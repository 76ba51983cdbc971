"""Build the package's CUDA kernels and load them through ``ctypes``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers: a build takes
seconds, not minutes). All sources build in parallel, one ``nvcc`` each,
the first time any kernel is used; the libraries land in
``glt_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads as is.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         '_build')
SOURCES = ('gather_rows', 'dedup_table_insert', 'sample_walk_dedup',
           'sample_hop_dedup', 'sample_hop', 'gather_windows')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: C entry points per library: name -> argtypes (every one returns the
#: cudaError_t of its launch as an int)
SIGNATURES = {
    'gather_rows': {
        'glt_gather_rows': [_vp, _vp, _vp, _i64, _i64, _i64, _i32, _vp],
    },
    'dedup_table_insert': {
        'glt_dedup_table_insert': [_vp, _vp, _i32, _vp, _vp, _vp, _i32,
                                   _vp],
    },
    'sample_walk_dedup': {
        'glt_walk_sample': [_vp, _i32, _vp, _vp, _vp, _i32, _i32, _vp,
                            _i32, _vp, _vp, _vp, _i32, _vp, _vp, _vp, _vp,
                            _vp],
        'glt_walk_heads': [_vp, _vp, _vp, _vp, _vp, _i32, _vp, _vp, _vp,
                           _vp],
        'glt_walk_labels': [_vp, _vp, _vp, _vp, _vp, _i32, _vp, _vp, _vp],
    },
    'sample_hop_dedup': {
        'glt_hop_sample': [_vp, _vp, _vp, _vp, _vp, _i32, _i32, _vp, _vp,
                           _vp, _i32, _vp, _vp, _vp, _vp],
        'glt_hop_heads': [_vp, _vp, _vp, _vp, _vp, _i32, _vp, _vp, _vp,
                          _vp],
        'glt_hop_labels': [_vp, _vp, _vp, _vp, _vp, _i32, _vp, _i32, _vp,
                           _vp, _vp],
    },
    'sample_hop': {
        'glt_sample_hop': [_vp, _vp, _i64, _vp, _vp, _i32, _i32, _vp, _vp,
                           _vp],
    },
    'gather_windows': {
        'glt_gather_windows': [_vp, _i64, _vp, _i32, _i32, _vp, _vp],
    },
}


def _nvcc() -> str:
  path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
  if not os.path.exists(path):
    raise RuntimeError('nvcc not found: the CUDA kernels build only on a '
                       'machine with the CUDA toolkit')
  return path


def _source_hash(name: str) -> str:
  h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for fn in sorted(os.listdir(CSRC)):
    if fn.endswith('.cuh') or fn == f'{name}.cu':
      with open(os.path.join(CSRC, fn), 'rb') as f:
        h.update(fn.encode() + f.read())
  return h.hexdigest()[:16]


def build_all() -> Dict[str, str]:
  """Compile every stale source, all ``nvcc`` processes started together;
  returns ``{name: path of the .so}``. The compiler's report (``-Xptxas
  -v``: registers, spills) is kept beside each library as ``.log``."""
  os.makedirs(BUILD_DIR, exist_ok=True)
  paths, procs = {}, {}
  for name in SOURCES:
    so = os.path.join(BUILD_DIR, f'{name}-{_source_hash(name)}.so')
    paths[name] = so
    if not os.path.exists(so):
      tmp = f'{so}.{os.getpid()}.tmp'
      log = open(f'{so}.log', 'w')
      procs[name] = (subprocess.Popen(
          [_nvcc(), *NVCC_FLAGS, '-o', tmp,
           os.path.join(CSRC, f'{name}.cu')],
          stdout=log, stderr=subprocess.STDOUT), tmp, log)
  failed = []
  for name, (proc, tmp, log) in procs.items():
    rc = proc.wait()
    log.close()
    if rc != 0:
      failed.append(name)
    else:
      os.replace(tmp, paths[name])
  if failed:
    reports = []
    for name in failed:
      with open(f'{paths[name]}.log') as f:
        reports.append(f'--- {name} ---\n{f.read()}')
    raise RuntimeError('nvcc failed for ' + ', '.join(failed) + '\n'
                       + '\n'.join(reports))
  return paths


@functools.lru_cache(maxsize=None)
def _libraries() -> Dict[str, ctypes.CDLL]:
  libs = {}
  for name, path in build_all().items():
    lib = ctypes.CDLL(path)
    for fn, argtypes in SIGNATURES[name].items():
      getattr(lib, fn).argtypes = argtypes
      getattr(lib, fn).restype = ctypes.c_int
    libs[name] = lib
  return libs


def kernel_library(name: str) -> ctypes.CDLL:
  """The loaded library of ``csrc/<name>.cu``, building every source on
  first use."""
  return _libraries()[name]
