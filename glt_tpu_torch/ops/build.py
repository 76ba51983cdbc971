"""Build the package's CUDA kernels and import them as Python modules.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a Python extension
module ``_glt_<name>`` whose functions are the source's C entry points
(``csrc/entry.cuh``): Python's C API and the CUDA runtime, no PyTorch
headers, so a build takes seconds, not minutes, and a call costs a
fast-call parse instead of ctypes' conversion of every argument. All
sources build in parallel, one ``nvcc`` each, the first time any kernel
is used; the modules land in ``glt_tpu_torch/_build/`` under a name keyed
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads as is.
"""
from __future__ import annotations

import functools
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
from types import ModuleType
from typing import Callable, Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         '_build')
SOURCES = ('gather_rows', 'dedup_table_insert', 'sample_walk_dedup',
           'sample_hop_dedup', 'sample_hop', 'gather_windows', 'probes',
           'take2d')
#: the CUDA runtime is the one PyTorch has loaded (shared); the launches of
#: csrc/entry.cuh go through libcuda's cuLaunchKernel (LIBS, after the source)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
              '-cudart', 'shared')
LIBS = ('-lcuda',)
PY_INCLUDE = sysconfig.get_paths()['include']


def _nvcc() -> str:
  path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
  if not os.path.exists(path):
    raise RuntimeError('nvcc not found: the CUDA kernels build only on a '
                       'machine with the CUDA toolkit')
  return path


def _source_hash(name: str) -> str:
  h = hashlib.sha256(' '.join(NVCC_FLAGS + LIBS + (PY_INCLUDE,)).encode())
  for fn in sorted(os.listdir(CSRC)):
    if fn.endswith('.cuh') or fn == f'{name}.cu':
      with open(os.path.join(CSRC, fn), 'rb') as f:
        h.update(fn.encode() + f.read())
  return h.hexdigest()[:16]


def build_all() -> Dict[str, str]:
  """Compile every stale source, all ``nvcc`` processes started together;
  returns ``{name: path of the .so}``. The compiler's report (``-Xptxas
  -v``: registers, spills) is kept beside each library as ``.log``."""
  if not os.path.exists(os.path.join(PY_INCLUDE, 'Python.h')):
    raise RuntimeError(f'Python.h not found under {PY_INCLUDE}: the kernels '
                       'build as Python extension modules')
  os.makedirs(BUILD_DIR, exist_ok=True)
  paths, procs = {}, {}
  for name in SOURCES:
    so = os.path.join(BUILD_DIR, f'{name}-{_source_hash(name)}.so')
    paths[name] = so
    if not os.path.exists(so):
      tmp = f'{so}.{os.getpid()}.tmp'
      log = open(f'{so}.log', 'w')
      procs[name] = (subprocess.Popen(
          [_nvcc(), *NVCC_FLAGS, '-I', PY_INCLUDE, '-o', tmp,
           os.path.join(CSRC, f'{name}.cu'), *LIBS],
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
def _modules() -> Dict[str, ModuleType]:
  mods = {}
  for name, path in build_all().items():
    loader = importlib.machinery.ExtensionFileLoader(f'_glt_{name}', path)
    mod = importlib.util.module_from_spec(
        importlib.util.spec_from_loader(loader.name, loader))
    loader.exec_module(mod)
    mods[name] = mod
  return mods


def kernel_library(name: str) -> ModuleType:
  """The module of ``csrc/<name>.cu``, building every source on first
  use. Its ``glt_*`` functions take pointers as ints (None is NULL) and
  return the CUDA error of their launch, 0 when it was enqueued."""
  return _modules()[name]


def lazy_entry(namespace: dict, name: str) -> Callable[..., int]:
  """A stand-in for the C entry point ``name``, a global of the wrapper
  module whose globals are ``namespace``: its first call builds every
  source, binds each entry point that ``namespace`` names in place of
  its stand-in and calls through. From then on a launch reads one
  global, with no import and no library lookup."""
  def call(*args):
    for lib in SOURCES:
      for fn, entry in vars(kernel_library(lib)).items():
        if fn.startswith('glt_') and fn in namespace:
          namespace[fn] = entry
    return namespace[name](*args)
  return call
