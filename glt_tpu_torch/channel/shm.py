"""ctypes bindings of the port's shared-memory ring
(``glt_tpu_torch/csrc/shm_queue.cc``; counterpart of
glt_tpu/channel/shm.py), the reference's pywrap.SampleQueue surface
(py_export_glt.cc:127-146): picklable by shmid, blocking enqueue and
dequeue with a timeout.

The library is host code, built with ``g++`` on first use into
``glt_tpu_torch/_build/`` (the CUDA kernels' build directory): a stamp
holding the hash of the source and the command decides whether to
rebuild, a cross-process ``flock`` keeps concurrent first users from
building twice, and the build writes a temporary name that is renamed
into place, so no process loads a half-written library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

_LIB = None
_LIB_LOCK = threading.Lock()
_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), 'csrc')
SOURCE = os.path.join(_CSRC, 'shm_queue.cc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         '_build')
LIBRARY = os.path.join(BUILD_DIR, 'libglt_shm.so')
_CXX = ('g++', '-O2', '-fPIC', '-std=c++17', '-Wall', '-shared')
_ETIMEDOUT, _EMSGSIZE = 110, 90


class QueueTimeoutError(Exception):
  """A dequeue or an enqueue ran past its timeout (the reference maps the
  same condition to this name, py_export_glt.cc:133-137)."""


def _src_hash() -> str:
  h = hashlib.sha256(' '.join(_CXX).encode())
  with open(SOURCE, 'rb') as f:
    h.update(f.read())
  return h.hexdigest()


def build_library(force: bool = False) -> str:
  """``LIBRARY``, built from ``SOURCE`` when it is missing or its stamp
  differs from the source's hash (mtimes are not trusted: a fresh checkout
  gives every file one time)."""
  import fcntl
  os.makedirs(BUILD_DIR, exist_ok=True)
  stamp = LIBRARY + '.srchash'
  want = _src_hash()
  with open(os.path.join(BUILD_DIR, '.shm.lock'), 'w') as lockf:
    fcntl.flock(lockf, fcntl.LOCK_EX)
    have = None
    if os.path.exists(stamp):
      with open(stamp) as f:
        have = f.read().strip()
    if force or not os.path.exists(LIBRARY) or have != want:
      tmp = f'{LIBRARY}.tmp.{os.getpid()}'
      try:
        subprocess.run([*_CXX, SOURCE, '-o', tmp, '-lpthread'], check=True,
                       capture_output=True)
        os.replace(tmp, LIBRARY)
      finally:
        if os.path.exists(tmp):
          os.unlink(tmp)
      with open(stamp, 'w') as f:
        f.write(want)
  return LIBRARY


def get_lib():
  global _LIB
  with _LIB_LOCK:
    if _LIB is None:
      lib = ctypes.CDLL(build_library())
      lib.shmq_create.restype = ctypes.c_int
      lib.shmq_create.argtypes = [ctypes.c_uint64]
      lib.shmq_attach.restype = ctypes.c_void_p
      lib.shmq_attach.argtypes = [ctypes.c_int]
      lib.shmq_detach.argtypes = [ctypes.c_void_p]
      lib.shmq_destroy.argtypes = [ctypes.c_int]
      lib.shmq_enqueue.restype = ctypes.c_int
      lib.shmq_enqueue.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint64, ctypes.c_int]
      lib.shmq_peek_size.restype = ctypes.c_int64
      lib.shmq_peek_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
      lib.shmq_dequeue.restype = ctypes.c_int64
      lib.shmq_dequeue.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint64, ctypes.c_int]
      lib.shmq_size.restype = ctypes.c_uint64
      lib.shmq_size.argtypes = [ctypes.c_void_p]
      _LIB = lib
    return _LIB


def _address(data) -> int:
  """The address of the first byte of ``bytes`` or of a writable buffer,
  no copy; the caller keeps ``data`` alive while the address is used."""
  if isinstance(data, bytes):
    return ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value or 0
  view = memoryview(data)
  if not view.nbytes:
    return 0
  return ctypes.addressof(ctypes.c_char.from_buffer(view))


class ShmQueue:
  """A cross-process ring of variable-size blocks.

  Picklable: only the shmid travels and the receiving process attaches
  again (the reference's ForkingPickler pattern, data/graph.py:257-306).
  """

  def __init__(self, capacity_bytes: int = 64 * 1024 * 1024,
               shmid: int = None, owner: bool = True):
    lib = get_lib()
    if shmid is None:
      shmid = lib.shmq_create(capacity_bytes)
      if shmid < 0:
        raise OSError(-shmid, 'shmq_create failed')
      owner = True
    self.shmid = shmid
    self.owner = owner
    self._handle = lib.shmq_attach(shmid)
    if not self._handle:
      raise OSError('shmq_attach failed')
    # peek and dequeue are two steps: consumers of one process take turns
    # (across processes the dequeue refuses with -EMSGSIZE, consuming
    # nothing, when the head block changed under it, and dequeue() peeks
    # again)
    self._recv_lock = threading.Lock()

  def enqueue(self, data, timeout_ms: int = 60_000) -> None:
    """Blocks while the ring is full; raises QueueTimeoutError past the
    timeout and ``OSError(EMSGSIZE)`` for a block the ring cannot hold."""
    if not isinstance(data, bytes) and memoryview(data).readonly:
      data = bytes(data)
    rc = get_lib().shmq_enqueue(self._handle, _address(data),
                                memoryview(data).nbytes, timeout_ms)
    if rc == -_ETIMEDOUT:
      raise QueueTimeoutError('enqueue timed out')
    if rc != 0:
      raise OSError(-rc, 'shmq_enqueue failed')

  def dequeue(self, timeout_ms: int = 60_000) -> memoryview:
    """The next block, copied out of the ring once into a new writable
    buffer (not zero-filled first)."""
    lib = get_lib()
    deadline = time.monotonic() + timeout_ms / 1000
    with self._recv_lock:
      while True:
        remaining = max(int((deadline - time.monotonic()) * 1000), 1)
        size = lib.shmq_peek_size(self._handle, remaining)
        if size == -_ETIMEDOUT:
          raise QueueTimeoutError('dequeue timed out')
        if size < 0:
          raise OSError(int(-size), 'shmq_peek_size failed')
        buf = np.empty(max(int(size), 1), np.uint8)
        remaining = max(int((deadline - time.monotonic()) * 1000), 1)
        got = lib.shmq_dequeue(self._handle, buf.ctypes.data, int(size),
                               remaining)
        if got == -_ETIMEDOUT:
          raise QueueTimeoutError('dequeue timed out')
        if got == -_EMSGSIZE:   # another consumer took the block we
          continue              # peeked: peek again
        if got < 0:
          raise OSError(int(-got), 'shmq_dequeue failed')
        return memoryview(buf)[:got]

  def size(self) -> int:
    return int(get_lib().shmq_size(self._handle))

  def empty(self) -> bool:
    return self.size() == 0

  def close(self) -> None:
    """Detaches; the owner also marks the segment for removal (it goes
    once every process has detached)."""
    if self._handle:
      get_lib().shmq_detach(self._handle)
      self._handle = None
    if self.owner:
      get_lib().shmq_destroy(self.shmid)
      self.owner = False

  def unlink(self) -> None:
    """Marks the segment for removal now, attached as it stays: it goes
    when the last process detaches, or dies, so it cannot outlive its
    users. Linux still lets a process attach it by shmid (a worker
    unpickling this queue) until then."""
    if self.owner:
      get_lib().shmq_destroy(self.shmid)
      self.owner = False

  def __reduce__(self):
    return (ShmQueue, (0, self.shmid, False))

  def __del__(self):
    try:
      if getattr(self, '_handle', None):
        get_lib().shmq_detach(self._handle)
    except Exception:
      pass
