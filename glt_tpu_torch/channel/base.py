"""Channel abstractions and the flat SampleMessage wire format
(counterpart of glt_tpu/channel/base.py).

A SampleMessage is ``Dict[str, torch.Tensor]`` of CPU tensors, as in GLT
(graphlearn_torch/python/channel/base.py:28). ``pack_message`` writes the
JAX package's layout byte for byte -- ``|n| key_len|key|dtype|ndim|shape
...|nbytes|data|`` per entry, every integer little-endian, the dtype codes
of ``_DTYPES`` and 9 for bfloat16 (its 16-bit words) -- so a message packed
by either package unpacks in the other. ``unpack_message`` returns views
of the buffer, not copies (JAX's ``np.frombuffer``); a view of a read-only
buffer (``bytes``) must not be written to.
"""
from __future__ import annotations

import struct
import warnings
from typing import Dict

import numpy as np
import torch

SampleMessage = Dict[str, torch.Tensor]

#: the JAX package's dtype codes, in order; bfloat16 is the next code
_DTYPES = (torch.bool, torch.int8, torch.uint8, torch.int16, torch.int32,
           torch.int64, torch.float16, torch.float32, torch.float64)
_NP_DTYPES = (np.bool_, np.int8, np.uint8, np.int16, np.int32, np.int64,
              np.float16, np.float32, np.float64)
_DTYPE_CODE = {d: i for i, d in enumerate(_DTYPES)}
_BF16_CODE = len(_DTYPES)


def _as_tensor(x) -> torch.Tensor:
  if isinstance(x, torch.Tensor):
    return x.detach()
  a = np.asarray(x)
  a = a if a.flags.c_contiguous else a.copy()
  if a.dtype.name == 'bfloat16':    # an ml_dtypes array: its 16-bit words
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
  return torch.from_numpy(a)


def _raw(t: torch.Tensor) -> memoryview:
  """The tensor's bytes (C order) without a copy when it is contiguous on
  the CPU; bfloat16 as its 16-bit words."""
  t = t.cpu().contiguous()
  if t.dtype == torch.bfloat16:
    t = t.view(torch.int16)
  return memoryview(t.numpy().reshape(-1).view(np.uint8))


def pack_message(msg: SampleMessage) -> bytes:
  """Serialize (TensorMapSerializer::Serialize): the JAX package's bytes
  for the same contents. Takes tensors (or numpy arrays)."""
  parts = [struct.pack('<I', len(msg))]
  for key, x in msg.items():
    t = _as_tensor(x)
    if t.dtype == torch.bfloat16:
      code = _BF16_CODE
    elif t.dtype in _DTYPE_CODE:
      code = _DTYPE_CODE[t.dtype]
    else:
      raise TypeError(f'{key}: no wire code for {t.dtype}')
    kb = key.encode()
    # a 0-d entry crosses as shape (1,), as np.ascontiguousarray gives
    # the JAX package
    shape = tuple(t.shape) or (1,)
    raw = _raw(t)
    parts += [struct.pack('<I', len(kb)), kb,
              struct.pack('<II', code, len(shape)),
              struct.pack(f'<{max(len(shape), 1)}Q', *(shape or (0,))),
              struct.pack('<Q', raw.nbytes), raw]
  return b''.join(parts)


def unpack_message(buf) -> SampleMessage:
  """Deserialize (TensorMapSerializer::Load): CPU tensors viewing ``buf``
  (``bytes``, ``bytearray`` or a memoryview)."""
  out: SampleMessage = {}
  (n,) = struct.unpack_from('<I', buf, 0)
  off = 4
  with warnings.catch_warnings():
    # a view of read-only bytes, as np.frombuffer gives the JAX package
    warnings.simplefilter('ignore', UserWarning)
    for _ in range(n):
      (klen,) = struct.unpack_from('<I', buf, off)
      off += 4
      key = bytes(buf[off:off + klen]).decode()
      off += klen
      code, ndim = struct.unpack_from('<II', buf, off)
      off += 8
      shape = struct.unpack_from(f'<{max(ndim, 1)}Q', buf, off)
      off += 8 * max(ndim, 1)
      shape = tuple(shape[:ndim]) if ndim else ()
      (nbytes,) = struct.unpack_from('<Q', buf, off)
      off += 8
      count = int(np.prod(shape)) if ndim else 1
      np_dtype = np.int16 if code == _BF16_CODE else _NP_DTYPES[code]
      arr = np.frombuffer(buf, dtype=np_dtype, count=count,
                          offset=off).reshape(shape)
      t = torch.from_numpy(arr)
      out[key] = t.view(torch.bfloat16) if code == _BF16_CODE else t
      off += nbytes
  return out


class ChannelBase:
  """Producer -> consumer channel of SampleMessages."""

  def send(self, msg: SampleMessage) -> None:
    raise NotImplementedError

  def recv(self, timeout_ms: int = 60_000) -> SampleMessage:
    raise NotImplementedError

  def empty(self) -> bool:
    raise NotImplementedError
