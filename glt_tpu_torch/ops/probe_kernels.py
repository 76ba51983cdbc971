"""The compile probe's and the gather microbench's kernels: Python
wrappers over ``csrc/probes.cu`` and ``csrc/take2d.cu`` and, beside each,
its plain PyTorch version with the same signature (counterparts of the
Pallas kernels of benchmarks/probe_pallas_compile.py and
benchmarks/microbench_pallas_gather.py).

As in ops/cuda_kernels.py: a wrapper runs its plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel (built on
first use by ops/build.py) on the card's current stream or raises
``ValueError`` for what the kernel does not take; nothing falls back.
Each wrapper counts its launches in ``<wrapper>.launches`` (or
``<wrapper>.recorded`` inside a CUDA graph's capture), by what its entry
point returns.

=================  ==========================================  ==============
wrapper            replaces (benchmarks/...)                   source
=================  ==========================================  ==============
``vmem_id``        probe_pallas_compile.py:55 (rung 1)          csrc/probes.cu
``smem_scalar``    probe_pallas_compile.py:65 (rung 2)          csrc/probes.cu
``dma_fixed``      probe_pallas_compile.py:83 (rung 3)          csrc/probes.cu
``dma_dynamic``    probe_pallas_compile.py:102 (rung 4)         csrc/probes.cu
``prefetch_grid``  probe_pallas_compile.py:125 (rung 5)         csrc/probes.cu
``vt``             probe_pallas_compile.py:163 (rung 7)         csrc/take2d.cu
``vmem_take``      microbench_pallas_gather.py:129             csrc/take2d.cu
=================  ==========================================  ==============
"""
from __future__ import annotations

import torch

from .build import lazy_entry
from .cuda_kernels import _check, _where, count_launch

glt_probe_copy = lazy_entry(globals(), 'glt_probe_copy')
glt_probe_scale = lazy_entry(globals(), 'glt_probe_scale')
glt_probe_window = lazy_entry(globals(), 'glt_probe_window')
glt_probe_row_copy = lazy_entry(globals(), 'glt_probe_row_copy')
glt_take2d = lazy_entry(globals(), 'glt_take2d')

#: words a window copy holds (csrc/probes.cu kMaxWindow)
MAX_WINDOW = 1024
#: bytes a row copy holds (csrc/probes.cu kMaxRowBytes)
MAX_ROW_BYTES = 16384
#: words of a shared-memory table (csrc/take2d.cu kTableWords)
MAX_TABLE_WORDS = 8192
_I32 = torch.int32
_F32 = torch.float32

# Every wrapper's checks on the card are plain attribute reads, and its
# message is formatted only when it raises (as in ops/cuda_kernels.py).


# -- rung 1: vmem_id -----------------------------------------------------------

def vmem_id_plain(x: torch.Tensor) -> torch.Tensor:
  """A copy of ``x``."""
  return x.clone()


def vmem_id(x: torch.Tensor) -> torch.Tensor:
  """A copy of ``x``: each thread of the kernel loads a 16-byte unit into
  a register and stores it, the grid as many blocks as the units need.
  On the card ``x`` is contiguous, 16-byte aligned and a whole number of
  16-byte units."""
  if not x.is_cuda:
    return vmem_id_plain(x)
  nbytes, ptr = x.numel() * x.element_size(), x.data_ptr()
  if not (nbytes % 16 == 0 and ptr % 16 == 0 and x.is_contiguous()):
    raise ValueError(
        f'vmem_id copies 16-byte units of an aligned contiguous tensor, got '
        f'{nbytes} bytes at {ptr % 16} past 16')
  out = torch.empty_like(x)
  if nbytes:
    count_launch(vmem_id, _check(glt_probe_copy(
        ptr, out.data_ptr(), nbytes, *_where(x.device)), 'vmem_id'))
  return out


# -- rung 2: smem_scalar -------------------------------------------------------

def smem_scalar_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
  """``x * float32(s[0, 0])``."""
  return x * s.reshape(-1)[0].to(torch.float32)


def smem_scalar(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
  """``x * float32(s[0, 0])``: every thread of the kernel loads 16 bytes
  of ``x`` and the int32 scalar together. On the card ``x`` is float32,
  contiguous, 16-byte aligned and of a multiple of 4 elements; ``s``
  int32."""
  if not x.is_cuda:
    return smem_scalar_plain(x, s)
  dev, n, ptr = x.device, x.numel(), x.data_ptr()
  if not (x.dtype is _F32 and s.dtype is _I32 and s.numel() >= 1
          and s.is_contiguous() and ptr % 16 == 0 and x.is_contiguous()
          and n % 4 == 0 and s.device == dev):
    raise ValueError(
        f'smem_scalar takes an aligned float32 x of 4k elements and an int32 '
        f's on one card, got {x.dtype} {tuple(x.shape)}, {s.dtype}')
  out = torch.empty_like(x)
  if n:
    count_launch(smem_scalar, _check(glt_probe_scale(
        ptr, s.data_ptr(), out.data_ptr(), n, *_where(dev)), 'smem_scalar'))
  return out


# -- rungs 3 and 4: dma_fixed, dma_dynamic -------------------------------------

# A window's start is taken as lax.dynamic_slice takes it (pl.ds in the
# TPU rungs' interpret mode): a negative start counts from the end, then
# the start is clamped into [0, n - width], so the window stays inside.

def _window_index(n: int, st: torch.Tensor, width: int) -> torch.Tensor:
  st = st.reshape(-1)[:1].long()
  st = torch.where(st < 0, st + n, st).clamp(0, n - width)
  return st + torch.arange(width, device=st.device)


def dma_fixed_plain(big: torch.Tensor, start: int = 256,
                    width: int = 128) -> torch.Tensor:
  """``big[st:st + width]``, ``st`` = ``start`` as ``lax.dynamic_slice``
  takes it."""
  n, st = big.numel(), int(start)
  st = min(max(st + n if st < 0 else st, 0), n - width)
  return big[st:st + width].clone()


def _check_window(big: torch.Tensor, width: int, what: str) -> None:
  if not (big.dtype is _I32 and big.dim() == 1 and big.is_contiguous()
          and 0 < width <= min(MAX_WINDOW, big.numel())):
    raise ValueError(
        f'{what} copies up to {MAX_WINDOW} words of a contiguous 1-D int32 '
        f'array, got {big.dtype} {tuple(big.shape)}, width {width}')


def dma_fixed(big: torch.Tensor, start: int = 256,
              width: int = 128) -> torch.Tensor:
  """``big[start:start + width]``, a word a thread read straight from
  device memory; the start is a launch argument, as the TPU rung's
  ``pl.ds(256, 128)`` is static; taken as ``lax.dynamic_slice`` takes
  it."""
  if not big.is_cuda:
    return dma_fixed_plain(big, start, width)
  _check_window(big, width, 'dma_fixed')
  out = big.new_empty(width)
  count_launch(dma_fixed, _check(glt_probe_window(
      big.data_ptr(), big.numel(), int(start), None, width, out.data_ptr(),
      *_where(big.device)), 'dma_fixed'))
  return out


def dma_dynamic_plain(big: torch.Tensor, st: torch.Tensor,
                      width: int = 128) -> torch.Tensor:
  """``big[st:st + width]``, ``st = st[0, 0]`` as ``lax.dynamic_slice``
  takes it, read without a host sync."""
  return big[_window_index(big.numel(), st, width)]


def dma_dynamic(big: torch.Tensor, st: torch.Tensor,
                width: int = 128) -> torch.Tensor:
  """``big[st:st + width]``, the start read from the int32 tensor ``st``
  on the card by every thread of the kernel (taken as
  ``lax.dynamic_slice`` takes it), then a word a thread."""
  if not big.is_cuda:
    return dma_dynamic_plain(big, st, width)
  _check_window(big, width, 'dma_dynamic')
  dev = big.device
  if not (st.dtype is _I32 and st.numel() >= 1 and st.is_contiguous()
          and st.device == dev):
    raise ValueError(
        f'dma_dynamic reads its start from an int32 tensor on the card, got '
        f'{st.dtype} on {st.device}')
  out = big.new_empty(width)
  count_launch(dma_dynamic, _check(glt_probe_window(
      big.data_ptr(), big.numel(), 0, st.data_ptr(), width, out.data_ptr(),
      *_where(dev)), 'dma_dynamic'))
  return out


# -- rung 5: prefetch_grid -----------------------------------------------------

def prefetch_grid_plain(tab: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
  """``tab[clip(rows, 0, N - 1)]`` along the first axis."""
  return tab.index_select(0, rows.reshape(-1).long().clamp(
      0, max(tab.shape[0] - 1, 0)))


def prefetch_grid(tab: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
  """Rows of ``tab`` (``[N, ...]``) steered by ``rows`` (int32, clipped
  into ``[0, N - 1]``): a warp per group of output rows reads their
  indices and copies the rows as 16-byte vectors. On the card a row is a
  whole number of 16-byte units, at most 16 KB."""
  if not tab.is_cuda:
    return prefetch_grid_plain(tab, rows)
  dev, ptr = tab.device, tab.data_ptr()
  n = tab.shape[0] if tab.dim() else 0
  row_bytes = (tab.numel() // n if n else 0) * tab.element_size()
  if not (n > 0 and row_bytes % 16 == 0 and 0 < row_bytes <= MAX_ROW_BYTES
          and ptr % 16 == 0 and tab.is_contiguous()
          and rows.dtype is _I32 and rows.is_contiguous()
          and rows.device == dev):
    raise ValueError(
        f'prefetch_grid copies aligned rows of 16k bytes (at most '
        f'{MAX_ROW_BYTES}) by int32 rows on one card, got '
        f'{tuple(tab.shape)} {tab.dtype}, rows {rows.dtype}')
  b = rows.numel()
  out = tab.new_empty((b,) + tab.shape[1:])
  if b:
    count_launch(prefetch_grid, _check(glt_probe_row_copy(
        ptr, n, row_bytes, rows.data_ptr(), b, out.data_ptr(), *_where(dev)),
        'prefetch_grid'))
  return out


# -- rung 7 and the microbench: vt, vmem_take ----------------------------------

def vmem_take_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """``take(tab.ravel(), idx, mode='clip')``: the shape of ``idx``."""
  return torch.take(tab, idx.long().clamp(0, max(tab.numel() - 1, 0)))


def _take2d(fn, tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """The shared-memory gather of ``vt`` and ``vmem_take`` on the card, a
  launch counted for wrapper ``fn`` when there are indices."""
  dev, n, ptr = tab.device, tab.numel(), tab.data_ptr()
  if not (tab.dtype is _I32 and idx.dtype is _I32
          and 0 < n <= MAX_TABLE_WORDS and ptr % 16 == 0
          and tab.is_contiguous() and idx.is_contiguous()
          and idx.device == dev):
    raise ValueError(
        f'{fn.__name__} reads an aligned int32 table of 1 to '
        f'{MAX_TABLE_WORDS} words by contiguous int32 indices on one card, '
        f'got {tuple(tab.shape)} {tab.dtype}, idx {idx.dtype}')
  out = torch.empty_like(idx)
  m = idx.numel()
  if m:
    count_launch(fn, _check(glt_take2d(
        ptr, n, idx.data_ptr(), m, out.data_ptr(), *_where(dev)),
        fn.__name__))
  return out


def vmem_take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """``take(tab.ravel(), idx, mode='clip')`` from a table of at most 8192
  int32 words that every block of the kernel fills into its shared memory
  (the microbench's gather). On the card ``tab`` is int32, contiguous and
  16-byte aligned; ``idx`` int32 and contiguous."""
  if not tab.is_cuda:
    return vmem_take_plain(tab, idx)
  return _take2d(vmem_take, tab, idx)


vt_plain = vmem_take_plain


def vt(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """Rung 7's gather: the kernel of ``vmem_take``, counted on its own so
  that the probe's launches and the microbench's stay apart."""
  if not tab.is_cuda:
    return vt_plain(tab, idx)
  return _take2d(vt, tab, idx)


KERNELS = (vmem_id, smem_scalar, dma_fixed, dma_dynamic, prefetch_grid, vt,
           vmem_take)


def reset_launch_counts() -> None:
  for fn in KERNELS:
    fn.launches = fn.recorded = 0


reset_launch_counts()
