"""The compile probe's and the gather microbench's kernels: Python
wrappers over ``csrc/probes.cu`` and ``csrc/take2d.cu`` and, beside each,
its plain PyTorch version with the same signature (counterparts of the
Pallas kernels of benchmarks/probe_pallas_compile.py and
benchmarks/microbench_pallas_gather.py).

As in ops/cuda_kernels.py: a wrapper runs its plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel (built on
first use by ops/build.py) on the card's current stream or raises
``ValueError`` for what the kernel does not take; nothing falls back.
Each wrapper counts its launches in ``<wrapper>.launches``.

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

from typing import Tuple

import torch

from .build import lazy_entry
from .cuda_kernels import _check, _raw_stream, count_launch

glt_probe_stage_copy = lazy_entry(globals(), 'glt_probe_stage_copy')
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


def _need(ok: bool, what: str) -> None:
  if not ok:
    raise ValueError(what)


def _aligned(*ts: torch.Tensor) -> bool:
  return all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts)


def _same_card(ref: torch.Tensor, *ts: torch.Tensor) -> bool:
  return all(t.device == ref.device for t in ts)


# -- rung 1: vmem_id -----------------------------------------------------------

def vmem_id_plain(x: torch.Tensor) -> torch.Tensor:
  """A copy of ``x``."""
  return x.clone()


def vmem_id(x: torch.Tensor) -> torch.Tensor:
  """A copy of ``x`` staged through shared memory by 16-byte ``cp.async``
  copies. On the card ``x`` is contiguous, 16-byte aligned and a whole
  number of 16-byte units."""
  if not x.is_cuda:
    return vmem_id_plain(x)
  nbytes = x.numel() * x.element_size()
  _need(_aligned(x) and nbytes % 16 == 0,
        f'vmem_id copies 16-byte units of an aligned contiguous tensor, got '
        f'{nbytes} bytes at {x.data_ptr() % 16} past 16')
  out = torch.empty_like(x)
  if nbytes:
    dev = x.get_device()
    _check(glt_probe_stage_copy(x.data_ptr(), out.data_ptr(), nbytes, dev,
                                _raw_stream(dev)), 'vmem_id')
    count_launch(vmem_id)
  return out


# -- rung 2: smem_scalar -------------------------------------------------------

def smem_scalar_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
  """``x * float32(s[0, 0])``."""
  return x * s.reshape(-1)[0].to(torch.float32)


def smem_scalar(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
  """``x * float32(s[0, 0])``, the int32 scalar read on the card once per
  block into shared memory. On the card ``x`` is float32, contiguous,
  16-byte aligned and of a multiple of 4 elements; ``s`` int32."""
  if not x.is_cuda:
    return smem_scalar_plain(x, s)
  _need(x.dtype == torch.float32 and s.dtype == torch.int32
        and s.numel() >= 1 and s.is_contiguous() and _aligned(x)
        and x.numel() % 4 == 0 and _same_card(x, s),
        f'smem_scalar takes an aligned float32 x of 4k elements and an int32 '
        f's on one card, got {x.dtype} {tuple(x.shape)}, {s.dtype}')
  out = torch.empty_like(x)
  if x.numel():
    dev = x.get_device()
    _check(glt_probe_scale(x.data_ptr(), s.data_ptr(), out.data_ptr(),
                           x.numel(), dev, _raw_stream(dev)), 'smem_scalar')
    count_launch(smem_scalar)
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
  _need(big.dtype == torch.int32 and big.dim() == 1 and _aligned(big)
        and big.numel() % 4 == 0 and 0 < width <= min(MAX_WINDOW,
                                                      big.numel()),
        f'{what} copies up to {MAX_WINDOW} words of an aligned 1-D int32 '
        f'array of 4k elements, got {big.dtype} {tuple(big.shape)}, width '
        f'{width}')


def dma_fixed(big: torch.Tensor, start: int = 256,
              width: int = 128) -> torch.Tensor:
  """``big[start:start + width]`` by one bulk async copy into shared
  memory, completed on an mbarrier; the start is a launch argument, as
  the TPU rung's ``pl.ds(256, 128)`` is static; taken as
  ``lax.dynamic_slice`` takes it."""
  if not big.is_cuda:
    return dma_fixed_plain(big, start, width)
  _check_window(big, width, 'dma_fixed')
  out = big.new_empty(width)
  dev = big.get_device()
  _check(glt_probe_window(big.data_ptr(), big.numel(), int(start), None,
                          width, out.data_ptr(), dev, _raw_stream(dev)),
         'dma_fixed')
  count_launch(dma_fixed)
  return out


def dma_dynamic_plain(big: torch.Tensor, st: torch.Tensor,
                      width: int = 128) -> torch.Tensor:
  """``big[st:st + width]``, ``st = st[0, 0]`` as ``lax.dynamic_slice``
  takes it, read without a host sync."""
  return big[_window_index(big.numel(), st, width)]


def dma_dynamic(big: torch.Tensor, st: torch.Tensor,
                width: int = 128) -> torch.Tensor:
  """``big[st:st + width]``, the start read from the int32 tensor ``st``
  on the card (taken as ``lax.dynamic_slice`` takes it); one bulk async copy of
  the 16-byte-aligned cover of the window, the window selected from
  shared memory."""
  if not big.is_cuda:
    return dma_dynamic_plain(big, st, width)
  _check_window(big, width, 'dma_dynamic')
  _need(st.dtype == torch.int32 and st.numel() >= 1 and st.is_contiguous()
        and _same_card(big, st),
        f'dma_dynamic reads its start from an int32 tensor on the card, got '
        f'{st.dtype} on {st.device}')
  out = big.new_empty(width)
  dev = big.get_device()
  _check(glt_probe_window(big.data_ptr(), big.numel(), 0, st.data_ptr(),
                          width, out.data_ptr(), dev, _raw_stream(dev)),
         'dma_dynamic')
  count_launch(dma_dynamic)
  return out


# -- rung 5: prefetch_grid -----------------------------------------------------

def prefetch_grid_plain(tab: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
  """``tab[clip(rows, 0, N - 1)]`` along the first axis."""
  return tab.index_select(0, rows.reshape(-1).long().clamp(
      0, max(tab.shape[0] - 1, 0)))


def prefetch_grid(tab: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
  """Rows of ``tab`` (``[N, ...]``) steered by ``rows`` (int32, clipped
  into ``[0, N - 1]``): one block per output row reads its index and
  bulk-copies that row through shared memory. On the card a row is a
  whole number of 16-byte units, at most 16 KB."""
  if not tab.is_cuda:
    return prefetch_grid_plain(tab, rows)
  n = tab.shape[0] if tab.dim() else 0
  row_bytes = (tab.numel() // n if n else 0) * tab.element_size()
  _need(n > 0 and _aligned(tab) and row_bytes % 16 == 0
        and 0 < row_bytes <= MAX_ROW_BYTES and rows.dtype == torch.int32
        and rows.is_contiguous() and _same_card(tab, rows),
        f'prefetch_grid copies aligned rows of 16k bytes (at most '
        f'{MAX_ROW_BYTES}) by int32 rows on one card, got {tuple(tab.shape)} '
        f'{tab.dtype}, rows {rows.dtype}')
  b = rows.numel()
  out = tab.new_empty((b,) + tuple(tab.shape[1:]))
  if b:
    dev = tab.get_device()
    _check(glt_probe_row_copy(tab.data_ptr(), n, row_bytes, rows.data_ptr(),
                              b, out.data_ptr(), dev, _raw_stream(dev)),
           'prefetch_grid')
    count_launch(prefetch_grid)
  return out


# -- rung 7 and the microbench: vt, vmem_take ----------------------------------

def vmem_take_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """``take(tab.ravel(), idx, mode='clip')``: the shape of ``idx``."""
  return torch.take(tab, idx.long().clamp(0, max(tab.numel() - 1, 0)))


def _take2d(tab: torch.Tensor, idx: torch.Tensor,
            what: str) -> Tuple[torch.Tensor, bool]:
  """The shared-memory gather of ``vt`` and ``vmem_take`` on the card, and
  whether it launched (not for an empty ``idx``)."""
  n = tab.numel()
  _need(tab.dtype == torch.int32 and _aligned(tab)
        and 0 < n <= MAX_TABLE_WORDS and idx.dtype == torch.int32
        and idx.is_contiguous() and _same_card(tab, idx),
        f'{what} reads an aligned int32 table of 1 to {MAX_TABLE_WORDS} '
        f'words by contiguous int32 indices on one card, got '
        f'{tuple(tab.shape)} {tab.dtype}, idx {idx.dtype}')
  out = torch.empty_like(idx)
  if not idx.numel():
    return out, False
  dev = tab.get_device()
  _check(glt_take2d(tab.data_ptr(), n, idx.data_ptr(), idx.numel(),
                    out.data_ptr(), dev, _raw_stream(dev)), what)
  return out, True


def vmem_take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """``take(tab.ravel(), idx, mode='clip')`` from a table of at most 8192
  int32 words that every block holds in shared memory (the microbench's
  gather). On the card ``tab`` is int32, contiguous and 16-byte aligned;
  ``idx`` int32 and contiguous."""
  if not tab.is_cuda:
    return vmem_take_plain(tab, idx)
  out, launched = _take2d(tab, idx, 'vmem_take')
  count_launch(vmem_take, launched)
  return out


vt_plain = vmem_take_plain


def vt(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """Rung 7's gather: the kernel of ``vmem_take``, counted on its own so
  that the probe's launches and the microbench's stay apart."""
  if not tab.is_cuda:
    return vt_plain(tab, idx)
  out, launched = _take2d(tab, idx, 'vt')
  count_launch(vt, launched)
  return out


KERNELS = (vmem_id, smem_scalar, dma_fixed, dma_dynamic, prefetch_grid, vt,
           vmem_take)


def reset_launch_counts() -> None:
  for fn in KERNELS:
    fn.launches = fn.recorded = 0


reset_launch_counts()
