"""The port's kernels: Python wrappers over ``csrc/*.cu`` and, beside
each, its plain PyTorch version (counterpart of
glt_tpu/ops/pallas_kernels.py).

A wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel (built on first use by ops/build.py) on
the current stream or raises; nothing falls back. Each wrapper counts its
kernel launches in ``<wrapper>.launches``, a plain int, so a run can show
that it went through the kernels. A call made while the current stream
records a CUDA graph launches nothing: it counts in ``<wrapper>.recorded``
instead, and each replay of that graph launches the kernel once more (the
graph's owner multiplies, e.g. ``SPMDSageTrainStep.graph_launches``). The
entry point itself reads its stream's capture state in the call that
launches (csrc/entry.cuh), and the wrapper counts by what it returns.

============================  ================================  ==========
wrapper                       replaces (glt_tpu/ops/...)        source
============================  ================================  ==========
``gather_rows``               pallas_kernels.py:236             csrc/gather_rows.cu
``gather_rows_mixed``         data/feature.py:36 (no Pallas     csrc/gather_rows.cu
                              source: compute_on's host read)
``dedup_table_insert``,       pallas_kernels.py:588 (+ the      csrc/dedup_table_insert.cu
``dedup_table_init``,         seed phase, sample.py:587-593,
``dedup_table_init_types``    and its several seed types,
                              pipeline.py:1042-1088)
``sample_walk_dedup``         pallas_kernels.py:998 + the       csrc/sample_walk_dedup.cu
                              epilogue of pipeline.py:584-633
``sample_hop_dedup``          pallas_kernels.py:653 + the       csrc/sample_hop_dedup.cu
                              epilogue of pipeline.py:1162-1203
``sample_hop``                pallas_kernels.py:367             csrc/sample_hop.cu
``gather_windows``            pallas_kernels.py:165             csrc/gather_windows.cu
============================  ================================  ==========
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..utils import offload
from .build import lazy_entry
from .sample import _row_spans, draw_offsets, walk_geometry

BIG = torch.iinfo(torch.int32).max
_I32, _LANES = torch.int32, 2 ** 31   # kernels address lanes with int32


def walk_table_slots(budget: int) -> int:
  """Dedup-table slots for a walk of ``budget`` worst-case distinct nodes:
  the power of two >= 2 * budget (load factor <= 1/2, so probes stay
  short and always terminate)."""
  return 1 << max(2 * int(budget) - 1, 1).bit_length()


def make_dedup_table(slots: int, device) -> Tuple[torch.Tensor, ...]:
  """Fresh (keys, vals, first) planes: -1 keys are free, -1 vals are
  unlabelled, INT32_MAX firsts are untouched."""
  if slots & (slots - 1):
    raise ValueError(f'table slots must be a power of two, got {slots}')
  return (torch.full((slots,), -1, dtype=torch.int32, device=device),
          torch.full((slots,), -1, dtype=torch.int32, device=device),
          torch.full((slots,), BIG, dtype=torch.int32, device=device))


def count_launch(fn, recorded: bool, n: int = 1) -> None:
  """Counts ``n`` launches of wrapper ``fn``'s kernel: in ``fn.launches``,
  or in ``fn.recorded`` when the entry point found its stream recording a
  CUDA graph (``recorded``, as :func:`_check` returns it), where the call
  launched nothing."""
  if recorded:
    fn.recorded += n
  else:
    fn.launches += n


def reset_launch_counts() -> None:
  for fn in KERNELS:
    fn.launches = fn.recorded = 0


# -- plumbing ---------------------------------------------------------------
# Each C entry point of the kernel modules (ops/build.py) is a module global
# of its own name, bound at the first launch (build.lazy_entry); pointers
# go in as plain ints (``data_ptr()``, None is NULL), then the card's index
# and the raw handle of its current stream, read on every launch: a
# caller may switch streams.

glt_gather_rows = lazy_entry(globals(), 'glt_gather_rows')
glt_gather_rows_mixed = lazy_entry(globals(), 'glt_gather_rows_mixed')
glt_dedup_table_insert = lazy_entry(globals(), 'glt_dedup_table_insert')
glt_dedup_table_init = lazy_entry(globals(), 'glt_dedup_table_init')
glt_dedup_table_init_types = lazy_entry(globals(),
                                        'glt_dedup_table_init_types')
glt_walk_dedup_blocks = lazy_entry(globals(), 'glt_walk_dedup_blocks')
glt_walk_dedup = lazy_entry(globals(), 'glt_walk_dedup')
glt_hop_dedup_blocks = lazy_entry(globals(), 'glt_hop_dedup_blocks')
glt_hop_dedup = lazy_entry(globals(), 'glt_hop_dedup')
glt_sample_hop = lazy_entry(globals(), 'glt_sample_hop')
glt_gather_windows = lazy_entry(globals(), 'glt_gather_windows')

#: the raw handle of a device's current stream, by device index (the call
#: Triton's launcher makes; chip_smoke.py times it against
#: ``torch.cuda.current_stream(dev).cuda_stream``, which builds a Stream
#: object per call). None in a CPU-only build.
_raw_stream = getattr(torch._C, '_cuda_getCurrentRawStream', None)


def _ptr(t: Optional[torch.Tensor]):
  return t.data_ptr() if t is not None else None


def _where(device: torch.device) -> Tuple[int, int]:
  """The last two arguments of every entry point: the card's index, on
  which csrc/entry.cuh launches (switching the thread's device only when
  it differs), and the raw handle of that card's current stream."""
  return device.index, _raw_stream(device.index)


#: what a launching entry point returns when its stream was recording a
#: CUDA graph: the launch was recorded, not run (csrc/entry.cuh kRecorded)
RECORDED = -1


def _check(state: int, what: str) -> bool:
  """Whether a launch was recorded into a CUDA graph, from its entry
  point's return (csrc/entry.cuh): 0 enqueued to run, ``RECORDED``
  recorded. Anything else is the CUresult of a launch, or of the capture
  query before it, that failed, and raises: a failed query is never
  taken for "not capturing"."""
  if state == 0:
    return False
  if state == RECORDED:
    return True
  raise RuntimeError(f'{what}: CUDA launch failed with CUresult {state}')


def _on(t: torch.Tensor, dtype: torch.dtype,
        device: torch.device) -> torch.Tensor:
  """``t`` as a contiguous ``dtype`` tensor on ``device``: ``t`` itself
  when it already is one (three attribute reads, where ``.to`` and
  ``.contiguous`` cost a dispatch each on the launch path)."""
  if t.dtype is dtype and t.device == device and t.is_contiguous():
    return t
  return t.to(device=device, dtype=dtype).contiguous()


def _i32(t: torch.Tensor, device: torch.device) -> torch.Tensor:
  return _on(t, torch.int32, device)


# -- K3: gather_rows ----------------------------------------------------------

def gather_rows_plain(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
  """``out[i] = table[clamp(rows[i], 0, N-1)]``. JAX clips out-of-range
  rows where torch indexing would wrap (``x[-1]`` is the last row): the
  padded node lanes are -1 and must read row 0."""
  n = table.shape[0]
  return table.index_select(0, rows.long().clamp(0, max(n - 1, 0)))


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
  """Feature row gather, ``table [N, D]``, ``rows [B]`` -> ``[B, D]``,
  rows clamped to ``[0, N-1]``; any dtype, width and table address. The
  kernel copies each row as 16-byte vectors in the layout of
  :func:`gather_rows_layout`."""
  if not table.is_cuda:
    return gather_rows_plain(table, rows)
  if table.dim() != 2 or not table.is_contiguous():
    raise ValueError('gather_rows needs a contiguous [N, D] table')
  n, d = table.shape
  if n == 0 and rows.numel():
    raise ValueError('gather_rows from an empty table')
  rows = _i32(rows.reshape(-1), table.device)
  b = rows.numel()
  out = torch.empty((b, d), dtype=table.dtype, device=table.device)
  if b and d:
    row_bytes, ptr = d * table.element_size(), table.data_ptr()
    lay = _layout(row_bytes, ptr % 16)
    count_launch(gather_rows, _check(glt_gather_rows(
        ptr, rows.data_ptr(), out.data_ptr(), n, row_bytes, b, lay.lanes,
        int(lay.realign), lay.passes, *_where(table.device)), 'gather_rows'))
  return out


def gather_rows_mixed_plain(hot: torch.Tensor, cold,
                            rows: torch.Tensor) -> torch.Tensor:
  """``out[i] = r < H ? hot[r] : cold[r - H]``, ``r = clamp(rows[i], 0,
  H + C - 1)``, on ``hot``'s device: ``index_select`` on each block where
  it lies (the cold block's rows cross to ``hot``'s device in one copy).
  ``cold`` is a tensor or, as :func:`gather_rows_mixed` takes it, the
  ``PinnedHost`` that holds one."""
  if isinstance(cold, offload.PinnedHost):
    cold = cold.tensor
  h, c = hot.shape[0], cold.shape[0]
  r = rows.reshape(-1).long().clamp(0, max(h + c - 1, 0))
  if c == 0:
    return hot.index_select(0, r.to(hot.device))
  cold_rows = cold.index_select(0, (r - h).clamp(min=0).to(cold.device))
  cold_rows = cold_rows.to(hot.device)
  if h == 0:
    return cold_rows
  r = r.to(hot.device)
  return torch.where((r < h)[:, None], hot.index_select(0, r.clamp(max=h - 1)),
                     cold_rows)


def gather_rows_mixed(hot: torch.Tensor, cold,
                      rows: torch.Tensor) -> torch.Tensor:
  """A split store's row gather, ``hot [H, D]`` on the card, ``cold`` the
  ``utils.offload.PinnedHost`` of a ``[C, D]`` block that ``pin_host``
  pinned and mapped for that card, ``rows [B]`` -> ``[B, D]`` on the card:
  ``out[i] = r < H ? hot[r] : cold[r - H]`` with ``r = clamp(rows[i], 0,
  H + C - 1)``, both blocks read in one launch in the layout of
  :func:`gather_rows_layout` over both addresses. A CPU ``hot`` takes a
  CPU tensor ``cold`` and runs :func:`gather_rows_mixed_plain`."""
  if not hot.is_cuda:
    return gather_rows_mixed_plain(hot, cold, rows)
  if not isinstance(cold, offload.PinnedHost) or cold.device != hot.device:
    raise TypeError(f'gather_rows_mixed on {hot.device} reads a cold block '
                    'pinned and mapped for it (utils.offload.pin_host)')
  cold_ptr, cold = cold.address, cold.tensor
  for name, t in (('hot', hot), ('cold', cold)):
    if t.dim() != 2 or not t.is_contiguous():
      raise ValueError(f'gather_rows_mixed needs a contiguous [N, D] {name} '
                       'block')
  (h, d), c = hot.shape, cold.shape[0]
  if cold.shape[1] != d or cold.dtype != hot.dtype:
    raise ValueError(f'blocks differ: hot {tuple(hot.shape)} {hot.dtype}, '
                     f'cold {tuple(cold.shape)} {cold.dtype}')
  if h + c == 0 and rows.numel():
    raise ValueError('gather_rows_mixed from an empty table')
  dev = hot.device
  rows = _i32(rows.reshape(-1), dev)
  b = rows.numel()
  out = torch.empty((b, d), dtype=hot.dtype, device=dev)
  if b and d:
    row_bytes = d * hot.element_size()
    # an empty block takes no part in the layout
    lay = _layout(row_bytes, ((hot.data_ptr() if h else 0)
                              | (cold_ptr if c else 0)) % 16)
    count_launch(gather_rows_mixed, _check(glt_gather_rows_mixed(
        hot.data_ptr(), h, cold_ptr, c, rows.data_ptr(), out.data_ptr(),
        row_bytes, b, lay.lanes, int(lay.realign), lay.passes, *_where(dev)),
        'gather_rows_mixed'))
  return out


class RowLayout(NamedTuple):
  lanes: int      # T: threads a row, a power of two <= 32
  realign: bool   # rows shift against the output's 16-byte vectors
  passes: int     # passes over a row: T (realign: T - 1) vectors each


@functools.lru_cache(maxsize=256)
def _layout(row_bytes: int, base16: int) -> RowLayout:
  # output row i starts at byte i * row_bytes of a 16-byte-aligned
  # allocation, so at most 16 - gcd(row_bytes, 16) into its first vector
  head = 16 - math.gcd(row_bytes, 16)
  n_out = (head + row_bytes - 1) // 16 + 1
  realign = bool(row_bytes % 16 or base16)
  need = n_out + realign    # realign: a lane for the last vector's neighbour
  lanes = min(32, 1 << (need - 1).bit_length())
  return RowLayout(lanes, realign, -(-n_out // (lanes - realign)))


def gather_rows_layout(row_bytes: int, base: int) -> RowLayout:
  """How K3 copies rows of ``row_bytes`` bytes from a table at address
  ``base`` (for a split store's two blocks, their addresses or-ed)
  (csrc/gather_rows.cu): T threads a row, T the power of two at
  or above the output vectors a row touches (plus one for the neighbour
  vector when realigning), at most 32. Rows of one pass go two to a
  segment; a wider row takes several passes on 32 lanes, a segment to
  itself (the kernel derives both from ``passes``). Rows realign unless
  both the row size and the address are multiples of 16."""
  if row_bytes <= 0:
    raise ValueError(f'row_bytes must be positive, got {row_bytes}')
  return _layout(int(row_bytes), int(base) % 16)


# -- K2: dedup_table_insert ---------------------------------------------------

def _table_hash(x: torch.Tensor, mask: int) -> torch.Tensor:
  h = (x.long() & 0xFFFFFFFF) * 0x9E3779B9 & 0xFFFFFFFF
  return (h ^ (h >> 16)) & mask


def dedup_table_insert_plain(keys: torch.Tensor, vals: torch.Tensor,
                             ids: torch.Tensor, labs: torch.Tensor,
                             valid: torch.Tensor) -> None:
  """Insert ``(id, label)`` pairs in place; ids < 0 and invalid slots are
  skipped and an id already present keeps its label. Linear probing in
  rounds: each round every pending id looks at its slot, the lowest
  pending slot claims a free one."""
  mask = keys.numel() - 1
  x = ids.long()
  pend = (valid != 0) & (x >= 0)
  slot = _table_hash(x, mask)
  idx = torch.arange(x.numel(), device=x.device)
  while bool(pend.any()):
    k = keys[slot].long()
    free = pend & (k == -1)
    claim = torch.full((mask + 2,), x.numel(), dtype=torch.long,
                       device=x.device)
    claim.scatter_reduce_(0, torch.where(free, slot, mask + 1), idx, 'amin')
    won = free & (claim[slot] == idx)
    keys[slot[won]] = x[won].to(keys.dtype)
    vals[slot[won]] = labs[won].to(vals.dtype)
    pend &= ~won & (k != x)
    k = keys[slot].long()
    slot = torch.where(pend & (k != x), (slot + 1) & mask, slot)


def dedup_table_insert(keys: torch.Tensor, vals: torch.Tensor,
                       ids: torch.Tensor, labs: torch.Tensor,
                       valid: torch.Tensor) -> None:
  """Insert pre-labelled ids into the (keys, vals) table in place: ids < 0
  and invalid slots are no-ops, present ids keep their labels. Valid ids
  are distinct within one call; the kernel inserts in no fixed order, so
  an id repeated with two labels would keep either. The hetero walk's
  seed phase is :func:`dedup_table_init`, the same kernel with the
  table's fill in front; this mode fills tables that tests prepare."""
  if not keys.is_cuda:
    return dedup_table_insert_plain(keys, vals, ids, labs, valid)
  slots = keys.numel()
  if (slots & (slots - 1) or vals.numel() != slots
      or keys.dtype != torch.int32 or vals.dtype != torch.int32):
    raise ValueError('dedup table planes must be int32 [2^p]')
  dev = keys.device
  ids, labs = _i32(ids, dev), _i32(labs, dev)
  valid = _on(valid, torch.bool, dev)
  m = ids.numel()
  if m:
    count_launch(dedup_table_insert, _check(glt_dedup_table_insert(
        _ptr(keys), _ptr(vals), slots, _ptr(ids), _ptr(labs), _ptr(valid),
        m, *_where(dev)), 'dedup_table_insert'))


def dedup_table_init_plain(slots: int, ids: torch.Tensor, labs: torch.Tensor,
                           new_head: torch.Tensor, base: int, device
                           ) -> Tuple[torch.Tensor, ...]:
  """:func:`make_dedup_table`, then the seed uniques inserted:
  ``ids + base`` under ``labs`` wherever ``new_head`` holds and the id is
  neither negative nor INT32_MAX (the seed hop's non-heads)."""
  return dedup_table_init_types_plain(slots, [(ids, labs, new_head, base)],
                                      device)


def dedup_table_init_types_plain(slots: int, segments, device
                                 ) -> Tuple[torch.Tensor, ...]:
  """:func:`dedup_table_init_plain` over several seed types: a fresh
  table, then each segment ``(ids, labs, new_head, base)`` inserted in
  turn (types' tagged ids never collide, so the order does not
  matter)."""
  keys, vals, first = make_dedup_table(slots, device)
  for ids, labs, new_head, base in segments:
    x = ids.to(keys.device).long()
    live = (new_head.to(keys.device) != 0) & (x >= 0) & (x != BIG)
    x = torch.where(live, x + int(base), torch.full_like(x, -1))
    dedup_table_insert_plain(keys, vals, x, labs.to(keys.device), live)
  return keys, vals, first


def _init_segments(slots: int, segments, device):
  """The card of the segments' ids, checked against ``device`` and the
  table size; each segment ``(ids, labs, new_head, base)`` as the kernel
  reads it (int32 ids and labels, byte flags, its base)."""
  dev = segments[0][0].device
  if device != dev and torch.device(device) not in (
      dev, torch.device(dev.type)):
    raise ValueError(f'dedup_table_init: ids on {dev}, table on {device}')
  if slots < 1 or slots & (slots - 1):
    raise ValueError(f'table slots must be a power of two, got {slots}')
  out = []
  for ids, labs, new_head, base in segments:
    if ids.device != dev:
      raise ValueError(f'dedup_table_init: seed types on {dev} and '
                       f'{ids.device}')
    if not 0 <= base < BIG:
      raise ValueError(f'dedup_table_init: type base {base} out of range')
    if ids.dim() != 1 or labs.shape != ids.shape \
        or new_head.shape != ids.shape:
      raise ValueError(f'dedup_table_init takes three [m] planes, got ids '
                       f'{tuple(ids.shape)}, labels {tuple(labs.shape)}, '
                       f'flags {tuple(new_head.shape)}')
    out.append((_i32(ids, dev), _i32(labs, dev),
                _on(new_head, torch.bool, dev), int(base)))
  return dev, out


def dedup_table_init(slots: int, ids: torch.Tensor, labs: torch.Tensor,
                     new_head: torch.Tensor, base: int, device
                     ) -> Tuple[torch.Tensor, ...]:
  """A fresh dedup table ``(keys, vals, first)`` of ``slots`` slots with the
  seed uniques inserted: ``ids + base`` (the seed type's tag base) under
  ``labs`` wherever ``new_head`` holds (the counterpart of JAX's
  ``init_table``, glt_tpu/ops/sample.py:587-593). The three planes are
  views of one allocation on ``device``; the ids' card must be it.

  On the card this is one cooperative launch that fills the planes and
  inserts (csrc/dedup_table_insert.cu, counted on
  ``dedup_table_insert.launches``): it reads ``new_head`` as bytes and
  nothing back, so a CUDA graph can capture it."""
  if not ids.is_cuda:
    return dedup_table_init_plain(slots, ids, labs, new_head, base, device)
  dev, [(ids, labs, new_head, base)] = _init_segments(
      slots, [(ids, labs, new_head, base)], device)
  planes = torch.empty(3 * slots, dtype=torch.int32, device=dev)
  count_launch(dedup_table_insert, _check(glt_dedup_table_init(
      planes.data_ptr(), slots, ids.data_ptr(), labs.data_ptr(),
      new_head.data_ptr(), base, ids.numel(), *_where(dev)),
      'dedup_table_init'))
  return planes.split(slots)


#: seed types one :func:`dedup_table_init_types` launch takes (kMaxSegs)
MAX_SEED_TYPES = 8


def dedup_table_init_types(slots: int, segments, device
                           ) -> Tuple[torch.Tensor, ...]:
  """:func:`dedup_table_init` for seeds of several node types: a fresh
  table with every segment ``(ids, labs, new_head, base)`` inserted, each
  type's uniques under its own tag base (the seed phase of JAX's
  multi-type hetero walk, glt_tpu/ops/pipeline.py:1042-1088, where both
  endpoint types of a link batch seed one table).

  On the card the fill and every type's insert are one cooperative launch
  (at most :data:`MAX_SEED_TYPES` types; counted on
  ``dedup_table_insert.launches``), with no host read, so a CUDA graph
  can capture it."""
  segments = list(segments)
  if not segments or len(segments) > MAX_SEED_TYPES:
    raise ValueError(f'dedup_table_init_types takes 1 to {MAX_SEED_TYPES} '
                     f'seed types, got {len(segments)}')
  if not segments[0][0].is_cuda:
    return dedup_table_init_types_plain(slots, segments, device)
  dev, segs = _init_segments(slots, segments, device)
  planes = torch.empty(3 * slots, dtype=torch.int32, device=dev)
  count_launch(dedup_table_insert, _check(glt_dedup_table_init_types(
      planes.data_ptr(), slots, [s[0].data_ptr() for s in segs],
      [s[1].data_ptr() for s in segs], [s[2].data_ptr() for s in segs],
      [s[3] for s in segs], [s[0].numel() for s in segs], *_where(dev)),
      'dedup_table_init_types'))
  return planes.split(slots)


def dedup_table_lookup(keys: torch.Tensor, vals: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
  """Label of each id in the table, -1 where absent (plain PyTorch; the
  walk never looks up, tests and chip_smoke.py read tables with it)."""
  mask = keys.numel() - 1
  x = ids.long()
  out = torch.full_like(x, -1)
  active = x >= 0
  slot = _table_hash(x, mask)
  for _ in range(mask + 1):
    if not bool(active.any()):
      break
    k = keys[slot].long()
    hit = active & (k == x)
    out = torch.where(hit, vals[slot].long(), out)
    active &= ~hit & (k != -1)
    slot = (slot + 1) & mask
  return out


# -- K1: sample_walk_dedup ----------------------------------------------------

def _check_walk_inputs(indptr_pad, indices, seed_ids, u_hops, fanouts):
  hops = walk_geometry(seed_ids.numel(), fanouts)
  if len(u_hops) != len(hops):
    raise ValueError(f'{len(u_hops)} uniform planes for {len(hops)} hops')
  for (s, k), u in zip(hops, u_hops):
    if tuple(u.shape) != (s, k):
      raise ValueError(f'hop uniforms {tuple(u.shape)}, expected {(s, k)}')
  if indptr_pad.numel() < 2:
    raise ValueError('indptr_pad needs [N + 2] entries')
  return hops


def sample_walk_dedup_plain(indptr_pad, indices, seed_ids, seed_ok,
                            stab_ids, stab_labs, seed_count, u_hops, *,
                            fanouts, replace=False, table_slots=0,
                            with_slots=False) -> List[Dict[str, torch.Tensor]]:
  """The walk in plain PyTorch (same signature and outputs as
  :func:`sample_walk_dedup`; ``table_slots`` is unused). Dedup is a
  sorted seen-set: ``searchsorted`` finds seen ids, ``unique`` ranks the
  new ones by value, a scatter-min finds each new id's first slot."""
  hops = _check_walk_inputs(indptr_pad, indices, seed_ids, u_hops, fanouts)
  dev = indices.device
  e = indices.numel()
  keep = stab_ids >= 0
  order = torch.argsort(stab_ids[keep].long())
  seen_ids = stab_ids[keep].long()[order]
  seen_labs = stab_labs[keep].long()[order]
  count = int(seed_count)
  frontier = seed_ids.to(torch.int32)
  ok = seed_ok != 0
  out = []
  for (s, k), u in zip(hops, u_hops):
    start, deg = _row_spans(indptr_pad, frontier, ok)
    off, mask = draw_offsets(deg, u, k, replace)
    slot = (start[:, None].long() + off.long()).clamp(0, max(e - 1, 0))
    ids = torch.where(mask, indices[slot].long(),
                      torch.full_like(slot, -1)).reshape(-1)
    valid = mask.reshape(-1)
    m = ids.numel()
    pos = torch.searchsorted(seen_ids, ids).clamp(max=max(
        seen_ids.numel() - 1, 0))
    found = valid & (seen_ids[pos] == ids) if seen_ids.numel() else \
        torch.zeros_like(valid)
    new_el = valid & ~found
    uniq = torch.unique(ids[new_el])
    rank = torch.searchsorted(uniq, ids).clamp(max=max(uniq.numel() - 1, 0))
    first = torch.full((uniq.numel() + 1,), m, dtype=torch.long, device=dev)
    first.scatter_reduce_(0, torch.where(new_el, rank, uniq.numel()),
                          torch.arange(m, device=dev), 'amin')
    new_head = new_el & (first[rank] == torch.arange(m, device=dev))
    labels = torch.where(found, seen_labs[pos] if seen_ids.numel()
                         else torch.zeros_like(ids),
                         torch.where(new_el, count + rank,
                                     torch.full_like(ids, -1)))
    merged = torch.cat([seen_ids, uniq])
    order = torch.argsort(merged)
    seen_ids = merged[order]
    seen_labs = torch.cat([seen_labs, count + torch.arange(
        uniq.numel(), device=dev)])[order]
    count += uniq.numel()
    hop = dict(picks=ids.to(torch.int32).view(s, k), mask=mask,
               labels=labels.to(torch.int32), new_head=new_head,
               new_count=new_head.sum(dtype=torch.int32))
    if with_slots:
      hop['slots'] = torch.where(mask, slot, torch.full_like(slot, -1)).to(
          torch.int32).view(s, k)
    out.append(hop)
    frontier = torch.where(new_head, ids, torch.full_like(ids, BIG)).to(
        torch.int32)
    ok = frontier != BIG
  return out


def sample_walk_dedup(indptr_pad, indices, seed_ids, seed_ok, stab_ids,
                      stab_labs, seed_count, u_hops, *, fanouts,
                      replace=False, table_slots, with_slots=False
                      ) -> List[Dict[str, torch.Tensor]]:
  """The uniform multi-hop walk with dedup/relabel.

  Args:
    indptr_pad: [N + 2] int32 CSR offsets with a trailing ``num_edges``.
    indices: [E] int32 neighbour ids, each in ``[0, N)``.
    seed_ids / seed_ok: [B] hop 1's frontier and its validity (the exact
      seed dedup's ``ids3`` / ``new_head3``).
    stab_ids / stab_labs: [B] the seed uniques (-1 elsewhere) and their
      labels, inserted into a fresh table before hop 1.
    seed_count: int32 scalar tensor, labels assigned before hop 1.
    u_hops: per hop ``[S_h, K_h]`` float32 uniforms.
    table_slots: dedup-table size, a power of two >= 2x the walk's node
      budget (:func:`walk_table_slots`).
    with_slots: also return each pick's CSR slot (the edge position).

  Returns per hop a dict: ``picks`` [S, K] (-1 on invalid lanes),
  ``mask`` [S, K] bool, ``labels`` [S*K] final labels (seen ids keep
  theirs, new ids ``count..`` in value order, -1 on invalid lanes),
  ``new_head`` [S*K] bool (each new id's minimum slot), ``new_count``
  (int32 scalar, the hop's new ids) and, with ``with_slots``, ``slots``
  [S, K].

  On the card the whole walk is one cooperative launch
  (csrc/sample_walk_dedup.cu) of at most 16 hops; every output is a view
  of one allocation, and the table, bitmap and other scratch of another,
  freed on return.
  """
  if not indices.is_cuda:
    return sample_walk_dedup_plain(
        indptr_pad, indices, seed_ids, seed_ok, stab_ids, stab_labs,
        seed_count, u_hops, fanouts=fanouts, replace=replace,
        table_slots=table_slots, with_slots=with_slots)
  hops = _check_walk_inputs(indptr_pad, indices, seed_ids, u_hops, fanouts)
  if len(hops) > _MAX_WALK_HOPS:
    raise ValueError(f'the walk kernel takes at most {_MAX_WALK_HOPS} '
                     f'hops, got {len(hops)}')
  if seed_ids.numel() != hops[0][0]:
    raise ValueError('the walk needs at least one seed')
  if table_slots < 1 or table_slots & (table_slots - 1):
    raise ValueError(f'table slots must be a power of two, got '
                     f'{table_slots}')
  if any(s * k >= _LANES for s, k in hops):
    raise ValueError('a hop addresses its lanes with int32')
  dev = indices.device
  indptr_pad, indices = _i32(indptr_pad, dev), _i32(indices, dev)
  seeds, stab_ids = _i32(seed_ids, dev), _i32(stab_ids, dev)
  stab_labs = _i32(stab_labs, dev)
  seed_ok = _on(seed_ok, torch.bool, dev)
  count = _i32(torch.as_tensor(seed_count), dev)
  u_hops = [_on(u, torch.float32, dev) for u in u_hops]
  num_nodes = indptr_pad.numel() - 2
  words = _bitmap_words(num_nodes)
  lay = _walk_layout(tuple(hops), table_slots, words,
                     _coop_blocks('glt_walk_dedup_blocks', dev.index),
                     with_slots)
  # the outputs in one allocation, the kernel's scratch in another, which
  # is freed on return rather than held by the outputs
  buf = torch.empty(lay.size, dtype=torch.int32, device=dev)
  scratch = torch.empty(lay.scratch, dtype=torch.int32, device=dev)
  base, sbase = buf.data_ptr(), scratch.data_ptr()
  planes = []
  for (s, k), u, (picks, slots, mask, tslot, labels, new_head,
                  new_count) in zip(hops, u_hops, lay.hop_bytes):
    planes += (s, k, u.data_ptr(), base + picks,
               base + slots if with_slots else 0, base + mask,
               sbase + tslot, base + labels, base + new_head,
               base + new_count)
  count_launch(sample_walk_dedup, _check(glt_walk_dedup(
      indptr_pad.data_ptr(), num_nodes, indices.data_ptr(), seeds.data_ptr(),
      seed_ok.data_ptr(), stab_ids.data_ptr(), stab_labs.data_ptr(),
      seeds.numel(), count.data_ptr(), int(replace), sbase, table_slots,
      words, planes, *_where(dev)), 'sample_walk_dedup'))
  ints = buf.split_with_sizes(lay.int_sizes)
  flags = ints[-1].view(torch.bool).split_with_sizes(lay.flag_sizes)
  new_counts = ints[0].unbind()
  out = []
  for h, (s, k) in enumerate(hops):
    at = 1 + h * lay.per_hop
    hop = dict(picks=ints[at].view(s, k), mask=flags[2 * h].view(s, k),
               labels=ints[at + 1], new_head=flags[2 * h + 1],
               new_count=new_counts[h])
    if with_slots:
      hop['slots'] = ints[at + 2].view(s, k)
    out.append(hop)
  return out


#: csrc/sample_walk_dedup.cu's kMaxHops
_MAX_WALK_HOPS = 16


def _bitmap_words(n_ids: int) -> int:
  """int32 words of a bitmap over ids ``[0, n_ids)``, at least one."""
  return max(1, (int(n_ids) + 31) // 32)


@functools.lru_cache(maxsize=None)
def _coop_blocks(entry: str, device: int) -> int:
  """The most blocks of a cooperative kernel resident at once on card
  ``device``, asked of its entry point ``entry`` (``glt_*_blocks``) once
  per card: the length of the kernel's per-block scratch."""
  n = globals()[entry](device)
  if n <= 0:
    raise RuntimeError(f'{entry}: occupancy query failed with CUresult '
                       f'{-n}')
  return n


class _WalkLayout(NamedTuple):
  scratch: int                # int32 words of the kernel's scratch
  size: int                   # int32 words of the outputs
  int_sizes: List[int]        # the outputs' split (the flags last)
  per_hop: int                # its pieces a hop: picks, labels[, slots]
  flag_sizes: List[int]       # the flags' split: per hop mask, new_head
  hop_bytes: List[Tuple[int, ...]]   # byte offsets in csrc's field order


@functools.lru_cache(maxsize=64)
def _walk_layout(hops, table_slots, words, blocks, with_slots):
  """Where each plane of a walk lies. The kernel's scratch, one int32
  allocation: the table's keys, vals and first (``table_slots`` each),
  the bitmap and word ranks (``words`` each), the per-block counts
  (``blocks``), then every hop's tslot. The outputs, another: every hop's
  new_count, then per hop picks, labels and slots (``with_slots``), then
  every hop's mask and new_head bytes. ``hop_bytes`` gives each hop's
  byte offsets of picks, slots (-1 without), mask, tslot (in the
  scratch), labels, new_head and new_count."""
  scratch = 3 * table_slots + 2 * words + blocks
  sizes, off = [len(hops)], len(hops)
  per_hop = 3 if with_slots else 2
  flags, hop_bytes = [], []
  for h, (s, k) in enumerate(hops):
    m = s * k
    hop_bytes.append([off * 4, (off + 2 * m) * 4 if with_slots else -1,
                      None, scratch * 4, (off + m) * 4, None, h * 4])
    sizes += [m] * per_hop
    off += per_hop * m
    scratch += m
    flags += [m, m]
  fo = off * 4
  for hb, (s, k) in zip(hop_bytes, hops):
    hb[2], hb[5] = fo, fo + s * k
    fo += 2 * s * k
  flag_words = (sum(flags) + 3) // 4
  pad = flag_words * 4 - sum(flags)
  sizes.append(flag_words)
  return _WalkLayout(scratch, off + flag_words, sizes, per_hop,
                     flags + ([pad] if pad else []),
                     [tuple(hb) for hb in hop_bytes])


# -- B1: sample_hop_dedup -------------------------------------------------------

def _check_hop_inputs(starts, offsets, valid, type_bounds, counts):
  if offsets.dim() != 2 or tuple(valid.shape) != tuple(offsets.shape) \
      or starts.numel() != offsets.shape[0]:
    raise ValueError(f'hop planes: starts {tuple(starts.shape)}, offsets '
                     f'{tuple(offsets.shape)}, valid {tuple(valid.shape)}')
  if type_bounds.numel() != counts.numel() + 1:
    raise ValueError('type_bounds needs one more entry than counts')
  if offsets.numel() >= 2 ** 31:
    raise ValueError('a hop addresses its lanes with int32')


def sample_hop_dedup_plain(indices_flat, eids_flat, starts, offsets, valid,
                           keys, vals, first, type_bounds, counts, *,
                           num_ids=None) -> Dict[str, torch.Tensor]:
  """One hetero hop in plain PyTorch (same signature and outputs as
  :func:`sample_hop_dedup`; ``first`` and ``num_ids`` are unused). Seen
  ids are looked up in the table; the hop's new ids are ranked by
  ``unique`` (sorted, so grouped by type), a scatter-min finds each one's
  first lane, and they are inserted with their labels."""
  _check_hop_inputs(starts, offsets, valid, type_bounds, counts)
  s, k = offsets.shape
  dev = offsets.device
  ok = valid.bool()
  slot = starts.long()[:, None] + offsets.long()
  picks = torch.full((s, k), -1, dtype=torch.int32, device=dev)
  picks[ok] = indices_flat[slot[ok]].to(torch.int32)
  eid_picks = None
  if eids_flat is not None:
    eid_picks = torch.full((s, k), -1, dtype=torch.int32, device=dev)
    eid_picks[ok] = eids_flat[slot[ok]].to(torch.int32)
  ids, ok = picks.reshape(-1).long(), ok.reshape(-1)
  m = ids.numel()
  seen = dedup_table_lookup(keys, vals, ids)
  new_el = ok & (seen < 0)
  uniq = torch.unique(ids[new_el])
  rank = torch.searchsorted(uniq, ids).clamp(max=max(uniq.numel() - 1, 0))
  first_lane = torch.full((uniq.numel() + 1,), m, dtype=torch.long,
                          device=dev)
  first_lane.scatter_reduce_(0, torch.where(new_el, rank, uniq.numel()),
                             torch.arange(m, device=dev), 'amin')
  new_head = new_el & (first_lane[rank] == torch.arange(m, device=dev))
  bounds = type_bounds.long()
  type_rank = torch.searchsorted(uniq, bounds)      # [T + 1]
  base = counts.long() - type_rank[:-1]             # label = base[t] + rank
  utype = torch.searchsorted(bounds, uniq, right=True) - 1
  ulabs = base[utype] + torch.arange(uniq.numel(), device=dev)
  labels = torch.where(ok, seen, torch.full_like(seen, -1))
  labels[new_el] = ulabs[rank[new_el]]
  dedup_table_insert_plain(keys, vals, uniq, ulabs,
                           torch.ones_like(uniq, dtype=torch.bool))
  return dict(picks=picks, eid_picks=eid_picks,
              labels=labels.to(torch.int32), new_head=new_head,
              counts=(counts.long() + type_rank[1:] - type_rank[:-1]).to(
                  torch.int32))


def sample_hop_dedup(indices_flat, eids_flat, starts, offsets, valid, keys,
                     vals, first, type_bounds, counts, *, num_ids=None
                     ) -> Dict[str, torch.Tensor]:
  """One hop of the hetero walk over the flat edge-type plane, with
  dedup/relabel against the shared table of type-tagged ids.

  Args:
    indices_flat / eids_flat: [E_flat] int32 tagged neighbour ids and edge
      ids of every edge type (``build_type_plane``); ``eids_flat`` may be
      None.
    starts: [S] int32 each row's CSR start in the flat plane.
    offsets / valid: [S, K] int32 drawn offsets and bool lane validity
      (lanes past a segment's fanout are invalid).
    keys / vals / first: the table planes (:func:`make_dedup_table`),
      updated in place: this hop's new ids are inserted with their final
      labels.
    type_bounds: [T + 1] int32, type t's tagged ids are
      ``[type_bounds[t], type_bounds[t+1])``.
    counts: [T] int32 labels assigned per type before this hop.
    num_ids: ``type_bounds[T]`` as a host int, the tagged ids' range,
      which sizes the kernel's rank bitmap; read from ``type_bounds`` (a
      device sync) when not given.

  Returns a dict: ``picks`` and ``eid_picks`` [S, K] (-1 on invalid
  lanes; ``eid_picks`` None without ``eids_flat``), ``labels`` [S*K]
  (seen ids keep theirs, a new id of type t gets ``counts[t]`` + its
  value rank among the hop's new type-t ids, -1 on invalid lanes),
  ``new_head`` [S*K] bool (each new id's minimum lane) and ``counts``
  [T] after the hop.

  On the card the hop is one cooperative launch
  (csrc/sample_hop_dedup.cu); its outputs are views of one allocation,
  its scratch another's.
  """
  if not offsets.is_cuda:
    return sample_hop_dedup_plain(indices_flat, eids_flat, starts, offsets,
                                  valid, keys, vals, first, type_bounds,
                                  counts, num_ids=num_ids)
  _check_hop_inputs(starts, offsets, valid, type_bounds, counts)
  slots = keys.numel()
  if slots < 1 or slots & (slots - 1) or vals.numel() != slots \
      or first.numel() != slots:
    raise ValueError('dedup table planes must be int32 [2^p]')
  s, k = offsets.shape
  m = s * k
  dev = offsets.device
  indices_flat = _i32(indices_flat, dev)
  eids_flat = _i32(eids_flat, dev) if eids_flat is not None else None
  starts, offsets = _i32(starts, dev), _i32(offsets, dev)
  valid = _on(valid, torch.bool, dev)
  type_bounds, counts = _i32(type_bounds, dev), _i32(counts, dev)
  if num_ids is None:
    num_ids = int(type_bounds[-1])
  words = _bitmap_words(num_ids)
  n_types = counts.numel()
  blocks = _coop_blocks('glt_hop_dedup_blocks', dev.index)
  n_eid = m if eids_flat is not None else 0
  # the outputs (picks, eid_picks, labels, counts, then the new_head
  # bytes) in one allocation; the kernel's scratch (the bitmap, word
  # ranks, per-block counts, then tslot) in another, freed on return
  buf = torch.empty(2 * m + n_eid + n_types + (m + 3) // 4,
                    dtype=torch.int32, device=dev)
  picks, eid_picks, labels, counts_out, flags = buf.split_with_sizes(
      [m, n_eid, m, n_types, (m + 3) // 4])
  new_head = flags.view(torch.bool)[:m]
  scratch = torch.empty(2 * words + blocks + m, dtype=torch.int32,
                        device=dev)
  sbase = scratch.data_ptr()
  count_launch(sample_hop_dedup, _check(glt_hop_dedup(
      indices_flat.data_ptr(), _ptr(eids_flat), starts.data_ptr(),
      offsets.data_ptr(), valid.data_ptr(), s, k, keys.data_ptr(),
      vals.data_ptr(), first.data_ptr(), slots, type_bounds.data_ptr(),
      n_types, counts.data_ptr(), num_ids, sbase, words,
      picks.data_ptr(), eid_picks.data_ptr() if n_eid else None,
      sbase + 4 * (2 * words + blocks), labels.data_ptr(),
      new_head.data_ptr(), counts_out.data_ptr(), *_where(dev)),
      'sample_hop_dedup'))
  return dict(picks=picks.view(s, k),
              eid_picks=eid_picks.view(s, k) if n_eid else None,
              labels=labels, new_head=new_head, counts=counts_out)


# -- B2: sample_hop ------------------------------------------------------------

def _check_pick_inputs(indices, starts, offsets):
  if offsets.dim() != 2 or starts.numel() != offsets.shape[0]:
    raise ValueError(f'hop planes: starts {tuple(starts.shape)}, offsets '
                     f'{tuple(offsets.shape)}')
  if offsets.numel() and indices.numel() == 0:
    raise ValueError('sample_hop reads from an empty edge array')
  if offsets.numel() >= 2 ** 31:
    raise ValueError('a hop addresses its lanes with int32')


def sample_hop_plain(indices: torch.Tensor, eids: Optional[torch.Tensor],
                     starts: torch.Tensor, offsets: torch.Tensor
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """:func:`sample_hop` in plain PyTorch: one ``torch.take`` over the
  clipped slots per edge array."""
  _check_pick_inputs(indices, starts, offsets)
  slots = (starts.long()[:, None] + offsets.long()).clamp(
      0, max(indices.numel() - 1, 0))
  picks = torch.take(indices, slots).to(torch.int32)
  eid_picks = (torch.take(eids, slots).to(torch.int32)
               if eids is not None else None)
  return picks, eid_picks


def sample_hop(indices: torch.Tensor, eids: Optional[torch.Tensor],
               starts: torch.Tensor, offsets: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """The neighbour read of one uniform hop.

  Args:
    indices: [E] int32 neighbour ids (a stream snapshot's are padded to
      its capacity with -1).
    eids: [E] int32 edge ids read through the same slots, or None.
    starts: [S] int32 each row's CSR start.
    offsets: [S, K] int32 drawn offsets within the rows.

  On the card every tensor must be contiguous int32 on one device (the
  wrapper checks and raises ``ValueError``; it converts nothing).

  Returns ``(picks, eid_picks)``, [S, K] int32 each (``eid_picks`` None
  without ``eids``): ``picks[i, k] = indices[clip(starts[i] +
  offsets[i, k], 0, E - 1)]`` on every lane, valid or not, the clip of
  ``glt_tpu/ops/sample.py`` ``_slots_i32``.
  """
  if not offsets.is_cuda:
    return sample_hop_plain(indices, eids, starts, offsets)
  dev = offsets.get_device()
  shape = offsets.shape
  # one pass over every condition the kernel needs, each tensor property
  # read once (the launch path's host time is the hop's cost);
  # _refuse_picks names the condition that failed
  if not (len(shape) == 2 and offsets.dtype is _I32
          and starts.dtype is _I32 and indices.dtype is _I32
          and offsets.is_contiguous() and starts.is_contiguous()
          and indices.is_contiguous()
          and starts.get_device() == dev == indices.get_device()
          and starts.numel() == shape[0]
          and (m := shape[0] * shape[1]) < _LANES
          and ((n := indices.numel()) or not m)
          and (eids is None or (eids.dtype is _I32 and eids.is_contiguous()
                                and eids.get_device() == dev))):
    _refuse_picks(indices, eids, starts, offsets)
  picks = torch.empty_like(offsets)
  if eids is None:
    eid_picks = eids_ptr = eid_picks_ptr = None
  else:
    eid_picks = torch.empty_like(offsets)
    eids_ptr, eid_picks_ptr = eids.data_ptr(), eid_picks.data_ptr()
  if m:
    count_launch(sample_hop, _check(glt_sample_hop(
        indices.data_ptr(), eids_ptr, n, starts.data_ptr(),
        offsets.data_ptr(), shape[0], shape[1], picks.data_ptr(),
        eid_picks_ptr, dev, _raw_stream(dev)), 'sample_hop'))
  return picks, eid_picks


def _refuse_picks(indices, eids, starts, offsets):
  """The ValueError for inputs :func:`sample_hop`'s kernel does not take."""
  _refuse_planes('sample_hop', offsets, indices=indices, eids=eids,
                 starts=starts, offsets=offsets)
  _check_pick_inputs(indices, starts, offsets)


def _refuse_planes(what, ref, **planes):
  bad = [f'{n} {t.dtype} on {t.device}'
         f'{"" if t.is_contiguous() else " (strided)"}'
         for n, t in planes.items()
         if t is not None and (t.dtype is not _I32 or not t.is_contiguous()
                               or t.device != ref.device)]
  if bad:
    raise ValueError(f'{what} takes contiguous int32 tensors on one card, '
                     f'got ' + ', '.join(bad))


# -- B3: gather_windows ---------------------------------------------------------

def _check_window_inputs(arr, starts, width):
  if arr.dim() != 1 or arr.element_size() != 4:
    raise ValueError(f'gather_windows reads a 1-D array of 4-byte elements, '
                     f'got {tuple(arr.shape)} {arr.dtype}')
  if width <= 0:
    raise ValueError(f'window width must be positive, got {width}')
  if starts.numel() and arr.numel() == 0:
    raise ValueError('gather_windows reads from an empty array')
  if starts.numel() * width >= 2 ** 31:
    raise ValueError('a window read addresses its lanes with int32')


def gather_windows_plain(arr: torch.Tensor, starts: torch.Tensor,
                         width: int) -> torch.Tensor:
  """:func:`gather_windows` in plain PyTorch: one ``torch.take`` over the
  clipped ``[S, width]`` slots."""
  _check_window_inputs(arr, starts, width)
  win = torch.arange(width, device=starts.device)
  slots = (starts.long()[:, None] + win).clamp(0, max(arr.numel() - 1, 0))
  return torch.take(arr, slots)


def gather_windows(arr: torch.Tensor, starts: torch.Tensor,
                   width: int) -> torch.Tensor:
  """Contiguous windows of ``arr``: ``out[i, j] = arr[clip(starts[i] + j,
  0, len - 1)]``.

  Args:
    arr: [E] float32 or int32 (any 4-byte type): edge weights or
      neighbour ids.
    starts: [S] int32 each row's CSR start.
    width: the static window width (the hop's ``max_degree``).

  On the card ``arr`` and ``starts`` must be contiguous, on one device
  (the wrapper checks and raises ``ValueError``; it converts nothing).

  Returns ``[S, width]`` of ``arr``'s dtype. The TPU kernel clamps whole
  windows into an array padded by ``width`` sentinels; this one clips
  each element, so lanes ``j < deg`` read the row's neighbours and lanes
  past it read whatever follows, which every caller masks.
  """
  if not arr.is_cuda:
    return gather_windows_plain(arr, starts, width)
  dev = arr.get_device()
  if not (starts.dtype is _I32 and starts.dim() == 1
          and starts.is_contiguous() and arr.is_contiguous()
          and starts.get_device() == dev and arr.dim() == 1
          and arr.element_size() == 4 and width > 0
          and (s := starts.numel()) * width < _LANES
          and ((n := arr.numel()) or not s)):
    _refuse_windows(arr, starts, width)
  out = arr.new_empty(s, width)
  if s:
    count_launch(gather_windows, _check(glt_gather_windows(
        arr.data_ptr(), n, starts.data_ptr(), s, width, out.data_ptr(),
        dev, _raw_stream(dev)), 'gather_windows'))
  return out


def _refuse_windows(arr, starts, width):
  """The ValueError for inputs :func:`gather_windows`' kernel does not
  take."""
  _refuse_planes('gather_windows', arr, starts=starts)
  if not arr.is_contiguous() or starts.dim() != 1:
    raise ValueError(f'gather_windows takes a contiguous arr and 1-D '
                     f'starts, got arr strides {arr.stride()}, starts '
                     f'{tuple(starts.shape)}')
  _check_window_inputs(arr, starts, width)


KERNELS = (gather_rows, gather_rows_mixed, dedup_table_insert,
           sample_walk_dedup, sample_hop_dedup, sample_hop, gather_windows)
reset_launch_counts()
