"""Exact seed dedup/relabel and the node-list build (counterpart of
glt_tpu/ops/unique.py).

The seed hop must stay bit-identical to every engine of the JAX package:
``batch``, ``seed_labels`` and hop 1's frontier order all come from
:func:`sorted_hop_dedup`. It is two sorts over the batch, as in JAX; the
per-hop dedup of the walk lives in the walk kernel
(ops/cuda_kernels.py ``sample_walk_dedup``). The per-hop loop of the
live-update stream dedups each hop with :func:`sorted_hop_dedup_fused`.
:func:`ordered_unique` (first-occurrence order, inverse labels) labels the
nodes of an induced subgraph (ops/subgraph.py).
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

BIG = torch.iinfo(torch.int32).max


def ordered_unique(ids: torch.Tensor, valid: torch.Tensor, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """First-occurrence-ordered unique with inverse labels, fixed shapes
  (counterpart of ``glt_tpu.ops.unique.ordered_unique``).

  ``capacity`` must be at least the number of distinct valid ids. Returns
  ``uniq`` [capacity] (distinct ids in order of first appearance, -1
  padded, ``ids``' dtype), ``count`` (int32 scalar) and ``inverse`` [M]
  int32 (each slot's position in ``uniq``, -1 where ``~valid``). A
  stable sort by value marks each run's head (its first slot); the runs
  are then ordered by their heads' slots.
  """
  dev = ids.device
  m = ids.numel()
  big = torch.iinfo(ids.dtype).max
  x = torch.where(valid, ids, torch.full_like(ids, big))
  xs, order = torch.sort(x, stable=True)
  head = torch.ones(m, dtype=torch.bool, device=dev)
  head[1:] = xs[1:] != xs[:-1]
  head &= xs != big
  seg = torch.cumsum(head, 0) - 1
  # each run's first sorted slot (runs past ``capacity`` are dropped, as
  # the JAX ``nonzero(size=capacity)`` drops them)
  run_starts = torch.full((capacity + 1,), m, dtype=torch.long, device=dev)
  run_starts.scatter_(0, torch.where(head & (seg < capacity), seg,
                                     capacity),
                      torch.arange(m, device=dev))
  run_starts = run_starts[:capacity]
  run_ok = run_starts < m
  safe = run_starts.clamp(max=max(m - 1, 0))
  run_first_pos = torch.where(run_ok, order[safe], m)
  run_vals = torch.where(run_ok, xs[safe], torch.full_like(xs[safe], big))
  aorder = torch.sort(run_first_pos, stable=True).indices
  uniq = run_vals[aorder]
  count = head.sum(dtype=torch.int32)
  rank = torch.zeros(capacity, dtype=torch.int32, device=dev)
  rank[aorder] = torch.arange(capacity, dtype=torch.int32, device=dev)
  seg_at_orig = torch.zeros(m, dtype=torch.long, device=dev)
  seg_at_orig[order] = seg
  inverse = rank[seg_at_orig.clamp(0, capacity - 1)]
  inverse = torch.where(valid, inverse, torch.full_like(inverse, -1))
  uniq = torch.where(torch.arange(capacity, device=dev) < count, uniq,
                     torch.full_like(uniq, -1))
  return uniq, count, inverse


def sorted_hop_dedup(u_ids: torch.Tensor, u_labs: torch.Tensor,
                     count: Union[int, torch.Tensor], ids: torch.Tensor,
                     valid: torch.Tensor) -> Dict[str, torch.Tensor]:
  """One hop of exact dedup/relabel against an append-form seen-set.

  Seen ids keep their labels; new ids get ``count..count+n-1`` in
  first-occurrence (slot) order. Per-element outputs come in the
  appearance-grouped order of ``glt_tpu.ops.unique.sorted_hop_dedup``:
  new ids grouped under their first slot, every other slot at its own
  position, ascending; within a group by slot. Invalid slots carry
  ``BIG`` in ``ids3``.

  Returns ``ids3``, ``labels3``, ``new_head3``, ``pos3`` ([M] each,
  aligned), ``u_ids2``/``u_labs2`` (the seen-set with this hop's new ids
  appended, ``BIG`` padded), ``count2`` and ``new_count`` (int32
  scalars).
  """
  dev = ids.device
  c, m = u_ids.numel(), ids.numel()
  x = torch.where(valid, ids.to(torch.int32),
                  torch.full_like(ids, BIG, dtype=torch.int32))
  cat_id = torch.cat([u_ids.to(torch.int32), x])
  cat_pos = torch.cat([torch.full((c,), -1, dtype=torch.int64, device=dev),
                       torch.arange(m, device=dev)])
  cat_lab = torch.cat([u_labs.to(torch.int32),
                       torch.full((m,), -1, dtype=torch.int32, device=dev)])
  # sort 1 by (id, pos): the concatenation is already in pos order, so a
  # stable sort by id is the two-key sort; a seen entry (pos -1) heads
  # its id's run
  order = torch.sort(cat_id, stable=True).indices
  sid, spos, slab = cat_id[order], cat_pos[order], cat_lab[order]
  n = c + m
  iota = torch.arange(n, device=dev)
  hd = torch.ones(n, dtype=torch.bool, device=dev)
  hd[1:] = sid[1:] != sid[:-1]
  head = torch.where(hd, iota, torch.zeros_like(iota)).cummax(0).values
  head_slab, head_spos = slab[head], spos[head]
  ok = sid != BIG
  is_new_run = (head_slab < 0) & ok
  u_lab = torch.where(is_new_run | ~ok, torch.full_like(slab, -1),
                      head_slab)
  # sort 2 by (group key, pos): new runs group under their head slot,
  # seen/invalid slots key by their own slot, seen-set entries last
  gkey = torch.where(spos >= 0, torch.where(is_new_run, head_spos, spos),
                     torch.full_like(spos, BIG))
  order2 = torch.sort(gkey * (m + 2) + (spos + 1)).indices[:m]
  pos3, ids3, gkey3 = spos[order2], sid[order2], gkey[order2]
  ulab3, new3 = u_lab[order2], is_new_run[order2]
  new_head3 = new3 & (pos3 == gkey3)
  rank = torch.cumsum(new_head3.to(torch.int32), 0, dtype=torch.int32)
  labels3 = torch.where(new3, count + rank - 1, ulab3).to(torch.int32)
  new_count = rank[-1] if m > 0 else torch.zeros((), dtype=torch.int32,
                                                  device=dev)
  big = torch.full_like(ids3, BIG)
  return dict(
      ids3=ids3, labels3=labels3, new_head3=new_head3, pos3=pos3,
      u_ids2=torch.cat([u_ids.to(torch.int32),
                        torch.where(new_head3, ids3, big)]),
      u_labs2=torch.cat([u_labs.to(torch.int32),
                         torch.where(new_head3, labels3, big)]),
      count2=(count + new_count).to(torch.int32), new_count=new_count)


def sorted_hop_dedup_fused(u_ids: torch.Tensor, u_labs: torch.Tensor,
                           count: Union[int, torch.Tensor], ids: torch.Tensor,
                           valid: torch.Tensor) -> Dict[str, torch.Tensor]:
  """One hop of dedup/relabel against the append-form seen-set, outputs in
  slot order (counterpart of ``glt_tpu.ops.unique.sorted_hop_dedup_fused``,
  the ``GLT_FUSED_HOP`` contract): seen ids keep their labels, the hop's
  new ids get ``count..count+n-1`` in value order, and each new id's head
  is its minimum slot.

  Seen ids are found by a binary search of the sorted seen-set (its
  ``BIG`` padding never matches a valid id). The new ids are ranked over
  all M lanes, as the JAX function ranks them under ``jit``: a stable
  sort of the new lanes (every other lane ``BIG``), a flag on the first
  lane of each run of one value, which is that id's minimum slot, and a
  cumulative sum of the flags. Every shape is fixed by M and nothing is
  read back, so a CUDA graph can hold the hop.

  Returns ``labels3`` (-1 at ``~valid``), ``new_head3`` ([M] each),
  ``u_ids2``/``u_labs2`` (the seen-set with the new ids appended, ``BIG``
  padded), ``count2`` and ``new_count`` (int32 scalars on the device).
  """
  dev = ids.device
  m = ids.numel()
  x = torch.where(valid, ids.to(torch.int32),
                  torch.full_like(ids, BIG, dtype=torch.int32))
  seen_ids, order = torch.sort(u_ids.to(torch.int32))
  seen_labs = u_labs.to(torch.int32)[order]
  if seen_ids.numel():
    pos = torch.searchsorted(seen_ids, x).clamp(max=seen_ids.numel() - 1)
    found = valid & (seen_ids[pos] == x)
    seen_lab = seen_labs[pos]
  else:
    found = torch.zeros_like(valid)
    seen_lab = torch.full_like(x, -1)
  new_el = valid & ~found
  xs, order = torch.sort(torch.where(new_el, x, torch.full_like(x, BIG)),
                         stable=True)
  run_head = torch.ones(m, dtype=torch.bool, device=dev)
  run_head[1:] = xs[1:] != xs[:-1]
  run_head &= xs != BIG
  rank_sorted = torch.cumsum(run_head, 0, dtype=torch.int32) - 1
  rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
  new_head3 = torch.empty_like(run_head).scatter_(0, order, run_head)
  labels3 = torch.where(found, seen_lab, torch.where(
      new_el, (count + rank).to(torch.int32),
      torch.full_like(x, -1))).to(torch.int32)
  new_count = run_head.sum(dtype=torch.int32)
  big = torch.full_like(x, BIG)
  return dict(
      labels3=labels3, new_head3=new_head3,
      u_ids2=torch.cat([u_ids.to(torch.int32),
                        torch.where(new_head3, x, big)]),
      u_labs2=torch.cat([u_labs.to(torch.int32),
                         torch.where(new_head3, labels3, big)]),
      count2=(count + new_count).to(torch.int32), new_count=new_count)


def sorted_nodes_by_label(u_ids: torch.Tensor, u_labs: torch.Tensor,
                          count: torch.Tensor, budget: int) -> torch.Tensor:
  """The dense node list (position = label) from the append-form
  seen-set; -1 past ``count``. Labels are unique, so one scatter places
  every id (padding routes to a sink slot)."""
  live = (u_labs >= 0) & (u_labs < budget)
  idx = torch.where(live, u_labs, torch.full_like(u_labs, budget)).long()
  nodes = torch.full((budget + 1,), -1, dtype=torch.int32,
                     device=u_ids.device)
  nodes = nodes.scatter(0, idx, u_ids.to(torch.int32))[:budget]
  lanes = torch.arange(budget, device=u_ids.device) < count
  return torch.where(lanes, nodes, torch.full_like(nodes, -1))
