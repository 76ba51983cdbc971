"""Delta-aware one-hop sampling: base CSR + insert window - tombstones
(counterpart of glt_tpu/ops/delta.py).

The live-update subsystem (:mod:`glt_tpu_torch.stream`) keeps sampling on
an immutable CSR snapshot and layers mutations on top as two small
capacity-padded CSR overlays: the edges inserted since the last
compaction and the edges deleted since then. :func:`delta_one_hop` merges
both into one hop: the base hop samples as usual, base lanes whose
neighbour appears in the frontier row's tombstone window are masked out,
and up to ``ins_window`` inserted neighbours per frontier row are
appended. The output width is ``abs(fanout) + ins_window``.

Exactness, as in the JAX package: full-neighbourhood hops (``fanout <
0``) are exact over ``(base \\ tombstones) ∪ inserts`` while each row's
delta fits its window; uniform hops draw from the base adjacency and drop
tombstoned picks, so a row with pending deletes sees a reduced fanout
until compaction, and its inserted edges join through the full insert
window.
"""
from __future__ import annotations

from typing import Optional

import torch

from .sample import NeighborOutput, sample_full_neighbors, sample_neighbors


def tombstone_mask(nbrs: torch.Tensor, mask: torch.Tensor,
                   del_nbrs: torch.Tensor,
                   del_mask: torch.Tensor) -> torch.Tensor:
  """The [S, K] validity of a one-hop sample with tombstoned lanes
  cleared. ``del_nbrs``/``del_mask`` [S, W] are the frontier rows'
  tombstone windows. A delete of (u, v) kills every sampled copy of v
  under u: multigraph deletes remove all instances."""
  hit = (nbrs[:, :, None] == del_nbrs[:, None, :]) & del_mask[:, None, :]
  return mask & ~hit.any(dim=-1)


def delta_one_hop(indptr: torch.Tensor, indices: torch.Tensor,
                  ins_indptr: torch.Tensor, ins_indices: torch.Tensor,
                  del_indptr: torch.Tensor, del_indices: torch.Tensor,
                  frontier: torch.Tensor, fanout: int,
                  u: Optional[torch.Tensor],
                  seed_mask: Optional[torch.Tensor], ins_window: int,
                  del_window: int) -> NeighborOutput:
  """One delta-merged hop; output width ``abs(fanout) + ins_window``.

  Args:
    indptr/indices: base CSR (``indices`` may be padded past the live
      edges to the snapshot's capacity; valid lanes never read the pad).
    ins_indptr/ins_indices: the insert overlay over the same rows,
      ``indices`` padded to the delta capacity.
    del_indptr/del_indices: the tombstone overlay, same contract.
    frontier: [S] row ids to expand; ``seed_mask`` [S] their validity.
    fanout: positive: a uniform sample without replacement drawn from
      ``u`` ([S, fanout], :func:`~glt_tpu_torch.ops.sample.sample_neighbors`),
      read through the ``sample_hop`` kernel; negative: the full neighbourhood inside
      a ``-fanout`` window (``u`` unused).
    ins_window/del_window: per-row overlay windows; a row with more
      pending inserts (deletes) than its window truncates (under-masks)
      until compaction.
  """
  if fanout < 0:
    base = sample_full_neighbors(indptr, indices, frontier, -fanout,
                                 seed_mask=seed_mask)
  else:
    base = sample_neighbors(indptr, indices, frontier, fanout, u,
                            seed_mask=seed_mask)
  keep = base.mask
  if del_window > 0:
    dels = sample_full_neighbors(del_indptr, del_indices, frontier,
                                 del_window, seed_mask=seed_mask)
    keep = tombstone_mask(base.nbrs, base.mask, dels.nbrs, dels.mask)
  if ins_window <= 0:
    return NeighborOutput(nbrs=base.nbrs, mask=keep)
  ins = sample_full_neighbors(ins_indptr, ins_indices, frontier, ins_window,
                              seed_mask=seed_mask)
  return NeighborOutput(nbrs=torch.cat([base.nbrs, ins.nbrs], dim=1),
                        mask=torch.cat([keep, ins.mask], dim=1))
