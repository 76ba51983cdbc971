"""Negative edge sampling (counterpart of glt_tpu/ops/negative.py).

Every trial round is proposed at once, membership is an exact binary
search over the CSR (columns sorted within each row), and each request
takes its first passing round; with ``padding`` a request that passed no
round takes the last round's pair. No shape depends on the data.

The proposals are injected, as the sampler's uniforms are: tests pass
the JAX package's ``randint`` draws, and by default they come from the
caller's ``torch.Generator`` on the graph's device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


def edge_in_csr(indptr: torch.Tensor, indices: torch.Tensor,
                rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
  """Does edge ``rows[i] -> cols[i]`` exist? Exact over a CSR whose
  columns are sorted within each row (``Topology`` sorts them).

  A lower-bound binary search of a fixed number of steps: every row's
  span is at most ``len(indices)`` wide and each step halves it, so
  ``bit_length(len(indices))`` steps leave every search converged (the
  JAX package runs 34, enough for 2^34 edges). ``rows`` clip into the
  pointer's range, as ``take(mode='clip')`` clips them."""
  num_edges = indices.numel()
  if num_edges == 0:
    return torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
  n = indptr.numel() - 1
  r = rows.long().clamp(0, n)
  lo = indptr[r].long()
  end = indptr[(r + 1).clamp(0, n)].long()
  hi = end
  cols = cols.to(indices.dtype)
  top = num_edges - 1
  for _ in range(max(num_edges.bit_length(), 1)):
    probing = lo < hi
    mid = lo + ((hi - lo) >> 1)
    val = indices[mid.clamp(0, top)]
    go_right = probing & (val < cols)
    lo = torch.where(go_right, mid + 1, lo)
    hi = torch.where(probing & ~go_right, mid, hi)
  return (lo < end) & (indices[lo.clamp(0, top)] == cols)


class NegativeOutput(NamedTuple):
  rows: torch.Tensor   # [req] int32
  cols: torch.Tensor   # [req] int32
  mask: torch.Tensor   # [req] valid negatives (False only without
                       # padding, where every trial round hit an edge)


def negative_proposals(generator: Optional[torch.Generator], req_num: int,
                       trials_num: int, num_rows: int, num_cols: int,
                       device) -> Tuple[torch.Tensor, torch.Tensor]:
  """Uniform ``(rows, cols)`` proposals, [max(trials_num, 1), req_num]
  int32 each, from ``generator`` on ``device``."""
  t = max(int(trials_num), 1)
  rows = torch.randint(0, num_rows, (t, req_num), generator=generator,
                       device=device, dtype=torch.int32)
  cols = torch.randint(0, num_cols, (t, req_num), generator=generator,
                       device=device, dtype=torch.int32)
  return rows, cols


def random_negative_sample(indptr: torch.Tensor, indices: torch.Tensor,
                           req_num: int, trials_num: int, num_rows: int,
                           num_cols: int, strict: bool = True,
                           padding: bool = False, proposals=None,
                           generator: Optional[torch.Generator] = None
                           ) -> NegativeOutput:
  """``req_num`` node pairs that are, in strict mode, not edges.

  ``proposals``: ``(rows, cols)`` [max(trials_num, 1), req_num] each
  (default: :func:`negative_proposals` from ``generator``). A request
  takes the first trial round whose pair passes; strict mode passes only
  non-edges, non-strict every pair. With ``padding`` a request no round
  passed takes the last round's pair and every mask is True."""
  dev = indptr.device
  if proposals is None:
    proposals = negative_proposals(generator, req_num, trials_num, num_rows,
                                   num_cols, dev)
  prop_rows, prop_cols = (p.to(dev, torch.int32) for p in proposals)
  t = max(int(trials_num), 1)
  if tuple(prop_rows.shape) != (t, req_num) or prop_cols.shape != \
      prop_rows.shape:
    raise ValueError(f'proposals must be [{t}, {req_num}] each, got '
                     f'{tuple(prop_rows.shape)}, {tuple(prop_cols.shape)}')
  if strict:
    ok = ~edge_in_csr(indptr, indices, prop_rows.reshape(-1),
                      prop_cols.reshape(-1)).reshape(t, req_num)
  else:
    ok = torch.ones((t, req_num), dtype=torch.bool, device=dev)
  # the first passing round, round 0 where none passed (jnp.argmax's
  # answer for an all-False column)
  rounds = torch.arange(t, device=dev)[:, None]
  any_ok = ok.any(0)
  first = torch.where(ok, rounds, t).amin(0)
  first = torch.where(any_ok, first, torch.zeros_like(first))
  sel_rows = prop_rows.gather(0, first[None, :])[0]
  sel_cols = prop_cols.gather(0, first[None, :])[0]
  if padding:
    return NegativeOutput(
        rows=torch.where(any_ok, sel_rows, prop_rows[-1]),
        cols=torch.where(any_ok, sel_cols, prop_cols[-1]),
        mask=torch.ones(req_num, dtype=torch.bool, device=dev))
  return NegativeOutput(rows=sel_rows, cols=sel_cols, mask=any_ok)
