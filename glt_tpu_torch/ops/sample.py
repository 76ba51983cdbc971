"""Uniform neighbour draws (counterpart of glt_tpu/ops/sample.py).

The walk's offsets are a pure function of (degree, uniforms): Floyd's
algorithm without replacement, or ``min(int(u * deg), deg - 1)`` with
replacement, in float32 with truncation toward zero -- the arithmetic of
the TPU draw, so injected ``jax.random`` uniforms reproduce its picks bit
for bit. The CUDA walk computes the same formula per thread; the helpers
here are the plain version's and the tests'.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

#: the walk kernel keeps one row's offsets in registers (kMaxFanout)
MAX_FANOUT = 64


def walk_geometry(batch_size: int,
                  fanouts: Sequence[int]) -> List[Tuple[int, int]]:
  """``[(S_h, K_h)]`` per hop: hop h's frontier rows and fanout. Hop
  h+1's frontier is every slot of hop h, heads or not (non-heads carry
  INT32_MAX), so ``S_{h+1} = S_h * K_h``."""
  hops, s = [], max(int(batch_size), 1)
  for k in fanouts:
    k = int(k)
    if not 0 < k <= MAX_FANOUT:
      raise ValueError(f'the walk serves fanouts in [1, {MAX_FANOUT}], '
                       f'got {k}')
    hops.append((s, k))
    s *= k
  return hops


def _floyd_offsets(deg: torch.Tensor, u: torch.Tensor,
                   fanout: int) -> torch.Tensor:
  """Floyd's uniform sampling of ``fanout`` distinct offsets from
  ``[0, deg)``; valid only where ``deg >= fanout``. ``u``: [S, fanout]."""
  cols: List[torch.Tensor] = []
  for j in range(fanout):
    bound = torch.clamp(deg - fanout + j, min=0)
    t = torch.minimum((u[:, j] * (bound + 1).to(u.dtype)).to(torch.int32),
                      bound)
    if cols:
      dup = (torch.stack(cols, 1) == t[:, None]).any(1)
      t = torch.where(dup, bound, t)
    cols.append(t)
  return torch.stack(cols, 1)


def _hop_degrees(indptr_pad: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """Row start and masked degree per frontier id. ``indptr_pad`` is
  [N + 2] with a trailing ``num_edges`` sentinel, so an invalid id
  (INT32_MAX) clamps to row N and reads degree 0."""
  n = indptr_pad.numel() - 2
  addr = ids.long().clamp(0, n)
  start = indptr_pad[addr].to(torch.int32)
  deg = (indptr_pad[addr + 1] - indptr_pad[addr]).to(torch.int32)
  return start, torch.where(mask, deg, torch.zeros_like(deg))


def hop_valid_mask(deg: torch.Tensor, fanout: int,
                   replace: bool) -> torch.Tensor:
  """[S, K] lanes the draw marks valid, from the masked degrees alone."""
  if replace:
    return (deg[:, None] > 0).expand(deg.numel(), fanout)
  iota = torch.arange(fanout, device=deg.device)[None, :]
  return iota < torch.clamp(deg, max=fanout)[:, None]


def draw_offsets(deg: torch.Tensor, u: torch.Tensor, fanout: int,
                 replace: bool) -> Tuple[torch.Tensor, torch.Tensor]:
  """The uniform hop draw: ``(offsets [S, K] int32, mask [S, K])``."""
  if replace:
    off = torch.minimum((u * deg[:, None].to(u.dtype)).to(torch.int32),
                        torch.clamp(deg - 1, min=0)[:, None])
  else:
    iota = torch.arange(fanout, dtype=torch.int32,
                        device=deg.device)[None, :].expand(deg.numel(),
                                                           fanout)
    off = torch.where((deg <= fanout)[:, None], iota,
                      _floyd_offsets(deg, u, fanout))
  return off, hop_valid_mask(deg, fanout, replace)


def walk_hop_uniforms(generator: Optional[torch.Generator],
                      batch_size: int, fanouts: Sequence[int],
                      replace: bool, device) -> Tuple[torch.Tensor, ...]:
  """Per-hop uniforms of a walk, drawn from ``generator`` on ``device``:
  hop h is ``[S_h, K_h]`` float32, ``u[row, j]``. Shapes and orientation
  are those of ``glt_tpu.ops.sample.walk_hop_uniforms`` without its block
  padding: the Floyd draw is made ``(K, S)`` and transposed, the
  with-replacement draw is ``(S, K)``."""
  us = []
  for s, k in walk_geometry(batch_size, fanouts):
    if replace:
      u = torch.rand((s, k), generator=generator, device=device)
    else:
      u = torch.rand((k, s), generator=generator, device=device).T
    us.append(u.contiguous())
  return tuple(us)


class FusedHopPlan:
  """What the walk reads of a graph, built once per sampler: the CSR with
  its ``indptr_pad`` sentinel, the optional edge-id plane, the draw mode
  and the dedup-table size for the sampler's batch shape."""

  def __init__(self, indptr_pad: torch.Tensor, indices: torch.Tensor,
               table_slots: int, edge_ids: Optional[torch.Tensor] = None,
               replace: bool = False):
    self.indptr_pad = indptr_pad
    self.indices = indices
    self.table_slots = int(table_slots)
    self.edge_ids = edge_ids
    self.replace = bool(replace)
