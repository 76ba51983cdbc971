"""Globally strict negative sampling over a partitioned graph (counterpart
of glt_tpu/distributed/dist_negative.py).

Each proposed ``(src, dst)`` pair goes to the rank that owns its row,
which tests it against its sorted block (``ops.negative.edge_in_csr``)
and sends the verdict back: the exchange of ``parallel/collectives.py``.
A negative is thus rejected if the edge exists anywhere in the
partitioned graph, which the reference's local check is not.

The proposals are injected, as the sampler's uniforms are (tests pass
the JAX package's ``randint`` draws); by default each rank draws its own
from its generator.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.negative import NegativeOutput, edge_in_csr
from ..parallel.collectives import (all_to_all, bucket_by_owner,
                                    bucket_payload, unbucket)
from ..parallel.mesh import Mesh
from ..utils import RandomSeedManager, make_generator
from .dist_graph import DistGraph, store_tensors


def make_dist_edge_membership(graph_shards: Dict[str, torch.Tensor],
                              num_nodes: int, n_parts: int, rows_max: int,
                              mesh: Mesh):
  """``member(rows, cols, valid) -> bool [B]``: does each global pair
  ``rows[i] -> cols[i]`` (in the store's row orientation) exist in the
  partitioned graph (dist_negative.py:27)? A collective: every rank calls
  it with the same B."""
  indptr, indices = graph_shards['indptr'], graph_shards['indices']
  local_row, node_pb = graph_shards['local_row'], graph_shards['node_pb']
  hi = num_nodes - 1

  def member(rows: torch.Tensor, cols: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    owner = node_pb.index_select(0, rows.long().clamp(0, hi))
    owner = torch.where(valid, owner, torch.full_like(owner, n_parts))
    req_rows, meta = bucket_by_owner(rows.to(torch.int32), owner, n_parts)
    req_cols = bucket_payload(cols.to(torch.int32), meta, n_parts,
                              fill_value=-1)
    rows_in = all_to_all(req_rows, mesh).reshape(-1)
    cols_in = all_to_all(req_cols, mesh).reshape(-1)
    lrow = local_row.index_select(0, rows_in.long().clamp(0, hi))
    ok = (rows_in >= 0) & (lrow >= 0) & (cols_in >= 0)
    exists = edge_in_csr(indptr, indices, lrow.clamp(0, rows_max - 1),
                         cols_in) & ok
    # the verdicts travel as bytes (gloo has no bool collectives)
    resp = all_to_all(exists.to(torch.uint8).reshape(n_parts, -1), mesh)
    return unbucket(resp, meta, n_parts, invalid_value=0) != 0

  return member


class DistRandomNegativeSampler:
  """Globally strict negative pairs over a :class:`DistGraph`, this
  rank's share (dist_negative.py:58): every trial round proposed at once,
  one membership exchange, each request the first round that passed;
  with ``padding`` a request no round passed takes the last round's
  pair.

  Args:
    dist_graph: this rank's block.
    trials_num: proposal rounds.
    padding: fill requests no round passed (every mask True).
    seed: seed of the rank's generator (``seed + rank``; default the
      process-wide seed), which draws proposals a call is given none.
  """

  def __init__(self, dist_graph: DistGraph, trials_num: int = 5,
               padding: bool = True, seed: Optional[int] = None):
    self.g = dist_graph
    self.mesh = dist_graph.mesh
    self.trials = max(int(trials_num), 1)
    self.padding = padding
    self._member = make_dist_edge_membership(
        store_tensors(dist_graph), dist_graph.num_nodes,
        dist_graph.num_partitions, dist_graph.max_rows, self.mesh)
    base = (seed if seed is not None
            else RandomSeedManager.getInstance().getSeed())
    self.generator = make_generator(base + self.mesh.rank, self.mesh.device)

  def _draw(self, req_num: int) -> torch.Tensor:
    return torch.randint(0, self.g.num_nodes, (self.trials, req_num),
                         generator=self.generator, device=self.mesh.device,
                         dtype=torch.int32)

  def _resolve(self, prop_r: torch.Tensor,
               prop_c: torch.Tensor) -> NegativeOutput:
    t, req = prop_r.shape
    # proposals are (src, dst); the store's rows are dst for edge_dir='in'
    q_rows, q_cols = ((prop_c, prop_r) if self.g.edge_dir == 'in'
                      else (prop_r, prop_c))
    exists = self._member(q_rows.reshape(-1), q_cols.reshape(-1),
                          torch.ones(t * req, dtype=torch.bool,
                                     device=prop_r.device)).reshape(t, req)
    ok = ~exists
    rounds = torch.arange(t, device=ok.device)[:, None]
    any_ok = ok.any(0)
    # the first passing round, round 0 where none passed (argmax's answer)
    first = torch.where(ok, rounds, t).amin(0)
    first = torch.where(any_ok, first, torch.zeros_like(first))[None]
    sel_r, sel_c = prop_r.gather(0, first)[0], prop_c.gather(0, first)[0]
    if self.padding:
      return NegativeOutput(
          rows=torch.where(any_ok, sel_r, prop_r[-1]),
          cols=torch.where(any_ok, sel_c, prop_c[-1]),
          mask=torch.ones(req, dtype=torch.bool, device=ok.device))
    return NegativeOutput(rows=sel_r, cols=sel_c, mask=any_ok)

  def _check(self, x, req_num: int) -> torch.Tensor:
    x = torch.as_tensor(x).to(self.mesh.device, torch.int32)
    if tuple(x.shape) != (self.trials, req_num):
      raise ValueError(f'proposals must be [{self.trials}, {req_num}], '
                       f'got {tuple(x.shape)}')
    return x

  def sample(self, req_num: int, proposals=None) -> NegativeOutput:
    """``req_num`` strict negative ``(src, dst)`` pairs of this rank (a
    collective: every rank asks the same number). ``proposals``: this
    rank's ``(rows, cols)`` ``[trials, req_num]`` each, or None
    (drawn)."""
    if proposals is None:
      return self._resolve(self._draw(req_num), self._draw(req_num))
    return self._resolve(*(self._check(p, req_num) for p in proposals))

  def sample_dst(self, src: torch.Tensor, proposals=None) -> NegativeOutput:
    """Per-source strict destinations (triplet mode): for each of this
    rank's ``src [R]``, a dst such that ``(src, dst)`` is no edge
    anywhere; ``rows`` are the sources. ``proposals``: ``[trials, R]``
    dsts, or None (drawn)."""
    src = torch.as_tensor(src).to(self.mesh.device, torch.int32).reshape(-1)
    r = src.numel()
    cols = (self._draw(r) if proposals is None
            else self._check(proposals, r))
    return self._resolve(src[None].expand(self.trials, r).contiguous(), cols)
