"""The partitioned one-hop and the homogeneous sampler over it
(counterpart of glt_tpu/distributed/dist_neighbor_sampler.py).

A hop over a partitioned graph is the exchange of
``parallel/collectives.py``::

    owner = node_pb[frontier]            # the partition book
    all_to_all(requests)                 # to the rows' owners
    sample_neighbors on each owner       # the B2 kernel (sample_hop)
    all_to_all(answers)                  # back to the requesters
    unbucket                             # each answer at its request

and the hop loop and its dedup run unchanged from ``ops/pipeline.py``
with this one-hop in place of the in-memory one.

Randomness: the owner draws the offsets of the requests it serves, from
its own stream (the JAX package folds the hop key by the serving
device's index, dist_neighbor_sampler.py:69). So the uniforms a one-hop
takes are the serving rank's, ``[world * F, fanout]`` over the requests
it received (row p's bucket of F slots at rows ``[p*F, (p+1)*F)``).

With ``with_edge`` the owner also reads each pick's global edge id (the
``eids`` plane of the same B2 launch), which rides back beside the
neighbours: ``out['edge']``, -1 on invalid lanes.

The owner's other two hops (dist_neighbor_sampler.py:76-88):

* weighted (``with_weight`` over a store with edge weights): B3
  (``gather_windows``) reads each served row's ``[W]`` weight window, a
  Gumbel top-k over the serving rank's uniforms ``[world * F, W]`` picks,
  and B2 (``sample_hop``) reads the picks and their edge ids; ``W =
  max(max_weighted_degree, fanout)``, so a hub row draws among its first
  ``W`` neighbours;
* full neighbourhood (fanout ``-w``, the resolved ``-1``): B3 windows of
  width ``w`` over ``indices`` and, for edge ids, a second over the ids;
  it draws nothing.

Either answer rides back at the hop's width, as the uniform hop's does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.pipeline import edge_hop_offsets, multihop_sample_sorted
from ..ops.sample import (NeighborOutput, sample_full_neighbors,
                          sample_neighbors, sample_neighbors_weighted,
                          weighted_hop_uniforms)
from ..parallel.collectives import all_to_all, bucket_by_owner, unbucket
from ..parallel.mesh import Mesh
from ..utils import RandomSeedManager, as_numpy, make_generator
from .dist_graph import DistGraph, store_tensors


def make_dist_one_hop(graph_shards: Dict[str, torch.Tensor], num_nodes: int,
                      n_parts: int, rows_max: int, mesh: Mesh,
                      with_weight: bool = False,
                      max_weighted_degree: int = 0):
  """The partitioned one-hop over this rank's block (dist_neighbor_
  sampler.py:38-96).

  ``graph_shards``: this rank's ``indptr`` [R+1], ``indices`` [E],
  ``local_row`` [N], ``node_pb`` [N] and, for edge ids in the output,
  int32 ``edge_ids`` [E], for the weighted hop ``edge_weights`` [E]
  (:func:`~glt_tpu_torch.distributed.dist_graph.store_tensors`).

  Returns ``one_hop(ids [F], fanout, u, mask [F]) -> NeighborOutput``
  ([F, |fanout|], ``eids`` given ``edge_ids``): a collective, every rank
  calls it with the same F and fanout. ``u`` is this rank's draw over the
  requests it serves: ``[world * F, fanout]`` for a uniform hop, ``[world
  * F, max(max_weighted_degree, fanout)]`` for a weighted one (``with_
  weight`` and weights in the shards), None for a full hop (fanout < 0,
  window ``-fanout``)."""
  indptr, indices = graph_shards['indptr'], graph_shards['indices']
  local_row, node_pb = graph_shards['local_row'], graph_shards['node_pb']
  eids = graph_shards.get('edge_ids')
  weights = graph_shards.get('edge_weights') if with_weight else None

  def one_hop(ids: torch.Tensor, fanout: int, u: Optional[torch.Tensor],
              mask: torch.Tensor) -> NeighborOutput:
    f, width = ids.numel(), abs(fanout)
    owner = node_pb.index_select(0, ids.long().clamp(0, num_nodes - 1))
    owner = torch.where(mask, owner, torch.full_like(owner, n_parts))
    req, meta = bucket_by_owner(ids.to(torch.int32), owner, n_parts)
    req_in = all_to_all(req, mesh).reshape(-1)          # [P * F]
    lrow = local_row.index_select(0, req_in.long().clamp(0, num_nodes - 1))
    ok = (req_in >= 0) & (lrow >= 0)
    rows = lrow.clamp(0, rows_max - 1)
    if fanout < 0:
      out = sample_full_neighbors(indptr, indices, rows, width,
                                  seed_mask=ok, edge_ids=eids)
    elif weights is not None:
      out = sample_neighbors_weighted(
          indptr, indices, weights, rows, fanout, u,
          max(max_weighted_degree, fanout), seed_mask=ok, edge_ids=eids)
    else:
      out = sample_neighbors(indptr, indices, rows, fanout, u, seed_mask=ok,
                             edge_ids=eids)

    def back(x, invalid):
      resp = all_to_all(x.reshape(n_parts, f, width), mesh)
      return unbucket(resp, meta, n_parts, invalid_value=invalid)
    nbrs = back(out.nbrs, 0)
    # the validity plane travels as bytes (gloo has no bool collectives)
    nmask = back(out.mask.to(torch.uint8), 0) != 0
    out_eids = None if eids is None else back(out.eids, -1)
    return NeighborOutput(nbrs=nbrs, mask=nmask & mask[:, None],
                          eids=out_eids)

  return one_hop


def own_block(x, mesh: Mesh, per_rank: int) -> np.ndarray:
  """This rank's block ``[rank*per_rank, (rank+1)*per_rank)`` of a
  shard-major ``[world, per_rank]`` or ``[world * per_rank]`` array."""
  flat = as_numpy(x).reshape(-1)
  return flat[mesh.rank * per_rank:(mesh.rank + 1) * per_rank]


def check_fanouts(fanouts: Sequence[int], full_neighbor_cap: Optional[int],
                  max_degree: int) -> List[int]:
  """Fanouts 0 or positive stay; ``-1`` becomes ``-(full_neighbor_cap or
  max_degree)``, the full hop's static window (dist_neighbor_sampler.py:
  110-119); any other negative fanout raises."""
  out = []
  for f in fanouts:
    f = int(f)
    if f == -1:
      cap = int(full_neighbor_cap or max_degree)
      if cap <= 0:
        raise ValueError('fanout -1 needs full_neighbor_cap or a store '
                         'with a known max_degree')
      f = -cap
    elif f < 0:
      raise ValueError(f'fanout must be >= 0 or -1, got {f}')
    out.append(f)
  return out


def hop_uniform_shape(world: int, frontier: int, fanout: int,
                      weight_window: Optional[int]):
  """The draw a rank serves one hop of ``frontier`` requests a rank with:
  ``(world * F, fanout)`` uniform, ``(world * F, max(weight_window,
  fanout))`` weighted (``weight_window`` not None), None for a full hop
  (``fanout < 0``)."""
  if fanout < 0:
    return None
  if weight_window is not None:
    return (world * frontier, max(weight_window, fanout))
  return (world * frontier, fanout)


def draw_hop_uniforms(generator: torch.Generator, shape, weighted: bool,
                      device) -> Optional[torch.Tensor]:
  """A hop's draw of ``shape`` (None: nothing), weighted ones mapped into
  ``[1e-20, 1)`` as :func:`~glt_tpu_torch.ops.sample.
  weighted_hop_uniforms` maps them."""
  if shape is None:
    return None
  if weighted:
    return weighted_hop_uniforms(generator, shape[0], shape[1], device)
  return torch.rand(shape, generator=generator, device=device)


class DistNeighborSampler:
  """Multi-hop sampling over a :class:`DistGraph`, one seed block a rank
  (dist_neighbor_sampler.py:99): the per-hop loop of
  ``ops.pipeline.multihop_sample_sorted`` over :func:`make_dist_one_hop`.

  Args:
    dist_graph: this rank's block.
    num_neighbors: per-hop fanouts, positive or ``-1`` (every neighbour,
      inside a window of ``full_neighbor_cap`` or the store's
      ``max_degree``).
    with_edge: also return each sampled edge's global id (``'edge'``).
    with_weight: weight-proportional positive hops, when the store keeps
      edge weights (uniform otherwise, as in JAX).
    max_weighted_degree: a weighted hop's window (default the store's
      ``max_degree``; a hop never draws from fewer than its fanout).
    seed: seed of the rank's generator (``seed + rank``; default the
      process-wide seed), which draws the uniforms a call is given none.
    full_neighbor_cap: the window of a ``-1`` hop.
  """

  def __init__(self, dist_graph: DistGraph, num_neighbors: Sequence[int],
               with_edge: bool = False, with_weight: bool = False,
               max_weighted_degree: Optional[int] = None,
               seed: Optional[int] = None,
               full_neighbor_cap: Optional[int] = None):
    self.g = dist_graph
    self.mesh = dist_graph.mesh
    self.with_edge = bool(with_edge)
    self.with_weight = bool(with_weight) and (
        dist_graph.edge_weights is not None)
    self.max_weighted_degree = int(max_weighted_degree
                                   or dist_graph.max_degree)
    self.num_neighbors = check_fanouts(num_neighbors, full_neighbor_cap,
                                       dist_graph.max_degree)
    self._one_hop = make_dist_one_hop(
        store_tensors(dist_graph, with_edge=self.with_edge,
                      with_weight=self.with_weight),
        dist_graph.num_nodes,
        dist_graph.num_partitions, dist_graph.max_rows, self.mesh,
        with_weight=self.with_weight,
        max_weighted_degree=self.max_weighted_degree)
    base = (seed if seed is not None
            else RandomSeedManager.getInstance().getSeed())
    self.generator = make_generator(base + self.mesh.rank, self.mesh.device)

  def uniform_shapes(self, batch_size: int) -> List[Optional[Tuple[int, int]]]:
    """Per hop the draw a rank serves with (:func:`hop_uniform_shape`):
    ``[world * F_h, K_h]``, ``[world * F_h, W]`` for a weighted hop, None
    for a full one."""
    shapes, f = [], batch_size
    window = self.max_weighted_degree if self.with_weight else None
    for k in self.num_neighbors:
      shapes.append(hop_uniform_shape(self.mesh.world, f, k, window))
      f *= abs(k)
    return shapes

  def own_uniforms(self, uniforms, batch_size: int
                   ) -> List[Optional[torch.Tensor]]:
    """This rank's row of per-hop ``[world, *shape]`` draws on its device
    (None for a full hop), or, for ``uniforms=None``, its own draws from
    its generator."""
    dev = self.mesh.device
    if uniforms is None:
      return [draw_hop_uniforms(self.generator, s, self.with_weight, dev)
              for s in self.uniform_shapes(batch_size)]
    return [None if x is None
            else torch.as_tensor(x)[self.mesh.rank].to(dev, torch.float32)
            for x in uniforms]

  def sample_local(self, seeds: torch.Tensor, n_valid, u_hops
                   ) -> Dict[str, torch.Tensor]:
    """This rank's walk from ``seeds [B]`` on its device (``n_valid`` an
    int or a 0-dim tensor, ``u_hops`` per hop this rank's draw); the
    output dict of ``multihop_sample_sorted`` (with ``edge`` given
    ``with_edge``)."""
    fanouts = self.num_neighbors
    return multihop_sample_sorted(
        lambda h, ids, mask, u: self._one_hop(ids, fanouts[h], u, mask),
        seeds, n_valid, fanouts, u_hops, with_edge=self.with_edge)

  def sample_from_nodes(self, seeds_per_device, n_valid_per_device=None,
                        uniforms=None) -> Dict[str, torch.Tensor]:
    """``seeds_per_device [world, B]`` (or shard-major ``[world * B]``)
    and ``n_valid_per_device [world]`` (default all B), the same on every
    rank; ``uniforms`` per hop ``[world, *shape]`` (rank r reads row r;
    :meth:`uniform_shapes`, None for a full hop) or None (drawn). Returns
    this rank's output dict plus ``edge_hop_offsets``."""
    mesh = self.mesh
    seeds = as_numpy(seeds_per_device).reshape(-1)
    b = seeds.shape[0] // mesh.world
    mine = torch.as_tensor(own_block(seeds, mesh, b).astype(np.int32),
                           device=mesh.device)
    n_valid = (b if n_valid_per_device is None
               else int(as_numpy(n_valid_per_device).reshape(-1)[mesh.rank]))
    out = self.sample_local(mine, n_valid, self.own_uniforms(uniforms, b))
    out['edge_hop_offsets'] = edge_hop_offsets(b, self.num_neighbors)
    return out
