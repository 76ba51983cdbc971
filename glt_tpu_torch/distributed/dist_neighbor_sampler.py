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

Not ported (each raises until a caller needs it): the full-neighbourhood
hop (fanout -1, B3) and the weighted hop.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.pipeline import edge_hop_offsets, multihop_sample_sorted
from ..ops.sample import NeighborOutput, sample_neighbors
from ..parallel.collectives import all_to_all, bucket_by_owner, unbucket
from ..parallel.mesh import Mesh
from ..utils import RandomSeedManager, as_numpy, make_generator
from .dist_graph import DistGraph, store_tensors


def make_dist_one_hop(graph_shards: Dict[str, torch.Tensor], num_nodes: int,
                      n_parts: int, rows_max: int, mesh: Mesh,
                      with_weight: bool = False):
  """The partitioned one-hop over this rank's block (dist_neighbor_
  sampler.py:38-96).

  ``graph_shards``: this rank's ``indptr`` [R+1], ``indices`` [E],
  ``local_row`` [N], ``node_pb`` [N] and, for edge ids in the output,
  int32 ``edge_ids`` [E] (:func:`~glt_tpu_torch.distributed.dist_graph.
  store_tensors`).

  Returns ``one_hop(ids [F], fanout, u [world * F, fanout], mask [F]) ->
  NeighborOutput`` ([F, fanout], ``eids`` given ``edge_ids``): a
  collective, every rank calls it with the same F and fanout; ``u`` is
  this rank's draw over the requests it serves."""
  if with_weight:
    raise NotImplementedError('the weighted partitioned hop is not ported')
  indptr, indices = graph_shards['indptr'], graph_shards['indices']
  local_row, node_pb = graph_shards['local_row'], graph_shards['node_pb']
  eids = graph_shards.get('edge_ids')

  def one_hop(ids: torch.Tensor, fanout: int, u: torch.Tensor,
              mask: torch.Tensor) -> NeighborOutput:
    if fanout < 0:
      raise NotImplementedError('the full-neighbourhood partitioned hop '
                                '(fanout -1) is not ported')
    f = ids.numel()
    owner = node_pb.index_select(0, ids.long().clamp(0, num_nodes - 1))
    owner = torch.where(mask, owner, torch.full_like(owner, n_parts))
    req, meta = bucket_by_owner(ids.to(torch.int32), owner, n_parts)
    req_in = all_to_all(req, mesh).reshape(-1)          # [P * F]
    lrow = local_row.index_select(0, req_in.long().clamp(0, num_nodes - 1))
    ok = (req_in >= 0) & (lrow >= 0)
    out = sample_neighbors(indptr, indices, lrow.clamp(0, rows_max - 1),
                           fanout, u, seed_mask=ok, edge_ids=eids)

    def back(x, invalid):
      resp = all_to_all(x.reshape(n_parts, f, fanout), mesh)
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


def check_fanouts(fanouts: Sequence[int], full_neighbor_cap) -> List[int]:
  """Positive (or 0) fanouts; -1 and ``full_neighbor_cap`` raise (the
  full-neighbourhood partitioned hop is not ported)."""
  out = [int(f) for f in fanouts]
  if full_neighbor_cap is not None or any(f < 0 for f in out):
    raise NotImplementedError('the full-neighbourhood partitioned hop '
                              '(fanout -1) is not ported')
  return out


class DistNeighborSampler:
  """Multi-hop sampling over a :class:`DistGraph`, one seed block a rank
  (dist_neighbor_sampler.py:99): the per-hop loop of
  ``ops.pipeline.multihop_sample_sorted`` over :func:`make_dist_one_hop`.

  Args:
    dist_graph: this rank's block.
    num_neighbors: per-hop fanouts (positive).
    with_edge: also return each sampled edge's global id (``'edge'``).
    seed: seed of the rank's generator (``seed + rank``; default the
      process-wide seed), which draws the uniforms a call is given none.
  """

  def __init__(self, dist_graph: DistGraph, num_neighbors: Sequence[int],
               with_edge: bool = False, with_weight: bool = False,
               seed: Optional[int] = None,
               full_neighbor_cap: Optional[int] = None):
    self.g = dist_graph
    self.mesh = dist_graph.mesh
    self.with_edge = bool(with_edge)
    self.num_neighbors = check_fanouts(num_neighbors, full_neighbor_cap)
    self._one_hop = make_dist_one_hop(
        store_tensors(dist_graph, with_edge=self.with_edge),
        dist_graph.num_nodes,
        dist_graph.num_partitions, dist_graph.max_rows, self.mesh,
        with_weight=with_weight)
    base = (seed if seed is not None
            else RandomSeedManager.getInstance().getSeed())
    self.generator = make_generator(base + self.mesh.rank, self.mesh.device)

  def uniform_shapes(self, batch_size: int) -> List[Tuple[int, int]]:
    """Per hop the ``[world * F_h, K_h]`` draw a rank serves with."""
    shapes, f = [], batch_size
    for k in self.num_neighbors:
      shapes.append((self.mesh.world * f, k))
      f *= k
    return shapes

  def own_uniforms(self, uniforms, batch_size: int) -> List[torch.Tensor]:
    """This rank's row of per-hop ``[world, world * F_h, K_h]`` draws on
    its device, or, for ``uniforms=None``, its own draws from its
    generator."""
    dev = self.mesh.device
    if uniforms is None:
      return [torch.rand(s, generator=self.generator, device=dev)
              for s in self.uniform_shapes(batch_size)]
    return [torch.as_tensor(x)[self.mesh.rank].to(dev, torch.float32)
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
    rank; ``uniforms`` per hop ``[world, world * F_h, K_h]`` (rank r
    reads row r) or None (drawn). Returns this rank's output dict plus
    ``edge_hop_offsets``."""
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
