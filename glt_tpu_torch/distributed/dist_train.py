"""Partitioned homogeneous training, the collocated worker mode of
examples/distributed/dist_train_sage_supervised.py (counterpart of
glt_tpu/distributed/dist_train.py).

One process a rank: each rank walks its seed block over the partitioned
graph (:class:`~glt_tpu_torch.distributed.DistNeighborSampler`: at every
hop the ``sample_hop`` kernel, B2, at the rows' owners, and the
static-shape dedup), reads the sampled nodes' features through its
:class:`~glt_tpu_torch.distributed.DistFeature` (K3 at the owners, or K3
mixed at a spilled owner) and, given an edge store, the sampled edges'
features the same way; then the GraphSAGE's masked cross-entropy, the
gradients' and the loss's mean over the mesh (``parallel.train.
mesh_update``) and Adam. A batch a call: JAX has no superstep for this
trainer.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..loader.transform import Batch
from ..ops.pipeline import edge_hop_offsets, sample_budget
from ..parallel.dist_feature import require_device_resident
from ..parallel.train import mesh_update
from ..utils import as_numpy
from ..utils.rng import seeded_state_dict
from .dist_feature import DistFeature
from .dist_graph import DistGraph
from .dist_neighbor_sampler import DistNeighborSampler


class DistTrainStep:
  """One data-parallel step over a partitioned graph (dist_train.py:30).

  Args:
    dist_graph: this rank's :class:`DistGraph`.
    dist_feature: the node features, a DistFeature over the same mesh.
    model: a module over :class:`~glt_tpu_torch.loader.transform.Batch`
      (a GraphSAGE) on the mesh's device; its parameters are broadcast
      from rank 0.
    labels: ``[N]`` labels (replicated; the seeds' are read).
    fanouts: per-hop fanouts (positive).
    batch_size_per_device: seeds a rank a batch.
    lr: Adam's learning rate (optax ``adam`` defaults otherwise).
    seed: seed of the sampler's generator, which draws the uniforms a
      call is given none.
    edge_feature: an edge-feature DistFeature (global edge ids); the
      batch then carries ``edge`` and ``edge_attr``.
  """

  def __init__(self, dist_graph: DistGraph, dist_feature: DistFeature,
               model: nn.Module, labels, fanouts: Sequence[int],
               batch_size_per_device: int, lr: float = 1e-3, seed: int = 0,
               edge_feature: Optional[DistFeature] = None):
    require_device_resident(dist_feature, 'DistTrainStep features')
    require_device_resident(edge_feature, 'DistTrainStep edge features')
    mesh = dist_graph.mesh
    dev = mesh.device
    if next(model.parameters()).device != dev:
      raise ValueError(f'the model is not on the mesh\'s device {dev}')
    self.g, self.f, self.ef, self.model = (dist_graph, dist_feature,
                                           edge_feature, model)
    self.mesh = mesh
    self.fanouts = [int(k) for k in fanouts]
    self.bs = int(batch_size_per_device)
    self.sampler = DistNeighborSampler(dist_graph, self.fanouts,
                                       with_edge=edge_feature is not None,
                                       seed=seed)
    self.labels = torch.as_tensor(as_numpy(labels)).to(dev)
    self._budget = sample_budget(self.bs, self.fanouts)
    self._offs = tuple(edge_hop_offsets(self.bs, self.fanouts))
    if mesh.world > 1:
      for p in model.parameters():
        dist.broadcast(p.data, 0, group=mesh.group)
    self.optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                      betas=(0.9, 0.999), eps=1e-8)

  def init_params(self, seed: int) -> Dict[str, torch.Tensor]:
    """Install weights drawn from ``seed`` (the same on every rank) and
    return them."""
    state = seeded_state_dict(self.model, seed)
    self.model.load_state_dict(state)
    return state

  def make_batch(self, seeds: torch.Tensor, n_valid: torch.Tensor,
                 u_hops) -> Batch:
    """This rank's batch (dist_train.py:98-127): the walk from ``seeds
    [B]`` (``n_valid`` a 0-dim tensor, ``u_hops`` this rank's draws per
    hop), the nodes' features through the exchange, the seed labels and,
    with an edge store, the sampled edges' ids and features."""
    out = self.sampler.sample_local(seeds, n_valid, u_hops)
    node_valid = (torch.arange(self._budget, device=self.mesh.device)
                  < out['node_count'])
    x = self.f.lookup_local(out['node'].clamp(min=0), node_valid)
    edge_attr = (None if self.ef is None
                 else self.ef.collate_edge_attr(out))
    y = self.labels.index_select(
        0, out['batch'].clamp(min=0).long()[:self.bs])
    return Batch(x=x, row=out['row'], col=out['col'],
                 edge_mask=out['edge_mask'], node=out['node'],
                 node_count=out['node_count'], y=y, edge=out.get('edge'),
                 edge_attr=edge_attr, batch_size=self.bs,
                 edge_hop_offsets=self._offs,
                 metadata={'n_valid': n_valid})

  def own_inputs(self, seeds, n_valid_per_device, uniforms=None):
    """This rank's seeds ``[B]`` and valid count (int32 on its device)
    and draws per hop, from ``seeds [world, B]`` (or ``[world * B]``),
    ``n_valid_per_device [world]`` and ``uniforms`` per hop ``[world,
    world * F_h, K_h]`` (None: drawn)."""
    dev, r, bs = self.mesh.device, self.mesh.rank, self.bs
    s = as_numpy(seeds).reshape(-1)[r * bs:(r + 1) * bs]
    nv = int(as_numpy(n_valid_per_device).reshape(-1)[r])
    return (torch.as_tensor(s.astype(np.int32), device=dev),
            torch.tensor(nv, dtype=torch.int32, device=dev),
            self.sampler.own_uniforms(uniforms, bs))

  def __call__(self, seeds, n_valid_per_device, uniforms=None
               ) -> torch.Tensor:
    """One batch: ``seeds [world, B]`` (or ``[world * B]``),
    ``n_valid_per_device [world]``, ``uniforms`` per hop ``[world, world
    * F_h, K_h]`` or None (drawn). Returns the mesh's mean loss, a 0-dim
    tensor."""
    batch = self.make_batch(*self.own_inputs(seeds, n_valid_per_device,
                                             uniforms))
    return mesh_update(self.model, self.optimizer, self.mesh, batch)
