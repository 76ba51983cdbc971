"""NeighborSampler: homogeneous multi-hop sampling on the device
(counterpart of glt_tpu/sampler/neighbor_sampler.py).

This slice serves uniform positive fanouts through the walk
(ops/pipeline.py); weighted, full-neighbourhood and hetero sampling come
in later slices and are refused here.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..data import Graph
from ..ops.cuda_kernels import walk_table_slots
from ..ops.pipeline import edge_hop_offsets, multihop_sample, sample_budget
from ..ops.sample import FusedHopPlan, walk_hop_uniforms
from ..utils import as_numpy, make_generator, resolve_device
from ..utils.rng import RandomSeedManager
from .base import BaseSampler, NodeSamplerInput, SamplerOutput


class NeighborSampler(BaseSampler):
  """Uniform multi-hop neighbour sampling over a device CSR.

  Args:
    graph: a :class:`Graph` on ``device``.
    num_neighbors: positive fanout per hop, e.g. ``[15, 10, 5]``.
    device: where sampling runs (default: the card; raises when there is
      none). The graph must already live there.
    with_edge: also emit the sampled edges' ids.
    replace: sample with replacement.
    seed: seed of the sampler's ``torch.Generator``; defaults to the
      process :class:`RandomSeedManager` seed.
  """

  def __init__(self, graph: Graph, num_neighbors: Sequence[int],
               device=None, with_edge: bool = False, replace: bool = False,
               seed: Optional[int] = None):
    if isinstance(graph, dict) or isinstance(num_neighbors, dict):
      raise NotImplementedError('hetero sampling is not ported yet')
    self.device = resolve_device(device)
    if graph.device != self.device:
      raise ValueError(f'graph lives on {graph.device}, sampler runs on '
                       f'{self.device}')
    self.num_neighbors = [int(f) for f in num_neighbors]
    if any(f <= 0 for f in self.num_neighbors):
      raise NotImplementedError(
          'the port serves uniform positive fanouts; full-neighbourhood '
          '(-1) hops are not ported yet')
    self.graph = graph
    self.with_edge = with_edge
    self.replace = replace
    self.generator = make_generator(
        seed if seed is not None
        else RandomSeedManager.getInstance().getSeed(), self.device)
    self._plans = {}

  def _fused_plan(self, batch_size: int) -> FusedHopPlan:
    if batch_size not in self._plans:
      g = self.graph
      self._plans[batch_size] = FusedHopPlan(
          g.indptr_pad, g.indices,
          walk_table_slots(sample_budget(batch_size, self.num_neighbors)),
          edge_ids=g.edge_ids if self.with_edge else None,
          replace=self.replace)
    return self._plans[batch_size]

  def hop_uniforms(self, batch_size: int):
    """The next per-hop uniforms of this sampler's stream."""
    return walk_hop_uniforms(self.generator, batch_size, self.num_neighbors,
                             self.replace, self.device)

  def sample_from_nodes(self, inputs, n_valid: Optional[int] = None,
                        uniforms=None) -> SamplerOutput:
    """Multi-hop sampling from seed nodes; seeds past ``n_valid`` are
    padding. ``uniforms`` injects the per-hop draws (default: the next
    ones of the sampler's generator)."""
    if isinstance(inputs, NodeSamplerInput):
      inputs = inputs.node
    seeds = (inputs.to(self.device, torch.int32)
             if isinstance(inputs, torch.Tensor)
             else torch.as_tensor(as_numpy(inputs).astype(np.int32),
                                  device=self.device))
    batch_size = seeds.numel()
    n_valid = batch_size if n_valid is None else int(n_valid)
    if uniforms is None:
      uniforms = self.hop_uniforms(batch_size)
    out = multihop_sample(self._fused_plan(batch_size), seeds, n_valid,
                          self.num_neighbors, u_hops=uniforms,
                          with_edge=self.with_edge)
    return SamplerOutput(
        node=out['node'], node_count=out['node_count'], row=out['row'],
        col=out['col'], edge_mask=out['edge_mask'], edge=out.get('edge'),
        batch=out['batch'], num_sampled_nodes=out['num_sampled_nodes'],
        num_sampled_edges=out['num_sampled_edges'],
        edge_hop_offsets=edge_hop_offsets(batch_size, self.num_neighbors),
        metadata={'seed_labels': out['seed_labels'],
                  'seed_count': out['seed_count']})
