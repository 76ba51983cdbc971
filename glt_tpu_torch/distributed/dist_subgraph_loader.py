"""DistSubGraphLoader: induced-subgraph batches over a partitioned graph
(counterpart of glt_tpu/distributed/dist_subgraph_loader.py).

The walk expands each hop with a ``max_degree``-wide window through the
partitioned sampler (B2 at the rows' owners, edge ids on), exact while
``max_degree`` bounds the true degrees; an extraction pass then expands
every node of the final set one hop more, and the induced edges are the
sampled ones whose two ends both lie in the set, each edge id once. As
the other dist loaders, a rank returns its own dict (``induced`` its own
edge lists).
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from .dist_feature import DistFeature
from .dist_graph import DistGraph
from .dist_loader import (batch_count, epoch_orders, node_features,
                          padded_seed_block, seed_lists)
from .dist_neighbor_sampler import DistNeighborSampler


class DistSubGraphLoader:
  """Args:
    dist_graph: this rank's block.
    num_hops: hops of ``max_degree`` picks.
    input_nodes_per_device: every rank's seed list (the same on every
      rank).
    max_degree: the window (default the graph's largest degree).
    dist_feature / edge_feature: node and edge stores (``x``; the induced
      edges' ``edge_attr``).
    batch_size, shuffle, drop_last, seed, rng: as for
      :class:`DistNeighborLoader`.
  """

  def __init__(self, dist_graph: DistGraph, num_hops: int,
               input_nodes_per_device, max_degree: Optional[int] = None,
               dist_feature: Optional[DistFeature] = None,
               batch_size: int = 64, shuffle: bool = False,
               drop_last: bool = False, seed: Optional[int] = None,
               rng: Optional[np.random.Generator] = None,
               edge_feature: Optional[DistFeature] = None):
    self.g = dist_graph
    self.mesh = dist_graph.mesh
    self.seeds = seed_lists(input_nodes_per_device, self.mesh.world)
    self.max_degree = int(max_degree or dist_graph.max_degree)
    self.sampler = DistNeighborSampler(
        dist_graph, [self.max_degree] * num_hops, with_edge=True, seed=seed)
    # the extraction pass: one window over every node of the set (the walk
    # alone misses edges between two nodes of its last hop)
    self.extractor = DistNeighborSampler(
        dist_graph, [self.max_degree], with_edge=True, seed=seed)
    self.feature = dist_feature
    self.edge_feature = edge_feature
    self.batch_size = int(batch_size)
    self.shuffle = shuffle
    self.drop_last = drop_last
    self.rng = rng or np.random.default_rng(seed or 0)

  def __len__(self):
    return batch_count(min(s.shape[0] for s in self.seeds), self.batch_size,
                       self.drop_last)

  def __iter__(self) -> Iterator[dict]:
    orders = epoch_orders(self.rng, [s.shape[0] for s in self.seeds],
                          self.shuffle)
    world, me = self.mesh.world, self.mesh.rank
    for it in range(len(self)):
      seeds, n_valid = padded_seed_block(self.seeds, orders,
                                         it * self.batch_size,
                                         self.batch_size)
      out = self.sampler.sample_from_nodes(seeds, n_valid)
      # the set is unique and goes in label order, so the extractor's seed
      # labels are the set's own: an edge is induced iff both labels are
      # below the count
      count = out['node_count']
      set_nodes = out['node'].clamp(min=0)
      stack = set_nodes.new_zeros((world, set_nodes.numel()))
      stack[me] = set_nodes
      counts = torch.zeros(world, dtype=torch.int64)
      counts[me] = int(count)
      ex = self.extractor.sample_from_nodes(stack, counts)
      ea = (None if self.edge_feature is None
            else self.edge_feature.collate_edge_attr(ex))
      rows, cols = ex['row'], ex['col']
      ok = (ex['edge_mask'] & (rows >= 0) & (cols >= 0) & (rows < count)
            & (cols < count)).cpu().numpy()
      e = ex['edge'].cpu().numpy()[ok]
      _, first = np.unique(e, return_index=True)
      induced = dict(rows=rows.cpu().numpy()[ok][first],
                     cols=cols.cpu().numpy()[ok][first], eids=e[first])
      if ea is not None:
        induced['edge_attr'] = ea[torch.as_tensor(ok, device=ea.device)][
            torch.as_tensor(first, device=ea.device)]
      out['induced'] = induced
      if self.feature is not None:
        out['x'] = node_features(self.feature, out)
      out['n_valid'] = int(n_valid[me])
      yield out
