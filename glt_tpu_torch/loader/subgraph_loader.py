"""SubGraphLoader: induced-subgraph batches for SEAL-style workloads
(counterpart of glt_tpu/loader/subgraph_loader.py): sample the k-hop
neighbourhood of the seeds, induce the subgraph over it, and yield
Batches with a ``mapping`` from seed order to subgraph labels."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..data import Dataset
from ..data.feature import gather_features
from ..sampler import NeighborSampler
from .node_loader import NodeLoader
from .transform import Batch


class SubGraphLoader(NodeLoader):
  """:class:`NodeLoader` whose batches are the subgraphs induced on the
  seeds' sampled neighbourhood (``NeighborSampler.subgraph``), over a
  NeighborSampler of ``data.graph`` with ``num_neighbors``, on ``device``
  (default: the card). ``with_edge`` puts each induced edge's id in
  ``batch.edge`` (-1 on masked slots)."""

  def __init__(self, data: Dataset, num_neighbors, input_nodes,
               batch_size: int = 512, shuffle: bool = False,
               drop_last: bool = False, with_edge: bool = False,
               collect_features: bool = True, seed: Optional[int] = None,
               device=None, rng: Optional[np.random.Generator] = None):
    sampler = NeighborSampler(data.graph, num_neighbors, device=device,
                              with_edge=with_edge, edge_dir=data.edge_dir,
                              seed=seed)
    super().__init__(data, sampler, input_nodes, batch_size=batch_size,
                     shuffle=shuffle, drop_last=drop_last,
                     collect_features=collect_features, rng=rng)

  def _make_batch(self, seeds: np.ndarray, n_valid: int) -> Batch:
    with record_function('sample.multihop'):
      sub = self.sampler.subgraph(seeds)
    x = None
    if self.collect_features and self.data.node_features is not None:
      with record_function('gather.features'):
        x = gather_features(self.data.get_node_feature(),
                            sub.nodes.clamp(min=0))
    dev = sub.nodes.device
    y = None
    if self.data.node_labels is not None:
      y = torch.as_tensor(self.data.get_node_label()[seeds], device=dev)
    # the seeds head the node list, so with unique seeds their labels are
    # 0..batch_size-1; the message-flow orientation puts the neighbour
    # (the subgraph's cols) in ``row`` and the expanding node in ``col``
    return Batch(
        x=x, row=sub.cols, col=sub.rows, edge_mask=sub.edge_mask,
        node=sub.nodes, node_count=sub.node_count, y=y, edge=sub.eids,
        metadata={'mapping': torch.arange(self.batch_size, device=dev),
                  'n_valid': n_valid},
        batch_size=self.batch_size)
