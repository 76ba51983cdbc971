"""NeighborLoader: the user-facing mini-batch loader (counterpart of
glt_tpu/loader/neighbor_loader.py). Builds a NeighborSampler over the
dataset's graph, in the dataset's ``edge_dir``, and yields Batches
(HeteroBatches over a hetero dataset) ready for a training step, or
PyG-v1 ``(batch_size, n_id, adjs)`` triples with ``as_pyg_v1``."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..data import Dataset
from ..sampler import NeighborSampler
from .node_loader import NodeLoader
from .transform import to_pyg_v1


class NeighborLoader(NodeLoader):
  """:class:`NodeLoader` over a :class:`NeighborSampler` of
  ``data.graph`` with ``num_neighbors`` (-1 = full neighbourhood; hetero:
  one list for every edge type or a dict keyed by EdgeType),
  ``with_edge``, ``with_weight``, ``replace`` and ``seed``, on ``device``
  (default: the card). ``prefetch_depth`` as for :class:`NodeLoader`;
  ``as_pyg_v1`` yields :func:`~glt_tpu_torch.loader.transform.to_pyg_v1`
  of each batch (homogeneous)."""

  def __init__(self, data: Dataset, num_neighbors, input_nodes,
               batch_size: int = 512, shuffle: bool = False,
               drop_last: bool = False, with_edge: bool = False,
               with_weight: bool = False, collect_features: bool = True,
               replace: bool = False, seed: Optional[int] = None,
               device=None, prefetch_depth: Optional[int] = None,
               as_pyg_v1: bool = False,
               rng: Optional[np.random.Generator] = None):
    sampler = NeighborSampler(data.graph, num_neighbors, device=device,
                              with_edge=with_edge, with_weight=with_weight,
                              replace=replace, edge_dir=data.edge_dir,
                              seed=seed)
    super().__init__(data, sampler, input_nodes, batch_size=batch_size,
                     shuffle=shuffle, drop_last=drop_last,
                     collect_features=collect_features,
                     prefetch_depth=prefetch_depth, rng=rng)
    #: yield PyG-v1 (batch_size, n_id, adjs) triples instead of Batches
    self.as_pyg_v1 = bool(as_pyg_v1)

  def __iter__(self):
    it = super().__iter__()
    if not self.as_pyg_v1:
      return it
    return (to_pyg_v1(b) for b in it)
