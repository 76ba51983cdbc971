"""NeighborLoader: the user-facing mini-batch loader (counterpart of
glt_tpu/loader/neighbor_loader.py, without ``as_pyg_v1``). Builds a
NeighborSampler over the dataset's graph, in the dataset's ``edge_dir``,
and yields Batches (HeteroBatches over a hetero dataset) ready for a
training step."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..data import Dataset
from ..sampler import NeighborSampler
from .node_loader import NodeLoader


class NeighborLoader(NodeLoader):
  """:class:`NodeLoader` over a :class:`NeighborSampler` of
  ``data.graph`` with ``num_neighbors`` (-1 = full neighbourhood; hetero:
  one list for every edge type or a dict keyed by EdgeType),
  ``with_weight`` and ``seed``, on ``device`` (default: the card)."""

  def __init__(self, data: Dataset, num_neighbors, input_nodes,
               batch_size: int = 512, shuffle: bool = False,
               drop_last: bool = False, with_weight: bool = False,
               collect_features: bool = True, seed: Optional[int] = None,
               device=None, rng: Optional[np.random.Generator] = None):
    sampler = NeighborSampler(data.graph, num_neighbors, device=device,
                              with_weight=with_weight,
                              edge_dir=data.edge_dir, seed=seed)
    super().__init__(data, sampler, input_nodes, batch_size=batch_size,
                     shuffle=shuffle, drop_last=drop_last,
                     collect_features=collect_features, rng=rng)
