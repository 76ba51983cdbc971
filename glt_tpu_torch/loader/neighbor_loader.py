"""NeighborLoader: the user-facing mini-batch loader (counterpart of
glt_tpu/loader/neighbor_loader.py, without ``as_pyg_v1``). Builds a
NeighborSampler over the dataset's graph and yields Batches ready for a
training step."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..data import Dataset
from ..sampler import NeighborSampler
from .node_loader import NodeLoader


class NeighborLoader(NodeLoader):
  """:class:`NodeLoader` over a :class:`NeighborSampler` of
  ``data.graph`` with ``num_neighbors`` (-1 = full neighbourhood),
  ``with_weight`` and ``seed``, on ``device`` (default: the card)."""

  def __init__(self, data: Dataset, num_neighbors, input_nodes,
               batch_size: int = 512, shuffle: bool = False,
               with_weight: bool = False, seed: Optional[int] = None,
               device=None, rng: Optional[np.random.Generator] = None):
    sampler = NeighborSampler(data.graph, num_neighbors, device=device,
                              with_weight=with_weight, seed=seed)
    super().__init__(data, sampler, input_nodes, batch_size=batch_size,
                     shuffle=shuffle, rng=rng)
