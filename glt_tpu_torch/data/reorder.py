"""Degree-based feature reordering for the hot/cold split (counterpart of
glt_tpu/data/reorder.py): rows sorted by descending in-degree, so the
hottest rows form the device-resident prefix of a split
:class:`~glt_tpu_torch.data.Feature`. Host numpy, as in the JAX package;
``old2new`` is the JAX one bit for bit (the same stable argsort and the
same draws when shuffling)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import as_numpy
from .topology import Topology


def in_degrees(topo: Topology) -> np.ndarray:
  """Each node's in-degree, int64: a CSC's row degrees, a CSR's column
  counts over ``num_cols`` (counted where the topology lives)."""
  if topo.layout == 'CSC':
    return as_numpy(topo.degrees)
  return as_numpy(torch.bincount(topo.indices.long(),
                                 minlength=topo.num_cols))


def sort_by_in_degree(feats, split_ratio: float, topo: Topology,
                      shuffle_ratio: float = 0.0,
                      rng: Optional[np.random.Generator] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
  """``(reordered feats, old2new)``, the hottest rows first: new row k
  holds old node ``order[k]``, ``order`` a stable argsort of ``-deg``
  (nodes past the topology's axis count degree 0). ``split_ratio`` is
  part of the sort-func convention of ``Dataset.init_node_features``;
  the degree sort does not read it. ``shuffle_ratio`` moves that share
  of the rows among themselves with ``rng`` (default ``default_rng(0)``),
  as the JAX function draws them."""
  feats = as_numpy(feats)
  deg = in_degrees(topo)
  n = feats.shape[0]
  if deg.shape[0] < n:
    deg = np.concatenate([deg, np.zeros(n - deg.shape[0], dtype=deg.dtype)])
  order = np.argsort(-deg[:n], kind='stable')
  if shuffle_ratio > 0.0:
    rng = rng or np.random.default_rng(0)
    k = int(n * shuffle_ratio)
    if k > 1:
      pick = rng.choice(n, size=k, replace=False)
      order[pick] = order[rng.permutation(pick)]
  old2new = np.empty(n, dtype=np.int64)
  old2new[order] = np.arange(n, dtype=np.int64)
  return feats[order], old2new
