"""Shared helpers of the port's examples (counterpart of
examples/common.py): synthetic datasets standing in for OGB downloads,
from the same numpy draws as the JAX package's."""
from __future__ import annotations

import numpy as np

from glt_tpu_torch.data import Dataset, sort_by_in_degree


def synthetic_products(num_nodes=24_000, avg_degree=25, feat_dim=100,
                       num_classes=47, seed=0, split_ratio=1.0,
                       sort_features=False, device=None):
  """The ogbn-products-shaped synthetic graph of examples/common.py (2.45M
  nodes and 62M edges at full scale): square-uniform in-degree skew,
  normal features, learnable labels ``argmax(x @ w)``, the 0.1/0.1 node
  split; ``split_ratio`` of the feature rows on ``device``, the rest in
  host memory, sorted hottest-first by in-degree with ``sort_features``."""
  rng = np.random.default_rng(seed)
  e = num_nodes * avg_degree
  src = rng.integers(0, num_nodes, e, dtype=np.int64)
  # mild power-law: square a uniform to concentrate on low ids
  dst = (rng.random(e) ** 2 * num_nodes).astype(np.int64) % num_nodes
  feats = rng.normal(size=(num_nodes, feat_dim)).astype(np.float32)
  w = rng.normal(size=(feat_dim, num_classes)).astype(np.float32)
  labels = np.argmax(feats @ w, axis=1).astype(np.int32)
  ds = Dataset(edge_dir='out')
  ds.init_graph(np.stack([src, dst]), num_nodes=num_nodes, device=device)
  ds.init_node_features(
      feats, sort_func=sort_by_in_degree if sort_features else None,
      split_ratio=split_ratio, device=device)
  ds.init_node_labels(labels)
  ds.random_node_split(num_val=0.1, num_test=0.1)
  return ds, num_classes
