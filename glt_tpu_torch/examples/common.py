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


#: ogbn-mag's counts (paper-cites-paper, author-writes-paper), its feature
#: width and classes: ``synthetic_hetero_mag(**MAG_COUNTS)`` is the graph
#: at full scale
MAG_COUNTS = dict(num_papers=736_389, num_authors=1_134_649,
                  num_cites=5_416_271, num_writes=7_145_660, feat_dim=128,
                  num_classes=349)


def synthetic_hetero_mag(num_papers=2_000, num_authors=1_000, feat_dim=64,
                         num_classes=8, seed=0, num_cites=None,
                         num_writes=None, device=None):
  """The ogbn-mag-shaped hetero graph of examples/common.py
  (paper-cites-paper, author-writes-paper, uniform endpoints, normal
  features, learnable paper labels ``argmax(x_paper @ w)``), from the
  same numpy draws; ``num_cites`` and ``num_writes`` default to the JAX
  recipe's 8 and 3 a paper (:data:`MAG_COUNTS` gives ogbn-mag's). Graph
  and features on ``device``. Returns ``(dataset, classes, cites,
  writes)``."""
  rng = np.random.default_rng(seed)
  cites = ('paper', 'cites', 'paper')
  writes = ('author', 'writes', 'paper')
  n_pp = num_papers * 8 if num_cites is None else int(num_cites)
  n_ap = num_papers * 3 if num_writes is None else int(num_writes)
  pp = np.stack([rng.integers(0, num_papers, n_pp),
                 rng.integers(0, num_papers, n_pp)])
  ap = np.stack([rng.integers(0, num_authors, n_ap),
                 rng.integers(0, num_papers, n_ap)])
  ds = Dataset(edge_dir='out')
  ds.init_graph({cites: pp, writes: ap},
                num_nodes={'paper': num_papers, 'author': num_authors},
                device=device)
  pf = rng.normal(size=(num_papers, feat_dim)).astype(np.float32)
  af = rng.normal(size=(num_authors, feat_dim)).astype(np.float32)
  w = rng.normal(size=(feat_dim, num_classes)).astype(np.float32)
  labels = np.argmax(pf @ w, 1).astype(np.int32)
  ds.init_node_features({'paper': pf, 'author': af}, device=device)
  ds.init_node_labels({'paper': labels})
  return ds, num_classes, cites, writes
