"""The IGBH-layout dataset of examples/igbh, in numpy: the synthetic graph
(a copy of examples/igbh/compress_graph.py ``synthesize``, the same draws
from the same seed), the train/validation split (examples/igbh/
split_seeds.py) and the reader of the tree they write::

    <root>/processed/<src>__<rel>__<dst>/edge_index.npy   [2, E] COO int64
    <root>/processed/<ntype>/node_feat.npy                [N, D] float32
    <root>/processed/paper/node_label.npy                 [N] int32
    <root>/processed/{train,val}_idx.npy, meta.txt
    <root>/{csc,csr}/<ntype>/node_feat_bf16.npy           (compress_graph.py)
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


def synthesize(root: str, num_papers: int, seed: int = 0,
               feat_dim: int = 128, num_classes: int = 16) -> None:
  """A synthetic MAG-shaped IGBH-layout dataset on disk: paper-cites-paper
  (10 a paper), author-writes-paper (3 a paper), author-affiliated-
  institute (1 an author), ``num_papers // 2`` authors and ``num_papers
  // 50`` institutes, normal features, labels ``argmax(x_paper @ w)``."""
  rng = np.random.default_rng(seed)
  num_authors = max(num_papers // 2, 4)
  num_inst = max(num_papers // 50, 4)
  proc = os.path.join(root, 'processed')
  rels = {
      ('paper', 'cites', 'paper'): (
          rng.integers(0, num_papers, num_papers * 10),
          rng.integers(0, num_papers, num_papers * 10)),
      ('author', 'writes', 'paper'): (
          rng.integers(0, num_authors, num_papers * 3),
          rng.integers(0, num_papers, num_papers * 3)),
      ('author', 'affiliated', 'institute'): (
          rng.integers(0, num_authors, num_authors),
          rng.integers(0, num_inst, num_authors)),
  }
  for (s, r, d), (src, dst) in rels.items():
    ed = os.path.join(proc, f'{s}__{r}__{d}')
    os.makedirs(ed, exist_ok=True)
    np.save(os.path.join(ed, 'edge_index.npy'),
            np.stack([src, dst]).astype(np.int64))
  counts = {'paper': num_papers, 'author': num_authors,
            'institute': num_inst}
  pf = rng.normal(size=(num_papers, feat_dim)).astype(np.float32)
  w = rng.normal(size=(feat_dim, num_classes)).astype(np.float32)
  for t, n in counts.items():
    nd = os.path.join(proc, t)
    os.makedirs(nd, exist_ok=True)
    feat = pf if t == 'paper' else \
        rng.normal(size=(n, feat_dim)).astype(np.float32)
    np.save(os.path.join(nd, 'node_feat.npy'), feat)
  labels = np.argmax(pf @ w, 1).astype(np.int32)
  np.save(os.path.join(proc, 'paper', 'node_label.npy'), labels)
  with open(os.path.join(proc, 'meta.txt'), 'w') as f:
    for t, n in counts.items():
      f.write(f'{t} {n}\n')


def split_indices(num_papers: int, random_seed: int = 42,
                  validation_frac: float = 0.01, train_frac: float = 0.6
                  ) -> Tuple[np.ndarray, np.ndarray]:
  """``(train_idx, val_idx)``: the first ``train_frac`` of a seeded
  permutation of the papers, then the next ``validation_frac``."""
  perm = np.random.default_rng(random_seed).permutation(num_papers)
  n_train = int(num_papers * train_frac)
  n_val = int(num_papers * validation_frac)
  return perm[:n_train], perm[n_train:n_train + n_val]


def split_seeds(path: str, random_seed: int = 42,
                validation_frac: float = 0.01,
                train_frac: float = 0.6) -> None:
  """Write ``train_idx.npy`` and ``val_idx.npy`` beside the labels."""
  proc = os.path.join(path, 'processed')
  n = np.load(os.path.join(proc, 'paper', 'node_label.npy')).shape[0]
  train, val = split_indices(n, random_seed, validation_frac, train_frac)
  np.save(os.path.join(proc, 'train_idx.npy'), train)
  np.save(os.path.join(proc, 'val_idx.npy'), val)
  print(f'{n} labeled papers -> {train.size} train / {val.size} val')


def load_meta(root: str) -> Dict[str, int]:
  counts = {}
  with open(os.path.join(root, 'processed', 'meta.txt')) as f:
    for line in f:
      t, n = line.split()
      counts[t] = int(n)
  return counts


def load_igbh_root(root: str, load_feats: bool = True,
                   load_edges: bool = True):
  """``(counts, edges, feats, labels, train_idx, val_idx)`` of the tree;
  ``edges`` keyed by edge type, ``feats`` by node type: a
  ``torch.bfloat16`` tensor where compress_graph.py wrote the type's bf16
  table (``csc`` first, then ``csr``), else float32 numpy.
  ``load_feats=False`` and ``load_edges=False`` leave the feature tables
  and the edge payloads on disk (empty dicts): the multihost mode of
  dist_train_rgnn.py builds its stores from a rank's own partition and
  reads the edge types from the partition's META."""
  import torch
  proc = os.path.join(root, 'processed')
  counts = load_meta(root)
  edges = {}
  for name in sorted(os.listdir(proc)) if load_edges else ():
    p = os.path.join(proc, name, 'edge_index.npy')
    if os.path.exists(p):
      s, r, d = name.split('__')
      edges[(s, r, d)] = np.load(p)
  feats = {}
  for t in counts if load_feats else ():
    bf = next((p for p in (os.path.join(root, lay, t, 'node_feat_bf16.npy')
                           for lay in ('csc', 'csr')) if os.path.exists(p)),
              None)
    if bf is not None:
      feats[t] = torch.from_numpy(np.load(bf).view(np.int16)).view(
          torch.bfloat16)
    else:
      feats[t] = np.load(os.path.join(proc, t, 'node_feat.npy'))
  labels = np.load(os.path.join(proc, 'paper', 'node_label.npy'))
  train_idx = np.load(os.path.join(proc, 'train_idx.npy'))
  val_idx = np.load(os.path.join(proc, 'val_idx.npy'))
  return counts, edges, feats, labels, train_idx, val_idx
