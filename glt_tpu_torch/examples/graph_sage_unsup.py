"""Unsupervised GraphSAGE link prediction with negative sampling
(counterpart of examples/graph_sage_unsup.py, the reference's
graph_sage_unsup_ppi workload): LinkNeighborLoader with binary negatives
-> GraphSAGE embeddings of every sampled node -> dot-product sigmoid BCE
-> Adam(3e-3).

    python -m glt_tpu_torch.examples.graph_sage_unsup [--epochs 3]
        [--batch-size 128] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from glt_tpu_torch.data import Dataset
from glt_tpu_torch.loader import LinkNeighborLoader
from glt_tpu_torch.models import GraphSAGE
from glt_tpu_torch.parallel import SageTrainStep, link_bce_loss
from glt_tpu_torch.sampler import NegativeSampling
from glt_tpu_torch.utils import resolve_device

FANOUTS, HIDDEN, EMBED, LR = [8, 4], 128, 64, 3e-3


def synthetic_products(num_nodes=3_000, avg_degree=25, feat_dim=100,
                       num_classes=47, seed=0, device=None):
  """The ogbn-products-shaped synthetic graph of examples/common.py (the
  same numpy draws): square-uniform in-degree skew, normal features,
  learnable labels, the 0.1/0.1 node split; on ``device``."""
  rng = np.random.default_rng(seed)
  e = num_nodes * avg_degree
  src = rng.integers(0, num_nodes, e, dtype=np.int64)
  dst = (rng.random(e) ** 2 * num_nodes).astype(np.int64) % num_nodes
  feats = rng.normal(size=(num_nodes, feat_dim)).astype(np.float32)
  w = rng.normal(size=(feat_dim, num_classes)).astype(np.float32)
  labels = np.argmax(feats @ w, axis=1).astype(np.int32)
  ds = Dataset(edge_dir='out')
  ds.init_graph(np.stack([src, dst]), num_nodes=num_nodes, device=device)
  ds.init_node_features(feats, device=device)
  ds.init_node_labels(labels)
  ds.random_node_split(num_val=0.1, num_test=0.1)
  return ds, num_classes


def main(argv: Optional[Sequence[str]] = None) -> float:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--epochs', type=int, default=3)
  ap.add_argument('--batch-size', type=int, default=128)
  ap.add_argument('--device', default=None,
                  help='default: the card (cpu runs the plain versions)')
  args = ap.parse_args(argv)
  device = resolve_device(args.device)

  ds, _ = synthetic_products(num_nodes=3_000, device=device)
  loader = LinkNeighborLoader(
      ds, FANOUTS, batch_size=args.batch_size, shuffle=True, seed=0,
      neg_sampling=NegativeSampling('binary', amount=1), device=device)
  torch.manual_seed(0)
  model = GraphSAGE(ds.get_node_feature().feature_dim, HIDDEN, EMBED,
                    num_layers=len(FANOUTS)).to(device)
  step = SageTrainStep(model, lr=LR, loss=link_bce_loss)
  loss = float('nan')
  for epoch in range(args.epochs):
    for batch in loader:
      loss = float(step(batch))
    print(f'epoch {epoch}: loss={loss:.4f}')
  return loss


if __name__ == '__main__':
  main()
