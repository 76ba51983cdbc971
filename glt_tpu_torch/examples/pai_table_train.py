"""Table-sourced training (counterpart of examples/pai_table_train.py, the
reference's examples/pai workload): a TableDataset fed by table readers,
then supervised GraphSAGE. The readers here are the CSV ones over tables
written to a temporary directory; on PAI, ``odps_table_reader('odps://...')``
takes their place.

    python -m glt_tpu_torch.examples.pai_table_train [--epochs 2]
        [--batch-size 256] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from glt_tpu_torch.data import (TableDataset, csv_edge_reader,
                                csv_node_reader)
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.models import GraphSAGE
from glt_tpu_torch.parallel import SageTrainStep
from glt_tpu_torch.utils import resolve_device


def write_tables(root, num_nodes=2_000, avg_deg=8, feat_dim=32,
                 num_classes=8, seed=0):
  """Edge and node tables in the records the readers stream: ``src,dst``
  lines and ``id,<f0:f1:...>,label`` lines (the JAX example's draws and
  text)."""
  rng = np.random.default_rng(seed)
  e = num_nodes * avg_deg
  src = rng.integers(0, num_nodes, e)
  dst = rng.integers(0, num_nodes, e)
  edge_csv = os.path.join(root, 'edges.csv')
  with open(edge_csv, 'w') as f:
    for s, d in zip(src, dst):
      f.write(f'{s},{d}\n')
  feats = rng.normal(size=(num_nodes, feat_dim)).astype(np.float32)
  w = rng.normal(size=(feat_dim, num_classes)).astype(np.float32)
  labels = np.argmax(feats @ w, 1)
  node_csv = os.path.join(root, 'nodes.csv')
  with open(node_csv, 'w') as f:
    for i in range(num_nodes):
      row = ':'.join(f'{v:.6f}' for v in feats[i])
      f.write(f'{i},{row},{labels[i]}\n')
  return edge_csv, node_csv, num_nodes, num_classes


def main(argv: Optional[Sequence[str]] = None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--epochs', type=int, default=2)
  ap.add_argument('--batch-size', type=int, default=256)
  ap.add_argument('--device', default=None,
                  help='default: the card (cpu runs the plain versions)')
  args = ap.parse_args(argv)
  device = resolve_device(args.device)

  with tempfile.TemporaryDirectory() as root:
    edge_csv, node_csv, n, num_classes = write_tables(root)
    ds = TableDataset(edge_dir='out').load(
        edge_reader=csv_edge_reader(edge_csv),
        node_reader=csv_node_reader(node_csv, label_col=2),
        num_nodes=n, device=device)

  loader = NeighborLoader(ds, [10, 5], np.arange(n),
                          batch_size=args.batch_size, shuffle=True, seed=0,
                          device=device)
  torch.manual_seed(0)
  model = GraphSAGE(ds.get_node_feature().feature_dim, 128, num_classes,
                    num_layers=2).to(device)
  step = SageTrainStep(model, lr=1e-3)
  losses = []
  for epoch in range(args.epochs):
    for batch in loader:
      loss = step(batch)
    losses.append(float(loss))
    print(f'epoch {epoch}: loss={losses[-1]:.4f}')
  return dict(losses=losses)


if __name__ == '__main__':
  main()
