"""Supervised GraphSAGE node classification (counterpart of
examples/train_sage_products.py, the reference's headline single-device
workload: fanouts [15, 10, 5], batch 1024, 3 layers, hidden 256) on the
synthetic products-shaped graph of examples/common.py; ``--scale full``
is the 2.45M-node configuration. Below ``--split-ratio 1`` the feature
rows are sorted hottest-first by in-degree, that share of them stays on
the card and the rest in pinned host memory, which the feature gather
reads over the host link.

    python -m glt_tpu_torch.examples.train_sage_products [--scale full]
        [--split-ratio 0.2] [--epochs 3] [--device cpu] [--max-steps N]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from glt_tpu_torch.examples.common import synthetic_products
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.models import GraphSAGE
from glt_tpu_torch.parallel import SageTrainStep
from glt_tpu_torch.typing import Split
from glt_tpu_torch.utils import resolve_device
from glt_tpu_torch.utils.profile import ThroughputMeter


def main(argv: Optional[Sequence[str]] = None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--scale', default='smoke', choices=['smoke', 'full'])
  ap.add_argument('--epochs', type=int, default=3)
  ap.add_argument('--batch-size', type=int, default=1024)
  ap.add_argument('--fanout', default='15,10,5')
  ap.add_argument('--hidden', type=int, default=256)
  ap.add_argument('--split-ratio', type=float, default=1.0,
                  help='device-resident feature fraction')
  ap.add_argument('--device', default=None,
                  help='default: the card (cpu runs the plain versions)')
  ap.add_argument('--max-steps', type=int, default=None,
                  help='stop training, and evaluating, after this many '
                  'batches')
  args = ap.parse_args(argv)
  device = resolve_device(args.device)

  ds, num_classes = synthetic_products(
      num_nodes=2_450_000 if args.scale == 'full' else 24_000,
      split_ratio=args.split_ratio,
      sort_features=args.split_ratio < 1.0, device=device)
  fanout = [int(x) for x in args.fanout.split(',')]
  loader = NeighborLoader(ds, fanout, ds.get_split(Split.train),
                          batch_size=args.batch_size, shuffle=True, seed=0,
                          device=device)
  torch.manual_seed(0)
  feat = ds.get_node_feature()
  model = GraphSAGE(feat.feature_dim, args.hidden, num_classes,
                    num_layers=len(fanout)).to(device)
  step = SageTrainStep(model, lr=1e-3)
  cap = args.max_steps if args.max_steps is not None else float('inf')

  meter = ThroughputMeter('edges')
  steps, loss = 0, float('nan')
  for epoch in range(args.epochs):
    t0 = time.perf_counter()
    edges = 0
    for batch in loader:
      if steps >= cap:
        break
      loss = float(step(batch))
      edges += int(batch.num_sampled_edges.sum())
      steps += 1
    dt = time.perf_counter() - t0
    meter.update(edges, dt)
    print(f'epoch {epoch}: loss={loss:.4f} time={dt:.1f}s '
          f'({meter.report()})')

  eval_loader = NeighborLoader(ds, fanout, ds.get_split(Split.test),
                               batch_size=args.batch_size, seed=1,
                               device=device)
  correct = total = 0
  model.eval()
  with torch.no_grad():
    for i, batch in enumerate(eval_loader):
      if i >= cap:
        break
      nv = batch.metadata['n_valid']
      pred = model(batch).argmax(-1)[:nv]
      correct += int((pred == batch.y[:nv].long()).sum())
      total += nv
  acc = correct / max(total, 1)
  print(f'test acc: {acc:.4f}')
  return dict(loss=loss, steps=steps, test_acc=acc,
              hot_rows=feat.hot_count, rows=feat.num_rows)


if __name__ == '__main__':
  main()
