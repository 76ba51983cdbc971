"""Hetero RGNN (RGAT or RSAGE) training on the ogbn-mag-shaped graph
(counterpart of examples/hetero/train_rgnn.py): the hetero NeighborLoader
seeded on papers, ``{cites: [5, 5], writes: [5, 5]}``, batch 128 -> RGNN
(hidden 64, 2 layers) -> masked cross-entropy -> Adam(2e-3).

The model takes the relations a batch holds (here only ``cites``: no
paper-seeded batch reaches an author) and a self layer for every node
type they do not reach, the parameters the flax RGNN makes on the same
batch.

    python -m glt_tpu_torch.examples.hetero.train_rgnn [--conv rsage]
        [--epochs 3] [--device cpu] [--max-steps N]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from glt_tpu_torch.examples.common import synthetic_hetero_mag
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.models import RGNN
from glt_tpu_torch.parallel import SageTrainStep
from glt_tpu_torch.utils import resolve_device


def batch_model(batch, feat_dim, hidden, classes, device, **kw) -> RGNN:
  """An RGNN over the relations of ``batch`` with a self layer for each
  of its node types that none of them reaches."""
  return RGNN(list(batch.row_dict), feat_dim, hidden, classes,
              num_layers=2, node_types=list(batch.x_dict), **kw).to(device)


def train(loader, model, lr, epochs, max_steps=None) -> float:
  step = SageTrainStep(model, lr=lr)
  loss = float('nan')
  for epoch in range(epochs):
    for i, batch in enumerate(loader):
      if max_steps is not None and i == max_steps:
        break
      loss = float(step(batch))
    print(f'epoch {epoch}: loss={loss:.4f}')
  return loss


def main(argv: Optional[Sequence[str]] = None) -> float:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--conv', default='rgat', choices=['rgat', 'rsage'])
  ap.add_argument('--epochs', type=int, default=3)
  ap.add_argument('--device', default=None,
                  help='default: the card (cpu runs the plain versions)')
  ap.add_argument('--max-steps', type=int, default=None,
                  help='training batches an epoch (default: all)')
  args = ap.parse_args(argv)
  device = resolve_device(args.device)

  ds, classes, cites, writes = synthetic_hetero_mag(device=device)
  loader = NeighborLoader(ds, {cites: [5, 5], writes: [5, 5]},
                          ('paper', np.arange(2000)), batch_size=128,
                          shuffle=True, seed=0, device=device)
  torch.manual_seed(0)
  model = batch_model(next(iter(loader)),
                      ds.get_node_feature('paper').shape[1], 64, classes,
                      device, conv=args.conv)
  return train(loader, model, 2e-3, args.epochs, args.max_steps)


if __name__ == '__main__':
  main()
