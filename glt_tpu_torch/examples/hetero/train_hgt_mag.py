"""HGT training on an ogbn-mag-shaped hetero graph (counterpart of
examples/hetero/train_hgt_mag.py, the reference's HGTConv workload): the
hetero NeighborLoader seeded on papers, ``{cites: [5, 5], writes: [5,
5]}``, batch 128 -> HGT (hidden 64, 2 heads, 2 layers) -> masked
cross-entropy on the paper labels -> Adam(2e-3).

``--scale toy`` is the JAX example's graph (2,000 papers, 1,000 authors,
64 features, 8 classes); ``--scale mag`` has ogbn-mag's counts (736,389
papers, 1,134,649 authors, 5,416,271 cites, 7,145,660 writes, 128
features, 349 classes). Seeded on papers and sampled along out-edges,
no batch reaches an author (``writes`` expands from authors): the author
type is one padded row and ``rev_writes`` never appears, as in JAX.

    python -m glt_tpu_torch.examples.hetero.train_hgt_mag [--scale mag]
        [--epochs 3] [--device cpu] [--max-steps N]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from glt_tpu_torch.examples.common import MAG_COUNTS, synthetic_hetero_mag
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.models import HGT
from glt_tpu_torch.parallel import SageTrainStep
from glt_tpu_torch.typing import reverse_edge_type
from glt_tpu_torch.utils import resolve_device

FANOUTS, BATCH, LR = [5, 5], 128, 2e-3


def mag_dataset(scale: str, device=None):
  """``(dataset, classes, cites, writes, train ids)`` at ``scale``: the
  toy trains on the JAX example's first 2,000 papers, ``mag`` on every
  paper."""
  if scale == 'toy':
    ds, classes, cites, writes = synthetic_hetero_mag(device=device)
    return ds, classes, cites, writes, np.arange(2000)
  ds, classes, cites, writes = synthetic_hetero_mag(device=device,
                                                    **MAG_COUNTS)
  return ds, classes, cites, writes, np.arange(MAG_COUNTS['num_papers'])


def make_model(ds, classes, cites, writes, hidden=64, heads=2,
               device=None) -> HGT:
  feat = {t: ds.get_node_feature(t).shape[1] for t in ('paper', 'author')}
  return HGT(['paper', 'author'],
             [reverse_edge_type(cites), reverse_edge_type(writes)], feat,
             hidden, classes, num_layers=2, heads=heads).to(device)


def main(argv: Optional[Sequence[str]] = None) -> float:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--scale', default='toy', choices=['toy', 'mag'])
  ap.add_argument('--epochs', type=int, default=3)
  ap.add_argument('--heads', type=int, default=2)
  ap.add_argument('--hidden', type=int, default=64)
  ap.add_argument('--device', default=None,
                  help='default: the card (cpu runs the plain versions)')
  ap.add_argument('--max-steps', type=int, default=None,
                  help='training batches an epoch (default: all)')
  args = ap.parse_args(argv)
  device = resolve_device(args.device)

  ds, classes, cites, writes, train = mag_dataset(args.scale, device)
  loader = NeighborLoader(ds, {cites: FANOUTS, writes: FANOUTS},
                          ('paper', train), batch_size=BATCH, shuffle=True,
                          seed=0, device=device)
  torch.manual_seed(0)
  model = make_model(ds, classes, cites, writes, args.hidden, args.heads,
                     device)
  step = SageTrainStep(model, lr=LR)
  loss = float('nan')
  for epoch in range(args.epochs):
    for i, batch in enumerate(loader):
      if args.max_steps is not None and i == args.max_steps:
        break
      loss = float(step(batch))
    print(f'epoch {epoch}: loss={loss:.4f}')
  return loss


if __name__ == '__main__':
  main()
