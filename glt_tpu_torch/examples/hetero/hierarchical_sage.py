"""Hierarchical hetero GraphSAGE (counterpart of
examples/hetero/hierarchical_sage.py): the hetero NeighborLoader over the
ogbn-mag-shaped graph with [10, 10] on every edge type, and an RGNN
rsage that trims each layer to the hops it still needs, by the batch's
``edge_hop_offsets_dict`` (the reference's trim_to_layer, as static
slices) -> masked cross-entropy -> Adam(1e-2).

    python -m glt_tpu_torch.examples.hetero.hierarchical_sage
        [--papers 4000] [--epochs 2] [--device cpu] [--max-steps N]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from glt_tpu_torch.examples.common import synthetic_hetero_mag
from glt_tpu_torch.examples.hetero.train_rgnn import batch_model, train
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.utils import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> float:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--epochs', type=int, default=2)
  ap.add_argument('--batch-size', type=int, default=128)
  ap.add_argument('--papers', type=int, default=4_000)
  ap.add_argument('--device', default=None,
                  help='default: the card (cpu runs the plain versions)')
  ap.add_argument('--max-steps', type=int, default=None,
                  help='training batches an epoch (default: all)')
  args = ap.parse_args(argv)
  device = resolve_device(args.device)

  ds, classes, _, _ = synthetic_hetero_mag(
      num_papers=args.papers, num_authors=args.papers // 2, device=device)
  loader = NeighborLoader(ds, [10, 10],
                          ('paper', np.arange(ds.node_count('paper'))),
                          batch_size=args.batch_size, shuffle=True, seed=0,
                          device=device)
  b0 = next(iter(loader))
  if not b0.edge_hop_offsets_dict:
    raise RuntimeError('the loader must supply trim offsets')
  torch.manual_seed(0)
  model = batch_model(b0, ds.get_node_feature('paper').shape[1], 64,
                      classes, device, conv='rsage', trim=True)
  return train(loader, model, 1e-2, args.epochs, args.max_steps)


if __name__ == '__main__':
  main()
