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

import torch

from glt_tpu_torch.examples.common import synthetic_products
from glt_tpu_torch.loader import LinkNeighborLoader
from glt_tpu_torch.models import GraphSAGE
from glt_tpu_torch.parallel import SageTrainStep, link_bce_loss
from glt_tpu_torch.sampler import NegativeSampling
from glt_tpu_torch.utils import resolve_device

FANOUTS, HIDDEN, EMBED, LR = [8, 4], 128, 64, 3e-3


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
