"""Partitioned supervised GraphSAGE (counterpart of
examples/distributed/dist_train_sage.py, the reference's
dist_train_sage_supervised.py): the products-shaped graph of
``synthetic_products`` (examples/common.py's draws), partitioned to disk by RandomPartitioner, this rank's
partition loaded back (DistGraph, DistDataset, DistFeature: resident, or
with ``--split-ratio`` its first rows on the card and the rest pinned in
host memory) and trained by DistTrainStep, one batch a step.

    python -m glt_tpu_torch.examples.distributed.dist_train_sage \
        [--device cpu] [--split-ratio 0.2]
    torchrun --nproc_per_node N -m \
        glt_tpu_torch.examples.distributed.dist_train_sage

The defaults are the JAX example's CPU size (8,000 nodes, hidden 128, two
layers, [10, 5], 128 seeds a rank); products-sage's width is
``--num-nodes 2450000 --hidden 256 --num-layers 3 --fanout 15,10,5
--batch-size 1024``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from glt_tpu_torch.examples.distributed.common import (init_rank,
                                                       partition_dir)


def load_stores(mesh, root: str, split_ratio: Optional[float] = None):
  """This rank's DistGraph and DistFeature of the layout at ``root``
  (``split_ratio`` of its rows on the card, default all). A spilled
  store's partition is loaded to the host, so that the card holds only
  its hot rows."""
  from glt_tpu_torch.distributed import DistDataset, DistFeature, DistGraph
  dg = DistGraph.from_dataset_partitions(mesh, root)
  ds = {mesh.rank: DistDataset.load(
      root, mesh.rank, device=mesh.device if split_ratio is None else 'cpu')}
  return dg, DistFeature.from_dist_datasets(mesh, ds, split_ratio=split_ratio)


def main(argv: Optional[Sequence[str]] = None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--num-nodes', type=int, default=8_000)
  ap.add_argument('--feat-dim', type=int, default=100)
  ap.add_argument('--classes', type=int, default=47)
  ap.add_argument('--hidden', type=int, default=128)
  ap.add_argument('--num-layers', type=int, default=2)
  ap.add_argument('--fanout', default='10,5')
  ap.add_argument('--batch-size', type=int, default=128,
                  help='seeds a rank a step')
  ap.add_argument('--steps', type=int, default=30)
  ap.add_argument('--lr', type=float, default=1e-3)
  ap.add_argument('--split-ratio', type=float, default=None,
                  help='share of each partition\'s rows on the card, the '
                       'rest pinned in host memory (default: all)')
  ap.add_argument('--seed', type=int, default=0)
  ap.add_argument('--device', default=None,
                  help='default: this rank\'s card; "cpu" for the CPU')
  args = ap.parse_args(argv)

  from glt_tpu_torch.distributed import DistTrainStep
  from glt_tpu_torch.examples.common import synthetic_products
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.parallel import make_mesh
  from glt_tpu_torch.partition import RandomPartitioner

  world, rank, device = init_rank(args.device)
  ds, _ = synthetic_products(num_nodes=args.num_nodes,
                             feat_dim=args.feat_dim,
                             num_classes=args.classes, seed=args.seed,
                             device=device)
  src, dst, _ = ds.get_graph().topo.to_coo()
  edge_index = torch.stack([src, dst]).cpu().numpy()
  feats = ds.get_node_feature().table.cpu().numpy()
  labels = np.asarray(ds.node_labels)
  del ds, src, dst
  mesh = make_mesh(device=device)
  t0 = time.perf_counter()
  with partition_dir(world, rank, 'glt_parts_', lambda root: RandomPartitioner(
      root, num_parts=world, num_nodes=args.num_nodes, edge_index=edge_index,
      node_feat=feats, seed=args.seed).partition()) as root:
    dg, df = load_stores(mesh, root, args.split_ratio)
  print(f'rank {rank}: partitioned and loaded in '
        f'{time.perf_counter() - t0:.1f} s; {dg.max_edges} edges, '
        f'{df.hot_count} of {df.num_rows} feature rows on {device}')
  del feats, edge_index

  fanout = [int(x) for x in args.fanout.split(',')]
  torch.manual_seed(args.seed)
  model = GraphSAGE(args.feat_dim, args.hidden, args.classes,
                    num_layers=args.num_layers).to(device)
  step = DistTrainStep(dg, df, model, labels, fanout, args.batch_size,
                       lr=args.lr, seed=args.seed)
  rng = np.random.default_rng(args.seed)
  losses = []
  for it in range(args.steps):
    seeds = rng.integers(0, args.num_nodes, (world, args.batch_size))
    losses.append(float(step(seeds, np.full(world, args.batch_size))))
    if it % 10 == 0 and rank == 0:
      print(f'step {it}: loss={losses[-1]:.4f}')
  if rank == 0:
    print('done')
  return dict(losses=losses, spilled=df.cold_array is not None)


if __name__ == '__main__':
  main()
