"""Partitioned unsupervised GraphSAGE (counterpart of
examples/distributed/dist_sage_unsup.py, the reference's dist_sage_unsup
workload): each rank's positive edges are those whose source it owns;
DistLinkNeighborLoader seeds their endpoints and as many binary
negatives (strict across every partition with ``--strict``) into the
partitioned sampler, and each step embeds every sampled node
(``GraphSAGE.embed``), scores the labelled pairs by dot product, takes the
sigmoid BCE, averages the gradients over the ranks and steps Adam(3e-3).

    python -m glt_tpu_torch.examples.distributed.dist_sage_unsup \
        [--device cpu] [--strict]
    torchrun --nproc_per_node N -m \
        glt_tpu_torch.examples.distributed.dist_sage_unsup
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from glt_tpu_torch.examples.distributed.common import (init_rank,
                                                       partition_dir)
from glt_tpu_torch.loader.transform import Batch
from glt_tpu_torch.ops.pipeline import edge_hop_offsets


def ring_and_random(n: int, feat_dim: int = 64, seed: int = 0):
  """The JAX example's graph: a ring plus ``4 n`` uniform edges, normal
  features."""
  rng = np.random.default_rng(seed)
  src = np.concatenate([np.arange(n), rng.integers(0, n, n * 4)])
  dst = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, n * 4)])
  feats = rng.normal(size=(n, feat_dim)).astype(np.float32)
  return np.stack([src, dst]), feats


def positive_pools(edge_index: np.ndarray, node_pb, world: int):
  """Each rank's positive edges: those whose source it owns."""
  pb = np.asarray(node_pb.cpu() if isinstance(node_pb, torch.Tensor)
                  else node_pb)
  owner = pb[edge_index[0]]
  return [edge_index[:, owner == p] for p in range(world)]


def link_batch(out: dict, fanouts: Sequence[int]) -> Batch:
  """A loader batch of this rank as the Batch ``link_bce_loss`` reads:
  every seed endpoint a label row, the labelled pairs in ``metadata``."""
  spd = out['seed_labels'].numel()
  return Batch(x=out['x'], row=out['row'], col=out['col'],
               edge_mask=out['edge_mask'], node=out['node'],
               node_count=out['node_count'], batch_size=spd,
               edge_hop_offsets=tuple(edge_hop_offsets(spd, fanouts)),
               metadata={'edge_label_index': out['edge_label_index'],
                         'edge_label': out['edge_label']})


class LinkStep:
  """One data-parallel link step over a loader batch: ``link_bce_loss``,
  the gradients' mean over the mesh, Adam (optax's defaults)."""

  def __init__(self, mesh, model, fanouts: Sequence[int], lr: float = 3e-3):
    import torch.distributed as dist
    self.mesh, self.model, self.fanouts = mesh, model, list(fanouts)
    if mesh.world > 1:
      for p in model.parameters():
        dist.broadcast(p.data, 0, group=mesh.group)
    self.optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                      betas=(0.9, 0.999), eps=1e-8)

  def __call__(self, out: dict) -> torch.Tensor:
    from glt_tpu_torch.parallel import link_bce_loss
    from glt_tpu_torch.parallel.train import mesh_update
    return mesh_update(self.model, self.optimizer, self.mesh,
                       link_batch(out, self.fanouts), loss_fn=link_bce_loss)


def main(argv: Optional[Sequence[str]] = None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--nodes', type=int, default=4_000)
  ap.add_argument('--epochs', type=int, default=2)
  ap.add_argument('--batch-size', type=int, default=32,
                  help='positive edges a rank a step')
  ap.add_argument('--fanout', default='8,4')
  ap.add_argument('--hidden', type=int, default=128)
  ap.add_argument('--embed', type=int, default=64)
  ap.add_argument('--strict', action='store_true',
                  help='negatives that are no edge of any partition')
  ap.add_argument('--max-steps', type=int, default=None)
  ap.add_argument('--seed', type=int, default=0)
  ap.add_argument('--device', default=None,
                  help='default: this rank\'s card; "cpu" for the CPU')
  args = ap.parse_args(argv)

  from glt_tpu_torch.distributed import (DistDataset, DistFeature,
                                         DistGraph, DistLinkNeighborLoader)
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.parallel import make_mesh
  from glt_tpu_torch.partition import RandomPartitioner
  from glt_tpu_torch.sampler import NegativeSampling

  world, rank, device = init_rank(args.device)
  edge_index, feats = ring_and_random(args.nodes, seed=args.seed)
  mesh = make_mesh(device=device)
  with partition_dir(world, rank, 'unsup_parts_', lambda root:
                     RandomPartitioner(root, num_parts=world,
                                       num_nodes=args.nodes,
                                       edge_index=edge_index,
                                       node_feat=feats).partition()) as root:
    dg = DistGraph.from_dataset_partitions(mesh, root)
    ds = {rank: DistDataset.load(root, rank, device=device)}
    df = DistFeature.from_dist_datasets(mesh, ds)
  fanout = [int(x) for x in args.fanout.split(',')]
  loader = DistLinkNeighborLoader(
      dg, fanout, positive_pools(edge_index, dg.node_pb, world),
      dist_feature=df,
      neg_sampling=NegativeSampling('binary', amount=1, strict=args.strict),
      batch_size=args.batch_size, shuffle=True, seed=args.seed)
  torch.manual_seed(args.seed)
  model = GraphSAGE(feats.shape[1], args.hidden, args.embed,
                    num_layers=len(fanout)).to(device)
  step = LinkStep(mesh, model, fanout)
  losses = []
  for epoch in range(args.epochs):
    for b in loader:
      losses.append(float(step(b)))
      if args.max_steps and len(losses) >= args.max_steps:
        break
    if rank == 0:
      print(f'epoch {epoch}: loss={losses[-1]:.4f}')
  return dict(losses=losses)


if __name__ == '__main__':
  main()
