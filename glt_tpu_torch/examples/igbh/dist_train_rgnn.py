"""Partitioned hetero training on IGBH-layout data (counterpart of
examples/igbh/dist_train_rgnn.py, its single-host path): synthesise (or
read) the dataset, its features compressed to bfloat16 (compress_graph.py),
partition it with RandomPartitioner, load this rank's
partition (DistHeteroGraph, DistDataset, a DistFeature a node type), train
an RGNN through DistHeteroTrainStep a batch a step, validate with
``eval_step`` after each epoch, and log MLPerf's ``:::MLLOG`` lines.

One rank a card: ``python -m glt_tpu_torch.examples.igbh.dist_train_rgnn``
trains on one card (``--device cpu`` on the CPU); under ``torchrun
--nproc_per_node N`` each of N ranks drives its own card (NCCL; gloo on
the CPU) and the layout has N partitions. Partition files hold float32
(npz has no bfloat16); ``--bf16`` (default) casts the stores.

Not ported: ``--coordinator``/``--nprocs`` (the JAX multihost bootstrap),
``--ckpt-dir``/``--resume`` (ROADMAP A10), ``--split-ratio`` (every
store holds its whole partition on the card).
"""
from __future__ import annotations

import argparse
import math
import os
import shutil
import tempfile
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist


def lr_lambda(schedule: str, warmup: int, total_steps: int
              ) -> Callable[[int], float]:
  """The learning rate's factor at step n, the value of the JAX example's
  optax schedule over its base rate (examples/igbh/dist_train_rgnn.py
  :276-291): a linear warm-up from 0 over ``warmup`` steps, then constant,
  a cosine decay to 1% by ``total_steps``, or a linear decay to 1% over
  the steps after the warm-up."""
  def ramp(n):
    return min(n, warmup) / warmup

  def factor(n: int) -> float:
    if schedule == 'cosine':
      if warmup and n < warmup:
        return ramp(n)
      d = max(total_steps - warmup, 1)
      c = min(n - warmup, d)
      return 0.99 * 0.5 * (1 + math.cos(math.pi * c / d)) + 0.01
    if schedule == 'linear':
      if warmup and n < warmup:
        return ramp(n)
      d = max(total_steps - warmup, 1)
      return 1.0 - 0.99 * min(n - warmup, d) / d
    if schedule == 'constant':
      return ramp(n) if warmup else 1.0
    raise ValueError(f'unknown schedule {schedule!r}')
  return factor


def _shared(value, world: int):
  """Rank 0's ``value`` on every rank."""
  if world == 1:
    return value
  box = [value]
  dist.broadcast_object_list(box, src=0)
  return box[0]


def main(argv=None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--conv', default='rgat', choices=['rgat', 'rsage'])
  ap.add_argument('--epochs', type=int, default=1)
  ap.add_argument('--steps-per-epoch', type=int, default=0,
                  help='0 = a whole epoch over the train split')
  ap.add_argument('--fanout', default='10,5')
  ap.add_argument('--batch-size', type=int, default=64)
  ap.add_argument('--hidden', type=int, default=128)
  ap.add_argument('--heads', type=int, default=4)
  ap.add_argument('--data-root', default=None,
                  help='IGBH-layout tree (data.synthesize, split_seeds); '
                       'default synthesises one in a temporary directory')
  ap.add_argument('--papers', type=int, default=100_000,
                  help='synthetic scale when --data-root holds no data')
  ap.add_argument('--bf16', action=argparse.BooleanOptionalAction,
                  default=True, help='bfloat16 feature stores')
  ap.add_argument('--learning-rate', type=float, default=1e-3)
  ap.add_argument('--lr-schedule', default='constant',
                  choices=['constant', 'cosine', 'linear'])
  ap.add_argument('--lr-warmup-steps', type=int, default=0)
  ap.add_argument('--seed', type=int, default=0)
  ap.add_argument('--mlperf', action='store_true',
                  help='3 epochs unless --epochs says otherwise, the whole '
                       'validation split, the MLLOG submission block')
  ap.add_argument('--val-batches', type=int, default=20)
  ap.add_argument('--part-root', default=None,
                  help='partition directory; reused if it holds META.json')
  ap.add_argument('--device', default=None,
                  help='default: this rank\'s card; "cpu" for the CPU')
  args = ap.parse_args(argv)

  from glt_tpu_torch.distributed import (DistDataset, DistFeature,
                                         DistHeteroGraph,
                                         DistHeteroNeighborSampler,
                                         DistHeteroTrainStep)
  from glt_tpu_torch.models import RGNN
  from glt_tpu_torch.parallel import make_mesh
  from glt_tpu_torch.partition import RandomPartitioner
  from glt_tpu_torch.utils.mlperf_logging import MLLogger
  from .compress_graph import compress
  from .data import load_igbh_root, split_seeds, synthesize

  world = int(os.environ.get('WORLD_SIZE', '1'))
  on_cpu = args.device == 'cpu'
  if world > 1 and not dist.is_initialized():
    # torchrun's rendezvous (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)
    dist.init_process_group('gloo' if on_cpu else 'nccl')
  rank = dist.get_rank() if world > 1 else 0
  if args.device is not None:
    device = torch.device(args.device)
  elif torch.cuda.is_available():
    device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', '0')))
  else:
    raise SystemExit('no CUDA device: pass --device cpu to train on the CPU')
  if device.type == 'cuda':
    torch.cuda.set_device(device)
  if args.mlperf:
    if args.epochs == 1:
      args.epochs = 3
    args.val_batches = 1 << 30
  mll = MLLogger(benchmark='gnn',
                 emit=print if rank == 0 else (lambda *_: None))
  if args.mlperf:
    mll.submission_info(benchmark='GNN', submitter='glt_tpu',
                        platform=(torch.cuda.get_device_name(device)
                                  if device.type == 'cuda' else 'cpu'))
  mll.init_start()

  made = []    # temporary directories of this run, removed at its end

  def scratch(given, prefix):
    if given is not None:
      return given
    path = _shared(tempfile.mkdtemp(prefix=prefix) if rank == 0 else None,
                   world)
    made.append(path)
    return path

  root = args.data_root
  if root is None or not os.path.exists(
      os.path.join(root, 'processed', 'meta.txt')):
    root = scratch(root, 'igbh_data_')
    if rank == 0:
      print(f'synthesizing IGBH-layout data at {args.papers} papers...')
      synthesize(root, args.papers, seed=args.seed)
      # this path partitions from the COO: only compress's bf16 feature
      # pass is read
      compress(root, layout='CSC', bf16=args.bf16, topology=False,
               device=device)
      split_seeds(root)
    if world > 1:
      dist.barrier()
  counts, edges, feats, labels, train_idx, val_idx = load_igbh_root(root)
  # reversed relations make authors and institutes reachable from papers
  for (s, r, d), ei in list(edges.items()):
    if s != d:
      edges[(d, f'rev_{r}', s)] = ei[::-1].copy()
  etypes = list(edges)
  num_classes = int(labels.max()) + 1
  mll.event('global_batch_size', args.batch_size * world)
  mll.event('train_samples', int(train_idx.shape[0]))
  mll.event('eval_samples', int(val_idx.shape[0]))
  print(f'{sum(e.shape[1] for e in edges.values())} directed edges over '
        f'{counts}')

  part_root = scratch(args.part_root, 'igbh_parts_')
  if rank == 0 and not os.path.exists(os.path.join(part_root, 'META.json')):
    print('partitioning...')
    # partition files hold float32 (npz has no bfloat16); the stores
    # below cast to bf16 again
    part_feats = {t: f.float().numpy() if isinstance(f, torch.Tensor) else f
                  for t, f in feats.items()}
    RandomPartitioner(part_root, num_parts=world, num_nodes=dict(counts),
                      edge_index=edges, node_feat=part_feats).partition()
    del part_feats
  if world > 1:
    dist.barrier()
  del feats

  mesh = make_mesh(device=device)
  dtype = torch.bfloat16 if args.bf16 else None
  dg = DistHeteroGraph.from_dataset_partitions(mesh, part_root)
  dss = {rank: DistDataset.load(part_root, rank, device=device)}
  dfeats = {t: DistFeature.from_dist_datasets(mesh, dss, ntype=t, dtype=dtype)
            for t in counts}
  del dss
  fanout = [int(x) for x in args.fanout.split(',')]
  bs = args.batch_size
  fanouts = {e: fanout for e in etypes}
  torch.manual_seed(args.seed)
  in_dim = next(iter(dfeats.values())).feature_dim
  keys = DistHeteroNeighborSampler(dg, fanouts).message_passing_types(
      bs, 'paper')
  model = RGNN(keys, in_dim, args.hidden, num_classes,
               num_layers=len(fanout), conv=args.conv, heads=args.heads,
               node_types=list(counts)).to(device)
  per_epoch = args.steps_per_epoch or train_idx.shape[0] // (world * bs)
  total_steps = max(args.epochs * per_epoch, 1)
  step = DistHeteroTrainStep(dg, dfeats, model, {'paper': labels},
                             fanouts, batch_size_per_device=bs, seed_type='paper',
                             lr=args.learning_rate, seed=args.seed)
  sched = torch.optim.lr_scheduler.LambdaLR(
      step.optimizer, lr_lambda(args.lr_schedule, args.lr_warmup_steps,
                                total_steps))
  mll.event('opt_base_learning_rate', args.learning_rate)
  mll.event('opt_learning_rate_warmup_steps', args.lr_warmup_steps)
  mll.event('opt_learning_rate_decay_schedule', args.lr_schedule)
  mll.event('seed', args.seed)

  rng = np.random.default_rng(args.seed)
  global_step, losses, accs = 0, [], []
  mll.init_stop()
  mll.run_start()
  t_start = time.time()
  ndb = world * bs
  for epoch in range(args.epochs):
    mll.epoch_start(epoch)
    order = rng.permutation(train_idx.shape[0])
    for it in range(per_epoch):
      lo = (it * ndb) % train_idx.shape[0]
      sel = order[lo:lo + ndb]
      if sel.shape[0] < ndb:   # wrap the permutation at the epoch's seam
        sel = np.concatenate([sel, np.resize(order, ndb - sel.shape[0])])
      loss = step(train_idx[sel].reshape(world, bs), np.full(world, bs))
      sched.step()
      global_step += 1
      if it % 20 == 0:
        losses.append(float(loss))
        dt = time.time() - t_start
        print(f'epoch {epoch} step {it}/{per_epoch}: loss={losses[-1]:.4f} '
              f'({global_step * ndb / max(dt, 1e-9):.0f} seeds/s)')
    mll.eval_start(epoch)
    correct = total = 0
    for vb in range(args.val_batches):
      lo = vb * ndb
      if lo >= val_idx.shape[0]:
        break
      chunk = val_idx[lo:lo + ndb]
      nv = np.array([min(bs, max(0, chunk.shape[0] - p * bs))
                     for p in range(world)], np.int32)
      if chunk.shape[0] < ndb:
        chunk = np.concatenate([chunk, np.full(ndb - chunk.shape[0],
                                               chunk[-1])])
      c, t = step.eval_step(chunk.reshape(world, bs), nv)
      correct += c
      total += t
    acc = correct / max(total, 1)
    accs.append(acc)
    mll.eval_accuracy(acc, epoch)
    mll.eval_stop(epoch)
    mll.epoch_stop(epoch)
    print(f'epoch {epoch}: val_acc={acc:.4f} ({correct}/{total})')
  mll.run_stop(epoch=args.epochs - 1)
  if world > 1:
    dist.barrier()
  if rank == 0:
    for path in made:
      shutil.rmtree(path, ignore_errors=True)
  print('done')
  return dict(losses=losses, accs=accs, steps=global_step)


if __name__ == '__main__':
  main()
