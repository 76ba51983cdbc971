"""Partitioned hetero training on IGBH-layout data (counterpart of
examples/igbh/dist_train_rgnn.py): synthesise (or read) the dataset, its
features compressed to bfloat16 (compress_graph.py), partition it with
RandomPartitioner, load this rank's partition (DistHeteroGraph,
DistDataset, a DistFeature a node type), train an RGNN through
DistHeteroTrainStep a batch a step, validate with ``eval_step`` after each
epoch, and log MLPerf's ``:::MLLOG`` lines.

One rank a card: ``python -m glt_tpu_torch.examples.igbh.dist_train_rgnn``
trains on one card (``--device cpu`` on the CPU); under ``torchrun
--nproc_per_node N`` each of N ranks drives its own card (NCCL; gloo on
the CPU) and the layout has N partitions. Partition files hold float32
(npz has no bfloat16); ``--bf16`` (default) casts the stores.

``--split-ratio R`` (< 1) spills each store: a rank keeps the first R of
its partition's rows of every node type on the card and pins the rest in
host memory, and its owner reads both blocks in one K3 launch
(``gather_rows_mixed``); the partition is then loaded to the host.

``--ckpt-dir D`` saves ``{'params', 'opt_state'}`` (the model's and
Adam's state dicts, ``utils.checkpoint``) every ``--ckpt-steps`` steps and
at the end; ``--resume`` restores the latest one, sets the global step
and the learning-rate schedule there, and runs every epoch from its
start, as the JAX example does (no data position is restored). A step's
uniforms are a function of ``(--seed, global step, rank)``
(:func:`step_uniforms`), as JAX draws a step from ``key(global_step)``,
so a resumed run draws what an uninterrupted one drew at the same step.

``--coordinator HOST:PORT --nprocs N --rank R`` is the multihost mode: the
process joins a group of N through ``parallel.multihost.initialize`` and
loads only its own partition (``dist_hetero_graph_from_partitions_
multihost``, ``dist_feature_from_partitions_multihost``), the edge types
from the partition's META and no feature table or edge payload of the
tree. It needs a pre-built ``--data-root`` and ``--part-root`` (N
partitions, e.g. from a run under torchrun, or :func:`partition`)::

    python -m glt_tpu_torch.examples.igbh.dist_train_rgnn --data-root R \
        --part-root P --coordinator 127.0.0.1:29500 --nprocs 2 --rank 0

(and ``--rank 1`` on the second card; add ``--device cpu`` on the CPU).
The JAX flags ``--num-devices`` and ``--cpu-mesh`` have no counterpart:
one process drives one card, and the world size is the group's.
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

from glt_tpu_torch.distributed.dist_neighbor_sampler import draw_hop_uniforms


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


def step_uniforms(trainer, seed: int, draw: int):
  """The uniforms of one batch of ``trainer`` (a DistHeteroTrainStep) for
  its ``uniforms=``: per hop and segment ``[world, *shape]`` (None for a
  full hop), this rank's row drawn on its device from a generator seeded
  by ``(seed, draw, rank)`` and shared by the other rows (each rank reads
  its own). ``draw`` is the global step (the validation batches take
  10,000 + their index, as the JAX example's keys do)."""
  mesh, sampler = trainer.mesh, trainer.sampler
  state = np.random.SeedSequence([int(seed), int(draw), mesh.rank])
  gen = torch.Generator(device=mesh.device)
  gen.manual_seed(int(state.generate_state(1, np.uint64)[0] >> 1))
  out = []
  for hop in sampler.uniform_shapes(trainer.bs, trainer.seed_type):
    out.append([])
    for shape in hop:
      u = draw_hop_uniforms(gen, shape, sampler.with_weight, mesh.device)
      out[-1].append(None if u is None
                     else u.expand((mesh.world,) + tuple(u.shape)))
  return out


def partition(root: str, part_root: str, num_parts: int) -> None:
  """Partition the IGBH-layout tree at ``root`` into ``num_parts`` parts at
  ``part_root`` (RandomPartitioner), each relation with its reverse so
  authors and institutes are reachable from papers. Partition files hold
  float32 (npz has no bfloat16); the stores cast to bf16 again."""
  from glt_tpu_torch.partition import RandomPartitioner
  from .data import load_igbh_root
  counts, edges, feats, *_ = load_igbh_root(root)
  for (s, r, d), ei in list(edges.items()):
    if s != d:
      edges[(d, f'rev_{r}', s)] = ei[::-1].copy()
  part_feats = {t: f.float().numpy() if isinstance(f, torch.Tensor) else f
                for t, f in feats.items()}
  del feats
  RandomPartitioner(part_root, num_parts=num_parts, num_nodes=dict(counts),
                    edge_index=edges, node_feat=part_feats).partition()


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
  ap.add_argument('--split-ratio', type=float, default=1.0,
                  help='<1 keeps that share of each partition\'s rows on '
                       'the card and pins the rest in host memory, read in '
                       'the same K3 launch')
  ap.add_argument('--learning-rate', type=float, default=1e-3)
  ap.add_argument('--lr-schedule', default='constant',
                  choices=['constant', 'cosine', 'linear'])
  ap.add_argument('--lr-warmup-steps', type=int, default=0)
  ap.add_argument('--seed', type=int, default=0)
  ap.add_argument('--mlperf', action='store_true',
                  help='3 epochs unless --epochs says otherwise, the whole '
                       'validation split, the MLLOG submission block')
  ap.add_argument('--ckpt-dir', default=None)
  ap.add_argument('--ckpt-steps', type=int, default=200)
  ap.add_argument('--resume', action='store_true')
  ap.add_argument('--val-batches', type=int, default=20)
  ap.add_argument('--part-root', default=None,
                  help='partition directory; reused if it holds META.json '
                       '(required pre-built in --coordinator mode)')
  ap.add_argument('--coordinator', default=None,
                  help='host:port: run as one of --nprocs processes, each '
                       'loading only its own partition')
  ap.add_argument('--nprocs', type=int, default=1)
  ap.add_argument('--rank', type=int, default=0)
  ap.add_argument('--device', default=None,
                  help='default: this rank\'s card; "cpu" for the CPU')
  args = ap.parse_args(argv)

  from glt_tpu_torch.distributed import (
      DistDataset, DistFeature, DistHeteroGraph, DistHeteroNeighborSampler,
      DistHeteroTrainStep, dist_feature_from_partitions_multihost,
      dist_hetero_graph_from_partitions_multihost)
  from glt_tpu_torch.models import RGNN
  from glt_tpu_torch.parallel import make_mesh
  from glt_tpu_torch.parallel.multihost import initialize
  from glt_tpu_torch.partition import load_meta as load_part_meta
  from glt_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
  from glt_tpu_torch.utils.mlperf_logging import MLLogger
  from .compress_graph import compress
  from .data import load_igbh_root, split_seeds, synthesize

  multihost = args.coordinator is not None
  root = args.data_root
  have_data = root is not None and os.path.exists(
      os.path.join(root, 'processed', 'meta.txt'))
  if multihost and not (args.part_root and os.path.exists(
      os.path.join(args.part_root, 'META.json'))):
    raise SystemExit('--coordinator mode needs a pre-built --part-root '
                     '(partition first: a run without --coordinator, or '
                     'dist_train_rgnn.partition)')
  if multihost and not have_data:
    raise SystemExit('--coordinator mode needs a pre-built shared '
                     '--data-root (each process would otherwise '
                     'synthesise a dataset of its own)')
  on_cpu = args.device == 'cpu'
  if multihost:
    initialize(coordinator_address=args.coordinator,
               num_processes=args.nprocs, process_id=args.rank)
    world = args.nprocs
  else:
    world = int(os.environ.get('WORLD_SIZE', '1'))
    if world > 1 and not dist.is_initialized():
      # torchrun's rendezvous (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)
      dist.init_process_group('gloo' if on_cpu else 'nccl')
  rank = dist.get_rank() if world > 1 else 0
  if args.device is not None:
    device = torch.device(args.device)
  elif torch.cuda.is_available():
    local = os.environ.get('LOCAL_RANK')
    device = torch.device('cuda', int(local) if local is not None
                          else rank % torch.cuda.device_count())
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

  if not have_data:
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
  counts, edges, _, labels, train_idx, val_idx = load_igbh_root(
      root, load_feats=False, load_edges=not multihost)
  num_classes = int(labels.max()) + 1
  mll.event('global_batch_size', args.batch_size * world)
  mll.event('train_samples', int(train_idx.shape[0]))
  mll.event('eval_samples', int(val_idx.shape[0]))

  part_root = scratch(args.part_root, 'igbh_parts_')
  have_parts = os.path.exists(os.path.join(part_root, 'META.json'))
  if multihost:
    # the edge payloads stay on disk: the fanouts need the edge types'
    # names only, which the partition's META records (reverses included)
    etypes = [tuple(e) for e in load_part_meta(part_root)['edge_types']]
    print(f'{len(etypes)} edge types over {counts}')
  else:
    print(f'{sum(e.shape[1] for e in edges.values())} directed edges over '
          f'{counts}')
    # reversed relations make authors and institutes reachable from papers
    etypes = list(edges) + [(d, f'rev_{r}', s) for s, r, d in edges
                            if s != d]
  del edges
  if rank == 0 and not have_parts:
    print('partitioning...')
    partition(root, part_root, world)
  if world > 1:
    dist.barrier()

  mesh = make_mesh(device=device)
  dtype = torch.bfloat16 if args.bf16 else None
  sr = args.split_ratio if args.split_ratio < 1.0 else None
  if multihost:
    # each process loads only its own partition
    dg = dist_hetero_graph_from_partitions_multihost(mesh, part_root)
    dfeats = {t: dist_feature_from_partitions_multihost(
        mesh, part_root, ntype=t, dtype=dtype, split_ratio=args.split_ratio)
        for t in counts}
  else:
    dg = DistHeteroGraph.from_dataset_partitions(mesh, part_root)
    # a spilled store's partition goes to the host: the card then holds
    # only its hot rows
    dss = {rank: DistDataset.load(part_root, rank,
                                  device='cpu' if sr is not None else device)}
    dfeats = {t: DistFeature.from_dist_datasets(mesh, dss, ntype=t,
                                                dtype=dtype, split_ratio=sr)
              for t in counts}
    del dss
  spilled = {t: st.cold_array is not None for t, st in dfeats.items()}
  if sr is not None:
    print(f'host-offloaded cold blocks active: {spilled}')
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
                             fanouts, batch_size_per_device=bs,
                             seed_type='paper', lr=args.learning_rate,
                             seed=args.seed)

  start_step = 0
  if args.ckpt_dir and args.resume:
    got, payload = restore_checkpoint(
        args.ckpt_dir, template={'params': model.state_dict()})
    if payload is not None:
      model.load_state_dict(payload['params'])
      step.optimizer.load_state_dict(payload['opt_state'])
      start_step = int(got)
      print(f'resumed from checkpoint step {start_step}')
  for g in step.optimizer.param_groups:
    g.setdefault('initial_lr', args.learning_rate)
  # the schedule's step is the global step (optax keeps it in opt_state)
  sched = torch.optim.lr_scheduler.LambdaLR(
      step.optimizer, lr_lambda(args.lr_schedule, args.lr_warmup_steps,
                                total_steps), last_epoch=start_step - 1)

  def save(at):
    if rank == 0:
      save_checkpoint(args.ckpt_dir, at, model.state_dict(),
                      opt_state=step.optimizer.state_dict())
    if world > 1:
      dist.barrier()

  mll.event('opt_base_learning_rate', args.learning_rate)
  mll.event('opt_learning_rate_warmup_steps', args.lr_warmup_steps)
  mll.event('opt_learning_rate_decay_schedule', args.lr_schedule)
  mll.event('seed', args.seed)

  rng = np.random.default_rng(args.seed)
  global_step, losses, accs = start_step, [], []
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
      loss = step(train_idx[sel].reshape(world, bs), np.full(world, bs),
                  step_uniforms(step, args.seed, global_step))
      sched.step()
      global_step += 1
      if it % 20 == 0:
        losses.append(float(loss))
        dt = time.time() - t_start
        print(f'epoch {epoch} step {it}/{per_epoch}: loss={losses[-1]:.4f} '
              f'({(global_step - start_step) * ndb / max(dt, 1e-9):.0f} '
              'seeds/s)')
      if args.ckpt_dir and global_step % args.ckpt_steps == 0:
        save(global_step)
        print(f'checkpoint saved at step {global_step}')
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
      c, t = step.eval_step(chunk.reshape(world, bs), nv,
                            step_uniforms(step, args.seed, 10_000 + vb))
      correct += c
      total += t
    acc = correct / max(total, 1)
    accs.append(acc)
    mll.eval_accuracy(acc, epoch)
    mll.eval_stop(epoch)
    mll.epoch_stop(epoch)
    print(f'epoch {epoch}: val_acc={acc:.4f} ({correct}/{total})')
  if args.ckpt_dir:
    save(global_step)
    print(f'final checkpoint at step {global_step}')
  mll.run_stop(epoch=args.epochs - 1)
  if world > 1:
    dist.barrier()
  if rank == 0:
    for path in made:
      shutil.rmtree(path, ignore_errors=True)
  if multihost:
    dist.destroy_process_group()
  print('done')
  return dict(losses=losses, accs=accs, steps=global_step,
              start_step=start_step, spilled=spilled,
              params={k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()})


if __name__ == '__main__':
  main()
