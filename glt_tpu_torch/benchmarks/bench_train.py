"""Per-batch against superstep training, the engine A/B of
benchmarks/bench_train.py (``measure_engines`` and ``--superstep-ab``;
its epoch-and-accuracy protocol is not ported).

Both engines are ``parallel.SPMDSageTrainStep`` on a one-rank mesh over
the same graph, features and starting weights, fed the same seeds and the
same uniforms (drawn once from one generator): the per-batch engine calls
the step K times a window, the superstep engine runs the window as one
unit, on the card one CUDA graph replayed after its first window. The
timed windows alternate between the engines (K per-batch steps, then one
window, each ending in a sync), as the JAX file interleaves them, so
drift on the host clock cancels. Before each window, outside the timed
span, the per-batch engine takes the superstep engine's weights and
Adam state, so the two start every window alike. It asserts loss parity
(exact on the CPU; within 1e-4 on the card, where ``index_add_``'s float
atomics sum in another order each run, an order that would otherwise
compound through every Adam step before the window) and that no capture
happens after the warm-up windows.

Usage:

    python -m glt_tpu_torch.benchmarks.bench_train --superstep-ab
        [--ab-k K] [--ab-batch B] [--ab-supersteps S] [--device cpu]

The defaults are the JAX file's (5,000 nodes of average out-degree 8, 16
features, 8 classes, batch 256, fanouts (3, 2), hidden 16, K = 8, 2
warm-up and 12 timed windows). chip_smoke.py runs this command, then
:func:`measure_engines` at products-sage's width on the graph it built
(``data=``). Prints one JSON line:
``train_steps_per_sec`` of the superstep engine, and in ``detail`` both
engines' steps/s and ms a step, on the card also their device busy share
(torch.profiler over one window each), the per-batch engine's peak
memory above the resident bytes, the memory the superstep's graph holds
(its private pool, measured across the warm-up windows) and the
captures' seconds, with the device's name. Runs on the card unless given
``--device cpu``, where no device metric is taken.
"""
from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import Dataset
from ..models import GraphSAGE
from ..ops.sample import walk_hop_uniforms
from ..parallel import ShardedFeature, SPMDSageTrainStep, make_mesh
from ..utils import resolve_device

#: loss parity on the card: the same batches, float atomics summed in
#: another order from run to run
CARD_LOSS_TOL = 1e-4


def _sync(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def device_busy(run, device: torch.device) -> float:
  """The share of ``run()``'s wall time during which a kernel ran on the
  card: the union of the CUDA kernel intervals of torch.profiler's trace
  over the host interval, which ends in a sync."""
  from torch.profiler import ProfilerActivity, profile
  _sync(device)
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    run()
    _sync(device)
    wall_us = (time.perf_counter() - t0) * 1e6
  cuda = torch.autograd.DeviceType.CUDA
  kern = sorted((e.time_range.start, e.time_range.end)
                for e in prof.events() if e.device_type == cuda)
  busy, end = 0.0, float('-inf')
  for a, b in kern:
    busy += max(0.0, b - max(a, end))
    end = max(end, b)
  return busy / wall_us


def measure_engines(num_nodes=5_000, avg_degree=8, feat_dim=16,
                    batch_size=256, fanout=(3, 2), hidden=16, num_classes=8,
                    k=8, supersteps=12, warmup=2, seed=0, device=None,
                    data=None) -> dict:
  """The A/B; returns the JSON line's dict. ``data`` = ``(dataset,
  feats, labels)`` reuses a built graph (chip_smoke.py's), else one is
  drawn from ``seed`` as the JAX file draws it."""
  device = resolve_device(device)
  if data is None:
    rng = np.random.default_rng(seed)
    e = num_nodes * avg_degree
    src = rng.integers(0, num_nodes, e, dtype=np.int64)
    dst = (rng.random(e) ** 2 * num_nodes).astype(np.int64) % num_nodes
    feats = rng.normal(size=(num_nodes, feat_dim)).astype(np.float32)
    labels = rng.integers(0, num_classes, num_nodes).astype(np.int32)
    ds = Dataset().init_graph(np.stack([src, dst]), num_nodes=num_nodes,
                              device=device)
    del src, dst
  else:
    ds, feats, labels = data
    rng = np.random.default_rng(seed)
    num_nodes = ds.get_graph().num_nodes
  mesh = make_mesh(device=device)
  torch.manual_seed(seed)
  model = GraphSAGE(feats.shape[1], hidden, num_classes,
                    num_layers=len(fanout)).to(device)
  sf = ShardedFeature(feats, mesh)
  engines = [SPMDSageTrainStep(mesh, m, ds.get_graph(), sf, labels,
                               list(fanout), batch_size)
             for m in (model, copy.deepcopy(model))]
  per_batch, windowed = engines

  n_win = warmup + supersteps
  seeds = rng.integers(0, num_nodes, (n_win, k, batch_size))
  nv = np.full((k, 1), batch_size)
  gen = torch.Generator(device=device).manual_seed(seed + 1)

  def window_uniforms():
    draws = [walk_hop_uniforms(gen, batch_size, fanout, False, device)
             for _ in range(k)]
    return [torch.stack(h)[:, None] for h in zip(*draws)]

  def run_pb(w, u):
    return torch.stack([per_batch(seeds[w, t], nv[t], [x[t] for x in u])
                        for t in range(k)])

  def align():
    """The per-batch engine takes the superstep engine's weights and Adam
    state, in place."""
    with torch.no_grad():
      for p, q in zip(per_batch.model.parameters(),
                      windowed.model.parameters()):
        p.copy_(q)
      for p, q in zip(per_batch.model.parameters(),
                      windowed.model.parameters()):
        mine, theirs = (per_batch.optimizer.state[p],
                        windowed.optimizer.state[q])
        for key, v in theirs.items():
          mine[key].copy_(v)

  def cached() -> int:
    """Bytes the allocator holds once its free cache is returned: live
    tensors plus the private pools of live CUDA graphs."""
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device)

  losses = {'pb': [], 'ss': []}
  cached0 = cached() if device.type == 'cuda' else 0
  for w in range(warmup):
    u = window_uniforms()
    if w:
      align()
    losses['pb'].append(run_pb(w, u))
    losses['ss'].append(windowed.superstep(seeds[w], nv, u))
  _sync(device)
  graph_pool = cached() - cached0 if device.type == 'cuda' else 0
  captures = windowed.superstep_captures
  dt = {'pb': 0.0, 'ss': 0.0}
  us = []
  for w in range(warmup, n_win):
    u = window_uniforms()
    us.append(u)
    align()
    _sync(device)
    t0 = time.perf_counter()
    losses['pb'].append(run_pb(w, u))
    _sync(device)
    dt['pb'] += time.perf_counter() - t0
    t0 = time.perf_counter()
    losses['ss'].append(windowed.superstep(seeds[w], nv, u))
    _sync(device)
    dt['ss'] += time.perf_counter() - t0
  recaptures = windowed.superstep_captures - captures
  if recaptures:
    raise AssertionError(f'{recaptures} captures after the warm-up')
  pb = torch.cat(losses['pb']).cpu().numpy()
  ss = torch.cat(losses['ss']).cpu().numpy()
  diff = float(np.abs(pb - ss).max())
  if device.type == 'cuda':
    if not diff <= CARD_LOSS_TOL:
      raise AssertionError(f'engine losses differ by {diff}')
  elif not np.array_equal(pb, ss):
    raise AssertionError(f'engine losses differ by {diff}')

  total = k * supersteps
  detail = dict(
      per_batch_steps_per_sec=total / dt['pb'],
      superstep_steps_per_sec=total / dt['ss'],
      speedup=dt['pb'] / dt['ss'],
      per_batch_ms_per_step=dt['pb'] * 1e3 / total,
      superstep_ms_per_step=dt['ss'] * 1e3 / total,
      superstep_k=k, batch_size=batch_size, fanout=list(fanout),
      hidden=hidden, num_nodes=num_nodes, feat_dim=int(feats.shape[1]),
      steps_timed=total, loss_max_abs_diff=diff,
      loss_parity='exact' if device.type != 'cuda' else
      f'within {CARD_LOSS_TOL}',
      captures=windowed.superstep_captures, recaptures=recaptures,
      capture_ms=[s * 1e3 for s in windowed.capture_seconds],
      final_loss=float(ss[-1]),
      device=(torch.cuda.get_device_name(device) if device.type == 'cuda'
              else 'cpu'))
  if device.type == 'cuda':
    # one more window each: its device busy share, then its peak memory
    u = us[-1]
    detail['per_batch_busy'] = device_busy(lambda: run_pb(0, u), device)
    detail['superstep_busy'] = device_busy(
        lambda: windowed.superstep(seeds[0], nv, u), device)
    for name, fn in (('per_batch', lambda: run_pb(0, u)),
                     ('superstep', lambda: windowed.superstep(seeds[0], nv,
                                                              u))):
      _sync(device)
      base = torch.cuda.memory_allocated(device)
      torch.cuda.reset_peak_memory_stats(device)
      fn()
      _sync(device)
      detail[f'{name}_peak_bytes'] = (torch.cuda.max_memory_allocated(device)
                                      - base)
    detail['resident_bytes'] = torch.cuda.memory_allocated(device)
    # the superstep engine works inside its graph's private pool, which
    # a replay's peak (it allocates nothing) does not show
    detail['superstep_graph_pool_bytes'] = graph_pool
  return {'metric': 'train_steps_per_sec',
          'value': detail['superstep_steps_per_sec'], 'unit': 'steps/s',
          'vs_baseline': None, 'detail': detail}


def main(argv: Optional[Sequence[str]] = None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--superstep-ab', action='store_true', required=True,
                  help='run the per-batch against superstep A/B (the only '
                       'protocol ported)')
  ap.add_argument('--ab-k', type=int, default=8)
  ap.add_argument('--ab-batch', type=int, default=256)
  ap.add_argument('--ab-supersteps', type=int, default=12)
  ap.add_argument('--device', default=None,
                  help='default: the card (cpu runs the plain versions)')
  args = ap.parse_args(argv)
  out = measure_engines(batch_size=args.ab_batch, k=args.ab_k,
                        supersteps=args.ab_supersteps, device=args.device)
  print(json.dumps(out), flush=True)
  return out


if __name__ == '__main__':
  main()
