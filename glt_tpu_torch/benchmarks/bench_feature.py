"""Feature-gather throughput (counterpart of benchmarks/bench_feature.py,
the reference protocol of benchmarks/api/bench_feature.py: split ratio
0.2, lookups of random ids) over the two residency paths:

  device : a Feature whose whole table is on the card, ``device_gather``
           (the gather_rows kernel) of ``--batch`` random rows;
  split  : a Feature with ``--split-ratio`` of its rows on the card and
           the rest pinned in host memory, ``Feature.__getitem__`` (ids in
           from numpy, one gather_rows_mixed launch over both blocks, the
           rows out to numpy) of a batch whose ids hit the hot prefix 80%
           of the time.

The table is ``--num-rows`` x ``--dim`` float32 normals from
``default_rng(0)``, drawn as the JAX file draws them, and each path times
``--iters`` calls by the host clock, as the JAX file does (the device
path after one warm-up call, which builds the kernels). Usage:

    python -m glt_tpu_torch.benchmarks.bench_feature [--num-rows N]
        [--dim D] [--batch B] [--iters I] [--split-ratio R] [--device cpu]

Prints one JSON line per path (the JAX file's metric names, with the
device the rates were taken on). Runs on the card unless given
``--device cpu``, where the rates are the CPU's plain versions' and no
device metric.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import Feature
from ..utils import resolve_device


def _sync(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--num-rows', type=int, default=2_000_000)
  ap.add_argument('--dim', type=int, default=128)
  ap.add_argument('--batch', type=int, default=200_000)
  ap.add_argument('--iters', type=int, default=30)
  ap.add_argument('--split-ratio', type=float, default=0.2)
  ap.add_argument('--device', default=None,
                  help='default: the card (cpu times the plain versions)')
  args = ap.parse_args(argv)
  device = resolve_device(args.device)
  name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
          else 'cpu')

  rng = np.random.default_rng(0)
  feats = rng.normal(size=(args.num_rows, args.dim)).astype(np.float32)
  rates = {}

  def report(metric, seconds):
    rates[metric] = args.batch * args.iters / seconds
    print(json.dumps({'metric': metric, 'value': round(rates[metric], 1),
                      'unit': 'rows/s', 'vs_baseline': None,
                      'device': name}), flush=True)

  # path 1: fully device resident
  f_dev = Feature(feats, split_ratio=1.0, device=device)
  ids = torch.as_tensor(rng.integers(0, args.num_rows, args.batch),
                        device=device)
  f_dev.device_gather(ids)
  _sync(device)
  t0 = time.perf_counter()
  for _ in range(args.iters):
    f_dev.device_gather(ids)
  _sync(device)
  report('feature_gather_rows_per_sec_device', time.perf_counter() - t0)
  del f_dev

  # path 2: hot/cold split (a degree-ordered hot prefix assumed), 80% of
  # the ids in the hot prefix
  f_split = Feature(feats, split_ratio=args.split_ratio, device=device)
  hot_rows = int(args.num_rows * args.split_ratio)
  hot = rng.integers(0, hot_rows, int(args.batch * 0.8))
  cold = rng.integers(hot_rows, args.num_rows, args.batch - hot.shape[0])
  ids_np = np.concatenate([hot, cold])
  rng.shuffle(ids_np)
  t0 = time.perf_counter()
  for _ in range(args.iters):
    f_split[ids_np]
  report('feature_gather_rows_per_sec_split', time.perf_counter() - t0)
  return rates


if __name__ == '__main__':
  main()
