"""A feature store serving another process (counterpart of
examples/feature_mp.py; the reference's examples/feature_mp.py shares a
Feature through CUDA IPC handles): row lookups cross two shared-memory
channels (ShmChannel) to a worker process whose ``Feature(split_ratio=
0.5)`` keeps half its rows on the card and half pinned in host memory,
and gathers each request's rows in one launch of K3 over both blocks
(``gather_rows_mixed``); the rows come back over the second channel.

    python -m glt_tpu_torch.examples.feature_mp [--device cpu]
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
from typing import Optional, Sequence

import numpy as np
import torch

NUM_ROWS, DIM = 1000, 16


def table(seed: int = 0) -> np.ndarray:
  """The worker's feature table: ``NUM_ROWS x DIM`` normal float32 rows
  from ``default_rng(seed)``, as the JAX example draws them."""
  return np.random.default_rng(seed).normal(
      size=(NUM_ROWS, DIM)).astype(np.float32)


def feature_worker(chan_req, chan_resp, device: Optional[str]) -> None:
  """Serves ``{'ids'}`` requests with ``{'rows'}`` until ``{'#EXIT'}``."""
  from glt_tpu_torch.data import Feature
  from glt_tpu_torch.data.feature import gather_features
  f = Feature(table(), split_ratio=0.5, device=device)
  while True:
    msg = chan_req.recv(timeout_ms=120_000)
    if '#EXIT' in msg:
      break
    rows = gather_features(f, msg['ids'].to(f.device))
    chan_resp.send({'rows': rows.cpu()})


def run(num_batches: int = 5, batch: int = 64, device=None, worker=None,
        worker_args: Sequence = ()) -> list:
  """Sends ``num_batches`` requests of ``batch`` ids (``default_rng(1)``)
  to a spawned ``worker`` (default :func:`feature_worker`, called with the
  two channels, the device and ``worker_args``); returns each request's
  ``(ids, rows)``."""
  from glt_tpu_torch.channel import ShmChannel
  from glt_tpu_torch.utils import resolve_device
  device = str(resolve_device(device))
  chan_req = ShmChannel(capacity_bytes=1 << 20)
  chan_resp = ShmChannel(capacity_bytes=1 << 22)
  p = mp.get_context('spawn').Process(
      target=worker or feature_worker,
      args=(chan_req, chan_resp, device, *worker_args))
  p.start()
  got = []
  try:
    rng = np.random.default_rng(1)
    for i in range(num_batches):
      ids = torch.as_tensor(rng.integers(0, NUM_ROWS, batch))
      chan_req.send({'ids': ids})
      rows = chan_resp.recv(timeout_ms=120_000)['rows'].clone()
      got.append((ids, rows))
      print(f'batch {i}: got {tuple(rows.shape)} rows')
    chan_req.send({'#EXIT': torch.ones(1)})
    p.join(timeout=60)
  finally:
    if p.is_alive():
      p.terminate()
      p.join(timeout=10)
    chan_req.close()
    chan_resp.close()
  if p.exitcode != 0:
    raise RuntimeError(f'the feature worker exited with {p.exitcode}')
  return got


def main(argv: Optional[Sequence[str]] = None) -> list:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--batches', type=int, default=5)
  ap.add_argument('--batch', type=int, default=64)
  ap.add_argument('--device', default=None,
                  help='default: the card; "cpu" for the CPU')
  args = ap.parse_args(argv)
  got = run(args.batches, args.batch, args.device)
  print('done')
  return got


if __name__ == '__main__':
  main()
