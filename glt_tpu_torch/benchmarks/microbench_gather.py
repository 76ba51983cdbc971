"""Random-gather rates on the card (counterpart of
benchmarks/microbench_pallas_gather.py), at that file's sizes:

  elem      : torch.take of M = 768,000 elements from an E = 62,000,000
              int32 array (248 MB), the sampler's edge array (the JAX
              file's ``xla_elem``);
  rows      : a 153,600-row gather from a [1,000,000, 128] float32 table
              (512 MB): index_select (``xla_rows``) and the port's K3
              gather_rows (csrc/gather_rows.cu) beside it;
  dma_rows  : B3 gather_windows (csrc/gather_windows.cu), R = 153,600
              sorted starts, width 128, over the edge array; B3 takes no
              ``block``, so one entry stands for ``dma_rows_b8``/``_b32``;
  vmem_take : the shared-memory gather (csrc/take2d.cu) of [200, 3840]
              int32 indices from a [64, 128] int32 table, with torch.take
              on the flat table beside it (its indices int64, as
              torch.take takes them).

Each rate times ITERS - 1 calls on distinct inputs after one warm-up
call on the first (``timed_varying``), with CUDA events; every input is
generated on the card from ``--seed``. Each kernel's output is held
equal to its library call's on the last inputs. Usage, on a card:

    python -m glt_tpu_torch.benchmarks.microbench_gather [--seed N]

Prints one JSON line of ms per call and ns per element or row (the JAX
file's key names, unrounded), with ``backend: "cuda"`` and the card's
name and power limit. Measures the card only: it raises without one
(there is no ``--device``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..ops import cuda_kernels as K
from ..ops import probe_kernels as P
from ..utils import resolve_device

E, M = 62_000_000, 768_000
NR, D, BR = 1_000_000, 128, 153_600
R, W = 153_600, 128
TN, TD, TAKE_SHAPE = 64, 128, (200, 3840)
ITERS = 6
#: the ids the edge array holds (products' node count, as the JAX file)
NUM_IDS = 2_450_000


def timed_varying(fn: Callable[..., torch.Tensor], variants: Sequence[tuple]
                  ) -> Tuple[float, torch.Tensor]:
  """Mean ms a call of ``fn`` over ``variants[1:]``, each a distinct
  argument tuple, after a warm-up call on ``variants[0]``; CUDA events
  around the calls. Returns it and the last call's output."""
  fn(*variants[0])
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for v in variants[1:]:
    out = fn(*v)
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / (len(variants) - 1), out


def card_name(dev: torch.device) -> str:
  """The card as ``nvidia-smi --query-gpu=name,power.limit`` names it."""
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader',
       '-i', str(dev.index)], capture_output=True, text=True, check=True,
      timeout=60).stdout.strip()


def run(dev: torch.device, seed: int = 0) -> Dict[str, object]:
  """Every rate on the card ``dev`` (timed with CUDA events); returns the
  result dict."""
  gen = torch.Generator(device=dev).manual_seed(seed)

  def ints(hi, shape, dtype=torch.int32):
    return torch.randint(0, hi, shape, generator=gen, device=dev,
                         dtype=dtype)
  res: Dict[str, object] = {'backend': 'cuda', 'device': card_name(dev)}

  # elem: the edge array's random element gather (torch.take indexes
  # with int64)
  arr = ints(NUM_IDS, (E,))
  idxs = [ints(E, (M,), torch.int64) for _ in range(ITERS)]
  dt, _ = timed_varying(torch.take, [(arr, i) for i in idxs])
  res['elem_ns_per_elt'] = 1e6 * dt / M
  res['elem_ms'] = dt
  del idxs

  # rows: the feature path's row gather, index_select and K3
  tab = torch.randn((NR, D), generator=gen, device=dev)
  rowss = [ints(NR, (BR,)) for _ in range(ITERS)]
  dt, want = timed_varying(lambda t, r: torch.index_select(t, 0, r),
                           [(tab, r) for r in rowss])
  res['rows_ns_per_row'] = 1e6 * dt / BR
  res['rows_ns_per_elt'] = 1e6 * dt / (BR * D)
  res['rows_ms'] = dt
  dt, got = timed_varying(K.gather_rows, [(tab, r) for r in rowss])
  if not torch.equal(got, want):
    raise AssertionError('gather_rows differs from index_select')
  res['gather_rows_ns_per_row'] = 1e6 * dt / BR
  res['gather_rows_ms'] = dt
  del tab, rowss, got, want

  # dma_rows: B3 over sorted starts, windows inside the array
  startss = [torch.sort(ints(E - W, (R,))).values for _ in range(ITERS)]
  dt, got = timed_varying(K.gather_windows,
                          [(arr, s, W) for s in startss])
  if not torch.equal(got, K.gather_windows_plain(arr, startss[-1], W)):
    raise AssertionError('gather_windows differs from plain')
  res['dma_rows_ns_per_row'] = 1e6 * dt / R
  res['dma_rows_ms'] = dt
  del arr, startss, got

  # vmem_take: the table held in shared memory, torch.take beside it
  table2d = ints(1 << 20, (TN, TD))
  idx_smalls = [ints(TN * TD, TAKE_SHAPE) for _ in range(ITERS)]
  dt, got = timed_varying(P.vmem_take, [(table2d, i) for i in idx_smalls])
  dt_take, want = timed_varying(torch.take,
                                [(table2d, i.long()) for i in idx_smalls])
  if not torch.equal(got, want):
    raise AssertionError('vmem_take differs from torch.take')
  n = idx_smalls[0].numel()
  res['vmem_take_ns_per_elt'] = 1e6 * dt / n
  res['vmem_take_ms'] = dt
  res['take_flat_ns_per_elt'] = 1e6 * dt_take / n
  res['take_flat_ms'] = dt_take
  return res


def main(argv: Optional[Sequence[str]] = None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--seed', type=int, default=0)
  opts = ap.parse_args(argv)
  print(json.dumps(run(resolve_device(None), opts.seed)), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
