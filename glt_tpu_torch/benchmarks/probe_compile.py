"""The compile probe's ladder on the card (counterpart of
benchmarks/probe_pallas_compile.py).

Seven rungs, from a plain copy to the shared-memory gather, each the
port's hand-written kernel for the TPU rung of the same number:

  1 vmem_id        : a [128, 128] float32 copy staged through shared
                     memory by cp.async (csrc/probes.cu)
  2 smem_scalar    : the block times an int32 scalar read on the card
  3 dma_fixed      : big[256:384] by one bulk async copy and an mbarrier
  4 dma_dynamic    : the same from a start read on the card (512)
  5 prefetch_grid  : 16 rows of a [64, 1, 128] table steered by an index
                     vector, one bulk row copy a block
  6 gather_windows : B3 (csrc/gather_windows.cu) at the probe's toy size
  7 vmem_take2d    : take(tab.ravel(), idx, mode='clip') from a [64, 128]
                     int32 table held in shared memory (csrc/take2d.cu)

Every rung draws its inputs from ``numpy.random.default_rng(seed)`` in
the JAX file's order, so seed 0 gives both probes the same inputs. A
rung is "ok" when its output equals its plain PyTorch version and the
TPU rung's own reference (numpy here), exactly. Usage, on a card:

    python -m glt_tpu_torch.benchmarks.probe_compile [--seed N]

Prints one ``{"<rung>": "ok" | "<error>"}`` line per rung, then the
status of every rung on one line; exits 1 if any rung failed. Without a
card it raises.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops import cuda_kernels as K
from ..ops import probe_kernels as P
from ..utils import resolve_device

#: the JAX rungs' sizes: window width and start of rungs 3-4, rung 6's
#: array, window and row count, rung 7's table and index block
WINDOW, FIXED_START, DYNAMIC_START = 128, 256, 512
GW_LEN, GW_WIDTH, GW_ROWS = 8192, 128, 64
TAB_ROWS, TAB_COLS, VT_SHAPE = 64, 128, (8, 3840)


def draw_inputs(seed: int = 0) -> Dict[str, np.ndarray]:
  """Every rung's numpy inputs, drawn in the order of
  benchmarks/probe_pallas_compile.py."""
  rng = np.random.default_rng(seed)
  d = {}
  d['x'] = rng.normal(size=(128, 128)).astype(np.float32)
  d['s'] = np.asarray([[3]], np.int32)
  d['big'] = rng.integers(0, 99, 4096, dtype=np.int32)
  d['st'] = np.asarray([[DYNAMIC_START]], np.int32)
  d['tab'] = rng.normal(size=(64, 1, 128)).astype(np.float32)
  d['rows'] = rng.integers(0, 64, 16, dtype=np.int32)
  d['arr'] = rng.integers(0, 99, GW_LEN, dtype=np.int32)
  d['starts'] = np.sort(rng.integers(0, GW_LEN - GW_WIDTH, GW_ROWS)
                        .astype(np.int32))
  d['tab2d'] = rng.integers(0, 1 << 20, (TAB_ROWS, TAB_COLS), dtype=np.int32)
  d['idx'] = rng.integers(0, TAB_ROWS * TAB_COLS, VT_SHAPE, dtype=np.int32)
  return d


def references(d: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
  """The TPU rungs' own references, in numpy."""
  return {
      '1_vmem_id': d['x'],
      '2_smem_scalar': d['x'] * np.float32(d['s'][0, 0]),
      '3_dma_fixed': d['big'][FIXED_START:FIXED_START + WINDOW],
      '4_dma_dynamic': d['big'][DYNAMIC_START:DYNAMIC_START + WINDOW],
      '5_prefetch_grid': np.take(d['tab'], d['rows'], axis=0),
      '6_gather_windows': np.stack([d['arr'][s:s + GW_WIDTH]
                                    for s in d['starts']]),
      '7_vmem_take2d': np.take(d['tab2d'].ravel(), d['idx'], mode='clip'),
  }


#: each rung's wrapper, by module and name (its plain version is
#: ``<name>_plain`` beside it); looked up at every call
KERNEL_OF = {'1_vmem_id': (P, 'vmem_id'), '2_smem_scalar': (P, 'smem_scalar'),
             '3_dma_fixed': (P, 'dma_fixed'),
             '4_dma_dynamic': (P, 'dma_dynamic'),
             '5_prefetch_grid': (P, 'prefetch_grid'),
             '6_gather_windows': (K, 'gather_windows'),
             '7_vmem_take2d': (P, 'vt')}


def rung_args(t: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
  """Each rung's arguments, from the inputs ``t`` on one device."""
  return {'1_vmem_id': (t['x'],), '2_smem_scalar': (t['x'], t['s']),
          '3_dma_fixed': (t['big'], FIXED_START, WINDOW),
          '4_dma_dynamic': (t['big'], t['st'], WINDOW),
          '5_prefetch_grid': (t['tab'], t['rows']),
          '6_gather_windows': (t['arr'], t['starts'], GW_WIDTH),
          '7_vmem_take2d': (t['tab2d'], t['idx'])}


def call(name: str, args: tuple, plain: bool = False) -> torch.Tensor:
  """Rung ``name``'s kernel (or, with ``plain``, its plain version)."""
  mod, fn = KERNEL_OF[name]
  return getattr(mod, fn + ('_plain' if plain else ''))(*args)


def run(device: torch.device, seed: int = 0) -> Dict[str, str]:
  """The ladder on ``device``; returns each rung's status."""
  d = draw_inputs(seed)
  want = references(d)
  t = {k: torch.as_tensor(v, device=device) for k, v in d.items()}
  status = {}
  for name, args in rung_args(t).items():
    # a rung reports its error and the ladder goes on, as the TPU probe
    # does; the run's exit code says whether every rung held
    try:
      got = call(name, args)
      plain = call(name, args, plain=True)
      if not torch.equal(got, plain):
        raise AssertionError(f'{name}: the kernel differs from its plain '
                             'version')
      if not np.array_equal(got.cpu().numpy(), want[name]):
        raise AssertionError(f'{name}: differs from the TPU rung\'s '
                             'reference')
      status[name] = 'ok'
    except Exception as e:   # noqa: BLE001 -- recorded, fails the run
      status[name] = f'{type(e).__name__}: {e}'[:200]
    print(json.dumps({name: status[name]}), flush=True)
  print(json.dumps(status), flush=True)
  return status


def main(argv: Optional[Sequence[str]] = None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--seed', type=int, default=0)
  opts = ap.parse_args(argv)
  status = run(resolve_device(None), opts.seed)
  return 0 if all(v == 'ok' for v in status.values()) else 1


if __name__ == '__main__':
  sys.exit(main())
