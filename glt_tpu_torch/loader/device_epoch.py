"""Seed-batch padding (counterpart of the ``pad_seed_batch`` of
glt_tpu/loader/device_epoch.py; its epoch stack for superstep training is
not ported yet)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_seed_batch(seeds: np.ndarray,
                   batch_size: int) -> Tuple[np.ndarray, int]:
  """Pad a (possibly ragged) seed batch to the fixed batch size: fill
  slots repeat the last valid seed, a real node id, so the sampling and
  gather shapes stay fixed and in range; ``n_valid`` masks them out of
  the loss. Returns ``(padded [batch_size], n_valid)``."""
  n_valid = int(seeds.shape[0])
  if n_valid == 0:
    raise ValueError('cannot pad an empty seed batch')
  if n_valid < batch_size:
    seeds = np.concatenate(
        [seeds, np.full(batch_size - n_valid, seeds[-1], seeds.dtype)])
  return seeds, n_valid
