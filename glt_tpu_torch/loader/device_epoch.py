"""On-device seed staging for superstep training (counterpart of
glt_tpu/loader/device_epoch.py).

The per-batch loaders hand the trainer one padded seed batch per Python
iteration. The superstep trainer (``parallel.SPMDSageTrainStep``)
instead takes an epoch's shuffled, padded seed batches staged on the
device once as a ``[T, B]`` stack with per-shard valid counts, and
trains ``K`` batches a window: every window is a slice of that stack.
This module owns the staging, and the ragged-tail padding the per-batch
NodeLoader shares (:func:`pad_seed_batch`).
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import as_numpy, resolve_device


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


def stack_epoch_batches(seeds: np.ndarray, order: np.ndarray,
                        batch_size: int,
                        drop_last: bool) -> Tuple[np.ndarray, np.ndarray]:
  """Slice one epoch's permuted seeds into padded fixed-size batches:
  ``(stack [T, batch_size], n_valid [T] int32)``, numpy. Fewer seeds than
  one batch under ``drop_last`` is an empty epoch."""
  n = order.shape[0]
  stack, n_valid = [], []
  for lo in range(0, n, batch_size):
    hi = min(lo + batch_size, n)
    if hi - lo < batch_size and drop_last:
      break
    batch, nv = pad_seed_batch(seeds[order[lo:hi]], batch_size)
    stack.append(batch)
    n_valid.append(nv)
  if not stack:
    return (np.empty((0, batch_size), seeds.dtype),
            np.empty((0,), np.int32))
  return np.stack(stack), np.asarray(n_valid, np.int32)


def shard_n_valid(n_valid: np.ndarray, num_shards: int,
                  shard_batch: int) -> np.ndarray:
  """Per-batch valid counts split over the shard-major seed layout (shard
  d owns slots ``[d*B, (d+1)*B)``): shard d of a batch with ``v`` valid
  seeds holds ``clip(v - d*B, 0, B)``. ``[T]`` -> ``[T, num_shards]``
  int32."""
  d = np.arange(num_shards, dtype=np.int64) * shard_batch
  return np.clip(n_valid.astype(np.int64)[:, None] - d[None, :],
                 0, shard_batch).astype(np.int32)


class SeedSuperstep(NamedTuple):
  """One K-batch window of the staged epoch: ``seeds [K, B]`` and
  ``n_valid [K, num_shards]`` int32 slices of the staged stacks on the
  device (no fresh copy), and ``length`` K as an int (the epoch's tail
  window may be shorter, so a trainer captures at most two window
  lengths)."""
  seeds: torch.Tensor
  n_valid: torch.Tensor
  length: int


class DeviceEpochLoader:
  """Stages an epoch of shuffled, padded seed batches on the device once
  and yields K-batch windows for superstep training.

  Args:
    seeds: seed node ids (any array-like).
    batch_size: the global batch (num_shards x the per-rank batch, in the
      shard-major layout ``SPMDSageTrainStep`` reads).
    superstep_len: K, batches a window.
    num_shards: the mesh's width; ``n_valid`` comes per shard.
    shuffle, drop_last: the epoch's order and its ragged last batch.
    drop_last_superstep: also drop a trailing window shorter than K.
    rng: numpy Generator of the shuffle (default ``default_rng(0)``).
    device: where the stacks live (default the card; raises without
      one) or ``'cpu'``.
  """

  def __init__(self, seeds, batch_size: int, superstep_len: int = 8,
               num_shards: int = 1, shuffle: bool = False,
               drop_last: bool = False, drop_last_superstep: bool = False,
               rng: Optional[np.random.Generator] = None, device=None):
    self.seeds = as_numpy(seeds).astype(np.int64).reshape(-1)
    if self.seeds.shape[0] == 0:
      raise ValueError('DeviceEpochLoader needs at least one seed')
    self.batch_size = int(batch_size)
    if self.batch_size % int(num_shards):
      raise ValueError(f'batch_size {batch_size} not divisible by '
                       f'num_shards {num_shards}')
    self.superstep_len = max(1, int(superstep_len))
    self.num_shards = int(num_shards)
    self.shuffle = shuffle
    self.drop_last = drop_last
    self.drop_last_superstep = drop_last_superstep
    self.rng = rng or np.random.default_rng(0)
    self.device = resolve_device(device)

  @property
  def batches_per_epoch(self) -> int:
    n = self.seeds.shape[0]
    if self.drop_last:
      return n // self.batch_size
    return (n + self.batch_size - 1) // self.batch_size

  def __len__(self) -> int:
    """Windows an epoch."""
    t = self.batches_per_epoch
    if self.drop_last_superstep:
      return t // self.superstep_len
    return (t + self.superstep_len - 1) // self.superstep_len

  def stage_epoch(self) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shuffle, pad and copy one epoch to the device: ``(seeds [T, B],
    n_valid [T, num_shards])``, int32."""
    order = (self.rng.permutation(self.seeds.shape[0])
             if self.shuffle else np.arange(self.seeds.shape[0]))
    stack, n_valid = stack_epoch_batches(self.seeds, order, self.batch_size,
                                         self.drop_last)
    per_shard = shard_n_valid(n_valid, self.num_shards,
                              self.batch_size // self.num_shards)
    return (torch.as_tensor(stack.astype(np.int32), device=self.device),
            torch.as_tensor(per_shard, device=self.device))

  def __iter__(self) -> Iterator[SeedSuperstep]:
    seeds, n_valid = self.stage_epoch()
    t, k = seeds.shape[0], self.superstep_len
    for lo in range(0, t, k):
      hi = min(lo + k, t)
      if hi - lo < k and self.drop_last_superstep:
        break
      yield SeedSuperstep(seeds[lo:hi], n_valid[lo:hi], hi - lo)
