"""NodeLoader: seed iteration + sampling + feature collation (counterpart
of glt_tpu/loader/node_loader.py).

The host only shuffles and pads seed ids (numpy); sampling, dedup and the
feature gather run on the sampler's device. The last ragged batch is
padded to the batch size, ``metadata['n_valid']`` counting its real
seeds. The port's feature store is fully device-resident, so collation
has no host phase and the loader no prefetch thread (the JAX default is
depth 0 for such stores too). Homogeneous datasets only: the hetero
collate is not ported yet. Sampling and the feature gather carry
``torch.profiler`` ranges named as the serving engine's stages
(``sample.multihop``, ``gather.features``).
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..data import Dataset
from ..data.feature import gather_features
from ..sampler import BaseSampler, SamplerOutput
from ..utils import as_numpy
from .device_epoch import pad_seed_batch
from .transform import Batch, to_batch


class NodeLoader:
  """Iterates seed-node batches through a sampler.

  Args:
    data: the Dataset (graph + features + labels).
    sampler: the sampler (NeighborLoader builds a NeighborSampler).
    input_nodes: seed ids.
    batch_size: seeds a batch (the last one padded).
    shuffle: a fresh permutation of the seeds every epoch.
    rng: numpy Generator for shuffling (default ``default_rng(0)``, so
      the epoch order is the JAX loader's).
  """

  def __init__(self, data: Dataset, sampler: BaseSampler, input_nodes,
               batch_size: int = 512, shuffle: bool = False,
               rng: Optional[np.random.Generator] = None):
    if data.is_hetero:
      raise NotImplementedError('the port\'s loaders are homogeneous')
    self.data = data
    self.sampler = sampler
    self.seeds = as_numpy(input_nodes).astype(np.int64)
    self.batch_size = int(batch_size)
    self.shuffle = shuffle
    self.rng = rng or np.random.default_rng(0)

  def __len__(self):
    return (self.seeds.shape[0] + self.batch_size - 1) // self.batch_size

  def __iter__(self) -> Iterator[Batch]:
    order = (self.rng.permutation(self.seeds.shape[0])
             if self.shuffle else np.arange(self.seeds.shape[0]))
    n = order.shape[0]
    for lo in range(0, n, self.batch_size):
      hi = min(lo + self.batch_size, n)
      seeds, n_valid = pad_seed_batch(self.seeds[order[lo:hi]],
                                      self.batch_size)
      with record_function('sample.multihop'):
        out = self.sampler.sample_from_nodes(seeds, n_valid=n_valid)
      yield self._collate(out, seeds, n_valid)

  def _collate(self, out: SamplerOutput, seeds, n_valid) -> Batch:
    x = None
    if self.data.node_features is not None:
      with record_function('gather.features'):
        x = gather_features(self.data.get_node_feature(), out.node)
    y = None
    if self.data.node_labels is not None:
      y = torch.as_tensor(self.data.get_node_label()[seeds],
                          device=out.node.device)
    batch = to_batch(out, x=x, y=y, batch_size=self.batch_size)
    batch.metadata = dict(batch.metadata or {}, n_valid=n_valid)
    return batch
