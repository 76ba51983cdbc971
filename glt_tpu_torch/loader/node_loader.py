"""NodeLoader: seed iteration + sampling + feature collation (counterpart
of glt_tpu/loader/node_loader.py).

The host only shuffles and pads seed ids (numpy); sampling, dedup and the
feature gather run on the sampler's device. The last ragged batch is
padded to the batch size, ``metadata['n_valid']`` counting its real
seeds, or dropped with ``drop_last``. ``prefetch_depth`` > 0 makes the
next batches on a worker thread (``utils.prefetch``) while the caller
works on the current one; by default a loader prefetches 2 batches where
a feature store has a host phase (spilled rows with
``host_offload=False``) and none otherwise, as the JAX loader does.
Sampling and the feature gather carry ``torch.profiler`` ranges named as
the serving engine's stages (``sample.multihop``, ``gather.features``).
"""
from __future__ import annotations

from typing import Iterator, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from ..data import Dataset
from ..data.feature import gather_features
from ..sampler import (BaseSampler, HeteroSamplerOutput, NodeSamplerInput,
                       SamplerOutput)
from ..utils import as_numpy
from ..utils.prefetch import prefetch
from .device_epoch import pad_seed_batch
from .transform import Batch, HeteroBatch, to_batch, to_hetero_batch


class NodeLoader:
  """Iterates seed-node batches through a sampler.

  Args:
    data: the Dataset (graph + features + labels).
    sampler: the sampler (NeighborLoader builds a NeighborSampler).
    input_nodes: seed ids, or ``(node_type, ids)`` over a hetero dataset.
    batch_size: seeds a batch (the last one padded).
    shuffle: a fresh permutation of the seeds every epoch.
    drop_last: skip the last batch when it is ragged.
    collect_features: gather the nodes' feature rows into the batch.
    prefetch_depth: batches made ahead on a worker thread (None: 2 where
      a feature store has a host phase, else 0).
    rng: numpy Generator for shuffling (default ``default_rng(0)``, so
      the epoch order is the JAX loader's).
  """

  def __init__(self, data: Dataset, sampler: BaseSampler, input_nodes,
               batch_size: int = 512, shuffle: bool = False,
               drop_last: bool = False, collect_features: bool = True,
               prefetch_depth: Optional[int] = None,
               rng: Optional[np.random.Generator] = None):
    self.data = data
    self.sampler = sampler
    if isinstance(input_nodes, tuple) and isinstance(input_nodes[0], str):
      self.input_type, seeds = input_nodes
    else:
      self.input_type, seeds = None, input_nodes
    self.seeds = as_numpy(seeds).astype(np.int64)
    self.batch_size = int(batch_size)
    self.shuffle = shuffle
    self.drop_last = drop_last
    self.collect_features = collect_features
    if prefetch_depth is None:
      prefetch_depth = 2 if collect_features and _has_host_phase(data) else 0
    self.prefetch_depth = int(prefetch_depth)
    #: the last epoch's PrefetchIterator (None without prefetching)
    self._prefetcher = None
    self.rng = rng or np.random.default_rng(0)

  def __len__(self):
    n = self.seeds.shape[0]
    if self.drop_last:
      return n // self.batch_size
    return (n + self.batch_size - 1) // self.batch_size

  def __iter__(self) -> Iterator[Union[Batch, HeteroBatch]]:
    if self.prefetch_depth > 0:
      self._prefetcher = prefetch(self._epoch_iter(), self.prefetch_depth)
      return iter(self._prefetcher)
    return self._epoch_iter()

  def _epoch_iter(self) -> Iterator[Union[Batch, HeteroBatch]]:
    order = (self.rng.permutation(self.seeds.shape[0])
             if self.shuffle else np.arange(self.seeds.shape[0]))
    n = order.shape[0]
    for lo in range(0, n, self.batch_size):
      hi = min(lo + self.batch_size, n)
      if hi - lo < self.batch_size and self.drop_last:
        break
      seeds, n_valid = pad_seed_batch(self.seeds[order[lo:hi]],
                                      self.batch_size)
      yield self._make_batch(seeds, n_valid)

  def _make_batch(self, seeds: np.ndarray, n_valid: int
                  ) -> Union[Batch, HeteroBatch]:
    """One batch from ``seeds`` (padded to the batch size) of which the
    first ``n_valid`` are real: sample, then collate."""
    inputs = (seeds if self.input_type is None
              else NodeSamplerInput(seeds, self.input_type))
    with record_function('sample.multihop'):
      out = self.sampler.sample_from_nodes(inputs, n_valid=n_valid)
    return self._collate(out, seeds, n_valid)

  def _collate(self, out: Union[SamplerOutput, HeteroSamplerOutput], seeds,
               n_valid) -> Union[Batch, HeteroBatch]:
    if isinstance(out, HeteroSamplerOutput):
      return self._collate_hetero(out, seeds, n_valid)
    x = None
    if self.collect_features and self.data.node_features is not None:
      with record_function('gather.features'):
        x = gather_features(self.data.get_node_feature(), out.node)
    y = None
    if self.data.node_labels is not None:
      y = torch.as_tensor(self.data.get_node_label()[seeds],
                          device=out.node.device)
    batch = to_batch(out, x=x, y=y, batch_size=self.batch_size)
    batch.metadata = dict(batch.metadata or {}, n_valid=n_valid)
    return batch

  def _collate_hetero(self, out: HeteroSamplerOutput, seeds,
                      n_valid) -> HeteroBatch:
    """Per node type with a feature table, its rows (one ``gather_rows``
    launch a type); the seed type's labels, when the dataset has them."""
    x_dict = {}
    feats = self.data.node_features
    if self.collect_features and isinstance(feats, dict):
      with record_function('gather.features'):
        x_dict = {t: gather_features(feats[t], node)
                  for t, node in out.node.items() if t in feats}
    y_dict = None
    labels = self.data.node_labels
    if isinstance(labels, dict) and self.input_type in labels:
      dev = out.node[self.input_type].device
      y_dict = {self.input_type: torch.as_tensor(
          labels[self.input_type][seeds], device=dev)}
    batch = to_hetero_batch(out, x_dict=x_dict, y_dict=y_dict,
                            batch_size=self.batch_size)
    batch.metadata['n_valid'] = n_valid
    return batch


def _has_host_phase(data: Dataset) -> bool:
  """True when a node or edge feature store of ``data`` gathers its cold
  rows in a host phase (spilled, ``host_offload=False``): per batch host
  work a prefetch thread can hide (glt_tpu/loader/node_loader.py:73-99).
  A pinned cold block is read inside the gather's one launch."""
  stores = []
  for feats in (data.node_features, data.edge_features):
    if isinstance(feats, dict):
      stores.extend(feats.values())
    elif feats is not None:
      stores.append(feats)
  return any(not f.fully_device_resident and f.cold_array is None
             for f in stores)
