"""Partition books: id -> partition maps (counterpart of
glt_tpu/partition/partition_book.py).

The books are numpy on the host. A distributed store turns one into a
dense ``[N]`` owner table on its device (:func:`dense_book`), which its
exchange reads to bucket ids by owner.
"""
from __future__ import annotations

import numpy as np

from ..utils import as_numpy


class PartitionBook:
  """Abstract id -> partition-index mapping."""

  def __getitem__(self, ids) -> np.ndarray:
    raise NotImplementedError


class RangePartitionBook(PartitionBook):
  """Partitions are consecutive id ranges; ``bounds[i]`` is the exclusive
  end of partition i."""

  def __init__(self, bounds):
    self.bounds = as_numpy(bounds).astype(np.int64)
    if np.any(np.diff(self.bounds) < 0):
      raise ValueError('partition bounds must not decrease')

  def __getitem__(self, ids) -> np.ndarray:
    ids = as_numpy(ids)
    return np.searchsorted(self.bounds, ids, side='right').astype(np.int32)

  @property
  def num_partitions(self) -> int:
    return int(self.bounds.shape[0])

  def id2index(self, ids) -> np.ndarray:
    """Global id -> index within its owner partition."""
    ids = as_numpy(ids).astype(np.int64)
    part = self[ids]
    starts = np.concatenate([[0], self.bounds[:-1]])
    return ids - starts[part]


class TablePartitionBook(PartitionBook):
  """Dense per-id table."""

  def __init__(self, table):
    self.table = as_numpy(table).astype(np.int32)

  def __getitem__(self, ids) -> np.ndarray:
    return self.table[as_numpy(ids)]

  @property
  def num_partitions(self) -> int:
    return int(self.table.max()) + 1 if self.table.size else 0


def infer_partition_book(obj) -> PartitionBook:
  if isinstance(obj, PartitionBook):
    return obj
  return TablePartitionBook(as_numpy(obj))


def dense_book(pb, num_ids: int) -> np.ndarray:
  """The owner of every id in ``[0, num_ids)``, int32 (a table shorter
  than ``num_ids`` is extended with partition 0, as
  glt_tpu/distributed/dist_graph.py ``_pb_dense`` extends it)."""
  if isinstance(pb, TablePartitionBook):
    t = pb.table
    if t.shape[0] < num_ids:
      t = np.concatenate([t, np.zeros(num_ids - t.shape[0], t.dtype)])
    return t.astype(np.int32)
  if isinstance(pb, RangePartitionBook):
    return pb[np.arange(num_ids)]
  return as_numpy(pb).astype(np.int32)
