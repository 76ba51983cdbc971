"""LRU embedding cache for the online inference engine (counterpart of
glt_tpu/serving/embedding_cache.py).

Entries are keyed by ``(node_id, model_version)`` so a parameter reload
(version bump) instantly stops serving stale vectors without an O(N)
sweep: old-version entries simply stop hitting and age out of the LRU.
``invalidate`` covers the other staleness source — feature or graph
updates for specific nodes (``invalidate(ids=...)``) and bulk flushes
(``invalidate()``).

The fleet's stale-serve read and the invalidation listeners of the
reference come with the serving front ends in a later slice.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterable, Optional

import numpy as np


class EmbeddingCache:
  """Thread-safe LRU of ``(node_id, model_version) -> np.ndarray`` rows.

  Args:
    capacity: max resident entries; 0 disables caching entirely (every
      lookup misses, inserts are dropped) — useful for benchmarking the
      uncached path.
  """

  def __init__(self, capacity: int = 100_000):
    self.capacity = int(capacity)
    self._data: 'OrderedDict[tuple, np.ndarray]' = OrderedDict()
    # live-entry count per version: keeps the id-probe set (invalidate
    # by ids probes (id, v) per live version) from growing with every
    # version ever served on a long-running server
    self._version_counts: dict = {}
    self._lock = threading.Lock()
    self.hits = 0
    self.misses = 0
    self.evictions = 0
    self.invalidations = 0

  def __len__(self) -> int:
    with self._lock:
      return len(self._data)

  def lookup(self, ids: Iterable[int], version: int) -> dict:
    """Returns {node_id: row} for the cached subset; counts a hit or
    miss per requested id (duplicates count once per occurrence, the
    traffic-weighted definition a serving hit-rate wants)."""
    out = {}
    with self._lock:
      for i in ids:
        key = (int(i), int(version))
        row = self._data.get(key)
        if row is None:
          self.misses += 1
        else:
          self._data.move_to_end(key)
          self.hits += 1
          out[int(i)] = row
    return out

  def insert(self, ids: Iterable[int], values: np.ndarray,
             version: int) -> None:
    if self.capacity <= 0:
      return
    with self._lock:
      for i, row in zip(ids, values):
        key = (int(i), int(version))
        if key not in self._data:
          self._version_counts[int(version)] = \
              self._version_counts.get(int(version), 0) + 1
        # copy: a row view into the engine's padded [bucket, D] output
        # would pin the WHOLE bucket array for as long as the entry
        # lives (bucket× memory amplification under LRU churn)
        self._data[key] = np.array(row, copy=True)
        self._data.move_to_end(key)
      while len(self._data) > self.capacity:
        (_, v), _ = self._data.popitem(last=False)
        self._drop_version_entry(v)
        self.evictions += 1

  def _drop_version_entry(self, version: int) -> None:
    n = self._version_counts.get(version, 0) - 1
    if n <= 0:
      self._version_counts.pop(version, None)
    else:
      self._version_counts[version] = n

  def invalidate(self, ids: Optional[Iterable[int]] = None,
                 version: Optional[int] = None) -> int:
    """Drop entries. ``ids`` None = all nodes; ``version`` None = all
    versions. Returns the number of entries dropped. The per-node form
    probes (id, version) keys directly — O(len(ids) x live versions),
    never a scan of the whole cache."""
    with self._lock:
      if ids is None and version is None:
        dropped = len(self._data)
        self._data.clear()
        self._version_counts.clear()
      elif ids is None:
        keys = [k for k in self._data if k[1] == int(version)]
        for k in keys:
          del self._data[k]
        self._version_counts.pop(int(version), None)
        dropped = len(keys)
      else:
        versions = ([int(version)] if version is not None
                    else list(self._version_counts))
        dropped = 0
        for i in ids:
          for v in versions:
            if self._data.pop((int(i), v), None) is not None:
              self._drop_version_entry(v)
              dropped += 1
      self.invalidations += dropped
    return dropped
