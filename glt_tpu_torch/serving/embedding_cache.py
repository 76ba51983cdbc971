"""LRU embedding cache for the online inference engine (counterpart of
glt_tpu/serving/embedding_cache.py).

Entries are keyed by ``(node_id, model_version)`` so a parameter reload
(version bump) instantly stops serving stale vectors without an O(N)
sweep: old-version entries simply stop hitting and age out of the LRU.
Explicit invalidation hooks cover the other staleness source — feature
or graph updates for specific nodes (``invalidate(ids=...)``) and bulk
flushes (``invalidate()``); registered listeners let callers fan the
event out (e.g. to replicas or metrics).

Rows are host numpy arrays: the engine copies a bucket's logits off the
card once, and every hit, stale read and fleet write-back is host work.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Iterable, List, Optional

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
    self._listeners: List[Callable] = []
    self.hits = 0
    self.misses = 0
    self.evictions = 0
    self.invalidations = 0

  def __len__(self) -> int:
    with self._lock:
      return len(self._data)

  @property
  def hit_rate(self) -> float:
    # both counters under the lock: read unlocked against a concurrent
    # lookup() they could pair a new `hits` with a stale `misses` (or
    # vice versa) — a torn, even >1.0, ratio
    with self._lock:
      hits, misses = self.hits, self.misses
    total = hits + misses
    return hits / total if total else 0.0

  # -- lookup / insert ---------------------------------------------------

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

  def lookup_stale(self, ids: Iterable[int]) -> dict:
    """Degraded-mode read: {node_id: row} probing EVERY live version,
    newest first — the stale-serve tier answers from whatever the cache
    still holds while the engine circuit is open. Counts neither hits
    nor misses (a disaster-mode read must not skew the steady-state
    hit-rate the capacity tuning watches) and does not touch LRU order
    (stale reads must not keep stale entries artificially hot)."""
    out = {}
    with self._lock:
      versions = sorted(self._version_counts, reverse=True)
      for i in ids:
        for v in versions:
          row = self._data.get((int(i), v))
          if row is not None:
            out[int(i)] = row
            break
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

  # -- invalidation hooks ------------------------------------------------

  def add_invalidation_listener(self, fn: Callable) -> None:
    """``fn(ids, version)`` is called after every invalidate (ids may
    be None for a bulk flush). Listeners run synchronously inside the
    caller's invalidation path — when that caller is the engine (whose
    ``invalidate`` holds the non-reentrant engine lock), a listener
    must NOT call back into the same engine; hand off to another
    thread for cascading invalidations."""
    self._listeners.append(fn)

  def invalidate(self, ids: Optional[Iterable[int]] = None,
                 version: Optional[int] = None) -> int:
    """Drop entries. ``ids`` None = all nodes; ``version`` None = all
    versions. Returns the number of entries dropped. The per-node form
    probes (id, version) keys directly — O(len(ids) x live versions),
    never a scan of the whole cache (feature-update hooks fire this on
    the serving path)."""
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
    for fn in self._listeners:
      fn(ids, version)
    return dropped

  def reset_stats(self) -> None:
    with self._lock:
      self.hits = self.misses = self.evictions = self.invalidations = 0

  def stats(self) -> dict:
    with self._lock:
      total = self.hits + self.misses
      return {
          'size': len(self._data), 'capacity': self.capacity,
          'hits': self.hits, 'misses': self.misses,
          # computed from the counters already under THIS lock hold —
          # self.hit_rate would deadlock (non-reentrant lock) and a
          # re-read could tear against a concurrent lookup()
          'hit_rate': self.hits / total if total else 0.0,
          'evictions': self.evictions,
          'invalidations': self.invalidations,
      }
