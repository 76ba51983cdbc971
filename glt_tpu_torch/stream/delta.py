"""Host-side staging buffers for live graph and feature updates
(counterpart of glt_tpu/stream/delta.py; numpy and threading, the port's
own copy).

Writers append into these thread-safe, capacity-bounded buffers; the
sampling path never reads them directly -- the :class:`~glt_tpu_torch.
stream.snapshot.SnapshotManager` turns the pending set into small device
overlays (bounded staleness), and compaction folds it into a fresh CSR.

Effective adjacency is ``(base \\ tombstones) ∪ inserts`` -- deletes
apply to the base *before* inserts are appended, in the overlay merge
(ops/delta.py) and at compaction alike. That rule plus one staging-time
cancellation resolves op ordering:

  * ``delete_edges`` cancels matching *pending inserts* in place (an
    edge inserted and deleted inside one delta epoch never existed) and
    records a tombstone for the base graph -- required, because
    tombstones only ever filter the base;
  * ``insert_edges`` just appends. A pending tombstone plus a later
    insert of the same pair coexist deliberately: the tombstone clears
    every base instance, the insert contributes exactly one fresh one --
    correct whether or not the base ever held the edge.

Deletes are multigraph-wide: a tombstone (u, v) removes **every**
base instance of u->v.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional

import numpy as np

from ..utils import as_numpy


class DeltaOverflow(RuntimeError):
  """The delta buffer is full: compact (or raise capacity) before
  staging more updates. Raised instead of silently dropping — a lost
  update would silently serve stale neighborhoods forever."""


class EdgeDeltaCut(NamedTuple):
  """An atomically drained batch of pending edge ops (compaction input)."""
  ins_src: np.ndarray
  ins_dst: np.ndarray
  del_src: np.ndarray
  del_dst: np.ndarray

  @property
  def num_ops(self) -> int:
    return int(self.ins_src.shape[0] + self.del_src.shape[0])


class FeatureDeltaCut(NamedTuple):
  """Drained feature-row updates: ``ids`` unique, last-write-wins."""
  ids: np.ndarray
  values: np.ndarray

  @property
  def num_ops(self) -> int:
    return int(self.ids.shape[0])


def _pair_key(src: np.ndarray, dst: np.ndarray,
              num_cols: int) -> np.ndarray:
  """Dense (src, dst) -> int64 key for set matching. Safe while
  num_rows * num_cols < 2**63 — beyond that shard the stream per
  partition (the distributed apply-delta path)."""
  return src.astype(np.int64) * np.int64(max(num_cols, 1)) \
      + dst.astype(np.int64)


class EdgeDeltaBuffer:
  """Thread-safe, capacity-bounded staging of edge inserts + deletes.

  Args:
    capacity: max pending ops (inserts + tombstones together). This is
      also the static width of the device overlays built from the
      buffer, so it is a **compile-shape** constant — pick it once.
    num_nodes: id-space bound for square graphs; out-of-range endpoints
      are rejected at staging time (past this boundary they would be
      silently dropped by the CSR scatters, a wrong-but-quiet outcome).
    num_src/num_dst: independent per-axis bounds for bipartite
      topologies (src checked against num_src, dst against num_dst);
      default to ``num_nodes``.
  """

  def __init__(self, capacity: int = 4096,
               num_nodes: Optional[int] = None,
               num_src: Optional[int] = None,
               num_dst: Optional[int] = None):
    assert capacity > 0
    self.capacity = int(capacity)
    self.num_nodes = None if num_nodes is None else int(num_nodes)
    self.num_src = int(num_src) if num_src is not None \
        else self.num_nodes
    self.num_dst = int(num_dst) if num_dst is not None \
        else self.num_nodes
    #: bumped on every successful stage/drain/restage — overlay builds
    #: key on it to skip rebuilding an unchanged pending set
    self.mutation_seq = 0
    self._lock = threading.Lock()
    self._ins_src: list = []
    self._ins_dst: list = []
    self._del_src: list = []
    self._del_dst: list = []
    self._oldest_ts: Optional[float] = None
    self.total_inserts = 0
    self.total_deletes = 0
    self.high_watermark = 0.0

  # -- staging -----------------------------------------------------------

  def _check_ids(self, src: np.ndarray, dst: np.ndarray) -> None:
    if src.size == 0:
      return
    for name, ids, bound in (('src', src, self.num_src),
                             ('dst', dst, self.num_dst)):
      if bound is None:
        continue
      lo, hi = int(ids.min()), int(ids.max())
      if lo < 0 or hi >= bound:
        raise ValueError(
            f'{name} endpoint out of range [0, {bound}): '
            f'saw [{lo}, {hi}]')

  def _note_occupancy_locked(self) -> None:
    occ = self._size_locked() / self.capacity
    if occ > self.high_watermark:
      self.high_watermark = occ
    if self._oldest_ts is None and self._size_locked():
      self._oldest_ts = time.monotonic()

  def _size_locked(self) -> int:
    return (len(self._ins_src) + len(self._del_src))

  def insert_edges(self, src, dst) -> int:
    """Stage new edge instances; returns the number staged. A pending
    tombstone for the same pair is deliberately left in place (see the
    module docstring): it clears the base instances, this insert
    contributes the fresh one — cancelling it instead would silently
    lose the insert whenever the base never held the edge."""
    src = as_numpy(src).astype(np.int64).reshape(-1)
    dst = as_numpy(dst).astype(np.int64).reshape(-1)
    assert src.shape == dst.shape
    self._check_ids(src, dst)
    with self._lock:
      if self._size_locked() + src.size > self.capacity:
        raise DeltaOverflow(
            f'edge delta full ({self._size_locked()}/{self.capacity} '
            f'pending, {src.size} incoming): compact first')
      self._ins_src.extend(src.tolist())
      self._ins_dst.extend(dst.tolist())
      self.total_inserts += int(src.size)
      self.mutation_seq += 1
      self._note_occupancy_locked()
      return int(src.size)

  def delete_edges(self, src, dst) -> int:
    """Stage tombstones; pending inserts matching (src, dst) are
    cancelled in place. Returns the number of tombstones recorded."""
    src = as_numpy(src).astype(np.int64).reshape(-1)
    dst = as_numpy(dst).astype(np.int64).reshape(-1)
    assert src.shape == dst.shape
    self._check_ids(src, dst)
    with self._lock:
      keep = None
      if self._ins_src:
        nc = 1 + int(max(src.max(initial=0), dst.max(initial=0),
                         max(self._ins_src), max(self._ins_dst)))
        ikeys = _pair_key(np.asarray(self._ins_src),
                          np.asarray(self._ins_dst), nc)
        dkeys = _pair_key(src, dst, nc)
        keep = ~np.isin(ikeys, dkeys)
      # admission check BEFORE any mutation (the cancellation itself
      # frees slots, so count it): a rejected call must leave the
      # pending set — and the overlay memoized on mutation_seq —
      # exactly as it found them
      cancelled = 0 if keep is None else int((~keep).sum())
      if self._size_locked() - cancelled + src.size > self.capacity:
        raise DeltaOverflow(
            f'edge delta full ({self._size_locked()}/{self.capacity} '
            f'pending, {src.size} incoming): compact first')
      if keep is not None and cancelled:
        self._ins_src = list(np.asarray(self._ins_src)[keep])
        self._ins_dst = list(np.asarray(self._ins_dst)[keep])
      self._del_src.extend(src.tolist())
      self._del_dst.extend(dst.tolist())
      self.total_deletes += int(src.size)
      self.mutation_seq += 1
      self._note_occupancy_locked()
      return int(src.size)

  # -- reading -----------------------------------------------------------

  @property
  def size(self) -> int:
    with self._lock:
      return self._size_locked()

  @property
  def occupancy(self) -> float:
    return self.size / self.capacity

  @property
  def staleness_s(self) -> float:
    """Age of the oldest pending op (0 when empty)."""
    with self._lock:
      return (time.monotonic() - self._oldest_ts
              if self._oldest_ts is not None else 0.0)

  def view(self) -> EdgeDeltaCut:
    """Copy of the pending set WITHOUT draining (overlay refresh)."""
    with self._lock:
      return EdgeDeltaCut(
          np.asarray(self._ins_src, np.int64),
          np.asarray(self._ins_dst, np.int64),
          np.asarray(self._del_src, np.int64),
          np.asarray(self._del_dst, np.int64))

  def drain(self) -> EdgeDeltaCut:
    """Atomically take the pending set and clear the buffer (the
    compaction cut). Writers keep appending for the NEXT epoch; the
    live overlay still carries the cut until it is rebuilt post-swap,
    so readers never lose visibility mid-compaction."""
    with self._lock:
      cut = EdgeDeltaCut(
          np.asarray(self._ins_src, np.int64),
          np.asarray(self._ins_dst, np.int64),
          np.asarray(self._del_src, np.int64),
          np.asarray(self._del_dst, np.int64))
      self._ins_src, self._ins_dst = [], []
      self._del_src, self._del_dst = [], []
      self._oldest_ts = None
      self.mutation_seq += 1
      return cut

  def restage(self, cut: EdgeDeltaCut) -> None:
    """Put a drained cut back (failed compaction). Prepends, so op
    ordering against post-cut appends is preserved — including the one
    ordering delete_edges normally resolves at staging time: a
    tombstone staged *while the cut was out* is ordered after the
    cut's inserts, so it cancels the matching restaged inserts here
    (otherwise the restage would resurrect a deleted edge)."""
    with self._lock:
      ins_src, ins_dst = cut.ins_src, cut.ins_dst
      if self._del_src and ins_src.size:
        nc = 1 + int(max(ins_src.max(initial=0),
                         ins_dst.max(initial=0),
                         max(self._del_src), max(self._del_dst)))
        ikeys = _pair_key(ins_src, ins_dst, nc)
        dkeys = _pair_key(np.asarray(self._del_src),
                          np.asarray(self._del_dst), nc)
        keep = ~np.isin(ikeys, dkeys)
        ins_src, ins_dst = ins_src[keep], ins_dst[keep]
      self._ins_src = ins_src.tolist() + self._ins_src
      self._ins_dst = ins_dst.tolist() + self._ins_dst
      self._del_src = cut.del_src.tolist() + self._del_src
      self._del_dst = cut.del_dst.tolist() + self._del_dst
      if cut.num_ops:
        self._oldest_ts = time.monotonic()
      self.mutation_seq += 1
      self._note_occupancy_locked()

  def stats(self) -> dict:
    with self._lock:
      return {
          'pending': self._size_locked(),
          'capacity': self.capacity,
          'occupancy': self._size_locked() / self.capacity,
          'high_watermark': self.high_watermark,
          'total_inserts': self.total_inserts,
          'total_deletes': self.total_deletes,
      }


class FeatureDeltaBuffer:
  """Thread-safe staging of feature-row updates (last-write-wins per
  node id). Row values are copied at staging time — callers may reuse
  their buffers immediately.

  ``feature_dim`` (when known) makes wrong-width rows fail HERE, at the
  writer's call site; deferred to compaction a bad row would fail the
  merge, get restaged, and fail every subsequent flush — a permanently
  wedged stream."""

  def __init__(self, capacity: int = 4096,
               num_nodes: Optional[int] = None,
               feature_dim: Optional[int] = None):
    assert capacity > 0
    self.capacity = int(capacity)
    self.num_nodes = None if num_nodes is None else int(num_nodes)
    self.feature_dim = None if feature_dim is None else int(feature_dim)
    self._lock = threading.Lock()
    self._rows: dict = {}        # id -> np row
    self._oldest_ts: Optional[float] = None
    self.total_updates = 0
    self.high_watermark = 0.0

  def update_rows(self, ids, values) -> int:
    ids = as_numpy(ids).astype(np.int64).reshape(-1)
    values = as_numpy(values)
    if values.ndim == 1:
      values = values[None, :] if ids.size == 1 \
          else values[:, None]
    if values.shape[0] != ids.shape[0]:
      raise ValueError(
          f'{ids.shape[0]} ids vs {values.shape[0]} rows')
    if self.feature_dim is not None \
        and values.shape[1] != self.feature_dim:
      raise ValueError(
          f'row width {values.shape[1]} != feature dim '
          f'{self.feature_dim}')
    if self.num_nodes is not None and ids.size:
      if int(ids.min()) < 0 or int(ids.max()) >= self.num_nodes:
        raise ValueError(
            f'feature id out of range [0, {self.num_nodes})')
    with self._lock:
      new = sum(1 for i in ids.tolist() if i not in self._rows)
      if len(self._rows) + new > self.capacity:
        raise DeltaOverflow(
            f'feature delta full ({len(self._rows)}/{self.capacity} '
            f'pending, {new} new ids): compact first')
      for i, row in zip(ids.tolist(), values):
        self._rows[i] = np.array(row, copy=True)
      self.total_updates += int(ids.size)
      occ = len(self._rows) / self.capacity
      if occ > self.high_watermark:
        self.high_watermark = occ
      if self._oldest_ts is None and self._rows:
        self._oldest_ts = time.monotonic()
      return int(ids.size)

  @property
  def size(self) -> int:
    with self._lock:
      return len(self._rows)

  @property
  def occupancy(self) -> float:
    return self.size / self.capacity

  @property
  def staleness_s(self) -> float:
    with self._lock:
      return (time.monotonic() - self._oldest_ts
              if self._oldest_ts is not None else 0.0)

  def drain(self) -> FeatureDeltaCut:
    with self._lock:
      if not self._rows:
        cut = FeatureDeltaCut(np.zeros((0,), np.int64),
                              np.zeros((0, 0), np.float32))
      else:
        ids = np.fromiter(self._rows, np.int64, len(self._rows))
        cut = FeatureDeltaCut(ids,
                              np.stack([self._rows[i]
                                        for i in ids.tolist()]))
      self._rows = {}
      self._oldest_ts = None
      return cut

  def restage(self, cut: FeatureDeltaCut) -> None:
    """Failed-compaction path: re-stage WITHOUT clobbering newer writes
    (last-write-wins means a post-cut update supersedes the cut's)."""
    with self._lock:
      for i, row in zip(cut.ids.tolist(), cut.values):
        self._rows.setdefault(i, row)
      if self._rows and self._oldest_ts is None:
        self._oldest_ts = time.monotonic()

  def stats(self) -> dict:
    with self._lock:
      return {
          'pending': len(self._rows),
          'capacity': self.capacity,
          'occupancy': len(self._rows) / self.capacity,
          'high_watermark': self.high_watermark,
          'total_updates': self.total_updates,
      }
