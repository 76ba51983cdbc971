"""StreamIngestor: the background applier that turns buffered updates into
visible graph state (counterpart of glt_tpu/stream/ingest.py).

The write path is three stages:

  1. **stage**: ``insert_edges`` / ``delete_edges`` / ``update_features``
     append into the host delta buffers;
  2. **refresh** (with ``auto_refresh``, on every edge staging call; else
     on the background thread's poll): the pending edge set is rebuilt
     into the device overlays, so the next sample sees the inserts and
     tombstones;
  3. **compact**: the drained delta merges into a fresh snapshot (the
     base's layout), features apply, the serving cache drops the touched
     nodes and the overlay resets to the residual pending set.

Compaction fires from the policy (delta occupancy or staleness, checked
by the background thread of :meth:`StreamIngestor.start` and after every
staging call) or explicitly through :meth:`StreamIngestor.flush`. The
ingestor publishes its gauges into a shared
:class:`~glt_tpu_torch.serving.ServingMetrics`.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional

import numpy as np

from ..obs import get_tracer
from ..utils import as_numpy
from ..utils.profile import Timer
from .delta import EdgeDeltaBuffer, FeatureDeltaBuffer
from .sampler import StreamSampler
from .snapshot import SnapshotManager

logger = logging.getLogger(__name__)

RESTART_POLICIES = ('restart', 'raise', 'log')


@dataclasses.dataclass
class CompactionPolicy:
  """When the ingestor folds the delta into a fresh snapshot.

  occupancy_threshold: compact once pending ops reach this fraction of a
    delta buffer's capacity.
  max_staleness_s: compact once the oldest pending op is this old (feature
    updates are visible only after compaction, so this bounds their
    freshness); 0 disables.
  min_interval_s: least time between two policy compactions (an explicit
    ``flush`` ignores it).
  """
  occupancy_threshold: float = 0.5
  max_staleness_s: float = 30.0
  min_interval_s: float = 0.0


class StreamIngestor:
  """Owns the delta buffers and drives refresh and compaction.

  Args:
    manager: the snapshot chain.
    sampler: a StreamSampler to keep overlay-fresh, or None.
    engine: a serving InferenceEngine, or None; on compaction its
      ``update_snapshot`` swaps features and drops the touched cache
      entries.
    policy: the :class:`CompactionPolicy` (default: its defaults).
    metrics: a shared ServingMetrics, or None; the ingestor publishes its
      gauges there (``snapshot_version``, ``delta_occupancy``,
      ``feature_delta_occupancy``, ``compactions``,
      ``last_compaction_ms``, ``edge_capacity``, ``capacity_growths``,
      ``ingest_ops_total``, and ``ingest_tick_errors`` once a background
      tick fails) at construction, after every staging call and after
      every compaction.
    feature_capacity: the feature delta's capacity (default: the
      manager's ``delta_capacity``).
    auto_refresh: rebuild the overlay on every edge staging call; False
      leaves it to the background thread's poll (higher ingest
      throughput, staleness bounded by ``poll_interval_s``).
    expand_invalidation: also drop the touched ids' reverse-layout
      neighbours (``Snapshot.expand_affected``) from the cache.
    restart_policy: what a failing background tick does: ``'restart'``
      (default) logs it and keeps the applier running until
      ``max_tick_failures`` consecutive ticks failed, then declares it
      dead; ``'raise'`` declares it dead at the first failure; ``'log'``
      logs forever. A dead applier's error is raised again from the next
      ``insert_edges`` / ``delete_edges`` / ``update_features`` /
      ``flush`` / ``stop``, so no writer keeps staging into a stream that
      can no longer compact.
    max_tick_failures: the consecutive failures ``'restart'`` allows.
  """

  def __init__(self, manager: SnapshotManager,
               sampler: Optional[StreamSampler] = None, engine=None,
               policy: Optional[CompactionPolicy] = None,
               metrics=None,
               feature_capacity: Optional[int] = None,
               auto_refresh: bool = True,
               expand_invalidation: bool = False,
               restart_policy: str = 'restart',
               max_tick_failures: int = 3):
    if restart_policy not in RESTART_POLICIES:
      raise ValueError(f'restart_policy {restart_policy!r} is not one of '
                       f'{RESTART_POLICIES}')
    self.restart_policy = restart_policy
    self.max_tick_failures = int(max_tick_failures)
    self.manager = manager
    self.sampler = sampler
    self.engine = engine
    self.policy = policy or CompactionPolicy()
    self.metrics = metrics
    self.auto_refresh = auto_refresh
    self.expand_invalidation = expand_invalidation
    self.edges = EdgeDeltaBuffer(capacity=manager.delta_capacity,
                                 num_src=manager.num_src_nodes,
                                 num_dst=manager.num_dst_nodes)
    feat = manager.current().feature
    # built against the store's geometry, so a bad row fails at the
    # writer's call, not at a compaction that would restage it forever;
    # bounded by the id space, not the row count: a partition's store
    # takes global ids through its id map (ownership is checked in
    # update_features)
    self.features = FeatureDeltaBuffer(
        capacity=feature_capacity or manager.delta_capacity,
        num_nodes=feat.id_space,
        feature_dim=feat.feature_dim) if feat is not None else None
    self._compact_lock = threading.Lock()
    self._last_compaction_ts: Optional[float] = None
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None
    self._bg_error: Optional[BaseException] = None  # None: healthy
    self._tick_failures = 0      # consecutive failing ticks
    self.tick_errors_total = 0
    self._publish_gauges()

  # -- write API -----------------------------------------------------------

  def _check_bg_error(self) -> None:
    """Raise a dead background applier's error on the caller's thread:
    updates staged into a stream whose compaction loop died could never
    become visible."""
    if self._bg_error is not None:
      raise RuntimeError(
          'stream ingest background applier died '
          f'(restart_policy={self.restart_policy!r}, after '
          f'{self.tick_errors_total} tick error(s)); no further updates '
          'will compact -- fix the cause and build a new ingestor'
      ) from self._bg_error

  def insert_edges(self, src, dst) -> int:
    self._check_bg_error()
    n = self.edges.insert_edges(as_numpy(src), as_numpy(dst))
    self._after_stage(refresh=True)
    return n

  def delete_edges(self, src, dst) -> int:
    self._check_bg_error()
    n = self.edges.delete_edges(as_numpy(src), as_numpy(dst))
    self._after_stage(refresh=True)
    return n

  def update_features(self, ids, values) -> int:
    self._check_bg_error()
    if self.features is None:
      raise ValueError('this stream carries no Feature (the SnapshotManager '
                       'was built without one); feature updates have '
                       'nowhere to land')
    # range and ownership at staging time: on a partition's store an
    # unowned global id maps to no local row, and deferred to compaction
    # it would fail the merge and restage forever
    feat = self.manager.current().feature
    ids_np = as_numpy(ids).astype(np.int64).reshape(-1)
    if ids_np.size and (int(ids_np.min()) < 0
                        or int(ids_np.max()) >= feat.id_space):
      raise ValueError(f'feature id out of range [0, {feat.id_space})')
    rows = np.asarray(feat.map_ids(ids_np))
    bad = ids_np[(rows < 0) | (rows >= feat.num_rows)]
    if bad.size:
      raise ValueError(f'feature ids not owned by this store (local rows '
                       f'[0, {feat.num_rows})): {bad[:8].tolist()}')
    n = self.features.update_rows(ids_np, as_numpy(values))
    # feature rows land at compaction only (snapshot isolation): no
    # overlay refresh, but the staleness policy may fire at once
    self._after_stage(refresh=False)
    return n

  def _after_stage(self, refresh: bool) -> None:
    if refresh and self.auto_refresh and self.sampler is not None:
      self.sampler.refresh_overlay(self.edges)
    self._publish_gauges()
    self.maybe_compact()

  # -- compaction ------------------------------------------------------------

  def _due(self) -> bool:
    p = self.policy
    # an advisory debounce read: taking the compaction lock here would
    # block pollers behind a running compaction, and a stale read costs
    # at most one compaction tick early or late
    last = self._last_compaction_ts  # gltlint: disable=GLT002
    if last is not None and p.min_interval_s > 0:
      if time.monotonic() - last < p.min_interval_s:
        return False
    feat_occ = self.features.occupancy if self.features else 0.0
    if (self.edges.occupancy >= p.occupancy_threshold
        or feat_occ >= p.occupancy_threshold):
      return True
    staleness = max(self.edges.staleness_s,
                    self.features.staleness_s if self.features else 0.0)
    return p.max_staleness_s > 0 and staleness >= p.max_staleness_s

  def maybe_compact(self) -> Optional[dict]:
    """Compact iff the policy says so; returns the info dict or None."""
    if not self._due():
      return None
    return self.flush()

  def flush(self) -> Optional[dict]:
    """Compact everything pending; returns the info dict (with
    ``invalidated``, the cache entries dropped, when an engine is
    attached, and ``wall_s``) or None when nothing was pending."""
    self._check_bg_error()
    with self._compact_lock:
      if self.edges.size == 0 \
          and (self.features is None or self.features.size == 0):
        return None
      t = Timer().start()
      edge_cut = feat_cut = None
      try:
        with get_tracer().span('stream.compact', pending=self.edges.size):
          edge_cut = self.edges.drain()
          feat_cut = self.features.drain() if self.features else None
          snap, info = self.manager.compact(edge_cut, feat_cut)
      except Exception:
        # failed past a drain: put back what was drained, lose no update
        if edge_cut is not None:
          self.edges.restage(edge_cut)
        if feat_cut is not None:
          self.features.restage(feat_cut)
        raise
      # order matters: (1) the new base is live, (2) the overlay drops
      # the folded ops, (3) cache entries computed against the old
      # snapshot go last -- a request racing between (1) and (3) may
      # cache a stale row, and (3) sweeps it
      if self.sampler is not None:
        self.sampler.refresh_overlay(self.edges)
      if self.engine is not None:
        info['invalidated'] = self.engine.update_snapshot(
            snap, touched_ids=info['touched'],
            expand_in_neighbors=self.expand_invalidation,
            version=info['version'])
      self._last_compaction_ts = time.monotonic()
      info['wall_s'] = t.stop()
      if info['capacity_grown']:
        logger.info('stream: edge capacity grew to %d (snapshot v%d)',
                    info['edge_capacity'], info['version'])
      self._publish_gauges()
      return info

  # -- metrics -------------------------------------------------------------

  def _publish_gauges(self) -> None:
    if self.metrics is None:
      return
    m = self.manager
    self.metrics.set_gauge('snapshot_version', m.current().version)
    self.metrics.set_gauge('delta_occupancy', self.edges.occupancy)
    self.metrics.set_gauge(
        'feature_delta_occupancy',
        self.features.occupancy if self.features else 0.0)
    self.metrics.set_gauge('compactions', m.compactions)
    self.metrics.set_gauge('last_compaction_ms', m.last_compaction_s * 1e3)
    self.metrics.set_gauge('edge_capacity', m.edge_capacity)
    self.metrics.set_gauge('capacity_growths', m.capacity_growths)
    self.metrics.set_gauge(
        'ingest_ops_total',
        self.edges.total_inserts + self.edges.total_deletes
        + (self.features.total_updates if self.features else 0))

  def stats(self) -> dict:
    return {
        'snapshot_version': self.manager.current().version,
        'compactions': self.manager.compactions,
        'last_compaction_ms': self.manager.last_compaction_s * 1e3,
        'edge_capacity': self.manager.edge_capacity,
        'capacity_growths': self.manager.capacity_growths,
        'edge_delta': self.edges.stats(),
        'feature_delta': (self.features.stats() if self.features
                          else None),
    }

  # -- background applier ----------------------------------------------------

  def start(self, poll_interval_s: float = 0.5) -> 'StreamIngestor':
    """Runs the policy check (and, with ``auto_refresh=False``, the
    overlay refresh) every ``poll_interval_s`` on a daemon thread named
    ``glt-stream-ingest``."""
    if self._thread is not None:
      raise RuntimeError('ingestor already started')
    self._stop.clear()

    def loop():
      while not self._stop.wait(poll_interval_s):
        try:
          if not self.auto_refresh and self.sampler is not None:
            self.sampler.refresh_overlay(self.edges)
          self._publish_gauges()
          self.maybe_compact()
        except Exception as e:
          self.tick_errors_total += 1
          self._tick_failures += 1
          logger.exception(
              'stream ingest tick failed (%d consecutive, policy=%s)',
              self._tick_failures, self.restart_policy)
          if self.metrics is not None:
            self.metrics.set_gauge('ingest_tick_errors',
                                   float(self.tick_errors_total))
          if self.restart_policy == 'log':
            continue
          if (self.restart_policy == 'raise'
              or self._tick_failures >= self.max_tick_failures):
            # dead: the next staging call or stop() raises it; a
            # crash-looping applier must not drain and restage the same
            # poisoned cut forever
            self._bg_error = e
            try:  # the applier dying is the incident to keep
              from ..obs.recorder import get_recorder
              get_recorder().trip(
                  'ingestor_crash', error=repr(e),
                  tick_failures=self._tick_failures,
                  tick_errors_total=self.tick_errors_total,
                  restart_policy=self.restart_policy)
            except Exception:  # gltlint: disable=GLT006
              pass  # the recorder itself failed: nothing left to record to
            return
        else:
          self._tick_failures = 0

    self._thread = threading.Thread(target=loop, daemon=True,
                                    name='glt-stream-ingest')
    self._thread.start()
    return self

  def stop(self, raise_background_error: bool = True) -> None:
    """Stops the background thread (a join of at most 10 s) and, by
    default, raises its error if it died."""
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=10)
      self._thread = None
    if raise_background_error:
      self._check_bg_error()

  def __enter__(self):
    return self

  def __exit__(self, exc_type, exc, tb):
    # a body already raising keeps its own exception
    self.stop(raise_background_error=exc_type is None)
