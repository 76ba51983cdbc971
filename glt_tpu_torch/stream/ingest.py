"""StreamIngestor: turns buffered updates into visible graph state
(counterpart of glt_tpu/stream/ingest.py, its synchronous path).

The write path is three stages:

  1. **stage**: ``insert_edges`` / ``delete_edges`` / ``update_features``
     append into the host delta buffers;
  2. **refresh** (with ``auto_refresh``, on every edge staging call): the
     pending edge set is rebuilt into the device overlays, so the next
     sample sees the inserts and tombstones;
  3. **compact**: the drained delta merges into a fresh CSR snapshot,
     features apply, the serving cache drops the touched nodes and the
     overlay resets to the residual pending set.

Compaction fires from the policy (delta occupancy or staleness, checked
after every staging call) or explicitly through :meth:`flush`. The JAX
ingestor's background applier thread, its ``restart_policy`` and its
``ServingMetrics`` gauges are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional


from ..utils import as_numpy
from .delta import EdgeDeltaBuffer, FeatureDeltaBuffer
from .sampler import StreamSampler
from .snapshot import SnapshotManager

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CompactionPolicy:
  """When the ingestor folds the delta into a fresh snapshot.

  occupancy_threshold: compact once pending ops reach this fraction of a
    delta buffer's capacity.
  max_staleness_s: compact once the oldest pending op is this old (feature
    updates are visible only after compaction, so this bounds their
    freshness); 0 disables.
  """
  occupancy_threshold: float = 0.5
  max_staleness_s: float = 30.0


class StreamIngestor:
  """Owns the delta buffers and drives refresh and compaction.

  Args:
    manager: the snapshot chain.
    sampler: a StreamSampler to keep overlay-fresh, or None.
    engine: a serving InferenceEngine, or None; on compaction its
      ``update_snapshot`` swaps features and drops the touched cache
      entries.
    policy: the :class:`CompactionPolicy` (default: its defaults).
    auto_refresh: rebuild the overlay on every edge staging call (else
      only at compaction or on ``sampler.refresh_overlay``).
    expand_invalidation: also drop the touched ids' in-neighbours
      (``Snapshot.expand_affected``) from the cache.
  """

  def __init__(self, manager: SnapshotManager,
               sampler: Optional[StreamSampler] = None, engine=None,
               policy: Optional[CompactionPolicy] = None,
               auto_refresh: bool = True,
               expand_invalidation: bool = False):
    self.manager = manager
    self.sampler = sampler
    self.engine = engine
    self.policy = policy or CompactionPolicy()
    self.auto_refresh = auto_refresh
    self.expand_invalidation = expand_invalidation
    self.edges = EdgeDeltaBuffer(capacity=manager.delta_capacity,
                                 num_src=manager.num_src_nodes,
                                 num_dst=manager.num_dst_nodes)
    feat = manager.current().feature
    # built against the store's geometry, so a bad row fails at the
    # writer's call, not at a compaction that would restage it forever;
    # as wide as the edge delta (the JAX default feature_capacity)
    self.features = FeatureDeltaBuffer(
        capacity=manager.delta_capacity,
        num_nodes=feat.shape[0],
        feature_dim=feat.feature_dim) if feat is not None else None
    self._compact_lock = threading.Lock()

  # -- write API -----------------------------------------------------------

  def insert_edges(self, src, dst) -> int:
    n = self.edges.insert_edges(as_numpy(src), as_numpy(dst))
    self._after_stage(refresh=True)
    return n

  def delete_edges(self, src, dst) -> int:
    n = self.edges.delete_edges(as_numpy(src), as_numpy(dst))
    self._after_stage(refresh=True)
    return n

  def update_features(self, ids, values) -> int:
    if self.features is None:
      raise ValueError('this stream carries no Feature (the SnapshotManager '
                       'was built without one)')
    n = self.features.update_rows(as_numpy(ids), as_numpy(values))
    # feature rows land at compaction only (snapshot isolation): no
    # overlay refresh, but the staleness policy may fire at once
    self._after_stage(refresh=False)
    return n

  def _after_stage(self, refresh: bool) -> None:
    if refresh and self.auto_refresh and self.sampler is not None:
      self.sampler.refresh_overlay(self.edges)
    self.maybe_compact()

  # -- compaction ------------------------------------------------------------

  def _due(self) -> bool:
    p = self.policy
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
    with self._compact_lock:
      if self.edges.size == 0 \
          and (self.features is None or self.features.size == 0):
        return None
      t0 = time.perf_counter()
      edge_cut = feat_cut = None
      try:
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
      info['wall_s'] = time.perf_counter() - t0
      if info['capacity_grown']:
        logger.info('stream: edge capacity grew to %d (snapshot v%d)',
                    info['edge_capacity'], info['version'])
      return info

