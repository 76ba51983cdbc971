"""Health monitoring and degradation primitives for the distributed
fabric (counterpart of glt_tpu/resilience/health.py).

:class:`HealthMonitor` runs a background probe loop over named targets
(partition servers, serving endpoints) and publishes a 3-level status:

  * UP       — last probe succeeded;
  * DEGRADED — ``degraded_after`` consecutive probe failures (the peer
    is struggling: callers should prefer replicas but may still try);
  * DOWN     — ``down_after`` consecutive failures (callers must not
    wait on this peer; fail over or degrade).

Call sites can also feed *passive* observations (``record_failure`` /
``record_success`` from the request path) so a peer that dies between
probe ticks is demoted at once rather than an interval later.

:class:`DegradedFeatureCache` is the bounded-staleness answer for remote
feature lookups when every replica of a partition is gone: recently
fetched rows are served from a host-side store and true misses
zero-fill, so an epoch completes minus one server instead of
deadlocking. Rows are CPU tensors here (numpy in the JAX package).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

UP = 'UP'
DEGRADED = 'DEGRADED'
DOWN = 'DOWN'


class HealthMonitor:
  """Background prober publishing UP/DEGRADED/DOWN per target.

  Args:
    probes: {name: callable} — a probe returns normally for healthy,
      raises for unhealthy (e.g. ``lambda: client.request('_ping')``).
    interval_s: probe cadence.
    degraded_after / down_after: consecutive-failure thresholds.
    on_change: ``fn(name, old_status, new_status)`` called outside the
      lock on every transition (metrics / logging hook).
    labels: extra series labels (e.g. ``{'shard': 'shard1'}``) riding
      every published ``health_status`` point, so two shards' monitors
      on one shared registry never merge series (target names alone
      collide: every shard calls its replicas ``r0``/``r1``).
    registry: optional MetricsRegistry; when set, every transition
      publishes a labeled ``health_status`` gauge
      (0=UP, 1=DEGRADED, 2=DOWN) per target.
  """

  def __init__(self, probes: Dict[object, Callable[[], object]],
               interval_s: float = 1.0, degraded_after: int = 1,
               down_after: int = 3,
               on_change: Optional[Callable] = None,
               labels: Optional[Dict[str, str]] = None,
               registry=None):
    assert 1 <= degraded_after <= down_after
    self.interval_s = float(interval_s)
    self.degraded_after = int(degraded_after)
    self.down_after = int(down_after)
    self.on_change = on_change
    self.labels = {str(k): str(v) for k, v in (labels or {}).items()}
    self.registry = registry
    self._probes = dict(probes)
    self._lock = threading.Lock()
    self._cond = threading.Condition(self._lock)
    self._failures = {k: 0 for k in self._probes}
    self._status = {k: UP for k in self._probes}
    self._last_probe: Dict[object, float] = {}
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None

  # -- status surface ----------------------------------------------------

  def status(self, name) -> str:
    with self._lock:
      return self._status.get(name, DOWN)

  def is_up(self, name) -> bool:
    return self.status(name) == UP

  def is_down(self, name) -> bool:
    return self.status(name) == DOWN

  def snapshot(self) -> dict:
    with self._lock:
      return dict(self._status)

  def healthy(self) -> list:
    """Targets currently not DOWN."""
    with self._lock:
      return [k for k, s in self._status.items() if s != DOWN]

  def allow_probe(self, name,
                  min_interval_s: Optional[float] = None) -> bool:
    """Admit an occasional live request through to a DOWN peer so
    passive-only deployments (no background prober running) can
    observe recovery — callers that skip DOWN peers would otherwise
    never exercise a restarted one and it would stay DOWN forever.
    Rate-limited to one admission per ``min_interval_s`` (defaults to
    the probe cadence); stamps the admission time."""
    if min_interval_s is None:
      min_interval_s = self.interval_s
    now = time.monotonic()
    with self._lock:
      if now - self._last_probe.get(name, 0.0) >= min_interval_s:
        self._last_probe[name] = now
        return True
      return False

  def wait_for(self, name, status: str, timeout_s: float = 10.0) -> bool:
    """Block until ``name`` reaches ``status`` (tests / choreography)."""
    deadline = time.monotonic() + timeout_s
    with self._cond:
      while self._status.get(name) != status:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
          return False
        self._cond.wait(timeout=remaining)
      return True

  # -- observations ------------------------------------------------------

  def _transition(self, name, failures: int) -> None:
    """Map a consecutive-failure count to a status; must hold _lock."""
    if failures >= self.down_after:
      new = DOWN
    elif failures >= self.degraded_after:
      new = DEGRADED
    else:
      new = UP
    old = self._status.get(name, UP)
    self._status[name] = new
    self._cond.notify_all()
    if new != old:
      logger.warning('health: %s %s -> %s', name, old, new)
      if self.registry is not None:
        try:  # registry has its own lock and never re-enters ours
          self.registry.set('health_status',
                            {UP: 0.0, DEGRADED: 1.0, DOWN: 2.0}[new],
                            target=str(name), **self.labels)
        except Exception:
          pass
      if self.on_change is not None:
        cb = self.on_change
        # fire outside the lock: a callback that re-enters status()
        # must not deadlock
        threading.Thread(target=cb, args=(name, old, new),
                         daemon=True).start()

  def record_failure(self, name) -> None:
    """Passive demotion from the request path (a failed rpc is as good
    an observation as a failed probe — and arrives sooner)."""
    with self._lock:
      if name not in self._failures:
        return
      self._failures[name] += 1
      self._transition(name, self._failures[name])

  def record_success(self, name) -> None:
    with self._lock:
      if name not in self._failures:
        return
      self._failures[name] = 0
      self._transition(name, 0)

  # -- probing -----------------------------------------------------------

  def check_now(self, name=None) -> dict:
    """Run probes synchronously (all targets, or one) and return the
    updated status map — the deterministic path tests drive."""
    names = [name] if name is not None else list(self._probes)
    for n in names:
      try:
        self._probes[n]()
      except Exception:
        self.record_failure(n)
      else:
        self.record_success(n)
    return self.snapshot()

  def start(self, interval_s: Optional[float] = None) -> 'HealthMonitor':
    if interval_s is not None:
      self.interval_s = float(interval_s)
    assert self._thread is None, 'monitor already started'
    self._stop.clear()

    def loop():
      while not self._stop.wait(self.interval_s):
        try:
          self.check_now()
        except Exception:  # a probe dict mutation race etc: keep going
          logger.exception('health probe sweep failed')

    self._thread = threading.Thread(target=loop, daemon=True,
                                    name='glt-health')
    self._thread.start()
    return self

  def stop(self) -> None:
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=5)
      self._thread = None

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.stop()


class DegradedFeatureCache:
  """Bounded store of node id -> feature row, fed by successful remote
  fetches and consulted only when a partition has NO live replica.

  ``serve`` zero-fills true misses and reports how many rows were
  cached vs zero-filled, so metrics can account for every degraded
  lookup (the bounded-staleness contract: stale-but-real rows beat a
  deadlocked epoch; zeros are the documented last resort and are
  COUNTED, never silent).
  """

  def __init__(self, capacity: int = 200_000):
    self.capacity = int(capacity)
    self._rows: 'dict[int, torch.Tensor]' = {}
    self._lock = threading.Lock()
    self.feature_dim: Optional[int] = None
    self.dtype = torch.float32

  def __len__(self) -> int:
    with self._lock:
      return len(self._rows)

  def update(self, ids, rows) -> None:
    """Keeps ``rows [n, D]`` (a tensor on any device, or numpy) of
    ``ids [n]``; past ``capacity`` the oldest inserted rows go."""
    if self.capacity <= 0:
      return
    ids = torch.as_tensor(np.asarray(ids) if not isinstance(
        ids, torch.Tensor) else ids).reshape(-1).tolist()
    rows = (rows.detach().cpu() if isinstance(rows, torch.Tensor)
            else torch.as_tensor(np.asarray(rows)))
    with self._lock:
      self.feature_dim = int(rows.shape[1])
      self.dtype = rows.dtype
      for i, row in zip(ids, rows):
        self._rows[int(i)] = row.clone()
      if len(self._rows) > self.capacity:
        # a wholesale trim (this cache is a disaster fallback, not a hot
        # path): drop the oldest inserted overflow
        drop = len(self._rows) - self.capacity
        for k in list(self._rows)[:drop]:
          del self._rows[k]

  def serve_counted(self, ids, metrics=None, what: str = 'lookup',
                    cause: Optional[BaseException] = None) -> torch.Tensor:
    """``serve`` plus the bookkeeping every degradation tier shares —
    stale-serve / zero-fill counters (when ``metrics`` is given) and the
    mandatory (never silent) warning."""
    rows, cached = self.serve(ids)
    n = int(cached.numel())
    hit = int(cached.sum())
    if metrics is not None:
      metrics.record_stale_serve(hit)
      metrics.add_gauge('degraded_zero_fills', float(n - hit))
    logger.warning(
        '%s degraded (%s): %d/%d rows from the staleness cache, '
        '%d zero-filled', what, cause, hit, n, n - hit)
    return rows

  def serve(self, ids, feature_dim: Optional[int] = None):
    """Returns (rows [n, D], cached_mask [n]), CPU tensors, zero rows
    where missed."""
    ids = (ids.reshape(-1).tolist() if isinstance(ids, torch.Tensor)
           else np.asarray(ids).reshape(-1).tolist())
    with self._lock:
      dim = feature_dim or self.feature_dim
      if dim is None:
        raise RuntimeError(
            'degraded feature serve before any successful fetch: the '
            'row width is unknown (no cached rows to serve either)')
      out = torch.zeros((len(ids), int(dim)), dtype=self.dtype)
      mask = torch.zeros(len(ids), dtype=torch.bool)
      for k, i in enumerate(ids):
        row = self._rows.get(int(i))
        if row is not None:
          out[k] = row
          mask[k] = True
    return out, mask
