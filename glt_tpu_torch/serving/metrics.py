"""Serving observability: QPS, latency percentiles, batch fill, cache
hit-rate — a view over the obs registry (counterpart of
glt_tpu/serving/metrics.py: the same attribute names, registry series,
``snapshot()`` keys and report line).

Every counter, gauge and the latency histogram live in a
:class:`~glt_tpu_torch.obs.MetricsRegistry` (a private one by default, or
a shared one passed in), so serving, the rpc fabric and the resilience
primitives publish to ONE exposition surface. The derived readings
(``qps``, ``batch_fill_ratio``, ``report()``) all derive from one locked
cut of the registry.
"""
from __future__ import annotations

import time
from typing import Optional

# LatencyHistogram lives in the obs layer; re-exported here as the JAX
# package re-exports it
from ..obs.registry import (  # noqa: F401
    LatencyHistogram, MetricsRegistry,
)
from ..utils.profile import ThroughputMeter

#: attribute name -> registry metric name. The attribute names (and the
#: snapshot() keys derived from them) are frozen public API.
_COUNTERS = {
    'requests': 'serving_requests_total',
    'ids_served': 'serving_ids_served_total',
    'timeouts': 'serving_timeouts_total',
    'rejected': 'serving_rejected_total',
    'batches': 'serving_batches_total',
    'batched_ids': 'serving_batched_ids_total',
    'batch_capacity': 'serving_batch_capacity_total',
    # failure/degradation counters (resilience fabric): every degraded
    # answer and every recovery action is accounted here so a chaos run
    # can assert that shed + served == submitted, nothing silently lost
    'retries': 'rpc_retries_total',
    'reconnects': 'rpc_reconnects_total',
    'breaker_opens': 'rpc_breaker_opens_total',
    'shed': 'serving_shed_total',
    'stale_serves': 'serving_stale_serves_total',
    'failovers': 'rpc_failovers_total',
}

_LATENCY = 'serving_latency_seconds'


class ServingMetrics:
  """Aggregated counters shared by the batcher, engine, and server.

  All record_* methods are thread-safe (the batcher dispatcher, RPC
  handler threads, and direct callers all write concurrently).

  Args:
    registry: publish into this :class:`MetricsRegistry` instead of a
      fresh private one — pass :func:`glt_tpu_torch.obs.get_registry` to land
      these counters on the process-global exposition surface next to
      the pipeline stage timings.
    name: instance label attached to every instrument when sharing a
      registry (two ServingMetrics on one registry must not collide);
      empty = unlabeled.
  """

  def __init__(self, registry: Optional[MetricsRegistry] = None,
               name: str = ''):
    self.registry = registry if registry is not None \
        else MetricsRegistry()
    self._labels = {'view': str(name)} if name else {}
    self._c = {attr: self.registry.counter(metric, **self._labels)
               for attr, metric in _COUNTERS.items()}
    self.latency = self.registry.histogram(_LATENCY, **self._labels)
    # gauges: last-value-wins instruments for state (vs the monotonic
    # counters above) — snapshot version, delta occupancy, compaction
    # latency... The stream ingestor publishes here so serving and
    # streaming share ONE observability surface.
    self._gauge_names: set = set()
    self._t0 = time.perf_counter()

  # -- writers -----------------------------------------------------------

  def record_request(self, latency_s: float, num_ids: int = 1) -> None:
    with self.registry._lock:  # one atomic group, RLock-reentrant
      self.latency.observe(latency_s)
      self._c['requests'].inc()
      self._c['ids_served'].inc(int(num_ids))

  def record_batch(self, num_ids: int, capacity: int) -> None:
    with self.registry._lock:
      self._c['batches'].inc()
      self._c['batched_ids'].inc(int(num_ids))
      self._c['batch_capacity'].inc(int(capacity))

  def record_timeout(self) -> None:
    self._c['timeouts'].inc()

  def record_rejected(self) -> None:
    self._c['rejected'].inc()

  def record_retry(self, n: int = 1) -> None:
    self._c['retries'].inc(int(n))

  def record_reconnect(self) -> None:
    self._c['reconnects'].inc()

  def record_breaker_open(self) -> None:
    self._c['breaker_opens'].inc()

  def record_shed(self, n: int = 1) -> None:
    self._c['shed'].inc(int(n))

  def record_stale_serve(self, n: int = 1) -> None:
    self._c['stale_serves'].inc(int(n))

  def record_failover(self, n: int = 1) -> None:
    self._c['failovers'].inc(int(n))

  def set_gauge(self, name: str, value: float) -> None:
    with self.registry._lock:  # guards the name-set against snapshot()
      self._gauge_names.add(str(name))
      self.registry.set(str(name), float(value), **self._labels)

  def add_gauge(self, name: str, delta: float) -> float:
    """Atomic accumulate into a gauge (one lock hold — a
    get_gauge/set_gauge pair would tear under concurrent writers)."""
    with self.registry._lock:
      self._gauge_names.add(str(name))
      return self.registry.add(str(name), float(delta), **self._labels)

  def get_gauge(self, name: str, default: float = 0.0) -> float:
    if name not in self._gauge_names:
      return default
    return self.registry.gauge(str(name), **self._labels).value

  # -- readers -----------------------------------------------------------

  @property
  def elapsed(self) -> float:
    return time.perf_counter() - self._t0

  @property
  def qps(self) -> float:
    # ONE locked cut of exactly the fields involved; cheaper than a full
    # snapshot() for pollers
    with self.registry._lock:
      requests = self._c['requests']._value
      elapsed = self.elapsed
    return requests / max(elapsed, 1e-9)

  @property
  def batch_fill_ratio(self) -> float:
    """Mean fraction of the micro-batch capacity actually carrying
    requested ids (1.0 = every flush full)."""
    with self.registry._lock:
      ids = self._c['batched_ids']._value
      cap = self._c['batch_capacity']._value
    return ids / cap if cap else 0.0

  def snapshot(self, cache=None) -> dict:
    out, _ = self._snapshot(cache)
    return out

  def _snapshot(self, cache=None):
    """(snapshot dict, elapsed) from ONE locked cut — ``elapsed`` rides
    alongside (not as a key: the snapshot key set is frozen API) so
    ``report()`` never pairs counters with a later clock read."""
    with self.registry._lock:
      elapsed = self.elapsed
      c = {attr: int(ctr._value) for attr, ctr in self._c.items()}
      # the registry RLock is held: histogram reads re-enter it
      lat = self.latency
      out = {
          'requests': c['requests'],
          'ids_served': c['ids_served'],
          'qps': c['requests'] / max(elapsed, 1e-9),
          'latency_p50_ms': lat.percentile(50) * 1e3,
          'latency_p99_ms': lat.percentile(99) * 1e3,
          'latency_mean_ms': lat.mean * 1e3,
          'latency_max_ms': lat.max * 1e3,
          'batches': c['batches'],
          'batch_fill_ratio': (c['batched_ids'] / c['batch_capacity']
                               if c['batch_capacity'] else 0.0),
          'timeouts': c['timeouts'],
          'rejected': c['rejected'],
          # resilience counters: snapshotted under the SAME lock hold
          # as everything above — a reader can never see a torn pair
          # (e.g. a shed counted but its retry not yet) across fields
          'retries': c['retries'],
          'reconnects': c['reconnects'],
          'breaker_opens': c['breaker_opens'],
          'shed': c['shed'],
          'stale_serves': c['stale_serves'],
          'failovers': c['failovers'],
          'gauges': {
              g: self.registry.gauge(g, **self._labels)._value
              for g in sorted(self._gauge_names)
          },
      }
    if cache is not None:
      out['cache'] = cache.stats()
      out['cache_hit_rate'] = out['cache']['hit_rate']
    return out, elapsed

  def report(self, cache=None) -> str:
    """One-line human summary (ThroughputMeter formats the rate) —
    every field derives from one locked snapshot cut."""
    snap, elapsed = self._snapshot(cache)
    meter = ThroughputMeter('req')
    meter.update(snap['requests'], max(elapsed, 1e-9))
    line = (f'{meter.report()} p50={snap["latency_p50_ms"]:.2f}ms '
            f'p99={snap["latency_p99_ms"]:.2f}ms '
            f'fill={snap["batch_fill_ratio"]:.2f}')
    if cache is not None:
      line += f' cache_hit={snap["cache_hit_rate"]:.2f}'
    return line


def _make_counter_property(attr: str):
  def fget(self) -> int:
    return int(self._c[attr].value)
  fget.__name__ = attr
  fget.__doc__ = f'Read of the {_COUNTERS[attr]} counter.'
  return property(fget)


for _attr in _COUNTERS:
  setattr(ServingMetrics, _attr, _make_counter_property(_attr))
del _attr
