"""RPC front end for the inference engine (counterpart of
glt_tpu/serving/server.py).

Rides the :mod:`glt_tpu_torch.distributed.rpc` fabric, whose frames are
the JAX package's: a JAX ``ServingClient`` calls a port ``ServingServer``
and the reverse. Each client connection is served on its own thread by
RpcServer, so concurrent clients interleave in the MicroBatcher and share
micro-batches.

Registered callees:
  * ``infer(ids, timeout_ms=None)`` -> [len(ids), D] numpy
  * ``stats()``                     -> metrics + cache + engine run stats
  * ``invalidate(ids=None, version=None)`` -> entries dropped
  * ``ping()``                      -> server identity / readiness
  * ``apply_delta(...)``            -> stage + fold live updates into
    the server's stream ingestor (only when built with ``stream=``)

``stats()['engine']`` holds the engine's run counters
(``InferenceEngine.run_stats``) where the JAX server reports its
compile counters.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..distributed.rpc import RpcClient, RpcServer
from ..utils.profile import Timer
from .batcher import EngineStalledError, MicroBatcher
from .engine import InferenceEngine
from .metrics import ServingMetrics


class ServingServer:
  """Hosts an InferenceEngine behind a micro-batched RPC endpoint.

  Args:
    engine: the InferenceEngine (warmup runs here unless
      ``warmup=False``).
    host/port: bind address; port 0 picks an ephemeral port (read it
      back from ``.address``).
    max_batch_size: micro-batch id capacity; defaults to the engine's
      largest bucket (a full micro-batch exactly fills one forward).
    max_wait_ms / max_queue / request_timeout_ms: MicroBatcher knobs.
    stall_timeout_ms: engine watchdog budget (MicroBatcher) — a
      dispatch running past it opens the engine circuit and fails all
      pending futures immediately. None disables the watchdog.
    stale_serve: while the engine circuit is OPEN, answer infer
      requests from the versioned EmbeddingCache (zero-fill for
      misses, stale_serves counted) instead of failing fast — the
      opt-in availability-over-freshness tier.
    slos: latency SLO policies (:class:`glt_tpu_torch.obs.SloPolicy` list)
      evaluated on every ``stats()`` pull — each publishes a
      ``slo_burn{slo=...}`` gauge (windowed error-budget burn; the
      per-shard autoscaling/paging signal) and lands in the stats
      payload. None reads the ``GLT_OBS_SLO`` knob; policies without
      an explicit metric label default onto THIS server's
      ``serving_latency_seconds`` series.
    stream: optional :class:`glt_tpu_torch.stream.StreamIngestor` (built by
      the caller with this server's engine + sampler); registers the
      ``apply_delta`` callee so a fleet router can propagate live
      graph/feature updates to remote replicas. Callers retrying
      apply_delta MUST mark it idempotent on their RpcClient (the
      ServingClient here does) — the req-id dedup replay is what makes
      a retried mutation exactly-once-observable.
  """

  def __init__(self, engine: InferenceEngine, host: str = '127.0.0.1',
               port: int = 0, max_batch_size: Optional[int] = None,
               max_wait_ms: float = 2.0, max_queue: int = 1024,
               request_timeout_ms: Optional[float] = 1000.0,
               warmup: bool = True,
               stall_timeout_ms: Optional[float] = None,
               stale_serve: bool = False,
               registry=None, metrics_name: str = '',
               slos=None, stream=None):
    self.engine = engine
    self.stream = stream
    self.stale_serve = bool(stale_serve)
    if warmup:
      engine.warmup()
    # metrics clock starts AFTER warmup: the kernels' first launches
    # (the build, on a fresh card) must not dilute the reported QPS.
    # ``registry``: publish the serving counters into a shared
    # MetricsRegistry (e.g. glt_tpu_torch.obs.get_registry()) so one
    # exposition surface carries serving + pipeline-stage metrics;
    # ``metrics_name`` labels this server's series there — REQUIRED to
    # keep two servers on one registry from merging their counters.
    self.metrics = ServingMetrics(registry=registry, name=metrics_name)
    self.batcher = MicroBatcher(
        engine.infer,
        max_batch_size=max_batch_size or engine.buckets[-1],
        max_wait_ms=max_wait_ms, max_queue=max_queue,
        request_timeout_ms=request_timeout_ms, metrics=self.metrics,
        stall_timeout_ms=stall_timeout_ms)
    self._request_timeout_ms = request_timeout_ms
    # SLO burn: evaluated lazily on each stats() pull (the scrape/
    # health cadence IS the evaluation window) over this server's own
    # metrics registry, so per-shard burn gauges come for free when a
    # shared registry + metrics_name labels the fleet
    import dataclasses as _dc
    from ..obs.recorder import SloBurnEvaluator, parse_slo_env
    if slos is None:
      # a malformed GLT_OBS_SLO typo must degrade to no-SLO, not take
      # down serving
      try:
        slos = parse_slo_env()
      except ValueError as e:
        import logging
        logging.getLogger(__name__).warning(
            'ignoring malformed GLT_OBS_SLO: %s', e)
        slos = []
    # policies are COPIED before defaulting labels: a slos list shared
    # across servers must not have server A's view label stamped onto
    # the objects server B then evaluates
    policies = [
        _dc.replace(p, labels=(dict(p.labels) if p.labels
                               else dict(self.metrics._labels)))
        for p in slos]
    self.slo = SloBurnEvaluator(policies,
                                registry=self.metrics.registry) \
        if policies else None
    # register BEFORE start(): a pre-registered server fails unknown
    # names fast instead of stalling the connection (rpc.RpcServer)
    self.rpc = RpcServer(host=host, port=port, auto_start=False)
    self.rpc.register('infer', self.infer)
    self.rpc.register('stats', self.stats)
    self.rpc.register('invalidate', self.invalidate)
    self.rpc.register('ping', self._ping)
    self.rpc.register('apply_delta', self.apply_delta)
    self.rpc.start()

  @property
  def address(self):
    return (self.rpc.host, self.rpc.port)

  # -- callees (also the in-process API) ---------------------------------

  def infer(self, ids, timeout_ms: Optional[float] = None) -> np.ndarray:
    from ..obs import get_tracer
    tracer = get_tracer()
    if not tracer.enabled:  # span kwargs would pay an asarray per call
      return self._infer(ids, timeout_ms)
    with tracer.span('serve.infer', ids=int(np.asarray(ids).size)):
      return self._infer(ids, timeout_ms)

  def _infer(self, ids, timeout_ms: Optional[float] = None) -> np.ndarray:
    t = Timer().start()
    # validate BEFORE batching: a bad id raised inside the dispatcher
    # would fail every co-batched request, not just this caller's
    self.engine.validate_ids(np.asarray(ids, dtype=np.int64).reshape(-1))
    try:
      fut = self.batcher.submit(ids, timeout_ms=timeout_ms)
      # the batcher enforces the queue deadline (and the engine
      # watchdog the dispatch); the extra slack here only guards
      # against a wedged dispatcher with the watchdog disabled
      wait = timeout_ms if timeout_ms is not None \
          else self._request_timeout_ms
      out = fut.result(timeout=None if wait is None else wait / 1e3 + 60)
    except EngineStalledError:
      # engine circuit OPEN: degrade to the cache tier if opted in —
      # availability over freshness, every such answer counted
      if not self.stale_serve:
        raise
      out = self._stale_infer(ids)
    self.metrics.record_request(t.stop(), np.asarray(ids).size)
    return out

  def _stale_infer(self, ids) -> np.ndarray:
    rows, cached = self.engine.stale_serve(ids)
    self.metrics.record_stale_serve(int(cached.sum()))
    self.metrics.add_gauge('stale_zero_fills', float((~cached).sum()))
    return rows

  def stats(self) -> dict:
    out = self.metrics.snapshot(cache=self.engine.cache)
    out['engine'] = self.engine.run_stats()
    out['stalled'] = self.batcher.stalled
    out['stale_serve_enabled'] = self.stale_serve
    if self.slo is not None:
      out['slo_burn'] = {k: round(v, 4)
                         for k, v in self.slo.evaluate().items()}
    return out

  def invalidate(self, ids=None, version=None) -> int:
    # through the engine: serialized against in-flight infer
    return self.engine.invalidate(ids=ids, version=version)

  def apply_delta(self, ins=None, dels=None, feat_ids=None,
                  feat_rows=None, compact: bool = True) -> dict:
    """Stage live updates into this replica's stream ingestor and (by
    default) fold them immediately: compaction -> RCU snapshot swap ->
    engine ``update_snapshot`` cache invalidation, returning the
    snapshot version now being served — the consistency token the
    fleet router compares across shards. ``ins``/``dels`` are [2, n]
    edge blocks in this server's id space."""
    if self.stream is None:
      raise RuntimeError(
          'this server has no stream ingestor: build the ServingServer '
          'with stream= (a StreamIngestor over its engine) to accept '
          'apply_delta')
    staged = 0
    if ins is not None:
      ins = np.asarray(ins, np.int64).reshape(2, -1)
      if ins.shape[1]:
        staged += self.stream.insert_edges(ins[0], ins[1])
    if dels is not None:
      dels = np.asarray(dels, np.int64).reshape(2, -1)
      if dels.shape[1]:
        staged += self.stream.delete_edges(dels[0], dels[1])
    if feat_ids is not None:
      feat_ids = np.asarray(feat_ids, np.int64).reshape(-1)
      if feat_ids.size:
        staged += self.stream.update_features(
            feat_ids, np.asarray(feat_rows))
    info = self.stream.flush() if compact \
        else self.stream.maybe_compact()
    return {'staged': int(staged),
            'compacted': info is not None,
            'invalidated': int(info.get('invalidated', 0)) if info
            else 0,
            'version': int(self.engine.snapshot_version)}

  def _ping(self) -> dict:
    return {'ok': True, 'buckets': list(self.engine.buckets),
            'output_dim': self.engine.output_dim,
            'model_version': self.engine.model_version,
            'snapshot_version': self.engine.snapshot_version}

  def close(self) -> None:
    self.batcher.stop()
    self.rpc.stop()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


class ServingClient:
  """Thin client over the rpc fabric's RpcClient."""

  def __init__(self, host: str, port: int, timeout: float = 180.0):
    # apply_delta is mutating-but-dedupable: with the request id
    # attached, a lost-reply retry replays the server's recorded reply
    # instead of staging the delta twice (rpc.IDEMPOTENT_CALLEES)
    self._rpc = RpcClient(host, port, timeout=timeout,
                          idempotent=frozenset({'apply_delta'}))

  def infer(self, ids, timeout_ms: Optional[float] = None) -> np.ndarray:
    # the client-supplied deadline ALSO bounds the rpc wait (plus small
    # slack for the wire): a wedged server cannot hold this caller past
    # its own deadline — the client times out, reconnects, and the
    # request-id dedup makes the retry safe
    rpc_timeout = (timeout_ms / 1e3 + 5.0
                   if timeout_ms is not None else None)
    return np.asarray(self._rpc.request(
        'infer', np.asarray(ids, dtype=np.int64),
        timeout_ms=timeout_ms, _rpc_timeout=rpc_timeout))

  def infer_async(self, ids, timeout_ms: Optional[float] = None):
    # same deadline contract as the sync path: the future must resolve
    # within the caller's budget even against a wedged server
    rpc_timeout = (timeout_ms / 1e3 + 5.0
                   if timeout_ms is not None else None)
    return self._rpc.async_request(
        'infer', np.asarray(ids, dtype=np.int64),
        timeout_ms=timeout_ms, _rpc_timeout=rpc_timeout)

  def stats(self) -> dict:
    return self._rpc.request('stats')

  def invalidate(self, ids=None, version=None) -> int:
    return self._rpc.request('invalidate', ids=ids, version=version)

  def apply_delta(self, ins=None, dels=None, feat_ids=None,
                  feat_rows=None, compact: bool = True) -> dict:
    return self._rpc.request(
        'apply_delta', ins=ins, dels=dels, feat_ids=feat_ids,
        feat_rows=feat_rows, compact=compact)

  def ping(self) -> dict:
    return self._rpc.request('ping')

  def close(self) -> None:
    self._rpc.close()
