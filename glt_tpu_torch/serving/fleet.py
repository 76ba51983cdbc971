"""Sharded serving fleet: one endpoint over N shards x M replicas
(counterpart of glt_tpu/serving/fleet.py).

A single :class:`InferenceEngine` (or one :class:`ServingServer`) is a
single point of failure, and the resilience ladder (retry -> breaker ->
failover -> stale-serve) protects individual RPC peers — not a fleet.
:class:`FleetRouter` is the front door that composes those primitives
*per shard*::

        client ----> FleetRouter.infer(ids, klass)
                        |-- AdmissionController   (bounded per-class
                        |                          queues; deadline
                        |                          shed BEFORE dispatch)
                        |-- PartitionBook         (seed id -> shard)
                        |-- per shard: replica chain
                        |     r0 --breaker/health--> local engine or
                        |     r1 --breaker/health--> remote ServingServer
                        |     (walked with request_with_failover
                        |      semantics; every hop counted)
                        `-- stale tier: EmbeddingCache.lookup_stale
                              (whole replica set down; rows counted,
                               zero-fill counted, never silent)

**Resilience per shard.** Each replica gets its own
:class:`CircuitBreaker` labeled ``{shard=, replica=}`` and each shard
its own passive-first :class:`HealthMonitor` (labels ride the
``breaker_state`` / ``health_status`` series so two shards on one
shared registry never merge). The chain walk mirrors
the JAX client's ``request_with_failover``: known-DOWN replicas are skipped
(fail fast past them) unless they are the last resort — except a
rate-limited ``allow_probe`` pass-through so a restarted replica
rejoins. When every replica is skipped or failed, the router answers
from the fleet stale cache (``lookup_stale`` over every version it has
seen) or fails fast with :class:`FleetUnavailable`.

**Mutation propagation.** One :meth:`FleetRouter.apply_delta` fans out
to every shard (local shards stage into their
:class:`~glt_tpu_torch.stream.StreamIngestor`; remote replicas get the
``apply_delta`` rpc, idempotent via the req-id dedup LRU). Propagation
runs under the snapshot gate's WRITE side while requests run under its
READ side, so no request ever spans mixed snapshot versions — the
versioned consistency token (``fleet_version`` gauge,
:meth:`FleetRouter.consistency_token`) advances only after every shard
has swapped + invalidated.

**Burn-driven scaling.** The router evaluates a per-shard
:class:`~glt_tpu_torch.obs.SloBurnEvaluator` policy over the shared registry
(each shard's ``serving_latency_seconds{view=<shard>}`` series) and
publishes ``fleet_scale_signal{shard=}`` (+1 scale-up on fast burn, -1
scale-down on sustained idle, 0 otherwise); a fast-burn +1 also trips
the FlightRecorder (``fleet_scale_signal`` event) — the autoscaling
hook an operator or controller watches.

**Tracing.** A request opens one ``fleet.infer`` span; per-shard
dispatches run under ``contextvars.copy_context()`` so the rpc fabric
propagates ONE trace id from the router span through every shard's
server-side handler spans (the rpc frame's trace context).

A local replica's liveness probe is the engine's lock-free
``run_stats`` (the JAX fleet reads ``compile_stats``).
"""
from __future__ import annotations

import contextvars
import dataclasses
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..obs.recorder import SloBurnEvaluator, SloPolicy, get_recorder
from ..obs.registry import MetricsRegistry
from ..obs.trace import get_tracer
from ..partition.partition_book import PartitionBook, infer_partition_book
from ..resilience.health import HealthMonitor
from ..resilience.retry import CircuitBreaker, CircuitOpenError, RetryPolicy
from ..utils import as_numpy
from .batcher import EngineStalledError, ServingOverloaded
from .embedding_cache import EmbeddingCache
from .engine import InferenceEngine
from .metrics import ServingMetrics

logger = logging.getLogger(__name__)

#: failures that justify walking to the next replica in the chain —
#: connection-class errors (a breaker rejection IS a ConnectionError)
#: plus the engine stall watchdog. Anything else (a ValueError from id
#: validation, a handler bug) re-raises: failing over a caller bug
#: would just fail it M times.
FAILOVER_ERRORS = (ConnectionError, OSError, TimeoutError,
                   EngineStalledError)


class FleetOverloaded(ServingOverloaded):
  """Admission rejected the request BEFORE dispatch: its class queue is
  full, or its deadline lapsed while waiting for an inflight slot."""


class FleetUnavailable(ConnectionError):
  """A shard's whole replica set is down and the stale tier could not
  answer. Subclasses ConnectionError so callers' existing
  connection-failure handling applies."""


# -- admission ------------------------------------------------------------


@dataclasses.dataclass
class AdmissionClass:
  """One admission class (``interactive`` / ``batch`` / ...).

  Args:
    name: class label on the ``fleet_*`` series.
    max_inflight: concurrent dispatches for this class.
    max_queue: admitted-but-waiting bound; arrivals past
      ``max_inflight + max_queue`` are rejected immediately.
    deadline_ms: default per-request deadline (a request still waiting
      for a slot when it lapses is SHED before dispatch; the remainder
      bounds every downstream rpc/engine wait).
  """
  name: str = 'default'
  max_inflight: int = 64
  max_queue: int = 256
  deadline_ms: float = 1000.0


class AdmissionController:
  """Bounded per-class queues with deadline shedding BEFORE dispatch.

  Overload control at the door (the "overload control for scaled
  services" lever): a request that cannot possibly meet its deadline is
  cheapest to fail while it has consumed nothing but a queue slot —
  shedding it AFTER the engine forward would burn a bucket on an answer
  nobody is waiting for. Rejections (queue full) and sheds (deadline
  lapsed waiting) are separate counters: the first says "add capacity
  or shrink the class", the second "the fleet is too slow for this
  deadline".
  """

  def __init__(self, classes: Optional[Sequence[AdmissionClass]] = None,
               registry: Optional[MetricsRegistry] = None):
    classes = list(classes) if classes else [AdmissionClass()]
    self.classes: Dict[str, AdmissionClass] = {
        c.name: c for c in classes}
    self._registry = registry
    self._lock = threading.Lock()
    self._cond = threading.Condition(self._lock)
    self._inflight = {c.name: 0 for c in classes}
    self._waiting = {c.name: 0 for c in classes}

  def _count(self, metric: str, klass: str) -> None:
    if self._registry is not None:
      self._registry.inc(metric, **{'class': klass})

  def admit(self, klass: str, deadline_ts: float) -> AdmissionClass:
    """Block until an inflight slot is free; the caller MUST pair with
    :meth:`release`. Raises :class:`FleetOverloaded` on a full class
    queue or a deadline lapsing before dispatch."""
    cls = self.classes.get(klass)
    if cls is None:
      raise KeyError(f'unknown admission class {klass!r} '
                     f'(have {sorted(self.classes)})')
    with self._cond:
      if (self._waiting[cls.name] + self._inflight[cls.name]
          >= cls.max_inflight + cls.max_queue):
        self._count('fleet_rejected_total', cls.name)
        raise FleetOverloaded(
            f'admission queue full for class {cls.name!r} '
            f'({self._waiting[cls.name]} waiting + '
            f'{self._inflight[cls.name]} inflight)')
      self._waiting[cls.name] += 1
      try:
        while self._inflight[cls.name] >= cls.max_inflight:
          remaining = deadline_ts - time.monotonic()
          if remaining <= 0:
            self._count('fleet_shed_total', cls.name)
            raise FleetOverloaded(
                f'deadline lapsed before dispatch (class {cls.name!r})')
          self._cond.wait(timeout=remaining)
      finally:
        self._waiting[cls.name] -= 1
      self._inflight[cls.name] += 1
    return cls

  def release(self, klass: str) -> None:
    with self._cond:
      self._inflight[klass] -= 1
      self._cond.notify()

  def snapshot(self) -> dict:
    with self._lock:
      return {name: {'inflight': self._inflight[name],
                     'waiting': self._waiting[name],
                     'max_inflight': c.max_inflight,
                     'max_queue': c.max_queue,
                     'deadline_ms': c.deadline_ms}
              for name, c in self.classes.items()}


# -- snapshot gate --------------------------------------------------------


class _SnapshotGate:
  """Reader-writer gate for the consistency token: infers are readers,
  ``apply_delta`` the (writer-preferring) writer. Holding WRITE across
  the whole fan-out is what makes the token a real barrier: no request
  admitted during propagation can observe shard A on version v and
  shard B still on v-1. The price is a serving pause bounded by one
  compaction."""

  def __init__(self):
    self._lock = threading.Lock()
    self._cond = threading.Condition(self._lock)
    self._readers = 0
    self._writer = False
    self._writers_waiting = 0

  def read_acquire(self, timeout: Optional[float] = None) -> bool:
    deadline = None if timeout is None else time.monotonic() + timeout
    with self._cond:
      # writer preference: readers queue behind a waiting writer so a
      # steady request stream cannot starve delta propagation forever
      while self._writer or self._writers_waiting:
        remaining = None if deadline is None \
            else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
          return False
        self._cond.wait(timeout=remaining)
      self._readers += 1
      return True

  def read_release(self) -> None:
    with self._cond:
      self._readers -= 1
      if self._readers == 0:
        self._cond.notify_all()

  def write_acquire(self) -> None:
    with self._cond:
      self._writers_waiting += 1
      try:
        while self._writer or self._readers:
          self._cond.wait()
      finally:
        self._writers_waiting -= 1
      self._writer = True

  def write_release(self) -> None:
    with self._cond:
      self._writer = False
      self._cond.notify_all()


# -- scaling policy -------------------------------------------------------


@dataclasses.dataclass
class ScalePolicy:
  """Burn-signal contract for :meth:`FleetRouter.evaluate_scaling`.

  Per shard, over the window since the previous evaluation:
  ``burn >= scale_up_burn`` publishes ``fleet_scale_signal{shard=}=+1``
  and trips the FlightRecorder (fast burn: latency SLO budget burning
  ``scale_up_burn``x too fast — add a replica / split the shard);
  ``burn <= scale_down_burn`` publishes -1 (sustained headroom);
  anything else 0. Windows thinner than ``min_window`` requests always
  publish 0 — a 3-request blip must not page anyone.
  """
  threshold_s: float = 0.25
  objective: float = 0.99
  scale_up_burn: float = 6.0
  scale_down_burn: float = 0.1
  min_window: int = 20


# -- replicas -------------------------------------------------------------


class _LocalReplica:
  """In-process engine behind the same breaker contract as a remote
  peer: ``infer`` takes the breaker token, failures in
  :data:`FAILOVER_ERRORS` count toward opening it, anything else
  returns the token without counting (a caller bug is not peer
  death)."""

  kind = 'local'

  def __init__(self, name: str, engine: InferenceEngine,
               breaker: CircuitBreaker):
    self.name = name
    self.engine = engine
    self.breaker = breaker

  def infer(self, ids: np.ndarray,
            timeout_ms: Optional[float] = None) -> np.ndarray:
    if not self.breaker.allow():
      raise CircuitOpenError(
          f'replica {self.name}: circuit OPEN (fail fast)')
    try:
      out = self.engine.infer(ids)
    except FAILOVER_ERRORS:
      self.breaker.record_failure()
      raise
    except Exception:
      self.breaker.release_probe()
      raise
    self.breaker.record_success()
    return out

  def apply_delta(self, **kw) -> dict:
    raise RuntimeError(
        'local replicas receive deltas through their shard ingestor, '
        'not apply_delta')

  def close(self) -> None:
    pass


class _RemoteReplica:
  """A ServingServer endpoint over the hardened rpc fabric. The
  breaker/retry live INSIDE the RpcClient;
  ``connect_retries`` is kept small so a dead peer costs one fast
  connect failure, not a 30 s redial loop, before the chain walks on."""

  kind = 'remote'

  def __init__(self, name: str, host: str, port: int,
               breaker: CircuitBreaker,
               retry: Optional[RetryPolicy] = None,
               timeout: float = 30.0, connect_retries: int = 1,
               metrics: Optional[ServingMetrics] = None):
    from ..distributed.rpc import RpcClient
    self.name = name
    self.address = (str(host), int(port))
    self.breaker = breaker
    self._rpc = RpcClient(
        host, port, timeout=timeout,
        connect_retries=connect_retries, retry_interval=0.1,
        retry=retry or RetryPolicy(max_attempts=2, base_delay_s=0.02,
                                   max_delay_s=0.2),
        breaker=breaker,
        # apply_delta rides the req-id dedup LRU: a lost-reply retry
        # replays the recorded reply, never double-stages the cut
        idempotent=frozenset({'apply_delta'}),
        metrics=metrics)

  def infer(self, ids: np.ndarray,
            timeout_ms: Optional[float] = None) -> np.ndarray:
    rpc_timeout = (timeout_ms / 1e3 + 5.0
                   if timeout_ms is not None else None)
    return np.asarray(self._rpc.request(
        'infer', np.asarray(ids, np.int64), timeout_ms=timeout_ms,
        _rpc_timeout=rpc_timeout))

  def apply_delta(self, **kw) -> dict:
    return self._rpc.request('apply_delta', **kw)

  def close(self) -> None:
    self._rpc.close()


# -- shards ---------------------------------------------------------------


class FleetShard:
  """One shard: an ordered replica chain plus its resilience state.

  Build with :meth:`local` (in-process engines) or :meth:`remote`
  (ServingServer addresses); the :class:`FleetRouter` binds metrics,
  breakers, and the health monitor when it takes ownership — all
  labeled series are created in one place, keyed ``shard``/``replica``,
  so two shards on one registry can never merge.
  """

  def __init__(self, name: str, *, engines: Sequence = (),
               addresses: Sequence = (), manager=None,
               samplers: Optional[Sequence] = None,
               retry: Optional[RetryPolicy] = None,
               breaker_threshold: int = 3, breaker_reset_s: float = 2.0,
               rpc_timeout: float = 30.0, connect_retries: int = 1,
               probe_interval_s: float = 0.5):
    assert bool(engines) != bool(addresses), \
        'a shard is local (engines=) XOR remote (addresses=)'
    self.name = str(name)
    self._engines = list(engines)
    self._addresses = [(str(h), int(p)) for h, p in addresses]
    self._manager = manager
    self._samplers = list(samplers) if samplers is not None else [
        e.sampler for e in self._engines
        if hasattr(e.sampler, 'refresh_overlay')]
    self._retry = retry
    self._breaker_threshold = int(breaker_threshold)
    self._breaker_reset_s = float(breaker_reset_s)
    self._rpc_timeout = float(rpc_timeout)
    self._connect_retries = int(connect_retries)
    self._probe_interval_s = float(probe_interval_s)
    self._ingestor = None
    # bound by the router:
    self.replicas: List = []
    self.metrics: Optional[ServingMetrics] = None
    self.health: Optional[HealthMonitor] = None
    self.slo: Optional[SloBurnEvaluator] = None

  # -- construction -------------------------------------------------------

  @classmethod
  def local(cls, name: str, engines: Sequence[InferenceEngine],
            manager=None, samplers: Optional[Sequence] = None,
            **kw) -> 'FleetShard':
    """In-process replicas. ``manager`` (a SnapshotManager shared by
    the engines) enables ``apply_delta`` propagation; ``samplers``
    (StreamSamplers to overlay-refresh, default: each engine's own
    when it is a StreamSampler) must cover every engine or folded
    deltas stay visible in stale overlays."""
    return cls(name, engines=engines, manager=manager,
               samplers=samplers, **kw)

  @classmethod
  def remote(cls, name: str, addresses: Sequence, **kw) -> 'FleetShard':
    """Remote ServingServer replicas as ``[(host, port), ...]`` walked
    in order (first = primary)."""
    return cls(name, addresses=addresses, **kw)

  def _bind(self, registry: MetricsRegistry,
            scale_policy: ScalePolicy) -> None:
    """Router-side composition: per-replica breakers, the shard health
    monitor, the shard metrics view, and the shard burn policy — every
    series labeled with this shard's name."""
    self.metrics = ServingMetrics(registry=registry, name=self.name)
    probes = {}
    for i, eng in enumerate(self._engines):
      rname = f'r{i}'
      breaker = CircuitBreaker(
          failure_threshold=self._breaker_threshold,
          reset_timeout_s=self._breaker_reset_s,
          name=f'{self.name}/{rname}',
          labels={'shard': self.name, 'replica': rname},
          registry=registry)
      self.replicas.append(_LocalReplica(rname, eng, breaker))
        # a local replica's liveness probe is its (lock-free) stats
      # surface — it cannot hang on a wedged engine lock
      probes[rname] = (lambda e=eng: e.run_stats())
    for i, (host, port) in enumerate(self._addresses):
      rname = f'r{i}'
      breaker = CircuitBreaker(
          failure_threshold=self._breaker_threshold,
          reset_timeout_s=self._breaker_reset_s,
          name=f'{self.name}/{rname}',
          labels={'shard': self.name, 'replica': rname},
          registry=registry)
      self.replicas.append(_RemoteReplica(
          rname, host, port, breaker, retry=self._retry,
          timeout=self._rpc_timeout,
          connect_retries=self._connect_retries,
          metrics=self.metrics))
      from ..distributed.rpc import ping_endpoint
      probes[rname] = (lambda h=host, p=port:
                       ping_endpoint(h, p, timeout=2.0))
    # passive-first: the request path feeds record_failure/success; no
    # background prober thread unless the caller starts one. DOWN after
    # 2 consecutive failures — a fleet wants to stop queueing on a
    # corpse quickly; allow_probe re-admits it for recovery.
    self.health = HealthMonitor(
        probes, interval_s=self._probe_interval_s, degraded_after=1,
        down_after=2, labels={'shard': self.name}, registry=registry)
    self.slo = SloBurnEvaluator(
        [SloPolicy(name=self.name,
                   metric='serving_latency_seconds',
                   threshold_s=scale_policy.threshold_s,
                   objective=scale_policy.objective,
                   labels={'view': self.name})],
        registry=registry)

  # -- serving ------------------------------------------------------------

  def infer_failover(self, ids: np.ndarray,
                     timeout_ms: Optional[float] = None) -> np.ndarray:
    """Walk the replica chain (request_with_failover semantics): skip
    known-DOWN replicas unless last resort or a rate-limited
    probe-through; count every k>0 success as a failover. Raises the
    last :data:`FAILOVER_ERRORS` member when the whole chain fails."""
    chain = self.replicas
    last: Optional[BaseException] = None
    t0 = time.perf_counter()
    for k, rep in enumerate(chain):
      if (self.health.is_down(rep.name) and k < len(chain) - 1
          and not self.health.allow_probe(rep.name)):
        last = last or FleetUnavailable(
            f'{self.name}/{rep.name} is DOWN')
        continue
      if (self.health.is_down(rep.name) and k == len(chain) - 1
          and last is not None
          and not self.health.allow_probe(
              rep.name, min_interval_s=self._probe_interval_s)):
        # fail FAST while the whole set is down: the last resort is
        # only exercised on the rate-limited probe cadence, so a
        # dead-shard request costs a dict lookup, not a dial
        continue
      try:
        out = rep.infer(ids, timeout_ms=timeout_ms)
      except FAILOVER_ERRORS as e:
        self.health.record_failure(rep.name)
        last = e
        continue
      self.health.record_success(rep.name)
      if k > 0:
        self.metrics.record_failover()
      self.metrics.record_request(time.perf_counter() - t0,
                                  int(np.asarray(ids).size))
      return out
    raise last if last is not None else FleetUnavailable(
        f'shard {self.name} has no replicas')

  # -- mutation -----------------------------------------------------------

  @property
  def can_apply(self) -> bool:
    return self._manager is not None or bool(self._addresses)

  def apply(self, ins=None, dels=None, feat_ids=None,
            feat_rows=None) -> dict:
    """Propagate one delta to every replica of this shard; returns
    ``{'version': ..., 'invalidated': ...}``. Local: stage into the
    shared SnapshotManager once, then swap every engine onto the fresh
    snapshot. Remote: ``apply_delta`` rpc per replica (each owns its
    snapshot chain); all replicas must land on one version."""
    if self._manager is not None:
      return self._apply_local(ins, dels, feat_ids, feat_rows)
    if self._addresses:
      return self._apply_remote(ins=ins, dels=dels, feat_ids=feat_ids,
                                feat_rows=feat_rows)
    raise RuntimeError(
        f'shard {self.name} cannot apply deltas: local shard built '
        'without manager= (no stream lineage)')

  def _ingest(self):
    if self._ingestor is None:
      from ..stream.ingest import StreamIngestor
      # engine/sampler deliberately None: apply() fans the swap out to
      # EVERY engine/sampler, not just one
      self._ingestor = StreamIngestor(self._manager, auto_refresh=False)
    return self._ingestor

  def _apply_local(self, ins, dels, feat_ids, feat_rows) -> dict:
    ing = self._ingest()
    if ins is not None:
      ins = np.asarray(ins, np.int64).reshape(2, -1)
      if ins.shape[1]:
        ing.insert_edges(ins[0], ins[1])
    if dels is not None:
      dels = np.asarray(dels, np.int64).reshape(2, -1)
      if dels.shape[1]:
        ing.delete_edges(dels[0], dels[1])
    if feat_ids is not None:
      feat_ids = np.asarray(feat_ids, np.int64).reshape(-1)
      if feat_ids.size:
        ing.update_features(feat_ids, np.asarray(feat_rows))
    info = ing.flush()
    snap = self._manager.current()
    invalidated = 0
    if info is not None:
      # order per engine matches the ingestor contract: overlay drops
      # the folded ops first, cache invalidation runs strictly after
      # the feature swap
      for sampler in self._samplers:
        sampler.refresh_overlay(ing.edges)
      for eng in self._engines:
        invalidated += eng.update_snapshot(
            snap, touched_ids=info.get('touched'),
            version=info.get('version'))
    return {'version': int(snap.version), 'invalidated': invalidated,
            'compacted': info is not None}

  def _apply_remote(self, **kw) -> dict:
    versions, invalidated, last = [], 0, None
    for rep in self.replicas:
      try:
        out = rep.apply_delta(compact=True, **kw)
      except FAILOVER_ERRORS as e:
        # a dead replica misses the delta; its restart/recovery path
        # must resync before rejoining — record loudly
        self.health.record_failure(rep.name)
        logger.warning('apply_delta to %s/%s failed: %s', self.name,
                       rep.name, e)
        last = e
        continue
      self.health.record_success(rep.name)
      versions.append(int(out.get('version', -1)))
      invalidated += int(out.get('invalidated', 0))
    if not versions:
      raise last if last is not None else FleetUnavailable(
          f'shard {self.name}: no replica accepted the delta')
    if len(set(versions)) > 1:
      logger.warning('shard %s replicas diverged on snapshot version '
                     '%s', self.name, versions)
    return {'version': max(versions), 'invalidated': invalidated,
            'compacted': True, 'missed_replicas': last is not None}

  def close(self) -> None:
    if self.health is not None:
      self.health.stop()
    for rep in self.replicas:
      try:
        rep.close()
      except Exception:
        pass


# -- the router -----------------------------------------------------------


class FleetRouter:
  """One serving endpoint over partitioned/replicated shards.

  Args:
    shards: :class:`FleetShard` list; index == partition index.
    partition_book: seed id -> shard index (a
      :class:`~glt_tpu_torch.partition.partition_book.PartitionBook` or an
      array accepted by ``infer_partition_book``). Replicated fleets
      (every shard serves the full graph) still route by the book —
      it is the load-spreading function.
    admission: :class:`AdmissionController`; None builds one with a
      single permissive ``default`` class.
    registry: shared MetricsRegistry for every per-shard series +
      the fleet series; None builds a private one (tests).
    scale_policy: burn-signal thresholds (:class:`ScalePolicy`).
    stale_serve: answer from the fleet stale cache when a shard's
      whole replica chain fails (rows + zero-fills counted); off =
      fail fast with :class:`FleetUnavailable`.
    stale_capacity: fleet stale-cache entries (successful rows are
      written back on every request while ``stale_serve`` is on).
    dispatch_workers: thread pool width for multi-shard fan-out.
  """

  def __init__(self, shards: Sequence[FleetShard], partition_book,
               admission: Optional[AdmissionController] = None,
               registry: Optional[MetricsRegistry] = None,
               scale_policy: Optional[ScalePolicy] = None,
               stale_serve: bool = True,
               stale_capacity: int = 100_000,
               dispatch_workers: Optional[int] = None,
               start_health_probes: bool = False):
    assert shards, 'a fleet needs at least one shard'
    self.registry = registry if registry is not None \
        else MetricsRegistry()
    self.shards = list(shards)
    self.book: PartitionBook = infer_partition_book(partition_book)
    if self.book.num_partitions != len(self.shards):
      raise ValueError(
          f'partition book maps {self.book.num_partitions} partitions '
          f'but the fleet has {len(self.shards)} shards')
    self.scale_policy = scale_policy or ScalePolicy()
    self.admission = admission if admission is not None \
        else AdmissionController(registry=self.registry)
    if self.admission._registry is None:
      self.admission._registry = self.registry
    self.stale_serve = bool(stale_serve)
    self._stale = EmbeddingCache(stale_capacity if stale_serve else 0)
    self.metrics = ServingMetrics(registry=self.registry, name='fleet')
    self._gate = _SnapshotGate()
    self._version = 0
    self._out_dim: Optional[int] = None
    names = set()
    for shard in self.shards:
      assert shard.name not in names, f'duplicate shard {shard.name!r}'
      names.add(shard.name)
      shard._bind(self.registry, self.scale_policy)
      if start_health_probes:
        shard.health.start()
    self._pool = ThreadPoolExecutor(
        max_workers=dispatch_workers or min(16, 2 * len(self.shards)),
        thread_name_prefix='glt-fleet')
    self.registry.set('fleet_version', 0.0)

  # -- request path -------------------------------------------------------

  def infer(self, ids, klass: str = 'default',
            timeout_ms: Optional[float] = None) -> np.ndarray:
    """Embeddings for ``ids`` (any shard mix, duplicates allowed),
    aligned with the input order. One trace id covers the router span
    and every shard dispatch under it."""
    t0 = time.perf_counter()
    ids_np = as_numpy(ids).astype(np.int64).reshape(-1)
    tracer = get_tracer()
    with tracer.span('fleet.infer', ids=int(ids_np.size),
                     klass=str(klass)):
      cls = self.admission.classes.get(klass)
      deadline_ms = timeout_ms if timeout_ms is not None \
          else (cls.deadline_ms if cls else 1000.0)
      deadline_ts = time.monotonic() + deadline_ms / 1e3
      self.admission.admit(klass, deadline_ts)
      try:
        out = self._routed_infer(ids_np, deadline_ts)
      finally:
        self.admission.release(klass)
      self.metrics.record_request(time.perf_counter() - t0,
                                  int(ids_np.size))
      self.registry.inc('fleet_requests_total', **{'class': klass})
      return out

  def _routed_infer(self, ids_np: np.ndarray,
                    deadline_ts: float) -> np.ndarray:
    if ids_np.size == 0:
      return np.zeros((0, self._out_dim or 0), np.float32)
    if ids_np.min() < 0:
      raise ValueError(
          f'negative node ids: {ids_np[ids_np < 0][:8].tolist()}')
    part = self.book[ids_np]
    if part.max() >= len(self.shards):
      bad = ids_np[part >= len(self.shards)][:8]
      raise ValueError(
          f'node ids past the partition book: {bad.tolist()}')
    remaining = deadline_ts - time.monotonic()
    # the gate read waits out any in-flight delta barrier — but never
    # past this request's deadline (counted as a shed: the request
    # died BEFORE dispatch)
    if not self._gate.read_acquire(timeout=max(remaining, 0.0)):
      self.registry.inc('fleet_shed_total', **{'class': '_barrier'})
      raise FleetOverloaded(
          'deadline lapsed waiting on the snapshot barrier')
    try:
      token = self._version
      targets = np.unique(part)
      budget_ms = max((deadline_ts - time.monotonic()) * 1e3, 1.0)
      if targets.size == 1:
        rows = self._serve_shard(self.shards[int(targets[0])], ids_np,
                                 budget_ms, token)
        return np.asarray(rows)
      out: List[Optional[np.ndarray]] = [None] * targets.size
      futs = []
      for j, s in enumerate(targets.tolist()):
        sub = ids_np[part == s]
        # copy_context: the shard dispatch (and its rpc spans) must
        # inherit THIS request's trace id, not open orphan roots
        ctx = contextvars.copy_context()
        futs.append((j, s, self._pool.submit(
            ctx.run, self._serve_shard, self.shards[s], sub,
            budget_ms, token)))
      errs = []
      for j, s, fut in futs:
        try:
          out[j] = np.asarray(fut.result())
        except Exception as e:  # collected: one bad shard fails the
          errs.append(e)       # request once, not via a pool deadlock
      if errs:
        raise errs[0]
      result = np.zeros(
          (ids_np.size, out[0].shape[1]), out[0].dtype)
      for j, s in enumerate(targets.tolist()):
        result[part == s] = out[j]
      return result
    finally:
      self._gate.read_release()

  def _serve_shard(self, shard: FleetShard, sub_ids: np.ndarray,
                   budget_ms: float, token: int) -> np.ndarray:
    tracer = get_tracer()
    with tracer.span('fleet.shard', shard=shard.name,
                     ids=int(sub_ids.size)):
      try:
        rows = shard.infer_failover(sub_ids, timeout_ms=budget_ms)
      except FAILOVER_ERRORS as e:
        return self._degrade(shard, sub_ids, e)
      if self._out_dim is None:
        self._out_dim = int(rows.shape[1])
      if self.stale_serve:
        # write-back under the consistency token: lookup_stale probes
        # newest-version-first, so post-delta rows shadow pre-delta
        self._stale.insert(sub_ids, rows, token)
      return rows

  def _degrade(self, shard: FleetShard, sub_ids: np.ndarray,
               cause: BaseException) -> np.ndarray:
    """Last tier: the whole replica chain failed. Serve stale rows
    (zero-fill true misses, both counted) or fail fast."""
    self.registry.inc('fleet_unavailable_total', shard=shard.name)
    if not self.stale_serve:
      raise FleetUnavailable(
          f'shard {shard.name}: all replicas failed '
          f'({cause})') from cause
    found = self._stale.lookup_stale(sub_ids)
    dim = self._out_dim
    if dim is None and found:
      dim = int(next(iter(found.values())).shape[0])
    if dim is None:
      raise FleetUnavailable(
          f'shard {shard.name}: all replicas failed and the stale '
          f'tier is empty ({cause})') from cause
    out = np.zeros((sub_ids.size, dim), np.float32)
    mask = np.zeros(sub_ids.size, bool)
    for k, i in enumerate(sub_ids.tolist()):
      row = found.get(int(i))
      if row is not None:
        out[k] = row
        mask[k] = True
    shard.metrics.record_stale_serve(int(mask.sum()))
    shard.metrics.add_gauge('stale_zero_fills', float((~mask).sum()))
    logger.warning(
        'shard %s degraded (%s): %d/%d rows stale, %d zero-filled',
        shard.name, cause, int(mask.sum()), sub_ids.size,
        int((~mask).sum()))
    return out

  # -- mutation path ------------------------------------------------------

  def apply_delta(self, ins=None, dels=None, feat_ids=None,
                  feat_rows=None) -> dict:
    """Fan one delta out to every shard under the write side of the
    snapshot gate, then advance the fleet consistency token. Edge
    blocks are [2, n] global-id pairs; every shard receives the full
    delta (replicated shards fold it all; a partitioned deployment
    routes sub-deltas before calling this — the gate semantics are
    identical). Requests admitted during propagation wait (bounded by
    their own deadlines); requests already past the gate finish on the
    OLD version fleet-wide before the barrier engages."""
    tracer = get_tracer()
    t = time.perf_counter()
    self._gate.write_acquire()
    try:
      with tracer.span('fleet.apply_delta'):
        results = {}
        for shard in self.shards:
          if not shard.can_apply:
            continue
          results[shard.name] = shard.apply(
              ins=ins, dels=dels, feat_ids=feat_ids,
              feat_rows=feat_rows)
        if not results:
          raise RuntimeError(
              'no shard in this fleet can apply deltas (local shards '
              'need manager=, remote replicas need stream=)')
        self._version += 1
        token = self._version
        if self.stale_serve:
          # stale rows computed against the previous snapshot must not
          # shadow fresh post-delta rows; deltas carry no per-shard
          # touched sets here, so the conservative sweep drops all
          self._stale.invalidate()
    finally:
      self._gate.write_release()
    self.registry.set('fleet_version', float(token))
    get_recorder().record('fleet_delta_applied', version=token,
                          shards=sorted(results),
                          wall_ms=round((time.perf_counter() - t) * 1e3,
                                        2))
    return {'fleet_version': token, 'shards': results}

  def consistency_token(self) -> int:
    """The fleet snapshot version: requests observe one consistent
    value across every shard they touch (the gate's guarantee)."""
    self._gate.read_acquire()
    try:
      return self._version
    finally:
      self._gate.read_release()

  # -- scaling + stats ----------------------------------------------------

  def evaluate_scaling(self) -> dict:
    """Per-shard burn -> ``fleet_scale_signal{shard=}`` (+1/0/-1); a
    fast-burn +1 also trips the FlightRecorder. Call on the scrape
    cadence (the window between calls IS the burn window)."""
    pol = self.scale_policy
    out = {}
    for shard in self.shards:
      det = shard.slo.evaluate_detailed()[shard.name]
      burn, window = det['burn'], det['window']
      signal = 0
      if window >= pol.min_window:
        if burn >= pol.scale_up_burn:
          signal = 1
          get_recorder().trip(
              'fleet_scale_signal', shard=shard.name,
              burn=round(burn, 3), window=window, signal=1,
              threshold_s=pol.threshold_s)
        elif burn <= pol.scale_down_burn:
          signal = -1
      self.registry.set('fleet_scale_signal', float(signal),
                        shard=shard.name)
      out[shard.name] = {'burn': burn, 'window': window,
                         'signal': signal}
    return out

  def stats(self) -> dict:
    shard_stats = {}
    for shard in self.shards:
      shard_stats[shard.name] = {
          'metrics': shard.metrics.snapshot(),
          'health': shard.health.snapshot(),
          'breakers': {r.name: r.breaker.state for r in shard.replicas},
      }
    return {
        'fleet_version': self.consistency_token(),
        'admission': self.admission.snapshot(),
        'scaling': self.evaluate_scaling(),
        'stale_serve_enabled': self.stale_serve,
        'shards': shard_stats,
        'metrics': self.metrics.snapshot(cache=self._stale),
    }

  def close(self) -> None:
    self._pool.shutdown(wait=False)
    for shard in self.shards:
      shard.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
