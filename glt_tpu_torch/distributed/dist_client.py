"""The client side of the server-client mode (counterpart of
glt_tpu/distributed/dist_client.py; the reference's
distributed/dist_client.py: init_client, request_server and
async_request_server, and the ordered shutdown -- a client barrier, then
client 0 tells the servers to exit, then teardown, :57-79).

Every server connection is a hardened :class:`~glt_tpu_torch.distributed.
rpc.RpcClient` (reconnect, idempotent retry, a circuit breaker a peer), a
background :class:`~glt_tpu_torch.resilience.HealthMonitor` publishes each
server's UP/DEGRADED/DOWN, and remote feature lookups fail over to
replica servers (``set_replicas``) or degrade to the staleness cache and
zero rows, counted and logged.

Each session counts its retries, reconnects, breaker opens, failovers,
stale serves and dropouts in a :class:`~glt_tpu_torch.serving.
ServingMetrics` of its own (``fabric_stats()['metrics']``), on a private
registry or, labeled ``view="dist_client"``, on the caller's.
``collect_obs`` and ``export_fabric_trace`` assemble one Chrome trace of
the client and its servers. ``apply_delta`` posts live graph and feature
updates to one partition server, exactly once through retries.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from ..resilience import (CircuitBreaker, DegradedFeatureCache,
                          HealthMonitor, RetryPolicy)
from .dist_context import init_client_context
from .dist_server import server_port
from .rpc import RpcClient, ping_endpoint

logger = logging.getLogger(__name__)

_clients: Dict[int, RpcClient] = {}
_num_servers = 0
_client_rank = 0
_num_clients = 0
_health: Optional[HealthMonitor] = None
_metrics = None                         # this session's ServingMetrics
_replicas: Dict[int, List[int]] = {}    # server -> replica servers
_feat_cache = DegradedFeatureCache()
_dropouts: set = set()


def init_client(num_servers: int, num_clients: int, client_rank: int,
                master_addr: str = '127.0.0.1',
                master_port: int = 29500,
                rpc_timeout: float = 180.0,
                retry: Optional[RetryPolicy] = None,
                breaker_threshold: int = 5,
                breaker_reset_s: float = 5.0,
                health_interval_s: Optional[float] = 1.0,
                registry=None) -> None:
  """Connects to servers ``0..num_servers-1`` at ``master_port + rank``.
  ``health_interval_s=None`` disables the background prober (the request
  path's passive observations still apply); the other knobs set each
  server connection's retry and breaker. ``registry``: publish the
  fabric's failure counters and the breakers' series into a shared
  MetricsRegistry (e.g. ``glt_tpu_torch.obs.get_registry()``, the
  counters labeled ``view="dist_client"``) instead of a private registry
  a session, whose counters start from zero."""
  global _num_servers, _client_rank, _num_clients, _health, _metrics, \
      _feat_cache
  from ..serving.metrics import ServingMetrics
  init_client_context(num_servers, num_clients, client_rank)
  _num_servers = num_servers
  _client_rank = client_rank
  _num_clients = num_clients
  _metrics = ServingMetrics(registry=registry,
                            name='dist_client' if registry is not None
                            else '')
  _dropouts.clear()
  _replicas.clear()
  # a fresh cache a session: rows of an earlier session's dataset must
  # never be served as this session's degraded answers
  _feat_cache = DegradedFeatureCache()
  for s in range(num_servers):
    _clients[s] = RpcClient(
        master_addr, server_port(master_port, s), timeout=rpc_timeout,
        retry=retry,
        breaker=CircuitBreaker(failure_threshold=breaker_threshold,
                               reset_timeout_s=breaker_reset_s,
                               name=f'server:{s}', registry=registry),
        # apply_delta mutates but is safe to retry with a request id (the
        # server's dedup replays the recorded reply), as in the JAX client
        idempotent=frozenset({'apply_delta'}),
        metrics=_metrics)

  def probe(rank):
    # one attempt on a fresh socket (ping_endpoint): it must neither hide
    # a failure behind the retry budget nor wait on the shared client's
    # lock, which a wedged request holds for its whole recv
    addr = (master_addr, server_port(master_port, rank))
    return lambda: ping_endpoint(*addr, timeout=2.0)

  _health = HealthMonitor({s: probe(s) for s in range(num_servers)},
                          interval_s=health_interval_s or 1.0,
                          degraded_after=1, down_after=3)
  if health_interval_s is not None:
    _health.start()


def get_health() -> Optional[HealthMonitor]:
  """This client's monitor of the servers' health (None before
  :func:`init_client`)."""
  return _health


def get_metrics():
  """This client's ServingMetrics (None before :func:`init_client`)."""
  return _metrics


def set_replicas(mapping: Dict[int, List[int]]) -> None:
  """Replica servers a partition server: a failed lookup on ``rank``
  fails over, in order, to ``mapping[rank]`` (servers holding a copy of
  that partition)."""
  _replicas.clear()
  for k, v in mapping.items():
    _replicas[int(k)] = [int(r) for r in v]


def request_server(server_rank: int, method: str, *args, **kwargs):
  try:
    out = _clients[server_rank].request(method, *args, **kwargs)
  except (ConnectionError, OSError):
    if _health is not None:
      _health.record_failure(server_rank)
    raise
  if _health is not None:
    _health.record_success(server_rank)
  return out


def async_request_server(server_rank: int, method: str, *args, **kwargs):
  return _clients[server_rank].async_request(method, *args, **kwargs)


def request_with_failover(server_rank: int, method: str, *args,
                          **kwargs):
  """``request_server`` along the replica chain on connection failure.
  Known-DOWN servers are skipped unless they are the last resort, except
  for an occasional rate-limited probe (``HealthMonitor.allow_probe``),
  so a restarted primary rejoins without a background prober."""
  chain = [int(server_rank)] + _replicas.get(int(server_rank), [])
  last: Optional[BaseException] = None
  for k, rank in enumerate(chain):
    if (_health is not None and _health.is_down(rank)
        and k < len(chain) - 1
        and not _health.allow_probe(rank)):
      last = last or ConnectionError(f'server {rank} is DOWN')
      continue
    try:
      out = request_server(rank, method, *args, **kwargs)
    except (ConnectionError, OSError) as e:
      last = e
      continue
    if k > 0 and _metrics is not None:
      _metrics.record_failover()
    return out
  assert last is not None
  raise last


def get_node_feature(server_rank: int, ids, degrade: bool = True
                     ) -> torch.Tensor:
  """Remote node-feature rows (a CPU tensor) down the degradation
  ladder: the primary, its replicas (``set_replicas``), then the
  staleness cache (recently fetched rows; zero rows for true misses,
  both counted). ``degrade=False`` stops after the replicas and
  re-raises."""
  from ..channel import pack_message, unpack_message
  ids = np.asarray(ids, np.int64).reshape(-1)
  try:
    out = unpack_message(request_with_failover(
        server_rank, 'get_node_feature', pack_message({'ids': ids})))
  except (ConnectionError, OSError) as e:
    if not degrade:
      raise
    return _feat_cache.serve_counted(
        ids, _metrics, what=f'get_node_feature(server {server_rank})',
        cause=e)
  rows = out['feats']
  _feat_cache.update(ids, rows)
  return rows


def record_server_dropout(server_rank: int) -> None:
  """A consumer (a loader) gave up on this server for the epoch: health
  and metrics record it."""
  _dropouts.add(int(server_rank))
  if _health is not None:
    _health.record_failure(server_rank)
  if _metrics is not None:
    _metrics.set_gauge('server_dropouts', float(len(_dropouts)))


def fabric_stats() -> dict:
  """The client's resilience record: its metrics' snapshot (``{}``
  before ``init_client``), each server's health, the dropouts and the
  degradation cache's rows."""
  return {
      'metrics': _metrics.snapshot() if _metrics is not None else {},
      'health': _health.snapshot() if _health is not None else {},
      'dropouts': sorted(_dropouts),
      'degraded_cache_rows': len(_feat_cache),
  }


def collect_obs(server_rank: int) -> dict:
  """One server's obs buffers (finished trace spans as Chrome-event
  dicts and its registry snapshot) through the rpc fabric's built-in
  ``_obs`` callee."""
  return request_server(server_rank, '_obs')


def export_fabric_trace(path: str,
                        trace_id: Optional[str] = None) -> str:
  """Write ONE Chrome-trace/Perfetto JSON of the fabric: this client's
  spans merged with every reachable server's handler spans, which carry
  the trace ids the client propagated. ``trace_id`` keeps one trace;
  an unreachable server is skipped and counted
  (``obs_harvest_misses_total{server=}``)."""
  import json
  from ..obs import get_registry, get_tracer, merge_chrome_traces

  def keep(events):
    if trace_id is None:
      return events
    return [e for e in events if e['args'].get('trace_id') == trace_id]

  lists = [keep(get_tracer().events())]
  for s in range(_num_servers):
    try:
      lists.append(keep(collect_obs(s)['events']))
    except Exception as e:  # the harvest is best-effort
      logger.warning('obs harvest from server %d failed: %s', s, e)
      get_registry().counter('obs_harvest_misses_total',
                             server=str(s)).inc()
  with open(path, 'w') as f:
    json.dump(merge_chrome_traces(*lists), f)
  return path


def apply_delta(server_rank: int, ins=None, dels=None, feat_ids=None,
                feat_rows=None, compact: bool = False) -> dict:
  """Posts live graph and feature updates to one partition server (its
  ``DistServer.apply_delta``). ``ins`` / ``dels`` are [2, n] edge blocks
  in that partition's local ids; ``compact=True`` makes the server fold
  the delta into a fresh snapshot at once. The payload packs as the JAX
  client's does (int64 edge blocks and ids, ``compact`` a 1-element
  int8).

  Exactly once as observed: ``init_client`` marks ``apply_delta``
  idempotent on every server connection, so the request carries a request
  id and a retry after a lost reply gets the server's recorded reply; the
  delta is never staged twice."""
  from ..channel import pack_message
  msg = {}
  if ins is not None:
    msg['ins'] = np.asarray(ins, np.int64)
  if dels is not None:
    msg['dels'] = np.asarray(dels, np.int64)
  if feat_ids is not None:
    msg['feat_ids'] = np.asarray(feat_ids, np.int64)
    msg['feat_rows'] = np.asarray(feat_rows)
  if compact:
    msg['compact'] = np.ones(1, np.int8)
  return request_server(server_rank, 'apply_delta', pack_message(msg))


def barrier() -> None:
  """A barrier of the clients through server 0's built-in."""
  request_server(0, '_barrier', 'clients', _num_clients)


def shutdown_client() -> None:
  """Ordered shutdown (reference dist_client.py:57-79); a dead server
  must not wedge it, so the barrier is best-effort."""
  global _health
  if not _clients:
    return
  if _health is not None:
    _health.stop()
  try:
    barrier()
  except (ConnectionError, OSError):
    logger.warning('shutdown barrier failed (dead server?); '
                   'tearing down anyway')
  if _client_rank == 0:
    for s in range(_num_servers):
      try:
        request_server(s, 'exit')
      except Exception:
        pass
  for c in _clients.values():
    c.close()
  _clients.clear()
  _health = None
  _dropouts.clear()
