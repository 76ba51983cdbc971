"""A small socket rpc fabric for the server-client mode (counterpart of
glt_tpu/distributed/rpc.py; the reference's distributed/rpc.py over
torch.distributed.rpc: a callee registry, role-scoped all_gather and
barrier, request wrappers).

The frames are the JAX package's, so an endpoint of either package
serves a client of the other: an 8-byte little-endian length, then a
pickled ``(name, args, kwargs[, req_id[, trace_ctx]])`` request or
``('ok' | 'err', payload)`` reply. Batches travel as packed SampleMessage
bytes (``channel.pack_message``), not pickled tensors.

Unlike the JAX package a frame is received into one buffer of its full
size (``recv_into``; JAX grows ``buf += chunk``, quadratic in a 0.4 GB
batch) and its length and body are sent by one ``sendmsg`` without
joining them (the bytes on the wire are the same). Sockets set
``TCP_NODELAY``.

Tracing (``glt_tpu_torch.obs``): with the tracer on, a request runs in an
``rpc.client:<name>`` span whose (trace_id, span_id) rides the frame's 5th
element, and the server reopens it around the handler as
``rpc.server:<name>``, so the two processes' spans share one trace id,
across the two packages too. A 5th element that is not a pair is
answered as an untraced request. Every endpoint answers the built-in
``_obs`` callee with its finished spans and its registry snapshot.
"""
from __future__ import annotations

import itertools
import os
import pickle
import socket
import struct
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, FrozenSet, List, Optional

from ..obs.trace import SpanContext, get_tracer
from ..resilience.retry import (
    CircuitBreaker, CircuitOpenError, RetryPolicy,
)

_HDR = struct.Struct('<Q')

#: Callees safe to retry after a lost reply (read-only, or — like
#: fetch_one_sampled_message — made retry-safe by the server's
#: request-id dedup cache, which replays the original reply instead of
#: re-executing a pop). Mutating callees (exit, barriers) are
#: deliberately absent: they get transparent reconnect but never an
#: automatic re-send after the request may have been delivered.
#: ``apply_delta`` is also absent HERE, but clients whose every callee
#: is a delta-staging server (dist_client.init_client, the fleet
#: router's remote replicas) opt it in via ``idempotent=`` — the same
#: req-id dedup replay makes the mutation exactly-once-observable, so
#: a lost-reply retry can never double-stage a delta cut.
IDEMPOTENT_CALLEES: FrozenSet[str] = frozenset({
    'get_node_feature', 'get_node_label', 'get_dataset_meta',
    'get_tensor_size', 'get_edge_index', 'get_edge_size',
    'get_node_partition_id', 'fetch_one_sampled_message',
    'infer', 'stats', 'ping', '_ping', '_obs',
})


def _nodelay(sock: socket.socket) -> socket.socket:
  sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
  return sock


def _send_msg(sock: socket.socket, obj: Any) -> None:
  data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
  bufs = [memoryview(_HDR.pack(len(data))), memoryview(data)]
  while bufs:     # one frame, the header and the body unjoined
    sent = sock.sendmsg(bufs)
    while bufs and sent >= bufs[0].nbytes:
      sent -= bufs[0].nbytes
      bufs.pop(0)
    if bufs and sent:
      bufs[0] = bufs[0][sent:]


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
  """``n`` bytes into one buffer allocated once."""
  buf = bytearray(n)
  view = memoryview(buf)
  got = 0
  while got < n:
    k = sock.recv_into(view[got:], n - got)
    if not k:
      raise ConnectionError('peer closed')
    got += k
  return buf


def _recv_msg(sock: socket.socket) -> Any:
  (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
  return pickle.loads(_recv_exact(sock, n))


def _trace_context(raw) -> Optional[SpanContext]:
  """A request's 5th element as a SpanContext; anything but a
  (trace_id, span_id) pair is no context (the request is still served)."""
  if isinstance(raw, (tuple, list)) and len(raw) == 2:
    return SpanContext(str(raw[0]), str(raw[1]))
  return None


class RpcServer:
  """Threaded RPC endpoint with a callee registry
  (the RpcCalleeBase/rpc_register pattern, reference rpc.py:419-473)."""

  def __init__(self, host: str = '127.0.0.1', port: int = 0,
               auto_start: bool = True,
               resolve_timeout: Optional[float] = None):
    """``resolve_timeout``: how long an incoming request waits for a
    not-yet-registered callee before KeyError. Defaults to 30 s under
    ``auto_start=True`` (where the discovery/registration race is real
    — peers can learn the address before user code finishes
    registering) and 1 s otherwise (callers of auto_start=False
    register everything before start(), so an unknown name is almost
    certainly a typo and should fail fast instead of stalling the
    connection's serve loop — and every request queued behind it — for
    30 s per call)."""
    self._resolve_timeout = (resolve_timeout if resolve_timeout
                             is not None else (30.0 if auto_start
                                               else 1.0))
    self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
      # a bounced server must rebind its well-known port immediately:
      # some kernels keep TIME_WAIT pairs blocking plain SO_REUSEADDR
      # binds for minutes after the old process's conns drained
      self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    except (AttributeError, OSError):
      pass
    self._sock.bind((host, port))
    self._sock.listen(64)
    self.host, self.port = self._sock.getsockname()
    self._callees: Dict[str, Callable] = {}
    self._threads: List[threading.Thread] = []
    self._conns: List[socket.socket] = []
    self._stop = threading.Event()
    self._barriers: Dict[str, threading.Barrier] = {}
    self._gathers: Dict[str, dict] = {}
    self._lock = threading.Lock()
    self._reg_cond = threading.Condition(self._lock)
    # request-id dedup (at-least-once -> exactly-once-observable): a
    # retried idempotent request whose ORIGINAL attempt executed but
    # whose reply was lost gets the cached reply replayed instead of a
    # second execution — this is what makes fetch_one_sampled_message
    # (a queue pop) safe to retry
    # bounded two ways: entries can hold whole sampled-batch payloads,
    # so (a) a NEW request arriving on a connection proves the client
    # consumed the previous reply on it (requests are strictly serial
    # per connection; retries always redial) — the previous entry is
    # evicted immediately, bounding steady state to ~1 entry per live
    # connection — and (b) the LRU cap is the backstop for entries
    # orphaned by dropped connections
    self._dedup: 'OrderedDict[str, tuple]' = OrderedDict()
    self._dedup_cap = 256
    # req_id -> Event for requests currently EXECUTING: a retry that
    # lands while the original attempt is still running (client recv
    # timeout below the callee's legitimate block time) must WAIT for
    # that execution and replay its reply — re-executing concurrently
    # would double-pop fetch_one_sampled_message and lose a batch
    self._dedup_inflight: Dict[str, threading.Event] = {}
    self.dedup_hits = 0
    self.register('_barrier', self._barrier)
    self.register('_gather', self._gather)
    self.register('_ping', self._ping)
    self.register('_obs', self._obs)
    self._accept_thread = None
    if auto_start:
      self.start()

  def start(self) -> None:
    """Begin accepting connections. Callers that register callees after
    construction should prefer auto_start=False + start() once
    registration is complete; requests that arrive before a callee
    exists wait up to 30 s for it (_resolve) before failing — the
    discovery/registration race (observed under load as
    KeyError('push_edges')) costs latency, not correctness."""
    if self._accept_thread is None:
      self._accept_thread = threading.Thread(target=self._accept_loop,
                                             daemon=True)
      self._accept_thread.start()

  def register(self, name: str, fn: Callable) -> None:
    with self._reg_cond:
      self._callees[name] = fn
      self._reg_cond.notify_all()

  def _resolve(self, name: str,
               timeout: Optional[float] = None) -> Callable:
    """Look up a callee, WAITING briefly for late registration — peers
    discover this server's address before user code finishes
    registering (the KeyError('push_edges') race the start() docstring
    documents); a bounded wait turns that race into latency. The wait
    is ``resolve_timeout`` (see __init__): long only under auto_start,
    so a typo'd name fails fast on pre-registered servers."""
    if timeout is None:
      timeout = self._resolve_timeout
    deadline = None
    with self._reg_cond:
      while name not in self._callees:
        if deadline is None:
          deadline = time.monotonic() + timeout
        remaining = deadline - time.monotonic()
        if remaining <= 0 or not self._reg_cond.wait(timeout=remaining):
          if name not in self._callees:
            raise KeyError(name)
      return self._callees[name]

  def _ping(self) -> dict:
    """Built-in liveness probe every endpoint answers (HealthMonitor
    targets this; servers may also register a richer 'ping')."""
    with self._lock:
      return {'ok': True, 'callees': len(self._callees)}

  def _obs(self) -> dict:
    """Built-in observability harvest every endpoint answers: this
    process's finished trace spans (Chrome-event dicts) and the global
    registry snapshot. A client assembling a cross-process trace pulls
    each peer's buffer through here (``obs.collect_endpoint_obs``) and
    merges: server-side handler spans carry the caller's trace id."""
    from ..obs import get_registry
    return {'events': get_tracer().events(),
            'metrics': get_registry().snapshot()}

  # built-in synchronization callees (reference rpc.py:105-235)
  def _barrier(self, key: str, world: int) -> bool:
    with self._lock:
      if key not in self._barriers:
        self._barriers[key] = threading.Barrier(world)
      b = self._barriers[key]
    idx = b.wait(timeout=180)
    if idx == 0:  # one releasee frees the slot (keys are single-use)
      with self._lock:
        self._barriers.pop(key, None)
    return True

  def _gather(self, key: str, rank: int, world: int, value) -> dict:
    with self._lock:
      slot = self._gathers.setdefault(
          key, {'vals': {}, 'served': 0,
                'cond': threading.Condition(self._lock)})
      slot['vals'][rank] = value
      slot['cond'].notify_all()
      while len(slot['vals']) < world:
        if not slot['cond'].wait(timeout=180):
          raise TimeoutError(f'gather {key} timed out')
      out = dict(slot['vals'])
      slot['served'] += 1
      if slot['served'] >= world:  # every rank got its copy: free it
        self._gathers.pop(key, None)
      return out

  def _accept_loop(self) -> None:
    while not self._stop.is_set():
      try:
        conn, _ = self._sock.accept()
      # accept() raising OSError means stop() closed the listening
      # socket: breaking is the orderly shutdown
      except OSError:  # gltlint: disable=GLT006
        break
      _nodelay(conn)
      t = threading.Thread(target=self._serve_conn, args=(conn,),
                           daemon=True)
      with self._lock:
        self._conns.append(conn)
        self._threads.append(t)
      t.start()

  def _dedup_get(self, req_id: Optional[str]):
    """Cached reply for ``req_id``, WAITING out an in-flight original
    execution first (so a duplicate never executes concurrently).
    Returns None only when this thread should execute the request."""
    if req_id is None:
      return None
    while True:
      with self._lock:
        hit = self._dedup.get(req_id)
        if hit is not None:
          self.dedup_hits += 1
          self._dedup.move_to_end(req_id)
          return hit
        ev = self._dedup_inflight.get(req_id)
        if ev is None:
          self._dedup_inflight[req_id] = threading.Event()
          return None
      # another connection is executing this very request: wait for it,
      # then loop — the re-check either replays its reply or (executor
      # vanished without one) atomically claims execution
      if not ev.wait(timeout=300):
        with self._lock:
          if self._dedup_inflight.get(req_id) is ev:
            # executor presumed dead after the full wait: claim it
            self._dedup_inflight[req_id] = threading.Event()
            return None

  def _dedup_put(self, req_id: Optional[str], reply) -> None:
    if req_id is None:
      return
    with self._lock:
      if reply is not None:
        self._dedup[req_id] = reply
        self._dedup.move_to_end(req_id)
        while len(self._dedup) > self._dedup_cap:
          self._dedup.popitem(last=False)
      ev = self._dedup_inflight.pop(req_id, None)
    if ev is not None:
      ev.set()

  def _serve_conn(self, conn: socket.socket) -> None:
    try:
      with conn:
        self._serve_conn_loop(conn)
    finally:
      # prune: reconnect-heavy clients (the hardened RpcClient redials
      # on every recovery) would otherwise grow _conns — and the dead
      # per-connection Thread objects — without bound
      me = threading.current_thread()
      # list.remove if present (under self._lock): a ValueError means
      # another path already pruned the entry
      with self._lock:
        try:
          self._conns.remove(conn)
        except ValueError:  # gltlint: disable=GLT006
          pass
        try:
          self._threads.remove(me)
        except ValueError:  # gltlint: disable=GLT006
          pass

  def _serve_conn_loop(self, conn: socket.socket) -> None:
    prev_req_id: Optional[str] = None
    while not self._stop.is_set():
      try:
        msg = _recv_msg(conn)
      except (ConnectionError, EOFError, OSError):
        return
      # wire format: (name, args, kwargs[, req_id[, trace_ctx]]) — the
      # 4th element rides only on retryable requests (None placeholder
      # when only tracing), the 5th only on traced requests
      name, args, kwargs = msg[0], msg[1], msg[2]
      req_id = msg[3] if len(msg) > 3 else None
      trace_ctx = _trace_context(msg[4]) if len(msg) > 4 else None
      # any subsequent request on this connection proves the client
      # consumed the previous reply (serial per connection; a retry
      # after a drop redials) — release the cached payload now instead
      # of pinning up to _dedup_cap full batch replies in steady state
      if prev_req_id is not None and prev_req_id != req_id:
        with self._lock:
          self._dedup.pop(prev_req_id, None)
      if req_id is not None:
        prev_req_id = req_id
      cached = self._dedup_get(req_id)
      if cached is not None:
        try:
          _send_msg(conn, cached)
        except (ConnectionError, OSError):
          return
        continue
      try:
        fn = self._resolve(name)
        # reopen the caller's span context (if any) around the handler:
        # the server-side span shares the client's trace id and parents
        # under its rpc span. With no incoming context this is a local
        # span (or the cached no-op while tracing is off).
        with get_tracer().remote_span(f'rpc.server:{name}', trace_ctx,
                                      callee=name):
          reply = ('ok', fn(*args, **kwargs))
      except BaseException as e:  # deliver errors to the caller
        try:
          pickle.dumps(e)
          reply = ('err', e)
        except Exception:
          reply = ('err', RuntimeError(str(e)))
      # callee errors are cached too: a retried request must observe
      # the SAME outcome as the lost original, success or not
      self._dedup_put(req_id, reply)
      try:
        _send_msg(conn, reply)
      except (ConnectionError, OSError):
        return

  def live_connections(self) -> int:
    """Connections this server is serving now."""
    with self._lock:
      return len(self._conns)

  def stop(self) -> None:
    """Stop serving: no connection is accepted or served after this
    returns. Each socket is shut down before it is closed: a bare close
    of a socket another thread is blocked on (the accept loop, a serve
    thread's recv) leaves it open in the kernel until that call returns,
    so a stopped server would still accept one more connection."""
    self._stop.set()
    with self._lock:
      conns, self._conns = self._conns, []
    for sock in [self._sock] + conns:
      # close live per-connection sockets too: serve threads unblock and
      # exit, and the port is immediately rebindable (a bounced server
      # can come back on the same address — the reconnect story depends
      # on it)
      try:
        sock.shutdown(socket.SHUT_RDWR)
      except OSError:
        pass
      try:
        sock.close()
      except OSError:
        pass


def ping_endpoint(host: str, port: int, timeout: float = 2.0) -> dict:
  """One-shot liveness probe on a FRESH connection: connect, call the
  built-in ``_ping``, close. Health probers use this instead of a
  shared RpcClient so a wedged in-flight request (which holds the
  client's lock for its whole recv) can never stall health detection
  for the other peers."""
  sock = socket.create_connection((host, int(port)), timeout=timeout)
  try:
    sock.settimeout(timeout)
    _send_msg(sock, ('_ping', (), {}))
    status, payload = _recv_msg(sock)
  finally:
    try:
      sock.close()
    except OSError:
      pass
  if status == 'err':
    raise payload
  return payload


#: process-unique prefix for request ids (pid guards against forked
#: twins colliding in one server's dedup cache)
_CLIENT_IDS = itertools.count()


class RpcClient:
  """One connection per (client, server); thread-safe; async via a pool
  (the reference's async_request_server, dist_client.py:82-101).

  Hardened, as in the JAX package:

    * **transparent reconnect** — a peer close no longer kills the
      client; the dead socket is dropped and the next request redials;
    * **per-request deadlines** — ``_rpc_timeout`` bounds one request's
      recv instead of the connection-wide 180 s default;
    * **idempotent retry** — requests to :data:`IDEMPOTENT_CALLEES`
      (plus ``idempotent`` extras) carry a request id and are retried
      under ``retry`` (capped exponential backoff + jitter); the
      server's dedup cache replays a lost reply rather than
      re-executing. Send-phase failures (the request provably never
      left) are retried for EVERY callee;
    * **circuit breaker** — ``failure_threshold`` consecutive
      connection errors trip the per-peer breaker and subsequent calls
      fail fast with :class:`CircuitOpenError` until the reset timeout
      admits a probe, instead of each eating a full timeout.

  ``metrics`` (None, or any object with record_retry /
  record_reconnect / record_breaker_open) observes recovery actions;
  the client also keeps local ``retries`` / ``reconnects`` counters.
  """

  _pool = ThreadPoolExecutor(max_workers=16)

  def __init__(self, host: str, port: int, timeout: float = 180.0,
               connect_retries: int = 60, retry_interval: float = 0.5,
               retry: Optional[RetryPolicy] = None,
               breaker: Optional[CircuitBreaker] = None,
               idempotent: Optional[FrozenSet[str]] = None,
               metrics=None):
    self._addr = (host, port)
    self._timeout = timeout
    self._lock = threading.Lock()
    self._sock = None
    self._retry = retry or RetryPolicy()
    self._idempotent = IDEMPOTENT_CALLEES | frozenset(idempotent or ())
    self.metrics = metrics
    self.breaker = breaker or CircuitBreaker(name=f'{host}:{port}')
    if self.breaker.on_open is None:
      self.breaker.on_open = self._on_breaker_open
    self.retries = 0
    self.reconnects = 0
    self._req_prefix = f'{os.getpid()}.{next(_CLIENT_IDS)}'
    self._req_seq = itertools.count()
    self._connect(connect_retries, retry_interval)

  def _on_breaker_open(self) -> None:
    if self.metrics is not None:
      self.metrics.record_breaker_open()

  def _connect(self, retries: int = 1, interval: float = 0.5,
               timeout: Optional[float] = None) -> None:
    # peers race at startup (the reference retries rendezvous the same
    # way, rpc.py:280-322 MAX_RETRY 60 @ 3s). ``timeout`` caps ONE
    # connect attempt; deadline-bounded requests pass their remaining
    # budget so a SYN-blackholed peer can't hold them for the full
    # connection-wide timeout.
    last = None
    tries = max(retries, 1)
    connect_timeout = self._timeout if timeout is None \
        else min(self._timeout, timeout)
    for k in range(tries):
      try:
        self._sock = _nodelay(socket.create_connection(
            self._addr, timeout=connect_timeout))
        return
      except OSError as e:
        last = e
        if k + 1 < tries:  # no pointless sleep after the final attempt
          time.sleep(interval)
    raise ConnectionError(
        f'could not connect to {self._addr}: {last}')

  def _drop_sock_locked(self) -> None:
    if self._sock is not None:
      try:
        self._sock.close()
      except OSError:
        pass
      self._sock = None

  def _request_once(self, name: str, args, kwargs,
                    req_id: Optional[str],
                    rpc_timeout: Optional[float], trace_ctx=None):
    """One attempt over the (re)established socket. Raises
    ``_SendPhaseError`` when the failure provably predates delivery
    (safe to retry for any callee)."""
    with self._lock:
      if self._sock is None:
        try:
          self._connect(retries=1, timeout=rpc_timeout)
        except ConnectionError as e:
          raise _SendPhaseError(e) from e
        self.reconnects += 1
        if self.metrics is not None:
          self.metrics.record_reconnect()
      if trace_ctx is not None:
        # the trace context rides a 5th element; req_id keeps slot 3
        # (a None placeholder: the server treats it as untracked)
        msg = (name, args, kwargs, req_id, tuple(trace_ctx))
      elif req_id is not None:
        msg = (name, args, kwargs, req_id)
      else:
        msg = (name, args, kwargs)
      try:
        _send_msg(self._sock, msg)
      except (ConnectionError, OSError) as e:
        self._drop_sock_locked()
        raise _SendPhaseError(e) from e
      try:
        if rpc_timeout is not None:
          self._sock.settimeout(rpc_timeout)
        try:
          status, payload = _recv_msg(self._sock)
        finally:
          if rpc_timeout is not None and self._sock is not None:
            self._sock.settimeout(self._timeout)
      except (ConnectionError, EOFError, OSError,
              pickle.UnpicklingError):
        # the reply is unrecoverable on this connection either way —
        # a stray late reply on a reused socket would answer the WRONG
        # request
        self._drop_sock_locked()
        raise
    if status == 'err':
      # wrapped so a callee-raised ConnectionError is never mistaken
      # for a transport failure (which would wrongly trip the breaker
      # and burn retry attempts replaying the same cached error)
      raise _CalleeError(payload)
    return payload

  def request(self, name: str, *args, _rpc_timeout: Optional[float]
              = None, **kwargs):
    """Call ``name`` on the peer. ``_rpc_timeout`` (seconds) is this
    request's TOTAL reply budget across every retry (reserved kwarg —
    never forwarded to the callee): each attempt's recv gets the
    remaining slice, and the retry loop stops once the budget is spent
    — a wedged peer cannot hold the caller for attempts x timeout.
    Connection errors engage reconnect/retry/breaker as described on
    the class.

    With tracing on the call runs inside an ``rpc.client:<name>`` span
    whose context ships with the request, so the peer's handler span
    nests under it in a merged trace."""
    tracer = get_tracer()
    if not tracer.enabled:
      return self._request_with_retries(name, args, kwargs, _rpc_timeout,
                                        None)
    with tracer.span(f'rpc.client:{name}', cat='rpc', callee=name,
                     peer=f'{self._addr[0]}:{self._addr[1]}') as ctx:
      return self._request_with_retries(name, args, kwargs, _rpc_timeout,
                                        ctx)

  def _request_with_retries(self, name: str, args, kwargs,
                            _rpc_timeout: Optional[float], trace_ctx):
    retryable = name in self._idempotent
    attempts = self._retry.max_attempts
    req_id = (f'{self._req_prefix}.{next(self._req_seq)}'
              if retryable else None)
    deadline = (time.monotonic() + _rpc_timeout
                if _rpc_timeout is not None else None)
    last: Optional[BaseException] = None
    for attempt in range(attempts):
      if not self.breaker.allow():
        raise CircuitOpenError(
            f'circuit open for peer {self._addr} '
            f'(after {self.breaker.failure_threshold} consecutive '
            'failures); failing fast')
      budget = None
      if deadline is not None:
        # slice the remaining budget over the remaining attempts: a
        # dropped reply must leave room to retry, yet the attempts can
        # never sum past the caller's deadline
        remaining = max(deadline - time.monotonic(), 0.001)
        budget = remaining / (attempts - attempt) if retryable \
            else remaining
      try:
        out = self._request_once(name, args, kwargs, req_id, budget,
                                 trace_ctx=trace_ctx)
      except _CalleeError as e:
        # callee-raised error: delivered + executed — the peer is
        # healthy, so neither the breaker nor the retry loop applies
        self.breaker.record_success()
        raise e.error
      except _SendPhaseError as e:
        # request never delivered: retry is safe for ANY callee
        self.breaker.record_failure()
        last = e.cause
      except (ConnectionError, EOFError, OSError,
              pickle.UnpicklingError) as e:
        self.breaker.record_failure()
        if not retryable:
          raise
        last = e
      except BaseException:
        # anything else (an unpicklable argument, a caller bug) never
        # exercised the peer: hand back a HALF_OPEN probe token taken
        # by allow() — without this the breaker wedges OPEN forever
        self.breaker.release_probe()
        raise
      else:
        self.breaker.record_success()
        return out
      if deadline is not None and time.monotonic() >= deadline:
        break  # budget spent: no further attempts
      if attempt + 1 < attempts:
        self.retries += 1
        if self.metrics is not None:
          self.metrics.record_retry()
        self._retry.sleep(attempt)
    assert last is not None
    raise last

  def async_request(self, name: str, *args, **kwargs) -> Future:
    if get_tracer().enabled:
      # the caller's span context into the pool thread: without it an
      # async rpc span would open an orphan root of its own
      import contextvars
      ctx = contextvars.copy_context()
      return self._pool.submit(ctx.run, self.request, name, *args,
                               **kwargs)
    return self._pool.submit(self.request, name, *args, **kwargs)

  def close(self) -> None:
    with self._lock:
      self._drop_sock_locked()


class _SendPhaseError(Exception):
  """Internal: a connection failure that provably happened before the
  request could reach the peer (connect refused / send reset), so a
  retry cannot double-execute even a mutating callee."""

  def __init__(self, cause: BaseException):
    super().__init__(str(cause))
    self.cause = cause


class _CalleeError(Exception):
  """Internal: the peer answered with an error the CALLEE raised — a
  healthy-peer outcome that must reach the caller verbatim."""

  def __init__(self, error: BaseException):
    super().__init__(str(error))
    self.error = error


# ---------------------------------------------------------------------------
# Reference-shaped any-to-any fabric (reference rpc.py:240-529): a
# process-global context where every process runs an RpcServer, ranks
# rendezvous through the master (rank 0 hosts it), and the convenience
# functions mirror the reference's module surface — init_rpc /
# rpc_register / rpc_request(_async) / barrier / all_gather (+ global
# variants) / rpc_sync_data_partitions / RpcDataPartitionRouter.
# The data plane of a partitioned trainer rides torch.distributed
# collectives (parallel/collectives.py); this fabric is the control plane
# plus host-side exchanges (a spilled DistFeature's cold fetcher, the
# server-client choreography).

import abc


class RpcCalleeBase(abc.ABC):
  """Registered callee contract (reference rpc.py:419-433): implement
  ``call`` and pass the instance to ``rpc_register``."""

  @abc.abstractmethod
  def call(self, *args, **kwargs):
    ...


class RpcDataPartitionRouter:
  """Round-robin among the workers serving each data partition
  (reference rpc.py:364-382)."""

  def __init__(self, partition2workers: Dict[int, List[int]]):
    self._p2w = {int(p): list(ws)
                 for p, ws in partition2workers.items()}
    self._next = {p: 0 for p in self._p2w}

  def get_to_worker(self, partition_idx: int) -> int:
    ws = self._p2w[int(partition_idx)]
    i = self._next[int(partition_idx)]
    self._next[int(partition_idx)] = (i + 1) % len(ws)
    return ws[i]


class _Fabric:
  def __init__(self, master_addr: str, master_port: int, rank: int,
               world_size: int, advertise_addr: str = None):
    self.rank, self.world = int(rank), int(world_size)
    self.master_addr, self.master_port = master_addr, int(master_port)
    local_only = master_addr in ('127.0.0.1', 'localhost')
    self.server = RpcServer(
        host='127.0.0.1' if local_only else '0.0.0.0')
    self.master_server = None
    if self.rank == 0:
      self.master_server = RpcServer(
          host='127.0.0.1' if local_only else '0.0.0.0',
          port=int(master_port))
    self.master = RpcClient(master_addr, int(master_port),
                            connect_retries=240, retry_interval=0.25)
    # rendezvous: everyone contributes the (host, port) its PEERS can
    # reach — a 0.0.0.0 bind must advertise a routable address (the
    # UDP-connect trick discovers the interface facing the master; no
    # packet is sent)
    host = advertise_addr or self.server.host
    if host == '0.0.0.0':
      probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
      try:
        probe.connect((master_addr, int(master_port)))
        host = probe.getsockname()[0]
      finally:
        probe.close()
    book = self.master.request(
        '_gather', 'rpc:addrs', self.rank, self.world,
        (host, self.server.port))
    self.addrs = {int(r): tuple(a) for r, a in book.items()}
    self._clients: Dict[int, RpcClient] = {}
    self._lock = threading.Lock()
    self._seq: Dict[str, int] = {}

  def client(self, dst: int) -> RpcClient:
    # self-requests go through the socket too: one code path
    dst = int(dst)
    with self._lock:
      c = self._clients.get(dst)
    if c is None:
      # connect OUTSIDE the lock: a slow/dead peer's retry window must
      # not stall requests to healthy ranks or seq()
      c = RpcClient(*self.addrs[dst], connect_retries=40)
      with self._lock:
        have = self._clients.get(dst)
        if have is not None:
          c.close()
          return have
        self._clients[dst] = c
    return c

  def seq(self, base: str) -> str:
    # collective calls happen in the same order on every rank, so a
    # local sequence number makes each collective's master key unique
    with self._lock:
      n = self._seq.get(base, 0)
      self._seq[base] = n + 1
      return f'{base}:{n}'

  def close(self, drained: bool = False) -> None:
    """``drained``: every rank has passed the shutdown barrier. The
    master then waits (30 s at most) until the other ranks hang up
    before it stops: stopping closes their connections, and a rank whose
    barrier reply was still in flight would see 'peer closed' (the JAX
    package's shutdown has that race)."""
    for c in self._clients.values():
      c.close()
    self.master.close()
    if drained and self.master_server is not None:
      deadline = time.monotonic() + 30
      while (self.master_server.live_connections()
             and time.monotonic() < deadline):
        time.sleep(0.01)
    self.server.stop()
    if self.master_server is not None:
      self.master_server.stop()


_fabric: 'Dict[str, _Fabric]' = {}


def _role_scope():
  """(key_prefix, world) of the caller's role group — falls back to the
  whole fabric when no DistContext is set."""
  from .dist_context import get_context
  ctx = get_context()
  fab = _fabric['ctx']
  if ctx is None:
    return 'all', fab.world
  return f'{ctx.role.name}:{ctx.group_name}', ctx.world_size


def init_rpc(master_addr: str = '127.0.0.1', master_port: int = 29388,
             rank: int = None, world_size: int = None,
             advertise_addr: str = None) -> None:
  """Bring up the any-to-any fabric (reference rpc.py:240-346). rank /
  world_size default to the DistContext's GLOBAL identity.
  ``master_port`` must be a concrete pre-agreed port — every rank
  connects to it before any channel exists to share an ephemeral one.
  ``advertise_addr`` overrides the address peers use to reach THIS
  rank's server (multihost deployments behind NAT/overlay networks)."""
  if 'ctx' in _fabric:
    raise RuntimeError('init_rpc called twice (see shutdown_rpc)')
  if not int(master_port):
    raise ValueError('master_port must be a concrete pre-agreed port '
                     '(port 0 cannot rendezvous: ranks would have no '
                     'way to learn the ephemeral choice)')
  if rank is None or world_size is None:
    from .dist_context import get_context
    ctx = get_context()
    if ctx is None:
      raise ValueError('init_rpc needs rank/world_size when no '
                       'DistContext is set')
    rank = ctx.global_rank if rank is None else rank
    world_size = (ctx.global_world_size if world_size is None
                  else world_size)
  _fabric['ctx'] = _Fabric(master_addr, master_port, rank, world_size,
                           advertise_addr=advertise_addr)


def rpc_is_initialized() -> bool:
  return 'ctx' in _fabric


def get_rpc_master_addr() -> str:
  return _fabric['ctx'].master_addr


def get_rpc_master_port() -> int:
  return _fabric['ctx'].master_port


def shutdown_rpc(graceful: bool = True) -> None:
  """Tear the fabric down; with ``graceful`` every rank waits at a
  global barrier first so in-flight requests drain (reference
  rpc.py:349-361). Teardown happens even if the drain barrier fails
  (a dead peer must not wedge shutdown or leak the fabric)."""
  fab = _fabric.get('ctx')
  if fab is None:
    return
  drained = False
  try:
    if graceful:
      global_barrier()
      drained = True
  finally:
    del _fabric['ctx']
    fab.close(drained)


def rpc_register(name: str, callee) -> None:
  """Register a callee on THIS process's server. Register before any
  peer can legitimately request ``name`` (the contract the reference
  enforces with registry-id allocation, rpc.py:435-454)."""
  fn = callee.call if isinstance(callee, RpcCalleeBase) else callee
  _fabric['ctx'].server.register(name, fn)


def rpc_request(dst_rank: int, name: str, *args, **kwargs):
  return _fabric['ctx'].client(dst_rank).request(name, *args, **kwargs)


def rpc_request_async(dst_rank: int, name: str, *args,
                      **kwargs) -> Future:
  return _fabric['ctx'].client(dst_rank).async_request(name, *args,
                                                       **kwargs)


def barrier() -> None:
  """Role-scoped barrier (reference rpc.py:105-211)."""
  scope, world = _role_scope()
  fab = _fabric['ctx']
  fab.master.request('_barrier', fab.seq(f'bar:{scope}'), world)


def all_gather(value) -> dict:
  """Role-scoped gather: returns {role_rank: value}."""
  from .dist_context import get_context
  scope, world = _role_scope()
  ctx = get_context()
  rank = _fabric['ctx'].rank if ctx is None else ctx.rank
  fab = _fabric['ctx']
  return fab.master.request(
      '_gather', fab.seq(f'ag:{scope}'), rank, world, value)


def global_barrier() -> None:
  fab = _fabric['ctx']
  fab.master.request('_barrier', fab.seq('gbar'), fab.world)


def global_all_gather(value) -> dict:
  fab = _fabric['ctx']
  return fab.master.request('_gather', fab.seq('gag'), fab.rank,
                            fab.world, value)


def rpc_sync_data_partitions(data_partitions) -> Dict[int, List[int]]:
  """Gather each rank's served partition list and invert it into
  partition -> [ranks] (reference rpc.py:386-414); feed the result to
  RpcDataPartitionRouter."""
  got = all_gather(list(map(int, data_partitions)))
  out: Dict[int, List[int]] = {}
  for rank in sorted(got):
    for p in got[rank]:
      out.setdefault(int(p), []).append(int(rank))
  return out


# The fabric is GLOBAL-rank addressed (every process has one identity),
# so the reference's role-crossing request variants (rpc.py:477-529
# rpc_global_request*) are the same operation under its names.
rpc_global_request = rpc_request
rpc_global_request_async = rpc_request_async
