"""Deterministic fault injection for the rpc and channel fabric
(counterpart of glt_tpu/resilience/chaos.py; host-side, no card).

Every injected fault is reproducible: the harness is seeded (knob
``GLT_CHAOS_SEED``, default 0) and every decision is drawn from a
:class:`FaultPlan`, a seeded schedule that answers "what happens to event
k" the same way on every run, and the same way as the JAX package's plan
of the same seed (both draw from ``random.Random(seed)``). Each concurrent
consumer (a proxy pump direction, a wrapped channel) gets its own
deterministic ``fork`` of the plan, so thread interleaving changes when a
fault fires, never whether.

Injectable faults:

  * ``delay``      -- hold an event for ``delay_s`` (a latency spike);
  * ``drop``       -- swallow a frame or message (a lossy link; the
    caller's deadline must notice);
  * ``disconnect`` -- close the connection mid-stream (a peer crash as the
    other end sees it);
  * ``truncate``   -- forward a partial frame, then close (a torn write).

:class:`ChaosTcpProxy` injects at the socket layer between a real
:class:`~glt_tpu_torch.distributed.rpc.RpcClient` and ``RpcServer``, so the
retry, reconnect and breaker stack meets genuine TCP behaviour.
:class:`ChaosChannel` wraps any channel of the sampling message plane;
:func:`flaky` wraps a callable.
"""
from __future__ import annotations

import logging
import random
import socket
import struct
import threading
import time
from typing import Dict, Optional

from ..utils.env import knob

logger = logging.getLogger(__name__)

_HDR = struct.Struct('<Q')  # the rpc fabric's length-prefix header

DELAY = 'delay'
DROP = 'drop'
DISCONNECT = 'disconnect'
TRUNCATE = 'truncate'
_FAULTS = (DELAY, DROP, DISCONNECT, TRUNCATE)


def chaos_seed(default: int = 0) -> int:
  """The run-wide chaos seed (env ``GLT_CHAOS_SEED``). A pinned seed replays
  every fault scenario identically on every run."""
  return knob('GLT_CHAOS_SEED', int(default))


class FaultPlan:
  """Seeded per-event fault schedule.

  Args:
    seed: RNG seed (None -> ``chaos_seed()``).
    delay / drop / disconnect / truncate: per-event probabilities,
      evaluated in that fixed order (at most one fault per event).
    delay_s: injected latency for ``delay`` faults.
    start_after: first ``start_after`` events pass untouched (lets a
      scenario establish healthy state before the weather turns).
    max_faults: stop injecting after this many faults (None =
      unlimited) — guarantees an eventually-successful retry story.
  """

  def __init__(self, seed: Optional[int] = None, *, delay: float = 0.0,
               drop: float = 0.0, disconnect: float = 0.0,
               truncate: float = 0.0, delay_s: float = 0.05,
               start_after: int = 0, max_faults: Optional[int] = None):
    self.seed = chaos_seed() if seed is None else int(seed)
    self.rates = {DELAY: float(delay), DROP: float(drop),
                  DISCONNECT: float(disconnect),
                  TRUNCATE: float(truncate)}
    self.delay_s = float(delay_s)
    self.start_after = int(start_after)
    self.max_faults = max_faults
    self._rng = random.Random(self.seed)
    self._lock = threading.Lock()
    self._events = 0
    self.injected: Dict[str, int] = {f: 0 for f in _FAULTS}

  def fork(self, salt: int) -> 'FaultPlan':
    """A derived plan with an independent deterministic stream — one
    per concurrent consumer, so thread interleaving never reorders any
    single stream's draws."""
    child = FaultPlan(
        seed=(self.seed * 1_000_003 + int(salt) + 1) & 0x7FFFFFFF,
        delay_s=self.delay_s, start_after=self.start_after,
        max_faults=self.max_faults)
    child.rates = dict(self.rates)
    return child

  def next_fault(self) -> Optional[str]:
    """The fault for the next event (None = pass through). Consumes
    exactly one rng draw per event regardless of rates, so schedules
    are stable under rate tweaks of later fault kinds."""
    with self._lock:
      self._events += 1
      u = self._rng.random()
      if self._events <= self.start_after:
        return None
      if (self.max_faults is not None
          and sum(self.injected.values()) >= self.max_faults):
        return None
      edge = 0.0
      for kind in _FAULTS:
        edge += self.rates[kind]
        if u < edge:
          self.injected[kind] += 1
          return kind
      return None

  def schedule(self, n: int) -> list:
    """First ``n`` decisions of a FRESH copy of this plan (pure
    introspection for determinism asserts; does not consume this
    plan's stream)."""
    probe = self.fork(-1)
    probe.seed = self.seed
    probe._rng = random.Random(self.seed)
    return [probe.next_fault() for _ in range(n)]


class ChaosTcpProxy:
  """Frame-aware TCP proxy injecting faults between an RpcClient and an
  RpcServer.

  Listens on an ephemeral port (``.address``); each accepted connection
  dials ``upstream`` and two pump threads forward length-prefixed
  frames, consulting a forked FaultPlan per direction. Chaos applies to
  both requests and responses — a dropped *response* is the nastier
  case (the callee executed, the caller never heard), which is exactly
  what the request-id dedup cache on the server must absorb.
  """

  def __init__(self, upstream_host: str, upstream_port: int,
               plan: FaultPlan, host: str = '127.0.0.1'):
    self.upstream = (upstream_host, int(upstream_port))
    self.plan = plan
    self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
      self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    except (AttributeError, OSError):
      pass
    self._sock.bind((host, 0))
    self._sock.listen(16)
    self.host, self.port = self._sock.getsockname()
    self._stop = threading.Event()
    self._conn_idx = 0
    self._lock = threading.Lock()
    self.connections = 0
    self._live: list = []
    self._accept = threading.Thread(target=self._accept_loop,
                                    daemon=True, name='glt-chaos-proxy')
    self._accept.start()

  @property
  def address(self):
    return (self.host, self.port)

  def retarget(self, host: str, port: int) -> None:
    """Point NEW connections at a different upstream (a restarted
    server on a fresh port); existing pumps keep their old sockets
    until they die — exactly a DNS/VIP failover as the client sees it."""
    self.upstream = (host, int(port))

  @property
  def faults_injected(self) -> Dict[str, int]:
    """Aggregate fault counts over every per-direction fork."""
    out = {f: 0 for f in _FAULTS}
    with self._lock:
      plans = [p for _, _, p in self._live]
    for p in plans:
      for f, n in p.injected.items():
        out[f] += n
    return out

  def _accept_loop(self) -> None:
    while not self._stop.is_set():
      try:
        client, _ = self._sock.accept()
      # the proxy severs its own sockets on purpose: an OSError here is
      # the injected fault, not a failure to surface
      except OSError:  # gltlint: disable=GLT006
        return
      try:
        server = socket.create_connection(self.upstream, timeout=10)
      except OSError:
        client.close()
        continue
      with self._lock:
        idx = self._conn_idx
        self._conn_idx += 1
        self.connections += 1
      closed = threading.Event()
      for d, (src, dst) in enumerate(((client, server),
                                      (server, client))):
        p = self.plan.fork(2 * idx + d)
        with self._lock:
          self._live.append((src, dst, p))
        threading.Thread(
            target=self._pump, args=(src, dst, p, closed),
            daemon=True, name=f'glt-chaos-pump-{idx}-{d}').start()

  @staticmethod
  def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b''
    while len(buf) < n:
      try:
        chunk = sock.recv(n - len(buf))
      except OSError:
        return None
      if not chunk:
        return None
      buf += chunk
    return buf

  def _pump(self, src: socket.socket, dst: socket.socket,
            plan: FaultPlan, closed: threading.Event) -> None:
    try:
      while not self._stop.is_set() and not closed.is_set():
        hdr = self._recv_exact(src, _HDR.size)
        if hdr is None:
          break
        (n,) = _HDR.unpack(hdr)
        payload = self._recv_exact(src, n)
        if payload is None:
          break
        fault = plan.next_fault()
        try:
          if fault == DROP:
            continue
          if fault == DELAY:
            time.sleep(plan.delay_s)
          elif fault == DISCONNECT:
            break
          elif fault == TRUNCATE:
            dst.sendall(hdr + payload[:max(n // 2, 1)])
            break
          dst.sendall(hdr + payload)
        # the injected fault severs this socket on purpose
        except OSError:  # gltlint: disable=GLT006
          break
    finally:
      closed.set()
      # the proxy severs its own sockets on purpose: closing one the
      # fault already closed raises nothing worth surfacing
      for s in (src, dst):
        try:
          s.close()
        except OSError:  # gltlint: disable=GLT006
          pass

  def close(self) -> None:
    self._stop.set()
    try:
      self._sock.close()
    except OSError:
      pass
    with self._lock:
      live = list(self._live)
    for src, dst, _ in live:
      for s in (src, dst):
        try:
          s.close()
        except OSError:
          pass

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


class ChaosChannel:
  """FaultPlan wrapper over any channel: recv-side injection for
  the sampling message plane (drop = message lost, delay = slow link,
  disconnect = producer death as the consumer sees it)."""

  def __init__(self, inner, plan: FaultPlan):
    self.inner = inner
    self.plan = plan

  def send(self, msg) -> None:
    self.inner.send(msg)

  def recv(self, timeout_ms: int = 60_000):
    deadline = time.monotonic() + timeout_ms / 1e3
    while True:
      remaining_ms = max(int((deadline - time.monotonic()) * 1e3), 1)
      msg = self.inner.recv(timeout_ms=remaining_ms)
      fault = self.plan.next_fault()
      if fault == DROP:
        continue  # the message is gone; keep waiting out the budget
      if fault == DELAY:
        time.sleep(self.plan.delay_s)
      elif fault == DISCONNECT:
        raise ConnectionError('chaos: injected disconnect')
      elif fault == TRUNCATE:
        raise ConnectionError('chaos: injected truncated frame')
      return msg

  def empty(self) -> bool:
    return self.inner.empty()

  def __getattr__(self, name):
    return getattr(self.inner, name)


def flaky(fn, plan: FaultPlan):
  """Wrap a callable with plan-driven faults (drop/disconnect ->
  ConnectionError, delay -> sleep) — stalls and crashes for components
  that are functions rather than sockets (engine forwards, fetchers)."""
  def wrapped(*args, **kwargs):
    fault = plan.next_fault()
    if fault in (DROP, DISCONNECT, TRUNCATE):
      raise ConnectionError(f'chaos: injected {fault}')
    if fault == DELAY:
      time.sleep(plan.delay_s)
    return fn(*args, **kwargs)
  return wrapped
