"""Retry policy and per-peer circuit breaker (counterpart of
glt_tpu/resilience/retry.py), the two host-side primitives the fault
tolerant rpc fabric is built from.

Failure model: peers are fail-stop processes behind lossy links. A
transient fault (a dropped frame, a flaky link, a peer restart) is
survived by a bounded *retry with capped exponential backoff and
jitter*; a persistent fault (a dead peer) must FAIL FAST -- the
:class:`CircuitBreaker` turns the N-th consecutive connection error into
an immediate :class:`CircuitOpenError` instead of letting every caller
wait out a full connect or recv timeout.

Every breaker open also lands on the process flight recorder
(``glt_tpu_torch.obs.get_recorder().trip('breaker_open')``), as in the
JAX package. ``registry=`` (default None) is a
:class:`~glt_tpu_torch.obs.MetricsRegistry` or any object with
``set(name, value, **labels)`` and ``inc(name, **labels)``.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Dict, Optional

#: breaker states (the classic 3-state machine)
CLOSED = 'CLOSED'
OPEN = 'OPEN'
HALF_OPEN = 'HALF_OPEN'


class CircuitOpenError(ConnectionError):
  """Fail-fast rejection: the peer's breaker is OPEN. Subclasses
  ConnectionError so existing connection-failure handling (failover,
  epoch degradation) treats a breaker rejection exactly like the dead
  peer it stands in for."""


@dataclasses.dataclass
class RetryPolicy:
  """Capped exponential backoff with full jitter.

  delay(attempt) = uniform(min_fraction, 1) * min(base * 2^attempt, cap)

  Args:
    max_attempts: total tries (1 = no retry).
    base_delay_s: backoff base for attempt 0.
    max_delay_s: cap on the un-jittered delay.
    jitter: fraction of the delay that is randomized; 0 = deterministic
      (chaos tests pin schedules), 1 = classic full jitter.
  """
  max_attempts: int = 4
  base_delay_s: float = 0.05
  max_delay_s: float = 2.0
  jitter: float = 0.5

  def delay(self, attempt: int, rng: Optional[random.Random] = None
            ) -> float:
    d = min(self.base_delay_s * (2.0 ** max(attempt, 0)),
            self.max_delay_s)
    if self.jitter <= 0:
      return d
    r = (rng or random).uniform(1.0 - self.jitter, 1.0)
    return d * r

  def sleep(self, attempt: int,
            rng: Optional[random.Random] = None) -> float:
    d = self.delay(attempt, rng)
    if d > 0:
      time.sleep(d)
    return d


class CircuitBreaker:
  """Per-peer CLOSED -> OPEN -> HALF_OPEN breaker.

  CLOSED: requests flow; ``failure_threshold`` CONSECUTIVE failures
  trip it OPEN (a single success resets the streak — an occasionally
  flaky peer never trips).
  OPEN: ``allow()`` is False (callers raise CircuitOpenError without
  touching the socket) until ``reset_timeout_s`` elapses, then one
  probe is admitted (HALF_OPEN).
  HALF_OPEN: exactly one in-flight probe; its success closes the
  breaker, its failure re-opens (and re-arms the timeout).

  Thread-safe; all transitions happen under one lock. ``on_open`` is
  called (outside the lock) every CLOSED/HALF_OPEN -> OPEN transition —
  the metrics hook. Every open also lands on the process flight
  recorder (``trip('breaker_open')``): a breaker opening is the moment a
  postmortem wants the recent span and counter context. ``name`` labels
  the peer in that event (optional, purely observational).

  ``labels`` (e.g. ``{'shard': 'shard0', 'replica': 'r1'}``) ride
  every trip payload and every registry series, so two shards sharing
  one registry never merge their breaker series — the fleet lesson:
  an unlabeled ``breaker_opens_total`` summed across shards cannot
  tell "shard 2 is dying" from "everything is mildly flaky". With
  ``registry=`` set, the breaker also publishes a labeled
  ``breaker_state`` gauge (0=CLOSED, 1=HALF_OPEN, 2=OPEN) and a
  ``breaker_opens_total`` counter on every transition.
  """

  def __init__(self, failure_threshold: int = 5,
               reset_timeout_s: float = 5.0,
               on_open: Optional[Callable[[], None]] = None,
               name: str = '',
               labels: Optional[Dict[str, str]] = None,
               registry=None):
    assert failure_threshold >= 1
    self.failure_threshold = int(failure_threshold)
    self.reset_timeout_s = float(reset_timeout_s)
    self.on_open = on_open
    self.name = str(name)
    self.labels = {str(k): str(v) for k, v in (labels or {}).items()}
    self.registry = registry
    self._lock = threading.Lock()
    self._state = CLOSED
    self._consecutive_failures = 0
    self._opened_at = 0.0
    self._probe_inflight = False
    self.opens = 0  # lifetime OPEN transitions (metrics)

  @property
  def state(self) -> str:
    with self._lock:
      return self._state_locked()

  def _state_locked(self) -> str:
    if (self._state == OPEN and not self._probe_inflight
        and time.monotonic() - self._opened_at >= self.reset_timeout_s):
      return HALF_OPEN
    return self._state

  def allow(self) -> bool:
    """True if a request may proceed. In HALF_OPEN this ADMITS the one
    probe (side effect: the token is taken until record_*)."""
    with self._lock:
      s = self._state_locked()
      if s == CLOSED:
        return True
      if s == HALF_OPEN and not self._probe_inflight:
        self._probe_inflight = True
        return True
      return False

  def _series_labels(self) -> Dict[str, str]:
    out = dict(self.labels)
    if self.name:
      out.setdefault('breaker', self.name)
    return out

  def _publish_state(self, state: str) -> None:
    """Labeled ``breaker_state`` gauge (0/1/2) — best-effort, outside
    the lock; metrics must never wedge the failure path."""
    if self.registry is None:
      return
    try:
      code = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}[state]
      self.registry.set('breaker_state', code, **self._series_labels())
    except Exception:
      pass

  def record_success(self) -> None:
    with self._lock:
      self._state = CLOSED
      self._consecutive_failures = 0
      self._probe_inflight = False
    self._publish_state(CLOSED)

  def record_failure(self) -> None:
    fire = False
    with self._lock:
      self._consecutive_failures += 1
      if self._probe_inflight:  # failed HALF_OPEN probe: re-open
        self._probe_inflight = False
        self._state = OPEN
        self._opened_at = time.monotonic()
        self.opens += 1
        fire = True
      elif (self._state == CLOSED
            and self._consecutive_failures >= self.failure_threshold):
        self._state = OPEN
        self._opened_at = time.monotonic()
        self.opens += 1
        fire = True
      # the trip payload under the lock: a concurrent record_success
      # resetting the streak before the trip below would otherwise
      # record consecutive_failures=0 for an OPEN
      failures, opens = self._consecutive_failures, self.opens
    if fire:
      self._publish_state(OPEN)
      if self.registry is not None:
        try:
          self.registry.inc('breaker_opens_total',
                            **self._series_labels())
        except Exception:
          pass
      if self.on_open is not None:
        try:
          self.on_open()
        except Exception:
          pass
      try:  # postmortem hook — must never break the failure path
        from ..obs.recorder import get_recorder
        payload = dict(self.labels)
        payload.update(breaker=self.name,
                       consecutive_failures=failures, opens=opens)
        get_recorder().trip('breaker_open', **payload)
      except Exception:
        pass

  def release_probe(self) -> None:
    """Return a HALF_OPEN probe token taken by ``allow()`` when the
    attempt aborted before the peer was ever exercised (an unpicklable
    argument, a caller bug) — neither a success nor a peer failure, so
    the token must come back or the breaker wedges OPEN forever with
    no probe ever admitted again."""
    with self._lock:
      self._probe_inflight = False

  def reset(self) -> None:
    """Force-close (admin/testing hook)."""
    self.record_success()
