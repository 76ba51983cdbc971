"""Postmortem flight recorder and SLO burn-rate evaluation (counterpart
of glt_tpu/obs/recorder.py).

**FlightRecorder** — an always-on bounded ring of operational events
(breaker opens, engine stalls, ingestor crashes, engine fallbacks —
anything a subsystem :meth:`~FlightRecorder.record`\\ s). When
resilience *trips* (:meth:`~FlightRecorder.trip`), it dumps a
postmortem JSON into ``GLT_OBS_POSTMORTEM_DIR`` carrying:

  * the trip reason + context,
  * the recent event ring (what led up to this),
  * the last spans from the process tracer (the pipeline's final
    moments, when tracing is on),
  * a full registry snapshot plus counter DELTAS since the previous
    dump (what moved, not just where it ended up).

Dumps are rate-limited (``GLT_OBS_POSTMORTEM_MIN_S``) so a flapping
breaker cannot fill a disk; every trip is still recorded and counted
(``flight_trips_total{reason=...}``). With a postmortem dir configured
the recorder also chains ``sys.excepthook`` and registers an atexit
hook, so an abnormal process exit (uncaught exception, or exit after
any trip) leaves a dump behind even when nobody called ``dump()``.

**SloBurnEvaluator** — burn rate over the registry's log-spaced
histograms: for each policy (latency histogram + threshold + objective)
it tracks the windowed fraction of observations above the threshold
between ``evaluate()`` calls and publishes
``slo_burn{slo=...}`` = bad_fraction / error_budget. Burn 1.0 means
"exactly consuming budget"; >1 is the per-shard paging/autoscaling
signal. Policies come from the API or the
``GLT_OBS_SLO`` knob (``name:metric:threshold_s:objective[;...]``,
metric optionally ``hist{label=value,...}``).

Everything is host-side; recording an event is one deque append + one
counter increment.
"""
from __future__ import annotations

import atexit
import dataclasses
import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..utils.env import knob
from .registry import MetricsRegistry, get_registry
from .trace import Tracer, get_tracer


def postmortem_dir() -> Optional[str]:
  return knob('GLT_OBS_POSTMORTEM_DIR', None) or None


class FlightRecorder:
  """Bounded operational-event ring with postmortem dumping.

  Args:
    capacity: event-ring size (oldest drop first).
    dump_dir: postmortem directory; None reads
      ``GLT_OBS_POSTMORTEM_DIR`` *at each dump* (so enabling the knob
      mid-process works). No dir -> trips record + count but never
      touch the filesystem.
    min_dump_interval_s: floor between trip-initiated dumps
      (``GLT_OBS_POSTMORTEM_MIN_S``, default 30); explicit ``dump()``
      calls ignore it.
    spans_tail: max tracer spans included per dump.
    registry / tracer: explicit surfaces (tests); None = process
      globals.
  """

  def __init__(self, capacity: int = 512,
               dump_dir: Optional[str] = None,
               min_dump_interval_s: Optional[float] = None,
               spans_tail: int = 256,
               registry: Optional[MetricsRegistry] = None,
               tracer: Optional[Tracer] = None):
    if min_dump_interval_s is None:
      # knob() warns-and-defaults on a malformed value, so this can
      # never crash the import (the module-level recorder runs this
      # while the module imports)
      min_dump_interval_s = knob('GLT_OBS_POSTMORTEM_MIN_S', 30.0)
    self._events: 'deque[dict]' = deque(maxlen=max(int(capacity), 16))
    self._lock = threading.Lock()
    self._dump_dir = dump_dir
    self._min_dump_s = float(min_dump_interval_s)
    self._spans_tail = int(spans_tail)
    self._registry = registry
    self._tracer = tracer
    self._last_dump_ts = 0.0
    self._last_counters: Dict[str, float] = {}
    self._abnormal = False          # a trip or uncaught exception seen
    self._exit_hooked = False
    self._file_seq = itertools.count(1)  # filename counter (attempt-
                                         # unique even for failed dumps)
    self.dumps = 0                  # postmortems WRITTEN (lifetime)

  # -- surfaces ----------------------------------------------------------

  def _reg(self) -> MetricsRegistry:
    return self._registry if self._registry is not None \
        else get_registry()

  def _trc(self) -> Tracer:
    return self._tracer if self._tracer is not None else get_tracer()

  def _dir(self) -> Optional[str]:
    return self._dump_dir if self._dump_dir is not None \
        else postmortem_dir()

  def events(self) -> List[dict]:
    with self._lock:
      return list(self._events)

  # -- recording ---------------------------------------------------------

  def record(self, kind: str, **data) -> None:
    """Append one operational event to the ring (cheap, never dumps):
    breaker state changes, fallbacks, shed decisions — the breadcrumb
    trail a postmortem replays."""
    evt = {'ts': time.time(), 'kind': str(kind), **data}
    with self._lock:
      self._events.append(evt)
    try:
      self._reg().counter('flight_events_total', kind=str(kind)).inc()
    except Exception:
      pass

  def trip(self, reason: str, **data) -> Optional[str]:
    """A resilience mechanism fired (breaker opened, engine stalled,
    ingestor died): record the event, count
    ``flight_trips_total{reason=...}``, arm the abnormal-exit hook, and
    — rate-limited, postmortem dir permitting — dump. Returns the dump
    path when one was written."""
    self.record(reason, **data)
    try:
      self._reg().counter('flight_trips_total',
                          reason=str(reason)).inc()
    except Exception:
      pass
    self._abnormal = True
    self._ensure_exit_hooks()
    now = time.monotonic()
    with self._lock:
      if self._last_dump_ts and now - self._last_dump_ts \
          < self._min_dump_s:
        return None
    return self.dump(reason)

  # -- dumping -----------------------------------------------------------

  def _counters_delta(self, counters: dict) -> dict:
    """Counter movement since the previous SUCCESSFUL dump — a flat
    registry snapshot says where counters ENDED; the delta says what
    moved during the failure window. Pure read: the baseline commits
    only after the dump actually lands on disk."""
    return {k: v - self._last_counters.get(k, 0.0)
            for k, v in counters.items()
            if v != self._last_counters.get(k, 0.0)}

  def dump(self, reason: str = 'manual') -> Optional[str]:
    """Write one postmortem JSON; returns its path (None when no
    postmortem dir is configured or the write failed). All dump state
    (rate-limit clock, dump counter, delta baseline) commits only on a
    SUCCESSFUL write — a transiently unwritable dir must not rate-limit
    away the retry that would have captured the incident."""
    d = self._dir()
    if not d:
      return None
    try:
      os.makedirs(d, exist_ok=True)
      snap = self._reg().snapshot()
      counters = snap.get('counters', {})
      with self._lock:
        doc = {
            'reason': str(reason),
            'ts': time.time(),
            'pid': os.getpid(),
            'events': list(self._events),
            'spans': self._trc().events()[-self._spans_tail:],
            'registry': snap,
            'counters_delta': self._counters_delta(counters),
        }
      n = next(self._file_seq)
      safe = ''.join(c if c.isalnum() or c in '-_' else '_'
                     for c in str(reason))[:48]
      path = os.path.join(
          d, f'postmortem_{os.getpid()}_{n:03d}_{safe}.json')
      with open(path, 'w') as f:
        json.dump(doc, f, indent=2, default=str)
      with self._lock:
        self._last_dump_ts = time.monotonic()
        self._last_counters = dict(counters)
        self.dumps += 1
      try:
        self._reg().counter('flight_dumps_total').inc()
      except Exception:
        pass
      return path
    except OSError:
      return None

  # -- abnormal-exit hooks -----------------------------------------------

  def _ensure_exit_hooks(self) -> None:
    """Chain sys.excepthook + register atexit once: an uncaught
    exception dumps immediately; a process that saw any trip leaves a
    final dump at interpreter exit (rate limit ignored — it is the
    last chance)."""
    if self._exit_hooked or not self._dir():
      return
    self._exit_hooked = True
    prev = sys.excepthook

    def hook(exc_type, exc, tb):
      self._abnormal = True
      try:
        self.record('uncaught_exception', error=repr(exc))
        self.dump('uncaught_exception')
      except Exception:
        pass
      prev(exc_type, exc, tb)

    sys.excepthook = hook
    atexit.register(self._atexit_dump)

  def _atexit_dump(self) -> None:
    if self._abnormal:
      try:
        self.dump('atexit')
      except Exception:
        pass


@dataclasses.dataclass
class SloPolicy:
  """One latency SLO: "``objective`` of requests observed by
  ``metric``/``labels`` complete within ``threshold_s``"."""
  name: str
  metric: str
  threshold_s: float
  objective: float = 0.99
  labels: dict = dataclasses.field(default_factory=dict)

  @property
  def error_budget(self) -> float:
    return max(1.0 - float(self.objective), 1e-9)


def parse_slo_env(spec: Optional[str] = None) -> List[SloPolicy]:
  """``GLT_OBS_SLO='serve_p99:serving_latency_seconds:0.25:0.99;...'``
  -> policies. Metric may carry labels:
  ``stage_seconds{stage=serve.infer}``."""
  if spec is None:
    spec = knob('GLT_OBS_SLO', '')
  out = []
  for chunk in (spec or '').split(';'):
    chunk = chunk.strip()
    if not chunk:
      continue
    parts = chunk.split(':')
    if len(parts) < 3:
      raise ValueError(
          f'GLT_OBS_SLO entry {chunk!r}: expected '
          'name:metric:threshold_s[:objective]')
    name, metric, threshold = parts[0], parts[1], float(parts[2])
    objective = float(parts[3]) if len(parts) > 3 else 0.99
    labels = {}
    if '{' in metric:
      metric, _, inner = metric.partition('{')
      for pair in inner.rstrip('}').split(','):
        if pair:
          k, _, v = pair.partition('=')
          labels[k.strip()] = v.strip().strip('"')
    out.append(SloPolicy(name, metric, threshold, objective, labels))
  return out


class SloBurnEvaluator:
  """Windowed burn rate over registry histograms.

  Each ``evaluate()`` reads every policy's histogram, diffs (count,
  count_above_threshold) against the previous call, and publishes
  ``slo_burn{slo=name}`` = windowed bad fraction / error budget (0.0
  for an empty window — no traffic burns no budget). Call it from any
  periodic loop (serving stats thread, bench tail, ops cron); state is
  per-evaluator, so two evaluators window independently."""

  def __init__(self, policies: Optional[List[SloPolicy]] = None,
               registry: Optional[MetricsRegistry] = None,
               recorder: Optional[FlightRecorder] = None,
               trip_above: Optional[float] = None):
    self.policies = list(policies) if policies is not None \
        else parse_slo_env()
    self._registry = registry
    self._recorder = recorder
    #: burn level that counts as an SLO trip on the flight recorder
    #: (None disables; e.g. 10.0 = "burning 10x budget" fast-burn page)
    self.trip_above = trip_above
    self._last: Dict[str, tuple] = {}
    # window state is read-modify-write: concurrent evaluate() calls
    # (two monitoring clients pulling stats() at once) would double-
    # count the gap between overlapping windows without this
    self._lock = threading.Lock()

  def add(self, name: str, metric: str, threshold_s: float,
          objective: float = 0.99, **labels) -> 'SloBurnEvaluator':
    self.policies.append(
        SloPolicy(name, metric, threshold_s, objective, labels))
    return self

  def evaluate(self) -> Dict[str, float]:
    return {name: rec['burn']
            for name, rec in self.evaluate_detailed().items()}

  def evaluate_detailed(self) -> Dict[str, dict]:
    """Like :meth:`evaluate` but returns
    ``{name: {'burn': float, 'window': int}}`` — the window request
    count lets callers (the fleet scale-signal loop) suppress
    decisions over windows too thin to mean anything."""
    reg = self._registry if self._registry is not None \
        else get_registry()
    out = {}
    for p in self.policies:
      h = reg.histogram(p.metric, **p.labels)
      # one lock hold for the pair: separate reads tear under
      # concurrent observers and overstate the bad fraction
      count, above = h.count_and_above(p.threshold_s)
      with self._lock:
        l_count, l_above = self._last.get(p.name, (0, 0))
        if count < l_count:  # histogram replaced/reset: restart window
          l_count = l_above = 0
        d_count, d_above = count - l_count, above - l_above
        self._last[p.name] = (count, above)
      burn = (d_above / d_count) / p.error_budget if d_count > 0 \
          else 0.0
      out[p.name] = {'burn': burn, 'window': int(d_count)}
      # the policy's labels ride the gauge too: two shards sharing one
      # registry (distinct view= labels) publish distinct burn series
      # instead of clobbering each other
      reg.set('slo_burn', burn, slo=p.name, **p.labels)
      if (self.trip_above is not None and burn >= self.trip_above
          and self._recorder is not None):
        self._recorder.trip('slo_burn', slo=p.name, burn=round(burn, 3),
                            threshold_s=p.threshold_s,
                            objective=p.objective,
                            window_requests=d_count)
    return out


#: process-global recorder — the surface resilience hooks (breaker
#: on_open, the batcher stall watchdog, the stream ingestor's applier
#: death) report into without plumbing
_RECORDER = FlightRecorder()


def get_recorder() -> FlightRecorder:
  return _RECORDER


def set_recorder(recorder: FlightRecorder) -> FlightRecorder:
  """Swap the process-global recorder (tests); returns the previous
  one."""
  global _RECORDER
  prev, _RECORDER = _RECORDER, recorder
  return prev
