"""Host-side pipeline tracer with cross-process context propagation
(counterpart of glt_tpu/obs/trace.py).

A :class:`Tracer` records **spans** — named, timed regions of the host
pipeline (``serve.flush``, ``serve.bucket``, ``fleet.infer``,
``rpc.client:<callee>`` / ``rpc.server:<callee>``...) — into a bounded
ring buffer. Spans nest via a contextvar, carry a shared ``trace_id``,
and export as Chrome-trace-event JSON (``chrome://tracing`` / Perfetto
"open trace file"), field for field as the JAX package's.

Three bridges make the host spans useful on a card:

  * **device annotation** — every live span also opens a
    ``torch.profiler.record_function`` range of the same name, so a
    torch profile of a traced run splits its device time by span
    (``GLT_OBS_ANNOTATE=0`` turns the ranges off);
  * **device-sync sampling** — CUDA launches are asynchronous, so a host
    span around them measures the enqueue, not the work. A span given
    ``sync=<tensors>`` synchronises the tensors' CUDA device on exit for
    a sampled fraction of spans (``GLT_OBS_TRACE_SAMPLE``, default 0);
  * **RPC propagation** — ``distributed.rpc`` ships the current
    (trace_id, span_id) with each traced request and the server reopens
    it (:meth:`Tracer.remote_span`), so a cross-process request
    assembles into ONE trace; per-endpoint buffers are harvested with
    :func:`collect_endpoint_obs` and merged with
    :func:`merge_chrome_traces`. The frames are the JAX package's, so
    the context crosses between the two packages too.

Disabled (default), ``span()`` returns a cached null context manager:
one attribute read + one ``if`` per call site.
"""
from __future__ import annotations

import contextvars
import itertools
import json
import os
import random
import threading
import time
from collections import deque
from typing import Iterable, List, NamedTuple, Optional

from ..utils.env import knob
from .registry import MetricsRegistry, get_registry


class SpanContext(NamedTuple):
  """The propagatable identity of a live span (what crosses the RPC
  wire): everything a child — local or remote — needs to attach."""
  trace_id: str
  span_id: str


class Span(NamedTuple):
  """One finished span (immutable record in the ring buffer)."""
  name: str
  cat: str
  trace_id: str
  span_id: str
  parent_id: Optional[str]
  ts_us: int          # wall-clock start, µs since epoch (cross-process)
  dur_us: int
  pid: int
  tid: int
  args: dict

  def to_chrome(self) -> dict:
    args = {'trace_id': self.trace_id, 'span_id': self.span_id}
    if self.parent_id is not None:
      args['parent_id'] = self.parent_id
    args.update(self.args)
    return {'name': self.name, 'cat': self.cat, 'ph': 'X',
            'ts': self.ts_us, 'dur': self.dur_us,
            'pid': self.pid, 'tid': self.tid, 'args': args}


_current: 'contextvars.ContextVar[Optional[SpanContext]]' = \
    contextvars.ContextVar('glt_torch_obs_span', default=None)


class _NullSpan:
  """Reusable no-op context manager — the disabled-tracer fast path."""

  __slots__ = ()

  def __enter__(self):
    return None

  def __exit__(self, *exc):
    return False


_NULL = _NullSpan()


def _sync_devices(target) -> None:
  """Synchronise the CUDA device of every tensor in ``target`` (a tensor
  or a nested list/tuple/dict of them); CPU tensors are complete when a
  call returns them."""
  import torch
  devices = set()
  stack = [target]
  while stack:
    t = stack.pop()
    if isinstance(t, torch.Tensor):
      if t.is_cuda:
        devices.add(t.device)
    elif isinstance(t, dict):
      stack.extend(t.values())
    elif isinstance(t, (list, tuple)):
      stack.extend(t)
  for d in devices:
    torch.cuda.synchronize(d)


class _LiveSpan:
  """Context manager for one recording span."""

  __slots__ = ('_tracer', '_name', '_cat', '_args', '_sync', '_ctx',
               '_token', '_parent', '_t0', '_ts', '_ann')

  def __init__(self, tracer: 'Tracer', name: str, cat: str, sync,
               args: dict):
    self._tracer = tracer
    self._name = name
    self._cat = cat
    self._args = args
    self._sync = sync
    self._ann = None

  def __enter__(self) -> SpanContext:
    parent = _current.get()
    if parent is None:
      return self._begin(self._tracer._new_trace_id(), None)
    return self._begin(parent.trace_id, parent.span_id)

  def _begin(self, trace_id: str,
             parent_id: Optional[str]) -> SpanContext:
    """Shared open path (local and remote-parent spans): contextvar
    push, profiler range, clock stamps."""
    t = self._tracer
    self._parent = parent_id
    self._ctx = SpanContext(trace_id, t._new_span_id())
    self._token = _current.set(self._ctx)
    if t._annotate:
      from torch.profiler import record_function
      self._ann = record_function(self._name)
      self._ann.__enter__()
    self._ts = time.time_ns() // 1000
    self._t0 = time.perf_counter()
    return self._ctx

  def __exit__(self, *exc):
    t = self._tracer
    if self._sync is not None and t._sample > 0.0 \
        and (t._sample >= 1.0 or random.random() < t._sample):
      try:
        # sync may be a zero-arg callable: call sites that only know
        # their output tensors after the launch hand back a closure
        target = self._sync() if callable(self._sync) else self._sync
        if target is not None:
          _sync_devices(target)
          self._args = dict(self._args, synced=True)
      except Exception:
        pass  # a failed sync must not mask the body's exception
    dur = time.perf_counter() - self._t0
    if self._ann is not None:
      self._ann.__exit__(*exc)
    _current.reset(self._token)
    t._record(Span(self._name, self._cat, self._ctx.trace_id,
                   self._ctx.span_id, self._parent, self._ts,
                   int(dur * 1e6), t._pid,
                   threading.get_ident() & 0x7fffffff, self._args))
    return False


class _RemoteSpan(_LiveSpan):
  """A span re-opened under a REMOTE parent (the rpc server side): the
  incoming SpanContext becomes the parent, and nested local spans
  attach below this one via the contextvar as usual."""

  __slots__ = ('_remote',)

  def __init__(self, tracer, name, cat, remote: SpanContext, args):
    super().__init__(tracer, name, cat, None, args)
    self._remote = remote

  def __enter__(self) -> SpanContext:
    return self._begin(self._remote.trace_id, self._remote.span_id)


class Tracer:
  """Bounded-buffer span recorder; one per process (:func:`get_tracer`).

  Args:
    enabled: initial state (default: the ``GLT_OBS_TRACE`` env knob).
    sample: device-sync sampling rate in [0, 1] for spans that carry a
      ``sync=`` argument (default: ``GLT_OBS_TRACE_SAMPLE`` or 0).
    buffer: ring-buffer capacity in spans (``GLT_OBS_BUFFER``, default
      65536); oldest spans drop first.
    registry: a :class:`MetricsRegistry` that also receives every
      finished span's duration as a ``stage_seconds{stage=<name>}``
      histogram observation (None = the process-global registry).
  """

  def __init__(self, enabled: Optional[bool] = None,
               sample: Optional[float] = None,
               buffer: Optional[int] = None,
               registry: Optional[MetricsRegistry] = None):
    if enabled is None:
      enabled = knob('GLT_OBS_TRACE', False)
    if sample is None:
      sample = knob('GLT_OBS_TRACE_SAMPLE', 0.0)
    if buffer is None:
      buffer = knob('GLT_OBS_BUFFER', 65536)
    self.enabled = bool(enabled)
    self._sample = min(max(float(sample), 0.0), 1.0)
    self._annotate = knob('GLT_OBS_ANNOTATE', True)
    self._spans: 'deque[Span]' = deque(maxlen=max(int(buffer), 16))
    self._lock = threading.Lock()
    self._pid = os.getpid()
    self._seq = itertools.count()
    self._registry = registry
    self.dropped = 0

  # -- lifecycle ---------------------------------------------------------

  def enable(self, sample: Optional[float] = None) -> 'Tracer':
    self.enabled = True
    if sample is not None:
      self._sample = min(max(float(sample), 0.0), 1.0)
    return self

  def disable(self) -> 'Tracer':
    self.enabled = False
    return self

  def clear(self) -> None:
    with self._lock:
      self._spans.clear()
      self.dropped = 0

  # -- recording ---------------------------------------------------------

  def span(self, name: str, cat: str = 'pipeline', sync=None, **args):
    """Context manager for one pipeline-stage span. No-op (a cached
    null manager) while disabled — safe to leave on every hot path.

    ``sync``: tensors whose CUDA device is synchronised on exit for a
    sampled fraction of spans (see ``GLT_OBS_TRACE_SAMPLE``) so the span
    captures device time, not just the enqueue."""
    if not self.enabled:
      return _NULL
    return _LiveSpan(self, name, cat, sync, args)

  def remote_span(self, name: str, ctx, cat: str = 'rpc', **args):
    """Reopen an incoming :class:`SpanContext` (e.g. from an RPC
    request header) as this span's parent. Records whenever ``ctx`` is
    present, even if this process's tracer is disabled — the caller
    opted the request into tracing, and its spans are harvested by the
    caller via :func:`collect_endpoint_obs`."""
    if ctx is None:
      return self.span(name, cat=cat, **args)
    if isinstance(ctx, (tuple, list)):
      ctx = SpanContext(str(ctx[0]), str(ctx[1]))
    return _RemoteSpan(self, name, cat, ctx, args)

  def current_context(self) -> Optional[SpanContext]:
    return _current.get()

  def _new_trace_id(self) -> str:
    return os.urandom(8).hex()

  def _new_span_id(self) -> str:
    return f'{self._pid:x}.{next(self._seq)}'

  def _record(self, span: Span) -> None:
    with self._lock:
      dropping = len(self._spans) == self._spans.maxlen
      if dropping:
        self.dropped += 1
      self._spans.append(span)
    reg = self._registry if self._registry is not None \
        else get_registry()
    if dropping:
      # ``dropped`` alone is an attribute nothing scrapes; the counter
      # makes span loss visible in every registry snapshot
      reg.inc('obs_spans_dropped_total')
    reg.observe('stage_seconds', span.dur_us / 1e6, stage=span.name)

  # -- export ------------------------------------------------------------

  def spans(self, trace_id: Optional[str] = None) -> List[Span]:
    with self._lock:
      out = list(self._spans)
    if trace_id is not None:
      out = [s for s in out if s.trace_id == trace_id]
    return out

  def events(self, trace_id: Optional[str] = None) -> List[dict]:
    """Finished spans as Chrome trace events (plain dicts — picklable,
    the payload ``collect_endpoint_obs`` harvests over RPC)."""
    return [s.to_chrome() for s in self.spans(trace_id)]

  def chrome_trace(self, trace_id: Optional[str] = None) -> dict:
    return merge_chrome_traces(self.events(trace_id))

  def save(self, path: str, trace_id: Optional[str] = None) -> str:
    return save_chrome_trace(path, self.events(trace_id))


def merge_chrome_traces(*event_lists: Iterable[dict]) -> dict:
  """Merge per-process event lists into one Chrome-trace-event /
  Perfetto-loadable document, adding process_name metadata per pid."""
  events: List[dict] = []
  for lst in event_lists:
    events.extend(lst)
  pids = sorted({e['pid'] for e in events})
  meta = [{'name': 'process_name', 'ph': 'M', 'pid': pid, 'tid': 0,
           'args': {'name': f'glt pid {pid}'}} for pid in pids]
  return {'traceEvents': meta + events, 'displayTimeUnit': 'ms'}


def save_chrome_trace(path: str, *event_lists: Iterable[dict]) -> str:
  doc = merge_chrome_traces(*event_lists)
  with open(path, 'w') as f:
    json.dump(doc, f)
  return path


def collect_endpoint_obs(host: str, port: int,
                         timeout: float = 10.0) -> dict:
  """Harvest a remote RpcServer endpoint's obs state on a FRESH
  connection (never contends with a wedged shared client): returns
  ``{'events': [...], 'metrics': {...}}`` from the peer's built-in
  ``_obs`` callee."""
  # local import: distributed.rpc imports this module for propagation
  from ..distributed import rpc as _rpc
  import socket
  sock = socket.create_connection((host, int(port)), timeout=timeout)
  try:
    sock.settimeout(timeout)
    _rpc._send_msg(sock, ('_obs', (), {}))
    status, payload = _rpc._recv_msg(sock)
  finally:
    try:
      sock.close()
    except OSError:
      pass
  if status == 'err':
    raise payload
  return payload


#: process-global tracer
_TRACER = Tracer()


def get_tracer() -> Tracer:
  return _TRACER
