"""Micro-batching request queue for online inference (counterpart of
glt_tpu/serving/batcher.py).

Per-request execution wastes the card on tiny launches: a 1-id request
runs the same walk, gather and forward launches as a full bucket. The
batcher merges concurrent requests into one micro-batch under two bounds
(the classic serving trade-off):

  * ``max_batch_size`` — flush as soon as the queued ids fill a batch
    (throughput bound);
  * ``max_wait_ms``    — flush when the OLDEST queued request has
    waited this long, full or not (latency bound).

Overload is handled at both ends: ``submit`` rejects immediately once
the queue holds ``max_queue`` requests (backpressure — callers see
:class:`ServingOverloaded` instead of unbounded queueing), and each
request carries a deadline after which it is failed with TimeoutError
rather than occupying a batch slot it can no longer use.

The dispatcher is a single thread, which also serializes access to the
engine. With ``handler=engine.infer`` one dispatch is one engine call:
its bucket runs launch the walk (K1) and the feature gather (K3) once
each.

One difference from the JAX batcher: while tracing is on, a dispatch
runs in the trace context of the batch's first request, so the
``serve.flush`` span and the engine's spans under it join that request's
trace instead of opening a root of their own.
"""
from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Callable, List, Optional

import numpy as np

from ..obs import get_tracer


def _fail_future(fut: Future, err: BaseException) -> None:
  """set_exception that tolerates losing the watchdog/dispatcher race:
  done() + set_exception is not atomic, and an InvalidStateError
  escaping the WATCHDOG thread would kill it silently — permanently
  disabling stall protection, the very bug it exists to fix."""
  try:
    if not fut.done():
      fut.set_exception(err)
  except InvalidStateError:
    pass  # the other thread resolved it first: that outcome stands


class ServingOverloaded(RuntimeError):
  """Raised by submit() when the request queue is at capacity."""


class EngineStalledError(RuntimeError):
  """The engine circuit is OPEN: a dispatched forward exceeded the
  stall watchdog's budget (wedged device, dead worker). Pending
  requests are failed with this immediately instead of queueing behind
  a corpse; submit() fails fast with it until the engine proves alive
  (the wedged call returning closes the circuit)."""


class _Request:
  __slots__ = ('ids', 'future', 'deadline', 't_submit', 'ctx')

  def __init__(self, ids, future, deadline, t_submit, ctx=None):
    self.ids = ids
    self.future = future
    self.deadline = deadline
    self.t_submit = t_submit
    self.ctx = ctx   # the submitter's trace context while tracing is on


class MicroBatcher:
  """Deadline-driven micro-batch queue in front of a batch handler.

  Args:
    handler: ``fn(ids: np.ndarray[int64]) -> np.ndarray [len(ids), D]``
      — rows aligned with the input ids (the engine's ``infer``).
    max_batch_size: flush threshold in total queued ids; also the
      capacity used for the batch-fill metric.
    max_wait_ms: max time the oldest request waits before a partial
      flush.
    max_queue: request-count backpressure bound.
    request_timeout_ms: default per-request deadline (None = no
      deadline); ``submit`` can override per call.
    metrics: optional ServingMetrics (batch fill + timeout/reject
      counters).
    stall_timeout_ms: engine watchdog budget — if one dispatched
      handler call runs longer than this, the batch's AND the queue's
      futures are failed with :class:`EngineStalledError` immediately
      (bounded p99 even with a wedged engine) and submit() fails fast
      until the wedged call returns. None disables the watchdog.
  """

  def __init__(self, handler: Callable[[np.ndarray], np.ndarray],
               max_batch_size: int = 64, max_wait_ms: float = 2.0,
               max_queue: int = 1024,
               request_timeout_ms: Optional[float] = 1000.0,
               metrics=None, stall_timeout_ms: Optional[float] = None):
    assert max_batch_size > 0 and max_queue > 0
    self.handler = handler
    self.max_batch_size = int(max_batch_size)
    self.max_wait = float(max_wait_ms) / 1e3
    self.max_queue = int(max_queue)
    self.request_timeout = (float(request_timeout_ms) / 1e3
                            if request_timeout_ms is not None else None)
    self.metrics = metrics
    self.stall_timeout = (float(stall_timeout_ms) / 1e3
                          if stall_timeout_ms is not None else None)
    self._queue: 'deque[_Request]' = deque()
    self._cond = threading.Condition()
    self._running = True
    self._force_flush = False
    # engine-circuit state (watchdog): _inflight tracks the dispatch
    # the handler is currently chewing on; _stalled_gen marks a
    # dispatch the watchdog gave up on (its eventual result is
    # discarded — the futures are long failed)
    self._inflight: Optional[tuple] = None  # (batch, t_start, gen)
    self._gen = 0
    self._stalled = False
    self._stalled_gen = -1
    self._thread = threading.Thread(target=self._dispatch_loop,
                                    daemon=True, name='glt-batcher')
    self._thread.start()
    self._watchdog: Optional[threading.Thread] = None
    if self.stall_timeout is not None:
      self._watchdog = threading.Thread(target=self._watchdog_loop,
                                        daemon=True,
                                        name='glt-batcher-watchdog')
      self._watchdog.start()

  # -- client side -------------------------------------------------------

  def submit(self, ids, timeout_ms: Optional[float] = None) -> Future:
    """Enqueue a request for embeddings of ``ids``; returns a Future
    resolving to an aligned ``[len(ids), D]`` array. Raises
    ServingOverloaded if the queue is full (backpressure), RuntimeError
    after stop()."""
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    timeout = (float(timeout_ms) / 1e3 if timeout_ms is not None
               else self.request_timeout)
    fut: Future = Future()
    with self._cond:
      if not self._running:
        raise RuntimeError('batcher is stopped')
      if self._stalled:
        # engine circuit OPEN: fail fast instead of queueing behind a
        # wedged forward (the server may answer from the embedding
        # cache instead — its stale-serve tier)
        if self.metrics is not None:
          self.metrics.record_shed()
        raise EngineStalledError(
            'engine stalled (dispatch exceeded '
            f'{self.stall_timeout}s); failing fast while the circuit '
            'is open')
      if len(self._queue) >= self.max_queue:
        if self.metrics is not None:
          self.metrics.record_rejected()
        raise ServingOverloaded(
            f'queue at capacity ({self.max_queue} requests)')
      now = time.monotonic()
      self._queue.append(_Request(
          ids, fut, now + timeout if timeout is not None else None, now,
          contextvars.copy_context() if get_tracer().enabled else None))
      # notify_all: the watchdog waits on this condition too — a single
      # notify could wake IT instead of the dispatcher and strand the
      # queue until the next timeout tick
      self._cond.notify_all()
    return fut

  def flush(self) -> None:
    """Force an immediate flush of whatever is queued."""
    with self._cond:
      self._force_flush = True
      self._cond.notify_all()

  @property
  def depth(self) -> int:
    with self._cond:
      return len(self._queue)

  @property
  def stalled(self) -> bool:
    """True while the engine circuit is OPEN (a dispatch blew past
    ``stall_timeout_ms`` and has not returned yet)."""
    with self._cond:
      return self._stalled

  def stop(self) -> None:
    """Stop the dispatcher; pending requests fail with RuntimeError."""
    with self._cond:
      self._running = False
      pending = list(self._queue)
      self._queue.clear()
      self._cond.notify_all()
    for r in pending:
      _fail_future(r.future, RuntimeError('batcher stopped'))
    self._thread.join(timeout=5)
    if self._watchdog is not None:
      self._watchdog.join(timeout=5)

  # -- dispatcher --------------------------------------------------------

  def _expire_locked(self, now: float) -> None:
    """Fail queued requests whose deadline has passed. A deadline
    firing on an all-expired queue is the 'empty flush' case: the
    handler is simply not called. Counted as BOTH a timeout (the
    client-visible outcome) and a shed (the request never occupied a
    dispatch slot — load-shedding accounting)."""
    live = deque()
    for r in self._queue:
      if r.deadline is not None and now >= r.deadline:
        if self.metrics is not None:
          self.metrics.record_timeout()
          self.metrics.record_shed()
        _fail_future(r.future, TimeoutError(
            f'request timed out after {now - r.t_submit:.3f}s in queue'))
      else:
        live.append(r)
    self._queue = live

  def _pop_batch_locked(self) -> List[_Request]:
    """Take requests FIFO while they fit in max_batch_size total ids.
    The head request always ships even if oversized by itself (the
    engine chunks across buckets); later oversized requests wait for
    the next flush rather than starving the current one."""
    batch: List[_Request] = []
    total = 0
    while self._queue:
      r = self._queue[0]
      if batch and total + r.ids.size > self.max_batch_size:
        break
      batch.append(self._queue.popleft())
      total += r.ids.size
      if total >= self.max_batch_size:
        break
    return batch

  def _next_wakeup_locked(self, now: float) -> float:
    """Seconds until the next actionable instant: the oldest request's
    flush deadline or the nearest per-request timeout."""
    t = self._queue[0].t_submit + self.max_wait
    for r in self._queue:
      if r.deadline is not None:
        t = min(t, r.deadline)
    return max(t - now, 0.0)

  def _dispatch_loop(self) -> None:
    while True:
      batch: List[_Request] = []
      with self._cond:
        while self._running:
          now = time.monotonic()
          self._expire_locked(now)
          if not self._queue:
            self._force_flush = False
            self._cond.wait()
            continue
          total = sum(r.ids.size for r in self._queue)
          oldest_wait = now - self._queue[0].t_submit
          if (total >= self.max_batch_size
              or oldest_wait >= self.max_wait or self._force_flush):
            batch = self._pop_batch_locked()
            if not self._queue:
              self._force_flush = False
            break
          self._cond.wait(timeout=self._next_wakeup_locked(now))
        if not self._running:
          return
        if batch:
          self._gen += 1
          gen = self._gen
          self._inflight = (batch, time.monotonic(), gen)
      if batch:
        try:
          self._dispatch(batch)
        except BaseException as e:  # noqa: BLE001 — the thread SURVIVES
          # _dispatch fails its batch internally for handler errors;
          # this wrapper is the backstop for failures in the dispatch
          # MACHINERY itself (which used to kill this thread silently,
          # stranding every queued request until its timeout). Fail the
          # batch with the original error; queued requests stay queued
          # — the surviving dispatcher serves them next
          for r in batch:
            _fail_future(r.future, e)
        finally:
          with self._cond:
            if self._stalled_gen == gen:
              # the wedged call came back: the engine is alive again —
              # close the circuit (its futures were already failed by
              # the watchdog; any result was discarded by done() guards)
              self._stalled = False
              self._stalled_gen = -1
              if self.metrics is not None:
                self.metrics.set_gauge('engine_stalled', 0.0)
            self._inflight = None

  def _watchdog_loop(self) -> None:
    poll = max(self.stall_timeout / 4, 0.005)
    while True:
      with self._cond:
        if not self._running:
          return
        victims: List[_Request] = []
        if self._inflight is not None and not self._stalled:
          batch, t0, gen = self._inflight
          if time.monotonic() - t0 >= self.stall_timeout:
            self._stalled = True
            self._stalled_gen = gen
            victims = list(batch) + list(self._queue)
            self._queue.clear()
            if self.metrics is not None:
              self.metrics.record_breaker_open()
              self.metrics.set_gauge('engine_stalled', 1.0)
              # queued requests never dispatched: that is load shedding
              self.metrics.record_shed(len(victims) - len(batch))
        if not victims:
          # nothing notifies during a stall (the dispatcher is wedged
          # in the handler), so waiting BEFORE failing freshly
          # collected victims would delay them a whole poll interval
          # past the documented stall budget
          self._cond.wait(timeout=poll)
      if victims:
        err = EngineStalledError(
            f'engine stalled: dispatch exceeded {self.stall_timeout}s '
            '(wedged forward / dead device); failing pending requests')
        for r in victims:
          _fail_future(r.future, err)
        try:  # postmortem flight-recorder dump (obs layer) — AFTER the
          # victims are failed: clients already past their stall budget
          # must not also wait out a registry snapshot + disk write
          from ..obs.recorder import get_recorder
          get_recorder().trip(
              'engine_stall', stall_timeout_s=self.stall_timeout,
              victims=len(victims), error=str(err))
        except Exception:  # gltlint: disable=GLT006
          pass  # the recorder itself failed; nothing left to record to

  def _dispatch(self, batch: List[_Request]) -> None:
    try:
      # shed-at-dispatch: a request whose deadline lapsed between
      # queue-expiry and here must not ride the batch — it is failed
      # NOW (before the handler runs), not after wasting a slot
      now = time.monotonic()
      live: List[_Request] = []
      for r in batch:
        if r.deadline is not None and now >= r.deadline:
          if self.metrics is not None:
            self.metrics.record_timeout()
            self.metrics.record_shed()
          _fail_future(r.future, TimeoutError(
              f'request deadline lapsed after '
              f'{now - r.t_submit:.3f}s, shed before dispatch'))
        else:
          live.append(r)
      batch = live
      if not batch:
        return
      ids = np.concatenate([r.ids for r in batch])
      if self.metrics is not None:
        # an oversized head request ships whole: count its true size as
        # the capacity so the fill ratio stays a [0, 1] utilization
        self.metrics.record_batch(ids.size,
                                  max(ids.size, self.max_batch_size))
      def run():
        with get_tracer().span('serve.flush', requests=len(batch),
                               ids=int(ids.size)):
          return self.handler(ids)
      out = batch[0].ctx.run(run) if batch[0].ctx is not None else run()
      out = np.asarray(out)
      if out.shape[0] != ids.size:
        # a real error, not an assert: under python -O a misaligned
        # handler would silently slice wrong rows to wrong callers
        raise ValueError(
            f'handler returned {out.shape[0]} rows for {ids.size} ids')
    except BaseException as e:  # noqa: BLE001 — failures go to callers
      for r in batch:
        _fail_future(r.future, e)
      return
    lo = 0
    for r in batch:
      hi = lo + r.ids.size
      try:
        if not r.future.done():
          r.future.set_result(out[lo:hi])
      except InvalidStateError:
        pass  # lost the race to the watchdog: its failure stands
      lo = hi
