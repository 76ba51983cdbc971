"""Bounded host-side task concurrency (counterpart of
glt_tpu/distributed/event_loop.py; the reference's
distributed/event_loop.py: an asyncio loop on a daemon thread with a
BoundedSemaphore's backpressure).

A thread pool with a bounded in-flight window gives the same
``add_task``/``run_task``/``wait_all`` contract without asyncio, for the
host-side surfaces: rpc fan-out (cold fetchers, producer control) and
partition-block I/O.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional


class ConcurrentEventLoop:
  """Reference event_loop.py:39-102 surface: submit up to
  ``concurrency`` tasks in flight; ``add_task`` blocks when the window
  is full (the reference's BoundedSemaphore backpressure), ``run_task``
  executes synchronously through the same window, ``wait_all`` joins
  every outstanding task (re-raising the first failure)."""

  def __init__(self, concurrency: int = 32):
    assert concurrency > 0
    self._sem = threading.BoundedSemaphore(concurrency)
    # per-instance prefix: nested submission to THIS loop deadlocks and
    # is rejected below; submission to a sibling loop stays legal
    self._thread_prefix = f'glt-evloop-{id(self):x}'
    self._pool = ThreadPoolExecutor(max_workers=concurrency,
                                    thread_name_prefix=self._thread_prefix)
    self._pending: List[Future] = []
    self._lock = threading.Lock()

  def _wrap(self, fn: Callable, args, kwargs, callback):
    try:
      result = fn(*args, **kwargs)
      # the callback runs INSIDE the worker so its exceptions land in
      # the future (add_done_callback would swallow them into the
      # executor's logger) and only a successful task invokes it
      if callback is not None:
        callback(result)
      return result
    finally:
      self._sem.release()

  def add_task(self, fn: Callable, *args,
               callback: Optional[Callable] = None, **kwargs) -> Future:
    """Submit; blocks while ``concurrency`` tasks are in flight.
    ``callback`` (if given) receives the result on success, running on
    the worker thread (its exceptions surface through the future).

    Tasks must NOT submit nested tasks through the same loop: with the
    window full, the submitting worker would block on the semaphore it
    can only release by finishing (and a fixed-size pool can deadlock
    the same way on result()); this raises instead of deadlocking.
    Use a second ConcurrentEventLoop for a nested stage.
    """
    if threading.current_thread().name.startswith(self._thread_prefix):
      raise RuntimeError(
          'nested add_task from inside a ConcurrentEventLoop task '
          'would deadlock under backpressure; use a separate loop for '
          'the nested stage')
    self._sem.acquire()
    fut = self._pool.submit(self._wrap, fn, args, kwargs, callback)
    with self._lock:
      self._pending.append(fut)
    return fut

  def run_task(self, fn: Callable, *args, **kwargs):
    """Synchronous execution through the same backpressure window.
    A failure raises HERE and is consumed — ``wait_all`` will not
    re-raise it a second time."""
    fut = self.add_task(fn, *args, **kwargs)
    try:
      return fut.result()
    finally:
      with self._lock:
        if fut in self._pending:
          self._pending.remove(fut)

  def wait_all(self) -> None:
    """Join every outstanding task; re-raises the first failure."""
    while True:
      with self._lock:
        if not self._pending:
          return
        pending, self._pending = self._pending, []
      for f in pending:
        f.result()

  def shutdown(self) -> None:
    self.wait_all()
    self._pool.shutdown(wait=True)
