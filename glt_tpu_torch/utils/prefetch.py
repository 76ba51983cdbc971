"""Host-side prefetching iterator (counterpart of
glt_tpu/utils/prefetch.py).

A small worker thread materialises the next items of an iterable while
the consumer works on the current one: the superstep trainer's cold-row
streaming (``parallel.SPMDSageTrainStep(cold_streaming=True).run_epoch``)
samples window N+1 and gathers its cold rows on the host while the card
trains on window N.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class PrefetchIterator:
  """Wraps any iterable; materialises up to ``depth`` items ahead on a
  worker thread. Exceptions propagate to the consumer. Closing or
  abandoning the consumer generator stops and joins the worker (bounded
  wait), so the references it holds (device tensors, pinned buffers) go
  promptly."""

  _END = object()

  #: how long the consumer's cleanup waits for the worker to see the
  #: stop flag. The worker polls it every 0.1 s between queue puts; a
  #: longer wait happens only while it is blocked inside the wrapped
  #: iterable, and then cleanup leaves the daemon thread to finish that
  #: one item on its own.
  JOIN_TIMEOUT = 5.0

  def __init__(self, iterable: Iterable, depth: int = 2):
    self.iterable = iterable
    self.depth = max(1, int(depth))
    #: the most recent ``__iter__``'s worker (introspection, tests)
    self.worker_thread = None

  def __iter__(self) -> Iterator:
    q: 'queue.Queue' = queue.Queue(maxsize=self.depth)
    stop = threading.Event()

    def _put(item) -> bool:
      # bounded puts poll the stop flag, so an abandoned consumer cannot
      # leave the worker blocked for ever holding item references
      while not stop.is_set():
        try:
          q.put(item, timeout=0.1)
          return True
        except queue.Full:
          continue
      return False

    def worker():
      try:
        for item in self.iterable:
          if not _put(item):
            return
      except BaseException as e:  # surfaced to the consumer, re-raised
        _put(e)
        return
      _put(self._END)

    t = threading.Thread(target=worker, daemon=True)
    self.worker_thread = t
    t.start()
    try:
      while True:
        item = q.get()
        if item is self._END:
          return
        if isinstance(item, BaseException):
          raise item
        yield item
    finally:
      stop.set()
      t.join(timeout=self.JOIN_TIMEOUT)


def prefetch(iterable: Iterable, depth: int = 2) -> PrefetchIterator:
  return PrefetchIterator(iterable, depth)
