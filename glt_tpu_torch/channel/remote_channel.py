"""RemoteReceivingChannel: a prefetching consumer over remote fetchers
(counterpart of glt_tpu/channel/remote_channel.py; the reference's
channel/remote_channel.py:24-131).

A fetcher is any callable that returns a SampleMessage or raises
StopIteration at the end of its server's epoch (the server-client loader
wires it to ``DistServer.fetch_one_sampled_message``). Each server has a
puller thread and a bounded queue of its own, so ``prefetch_size`` bounds
each server's readahead (a fast server cannot fill a shared window and
starve the others), and the consumer takes from the servers' queues in
turn. Every ``reset()`` starts an epoch: the earlier pullers are told to
stop and their queues dropped, so a partly consumed epoch never leaks
messages into the next.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

from .base import ChannelBase, SampleMessage
from .shm import QueueTimeoutError


class _EndOfServer:
  """What a puller queues when its server's epoch is exhausted."""


class _Puller:
  """One server's puller thread and its bounded readahead queue.
  ``avail`` is the channel's condition, notified on every put, so the
  consumer wakes on any server's arrival instead of polling."""

  def __init__(self, fn: Callable[[], SampleMessage], bound: int,
               avail: threading.Condition):
    self.q: 'queue.Queue' = queue.Queue(maxsize=bound)
    self.avail = avail
    self.stop = threading.Event()
    self.done = False  # the consumer has seen this server's end
    self.thread = threading.Thread(target=self._loop, args=(fn,),
                                   daemon=True)
    self.thread.start()

  def _loop(self, fn) -> None:
    while not self.stop.is_set():
      try:
        item = fn()
      except StopIteration:
        item = _EndOfServer()
      except Exception as e:  # the consumer raises it
        item = e
      # a bounded put that still sees the stop signal; on stop the item
      # is dropped (its epoch is being abandoned)
      while not self.stop.is_set():
        try:
          self.q.put(item, timeout=0.1)
          with self.avail:
            self.avail.notify_all()
          break
        except queue.Full:
          continue
      if isinstance(item, (_EndOfServer, Exception)):
        return


class RemoteReceivingChannel(ChannelBase):
  def __init__(self, fetch_fns: List[Callable[[], SampleMessage]],
               prefetch_size: int = 4):
    self.fetch_fns = fetch_fns
    self.prefetch_size = max(int(prefetch_size), 1)
    self._pullers: List[_Puller] = []
    self._avail = threading.Condition()
    self._rr = 0  # the next server queue to look at
    self._started = False

  def reset(self) -> None:
    """Starts an epoch of pulling; the pullers of a partly consumed epoch
    stop first and their buffered messages are dropped."""
    self._stop_pullers()
    self._started = True
    self._rr = 0
    self._pullers = [_Puller(fn, self.prefetch_size, self._avail)
                     for fn in self.fetch_fns]

  def _stop_pullers(self) -> None:
    for p in self._pullers:
      p.stop.set()
    for p in self._pullers:
      # drain, so a puller blocked on a full queue sees the stop
      while True:
        try:
          p.q.get_nowait()
        except queue.Empty:
          break
      p.thread.join(timeout=2.0)
    self._pullers = []

  def send(self, msg: SampleMessage) -> None:
    raise RuntimeError('RemoteReceivingChannel is receive-only')

  def recv(self, timeout_ms: int = 60_000) -> SampleMessage:
    if not self._started:
      self.reset()
    deadline = time.monotonic() + timeout_ms / 1000
    while True:
      live = [p for p in self._pullers if not p.done]
      if not live:
        self._started = False
        raise StopIteration
      # one pass over the live servers without blocking; when all are
      # empty, sleep on the shared condition until any puller puts
      item: Optional[object] = None
      src: Optional[_Puller] = None
      for off in range(len(live)):
        p = live[(self._rr + off) % len(live)]
        try:
          item = p.q.get_nowait()
          src = p
          self._rr = (self._rr + off + 1) % len(live)
          break
        except queue.Empty:
          continue
      if item is None:
        wait = deadline - time.monotonic()
        if wait <= 0.0:
          raise QueueTimeoutError('remote recv timed out')
        with self._avail:
          # look again under the lock: a put may have landed between the
          # pass above and taking the condition
          if all(p.q.empty() for p in live):
            self._avail.wait(timeout=wait)
        continue
      if isinstance(item, _EndOfServer):
        src.done = True
        continue
      if isinstance(item, Exception):
        # the puller has exited; its server counts as done, so the epoch
        # still ends if the consumer swallows the error and goes on
        src.done = True
        raise item
      return item

  def stop(self) -> None:
    """Abandons the current epoch: stops the pullers and drops what they
    buffered."""
    self._stop_pullers()
    self._started = False

  def empty(self) -> bool:
    return all(p.q.empty() for p in self._pullers)
