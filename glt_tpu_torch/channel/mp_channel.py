"""MpChannel: a ``multiprocessing.Queue`` channel (counterpart of
glt_tpu/channel/mp_channel.py; the reference's channel/mp_channel.py:21),
the fallback where a shared-memory ring cannot be made. Messages travel
pickled through the queue's pipe."""
from __future__ import annotations

import multiprocessing as mp
import queue as _queue

from .base import ChannelBase, SampleMessage
from .shm import QueueTimeoutError


class MpChannel(ChannelBase):
  def __init__(self, capacity: int = 64):
    self._queue = mp.get_context('spawn').Queue(maxsize=capacity)

  def send(self, msg: SampleMessage, timeout_ms: int = 60_000) -> None:
    self._queue.put(msg, timeout=timeout_ms / 1000)

  def recv(self, timeout_ms: int = 60_000) -> SampleMessage:
    try:
      return self._queue.get(timeout=timeout_ms / 1000)
    except _queue.Empty as e:
      raise QueueTimeoutError('recv timed out') from e

  def empty(self) -> bool:
    return self._queue.empty()
