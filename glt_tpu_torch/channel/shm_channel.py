"""ShmChannel: a cross-process channel over the port's shared-memory ring
(counterpart of glt_tpu/channel/shm_channel.py; the reference's
channel/shm_channel.py:24-53 over csrc/shm_queue.cc).

A message crosses as its packed bytes (``pack_message``): one copy into
the ring, one out, and the receiver's tensors view the block it dequeued.
``pin_memory`` is accepted and ignored, as in the JAX package: the
consumer copies each tensor to its card once (``message_to_batch``).
"""
from __future__ import annotations

from .base import ChannelBase, SampleMessage, pack_message, unpack_message
from .shm import ShmQueue


class ShmChannel(ChannelBase):
  """A picklable channel: a spawned process that unpickles it attaches to
  the same ring. ``close`` in the creating process removes the segment
  once every process has detached."""

  def __init__(self, capacity_bytes: int = 128 * 1024 * 1024,
               pin_memory: bool = False, shm_queue: ShmQueue = None):
    self._queue = shm_queue or ShmQueue(capacity_bytes)
    del pin_memory  # accepted for parity

  def send(self, msg: SampleMessage, timeout_ms: int = 60_000) -> None:
    self._queue.enqueue(pack_message(msg), timeout_ms)

  def recv(self, timeout_ms: int = 60_000) -> SampleMessage:
    return unpack_message(self._queue.dequeue(timeout_ms))

  def empty(self) -> bool:
    return self._queue.empty()

  def close(self) -> None:
    self._queue.close()

  def unlink(self) -> None:
    """Removes the ring once every process has detached or died
    (:meth:`ShmQueue.unlink`)."""
    self._queue.unlink()

  def __reduce__(self):
    return (ShmChannel, (0, False, self._queue))
