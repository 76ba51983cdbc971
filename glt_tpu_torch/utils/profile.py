"""Timing, throughput accounting and profiler traces (counterpart of
glt_tpu/utils/profile.py: ``Timer``, ``ThroughputMeter``, ``trace``,
``annotate``)."""
from __future__ import annotations

import contextlib
import os
import time


class Timer:
  """Wall-clock timer that can synchronise outstanding device work.

  ``elapsed`` accumulates across start/stop intervals; each ``stop()``
  consumes the matching ``start()``, so a stop without a running interval
  raises a clear RuntimeError."""

  def __init__(self):
    self.reset()

  def reset(self):
    self._t0 = None
    self.elapsed = 0.0

  @property
  def running(self) -> bool:
    return self._t0 is not None

  def start(self):
    # a restart (incl. reusing one Timer across `with` blocks) restamps
    # the interval; the accumulated elapsed stays
    self._t0 = time.perf_counter()
    return self

  def stop(self, sync=None) -> float:
    """End the interval; ``sync`` (a tensor) first waits for the work
    queued on its CUDA device, where the JAX timer blocks on an array."""
    if self._t0 is None:
      raise RuntimeError(
          'Timer.stop() without a running interval: call start() (or '
          'enter the context manager) first; each stop() consumes its '
          'start()')
    if sync is not None and getattr(sync, 'is_cuda', False):
      import torch
      torch.cuda.synchronize(sync.device)
    self.elapsed += time.perf_counter() - self._t0
    self._t0 = None
    return self.elapsed

  def __enter__(self):
    return self.start()

  def __exit__(self, *exc):
    if self._t0 is not None:  # tolerate an explicit stop() in the body
      self.stop()


class ThroughputMeter:
  """Accumulates (count, seconds) and reports the rate: the reference's
  'Sampled Edges per secs' metric."""

  def __init__(self, unit: str = 'edges'):
    self.unit = unit
    self.count = 0
    self.seconds = 0.0

  def update(self, count: int, seconds: float):
    self.count += int(count)
    self.seconds += seconds

  @property
  def rate(self) -> float:
    return self.count / self.seconds if self.seconds > 0 else 0.0

  def report(self) -> str:
    r = self.rate
    if r >= 1e6:
      return f'{r / 1e6:.2f}M {self.unit}/s'
    if r >= 1e3:
      return f'{r / 1e3:.2f}K {self.unit}/s'
    return f'{r:.2f} {self.unit}/s'


@contextlib.contextmanager
def trace(log_dir: str):
  """A ``torch.profiler`` session over the block (the host and, where
  there is one, the card), written into ``log_dir`` as a Chrome trace
  (``trace.json``; chrome://tracing or Perfetto read it)."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  acts = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    acts.append(ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  with profile(activities=acts) as prof:
    yield
  prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


@contextlib.contextmanager
def annotate(name: str):
  """A named range inside a trace (``torch.profiler.record_function``)."""
  from torch.profiler import record_function
  with record_function(name):
    yield
