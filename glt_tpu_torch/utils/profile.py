"""Throughput accounting (counterpart of the ``ThroughputMeter`` of
glt_tpu/utils/profile.py)."""
from __future__ import annotations


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
