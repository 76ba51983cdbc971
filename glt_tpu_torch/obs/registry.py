"""MetricsRegistry — thread-safe labeled counters / gauges / histograms
with JSON and Prometheus-text exposition (counterpart of
glt_tpu/obs/registry.py: the same series names, label escaping, bucket
edges and percentile rule, so an exporter scraping a process of either
package reads the same text).

Design constraints, in order:

  1. **One lock, one snapshot.** Every instrument mutation and every
     read goes through the registry's single lock, so ``snapshot()`` is
     one consistent cut — no reader can pair a fresh counter with a
     stale one for anything registered here.
  2. **Fixed memory.** Histograms are the log-spaced
     :class:`LatencyHistogram` (serving.metrics re-exports it): ~5%
     relative bucket error across 10 µs .. ~100 s,
     no reservoir, p99 independent of which samples survived.
  3. **Cheap steady state.** ``counter()``/``gauge()``/``histogram()``
     are get-or-create and return the instrument object — hot paths
     resolve once and call ``inc``/``observe`` directly (one lock hold,
     one float add).

Exposition: ``snapshot()`` (plain dict, json-dumpable), ``to_json()``,
and ``to_prometheus()`` (text format 0.0.4; histograms as summaries).
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, Optional, Tuple


class LatencyHistogram:
  """Log-spaced latency histogram: fixed memory, ~5% relative bucket
  error across 10 µs .. ~100 s."""

  #: geometric bucket layout
  _MIN = 1e-5
  _GROWTH = 1.1

  def __init__(self, num_bins: int = 170):
    self._counts = [0] * (num_bins + 2)  # [under | bins | over]
    self._num_bins = num_bins
    self.count = 0
    self.sum = 0.0
    self.max = 0.0

  def _bin(self, seconds: float) -> int:
    if seconds < self._MIN:
      return 0
    b = int(math.log(seconds / self._MIN) / math.log(self._GROWTH)) + 1
    return min(b, self._num_bins + 1)

  def observe(self, seconds: float) -> None:
    self._counts[self._bin(seconds)] += 1
    self.count += 1
    self.sum += seconds
    self.max = max(self.max, seconds)

  def count_above(self, seconds: float) -> int:
    """Observations in buckets strictly above the one holding
    ``seconds`` (bucket-resolution approximation, ~5% edge error like
    every other read here; the overflow bucket always counts). The SLO
    burn evaluator's windowed bad-event count derives from deltas of
    this."""
    return sum(self._counts[self._bin(seconds) + 1:])

  def fraction_above(self, seconds: float) -> float:
    """Fraction of all observations above ``seconds`` (0.0 when
    empty)."""
    if self.count == 0:
      return 0.0
    return self.count_above(seconds) / self.count

  def percentile(self, q: float) -> float:
    """q in [0, 100]; returns the upper edge of the bucket holding the
    q-th request (0.0 when empty). ``q=0`` returns the underflow edge
    (``_MIN``) — a lower bound on the smallest observation, consistent
    with every other bucket answer being an upper edge."""
    if self.count == 0:
      return 0.0
    target = math.ceil(self.count * q / 100.0)
    seen = 0
    for b, c in enumerate(self._counts):
      seen += c
      if seen >= target:
        if b == 0:
          return self._MIN
        if b > self._num_bins:
          # overflow bucket: it has no finite upper edge (the geometric
          # formula would even UNDERSHOOT real observations there), so
          # the tracked true max is the only honest answer
          return self.max
        return min(self._MIN * self._GROWTH ** b, self.max)
    return self.max

  @property
  def mean(self) -> float:
    return self.sum / self.count if self.count else 0.0


#: (metric name, sorted label items) — the registry's instrument key
_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Optional[dict]) -> _Key:
  if not labels:
    return (str(name), ())
  return (str(name),
          tuple(sorted((str(k), str(v)) for k, v in labels.items())))


def _escape_label_value(v) -> str:
  """Prometheus text-exposition label-value escaping (format 0.0.4):
  backslash, double-quote and newline must be escaped or a value like
  ``say "hi"`` emits malformed exposition text that scrapers reject."""
  return (str(v).replace('\\', r'\\').replace('"', r'\"')
          .replace('\n', r'\n'))


def _render_key(key: _Key) -> str:
  name, items = key
  if not items:
    return name
  inner = ','.join(f'{k}="{v}"' for k, v in items)
  return f'{name}{{{inner}}}'


class _Instrument:
  __slots__ = ('name', 'labels', '_lock')

  def __init__(self, name: str, labels: Tuple, lock: threading.Lock):
    self.name = name
    self.labels = labels
    self._lock = lock


class Counter(_Instrument):
  """Monotonic counter."""

  __slots__ = ('_value',)

  def __init__(self, name, labels, lock):
    super().__init__(name, labels, lock)
    self._value = 0.0

  def inc(self, n: float = 1.0) -> float:
    with self._lock:
      self._value += float(n)
      return self._value

  @property
  def value(self) -> float:
    with self._lock:
      return self._value


class Gauge(_Instrument):
  """Last-value-wins instrument with atomic accumulate."""

  __slots__ = ('_value',)

  def __init__(self, name, labels, lock):
    super().__init__(name, labels, lock)
    self._value = 0.0

  def set(self, value: float) -> None:
    with self._lock:
      self._value = float(value)

  def add(self, delta: float) -> float:
    """Atomic accumulate (one lock hold — a get/set pair would tear
    under concurrent writers, the add_gauge contract)."""
    with self._lock:
      self._value += float(delta)
      return self._value

  @property
  def value(self) -> float:
    with self._lock:
      return self._value


class HistogramMetric(_Instrument):
  """Registry-locked wrapper over :class:`LatencyHistogram` exposing
  its full read API (count/sum/max/mean/percentile)."""

  __slots__ = ('_hist',)

  def __init__(self, name, labels, lock, num_bins: int = 170):
    super().__init__(name, labels, lock)
    self._hist = LatencyHistogram(num_bins)

  def observe(self, seconds: float) -> None:
    with self._lock:
      self._hist.observe(seconds)

  def percentile(self, q: float) -> float:
    with self._lock:
      return self._hist.percentile(q)

  def count_above(self, seconds: float) -> int:
    with self._lock:
      return self._hist.count_above(seconds)

  def fraction_above(self, seconds: float) -> float:
    with self._lock:
      return self._hist.fraction_above(seconds)

  def count_and_above(self, seconds: float) -> Tuple[int, int]:
    """(total count, count above threshold) under ONE lock hold — the
    paired read the SLO burn evaluator windows on (reading them
    separately tears under concurrent observers and can overstate the
    bad fraction)."""
    with self._lock:
      return self._hist.count, self._hist.count_above(seconds)

  @property
  def count(self) -> int:
    with self._lock:
      return self._hist.count

  @property
  def sum(self) -> float:
    with self._lock:
      return self._hist.sum

  @property
  def max(self) -> float:
    with self._lock:
      return self._hist.max

  @property
  def mean(self) -> float:
    with self._lock:
      return self._hist.mean


class MetricsRegistry:
  """Process-local registry of named (optionally labeled) instruments.

  All instruments created by one registry share ITS lock, which is what
  makes :meth:`snapshot` a single consistent cut across every counter,
  gauge and histogram — no reader can observe counter A incremented but
  its always-paired counter B not yet.
  """

  def __init__(self, namespace: str = 'glt'):
    self.namespace = str(namespace)
    self._lock = threading.RLock()
    self._counters: Dict[_Key, Counter] = {}
    self._gauges: Dict[_Key, Gauge] = {}
    self._hists: Dict[_Key, HistogramMetric] = {}

  # -- get-or-create -----------------------------------------------------

  def counter(self, name: str, **labels) -> Counter:
    k = _key(name, labels)
    with self._lock:
      c = self._counters.get(k)
      if c is None:
        c = self._counters[k] = Counter(name, k[1], self._lock)
      return c

  def gauge(self, name: str, **labels) -> Gauge:
    k = _key(name, labels)
    with self._lock:
      g = self._gauges.get(k)
      if g is None:
        g = self._gauges[k] = Gauge(name, k[1], self._lock)
      return g

  def histogram(self, name: str, num_bins: int = 170,
                **labels) -> HistogramMetric:
    k = _key(name, labels)
    with self._lock:
      h = self._hists.get(k)
      if h is None:
        h = self._hists[k] = HistogramMetric(name, k[1], self._lock,
                                             num_bins)
      return h

  # -- one-shot conveniences ---------------------------------------------

  def inc(self, name: str, n: float = 1.0, **labels) -> float:
    return self.counter(name, **labels).inc(n)

  def set(self, name: str, value: float, **labels) -> None:
    self.gauge(name, **labels).set(value)

  def add(self, name: str, delta: float, **labels) -> float:
    return self.gauge(name, **labels).add(delta)

  def observe(self, name: str, seconds: float, **labels) -> None:
    self.histogram(name, **labels).observe(seconds)

  def get(self, name: str, default: float = 0.0, **labels) -> float:
    """Current value of a counter or gauge (counters win on a name
    collision); ``default`` when neither exists."""
    k = _key(name, labels)
    with self._lock:
      c = self._counters.get(k)
      if c is not None:
        return c._value
      g = self._gauges.get(k)
      if g is not None:
        return g._value
      return default

  # -- exposition --------------------------------------------------------

  def snapshot(self) -> dict:
    """One consistent cut of every instrument (single lock hold)."""
    with self._lock:
      counters = {_render_key(k): c._value
                  for k, c in self._counters.items()}
      gauges = {_render_key(k): g._value
                for k, g in self._gauges.items()}
      hists = {}
      for k, h in self._hists.items():
        hh = h._hist
        hists[_render_key(k)] = {
            'count': hh.count,
            'sum': hh.sum,
            'max': hh.max,
            'mean': hh.mean,
            'p50': hh.percentile(50),
            'p99': hh.percentile(99),
        }
    return {'counters': counters, 'gauges': gauges,
            'histograms': hists}

  def to_json(self, **dump_kwargs) -> str:
    return json.dumps(self.snapshot(), **dump_kwargs)

  def to_prometheus(self) -> str:
    """Prometheus text exposition (format 0.0.4). Histograms export as
    summaries (quantile series + _count/_sum) — the log-spaced buckets
    answer percentiles directly, so shipping ~170 bucket series per
    histogram buys nothing."""
    ns = self.namespace

    def fq(name: str) -> str:
      return f'{ns}_{name}' if ns else name

    def labelstr(items, extra=()) -> str:
      pairs = list(items) + list(extra)
      if not pairs:
        return ''
      return ('{' + ','.join(
          f'{k}="{_escape_label_value(v)}"' for k, v in pairs) + '}')

    with self._lock:
      lines = []
      seen_types = set()

      def header(name, typ):
        if name not in seen_types:
          seen_types.add(name)
          lines.append(f'# TYPE {name} {typ}')

      for k, c in sorted(self._counters.items()):
        name = fq(k[0])
        header(name, 'counter')
        lines.append(f'{name}{labelstr(k[1])} {c._value:.17g}')
      for k, g in sorted(self._gauges.items()):
        name = fq(k[0])
        header(name, 'gauge')
        lines.append(f'{name}{labelstr(k[1])} {g._value:.17g}')
      for k, h in sorted(self._hists.items()):
        name = fq(k[0])
        hh = h._hist
        header(name, 'summary')
        for q in (0.5, 0.9, 0.99):
          lines.append(
              f'{name}{labelstr(k[1], [("quantile", q)])} '
              f'{hh.percentile(q * 100):.17g}')
        lines.append(f'{name}_sum{labelstr(k[1])} {hh.sum:.17g}')
        lines.append(f'{name}_count{labelstr(k[1])} {hh.count}')
    return '\n'.join(lines) + '\n'


#: process-global default registry — the ONE surface subsystems publish
#: into unless handed an explicit registry
_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
  return _REGISTRY


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
  """Swap the process-global registry (tests / embedding apps); returns
  the previous one so callers can restore it."""
  global _REGISTRY
  prev, _REGISTRY = _REGISTRY, registry
  return prev
