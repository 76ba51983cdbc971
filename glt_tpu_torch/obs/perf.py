"""Measured device ceilings (counterpart of the measured-roofline half of
glt_tpu/obs/perf.py).

A throughput quoted against a data-sheet ceiling is not grounded in the
card it ran on. :func:`device_ceilings` measures the pair a roofline needs
once per device kind -- the device memory's stream rate (``2 * x + y``
over arrays far larger than the L2) and the float32 GEMM rate (TF32 off,
what the port's float32 layers get) -- caches them as JSON
(``GLT_ROOFLINE_CACHE``) and publishes the ``roofline_hbm_bytes_per_sec``
and ``roofline_flops_per_sec`` gauges. :func:`roofline_report` restates
an items/s figure as a share of those ceilings.

The JAX module's compile accounting (``count_compile``,
``compile_counts``, ``xla_cost_enabled``, ``instrument_compiled``) has no
counterpart: the port compiles no programs.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Optional

import torch

from ..utils import resolve_device
from ..utils.env import knob
from .registry import MetricsRegistry, get_registry

logger = logging.getLogger(__name__)


def default_cache_path() -> str:
  """``GLT_ROOFLINE_CACHE``, else ``~/.cache/glt_tpu_torch/roofline.json``."""
  return knob(
      'GLT_ROOFLINE_CACHE',
      os.path.join(os.path.expanduser('~'), '.cache', 'glt_tpu_torch',
                   'roofline.json'))


def _best_seconds(fn: Callable[[], object], device: torch.device,
                  iters: int) -> float:
  """The fastest of ``iters`` calls of ``fn`` after one untimed call: on a
  card each call between two CUDA events, on the CPU by the host clock.
  The best, not the median: every disturbance adds time, so the least is
  the ceiling."""
  fn()
  best = float('inf')
  if device.type == 'cuda':
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(max(iters, 1)):
      start.record()
      fn()
      end.record()
      end.synchronize()
      best = min(best, start.elapsed_time(end) / 1e3)
    return best
  for _ in range(max(iters, 1)):
    t0 = time.perf_counter()
    fn()
    best = min(best, time.perf_counter() - t0)
  return best


def measure_hbm_bandwidth(device=None, mib: int = 256,
                          iters: int = 5) -> float:
  """The device memory's stream rate in bytes/s: ``2.0 * x + y`` over two
  float32 arrays of ``mib`` MiB each into a third (one ``torch.add`` with
  ``alpha``: two reads and a write, 12 B an element), best of ``iters``.
  ``device`` defaults to the card (raises without one)."""
  dev = resolve_device(device)
  n = max(mib, 1) * (1 << 20) // 4
  x = torch.ones(n, dtype=torch.float32, device=dev)
  y = torch.zeros(n, dtype=torch.float32, device=dev)
  out = torch.empty_like(x)
  best = _best_seconds(lambda: torch.add(y, x, alpha=2.0, out=out), dev,
                       iters)
  return 3.0 * 4.0 * n / best


def measure_matmul_flops(device=None, dim: int = 2048,
                         iters: int = 5) -> float:
  """The float32 GEMM rate in FLOP/s: a ``[dim, dim] @ [dim, dim]``
  product (``2 * dim ** 3`` operations) with TF32 off (float32
  ``'highest'`` precision for the call, then the caller's setting back),
  best of ``iters``. ``device`` defaults to the card (raises without
  one)."""
  dev = resolve_device(device)
  a = torch.ones((dim, dim), dtype=torch.float32, device=dev)
  b = torch.ones((dim, dim), dtype=torch.float32, device=dev)
  out = torch.empty_like(a)
  precision = torch.get_float32_matmul_precision()
  torch.set_float32_matmul_precision('highest')
  try:
    best = _best_seconds(lambda: torch.mm(a, b, out=out), dev, iters)
  finally:
    torch.set_float32_matmul_precision(precision)
  return 2.0 * dim ** 3 / best


#: the ceilings measured or read in this process, by device kind, so one
#: process measures once even when the disk cache cannot be written
_CEILINGS: dict = {}


def _kind(dev: torch.device):
  """``(key, platform, device kind)``: ``cuda:<card name>`` or
  ``cpu:cpu``."""
  if dev.type == 'cuda':
    name = torch.cuda.get_device_name(dev)
    return f'cuda:{name}', 'cuda', name
  return f'{dev.type}:{dev.type}', dev.type, dev.type


def device_ceilings(device=None, refresh: bool = False,
                    cache_path: Optional[str] = None,
                    mib: int = 256, dim: int = 2048,
                    registry: Optional[MetricsRegistry] = None) -> dict:
  """The measured ceilings of ``device`` (default: the card; raises
  without one), cached by device kind.

  Returns ``{'device_kind', 'platform', 'hbm_bytes_per_sec',
  'flops_per_sec', 'measured_at'}``. Looked up in this process's cache,
  then in the JSON file ``cache_path`` (default
  :func:`default_cache_path`), keyed ``cuda:<card name>`` so one card's
  entry never answers for another; measured (:func:`measure_hbm_bandwidth`
  at ``mib``, :func:`measure_matmul_flops` at ``dim``) when neither has
  it or ``refresh`` is set, and then written back. Every call republishes
  the ``roofline_hbm_bytes_per_sec`` and ``roofline_flops_per_sec``
  gauges (label ``device``) on ``registry`` (default: the process
  registry)."""
  dev = resolve_device(device)
  key, platform, name = _kind(dev)
  path = cache_path or default_cache_path()
  entry = None
  if not refresh:
    entry = _CEILINGS.get(key)
    if entry is None and os.path.exists(path):
      try:
        with open(path) as f:
          entry = json.load(f).get(key)
      except (OSError, ValueError):
        entry = None
  if entry is None:
    entry = {
        'device_kind': name,
        'platform': platform,
        'hbm_bytes_per_sec': measure_hbm_bandwidth(dev, mib=mib),
        'flops_per_sec': measure_matmul_flops(dev, dim=dim),
        'measured_at': time.time(),
    }
    try:
      os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
      doc = {}
      if os.path.exists(path):
        try:
          with open(path) as f:
            doc = json.load(f)
        except (OSError, ValueError):
          doc = {}
      doc[key] = entry
      with open(path, 'w') as f:
        json.dump(doc, f, indent=2)
    except OSError as e:   # an unwritable cache: this process's cache only
      logger.debug('roofline cache %s unwritable: %s', path, e)
  _CEILINGS[key] = entry
  reg = registry or get_registry()
  reg.set('roofline_hbm_bytes_per_sec', entry['hbm_bytes_per_sec'],
          device=key)
  reg.set('roofline_flops_per_sec', entry['flops_per_sec'], device=key)
  return entry


def roofline_report(items_per_sec: float,
                    bytes_per_item: Optional[float] = None,
                    flops_per_item: Optional[float] = None,
                    ceilings: Optional[dict] = None,
                    item: str = 'edge') -> dict:
  """A throughput against the measured ceilings (``ceilings``, default
  :func:`device_ceilings` of the card)::

      {'device_kind': the ceilings' device,
       'hbm_bytes_per_<item>': bytes moved an item,
       'flops_per_<item>': operations an item,
       'pct_of_measured_hbm_ceiling': 100 * rate * bytes / stream rate,
       'pct_of_measured_flop_ceiling': 100 * rate * flops / GEMM rate,
       'bound': 'hbm' or 'flops' (the larger share)}

  Keys whose inputs are missing (or whose ceiling is 0) are left out,
  as in the JAX function."""
  if ceilings is None:
    ceilings = device_ceilings()
  out: dict = {'device_kind': ceilings.get('device_kind', '?')}
  pct_hbm = pct_flop = None
  if bytes_per_item is not None:
    out[f'hbm_bytes_per_{item}'] = round(float(bytes_per_item), 2)
    bw = ceilings.get('hbm_bytes_per_sec') or 0.0
    if bw > 0:
      pct_hbm = 100.0 * items_per_sec * bytes_per_item / bw
      out['pct_of_measured_hbm_ceiling'] = round(pct_hbm, 3)
  if flops_per_item is not None:
    out[f'flops_per_{item}'] = round(float(flops_per_item), 2)
    peak = ceilings.get('flops_per_sec') or 0.0
    if peak > 0:
      pct_flop = 100.0 * items_per_sec * flops_per_item / peak
      out['pct_of_measured_flop_ceiling'] = round(pct_flop, 3)
  if pct_hbm is not None or pct_flop is not None:
    out['bound'] = ('hbm' if (pct_hbm or 0.0) >= (pct_flop or 0.0)
                    else 'flops')
  return out
