"""The port's measured ceilings (``glt_tpu_torch.obs.perf``) against the
JAX package's ``glt_tpu.obs.perf``: ``roofline_report`` returns the same
dict for the same inputs; ``device_ceilings`` measures once per device
kind, then answers from its in-process cache and from the JSON file named
by ``GLT_ROOFLINE_CACHE``, republishing its two gauges every time; the
``measure_*`` probes run on the CPU at a tiny size (the card's numbers
come from chip_smoke.py's ``rooflines`` phase)."""
import json

import pytest
import torch

from glt_tpu.obs.perf import roofline_report as jax_roofline_report
from glt_tpu_torch.obs import MetricsRegistry, perf
from glt_tpu_torch.obs import (default_cache_path, device_ceilings,
                               measure_hbm_bandwidth, measure_matmul_flops,
                               roofline_report)

CEILINGS = {'device_kind': 'fake', 'hbm_bytes_per_sec': 1e9,
            'flops_per_sec': 1e12}


@pytest.mark.parametrize('kw', [
    dict(items_per_sec=1e6, bytes_per_item=100.0, flops_per_item=50.0),
    dict(items_per_sec=1e6, bytes_per_item=100.0, flops_per_item=5e6,
         item='node'),
    dict(items_per_sec=2.5e7, bytes_per_item=12.345678),
    dict(items_per_sec=3e5, flops_per_item=7.0),
    dict(items_per_sec=1e6)])
@pytest.mark.parametrize('ceilings', [
    CEILINGS, {'device_kind': 'zero', 'hbm_bytes_per_sec': 0.0,
               'flops_per_sec': 2e12}, {}])
def test_roofline_report_matches_jax(kw, ceilings):
  got = roofline_report(ceilings=ceilings, **kw)
  assert got == jax_roofline_report(ceilings=ceilings, **kw)
  if ceilings is CEILINGS and kw.get('flops_per_item') == 50.0:
    # 1e6 edges/s * 100 B = 10% of 1e9 B/s; 5e7 FLOP/s = 0.005% of 1e12
    assert got == {'device_kind': 'fake', 'hbm_bytes_per_edge': 100.0,
                   'pct_of_measured_hbm_ceiling': 10.0,
                   'flops_per_edge': 50.0,
                   'pct_of_measured_flop_ceiling': 0.005, 'bound': 'hbm'}


def test_measure_probes_on_the_cpu():
  before = torch.get_float32_matmul_precision()
  bw = measure_hbm_bandwidth('cpu', mib=1, iters=2)
  flops = measure_matmul_flops('cpu', dim=64, iters=2)
  assert bw > 0 and flops > 0
  # the GEMM probe restores the caller's float32 precision
  assert torch.get_float32_matmul_precision() == before
  torch.set_float32_matmul_precision('high')
  try:
    measure_matmul_flops('cpu', dim=32, iters=1)
    assert torch.get_float32_matmul_precision() == 'high'
  finally:
    torch.set_float32_matmul_precision(before)


def test_measure_probes_need_a_device_without_a_card():
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default device is the card')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    measure_hbm_bandwidth(mib=1)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    device_ceilings(mib=1, dim=32)


def _gauges(reg):
  return {k: v for k, v in reg.snapshot()['gauges'].items()
          if k.startswith('roofline_')}


def test_device_ceilings_cached_per_kind(tmp_path, monkeypatch):
  path = tmp_path / 'sub' / 'roofline.json'
  monkeypatch.setenv('GLT_ROOFLINE_CACHE', str(path))
  assert default_cache_path() == str(path)
  monkeypatch.setattr(perf, '_CEILINGS', {})
  calls = []
  real_bw, real_mm = perf.measure_hbm_bandwidth, perf.measure_matmul_flops

  def counted(fn, name):
    def run(*a, **k):
      calls.append(name)
      return fn(*a, **k)
    return run
  monkeypatch.setattr(perf, 'measure_hbm_bandwidth',
                      counted(real_bw, 'hbm'))
  monkeypatch.setattr(perf, 'measure_matmul_flops',
                      counted(real_mm, 'gemm'))
  reg = MetricsRegistry()
  first = device_ceilings('cpu', mib=1, dim=64, registry=reg)
  assert calls == ['hbm', 'gemm']
  assert first['device_kind'] == 'cpu' and first['platform'] == 'cpu'
  assert first['hbm_bytes_per_sec'] > 0 and first['flops_per_sec'] > 0
  doc = json.loads(path.read_text())
  assert doc == {'cpu:cpu': first}
  g = _gauges(reg)
  assert g == {
      'roofline_hbm_bytes_per_sec{device="cpu:cpu"}':
          first['hbm_bytes_per_sec'],
      'roofline_flops_per_sec{device="cpu:cpu"}': first['flops_per_sec']}
  # a second call measures nothing: the process's cache, then the file
  reg2 = MetricsRegistry()
  assert device_ceilings('cpu', registry=reg2) == first
  monkeypatch.setattr(perf, '_CEILINGS', {})
  assert device_ceilings('cpu', registry=reg2) == first
  assert calls == ['hbm', 'gemm'] and _gauges(reg2) == g
  # another kind's entry in the file is kept and never answers for this
  doc['cuda:Other Card'] = dict(first, device_kind='Other Card',
                                platform='cuda', hbm_bytes_per_sec=1.0)
  path.write_text(json.dumps(doc))
  monkeypatch.setattr(perf, '_CEILINGS', {})
  assert device_ceilings('cpu', registry=reg2) == first
  # refresh measures again and writes its entry beside the other kind's
  again = device_ceilings('cpu', refresh=True, mib=1, dim=64, registry=reg2)
  assert calls == ['hbm', 'gemm'] * 2
  assert set(json.loads(path.read_text())) == {'cpu:cpu', 'cuda:Other Card'}
  assert json.loads(path.read_text())['cpu:cpu'] == again
  # roofline_report reads the given ceilings
  cell = roofline_report(1e6, bytes_per_item=12.0, ceilings=again)
  assert cell['device_kind'] == 'cpu' and cell['bound'] == 'hbm'


def test_device_ceilings_with_an_unwritable_cache(tmp_path, monkeypatch):
  # a file where the cache's directory should be: measured, kept in the
  # process only
  blocker = tmp_path / 'blocker'
  blocker.write_text('')
  monkeypatch.setattr(perf, '_CEILINGS', {})
  entry = device_ceilings('cpu', cache_path=str(blocker / 'roofline.json'),
                          mib=1, dim=32, registry=MetricsRegistry())
  assert perf._CEILINGS == {'cpu:cpu': entry}
