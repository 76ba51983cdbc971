"""The port's observability layer (glt_tpu_torch.obs, utils/env.py,
utils/profile.Timer) against the JAX package's (glt_tpu.obs): the same
scripted calls, made from one numpy seed, through both.

- registry: equal JSON ``snapshot()`` and equal Prometheus text, label
  escaping included; histogram percentiles equal exactly (both bin the
  same float64 values by the same rule);
- tracer: nesting, Chrome export fields, remote-span reopen, the disabled
  no-op, device-sync sampling, the ring buffer, the stage histograms;
- rpc trace context across the packages: a port client's span id is the
  parent of a JAX server's handler span, and the reverse; the built-in
  ``_obs`` callee answers either package's harvester; a malformed context
  is still answered;
- SLO recorder: ``parse_slo_env`` and ``SloBurnEvaluator.evaluate`` equal
  on the same specs and observations (tolerance: exact);
- flight recorder: the same events, trips and postmortem keys.
"""
import json

import numpy as np
import pytest

from glt_tpu import obs as jobs
from glt_tpu.distributed import rpc as jrpc
from glt_tpu.utils import env as jenv
from glt_tpu_torch import obs as pobs
from glt_tpu_torch.distributed import rpc as prpc
from glt_tpu_torch.utils import env as penv
from glt_tpu_torch.utils.profile import Timer

OBS = {'jax': jobs, 'port': pobs}
RPC = {'jax': jrpc, 'port': prpc}


@pytest.fixture
def tracers():
  """Both process tracers, force-restored to disabled and empty."""
  ts = [jobs.get_tracer(), pobs.get_tracer()]
  saved = [(t.enabled, t._sample) for t in ts]
  for t in ts:
    t.clear()
  yield ts
  for t, (was, sample) in zip(ts, saved):
    t.enabled, t._sample = was, sample
    t.clear()


def _script(mod, seed=0):
  """A seeded script of counter / gauge / histogram calls (labels with
  quotes, backslashes and newlines among them) on a fresh registry."""
  rng = np.random.default_rng(seed)
  r = mod.MetricsRegistry(namespace='glt')
  labels = [{}, {'stage': 'sample'}, {'shard': 's"0'},
            {'path': 'a\\b\nc', 'z': 1}]
  for _ in range(200):
    kind = rng.integers(0, 5)
    lab = labels[rng.integers(0, len(labels))]
    name = ['requests_total', 'depth', 'lat_seconds'][rng.integers(0, 3)]
    if kind == 0:
      r.inc(name + '_c', float(rng.integers(1, 4)), **lab)
    elif kind == 1:
      r.set(name + '_g', float(rng.standard_normal()), **lab)
    elif kind == 2:
      r.add(name + '_g', float(rng.standard_normal()), **lab)
    else:
      # 1 us .. 1000 s: underflow, the bins and the overflow bucket
      r.observe(name + '_h', float(10 ** rng.uniform(-6, 3)), **lab)
  return r


def test_registry_snapshot_and_prometheus_equal_jax():
  for seed in range(3):
    j, p = _script(jobs, seed), _script(pobs, seed)
    assert p.snapshot() == j.snapshot()
    assert p.to_prometheus() == j.to_prometheus()
    assert json.loads(p.to_json()) == json.loads(j.to_json())
    assert p.get('requests_total_c', stage='sample') == \
        j.get('requests_total_c', stage='sample')
  text = _script(pobs, 0).to_prometheus()
  assert r'shard="s\"0"' in text and r'path="a\\b\nc"' in text


def test_latency_histogram_percentiles_equal_jax():
  rng = np.random.default_rng(5)
  hs = [jobs.LatencyHistogram(), pobs.LatencyHistogram()]
  for v in 10 ** rng.uniform(-6, 3, 2000):
    for h in hs:
      h.observe(float(v))
  for q in (0, 1, 50, 90, 99, 99.9, 100):
    assert hs[1].percentile(q) == hs[0].percentile(q)
  for t in (1e-4, 0.01, 1.0):
    assert hs[1].count_above(t) == hs[0].count_above(t)
    assert hs[1].fraction_above(t) == hs[0].fraction_above(t)
  assert (hs[1].count, hs[1].sum, hs[1].max) == \
      (hs[0].count, hs[0].sum, hs[0].max)


def test_env_knobs_parse_as_jax(monkeypatch):
  cases = [('1', False), ('off', True), ('zillion', True), ('3', 7),
           ('x', 7), ('0.25', 0.5), ('', 0.5), ('abc', 'd')]
  for raw, default in cases:
    monkeypatch.setenv('GLT_TEST_KNOB', raw)
    with pytest.warns(RuntimeWarning) if raw in ('zillion', 'x') \
        else _no_warning():
      got = penv.knob('GLT_TEST_KNOB', default)
    assert got == jenv.knob('GLT_TEST_KNOB', default)
  assert penv.parse_bool(' Yes ') is jenv.parse_bool(' Yes ') is True
  assert penv.raw('GLT_TEST_KNOB') == 'abc'


class _no_warning:
  def __enter__(self):
    import warnings
    self._cm = warnings.catch_warnings()
    self._cm.__enter__()
    warnings.simplefilter('error')

  def __exit__(self, *exc):
    self._cm.__exit__(*exc)
    return False


def _traced_shape(tracer):
  """One nested script through ``tracer``: the finished events with the
  process-specific values (ids, clock, pid, tid) cut out."""
  tracer.enable()
  with tracer.span('root', cat='test', k=1) as root:
    with tracer.span('child') as child:
      assert child.trace_id == root.trace_id
      assert tracer.current_context() == child
    with tracer.span('child2'):
      pass
  tracer.disable()
  evs = tracer.events(trace_id=root.trace_id)
  by = {e['name']: e for e in evs}
  assert by['child']['args']['parent_id'] == root.span_id
  assert by['child2']['args']['parent_id'] == root.span_id
  assert 'parent_id' not in by['root']['args']
  doc = tracer.chrome_trace(trace_id=root.trace_id)
  json.dumps(doc)
  return ([(e['name'], e['cat'], e['ph'], sorted(e), sorted(e['args']))
           for e in evs],
          sorted(doc), [sorted(m) for m in doc['traceEvents']
                        if m['ph'] == 'M'])


def test_tracer_nesting_and_chrome_export_match_jax(tracers):
  j, p = tracers
  assert _traced_shape(p) == _traced_shape(j)


def test_tracer_disabled_is_the_cached_noop(tracers):
  _, p = tracers
  cm = p.span('x')
  assert p.span('y') is cm
  with cm as ctx:
    assert ctx is None
  assert p.events() == []


def test_tracer_remote_span_reopens_context(tracers):
  for t in tracers:
    assert not t.enabled
    with t.remote_span('rpc.server:f', ('t1234', 'c9')):
      with t.span('inner'):    # disabled: the inner span is a no-op
        pass
    (ev,) = t.events()
    assert ev['args']['trace_id'] == 't1234'
    assert ev['args']['parent_id'] == 'c9'
    assert ev['cat'] == 'rpc'


def test_tracer_sync_sampling_marks_synced(tracers):
  import torch
  _, p = tracers
  p.enable(sample=1.0)
  holder = {}
  with p.span('dispatch', sync=lambda: holder.get('x')):
    holder['x'] = torch.arange(8) * 2
  (ev,) = p.events()
  assert ev['args'].get('synced') is True
  p.clear()
  p.enable(sample=0.0)
  with p.span('dispatch', sync=lambda: holder['x']):
    pass
  (ev,) = p.events()
  assert 'synced' not in ev['args']


@pytest.mark.parametrize('which', ['jax', 'port'])
def test_tracer_ring_buffer_and_stage_histograms(which):
  mod = OBS[which]
  reg = mod.MetricsRegistry()
  t = mod.Tracer(enabled=True, buffer=16, registry=reg)
  for i in range(40):
    with t.span('gather.features' if i % 2 else f's{i}'):
      pass
  assert len(t.events()) == 16 and t.dropped == 24
  snap = reg.snapshot()
  assert snap['histograms']['stage_seconds{stage="gather.features"}'][
      'count'] == 20
  assert snap['counters']['obs_spans_dropped_total'] == 24


@pytest.mark.parametrize('client,server', [('port', 'jax'), ('jax', 'port'),
                                           ('port', 'port')])
def test_rpc_trace_context_crosses_packages(tracers, client, server):
  """The client package's ``rpc.client`` span is the parent of the server
  package's ``rpc.server`` span, one trace id over both; the server's
  ``_obs`` callee answers the client package's harvester."""
  ctracer = OBS[client].get_tracer()
  stracer = OBS[server].get_tracer()
  srv = RPC[server].RpcServer()
  srv.register('mul', lambda a, b: a * b)
  cli = RPC[client].RpcClient(srv.host, srv.port)
  try:
    assert cli.request('mul', 3, 4) == 12      # untraced: no spans
    assert ctracer.events() == [] and stracer.events() == []
    ctracer.enable()
    with ctracer.span('root') as root:
      assert cli.request('mul', 5, 6) == 30
      assert cli.async_request('mul', 2, 2).result(timeout=30) == 4
    ctracer.disable()
    cevs = {e['name']: e for e in ctracer.events(trace_id=root.trace_id)
            if e['name'] != 'rpc.server:mul'}
    sevs = [e for e in stracer.events(trace_id=root.trace_id)
            if e['name'] == 'rpc.server:mul']
    assert len(sevs) == 2
    assert cevs['rpc.client:mul']['args']['parent_id'] == root.span_id
    client_spans = {e['args']['span_id'] for e in ctracer.events()
                    if e['name'] == 'rpc.client:mul'}
    assert {e['args']['parent_id'] for e in sevs} == client_spans
    out = OBS[client].collect_endpoint_obs(srv.host, srv.port)
    assert any(e['name'] == 'rpc.server:mul' for e in out['events'])
    assert set(out['metrics']) == {'counters', 'gauges', 'histograms'}
  finally:
    cli.close()
    srv.stop()


def test_malformed_trace_context_is_answered(tracers):
  import socket
  srv = prpc.RpcServer()
  srv.register('add', lambda a, b: a + b)
  try:
    for ctx in ('not-a-pair', ('only-one',), 42, ('a', 'b', 'c')):
      with socket.create_connection((srv.host, srv.port), timeout=10) as s:
        prpc._send_msg(s, ('add', (1, 2), {}, None, ctx))
        assert prpc._recv_msg(s) == ('ok', 3)
    assert pobs.get_tracer().events() == []   # no context, no span
  finally:
    srv.stop()


SLO_SPECS = [
    'serve_p99:serving_latency_seconds:0.25:0.99',
    ' a:stage_seconds{stage=serve.infer}:0.01 ; b:h{x="1",y=2}:1e-3:0.9;',
    '',
]


def test_parse_slo_env_matches_jax(monkeypatch):
  import dataclasses
  for spec in SLO_SPECS:
    got = [dataclasses.asdict(p) for p in pobs.parse_slo_env(spec)]
    want = [dataclasses.asdict(p) for p in jobs.parse_slo_env(spec)]
    assert got == want
  monkeypatch.setenv('GLT_OBS_SLO', SLO_SPECS[1])
  assert [p.name for p in pobs.parse_slo_env()] == ['a', 'b']
  for bad in ('x:y', 'x:y:notanumber'):
    with pytest.raises(ValueError):
      pobs.parse_slo_env(bad)


def _burns(mod, seed=0):
  """Three evaluation windows of seeded observations; the burns each
  evaluate() returned and the slo_burn gauges."""
  rng = np.random.default_rng(seed)
  reg = mod.MetricsRegistry()
  rec = mod.FlightRecorder(registry=reg, tracer=mod.Tracer(registry=reg))
  ev = mod.SloBurnEvaluator(mod.parse_slo_env(
      'fast:lat:0.01:0.99;tail:lat{view=s0}:0.2:0.9'), registry=reg,
      recorder=rec, trip_above=5.0)
  out = []
  for window in range(3):
    for v in 10 ** rng.uniform(-4, 0, 50 * (window + 1)):
      reg.observe('lat', float(v))
      reg.observe('lat', float(v) * 2, view='s0')
    out.append(ev.evaluate())
  out.append(ev.evaluate())             # an empty window burns nothing
  return out, reg.snapshot()['gauges'], [
      (e['kind'], e.get('slo')) for e in rec.events()]


def test_slo_burn_evaluator_matches_jax():
  got, want = _burns(pobs), _burns(jobs)
  assert got == want
  assert got[0][-1] == {'fast': 0.0, 'tail': 0.0}
  assert any(b['fast'] > 1.0 for b in got[0][:3])


@pytest.mark.parametrize('which', ['jax', 'port'])
def test_flight_recorder_trip_and_dump(tmp_path, which):
  mod = OBS[which]
  reg = mod.MetricsRegistry()
  tr = mod.Tracer(enabled=True, registry=reg)
  rec = mod.FlightRecorder(dump_dir=str(tmp_path), registry=reg, tracer=tr,
                           min_dump_interval_s=60.0)
  rec._exit_hooked = True   # keep the test process's excepthook as it was
  with tr.span('serve.flush'):
    pass
  rec.record('breaker_state', peer='p0')
  reg.inc('x_total', 3)
  path = rec.trip('engine_stall', victims=2)
  assert rec.trip('engine_stall', victims=1) is None   # rate-limited
  with open(path) as f:
    doc = json.load(f)
  assert sorted(doc) == ['counters_delta', 'events', 'pid', 'reason',
                         'registry', 'spans', 'ts']
  assert doc['reason'] == 'engine_stall'
  assert [e['kind'] for e in doc['events']] == ['breaker_state',
                                                'engine_stall']
  assert doc['spans'][0]['name'] == 'serve.flush'
  assert doc['counters_delta']['x_total'] == 3
  assert reg.get('flight_trips_total', reason='engine_stall') == 2
  assert reg.get('flight_dumps_total') == 1 and rec.dumps == 1


def test_timer_accumulates_and_refuses_a_stop_without_start():
  import torch
  t = Timer()
  with pytest.raises(RuntimeError, match='without a running interval'):
    t.stop()
  with t:
    pass
  first = t.elapsed
  t.start()
  assert t.running
  total = t.stop(sync=torch.zeros(3))     # a CPU tensor: nothing to wait on
  assert total >= first >= 0.0 and not t.running
