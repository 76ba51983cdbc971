"""The port's serving front ends (glt_tpu_torch.serving: MicroBatcher,
ServingMetrics, ServingServer/ServingClient, the engine's validation,
stale tier and invalidation, utils/checkpoint, the serve_sage_products
example) against the JAX package's, on the CPU.

- the batcher scenarios of tests/test_serving.py:234-348 (merged batches,
  deadline flush, empty flush, request timeout, backpressure, oversized
  head, error propagation) and the stall watchdog run through both
  batchers with one deterministic handler: equal dispatch sequences,
  outcomes and counters;
- ``ServingMetrics``: the same record_* script gives equal ``snapshot()``
  keys and values (``qps`` reads the clock: compared as a key only);
- a port ``ServingServer`` answers a JAX ``ServingClient`` and the
  reverse, with equal rows, ``stats()`` keys, ``ping()`` and errors;
  identity engines (a model returning the seed rows of ``batch.x``, the
  JAX tests' ``apply_fn=lambda p, b: b.x``) over tests/fixtures.py's ring,
  whose feature row i is ``[i] * dim``, so a row names the node it is;
- the slice as a whole: a 2-layer GraphSAGE at the JAX package's
  parameters (``models/convert.py``), served by a port ``ServingServer``
  and a JAX one over the ring (every degree 2, fanouts [2, 2]: both
  samplers take every neighbour, so logits do not depend on the draws),
  agrees within 1e-5;
- ``init_client`` builds its ``ServingMetrics`` as JAX's does.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fixtures import ring_dataset as jax_ring_dataset
from fixtures import ring_edges
from glt_tpu import serving as jserving
from glt_tpu.obs.recorder import FlightRecorder as JaxFlightRecorder
from glt_tpu.obs.recorder import set_recorder as jax_set_recorder
from glt_tpu_torch import serving as pserving
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.obs.recorder import FlightRecorder, set_recorder

SERVING = {'jax': jserving, 'port': pserving}
FEAT_DIM, FANOUT, BUCKETS = 8, [2], (8,)


class SeedRows(nn.Module):
  """The identity engine's model: the seed rows of ``batch.x``."""

  def forward(self, batch):
    return batch.x[:batch.batch_size]


def port_ring_dataset(num_nodes=40, feat_dim=FEAT_DIM):
  """tests/fixtures.py's ring (feature row i == [i] * dim) on the CPU."""
  rows, cols, eids = ring_edges(num_nodes)
  ds = Dataset().init_graph(np.stack([rows, cols]), edge_ids=eids,
                            num_nodes=num_nodes, device='cpu')
  ds.init_node_features(np.tile(np.arange(num_nodes, dtype=np.float32)
                                [:, None], (1, feat_dim)), device='cpu')
  return ds


def identity_engine(which, num_nodes=40, sampler=None, data=None, **kw):
  """Engine whose output rows ARE the seed feature rows."""
  if which == 'jax':
    ds = data if data is not None else jax_ring_dataset(
        num_nodes=num_nodes, feat_dim=FEAT_DIM)
    return jserving.InferenceEngine(ds, None, None, FANOUT, buckets=BUCKETS,
                                    apply_fn=lambda p, b: b.x,
                                    sampler=sampler, **kw)
  ds = data if data is not None else port_ring_dataset(num_nodes)
  return pserving.InferenceEngine(ds, SeedRows(), None, FANOUT,
                                  buckets=BUCKETS, sampler=sampler,
                                  device='cpu', **kw)


# -- the batcher ------------------------------------------------------------

def _echo(calls):
  def handler(ids):
    calls.append(np.asarray(ids).tolist())
    return np.asarray(ids, np.float32)[:, None] * 2
  return handler


def _outcome(fut):
  try:
    return ('ok', np.asarray(fut.result(timeout=10)).ravel().tolist())
  except Exception as e:  # the outcome is what is compared
    return (type(e).__name__, str(e).split(' after ')[0])


def _counters(m):
  return {k: v for k, v in m.snapshot().items()
          if k in ('batches', 'timeouts', 'rejected', 'shed',
                   'breaker_opens', 'batch_fill_ratio')}


def _merged(mod):
  calls = []
  b = mod.MicroBatcher(_echo(calls), max_batch_size=8, max_wait_ms=60.0)
  try:
    futs = [b.submit([1, 2]), b.submit([3]), b.submit([4, 5, 6, 7, 8])]
    return calls, [_outcome(f) for f in futs]
  finally:
    b.stop()


def _deadline_flush(mod):
  calls = []
  b = mod.MicroBatcher(_echo(calls), max_batch_size=64, max_wait_ms=20.0)
  try:
    t0 = time.monotonic()
    out = _outcome(b.submit([9]))
    return calls, out, time.monotonic() - t0 >= 0.015
  finally:
    b.stop()


def _empty_flush(mod):
  calls = []
  b = mod.MicroBatcher(_echo(calls), max_batch_size=64, max_wait_ms=200.0)
  try:
    out = _outcome(b.submit([1], timeout_ms=10.0))
    time.sleep(0.05)
    return calls, out, b.depth
  finally:
    b.stop()


def _slow(release):
  def slow(ids):
    release.wait(5)
    return np.asarray(ids, np.float32)[:, None]
  return slow


def _request_timeout(mod):
  release = threading.Event()
  m = mod.ServingMetrics()
  b = mod.MicroBatcher(_slow(release), max_batch_size=1, max_wait_ms=0.0,
                       max_queue=8, metrics=m)
  try:
    f1 = b.submit([1])
    f2 = b.submit([2], timeout_ms=30.0)
    time.sleep(0.06)
    release.set()
    return [_outcome(f1), _outcome(f2)], _counters(m)
  finally:
    release.set()
    b.stop()


def _backpressure(mod):
  release = threading.Event()
  m = mod.ServingMetrics()
  b = mod.MicroBatcher(_slow(release), max_batch_size=1, max_wait_ms=0.0,
                       max_queue=2, metrics=m)
  try:
    futs = [b.submit([1])]
    time.sleep(0.05)
    futs += [b.submit([2]), b.submit([3])]
    try:
      b.submit([4])
      rejected = None
    except mod.ServingOverloaded as e:
      rejected = str(e)
    release.set()
    return rejected, [_outcome(f) for f in futs], _counters(m)
  finally:
    release.set()
    b.stop()


def _oversized_head(mod):
  calls = []
  m = mod.ServingMetrics()
  b = mod.MicroBatcher(_echo(calls), max_batch_size=4, max_wait_ms=60.0,
                       metrics=m)
  try:
    return calls, _outcome(b.submit(np.arange(10))), _counters(m)
  finally:
    b.stop()


def _errors(mod):
  def boom(ids):
    raise ValueError('kaput')
  b = mod.MicroBatcher(boom, max_batch_size=4, max_wait_ms=1.0)
  out = _outcome(b.submit([1]))
  b.stop()
  try:
    b.submit([2])
    after = None
  except RuntimeError as e:
    after = str(e)
  return out, after


def _stall(mod):
  """The watchdog: a dispatch past stall_timeout_ms fails the batch and
  the queue with EngineStalledError, submit fails fast while the circuit
  is open, and the flight recorder records the trip."""
  release = threading.Event()
  m = mod.ServingMetrics()
  b = mod.MicroBatcher(_slow(release), max_batch_size=1, max_wait_ms=0.0,
                       metrics=m, stall_timeout_ms=50.0)
  try:
    f1 = b.submit([1])
    time.sleep(0.01)
    f2 = b.submit([2])
    outs = [_outcome(f1), _outcome(f2)]
    try:
      b.submit([3])
      fast = None
    except mod.EngineStalledError as e:
      fast = type(e).__name__
    stalled = b.stalled
    release.set()
    time.sleep(0.1)
    return outs, fast, stalled, b.stalled, _counters(m), \
        m.get_gauge('engine_stalled')
  finally:
    release.set()
    b.stop()


@pytest.mark.parametrize('scenario', [
    _merged, _deadline_flush, _empty_flush, _request_timeout, _backpressure,
    _oversized_head, _errors, _stall], ids=lambda f: f.__name__.strip('_'))
def test_batcher_scenarios_match_jax(scenario):
  recs = [JaxFlightRecorder(), FlightRecorder()]
  prev = jax_set_recorder(recs[0]), set_recorder(recs[1])
  try:
    want = scenario(jserving)
    got = scenario(pserving)
  finally:
    jax_set_recorder(prev[0])
    set_recorder(prev[1])
  assert got == want
  if scenario is _stall:
    assert [e['kind'] for e in recs[1].events()] == ['engine_stall']
    assert got[0][0][0] == 'EngineStalledError'


# -- ServingMetrics ----------------------------------------------------------

def _metrics_script(mod, registry=None, name=''):
  m = mod.ServingMetrics(registry=registry, name=name)
  rng = np.random.default_rng(3)
  for _ in range(50):
    m.record_request(float(10 ** rng.uniform(-4, -1)),
                     int(rng.integers(1, 9)))
  for _ in range(7):
    m.record_batch(int(rng.integers(1, 64)), 64)
  m.record_timeout()
  m.record_rejected()
  m.record_retry(2)
  m.record_reconnect()
  m.record_breaker_open()
  m.record_shed(3)
  m.record_stale_serve(4)
  m.record_failover()
  m.set_gauge('engine_stalled', 1.0)
  m.add_gauge('stale_zero_fills', 2.0)
  m.add_gauge('stale_zero_fills', 3.0)
  return m


def test_serving_metrics_snapshot_matches_jax():
  got, want = _metrics_script(pserving), _metrics_script(jserving)
  gs, ws = got.snapshot(), want.snapshot()
  assert sorted(gs) == sorted(ws)
  gs.pop('qps'), ws.pop('qps')
  assert gs == ws
  for attr in ('requests', 'ids_served', 'timeouts', 'rejected', 'batches',
               'batched_ids', 'batch_capacity', 'retries', 'reconnects',
               'breaker_opens', 'shed', 'stale_serves', 'failovers'):
    assert getattr(got, attr) == getattr(want, attr)
  assert got.batch_fill_ratio == want.batch_fill_ratio
  assert got.get_gauge('stale_zero_fills') == 5.0
  assert got.get_gauge('missing', 7.0) == 7.0
  line = got.report(cache=pserving.EmbeddingCache(4))
  assert 'p50=' in line and 'fill=' in line and 'cache_hit=0.00' in line


def test_serving_metrics_on_a_shared_registry_match_jax():
  from glt_tpu.obs import MetricsRegistry as JaxRegistry
  from glt_tpu_torch.obs import MetricsRegistry
  regs = [JaxRegistry(), MetricsRegistry()]
  for reg, mod in zip(regs, (jserving, pserving)):
    _metrics_script(mod, reg, 's0')
    _metrics_script(mod, reg, 's1')
  assert regs[1].snapshot() == regs[0].snapshot()
  assert regs[1].to_prometheus() == regs[0].to_prometheus()
  assert regs[1].get('serving_requests_total', view='s1') == 50


# -- the engine's front-end surface ------------------------------------------

def test_engine_validation_stale_tier_and_invalidation_match_jax():
  out = {}
  for which in ('jax', 'port'):
    e = identity_engine(which)
    with pytest.raises(RuntimeError, match='stale_serve before any'):
      e.stale_serve([1])
    with pytest.raises(ValueError) as err:
      e.validate_ids(np.array([3, 40, -1, 7]))
    rows = e.infer(np.array([5, 1, 5]))
    stale, mask = e.stale_serve(np.array([1, 2, 5]))
    hit = e.cache.hit_rate
    dropped = [e.invalidate(ids=np.array([1])), e.invalidate_nodes([5, 9]),
               e.invalidate()]
    e.infer(np.array([3]))
    out[which] = (str(err.value), rows.tolist(), stale.tolist(),
                  mask.tolist(), e.output_dim, hit, dropped,
                  e.cache.stats())
  assert out['port'] == out['jax']
  assert out['port'][0] == 'node ids out of range [0, 40): [40, -1]'


def test_cache_listeners_stale_reads_and_stats_match_jax():
  out = {}
  for which in ('jax', 'port'):
    c = SERVING[which].EmbeddingCache(capacity=3)
    seen = []
    c.add_invalidation_listener(lambda ids, v: seen.append((ids, v)))
    c.insert([1, 2], np.ones((2, 2), np.float32), version=0)
    c.insert([2, 3], 2 * np.ones((2, 2), np.float32), version=1)
    c.lookup([1, 2, 7], version=1)
    stale = {k: v.tolist() for k, v in c.lookup_stale([1, 2, 9]).items()}
    stats = c.stats()
    c.invalidate(ids=[2])
    c.invalidate(version=0)
    c.reset_stats()
    out[which] = (stale, stats, seen, c.stats(), c.hit_rate)
  assert out['port'] == out['jax']
  assert out['port'][0] == {2: [2.0, 2.0]}   # newest version first; 1 evicted


# -- the rpc front end -------------------------------------------------------

def _server(which, **kw):
  return SERVING[which].ServingServer(identity_engine(which), max_wait_ms=1.0,
                                      **kw)


@pytest.mark.parametrize('client,server', [('jax', 'port'), ('port', 'jax')])
def test_server_and_client_cross_packages(client, server):
  servers = {w: _server(w) for w in ('jax', 'port')}
  cli = SERVING[client].ServingClient(*servers[server].address)
  ref = SERVING[server].ServingClient(*servers[server].address)
  try:
    ids = np.array([3, 39, 3, 0])
    rows = cli.infer(ids)
    np.testing.assert_array_equal(rows[:, 0], ids)
    assert rows.shape == (4, FEAT_DIM) and rows.dtype == np.float32
    np.testing.assert_array_equal(cli.infer_async([7]).result(10)[:, 0], [7])
    with pytest.raises(ValueError, match=r'out of range \[0, 40\): \[40\]'):
      cli.infer([1, 40])
    assert cli.invalidate(ids=[3]) == 1
    assert cli.ping() == ref.ping()
    stats = cli.stats()
    want = SERVING[client].ServingClient(
        *servers[client].address).stats()
    assert sorted(stats) == sorted(want)
    assert stats['requests'] == 2 and stats['ids_served'] == 5
    assert stats['cache']['invalidations'] == 1
  finally:
    cli.close()
    ref.close()
    for s in servers.values():
      s.close()


def test_stale_tier_answers_a_stalled_engine_as_jax():
  out = {}
  for which in ('jax', 'port'):
    srv = _server(which, stall_timeout_ms=100.0, stale_serve=True)
    release = threading.Event()
    real = srv.batcher.handler
    try:
      first = srv.infer(np.array([4, 5]))
      srv.batcher.handler = lambda ids: (release.wait(5), real(ids))[1]
      stale = srv.infer(np.array([5, 6, 4]))     # the stall: cache tier
      again = srv.infer(np.array([4]))           # the circuit is open
      st = srv.stats()
      out[which] = (first.tolist(), stale.tolist(), again.tolist(),
                    st['stale_serves'], st['gauges'], st['stalled'],
                    st['breaker_opens'], st['shed'])
    finally:
      release.set()
      srv.close()
  assert out['port'] == out['jax']
  assert out['port'][1] == [[5.0] * FEAT_DIM, [0.0] * FEAT_DIM,
                            [4.0] * FEAT_DIM]
  assert out['port'][3] == 3


def test_slo_burn_on_stats_pull_matches_jax():
  from glt_tpu.obs import SloPolicy as JaxSloPolicy
  from glt_tpu_torch.obs import SloPolicy
  out = {}
  for which, pol in (('jax', JaxSloPolicy), ('port', SloPolicy)):
    srv = _server(which, slos=[pol('p99', 'serving_latency_seconds', 1e-9)],
                  metrics_name='s0')
    try:
      for i in range(3):
        srv.infer(np.array([i]))
      out[which] = (srv.stats()['slo_burn'], srv.stats()['slo_burn'],
                    srv.slo.policies[0].labels)
    finally:
      srv.close()
  assert out['port'] == out['jax'] == ({'p99': 100.0}, {'p99': 0.0},
                                       {'view': 's0'})


def _stream_server(which):
  if which == 'jax':
    from glt_tpu.stream import SnapshotManager, StreamIngestor, StreamSampler
    ds = jax_ring_dataset(num_nodes=40, feat_dim=FEAT_DIM)
    mgr = SnapshotManager(ds.get_graph().topo, ds.get_node_feature())
  else:
    from glt_tpu_torch.stream import (SnapshotManager, StreamIngestor,
                                      StreamSampler)
    ds = port_ring_dataset(40)
    mgr = SnapshotManager(ds.get_graph().topo, ds.get_node_feature(),
                          device='cpu')
  eng = identity_engine(which, data=ds,
                        sampler=StreamSampler(mgr, FANOUT, seed=0))
  ing = StreamIngestor(mgr, sampler=eng.sampler, engine=eng)
  return SERVING[which].ServingServer(eng, max_wait_ms=1.0, stream=ing)


def test_apply_delta_over_the_stream_ingestor_matches_jax():
  out = {}
  for which in ('jax', 'port'):
    srv = _stream_server(which)
    plain = _server(which)
    cli = SERVING[which].ServingClient(*srv.address)
    try:
      before = cli.infer(np.array([4, 11, 30]))
      res = cli.apply_delta(ins=np.array([[1, 2], [30, 31]]),
                            dels=np.array([[4], [5]]),
                            feat_ids=np.array([4, 30]),
                            feat_rows=np.full((2, FEAT_DIM), 500.0,
                                              np.float32))
      after = cli.infer(np.array([4, 11, 30]))
      with pytest.raises(RuntimeError, match='no stream ingestor'):
        plain.apply_delta(feat_ids=[1], feat_rows=np.ones((1, FEAT_DIM)))
      out[which] = (before.tolist(), res, after.tolist(),
                    srv.engine.snapshot_version)
    finally:
      cli.close()
      srv.close()
      plain.close()
  assert out['port'] == out['jax']
  assert out['port'][1]['version'] == 1 and out['port'][3] == 1
  assert out['port'][2][0] == [500.0] * FEAT_DIM


# -- the slice as a whole ----------------------------------------------------

def test_graphsage_served_by_both_servers_agrees():
  """Ring graph (every degree 2), fanouts [2, 2]: every neighbour is
  taken by both samplers. A 2-layer GraphSAGE at the JAX parameters,
  served through each package's ServingServer and read by the other
  package's client: logits within 1e-5."""
  from glt_tpu.loader.transform import Batch as JaxBatch
  from glt_tpu.models.sage import GraphSAGE as JaxGraphSAGE
  from glt_tpu_torch.models import GraphSAGE, sage_params_from_flax
  n, f, classes, fanouts = 40, 16, 5, [2, 2]
  rng = np.random.default_rng(0)
  x = rng.standard_normal((n, f)).astype(np.float32)
  jmodel = JaxGraphSAGE(hidden_features=32, out_features=classes,
                        num_layers=2)
  z = jnp.zeros((4,), jnp.int32)
  params = jax.jit(jmodel.init)(jax.random.key(1), JaxBatch(
      x=jnp.zeros((4, f)), row=z, col=z, edge_mask=jnp.zeros((4,), bool),
      node=z, node_count=jnp.zeros((), jnp.int32), batch_size=2))
  jds = jax_ring_dataset(num_nodes=n, feat_dim=f)
  jds.init_node_features(x)
  jeng = jserving.InferenceEngine(jds, jmodel, params, fanouts,
                                  buckets=(8, 16))
  ds = port_ring_dataset(n, f)
  ds.init_node_features(x, device='cpu')
  peng = pserving.InferenceEngine(
      ds, GraphSAGE(f, 32, classes, num_layers=2),
      sage_params_from_flax(jax.tree.map(np.asarray, params)), fanouts,
      buckets=(8, 16), device='cpu')
  jsrv = jserving.ServingServer(jeng, max_wait_ms=1.0)
  psrv = pserving.ServingServer(peng, max_wait_ms=1.0)
  jcli = jserving.ServingClient(*psrv.address)
  pcli = pserving.ServingClient(*jsrv.address)
  try:
    for ids in ([5, 0, 5, 17, 39, 2], np.arange(3, 19), [38, 1, 0]):
      got = jcli.infer(np.asarray(ids))     # the port server
      want = pcli.infer(np.asarray(ids))    # the JAX server
      assert got.shape == (len(ids), classes)
      np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # 5 ids, then 14 uncached of 16, then 2 uncached of 3
    assert peng.run_stats()['bucket_runs'] == {8: 2, 16: 1}
  finally:
    for c in (jcli, pcli):
      c.close()
    jsrv.close()
    psrv.close()


# -- the client session's metrics -------------------------------------------

def test_init_client_builds_jax_serving_metrics():
  from glt_tpu_torch.distributed import (fabric_stats, free_port_base,
                                         init_client, shutdown,
                                         shutdown_client)
  from glt_tpu_torch.distributed.rpc import RpcServer
  from glt_tpu_torch.obs import MetricsRegistry
  port = free_port_base(1)
  srv = RpcServer(port=port, auto_start=False)
  srv.register('exit', lambda: True)
  srv.start()
  want = sorted(jserving.ServingMetrics().snapshot())
  try:
    init_client(num_servers=1, num_clients=1, client_rank=0,
                master_port=port, health_interval_s=None)
    assert sorted(fabric_stats()['metrics']) == want
    shutdown_client()
    reg = MetricsRegistry()
    init_client(num_servers=1, num_clients=1, client_rank=0,
                master_port=port, health_interval_s=None, registry=reg)
    assert sorted(fabric_stats()['metrics']) == want
    assert reg.get('serving_requests_total', view='dist_client') == 0
    assert 'rpc_failovers_total{view="dist_client"}' in \
        reg.snapshot()['counters']
  finally:
    shutdown_client()
    srv.stop()
    shutdown()      # the client context init_client set is process-global


def test_client_harvests_and_exports_the_fabric_trace(tmp_path):
  """``collect_obs`` reads a server's spans and registry through ``_obs``;
  ``export_fabric_trace`` merges them with the client's into one Chrome
  trace of one trace id, skipping (and counting) a dead server."""
  import json
  from glt_tpu_torch.distributed import (collect_obs, export_fabric_trace,
                                         free_port_base, init_client,
                                         request_server, shutdown,
                                         shutdown_client)
  from glt_tpu_torch.distributed.rpc import RpcServer
  from glt_tpu_torch.obs import get_registry, get_tracer
  port = free_port_base(2)
  srv = RpcServer(port=port, auto_start=False)
  srv.register('add', lambda a, b: a + b)
  srv.register('exit', lambda: True)
  srv.start()
  dead = RpcServer(port=port + 1)
  tracer = get_tracer()
  try:
    init_client(num_servers=2, num_clients=1, client_rank=0,
                master_port=port, health_interval_s=None)
    dead.stop()
    tracer.clear()
    tracer.enable()
    with tracer.span('root') as root:
      assert request_server(0, 'add', 2, 3) == 5
    tracer.disable()
    got = collect_obs(0)
    assert any(e['name'] == 'rpc.server:add'
               and e['args']['trace_id'] == root.trace_id
               for e in got['events'])
    assert set(got['metrics']) == {'counters', 'gauges', 'histograms'}
    misses = get_registry().get('obs_harvest_misses_total', server='1')
    path = export_fabric_trace(str(tmp_path / 'trace.json'),
                               trace_id=root.trace_id)
    with open(path) as f:
      doc = json.load(f)
    names = [e['name'] for e in doc['traceEvents'] if e['ph'] == 'X']
    assert names.count('rpc.server:add') == 2   # the client's and srv's copy
    assert {'root', 'rpc.client:add'} <= set(names)
    assert get_registry().get('obs_harvest_misses_total',
                              server='1') == misses + 1
  finally:
    tracer.disable()
    tracer.clear()
    shutdown_client()
    srv.stop()
    shutdown()


# -- checkpoints and the example ---------------------------------------------

def test_checkpoint_round_trip_and_retention(tmp_path):
  from glt_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
  d = str(tmp_path / 'ckpt')
  assert restore_checkpoint(d) == (None, None)
  model = nn.Linear(3, 2)
  for step in range(5):
    save_checkpoint(d, step, model.state_dict(), extra={'step': step},
                    opt_state={'lr': torch.tensor(0.1 * step)},
                    max_to_keep=2)
  assert sorted(p.name for p in (tmp_path / 'ckpt').iterdir()) == ['3', '4']
  step, payload = restore_checkpoint(d)
  assert step == 4 and payload['extra'] == {'step': 4}
  assert torch.equal(payload['params']['weight'], model.weight)
  step, payload = restore_checkpoint(
      d, step=3, template={'params': {k: v.double() for k, v in
                                      model.state_dict().items()}})
  assert step == 3 and payload['params']['bias'].dtype == torch.float64


def test_serve_example_runs_on_the_cpu():
  from glt_tpu_torch.examples import serve_sage_products
  out = serve_sage_products.main(
      ['--device', 'cpu', '--nodes', '600', '--max-steps', '2',
       '--batch-size', '64', '--hidden', '16', '--queries', '12'])
  assert out['step'] == 0 and out['requests'] == 13
  assert sum(out['bucket_runs'].values()) >= 1
  assert 'req/s' in out['report'] and 'cache_hit=' in out['report']
