"""The port's sharded serving fleet (glt_tpu_torch.serving.fleet) against
the JAX package's (glt_tpu/serving/fleet.py), on the CPU: the scenarios of
tests/test_fleet.py:67-341 run on both routers over tests/fixtures.py's
ring with identity engines (a served row is the feature row of its id,
``[i] * dim``, so a row shows which table, and so which snapshot version,
produced it), and their outcomes are held equal: routing order,
admission, failover counts, the stale fallback, the breaker series'
labels, the apply_delta token, no mixed versions, the scale signals and
one trace id. A replica killed under load fails over with no
client-visible failure, in seconds.
"""
import threading
import time

import numpy as np
import pytest

from glt_tpu import obs as jobs
from glt_tpu.partition.partition_book import \
    RangePartitionBook as JaxRangeBook
from glt_tpu_torch import obs as pobs
from glt_tpu_torch.partition.partition_book import RangePartitionBook
from test_torch_serving_frontend import (FEAT_DIM, FANOUT, SERVING,
                                         identity_engine, jax_ring_dataset,
                                         port_ring_dataset)

OBS = {'jax': jobs, 'port': pobs}
BOOK = {'jax': JaxRangeBook, 'port': RangePartitionBook}
WHICH = ('jax', 'port')


def local_shard(which, name, num_nodes=40, replicas=1, **kw):
  return SERVING[which].FleetShard.local(
      name, [identity_engine(which, num_nodes) for _ in range(replicas)],
      **kw)


def stream_shard(which, name, num_nodes=40):
  """2-replica local shard over one SnapshotManager (the mutation path)."""
  if which == 'jax':
    from glt_tpu.stream import SnapshotManager, StreamSampler
    ds = jax_ring_dataset(num_nodes=num_nodes, feat_dim=FEAT_DIM)
    mgr = SnapshotManager(ds.get_graph().topo, ds.get_node_feature())
  else:
    from glt_tpu_torch.stream import SnapshotManager, StreamSampler
    ds = port_ring_dataset(num_nodes)
    mgr = SnapshotManager(ds.get_graph().topo, ds.get_node_feature(),
                          device='cpu')
  engines = [identity_engine(which, data=ds,
                             sampler=StreamSampler(mgr, FANOUT, seed=0))
             for _ in range(2)]
  return SERVING[which].FleetShard.local(name, engines, manager=mgr)


def router(which, shards, bounds, **kw):
  return SERVING[which].FleetRouter(shards, BOOK[which](bounds), **kw)


class _DeadEngine:
  """Stands in for a crashed local replica."""

  def infer(self, ids):
    raise ConnectionError('replica crashed')


def both(fn):
  """``fn(which)`` for each package; asserts the outcomes are equal and
  returns the port's."""
  out = {w: fn(w) for w in WHICH}
  assert out['port'] == out['jax']
  return out['port']


# -- routing -----------------------------------------------------------------

def test_routes_by_partition_book_and_preserves_order():
  def run(which):
    r = router(which, [local_shard(which, 's0'), local_shard(which, 's1')],
               [20, 40])
    try:
      ids = np.array([1, 25, 5, 39, 25, 0])   # shard mix and duplicates
      out = r.infer(ids)
      st = r.stats()
      return (out[:, 0].tolist(),
              [st['shards'][s]['metrics']['requests'] for s in ('s0', 's1')],
              st['metrics']['requests'], sorted(st), st['fleet_version'],
              st['shards']['s0']['breakers'], st['shards']['s0']['health'])
    finally:
      r.close()
  out = both(run)
  assert out[0] == [1, 25, 5, 39, 25, 0] and out[1] == [1, 1]


def test_rejects_bad_ids_and_book_mismatch():
  def run(which):
    errs = []
    r = router(which, [local_shard(which, 's0')], [40])
    try:
      for ids in ([1, 40], [-1, 3]):
        with pytest.raises(ValueError) as e:
          r.infer(np.array(ids))
        errs.append(str(e.value))
      assert r.infer(np.array([], np.int64)).shape[0] == 0
    finally:
      r.close()
    with pytest.raises(ValueError) as e:
      router(which, [local_shard(which, 's0')], [20, 40])
    return errs + [str(e.value)]
  out = both(run)
  assert 'partition book' in out[0] and 'negative' in out[1]


# -- admission ---------------------------------------------------------------

def test_admission_rejects_sheds_and_knows_its_classes():
  def run(which):
    S, reg = SERVING[which], OBS[which].MetricsRegistry()
    adm = S.AdmissionController(
        [S.AdmissionClass('tiny', max_inflight=1, max_queue=0),
         S.AdmissionClass('q', max_inflight=1, max_queue=4)], registry=reg)
    msgs = []
    adm.admit('tiny', time.monotonic() + 1.0)
    with pytest.raises(S.FleetOverloaded) as e:
      adm.admit('tiny', time.monotonic() + 1.0)
    msgs.append(str(e.value))
    adm.release('tiny')
    adm.admit('tiny', time.monotonic() + 1.0)     # the slot is back
    adm.release('tiny')
    adm.admit('q', time.monotonic() + 5.0)
    t0 = time.monotonic()
    with pytest.raises(S.FleetOverloaded) as e:
      adm.admit('q', time.monotonic() + 0.1)
    waited = 0.05 < time.monotonic() - t0 < 2.0
    msgs.append(str(e.value))
    with pytest.raises(KeyError) as e:
      adm.admit('nope', time.monotonic() + 1.0)
    msgs.append(str(e.value))
    snap = adm.snapshot()
    adm.release('q')
    return (msgs, waited, reg.get('fleet_rejected_total', **{'class': 'tiny'}),
            reg.get('fleet_shed_total', **{'class': 'q'}), snap)
  out = both(run)
  assert out[1] and out[2] == 1 and out[3] == 1


# -- the per-shard resilience ladder -----------------------------------------

def test_failover_to_second_replica_is_counted():
  def run(which):
    shard = local_shard(which, 's0', replicas=2)
    r = router(which, [shard], [40])
    try:
      shard.replicas[0].engine = _DeadEngine()
      out = r.infer(np.array([3, 9]))
      m = r.stats()['shards']['s0']['metrics']
      return out[:, 0].tolist(), m['failovers'], shard.health.status('r0')
    finally:
      r.close()
  out = both(run)
  assert out[1] == 1 and out[2] != 'UP'


def test_whole_shard_down_serves_stale_then_fails_fast():
  def run(which):
    shard = local_shard(which, 's0', replicas=2)
    r = router(which, [shard], [40])
    try:
      ids = np.array([3, 9, 21])
      r.infer(ids)                       # fills the fleet's stale cache
      for rep in shard.replicas:
        rep.engine = _DeadEngine()
      stale = r.infer(ids)               # the whole chain fails
      zero = r.infer(np.array([15]))     # never served: zero-filled
      t0 = time.monotonic()
      for _ in range(30):
        r.infer(ids)
      fast = time.monotonic() - t0 < 2.0
      st = r.stats()['shards']['s0']
      return (stale[:, 0].tolist(), zero.tolist(),
              st['metrics']['stale_serves'] >= 3,
              st['metrics']['gauges']['stale_zero_fills'],
              r.registry.get('fleet_unavailable_total', shard='s0') >= 1,
              fast, st['health'])
    finally:
      r.close()
  out = both(run)
  assert out[0] == [3, 9, 21] and out[1] == [[0.0] * FEAT_DIM]
  assert out[5] and out[6] == {'r0': 'DOWN', 'r1': 'DOWN'}


def test_whole_shard_down_without_stale_serve_fails_fast():
  def run(which):
    shard = local_shard(which, 's0')
    r = router(which, [shard], [40], stale_serve=False)
    try:
      shard.replicas[0].engine = _DeadEngine()
      with pytest.raises(SERVING[which].FleetUnavailable) as e:
        r.infer(np.array([3]))
      return str(e.value), isinstance(e.value, ConnectionError)
    finally:
      r.close()
  assert both(run)[1]


def test_breaker_series_are_labeled_per_shard_and_replica():
  def run(which):
    s0, s1 = local_shard(which, 's0'), local_shard(which, 's1')
    r = router(which, [s0, s1], [20, 40])
    try:
      s0.replicas[0].engine = _DeadEngine()
      for _ in range(4):              # past the breaker threshold (3)
        with pytest.raises(ConnectionError):
          r.infer(np.array([1]))
      reg = r.registry
      return (reg.get('breaker_opens_total', breaker='s0/r0', shard='s0',
                      replica='r0'),
              reg.get('breaker_state', breaker='s0/r0', shard='s0',
                      replica='r0'),
              reg.get('breaker_opens_total', breaker='s1/r0', shard='s1',
                      replica='r0'),
              reg.get('health_status', target='r0', shard='s0'),
              sorted(k for k in reg.snapshot()['gauges']
                     if k.startswith(('breaker_state', 'health_status'))))
    finally:
      r.close()
  out = both(run)
  assert out[:4] == (1.0, 2.0, 0, 2.0)


# -- the consistency token ---------------------------------------------------

def test_apply_delta_advances_token_and_reaches_every_engine():
  def run(which):
    s0, s1 = stream_shard(which, 's0'), stream_shard(which, 's1')
    r = router(which, [s0, s1], [20, 40])
    try:
      ids = np.arange(0, 40, 5)
      before = r.infer(ids)[:, 0].tolist()
      token0 = r.consistency_token()
      rows = 1000.0 + np.arange(40, dtype=np.float32)[:, None] \
          * np.ones(FEAT_DIM, np.float32)
      res = r.apply_delta(feat_ids=np.arange(40), feat_rows=rows)
      after = r.infer(ids)[:, 0].tolist()
      return (before, token0, res, r.consistency_token(),
              r.registry.get('fleet_version'), after,
              [rep.engine.snapshot_version for s in (s0, s1)
               for rep in s.replicas])
    finally:
      r.close()
  out = both(run)
  assert out[2]['fleet_version'] == 1 and out[3] == 1
  assert out[5] == (1000.0 + np.arange(0, 40, 5)).tolist()
  assert out[6] == [1, 1, 1, 1]


def test_no_request_spans_mixed_snapshot_versions():
  """While apply_delta propagates fleet-wide, every concurrent response
  is uniformly OLD or uniformly NEW (the write barrier)."""
  def run(which):
    s0, s1 = stream_shard(which, 's0'), stream_shard(which, 's1')
    r = router(which, [s0, s1], [20, 40])
    ids = np.array([2, 7, 13, 22, 29, 37])
    seen, errs = set(), []
    stop = threading.Event()

    def hammer():
      try:
        while not stop.is_set():
          out = r.infer(ids, timeout_ms=5000)
          marks = np.unique(out[:, 0] - ids)
          assert marks.size == 1, f'mixed versions in a response: {marks}'
          seen.add(int(marks[0]))
      except Exception as e:  # surfaced below
        errs.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    try:
      for t in threads:
        t.start()
      for v in range(1, 4):
        rows = 1000.0 * v + np.arange(40, dtype=np.float32)[:, None] \
            * np.ones(FEAT_DIM, np.float32)
        r.apply_delta(feat_ids=np.arange(40), feat_rows=rows)
        time.sleep(0.05)
    finally:
      stop.set()
      for t in threads:
        t.join(timeout=10)
      r.close()
    assert not errs, errs
    return r.consistency_token(), 3000 in seen
  assert both(run) == (3, True)


# -- burn-driven scaling -----------------------------------------------------

def test_scale_signals_and_recorder_event():
  def run(which):
    mod = OBS[which]
    rec = mod.FlightRecorder()
    prev = mod.set_recorder(rec)
    pol = SERVING[which].ScalePolicy
    up = router(which, [local_shard(which, 's0')], [40],
                scale_policy=pol(threshold_s=1e-7, min_window=5))
    down = router(which, [local_shard(which, 's0')], [40],
                  scale_policy=pol(threshold_s=60.0, min_window=5))
    try:
      for _ in range(8):
        up.infer(np.array([1, 2]))
      hot = up.evaluate_scaling()['s0']
      down.infer(np.array([1]))
      thin = down.evaluate_scaling()['s0']['signal']
      for _ in range(8):
        down.infer(np.array([1, 2]))
      cool = down.evaluate_scaling()['s0']
      trips = [(e['kind'], e['shard'], e['signal']) for e in rec.events()
               if e['kind'] == 'fleet_scale_signal']
      return (hot['signal'], hot['burn'] > 1.0, hot['window'],
              up.registry.get('fleet_scale_signal', shard='s0'), thin,
              cool, down.registry.get('fleet_scale_signal', shard='s0'),
              trips)
    finally:
      mod.set_recorder(prev)
      up.close()
      down.close()
  out = both(run)
  assert out[0] == 1 and out[3] == 1.0 and out[4] == 0
  assert out[5]['signal'] == -1 and out[6] == -1.0
  assert out[7] == [('fleet_scale_signal', 's0', 1)]


# -- tracing -----------------------------------------------------------------

def test_one_trace_id_spans_router_and_every_shard():
  def run(which):
    r = router(which, [local_shard(which, 's0'), local_shard(which, 's1')],
               [20, 40])
    tracer = OBS[which].get_tracer()
    tracer.enable(sample=1.0)
    try:
      tracer.clear()
      r.infer(np.array([1, 30]))
      evs = tracer.events()
      roots = [e for e in evs if e['name'] == 'fleet.infer']
      tid = roots[0]['args']['trace_id']
      shards = sorted(e['args']['shard'] for e in evs
                      if e['name'] == 'fleet.shard'
                      and e['args']['trace_id'] == tid)
      buckets = [e for e in evs if e['name'] == 'serve.bucket'
                 and e['args'].get('trace_id') == tid]
      return len(roots), shards, len(buckets)
    finally:
      tracer.disable()
      tracer.clear()
      r.close()
  assert both(run) == (1, ['s0', 's1'], 2)


def test_killed_remote_replica_fails_over_under_load():
  """Two port ServingServers behind one shard, a local shard beside it,
  four load threads: the primary is killed (its endpoint first, as a
  process death drops its connections) and every request still answers
  with the right rows; failovers are counted, r0 ends DOWN, and a traced
  request after the kill carries one trace id from the router through
  the surviving server's handler, batcher flush and bucket run."""
  servers = [SERVING['port'].ServingServer(
      identity_engine('port', 60), max_wait_ms=1.0,
      request_timeout_ms=5000.0) for _ in range(2)]
  remote = SERVING['port'].FleetShard.remote(
      's0', [s.address for s in servers])
  r = router('port', [remote, local_shard('port', 's1', 60)], [30, 60])
  failures, responses = [], [0]
  lock = threading.Lock()
  stop = threading.Event()

  def load(seed):
    rng = np.random.default_rng(seed)
    while not stop.is_set():
      ids = rng.integers(0, 60, size=6)
      try:
        out = r.infer(ids, timeout_ms=8000)
        np.testing.assert_array_equal(out[:, 0], ids)
      except Exception as e:  # surfaced below
        failures.append(e)
        return
      with lock:
        responses[0] += 1

  threads = [threading.Thread(target=load, args=(s,)) for s in range(4)]
  tracer = pobs.get_tracer()
  try:
    for t in threads:
      t.start()
    time.sleep(0.5)
    servers[0].rpc.stop()
    servers[0].close()
    time.sleep(0.7)
    tracer.enable(sample=1.0)
    tracer.clear()
    servers[1].engine.invalidate()   # so the traced ids run a bucket
    ids = np.array([3, 9, 15])       # shard s0 -> the surviving server
    np.testing.assert_array_equal(r.infer(ids, timeout_ms=8000)[:, 0], ids)
    tracer.disable()
    evs = tracer.events()
    tid = [e for e in evs if e['name'] == 'fleet.infer'
           and e['args'].get('ids') == 3][0]['args']['trace_id']
    names = {e['name'] for e in evs if e['args'].get('trace_id') == tid}
  finally:
    stop.set()
    for t in threads:
      t.join(timeout=30)
    stats = r.stats()
    r.close()
    servers[1].close()
    tracer.disable()
    tracer.clear()
  assert not failures, failures[:3]
  assert responses[0] > 20, responses
  m0 = stats['shards']['s0']['metrics']
  assert m0['failovers'] > 0
  assert stats['shards']['s0']['health']['r0'] == 'DOWN'
  assert {'fleet.infer', 'fleet.shard', 'rpc.client:infer',
          'rpc.server:infer', 'serve.infer', 'serve.flush',
          'serve.bucket'} <= names
