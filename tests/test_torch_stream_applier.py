"""The port's StreamIngestor (glt_tpu_torch.stream.ingest) against the JAX
package's over tests/fixtures.py's ring:

- the ServingMetrics gauges and ``stats()`` after the same staging calls
  and compactions equal JAX's (timing values excepted), and
  ``CompactionPolicy.min_interval_s`` holds off a due compaction on both
  sides while an explicit ``flush`` ignores it;
- the background applier (``start``/``stop``): a staleness compaction
  with no writer, the overlay refreshed by the tick when ``auto_refresh``
  is off, and the four restart policies of tests/test_stream.py (a fatal
  error raised again from staging calls and ``stop``, recorded as an
  ``ingestor_crash`` trip in the port's flight recorder);
- concurrent writers reach consistent totals;
- feature staging validates at the writer's call, as JAX's does: the row
  width, a stream without features, ids out of the id space and ids a
  partition's store does not own (tests/test_stream.py:532-590);
- the stream example (examples/stream_updates.py ported) runs end to end
  on the CPU at 2,000 nodes and two training steps.

Applier polls are at most 0.05 s; every wait is bounded, every thread
joined with a timeout.
"""
import threading
import time

import numpy as np
import pytest

from fixtures import ring_dataset as jax_ring
from glt_tpu.data import Feature as JaxFeature
from glt_tpu.data import Topology as JaxTopology
from glt_tpu.serving import ServingMetrics as JaxMetrics
from glt_tpu.stream import CompactionPolicy as JaxPolicy
from glt_tpu.stream import SnapshotManager as JaxSnapshotManager
from glt_tpu.stream import StreamIngestor as JaxIngestor
from glt_tpu_torch.data import Feature, Topology
from glt_tpu_torch.obs import recorder as obs_recorder
from glt_tpu_torch.obs.registry import MetricsRegistry
from glt_tpu_torch.serving import ServingMetrics
from glt_tpu_torch.stream import (CompactionPolicy, SnapshotManager,
                                  StreamIngestor, StreamSampler)
from torch_server_worker import ring_dataset

N, D = 24, 16
POLL = 0.02
WAIT_S = 5.0


def make_manager(num_nodes=N, delta_capacity=64):
  ds = ring_dataset(num_nodes=num_nodes, feat_dim=D)
  return ds, SnapshotManager(ds.get_graph().topo, ds.get_node_feature(),
                             delta_capacity=delta_capacity, device='cpu')


def jax_manager(num_nodes=N, delta_capacity=64):
  ds = jax_ring(num_nodes=num_nodes, feat_dim=D)
  return ds, JaxSnapshotManager(ds.get_graph().topo, ds.get_node_feature(),
                                delta_capacity=delta_capacity)


def wait_for(cond, timeout=WAIT_S):
  deadline = time.monotonic() + timeout
  while not cond() and time.monotonic() < deadline:
    time.sleep(0.005)
  return cond()


@pytest.fixture
def recorder(monkeypatch):
  """A private flight recorder in place of the process's."""
  rec = obs_recorder.FlightRecorder(registry=MetricsRegistry())
  monkeypatch.setattr(obs_recorder, 'get_recorder', lambda: rec)
  return rec


# -- gauges, stats, policy ---------------------------------------------------

def _steps(ing):
  """The same staging sequence on either side; yields after each call."""
  ing.insert_edges([0, 1, 2], [5, 6, 7])
  yield 'insert'
  ing.delete_edges([0], [1])
  yield 'delete'
  ing.update_features([3, 4], np.full((2, D), 2.5, np.float32))
  yield 'features'
  ing.flush()
  yield 'flush'
  ing.insert_edges(np.arange(8), np.full(8, 11))   # 8/16 >= 0.5: compacts
  yield 'policy'
  ing.delete_edges([2], [4])
  yield 'residual'


def _comparable(gauges):
  return {k: v for k, v in gauges.items() if k != 'last_compaction_ms'}


def test_gauges_and_stats_match_jax():
  _, jm = jax_manager(delta_capacity=16)
  _, pm = make_manager(delta_capacity=16)
  jmet, pmet = JaxMetrics(), ServingMetrics()
  policy = dict(occupancy_threshold=0.5, max_staleness_s=1e9)
  jing = JaxIngestor(jm, policy=JaxPolicy(**policy), metrics=jmet,
                     feature_capacity=8)
  ping = StreamIngestor(pm, policy=CompactionPolicy(**policy),
                        metrics=pmet, feature_capacity=8)
  want, got = jmet.snapshot()['gauges'], pmet.snapshot()['gauges']
  assert got == want                 # published at construction
  assert set(got) == {'snapshot_version', 'delta_occupancy',
                      'feature_delta_occupancy', 'compactions',
                      'last_compaction_ms', 'edge_capacity',
                      'capacity_growths', 'ingest_ops_total'}
  for step, _ in zip(_steps(jing), _steps(ping)):
    want, got = jmet.snapshot()['gauges'], pmet.snapshot()['gauges']
    assert _comparable(got) == _comparable(want), step
    assert (got['last_compaction_ms'] > 0) == (want['last_compaction_ms']
                                                > 0), step
    js, ps = jing.stats(), ping.stats()
    assert ps.pop('last_compaction_ms') == got['last_compaction_ms']
    js.pop('last_compaction_ms')
    assert ps == js, step
  assert got['snapshot_version'] == pm.current().version == 2
  assert got['compactions'] == pm.compactions == 2
  assert got['edge_capacity'] == pm.edge_capacity
  assert got['ingest_ops_total'] == 3 + 1 + 2 + 8 + 1
  assert ping.features.capacity == 8


def test_min_interval_holds_off_policy_compactions_as_jax():
  sides = []
  for make, Ing, Policy in ((jax_manager, JaxIngestor, JaxPolicy),
                            (make_manager, StreamIngestor,
                             CompactionPolicy)):
    _, mgr = make(delta_capacity=16)
    ing = Ing(mgr, policy=Policy(occupancy_threshold=0.25,
                                 max_staleness_s=1e9, min_interval_s=60.0))
    versions = []
    ing.insert_edges(np.arange(4), np.full(4, 9))   # due: compacts (v1)
    versions.append(mgr.current().version)
    ing.insert_edges(np.arange(4), np.full(4, 10))  # due, inside 60 s
    versions.append(mgr.current().version)
    ing._last_compaction_ts -= 61.0                 # the interval passed
    ing.insert_edges([0], [12])
    versions.append(mgr.current().version)
    ing.insert_edges(np.arange(4), np.full(4, 13))  # inside it again
    versions.append(mgr.current().version)
    ing.flush()                                      # flush ignores it
    versions.append(mgr.current().version)
    sides.append(versions)
  assert sides[1] == sides[0] == [1, 1, 2, 2, 3]


# -- the background applier ------------------------------------------------------

def test_staleness_policy_compacts_on_the_background_thread():
  _, mgr = make_manager()
  ing = StreamIngestor(mgr, policy=CompactionPolicy(
      occupancy_threshold=2.0, max_staleness_s=0.05))
  ing.update_features([3], np.ones((1, D), np.float32))
  assert mgr.current().version == 0
  with ing.start(poll_interval_s=POLL):
    assert ing._thread.name == 'glt-stream-ingest' and ing._thread.daemon
    assert wait_for(lambda: mgr.current().version == 1)
  assert ing._thread is None
  np.testing.assert_array_equal(mgr.current().feature[np.array([3])],
                                np.ones((1, D), np.float32))


def test_background_tick_refreshes_the_overlay():
  _, mgr = make_manager()
  sampler = StreamSampler(mgr, [2], seed=0)
  ing = StreamIngestor(mgr, sampler=sampler, auto_refresh=False,
                       policy=CompactionPolicy(occupancy_threshold=2.0,
                                               max_staleness_s=1e9))
  empty = mgr.empty_overlay()
  ing.insert_edges([1, 2], [9, 9])
  assert sampler._overlay is empty          # staging did not refresh
  ing.start(poll_interval_s=POLL)
  try:
    assert wait_for(lambda: sampler._overlay is not empty)
  finally:
    ing.stop()
  assert sampler._overlay is mgr.build_overlay(ing.edges)   # memoized
  assert sampler._overlay['ins_indptr'].tolist()[1:4] == [0, 1, 2]
  with pytest.raises(RuntimeError, match='already started'):
    ing.start(poll_interval_s=POLL).start()
  ing.stop()


def test_ingestor_bg_crash_raises_on_next_stage_and_stop(recorder):
  _, mgr = make_manager()
  ing = StreamIngestor(mgr, policy=CompactionPolicy(
      occupancy_threshold=2.0, max_staleness_s=0), restart_policy='raise')

  def boom():
    raise RuntimeError('injected tick failure')

  ing.maybe_compact = boom
  ing.start(poll_interval_s=POLL)
  assert wait_for(lambda: ing._bg_error is not None)
  assert ing.tick_errors_total == 1
  with pytest.raises(RuntimeError, match='background applier died'):
    ing.insert_edges([1], [2])
  with pytest.raises(RuntimeError, match='background applier died'):
    ing.flush()
  with pytest.raises(RuntimeError, match='background applier died'):
    ing.stop()
  ing.stop(raise_background_error=False)   # the cleanup path stays usable
  trips = [e for e in recorder.events() if e['kind'] == 'ingestor_crash']
  assert len(trips) == 1
  assert trips[0]['restart_policy'] == 'raise'
  assert trips[0]['tick_failures'] == 1
  assert 'injected tick failure' in trips[0]['error']


def test_ingestor_restart_policy_survives_transient_tick_failures(recorder):
  _, mgr = make_manager()
  metrics = ServingMetrics()
  ing = StreamIngestor(mgr, policy=CompactionPolicy(
      occupancy_threshold=2.0, max_staleness_s=0), metrics=metrics,
      max_tick_failures=3)
  assert ing.restart_policy == 'restart'
  fails = {'left': 2}
  healthy = threading.Event()
  real = ing.maybe_compact

  def flaky_tick():
    if fails['left'] > 0:
      fails['left'] -= 1
      raise RuntimeError('transient')
    healthy.set()                # a success resets the streak
    return real()

  ing.maybe_compact = flaky_tick
  ing.start(poll_interval_s=POLL)
  try:
    assert healthy.wait(WAIT_S)
    assert wait_for(lambda: ing._tick_failures == 0)
    assert ing._bg_error is None
    assert ing.insert_edges([1], [2]) == 1   # staging still works
    assert ing.tick_errors_total == 2
    assert metrics.get_gauge('ingest_tick_errors') == 2.0
  finally:
    ing.stop()
  assert not [e for e in recorder.events() if e['kind'] == 'ingestor_crash']


def test_ingestor_crash_loop_exceeding_budget_is_fatal(recorder):
  _, mgr = make_manager()
  ing = StreamIngestor(mgr, policy=CompactionPolicy(
      occupancy_threshold=2.0, max_staleness_s=0), max_tick_failures=3)

  def always_boom():
    raise ValueError('poisoned cut')

  ing.maybe_compact = always_boom
  ing.start(poll_interval_s=POLL)
  assert wait_for(lambda: ing._bg_error is not None)
  assert ing.tick_errors_total == 3          # stopped at the budget
  with pytest.raises(RuntimeError) as ei:
    ing.update_features([0], np.zeros((1, D), np.float32))
  assert isinstance(ei.value.__cause__, ValueError)
  ing.stop(raise_background_error=False)
  trips = [e for e in recorder.events() if e['kind'] == 'ingestor_crash']
  assert [(t['tick_failures'], t['restart_policy']) for t in trips] == [
      (3, 'restart')]


def test_ingestor_log_policy_keeps_swallowing(recorder):
  _, mgr = make_manager()
  ing = StreamIngestor(mgr, policy=CompactionPolicy(
      occupancy_threshold=2.0, max_staleness_s=0), restart_policy='log')

  def bg_boom():
    # staging calls maybe_compact too: fail only on the applier's thread
    if threading.current_thread().name == 'glt-stream-ingest':
      raise RuntimeError('x')

  ing.maybe_compact = bg_boom
  ing.start(poll_interval_s=0.01)
  try:
    assert wait_for(lambda: ing.tick_errors_total >= 5)
    assert ing._bg_error is None and ing._thread.is_alive()
    assert ing.insert_edges([1], [2]) == 1
  finally:
    ing.stop()
  assert not recorder.events()
  with pytest.raises(ValueError, match='restart_policy'):
    StreamIngestor(mgr, restart_policy='ignore')


def test_concurrent_writers_consistent_totals():
  _, mgr = make_manager(delta_capacity=4096)
  ing = StreamIngestor(mgr, policy=CompactionPolicy(
      occupancy_threshold=0.25, max_staleness_s=1e9))
  errors = []

  def writer(rank):
    rng = np.random.default_rng(rank)
    try:
      for _ in range(50):
        s, d = rng.integers(0, N, 2)
        ing.insert_edges([int(s)], [int(d)])
    except Exception as e:  # pragma: no cover - reported below
      errors.append(e)

  threads = [threading.Thread(target=writer, args=(r,)) for r in range(4)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=30)
  assert not any(t.is_alive() for t in threads)
  assert not errors
  ing.flush()
  assert ing.edges.total_inserts == 200
  assert mgr.current().topo.num_edges == 2 * N + 200
  assert mgr.compactions >= 1


# -- feature staging (validated at the writer's call) ----------------------------

def test_feature_staging_rejects_bad_rows_and_featureless_streams():
  ds, mgr = make_manager()
  ing = StreamIngestor(mgr, policy=CompactionPolicy(
      occupancy_threshold=2.0, max_staleness_s=1e9))
  with pytest.raises(ValueError, match='row width'):
    ing.update_features([1, 2], np.ones((2, 7), np.float32))   # D = 16
  with pytest.raises(ValueError, match=r'out of range \[0, 24\)'):
    ing.update_features([3, 24], np.ones((2, D), np.float32))
  with pytest.raises(ValueError, match='out of range'):
    ing.update_features([-1], np.ones((1, D), np.float32))
  assert ing.features.size == 0
  mgr2 = SnapshotManager(ds.get_graph().topo, None, delta_capacity=8,
                         device='cpu')
  ing2 = StreamIngestor(mgr2, policy=CompactionPolicy(
      occupancy_threshold=2.0, max_staleness_s=1e9))
  with pytest.raises(ValueError, match='no Feature'):
    ing2.update_features([1], np.ones((1, D), np.float32))
  ing2.insert_edges([1], [2])
  assert ing2.flush()['version'] == 1      # topology-only still works


def test_partitioned_feature_updates_validated_in_global_id_space():
  """A store with an id map (a partition's) takes global ids: an owned id
  past the local row count stages, an unowned one fails at staging; the
  compaction lands as JAX's does."""
  n_global, n_local = 40, 12
  owned = np.arange(0, n_global, 3)[:n_local]
  id2index = np.full(n_global, -1, np.int64)
  id2index[owned] = np.arange(n_local)
  ei = np.stack([np.arange(8), (np.arange(8) + 1) % 8])
  big_owned = int(owned[-1])
  assert big_owned >= n_local
  infos = []
  for Topo, Feat, Mgr, Ing, Policy, kw in (
      (JaxTopology, JaxFeature, JaxSnapshotManager, JaxIngestor, JaxPolicy,
       {}),
      (Topology, Feature, SnapshotManager, StreamIngestor, CompactionPolicy,
       {'device': 'cpu'})):
    feat = Feat(np.zeros((n_local, 4), np.float32), id2index=id2index, **kw)
    topo = (Topo(edge_index=ei, num_nodes=n_global) if Topo is JaxTopology
            else Topo(ei, num_nodes=n_global, device='cpu'))
    mgr = Mgr(topo, feat, delta_capacity=8, **kw)
    ing = Ing(mgr, policy=Policy(occupancy_threshold=2.0,
                                 max_staleness_s=1e9))
    assert ing.features.num_nodes == n_global    # the id space
    ing.update_features([big_owned], np.ones((1, 4), np.float32))
    with pytest.raises(ValueError, match='not owned'):
      ing.update_features([1], np.ones((1, 4), np.float32))
    with pytest.raises(ValueError, match='out of range'):
      ing.update_features([n_global], np.ones((1, 4), np.float32))
    info = ing.flush()
    infos.append(info)
    np.testing.assert_allclose(
        mgr.current().feature[np.array([big_owned])][0], 1.0)
  np.testing.assert_array_equal(infos[1]['touched'], infos[0]['touched'])
  assert big_owned in infos[1]['touched'].tolist()


def test_stream_updates_example_runs_on_the_cpu():
  from glt_tpu_torch.examples import stream_updates
  out = stream_updates.main(['--device', 'cpu', '--nodes', '2000',
                             '--max-steps', '2', '--batch-size', '128'])
  assert out['info']['version'] == 1 and out['info']['invalidated'] > 0
  assert out['changed']
  assert out['gauges']['snapshot_version'] == 1.0
  assert out['gauges']['ingest_ops_total'] == 64 + 4
  assert out['edge_delta']['total_inserts'] == 64
  assert out['edge_delta']['pending'] == 0
  assert sum(out['bucket_runs'].values()) > 0
