"""The server-client and mp modes of the port (glt_tpu_torch.distributed:
dist_server, dist_client, dist_sampling_producer, channel_loader) against
the JAX package's producer, over tests/fixtures.py's ring (every degree 2,
the fanout 2, so a sample does not depend on its draws):

- two spawned port servers (``device='cpu'``, one module fixture) serve
  ``RemoteNeighborLoader`` batches (``with_edge`` and edge features, a
  shuffled order over two epochs; split-name seeding) bit-identical to
  JAX's ``_sampling_worker_loop`` -> ``flatten_sampler_output`` ->
  ``message_to_batch`` over the same seed orders (run in this process,
  no JAX server spawned), and their data-plane callees answer as JAX's
  DistServer does;
- ``MpNeighborLoader`` batches equal JAX's over epochs, an abandoned
  epoch leaks nothing into the next, dead workers are respawned at the
  next epoch, and a death mid-epoch ends in a timeout or the epoch's end,
  never a hang (tests/test_server_client.py:129, :392, :422);
- ``message_to_batch`` slices as the in-process ``to_batch`` does;
- the server_client_mode example trains over its own servers;
- a fetch slower than one rpc attempt still arrives, and one past the
  whole budget is taken for a lost server, in both packages' rpc; a
  sampling worker that starts late within the loader's budget loses no
  batch (ROADMAP C8);
- a server lost mid-run degrades the epoch to the survivor.

Ports come from the OS, every spawned process is joined with a timeout
(killed past it), and the servers' rings go with their processes.
"""
import collections
import contextlib
import multiprocessing as mp
import queue
import time

import numpy as np
import pytest
import torch

import torch_server_worker
from glt_tpu_torch.channel import pack_message, unpack_message
from glt_tpu_torch.distributed import (MpDistSamplingWorkerOptions,
                                       MpNeighborLoader,
                                       RemoteDistSamplingWorkerOptions,
                                       RemoteNeighborLoader, fabric_stats,
                                       free_port_base, init_client,
                                       request_server, shutdown_client)

FIELDS = ('x', 'y', 'row', 'col', 'edge_mask', 'node', 'node_count', 'edge',
          'edge_attr', 'num_sampled_nodes', 'num_sampled_edges')
JOIN_S = 60
#: The lost-server test's loader budget (``rpc_timeout``). A fetch that
#: blocks past a loader's budget takes a live server for a lost one and
#: ends its share of the epoch without an error, in the JAX package too
#: (ROADMAP C8). An epoch's first fetch waits for a freshly spawned
#: sampling worker, which on a loaded machine has taken longer than the
#: 20 s this test once gave it. A killed server is found at once (its
#: connection is refused), whatever the budget.
DEGRADE_RPC_TIMEOUT = 120.0
#: How late the held server's sampling worker starts: past the 20 s the
#: lost-server test once gave its loader.
HOLD_S = 21.0


def jax_ring():
  """The JAX fixture's ring with the JAX test's node split."""
  from fixtures import ring_dataset
  ds = ring_dataset(num_nodes=40, feat_dim=4)
  ds.random_node_split(num_val=0.25, num_test=0.25, seed=3)
  return ds


def _np_batch(b):
  out = {f: (None if getattr(b, f) is None else np.asarray(getattr(b, f)))
         for f in FIELDS}
  out['n_valid'] = int(b.metadata['n_valid'])
  out['edge_hop_offsets'] = tuple(b.edge_hop_offsets)
  out['batch_size'] = b.batch_size
  return out


def jax_reference(seeds, cfg, epochs, num_workers=1, rank=0):
  """JAX's sampling worker over ``seeds`` in this process: its batches by
  epoch, through JAX's ``message_to_batch``, as numpy."""
  from glt_tpu.distributed.channel_loader import message_to_batch
  from glt_tpu.distributed.dist_sampling_producer import (
      END_KEY, EPOCH_KEY, _sampling_worker_loop)
  from glt_tpu.sampler.base import SamplingConfig
  sent = []

  class Chan:
    send = sent.append
  q = queue.Queue()
  for e in epochs:
    q.put(('SAMPLE_ALL', e))
  q.put(('EXIT',))
  config = SamplingConfig(**cfg)
  _sampling_worker_loop(rank, num_workers, jax_ring, config,
                        np.asarray(seeds, np.int64), q, Chan())
  out = {e: [] for e in epochs}
  for msg in sent:
    if END_KEY not in msg:
      out[int(msg[EPOCH_KEY][0])].append(
          _np_batch(message_to_batch(msg, config)))
  return out


def assert_same(got, want, what):
  """Every field bit for bit; the edge ids and edge rows on the valid
  edge lanes (a masked lane holds another id in each package, as
  tests/test_torch_sampling.py allows)."""
  assert set(got) == set(want), what
  for k, w in want.items():
    g = got[k]
    if w is None or isinstance(w, (int, tuple)):
      assert g == w, (what, k, g, w)
      continue
    assert g is not None, (what, k)
    assert g.shape == w.shape, (what, k, g.shape, w.shape)
    if k in ('edge', 'edge_attr'):
      g, w = g[got['edge_mask']], w[want['edge_mask']]
    np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f'{what} {k}')


def _key(b):
  return b['node'].tobytes() + b['row'].tobytes() + b['x'].tobytes()


@pytest.fixture(scope='module')
def jax_env():
  with pytest.MonkeyPatch.context() as mp_:
    mp_.setenv('GLT_DEDUP', 'sort')
    mp_.setenv('GLT_FUSED_HOP', '1')
    yield


@contextlib.contextmanager
def spawned_servers(holds=(0.0, 0.0)):
  """Spawned port servers over the ring, one a hold (its sampling workers
  start that many seconds late), and this process's client session."""
  ctx = mp.get_context('spawn')
  n = len(holds)
  port = free_port_base(n)
  readies = [ctx.Event() for _ in range(n)]
  dones = [ctx.Event() for _ in range(n)]
  procs = [ctx.Process(target=torch_server_worker.server_main,
                       args=(r, n, port, readies[r], dones[r], holds[r]))
           for r in range(n)]
  for p in procs:
    p.start()
  try:
    for e in readies:
      assert e.wait(timeout=120), 'a server did not come up'
    init_client(num_servers=n, num_clients=1, client_rank=0,
                master_port=port, health_interval_s=None)
    yield procs
    shutdown_client()
    for p, d in zip(procs, dones):
      if p.is_alive():
        assert d.wait(timeout=JOIN_S), 'a server did not exit'
  finally:
    shutdown_client()
    for p in procs:
      p.join(timeout=10)
      if p.is_alive():
        p.kill()
        p.join(10)


@pytest.fixture(scope='module')
def servers(jax_env):
  """Two spawned port servers over the ring and this process's client."""
  with spawned_servers() as procs:
    yield procs


def degrade_loader(worker_key, rpc_timeout=DEGRADE_RPC_TIMEOUT):
  """The lost-server test's loader: ring seeds 0-19 from server 0 and
  20-39 from server 1, four batches each, a lost server degrading the
  epoch."""
  return RemoteNeighborLoader(
      [2], [np.arange(20), np.arange(20, 40)], batch_size=5, seed=3,
      device='cpu', worker_options=RemoteDistSamplingWorkerOptions(
          server_rank=[0, 1], prefetch_size=2, worker_key=worker_key,
          rpc_timeout=rpc_timeout))


def test_server_client_example_trains():
  """First in the module: the example runs its own servers and client
  session, before the module's servers start theirs."""
  from glt_tpu_torch.examples.distributed import server_client_mode
  out = server_client_mode.main(
      ['--device', 'cpu', '--num-nodes', '300', '--batch-size', '50',
       '--fanout', '4,3', '--hidden', '16', '--epochs', '2',
       '--max-steps', '2', '--prefetch', '2'])
  assert len(out['losses']) == 4 and np.isfinite(out['losses']).all()
  assert out['exitcodes'] == [0, 0]


@pytest.mark.parametrize('package', ['port', 'jax'])
def test_a_fetch_past_its_budget_fails_as_in_jax(package):
  """The rpc beneath a loader's fetch, in both packages. A reply slower
  than one attempt's share of the budget still arrives: the retry waits
  on the server for the original execution (request-id dedup). A reply
  slower than the whole budget raises a timeout, which both packages'
  loaders take for a lost server; the server's execution still runs and
  pops a batch that nobody reads."""
  if package == 'port':
    from glt_tpu_torch.distributed.rpc import RpcClient, RpcServer
  else:
    from glt_tpu.distributed.rpc import RpcClient, RpcServer
  calls = []

  def slow_fetch(hold_s):
    calls.append(hold_s)
    time.sleep(hold_s)
    return b'batch'
  srv = RpcServer()
  srv.register('fetch_one_sampled_message', slow_fetch)
  cli = RpcClient(srv.host, srv.port)
  try:
    # four attempts of 1 s each, the reply after 1.5 s
    assert cli.request('fetch_one_sampled_message', 1.5,
                       _rpc_timeout=4.0) == b'batch'
    assert calls == [1.5] and cli.retries >= 1
    with pytest.raises(OSError):     # socket.timeout is an OSError
      cli.request('fetch_one_sampled_message', 1.5, _rpc_timeout=1.0)
    time.sleep(1.0)
    assert calls == [1.5, 1.5]
  finally:
    cli.close()
    srv.stop()


def test_slow_worker_start_is_not_a_lost_server(jax_env):
  """Before the module's servers: a server pair of its own, server 1's
  sampling worker starting HOLD_S late while both stay alive. The
  lost-server test's loader keeps all 8 batches of the first epoch; at
  the 20 s budget it once had, server 1 was taken for lost and its share
  dropped (4 batches), whatever the machine's load."""
  with spawned_servers(holds=(0.0, HOLD_S)):
    loader = degrade_loader('held')
    t0 = time.monotonic()
    got = [int(b.batch[0]) >= 20 for b in loader]
    assert time.monotonic() - t0 > HOLD_S
    assert len(got) == 8 and sum(got) == 4
    assert loader.degraded_servers == set()
    assert fabric_stats()['dropouts'] == []


def test_data_plane_answers_as_jax(servers):
  from glt_tpu.channel import pack_message as jpack
  from glt_tpu.channel import unpack_message as junpack
  from glt_tpu.distributed import DistServer as JaxDistServer
  jsrv = JaxDistServer(jax_ring())
  ids = np.array([3, 7, 0, 39])
  for name in ('get_node_feature', 'get_node_label'):
    got = unpack_message(request_server(1, name, pack_message({'ids': ids})))
    want = junpack(getattr(jsrv, name)(jpack({'ids': ids})))
    for k in want:
      np.testing.assert_array_equal(got[k].numpy(), want[k])
  got = unpack_message(request_server(0, 'get_edge_index'))['edge_index']
  np.testing.assert_array_equal(
      got.numpy(), junpack(jsrv.get_edge_index())['edge_index'])
  for name in ('get_dataset_meta', 'get_tensor_size', 'get_edge_size'):
    assert request_server(0, name) == getattr(jsrv, name)(), name
  ping = request_server(0, 'ping')
  assert ping['ok'] and ping['partition_idx'] == 0
  assert ping['obs_tracing'] is False      # the server's tracer is off
  # apply_delta stages into the server's stream and replies as JAX's
  # DistServer does to the same payload (staged, not compacted: the graph
  # the later tests read stays as it was)
  payload = {'ins': np.array([[0, 1], [6, 7]], np.int64)}
  got = request_server(0, 'apply_delta', pack_message(payload))
  assert got == jsrv.apply_delta(jpack(payload))
  assert got == {'applied': {'inserts': 2, 'deletes': 0, 'feature_rows': 0},
                 'version': 0, 'pending': 2, 'compacted': False}


def test_remote_loader_matches_jax(servers):
  """with_edge (eids, edge features), a shuffled order, two epochs."""
  per_server = [np.arange(20), np.arange(20, 40)]
  cfg = dict(num_neighbors=[2], batch_size=6, shuffle=True,
             drop_last=False, with_edge=True, collect_features=True, seed=1)
  loader = RemoteNeighborLoader(
      [2], per_server, batch_size=6, shuffle=True, with_edge=True, seed=1,
      device='cpu', worker_options=RemoteDistSamplingWorkerOptions(
          server_rank=[0, 1], prefetch_size=2))
  want = [jax_reference(s, cfg, (0, 1)) for s in per_server]
  for epoch in (0, 1):
    got = {0: [], 1: []}
    for b in loader:
      assert b.node.device.type == 'cpu'
      got[int(b.batch[0] >= 20)].append(_np_batch(b))
    for s in (0, 1):
      assert len(got[s]) == len(want[s][epoch]) == 4
      for i, (g, w) in enumerate(zip(got[s], want[s][epoch])):
        assert_same(g, w, f'server {s} epoch {epoch} batch {i}')
    em = got[0][0]['edge_mask']
    assert em.any()
    np.testing.assert_array_equal(got[0][0]['edge_attr'][em][:, 0],
                                  got[0][0]['edge'][em])
  # the orders differ between epochs
  assert not np.array_equal(want[0][0][0]['node'], want[0][1][0]['node'])


def test_remote_loader_split_names_match_jax(servers):
  """Each server resolves the split against its own dataset (the same
  one here): every train seed comes once from each server."""
  loader = RemoteNeighborLoader(
      [2], 'train', batch_size=5, seed=2, device='cpu',
      worker_options=RemoteDistSamplingWorkerOptions(
          server_rank=[0, 1], prefetch_size=2, worker_key='bysplit'))
  got = [_np_batch(b) for b in loader]
  train = jax_ring().get_split('train')
  cfg = dict(num_neighbors=[2], batch_size=5, collect_features=True, seed=2)
  want = jax_reference(train, cfg, (0,))[0]
  assert len(got) == 2 * len(want) == 8
  assert (collections.Counter(map(_key, got))
          == collections.Counter(map(_key, want * 2)))
  by_key = {_key(w): w for w in want}
  for g in got:
    assert_same(g, by_key[_key(g)], 'split batch')
  seen = collections.Counter(
      v for g in got for v in g['node'][:g['n_valid']].tolist())
  assert sorted(seen) == sorted(train.tolist()) and set(seen.values()) == {2}


def test_mp_loader_matches_jax_heals_and_never_hangs(jax_env):
  from glt_tpu_torch.channel import QueueTimeoutError
  cfg = dict(num_neighbors=[2], batch_size=8, shuffle=True,
             collect_features=True, seed=0)
  seeds = np.arange(40)
  halves = np.array_split(seeds, 2)
  want = [jax_reference(halves[r], cfg, (0, 2, 3), num_workers=2, rank=r)
          for r in (0, 1)]
  loader = MpNeighborLoader(
      torch_server_worker.build_ring_dataset, [2], input_nodes=seeds,
      batch_size=8, shuffle=True, collect_features=True, seed=0,
      device='cpu', worker_options=MpDistSamplingWorkerOptions(
          num_workers=2, rpc_timeout=120.0))

  def check(epoch):
    got = {0: [], 1: []}
    for b in loader:
      got[int(b.batch[0] >= 20)].append(_np_batch(b))
    for r in (0, 1):
      assert len(got[r]) == len(want[r][epoch]) == 3, (epoch, r)
      for i, (g, w) in enumerate(zip(got[r], want[r][epoch])):
        assert_same(g, w, f'mp worker {r} epoch {epoch} batch {i}')

  try:
    check(0)
    it = iter(loader)          # epoch 1: two of six batches, abandoned
    next(it)
    next(it)
    del it
    time.sleep(1.0)            # the workers buffer epoch 1's leftovers
    check(2)                   # epoch 2 sees exactly its own batches
    for w in loader.producer._workers:     # every worker dies between
      w.kill()                             # epochs
      w.join(timeout=JOIN_S)
    check(3)                   # respawned at the epoch's start
    assert all(w.is_alive() for w in loader.producer._workers)
    # a death mid-epoch: the rest ends in a timeout or the epoch's end
    loader.options.rpc_timeout = 3.0
    it = iter(loader)
    next(it)
    for w in loader.producer._workers:
      w.kill()
      w.join(timeout=JOIN_S)
    t0 = time.monotonic()
    with pytest.raises((QueueTimeoutError, StopIteration)):
      for _ in range(100):
        next(it)
    assert time.monotonic() - t0 < 30
  finally:
    loader.shutdown()
  assert not loader.producer._workers


def test_message_to_batch_slices_as_to_batch():
  """A worker's message, through message_to_batch, is the in-process
  batch (to_batch), the hops' edge offsets included."""
  from glt_tpu_torch.data.feature import gather_features
  from glt_tpu_torch.distributed import (flatten_sampler_output,
                                         message_to_batch)
  from glt_tpu_torch.loader.transform import to_batch
  from glt_tpu_torch.sampler import NeighborSampler, SamplingConfig
  ds = torch_server_worker.ring_dataset()
  sampler = NeighborSampler(ds.get_graph(), [2, 2], device='cpu',
                            with_edge=True, seed=0)
  seeds = np.array([3, 5, 8, 8])
  out = sampler.sample_from_nodes(seeds, n_valid=3)
  x = gather_features(ds.get_node_feature(), out.node.clamp(min=0))
  msg = unpack_message(pack_message(flatten_sampler_output(out, x=x)))
  msg['n_valid'] = torch.tensor([3], dtype=torch.int32)
  b = message_to_batch(msg, SamplingConfig(num_neighbors=[2, 2],
                                           batch_size=4), device='cpu')
  ref = to_batch(out, x=x, batch_size=4)
  for f in FIELDS:
    a, r = getattr(b, f), getattr(ref, f)
    assert (a is None) == (r is None), f
    if a is not None:
      assert torch.equal(a, r), f
  assert b.edge_hop_offsets == ref.edge_hop_offsets == (0, 8, 24)
  assert b.metadata == {'n_valid': 3} and torch.equal(b.batch, out.batch)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    if not torch.cuda.is_available():
      message_to_batch(msg, SamplingConfig(batch_size=4))
    else:
      raise RuntimeError('no CUDA device (not run on a card)')


def test_lost_server_degrades_the_epoch(servers):
  """Server 1 is killed: the next epoch finishes with server 0's batches
  and the client records the dropout (degrade_on_server_failure)."""
  loader = degrade_loader('degrade')
  assert sum(1 for _ in loader) == 8
  servers[1].kill()
  servers[1].join(timeout=JOIN_S)
  got = [b for b in loader]
  assert len(got) == 4 and all(int(b.batch[0]) < 20 for b in got)
  assert loader.degraded_servers == {1}
  assert fabric_stats()['dropouts'] == [1]
  # the session's ServingMetrics (JAX's keys) records the dropout
  assert fabric_stats()['metrics']['gauges'] == {'server_dropouts': 1.0}
  # the feature lookup's ladder: a replica (server 0 holds the same
  # rows), then the staleness cache and zero rows
  from glt_tpu_torch.distributed import dist_client, set_replicas
  feats = torch_server_worker.ring_dataset().get_node_feature()
  set_replicas({1: [0]})
  rows = dist_client.get_node_feature(1, [3, 7])
  assert torch.equal(rows, torch.from_numpy(feats[np.array([3, 7])]))
  set_replicas({})
  with pytest.raises(ConnectionError):
    dist_client.get_node_feature(1, [3, 9], degrade=False)
  rows = dist_client.get_node_feature(1, [3, 9])
  assert torch.equal(rows[0], torch.from_numpy(feats[np.array([3])])[0])
  assert not rows[1].any()
  assert fabric_stats()['degraded_cache_rows'] == 2
  metrics = fabric_stats()['metrics']
  assert metrics['failovers'] >= 1 and metrics['stale_serves'] == 1
  assert metrics['gauges']['degraded_zero_fills'] == 1.0
