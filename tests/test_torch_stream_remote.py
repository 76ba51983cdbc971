"""Live updates of a sampling server's partition in the port
(``DistServer.apply_delta``, ``dist_client.apply_delta``) and the seeded
fault injection (glt_tpu_torch.resilience.chaos) against the JAX package:

- ``apply_delta`` stages inserts, deletes and feature rows and compacts
  on ``compact``; its replies, and the data plane after the swap
  (``get_edge_size``, ``get_edge_index``, ``get_node_feature``), equal
  the JAX DistServer's for the same payloads (tests/test_stream.py:508);
  a compaction the policy fires while staging rebinds the dataset too
  (:607); racing first calls build one stream (:626);
- over the rpc fabric: a port client to a port server, a JAX RpcClient
  posting JAX-packed bytes to a port server and a port client posting
  port-packed bytes to a JAX server, with equal replies; the client's
  payload packs byte for byte as JAX's; ``init_server``, ``init_client``
  and ``dist_client.apply_delta`` end to end;
- the port's ``FaultPlan`` schedules equal JAX's for the same seed,
  forks included (tests/test_chaos.py:446), and ``apply_delta`` retried
  through a lossy ``ChaosTcpProxy`` never stages a delta twice (:458),
  also when exactly the first reply is dropped.

Every server, client and proxy is stopped in a ``finally``; rpc requests
carry short deadlines.
"""
import threading

import numpy as np
import pytest

from fixtures import ring_dataset as jax_ring
from glt_tpu.channel import pack_message as jpack
from glt_tpu.channel import unpack_message as junpack
from glt_tpu.distributed import rpc as jrpc
from glt_tpu.distributed.dist_server import DistServer as JaxDistServer
from glt_tpu.resilience import FaultPlan as JaxFaultPlan
from glt_tpu.stream import CompactionPolicy as JaxPolicy
from glt_tpu_torch.channel import pack_message, unpack_message
from glt_tpu_torch.distributed import dist_client
from glt_tpu_torch.distributed import rpc as prpc
from glt_tpu_torch.distributed.dist_server import DistServer
from glt_tpu_torch.resilience import (ChaosTcpProxy, CircuitBreaker,
                                      FaultPlan, RetryPolicy, chaos_seed)
from glt_tpu_torch.stream import CompactionPolicy
from torch_server_worker import ring_dataset

N, D = 12, 16
PAYLOADS = (
    {'ins': np.array([[0, 1], [6, 7]], np.int64)},
    {'dels': np.array([[0], [1]], np.int64),
     'feat_ids': np.array([2], np.int64),
     'feat_rows': np.full((1, D), 42.0, np.float32),
     'compact': np.ones(1, np.int8)},
)


def servers():
  return (JaxDistServer(jax_ring(num_nodes=N, feat_dim=D)),
          DistServer(ring_dataset(num_nodes=N, feat_dim=D)))


def test_apply_delta_round_trip_matches_jax():
  jsrv, psrv = servers()
  before = psrv.get_edge_size()
  assert before == jsrv.get_edge_size()
  for payload in PAYLOADS:
    want = jsrv.apply_delta(jpack(payload))
    got = psrv.apply_delta(pack_message(payload))
    assert got == want
  assert got == {'applied': {'inserts': 0, 'deletes': 1, 'feature_rows': 1},
                 'version': 1, 'pending': 0, 'compacted': True}
  # the data plane serves the fresh snapshot at once
  assert psrv.get_edge_size() == jsrv.get_edge_size() == before + 2 - 1
  np.testing.assert_array_equal(
      unpack_message(psrv.get_edge_index())['edge_index'].numpy(),
      junpack(jsrv.get_edge_index())['edge_index'])
  ids = {'ids': np.array([2, 5], np.int64)}
  feats = unpack_message(psrv.get_node_feature(pack_message(ids)))['feats']
  np.testing.assert_array_equal(
      feats.numpy(), junpack(jsrv.get_node_feature(jpack(ids)))['feats'])
  np.testing.assert_allclose(feats[0].numpy(), 42.0)
  mgr = psrv._stream_ingestor().manager
  assert mgr.device.type == 'cpu'          # the dataset's device
  assert psrv.dataset.get_graph().topo is mgr.current().topo
  assert psrv.dataset.get_node_feature() is mgr.current().feature


def test_dist_server_rebinds_on_auto_compaction():
  jsrv, psrv = servers()
  replies = []
  for srv, pack, Policy in ((jsrv, jpack, JaxPolicy),
                            (psrv, pack_message, CompactionPolicy)):
    srv._stream_ingestor().policy = Policy(occupancy_threshold=1e-9,
                                           max_staleness_s=1e9)
    before = srv.get_edge_size()
    replies.append(srv.apply_delta(pack({
        'ins': np.array([[0], [6]], np.int64)})))   # no compact flag
    assert srv.get_edge_size() == before + 1          # dataset rebound
  assert replies[1] == replies[0]
  assert replies[1]['compacted'] and replies[1]['version'] >= 1


def test_dist_server_stream_init_is_single():
  _, psrv = servers()
  got = []
  threads = [threading.Thread(
      target=lambda: got.append(psrv._stream_ingestor())) for _ in range(4)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=30)
  assert len(got) == 4 and all(g is got[0] for g in got)


@pytest.mark.parametrize('client,server', [('port', 'port'), ('jax', 'port'),
                                           ('port', 'jax')])
def test_apply_delta_over_rpc_across_packages(client, server):
  jsrv, psrv = servers()
  want = [jsrv.apply_delta(jpack(p)) for p in PAYLOADS]
  srv = (DistServer(ring_dataset(num_nodes=N, feat_dim=D)) if server == 'port'
         else JaxDistServer(jax_ring(num_nodes=N, feat_dim=D)))
  rpc = prpc if server == 'port' else jrpc
  endpoint = rpc.RpcServer(host='127.0.0.1', port=0, auto_start=False)
  endpoint.register('apply_delta', srv.apply_delta)
  endpoint.start()
  cli = None
  try:
    pack, Client = ((pack_message, prpc.RpcClient) if client == 'port'
                    else (jpack, jrpc.RpcClient))
    cli = Client(endpoint.host, endpoint.port, timeout=30)
    got = [cli.request('apply_delta', pack(p)) for p in PAYLOADS]
  finally:
    if cli is not None:
      cli.close()
    endpoint.stop()
  assert got == want
  assert got[1]['compacted'] and got[1]['version'] == 1


def test_client_payload_packs_as_jax(monkeypatch):
  from glt_tpu.distributed import dist_client as jax_client
  sent = {}
  monkeypatch.setattr(jax_client, 'request_server',
                      lambda r, m, b: sent.setdefault('jax', (r, m, b)))
  monkeypatch.setattr(dist_client, 'request_server',
                      lambda r, m, b: sent.setdefault('port', (r, m, b)))
  kw = dict(ins=[[0, 1], [6, 7]], dels=[[3], [4]], feat_ids=[2, 9],
            feat_rows=np.ones((2, D), np.float32), compact=True)
  jax_client.apply_delta(1, **kw)
  dist_client.apply_delta(1, **kw)
  assert sent['port'] == sent['jax']
  assert sent['port'][:2] == (1, 'apply_delta')


def test_apply_delta_through_init_server_and_init_client():
  from glt_tpu_torch.distributed import (free_port_base, init_client,
                                         init_server, shutdown,
                                         shutdown_client, shutdown_server)
  port = free_port_base(1)
  srv = init_server(num_servers=1, num_clients=1, server_rank=0,
                    dataset=ring_dataset(num_nodes=N, feat_dim=D),
                    master_port=port, device='cpu')
  try:
    init_client(num_servers=1, num_clients=1, client_rank=0,
                master_port=port, rpc_timeout=30.0, health_interval_s=None)
    try:
      before = dist_client.request_server(0, 'get_edge_size')
      out = dist_client.apply_delta(0, ins=[[0, 1], [6, 7]], dels=[[0], [1]],
                                    feat_ids=[2], feat_rows=np.full(
                                        (1, D), 7.0, np.float32),
                                    compact=True)
      assert out == {'applied': {'inserts': 2, 'deletes': 1,
                                 'feature_rows': 1},
                     'version': 1, 'pending': 0, 'compacted': True}
      assert dist_client.request_server(0, 'get_edge_size') == before + 1
      feats = unpack_message(dist_client.request_server(
          0, 'get_node_feature',
          pack_message({'ids': np.array([2], np.int64)})))['feats']
      np.testing.assert_allclose(feats.numpy(), 7.0)
    finally:
      shutdown_client()
    assert srv.should_exit               # client 0 told the server to exit
  finally:
    shutdown_server()
    shutdown()                           # the process's DistContext


# -- chaos ---------------------------------------------------------------------------

@pytest.mark.parametrize('kw', [
    dict(seed=1234, drop=0.15, disconnect=0.1, delay=0.1),
    dict(seed=7, drop=0.3, truncate=0.2, start_after=5, max_faults=9),
])
def test_fault_plan_schedule_matches_jax(kw):
  a, b = FaultPlan(**kw), JaxFaultPlan(**kw)
  assert a.schedule(500) == b.schedule(500)
  fa, fb = a.fork(9), b.fork(9)
  assert fa.seed == fb.seed
  assert [fa.next_fault() for _ in range(200)] \
      == [fb.next_fault() for _ in range(200)]
  assert [a.next_fault() for _ in range(100)] \
      == [b.next_fault() for _ in range(100)]
  assert a.injected == b.injected and sum(a.injected.values()) > 0


def test_chaos_seed_reads_the_knob_as_jax(monkeypatch):
  from glt_tpu.resilience import chaos_seed as jax_chaos_seed
  monkeypatch.delenv('GLT_CHAOS_SEED', raising=False)
  assert chaos_seed() == jax_chaos_seed() == 0
  monkeypatch.setenv('GLT_CHAOS_SEED', '99')
  assert chaos_seed() == jax_chaos_seed() == 99
  assert FaultPlan().seed == JaxFaultPlan().seed == 99


class _FirstReplyDrop(FaultPlan):
  """Drops the first frame of connection 0's server-to-client direction
  (its first reply) and nothing else."""

  def fork(self, salt):
    child = super().fork(salt)
    if salt != 1:
      child.rates = {k: 0.0 for k in child.rates}
    return child


def _counted_server():
  srv = DistServer(ring_dataset(num_nodes=200, feat_dim=D))
  executed = []
  lock = threading.Lock()

  def apply_delta(payload):
    out = srv.apply_delta(payload)
    with lock:
      executed.append(out['pending'])
    return out
  endpoint = prpc.RpcServer(host='127.0.0.1', port=0, auto_start=False)
  endpoint.register('apply_delta', apply_delta)
  endpoint.start()
  return srv, endpoint, executed


@pytest.mark.parametrize('plan,cuts', [
    (FaultPlan(seed=1234, drop=0.2, disconnect=0.1, delay=0.1,
               delay_s=0.01), 16),
    (_FirstReplyDrop(seed=0, drop=1.0, max_faults=1), 3),
], ids=['lossy', 'first_reply'])
def test_apply_delta_retry_never_double_stages(plan, cuts):
  srv, endpoint, executed = _counted_server()
  proxy = ChaosTcpProxy(endpoint.host, endpoint.port, plan)
  cli = None
  try:
    cli = prpc.RpcClient(
        *proxy.address, timeout=10,
        retry=RetryPolicy(max_attempts=8, base_delay_s=0.01,
                          max_delay_s=0.05, jitter=0),
        breaker=CircuitBreaker(failure_threshold=1000),
        idempotent=frozenset({'apply_delta'}))
    pending = []
    for cut in range(cuts):
      out = cli.request('apply_delta', pack_message({
          'ins': np.array([[cut], [cut + 100]], np.int64)}),
          _rpc_timeout=2.0)
      pending.append(out['pending'])
    assert cli.retries > 0 and sum(proxy.faults_injected.values()) > 0
  finally:
    if cli is not None:
      cli.close()
    proxy.close()
    endpoint.stop()
  # each cut staged once, and every reply (replayed ones too) the one the
  # server recorded: the pending count the client saw is the staging order
  assert executed == list(range(1, cuts + 1))
  assert pending == list(range(1, cuts + 1))
  assert srv._stream_ingestor().edges.total_inserts == cuts
  if isinstance(plan, _FirstReplyDrop):
    assert proxy.faults_injected == {'delay': 0, 'drop': 1,
                                     'disconnect': 0, 'truncate': 0}
