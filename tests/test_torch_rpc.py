"""The port's rpc fabric and resilience primitives
(glt_tpu_torch.distributed.rpc, glt_tpu_torch.resilience) against the JAX
package's:

- the frames are the JAX package's: a JAX ``RpcClient`` calls a port
  ``RpcServer`` and a port client a JAX server (plain and idempotent
  requests, callee errors, async requests, ``ping_endpoint``); all in
  threads of this process;
- scripted failures (a lost reply of an idempotent callee, replayed from
  the server's dedup cache; a lost reply of a mutating one; a callee
  error; a dead peer tripping the breaker) give the same outcomes in
  every pairing of the two packages' clients and servers;
- RetryPolicy, CircuitBreaker, HealthMonitor and DegradedFeatureCache
  step through the same states as JAX's;
- a 64 MiB payload round-trips within 10 s (the receive fills one buffer;
  growing it chunk by chunk is quadratic);
- the event loop, the worker context and init_rpc's argument checks.
"""
import random
import socket
import threading
import time

import numpy as np
import pytest
import torch

import glt_tpu.distributed.rpc as jax_rpc
import glt_tpu.resilience as jax_res
import glt_tpu_torch.distributed.rpc as port_rpc
import glt_tpu_torch.resilience as port_res

RPC = {'jax': jax_rpc, 'port': port_rpc}
RES = {'jax': jax_res, 'port': port_res}
PAIRS = [('jax', 'port'), ('port', 'jax'), ('port', 'port'), ('jax', 'jax')]


def _server(pkg, **callees):
  srv = RPC[pkg].RpcServer(auto_start=False)
  for name, fn in callees.items():
    srv.register(name, fn)
  srv.start()
  return srv


@pytest.mark.parametrize('client,server', PAIRS[:2])
def test_rpc_frames_interoperate(client, server):
  srv = _server(server, add=lambda a, b: a + b,
                echo=lambda x: x,
                boom=lambda: (_ for _ in ()).throw(ValueError('x')),
                get_node_feature=lambda ids: np.asarray(ids) * 2)
  cli = RPC[client].RpcClient(srv.host, srv.port)
  try:
    assert cli.request('add', 2, 3) == 5
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(cli.request('echo', arr), arr)
    assert cli.request('echo', b'\x00' * 1000) == b'\x00' * 1000
    # an idempotent callee: the request carries a request id (4 elements)
    np.testing.assert_array_equal(
        cli.request('get_node_feature', np.array([1, 2])), [2, 4])
    assert cli.async_request('add', 10, 20).result(timeout=30) == 30
    with pytest.raises(ValueError, match='x'):
      cli.request('boom')
    assert cli.breaker.state == 'CLOSED'
    for pkg in ('jax', 'port'):
      assert RPC[pkg].ping_endpoint(srv.host, srv.port)['ok']
  finally:
    cli.close()
    srv.stop()


def test_port_server_ignores_a_trace_context():
  srv = _server('port', add=lambda a, b: a + b)
  try:
    with socket.create_connection((srv.host, srv.port), timeout=10) as s:
      port_rpc._send_msg(s, ('add', (1, 2), {}, None, ('trace', 'span')))
      assert port_rpc._recv_msg(s) == ('ok', 3)
  finally:
    srv.stop()


def test_stopped_port_server_accepts_no_connection():
  """Once ``stop`` returns, the port's server is unreachable even when its
  accept loop was blocked in ``accept`` at the time (a bare close left the
  listening socket open until that accept took one more connection)."""
  srv = _server('port', add=lambda a, b: a + b)
  cli = port_rpc.RpcClient(srv.host, srv.port)
  try:
    assert cli.request('add', 1, 2) == 3   # the loop is back in accept
    srv.stop()
    srv._accept_thread.join(timeout=30)
    assert not srv._accept_thread.is_alive()
    with pytest.raises(ConnectionRefusedError):
      socket.create_connection((srv.host, srv.port), timeout=5).close()
  finally:
    cli.close()
    srv.stop()


def _drop_replies(monkeypatch, mod, n):
  """The next ``n`` replies ``mod``'s servers send are lost: the server
  shuts the connection instead (the callee has run)."""
  real = mod._send_msg
  left = [n]

  def send(sock, obj):
    if (isinstance(obj, tuple) and len(obj) == 2 and obj[0] in ('ok', 'err')
        and left[0] > 0):
      left[0] -= 1
      sock.shutdown(socket.SHUT_RDWR)
      raise ConnectionError('reply lost (scripted)')
    return real(sock, obj)
  monkeypatch.setattr(mod, '_send_msg', send)


def _kill(srv):
  """Stop ``srv`` and return once it accepts nothing more. A JAX server's
  ``stop`` closes its listening socket under an accept loop blocked in
  another thread, which keeps it listening until that accept returns (the
  port's shuts it down first): give that accept a connection of its own,
  so that the loop sees the stop and ends, then join it. Without this a
  dead peer took the client's next dial whenever the loop was back in
  accept before ``stop``."""
  srv.stop()
  try:
    socket.create_connection((srv.host, srv.port), timeout=5).close()
  except OSError:
    pass
  srv._accept_thread.join(timeout=30)
  assert not srv._accept_thread.is_alive()


def _scenario(monkeypatch, client, server, what):
  """One scripted failure through ``client``'s RpcClient to ``server``'s
  RpcServer; the outcome as plain values."""
  runs = []

  def callee(x):
    runs.append(x)
    return x + 1
  srv = _server(server, get_node_feature=callee, mutate=callee,
                boom=lambda: (_ for _ in ()).throw(KeyError('k')))
  C = RPC[client]
  res = RES[client]
  cli = C.RpcClient(
      srv.host, srv.port,
      retry=res.RetryPolicy(max_attempts=3, base_delay_s=0.001, jitter=0),
      breaker=res.CircuitBreaker(failure_threshold=3, reset_timeout_s=60))
  outcomes = []
  try:
    if what in ('lost_reply_idempotent', 'lost_reply_mutating'):
      _drop_replies(monkeypatch, RPC[server], 1)
      name = ('get_node_feature' if what == 'lost_reply_idempotent'
              else 'mutate')
      for x in (1, 10):
        try:
          outcomes.append(cli.request(name, x))
        except Exception as e:
          outcomes.append(type(e).__name__)
    elif what == 'callee_error':
      for _ in range(4):
        try:
          cli.request('boom')
        except Exception as e:
          outcomes.append(type(e).__name__)
    else:   # a dead peer: the breaker opens after 3 failures
      _kill(srv)
      for _ in range(3):
        try:
          cli.request('get_node_feature', 1, _rpc_timeout=5)
        except Exception as e:
          outcomes.append(type(e).__name__)
    return dict(outcomes=outcomes, runs=runs, retries=cli.retries,
                reconnects=cli.reconnects, breaker=cli.breaker.state,
                opens=cli.breaker.opens, dedup_hits=srv.dedup_hits)
  finally:
    cli.close()
    srv.stop()


@pytest.mark.parametrize('what', ['lost_reply_idempotent',
                                  'lost_reply_mutating', 'callee_error',
                                  'dead_peer'])
def test_scripted_failures_match_jax(monkeypatch, what):
  got = {}
  for client, server in PAIRS:
    with monkeypatch.context() as mp:
      got[client, server] = _scenario(mp, client, server, what)
  want = got['jax', 'jax']
  for pair, out in got.items():
    assert out == want, (pair, out, want)
  if what == 'lost_reply_idempotent':
    # executed once, the lost reply replayed from the dedup cache
    assert want['outcomes'] == [2, 11] and want['runs'] == [1, 10]
    assert want['dedup_hits'] == 1 and want['retries'] == 1
  elif what == 'lost_reply_mutating':
    assert want['outcomes'] == ['ConnectionError', 11]
    assert want['runs'] == [1, 10] and want['retries'] == 0
  elif what == 'callee_error':
    assert want['outcomes'] == ['KeyError'] * 4
    assert want['breaker'] == 'CLOSED'
  else:
    assert want['outcomes'][-1] == 'CircuitOpenError'
    assert want['breaker'] == 'OPEN' and want['opens'] == 1


def _primitives(res, what):
  if what == 'retry':
    p = res.RetryPolicy(max_attempts=5, base_delay_s=0.1, max_delay_s=0.5,
                        jitter=0)
    q = res.RetryPolicy(base_delay_s=0.1, max_delay_s=10.0, jitter=0.5)
    rng = random.Random(7)
    return ([p.delay(a) for a in range(6)],
            [q.delay(a, rng) for a in range(6)])
  if what == 'breaker':
    opened = []
    # a reset timeout far above the time between two steps of the script
    b = res.CircuitBreaker(failure_threshold=2, reset_timeout_s=0.3,
                           on_open=lambda: opened.append(1))
    trace = []
    for op in ('f', 's', 'f', 'f', 'a', 'w', 'a', 'a', 'f', 'w', 'a', 'r',
               'a', 's', 'a'):
      if op == 'f':
        b.record_failure()
      elif op == 's':
        b.record_success()
      elif op == 'a':
        trace.append(b.allow())
      elif op == 'r':
        b.release_probe()
      else:
        time.sleep(0.35)
      trace.append(b.state)
    return trace, b.opens, len(opened)
  if what == 'health':
    ok = {'a': True, 'b': True}

    def probe(name):
      def run():
        if not ok[name]:
          raise ConnectionError('down')
      return run
    m = res.HealthMonitor({'a': probe('a'), 'b': probe('b')},
                          degraded_after=1, down_after=3, interval_s=5.0)
    trace = [m.check_now()]
    ok['b'] = False
    trace += [m.check_now() for _ in range(3)]
    trace.append(m.healthy())
    trace.append([m.allow_probe('b'), m.allow_probe('b')])
    ok['b'] = True
    trace.append(m.check_now())
    m.record_failure('a')
    trace.append(m.snapshot())
    return trace
  c = res.DegradedFeatureCache(capacity=3)
  rows = np.arange(8, dtype=np.float32).reshape(4, 2)
  c.update([1, 2, 3, 4], rows)      # past capacity: the oldest goes
  got, mask = c.serve([2, 7, 1, 4])
  return np.asarray(got).tolist(), np.asarray(mask).tolist(), len(c)


@pytest.mark.parametrize('what', ['retry', 'breaker', 'health', 'cache'])
def test_resilience_primitives_match_jax(what):
  assert _primitives(port_res, what) == _primitives(jax_res, what)


def test_degraded_cache_without_a_width_raises():
  with pytest.raises(RuntimeError, match='width'):
    port_res.DegradedFeatureCache().serve([1])


def test_64_mib_payload_round_trips_within_10_s():
  payload = np.random.default_rng(0).bytes(64 << 20)
  srv = _server('port', echo=lambda x: x)
  cli = port_rpc.RpcClient(srv.host, srv.port)
  try:
    t0 = time.perf_counter()
    got = cli.request('echo', payload)
    secs = time.perf_counter() - t0
    assert got == payload
    assert secs < 10.0, f'64 MiB took {secs:.2f} s'
  finally:
    cli.close()
    srv.stop()


def test_late_registration_and_fabric_checks():
  srv = port_rpc.RpcServer()
  try:
    cli = port_rpc.RpcClient(srv.host, srv.port)
    threading.Timer(0.3, lambda: srv.register('late',
                                              lambda x: x + 1)).start()
    assert cli.request('late', 41) == 42
    cli.close()
  finally:
    srv.stop()
  with pytest.raises(ValueError, match='rank/world_size'):
    port_rpc.init_rpc('127.0.0.1', 29999)
  with pytest.raises(ValueError, match='concrete pre-agreed port'):
    port_rpc.init_rpc('127.0.0.1', 0, rank=0, world_size=1)
  router = port_rpc.RpcDataPartitionRouter({0: [3, 5], 1: [4]})
  assert [router.get_to_worker(0) for _ in range(3)] == [3, 5, 3]


def test_event_loop_and_worker_context():
  from glt_tpu_torch.distributed import (ConcurrentEventLoop, get_context,
                                         init_worker_group, shutdown)
  loop = ConcurrentEventLoop(concurrency=2)
  active, peak, lock = [0], [0], threading.Lock()

  def task(i):
    with lock:
      active[0] += 1
      peak[0] = max(peak[0], active[0])
    time.sleep(0.02)
    with lock:
      active[0] -= 1
    return i * 2
  got = []
  for i in range(6):
    loop.add_task(task, i, callback=got.append)
  loop.wait_all()
  assert sorted(got) == [0, 2, 4, 6, 8, 10] and peak[0] <= 2
  assert loop.run_task(task, 21) == 42
  with pytest.raises(RuntimeError, match='nested add_task'):
    loop.run_task(lambda: loop.add_task(lambda: None))
  loop.add_task(lambda: (_ for _ in ()).throw(RuntimeError('boom')))
  with pytest.raises(RuntimeError, match='boom'):
    loop.wait_all()
  loop.shutdown()
  assert not torch.distributed.is_initialized()
  ctx = init_worker_group()
  assert (ctx.world_size, ctx.rank, ctx.is_worker) == (1, 0, True)
  assert get_context() is ctx
  assert init_worker_group(4, 2).rank == 2
  shutdown()
  assert get_context() is None
