"""The port's channel layer (glt_tpu_torch.channel) against the JAX
package's (glt_tpu.channel):

- ``pack_message`` writes the JAX bytes for every dtype code (bf16 as its
  16-bit words, a 0-d entry as shape (1,), an empty one), and each
  package unpacks the other's; the port's unpack views the buffer;
- the port's own shared-memory ring (built from
  ``glt_tpu_torch/csrc/shm_queue.cc`` into ``glt_tpu_torch/_build/``)
  keeps FIFO order over wraparound, times out, refuses a block it cannot
  hold with EMSGSIZE, and shares a segment with the JAX package's ring;
- a ShmChannel crosses to a spawned process, with backpressure;
- RemoteReceivingChannel's prefetch, epochs and per-server bound;
- the feature_mp example's rows equal the Feature's own.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import torch_server_worker
from glt_tpu.channel import ShmQueue as JaxShmQueue
from glt_tpu.channel import pack_message as jax_pack
from glt_tpu.channel import unpack_message as jax_unpack
from glt_tpu_torch.channel import (QueueTimeoutError, RemoteReceivingChannel,
                                   ShmChannel, ShmQueue, pack_message,
                                   unpack_message)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_entries():
  import ml_dtypes
  rng = np.random.default_rng(0)
  return {
      'bool': np.array([True, False, True]),
      'int8': np.arange(-3, 3, dtype=np.int8),
      'uint8': np.arange(250, 256, dtype=np.uint8),
      'int16': np.arange(-2, 5, dtype=np.int16).reshape(7, 1),
      'int32': np.arange(6, dtype=np.int32).reshape(2, 3),
      'int64': np.array([-1, 2 ** 40, 3], np.int64),
      'float16': rng.normal(size=5).astype(np.float16),
      'float32': rng.normal(size=(4, 3)).astype(np.float32),
      'float64': rng.normal(size=(2, 2, 2)),
      'bfloat16': rng.normal(size=(2, 3)).astype(ml_dtypes.bfloat16),
      'scalar': np.array(3.5, np.float32),
      'empty': np.zeros((0, 4), np.float32),
  }


def _as_torch(a):
  if a.dtype.name == 'bfloat16':
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
  return torch.from_numpy(a)


def _bits(t):
  """A tensor's values as numpy, bf16 as its 16-bit words."""
  if t.dtype == torch.bfloat16:
    t = t.view(torch.int16)
  return t.numpy()


@pytest.mark.parametrize('key', list(_np_entries()))
def test_pack_message_writes_the_jax_bytes(key):
  a = _np_entries()[key]
  msg = {'ids': np.arange(3, dtype=np.int64), key: a}
  want = jax_pack(msg)
  got = pack_message({k: _as_torch(v) for k, v in msg.items()})
  assert isinstance(got, bytes) and got == want
  # each package reads the other's bytes back
  back = unpack_message(want)[key]
  jax_back = jax_unpack(got)[key]
  want_shape = a.shape or (1,)
  assert tuple(back.shape) == want_shape == jax_back.shape
  if key == 'bfloat16':
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(back), a.view(np.int16))
    np.testing.assert_array_equal(jax_back.view(np.int16),
                                  a.view(np.int16))
  else:
    np.testing.assert_array_equal(back.numpy(), a.reshape(want_shape))
    assert back.numpy().dtype == a.dtype


def test_unpack_message_views_the_buffer():
  buf = bytearray(pack_message({'x': torch.arange(6, dtype=torch.int32),
                                'y': torch.ones(2, 2)}))
  out = unpack_message(buf)
  lo = np.frombuffer(buf, np.uint8).ctypes.data
  for t in out.values():
    assert lo <= t.data_ptr() < lo + len(buf)
  out['x'][0] = 41          # a writable buffer: the view writes through
  assert unpack_message(buf)['x'][0] == 41


def test_shm_library_is_the_ports_own():
  from glt_tpu_torch.channel import shm
  lib = shm.get_lib()
  assert shm.SOURCE == os.path.join(ROOT, 'glt_tpu_torch', 'csrc',
                                    'shm_queue.cc')
  assert shm.LIBRARY == os.path.join(ROOT, 'glt_tpu_torch', '_build',
                                     'libglt_shm.so')
  assert lib._name == shm.LIBRARY and os.path.exists(shm.LIBRARY)
  with open(shm.LIBRARY + '.srchash') as f:
    assert f.read().strip() == shm._src_hash()
  with open('/proc/self/maps') as f:
    maps = [ln.split(None, 5)[-1].strip() for ln in f
            if 'libglt_shm' in ln]
  # this process (which also loads the JAX package's ring in other
  # tests) maps the port's library from _build/
  assert any(m.startswith(shm.LIBRARY) for m in maps), maps
  # a stale stamp rebuilds from the source (to a temporary name,
  # renamed into place)
  with open(shm.LIBRARY + '.srchash', 'w') as f:
    f.write('stale')
  before = os.stat(shm.LIBRARY).st_ino
  assert shm.build_library() == shm.LIBRARY
  assert os.stat(shm.LIBRARY).st_ino != before
  with open(shm.LIBRARY + '.srchash') as f:
    assert f.read().strip() == shm._src_hash()


def test_shm_queue_fifo_wraparound_timeout_and_emsgsize():
  q = ShmQueue(capacity_bytes=1 << 12)   # tiny: the ring wraps
  try:
    rng = np.random.default_rng(0)
    payloads = [rng.bytes(rng.integers(1, 800)) for _ in range(64)]
    for i in range(0, 64, 4):
      for p in payloads[i:i + 4]:
        q.enqueue(p)
      for p in payloads[i:i + 4]:
        assert bytes(q.dequeue()) == p
    assert q.empty()
    t0 = time.monotonic()
    with pytest.raises(QueueTimeoutError):
      q.dequeue(timeout_ms=50)
    assert time.monotonic() - t0 < 5
    with pytest.raises(OSError) as e:
      q.enqueue(b'x' * 5000)
    assert e.value.errno == 90         # -EMSGSIZE, nothing consumed
    q.enqueue(b'after')
    assert bytes(q.dequeue()) == b'after'
  finally:
    q.close()


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_shm_ring_is_shared_with_the_jax_package(writer):
  """Both libraries implement one ring: a segment one package creates,
  the other attaches by shmid and reads."""
  if writer == 'jax':
    a = JaxShmQueue(capacity_bytes=1 << 16)
    b = ShmQueue(shmid=a.shmid, owner=False)
  else:
    a = ShmQueue(capacity_bytes=1 << 16)
    b = JaxShmQueue(shmid=a.shmid, owner=False)
  try:
    msg = {'rows': _as_torch(np.arange(12, dtype=np.float32).reshape(3, 4))}
    a.enqueue(pack_message(msg))
    got = b.dequeue()
    assert bytes(got) == pack_message(msg)
  finally:
    b.close()
    a.close()


def test_shm_channel_crosses_processes_with_backpressure():
  """200 messages through a 4 KiB ring to a spawned producer: it blocks
  while the ring is full and goes on as this side drains it."""
  import multiprocessing as mp
  chan = ShmChannel(capacity_bytes=1 << 12)
  p = mp.get_context('spawn').Process(
      target=torch_server_worker.producer_main, args=(chan, 200))
  try:
    p.start()
    got = [chan.recv(timeout_ms=60_000) for _ in range(200)]
    p.join(timeout=60)
    assert p.exitcode == 0
    for i, msg in enumerate(got):
      assert int(msg['i'][0]) == i
      assert torch.equal(msg['payload'], torch.full((8,), float(i)))
  finally:
    if p.is_alive():
      p.kill()
      p.join(10)
    chan.close()


def _fetcher(server_id, n, epoch=None, delay=0.0, pulled=None):
  state = {'i': 0, 'epoch': None}

  def fetch():
    if epoch is not None and state['epoch'] != epoch['n']:
      state['epoch'], state['i'] = epoch['n'], 0
    if n is not None and state['i'] >= n:
      raise StopIteration
    time.sleep(delay)
    if pulled is not None:
      pulled[server_id] += 1
    i = state['i']
    state['i'] += 1
    return {'sid': torch.tensor([server_id]), 'i': torch.tensor([i]),
            'epoch': torch.tensor([epoch['n'] if epoch else 0])}
  return fetch


def test_remote_receiving_channel_epochs_and_readahead():
  # every message of both servers, each in order
  ch = RemoteReceivingChannel([_fetcher(0, 5), _fetcher(1, 5)],
                              prefetch_size=2)
  got = []
  while True:
    try:
      got.append(ch.recv(timeout_ms=10_000))
    except StopIteration:
      break
  per = {0: [], 1: []}
  for m in got:
    per[int(m['sid'][0])].append(int(m['i'][0]))
  assert per == {0: list(range(5)), 1: list(range(5))}

  # an abandoned epoch leaks nothing into the next
  epoch = {'n': 0}
  ch = RemoteReceivingChannel([_fetcher(0, 50, epoch), _fetcher(1, 50, epoch)],
                              prefetch_size=2)
  for _ in range(3):
    ch.recv(timeout_ms=10_000)
  ch.stop()
  epoch['n'] = 1
  ch.reset()
  got = []
  while True:
    try:
      got.append(ch.recv(timeout_ms=10_000))
    except StopIteration:
      break
  assert len(got) == 100 and all(int(m['epoch'][0]) == 1 for m in got)
  ch.stop()

  # each server's readahead is bounded on its own
  pulled = {0: 0, 1: 0}
  ch = RemoteReceivingChannel([_fetcher(0, None, pulled=pulled),
                               _fetcher(1, None, delay=0.05,
                                        pulled=pulled)], prefetch_size=3)
  ch.reset()
  time.sleep(0.5)
  assert pulled[0] <= 3 + 1
  ch.stop()

  # nothing arrives: recv times out
  release = threading.Event()

  def stuck():
    release.wait(10)
    raise StopIteration
  ch = RemoteReceivingChannel([stuck])
  with pytest.raises(QueueTimeoutError):
    ch.recv(timeout_ms=100)
  release.set()
  ch.stop()


def test_feature_mp_example_rows_equal_the_features():
  from glt_tpu_torch.data import Feature
  from glt_tpu_torch.examples import feature_mp
  got = feature_mp.run(num_batches=3, batch=32, device='cpu')
  f = Feature(feature_mp.table(), split_ratio=0.5, device='cpu')
  assert f.hot_count == 500 and f.cold_array is not None
  assert len(got) == 3
  for ids, rows in got:
    assert torch.equal(rows, torch.from_numpy(f[ids.numpy()]))
    assert torch.equal(rows, torch.from_numpy(feature_mp.table()[ids]))
