"""DistServer and the server's lifecycle: the sampling service of the
server-client mode (counterpart of glt_tpu/distributed/dist_server.py;
the reference's distributed/dist_server.py: a producer pool keyed by
worker_key with an epoch's bookkeeping each (:50-211), the PyG remote
backend's data-plane rpcs (:87-127), the poll fetch (:193-210), and
init_server / wait_and_shutdown_server (:224-281)).

A server serves the data-plane callees from its dataset, on whatever
device its caller built that dataset (the host, or the card, where
``get_node_feature`` gathers through the ``gather_rows`` kernel); its
sampling workers (``create_sampling_producer``) build their own through
``dataset_builder`` on ``device`` (the card by default) and stream
batches through a shared-memory ring (``ShmChannel``; an ``MpChannel``
when the ring cannot be made, as in the JAX package). Batches leave over
the rpc fabric as packed SampleMessage bytes. ``apply_delta`` stages live
updates of the server's partition into a stream (``glt_tpu_torch.stream``)
on the dataset's device and rebinds the dataset to each new snapshot.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..channel import ShmChannel, pack_message, unpack_message
from ..channel.mp_channel import MpChannel
from ..data.feature import gather_features
from ..obs import get_tracer
from ..sampler.base import SamplingConfig
from .dist_context import init_server_context
from .dist_sampling_producer import (DistMpSamplingProducer, END_KEY,
                                     EPOCH_KEY)
from .rpc import RpcServer

_END = b'#EPOCH_END'
_STALE = b'#STALE'


class DistServer:
  """Reference dist_server.py:50-211. ``device`` is where the sampling
  workers sample (None: the card)."""

  def __init__(self, dataset, dataset_builder=None, device=None):
    self.dataset = dataset
    self.dataset_builder = dataset_builder
    self.device = None if device is None else str(device)
    self._producers: Dict[str, DistMpSamplingProducer] = {}
    self._channels: Dict[str, object] = {}
    self._ends_seen: Dict[str, int] = {}
    self._epochs: Dict[str, int] = {}
    self._stream = None  # the StreamIngestor of apply_delta, made lazily
    self._stream_lock = threading.Lock()
    self._stream_bound_version = 0
    self._exit = threading.Event()

  # -- control plane -----------------------------------------------------

  def ping(self) -> dict:
    """Liveness and readiness (a HealthMonitor target; richer than the
    fabric's built-in ``_ping``)."""
    return {
        'ok': True,
        'exiting': self._exit.is_set(),
        'producers': len(self._producers),
        'partition_idx': getattr(self.dataset, 'partition_idx', 0),
        # which peers are tracing: their spans are harvestable through
        # the fabric's _obs callee
        'obs_tracing': get_tracer().enabled,
    }

  def get_dataset_meta(self):
    ds = self.dataset
    num_nodes = (None if ds.is_hetero else ds.get_graph().num_nodes)
    return {
        'num_partitions': getattr(ds, 'num_partitions', 1),
        'partition_idx': getattr(ds, 'partition_idx', 0),
        'is_hetero': ds.is_hetero,
        'num_nodes': num_nodes,
        'edge_dir': ds.edge_dir,
    }

  def create_sampling_producer(self, worker_key: str, seeds_bytes: bytes,
                               config_kwargs: dict,
                               num_workers: int = 1,
                               buffer_capacity: int = 256 << 20) -> bool:
    """Spawns ``num_workers`` sampling workers for ``worker_key`` over the
    seeds of ``seeds_bytes`` (a packed ``{'seeds'}``, or ``{'split'}``, a
    split name this server resolves against its own dataset, the
    reference's RemoteNodeSplitSamplerInput)."""
    if worker_key in self._producers:
      return True
    assert self.dataset_builder is not None, (
        'server needs a picklable dataset_builder to spawn sampling '
        'workers')
    msg = unpack_message(seeds_bytes)
    if 'split' in msg:
      from ..typing import Split
      split = Split(bytes(msg['split'].numpy().tobytes()).decode()
                    .rstrip('\0'))
      seeds = np.asarray(self.dataset.get_split(split))
    else:
      seeds = msg['seeds'].numpy()
    config = SamplingConfig(**config_kwargs)
    try:
      channel = ShmChannel(capacity_bytes=buffer_capacity)
      # the ring goes with the last of this server and its workers, even
      # a killed one; the workers still attach to it by shmid
      channel.unlink()
    except Exception:
      channel = MpChannel(capacity=256)
    producer = DistMpSamplingProducer(
        self.dataset_builder, config, seeds, channel,
        num_workers=num_workers, device=self.device)
    producer.init()
    self._producers[worker_key] = producer
    self._channels[worker_key] = channel
    self._ends_seen[worker_key] = 0
    return True

  def start_new_epoch_sampling(self, worker_key: str, epoch: int) -> bool:
    self._ends_seen[worker_key] = 0
    self._epochs[worker_key] = int(epoch)
    self._producers[worker_key].produce_all(epoch)
    return True

  def fetch_one_sampled_message(self, worker_key: str, epoch=None,
                                timeout_ms: int = 60_000) -> bytes:
    """Packed SampleMessage bytes, or the epoch-end marker once every
    worker has finished (reference :193-210).

    Every producer message carries its epoch. Leftovers of an abandoned
    epoch are dropped here, and a fetch from a stale puller (``epoch``
    behind the server's) gets ``#STALE``; a current message it raced
    onto goes back to the channel first, so no live batch is lost to a
    stale puller."""
    producer = self._producers[worker_key]
    channel = self._channels[worker_key]
    deadline = time.time() + timeout_ms / 1000
    while True:
      cur = self._epochs.get(worker_key, 0)
      if epoch is not None and int(epoch) != cur:
        return _STALE
      remaining = max(int((deadline - time.time()) * 1000), 1)
      msg = channel.recv(timeout_ms=remaining)
      cur = self._epochs.get(worker_key, 0)
      msg_epoch = int(msg[EPOCH_KEY][0]) if EPOCH_KEY in msg else cur
      if msg_epoch != cur:
        continue  # a leftover of an abandoned epoch
      if epoch is not None and int(epoch) != cur:
        channel.send(msg)  # not ours: back to the live epoch
        return _STALE
      if END_KEY in msg:
        self._ends_seen[worker_key] += 1
        if self._ends_seen[worker_key] >= producer.num_expected_ends:
          return _END
        continue
      return pack_message(msg)

  # -- data plane (PyG remote backend, reference :87-127) ----------------

  def get_node_feature(self, ids_bytes: bytes) -> bytes:
    ids = unpack_message(ids_bytes)['ids']
    feat = self.dataset.get_node_feature()
    rows = gather_features(feat, ids.to(feat.device).long())
    return pack_message({'feats': rows.cpu()})

  def get_node_label(self, ids_bytes: bytes) -> bytes:
    ids = unpack_message(ids_bytes)['ids'].numpy()
    return pack_message(
        {'labels': np.asarray(self.dataset.get_node_label())[ids]})

  def get_tensor_size(self) -> tuple:
    return tuple(self.dataset.get_node_feature().shape)

  def get_edge_index(self) -> bytes:
    g = self.dataset.get_graph()
    ptr, other, _ = g.topo.to_coo()
    ei = torch.stack([ptr, other] if g.layout == 'CSR' else [other, ptr])
    return pack_message({'edge_index': ei.cpu()})

  def get_edge_size(self) -> int:
    return self.dataset.get_graph().num_edges

  def get_node_partition_id(self, ids_bytes: bytes) -> bytes:
    ids = unpack_message(ids_bytes)['ids'].numpy()
    pb = (self.dataset.get_node_pb() if hasattr(self.dataset, 'get_node_pb')
          else None)
    if pb is None:
      part = np.zeros(ids.shape[0], np.int32)
    else:
      part = np.asarray(pb[ids])
    return pack_message({'partition': part})

  # -- live updates (the stream) -------------------------------------------

  def _stream_ingestor(self, delta_capacity: int = 4096):
    """The server's StreamIngestor, built once on the first call: a
    SnapshotManager over the dataset's graph and node features on the
    graph's device (the device the caller built the dataset on). Locked:
    the rpc server serves each connection on its own thread, and two
    racing first calls would each build a chain off the startup graph,
    one client's updates silently lost."""
    with self._stream_lock:
      if self._stream is None:
        if self.dataset.is_hetero:
          raise ValueError('apply_delta is homogeneous only (a hetero '
                           'stream needs a delta buffer an edge type)')
        from ..stream import SnapshotManager, StreamIngestor
        g = self.dataset.get_graph()
        manager = SnapshotManager(
            g.topo, self.dataset.get_node_feature(),
            delta_capacity=delta_capacity, device=g.topo.indices.device)
        self._stream = StreamIngestor(manager)
      return self._stream

  def apply_delta(self, delta_bytes: bytes) -> dict:
    """Applies live updates to this server's partition (the fan-out arm
    of the stream: a coordinator shards updates by partition book and
    posts each server its slice).

    Payload (a packed TensorMap): optional ``ins`` / ``dels`` ``[2, n]``
    edge blocks in the partition's local ids, optional ``feat_ids`` and
    ``feat_rows`` feature updates, optional ``compact`` (any 1-element
    array: compact now rather than when the policy says).

    Whenever the snapshot version moves (this call's ``compact``, or a
    compaction the policy fired while staging, this call's or another
    client's), ``dataset.graph`` and ``dataset.node_features`` rebind to
    the new snapshot, so the data-plane callees (``get_node_feature``,
    ``get_edge_index``, ``get_edge_size``) and any producer created after
    it serve the fresh graph. Sampling workers already running keep the
    graph their ``dataset_builder`` built, as in the JAX package.

    Returns JAX's reply: ``{'applied': {'inserts', 'deletes',
    'feature_rows'}, 'version', 'pending', 'compacted'}``."""
    msg = unpack_message(delta_bytes)
    stream = self._stream_ingestor()
    v0 = stream.manager.current().version
    applied = {'inserts': 0, 'deletes': 0, 'feature_rows': 0}
    if 'ins' in msg:
      ins = msg['ins'].numpy()
      applied['inserts'] = stream.insert_edges(ins[0], ins[1])
    if 'dels' in msg:
      dels = msg['dels'].numpy()
      applied['deletes'] = stream.delete_edges(dels[0], dels[1])
    if 'feat_ids' in msg:
      applied['feature_rows'] = stream.update_features(
          msg['feat_ids'].numpy(), msg['feat_rows'].numpy())
    if 'compact' in msg:
      stream.flush()
    else:
      stream.maybe_compact()
    # rebind on the version, not on this call's flush: staging may have
    # compacted through the policy, and another client's call may have too
    version = stream.manager.current().version
    with self._stream_lock:
      if version != self._stream_bound_version:
        from ..data import Graph
        snap = stream.manager.current()
        old = self.dataset.get_graph()
        self.dataset.graph = Graph(snap.topo, device=old.device)
        if snap.feature is not None:
          self.dataset.node_features = snap.feature
        self._stream_bound_version = snap.version
        version = snap.version
    return {
        'applied': applied,
        'version': version,
        'pending': stream.edges.size + (stream.features.size
                                        if stream.features else 0),
        'compacted': version > v0,
    }

  # -- lifecycle ---------------------------------------------------------

  def exit(self) -> bool:
    """Stops every producer's workers, then marks the server for exit
    (the rings go with the process, :meth:`ShmChannel.unlink`)."""
    for producer in self._producers.values():
      producer.shutdown()
    self._producers.clear()
    self._exit.set()
    return True

  @property
  def should_exit(self) -> bool:
    return self._exit.is_set()


_server: Optional[DistServer] = None
_rpc_server: Optional[RpcServer] = None

CALLEES = ('get_dataset_meta', 'create_sampling_producer',
           'start_new_epoch_sampling', 'fetch_one_sampled_message',
           'get_node_feature', 'get_node_label', 'get_tensor_size',
           'get_edge_index', 'get_edge_size', 'get_node_partition_id',
           'apply_delta', 'exit', 'ping')


def server_port(master_port: int, server_rank: int) -> int:
  return master_port + server_rank


def free_port_base(span: int, host: str = '127.0.0.1',
                   tries: int = 50) -> int:
  """A port ``base`` such that ``base .. base + span - 1`` were free when
  probed (the OS picks ``base``): a ``master_port`` for ``span`` servers
  on one host. Another process may still take one before the servers
  bind."""
  import socket
  for _ in range(tries):
    with socket.socket() as s:
      s.bind((host, 0))
      base = s.getsockname()[1]
    ok = True
    for k in range(1, span):
      with socket.socket() as t:
        try:
          t.bind((host, base + k))
        except OSError:
          ok = False
      if not ok:
        break
    if ok:
      return base
  raise RuntimeError(f'no {span} consecutive free ports found')


def init_server(num_servers: int, num_clients: int, server_rank: int,
                dataset, master_addr: str = '127.0.0.1',
                master_port: int = 29500, dataset_builder=None,
                device=None) -> DistServer:
  """Reference dist_server.py:224-260: binds the rpc endpoint (port =
  master_port + rank) and serves the DistServer's callees; its sampling
  workers sample on ``device`` (None: the card)."""
  global _server, _rpc_server
  init_server_context(num_servers, num_clients, server_rank)
  _server = DistServer(dataset, dataset_builder, device=device)
  _rpc_server = RpcServer(master_addr,
                          server_port(master_port, server_rank),
                          auto_start=False)
  for name in CALLEES:
    _rpc_server.register(name, getattr(_server, name))
  _rpc_server.start()  # accept only once every callee exists
  return _server


def wait_and_shutdown_server(poll_s: float = 0.2) -> None:
  """Reference :263-281: waits for a client's ``exit``, then stops."""
  assert _server is not None
  while not _server.should_exit:
    time.sleep(poll_s)
  shutdown_server()


def shutdown_server() -> None:
  global _server, _rpc_server
  if _rpc_server is not None:
    _rpc_server.stop()
  _server = None
  _rpc_server = None


def get_server() -> Optional[DistServer]:
  """The process's DistServer (reference dist_server.py:216-221), None
  before init_server."""
  return _server
