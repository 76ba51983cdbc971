"""Online partitioning over the rpc fabric: DistRandomPartitioner and
DistTableRandomPartitioner (counterpart of
glt_tpu/distributed/dist_random_partitioner.py).

Each rank holds a slice of the edges and of the feature rows. It runs an
:class:`~glt_tpu_torch.distributed.rpc.RpcServer` on ``master_port +
rank`` with ``push_edges`` and ``push_node_feat``, pushes each edge to its
source's owner and each feature row to its id's owner in chunks, the
payloads packed by ``pack_message`` (the JAX package's bytes, so ranks of
either package partition together), with a barrier on rank 0's server
after each phase. Then each rank saves ``part{rank}`` of the layout
``glt_tpu_torch.partition`` reads, and rank 0 the books and
``META.json``. Owners come from a multiplicative hash of the id
(:meth:`DistRandomPartitioner._owner_of`), the same in both packages.

A partition's rows are in the order their chunks arrived, as in the JAX
package: the same slices give the same files up to that order (one rank:
the same order). Everything here is numpy on the host.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from ..channel import pack_message, unpack_message
from ..utils import as_numpy
from .rpc import RpcClient, RpcServer

CHUNK = 2 * 1024 * 1024


class _PartitionBuffer:
  """The rows pushed to the partition this rank owns."""

  def __init__(self):
    self.lock = threading.Lock()
    self.edge_chunks: List[np.ndarray] = []     # [3, m]: rows, cols, eids
    self.node_feat_chunks: List[np.ndarray] = []
    self.node_id_chunks: List[np.ndarray] = []

  def push_edges(self, payload: bytes) -> bool:
    msg = unpack_message(payload)
    chunk = np.stack([msg['rows'].numpy(), msg['cols'].numpy(),
                      msg['eids'].numpy()])
    with self.lock:
      self.edge_chunks.append(chunk)
    return True

  def push_node_feat(self, payload: bytes) -> bool:
    msg = unpack_message(payload)
    # copies: the views would keep the whole payload alive
    ids, feats = msg['ids'].numpy().copy(), msg['feats'].numpy().copy()
    with self.lock:
      self.node_id_chunks.append(ids)
      self.node_feat_chunks.append(feats)
    return True


class DistRandomPartitioner:
  """One rank of an online partitioning.

  Args:
    output_dir: the layout's root, on a filesystem every rank shares
      (rank r writes ``part{r}``).
    rank, world_size: this rank (its partition index) and the ranks.
    num_nodes: the global node count.
    edge_slice: this rank's ``[2, E_r]`` COO (src, dst); each edge goes to
      its source's owner (``edge_assign='by_src'``).
    eid_slice: the slice's global edge ids, ``[E_r]``.
    node_ids, node_feat: this rank's feature rows and their global ids
      (or None: a rank may hold none).
    master_addr, master_port: rank r serves on ``master_port + r``; the
      phase barriers run on rank 0's server.
    chunk_size: rows a push.
    seed: salt of the owner hash.
    bind_addr, peer_addrs: the address this rank's server binds (default
      ``master_addr``) and each rank's host (default all
      ``master_addr``).
  """

  def __init__(self, output_dir: str, rank: int, world_size: int,
               num_nodes: int, edge_slice, eid_slice, node_ids=None,
               node_feat=None, master_addr: str = '127.0.0.1',
               master_port: int = 30500, chunk_size: int = CHUNK,
               seed: int = 0, bind_addr: Optional[str] = None,
               peer_addrs: Optional[List[str]] = None):
    self.output_dir = output_dir
    self.rank = int(rank)
    self.world = int(world_size)
    self.num_nodes = int(num_nodes)
    self.edge_slice = as_numpy(edge_slice)
    self.eid_slice = as_numpy(eid_slice)
    self.node_ids = as_numpy(node_ids)
    self.node_feat = as_numpy(node_feat)
    self.chunk_size = int(chunk_size)
    self.seed = seed
    self.buffer = _PartitionBuffer()
    self.server = RpcServer(bind_addr or master_addr, master_port + rank,
                            auto_start=False)
    self.server.register('push_edges', self.buffer.push_edges)
    self.server.register('push_node_feat', self.buffer.push_node_feat)
    self.server.start()    # accept only once every callee exists
    self.peer_addrs = peer_addrs or [master_addr] * world_size
    if len(self.peer_addrs) != world_size:
      raise ValueError(f'{len(self.peer_addrs)} peer addresses for '
                       f'{world_size} ranks')
    self.base_port = master_port
    self._clients: Dict[int, RpcClient] = {}

  def _client(self, peer: int) -> RpcClient:
    if peer not in self._clients:
      self._clients[peer] = RpcClient(self.peer_addrs[peer],
                                      self.base_port + peer)
    return self._clients[peer]

  def _owner_of(self, ids: np.ndarray) -> np.ndarray:
    """The owner of each id: ``((id * 0x9E3779B97F4A7C15 + seed) >> 32) %
    world`` in wrapping uint64 (kept in numpy: an int64 product and an
    arithmetic shift would give other owners once the top bit is set)."""
    mix = (ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
           + np.uint64(self.seed))
    return ((mix >> np.uint64(32)) % np.uint64(self.world)).astype(np.int32)

  def _push(self, peer: int, method: str, payload: dict) -> None:
    if peer == self.rank:
      getattr(self.buffer, method)(pack_message(payload))
    else:
      self._client(peer).request(method, pack_message(payload))

  def _barrier(self, key: str) -> None:
    self._client(0).request('_barrier', key, self.world)

  def partition(self) -> np.ndarray:
    """Every phase; returns the node partition book."""
    node_pb = self._owner_of(np.arange(self.num_nodes, dtype=np.int64))

    # phase 1: edges by their source's owner
    rows, cols = self.edge_slice
    for lo in range(0, rows.shape[0], self.chunk_size):
      hi = min(lo + self.chunk_size, rows.shape[0])
      owner = node_pb[rows[lo:hi]]
      for p in range(self.world):
        sel = np.nonzero(owner == p)[0] + lo
        if sel.size:
          self._push(p, 'push_edges', {'rows': rows[sel], 'cols': cols[sel],
                                       'eids': self.eid_slice[sel]})
    self._barrier('edges_done')

    # phase 2: feature rows by their id's owner; every rank joins the
    # barrier, a rank without rows too
    if self.node_ids is not None:
      for lo in range(0, self.node_ids.shape[0], self.chunk_size):
        hi = min(lo + self.chunk_size, self.node_ids.shape[0])
        ids = self.node_ids[lo:hi]
        owner = node_pb[ids]
        for p in range(self.world):
          sel = np.nonzero(owner == p)[0]
          if sel.size:
            self._push(p, 'push_node_feat',
                       {'ids': ids[sel], 'feats': self.node_feat[lo:hi][sel]})
    self._barrier('feats_done')

    # phase 3: each rank saves its partition, then rank 0 the books
    self._save()
    self._barrier('save_done')
    if self.rank == 0:
      self._save_meta(node_pb)
    self._barrier('meta_done')
    return node_pb

  def _save(self) -> None:
    pdir = os.path.join(self.output_dir, f'part{self.rank}')
    os.makedirs(os.path.join(pdir, 'graph'), exist_ok=True)
    all_e = (np.concatenate(self.buffer.edge_chunks, axis=1)
             if self.buffer.edge_chunks else np.zeros((3, 0), np.int64))
    np.savez(os.path.join(pdir, 'graph', 'data.npz'), rows=all_e[0],
             cols=all_e[1], eids=all_e[2])
    if self.buffer.node_feat_chunks:
      ids = np.concatenate(self.buffer.node_id_chunks)
      feats = np.concatenate(self.buffer.node_feat_chunks)
      order = np.argsort(ids)
      os.makedirs(os.path.join(pdir, 'node_feat'), exist_ok=True)
      np.savez(os.path.join(pdir, 'node_feat', 'data.npz'), ids=ids[order],
               feats=feats[order])

  def _save_meta(self, node_pb: np.ndarray) -> None:
    np.save(os.path.join(self.output_dir, 'node_pb.npy'),
            node_pb.astype(np.int32))
    # the edge book from every saved partition (all on the shared
    # filesystem after 'save_done'), sized by the largest edge id + 1
    chunks = []
    for r in range(self.world):
      with np.load(os.path.join(self.output_dir, f'part{r}', 'graph',
                                'data.npz')) as z:
        chunks.append((z['eids'], r))
    total = max((int(e.max()) + 1 for e, _ in chunks if e.size), default=0)
    edge_pb = np.zeros(total, np.int32)
    for eids, r in chunks:
      edge_pb[eids] = r
    np.save(os.path.join(self.output_dir, 'edge_pb.npy'), edge_pb)
    with open(os.path.join(self.output_dir, 'META.json'), 'w') as f:
      json.dump({'num_parts': self.world, 'data_cls': 'homo',
                 'edge_dir': 'out', 'edge_assign': 'by_src'}, f)

  def shutdown(self) -> None:
    for c in self._clients.values():
      c.close()
    self.server.stop()


class DistTableRandomPartitioner(DistRandomPartitioner):
  """A rank fed by table readers (``glt_tpu_torch.data.table_dataset``'s
  protocol): its edge records ``(src, dst, ...)`` and node records
  ``(ids, rows, ...)``, with explicit global node ids, drained into the
  slice form; the edges' global ids are ``edge_id_offset + local
  position`` (ranks pass disjoint offsets, e.g. the exclusive prefix sums
  of their row counts). Weights and labels are not partitioned."""

  def __init__(self, output_dir: str, rank: int, world_size: int,
               num_nodes: int, edge_reader=None, node_reader=None,
               edge_id_offset: int = 0, **kwargs):
    srcs, dsts = [], []
    for rec in (edge_reader or ()):
      srcs.append(as_numpy(rec[0]).astype(np.int64))
      dsts.append(as_numpy(rec[1]).astype(np.int64))
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    eids = edge_id_offset + np.arange(src.shape[0], dtype=np.int64)
    ids_l, feats_l = [], []
    for rec in (node_reader or ()):
      ids_l.append(as_numpy(rec[0]).astype(np.int64))
      feats_l.append(as_numpy(rec[1]))
    super().__init__(
        output_dir, rank=rank, world_size=world_size, num_nodes=num_nodes,
        edge_slice=np.stack([src, dst]), eid_slice=eids,
        node_ids=np.concatenate(ids_l) if ids_l else None,
        node_feat=np.concatenate(feats_l) if feats_l else None, **kwargs)
