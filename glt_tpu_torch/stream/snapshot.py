"""Versioned immutable snapshots with RCU-style swap and delta compaction
(counterpart of glt_tpu/stream/snapshot.py).

A :class:`Snapshot` is one immutable ``(Topology, Feature)`` version plus
its device CSR (or CSC: the base's layout, kept through every compaction)
with ``indices`` padded to a fixed edge capacity (-1 past the live
edges). The padding keeps the JAX package's geometry: the slots
of a uniform hop clip to the capacity, and a compaction that stays inside
it keeps every shape. The snapshot's Topology reads its live edges as a
view of the padded array, so each version holds its neighbour array on
the card once.

Swap protocol (read-copy-update): readers ``acquire()`` the current
snapshot, sample against its arrays, then ``release()``. ``compact()``
publishes the merged snapshot and retires the old one; its arrays are
dropped when the last in-flight reader releases, so in-flight sampling
finishes on the snapshot it started with. Kernels still queued on the
stream when the arrays are dropped are safe: PyTorch's allocator reuses
a block only for work ordered after them on the same stream.

Compaction runs on the topology's device: the merged COO goes through
:class:`~glt_tpu_torch.data.Topology`'s constructor, the same (row, col)
stable sort as a cold-start build, so it gives the JAX package's
``indptr``, ``indices`` and ``edge_ids`` exactly.
"""
from __future__ import annotations

import copy
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.feature import Feature
from ..data.topology import Topology, _compress
from ..utils import as_numpy, resolve_device
from .delta import EdgeDeltaBuffer, EdgeDeltaCut, FeatureDeltaCut


def _padded_csr(indptr: torch.Tensor, indices: torch.Tensor, capacity: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
  """int32 (indptr, indices) on ``device``, indices padded to
  ``capacity`` slots with -1 (valid lanes never read the pad)."""
  if indices.numel() > capacity:
    raise ValueError(f'{indices.numel()} edges exceed capacity {capacity}')
  if int(indptr[-1]) >= 2 ** 31 - 1:
    raise ValueError('the hop kernels address edges with int32')
  padded = torch.full((capacity,), -1, dtype=torch.int32, device=device)
  padded[:indices.numel()] = indices.to(device)
  return indptr.to(device, torch.int32), padded


def _delta_csr(src: np.ndarray, dst: np.ndarray, num_rows: int,
               num_cols: int, capacity: int, layout: str,
               device: torch.device) -> tuple:
  """One capacity-padded overlay over the base's pointer axis from (src,
  dst) pairs: rows are the sources of a CSR base and the destinations of
  a CSC one, sorted by (row, col) like the base."""
  row, col = (src, dst) if layout == 'CSR' else (dst, src)
  row = torch.as_tensor(row, dtype=torch.int64, device=device)
  col = torch.as_tensor(col, dtype=torch.int64, device=device)
  indptr, indices, _ = _compress(row, col, num_rows, num_cols)
  return _padded_csr(indptr, indices, capacity, device)


def _pair_key(src: torch.Tensor, dst: torch.Tensor,
              space: int) -> torch.Tensor:
  """Dense (src, dst) -> int64 key for set matching (glt_tpu/stream/
  delta.py ``_pair_key``)."""
  return src.long() * max(space, 1) + dst.long()


class Snapshot:
  """One immutable graph/feature version.

  Attributes:
    version: monotonically increasing snapshot id.
    topo: the version's Topology (on the manager's device, in the base's
      layout), a shallow copy of the one given whose ``indices`` are
      ``arrays['indices'][:E]``.
    feature: its node Feature (None when the stream is topology-only);
      shared with the previous snapshot when a compaction carried no
      feature updates.
    arrays: ``{'indptr': [N + 1] int32, 'indices': [edge_capacity] int32}``
      on the device, what the sampler reads.
  """

  def __init__(self, version: int, topo: Topology, feature: Optional[Feature],
               edge_capacity: int, device: torch.device):
    self.version = int(version)
    indptr, indices = _padded_csr(topo.indptr, topo.indices, edge_capacity,
                                  device)
    self.topo = copy.copy(topo)
    self.topo.indices = indices[:topo.num_edges]
    self.feature = feature
    self.arrays: Dict[str, torch.Tensor] = {'indptr': indptr,
                                            'indices': indices}
    self._refs = 0
    self._retired = False
    self._freed = False
    self._flipped: Optional[Topology] = None
    #: read by samplers per call to detect full-window truncation
    self.max_degree = topo.max_degree

  @property
  def num_rows(self) -> int:
    return self.topo.num_rows

  @property
  def num_edges(self) -> int:
    return self.topo.num_edges

  @property
  def freed(self) -> bool:
    return self._freed

  def _free(self) -> None:
    """Drop the device arrays and the flipped view (manager-internal: once
    retired and released by its last reader; the manager drops the
    snapshot with them, and with it the padded array its Topology views).
    The Feature stays: the successor may share it."""
    self._freed = True
    self.arrays = {}
    self._flipped = None

  def flipped_topo(self) -> Topology:
    """The opposite-layout view (``Topology.flip_layout``: the CSC of a
    CSR base, the CSR of a CSC one), built once per snapshot on its
    device, for reverse-adjacency cache invalidation."""
    if self._flipped is None:
      self._flipped = self.topo.flip_layout()
    return self._flipped

  def expand_affected(self, ids) -> np.ndarray:
    """ids ∪ their reverse-layout neighbours (the in-neighbours of a CSR
    base, the out-neighbours of a CSC one): every node whose sampled
    neighbourhood can contain an id, i.e. whose cached embedding
    aggregates over it."""
    ids = as_numpy(ids).astype(np.int64).reshape(-1)
    flip = self.flipped_topo()
    valid = torch.as_tensor(ids[(ids >= 0) & (ids < flip.num_rows)],
                            device=flip.indptr.device)
    starts, ends = flip.indptr[valid], flip.indptr[valid + 1]
    lens = ends - starts
    slots = (torch.repeat_interleave(starts, lens)
             + torch.arange(int(lens.sum()), device=lens.device)
             - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens))
    nbrs = as_numpy(flip.indices[slots]).astype(np.int64)
    return np.unique(np.concatenate([ids, nbrs]))


class SnapshotManager:
  """Owns the snapshot chain, the delta overlays and compaction.

  Args:
    topo: the startup Topology (version 0 base), CSR or CSC; every
      compaction keeps its layout.
    feature: the startup node Feature (optional).
    delta_capacity: overlay width = max pending delta ops; the
      EdgeDeltaBuffer feeding this manager must not exceed it.
    edge_capacity: padded edge-array size; defaults to ``num_edges + 4 *
      delta_capacity`` (room for several compactions of pure inserts
      before a capacity growth).
    device: where the snapshots live (default: the card; raises when there
      is none); the topology must already live there.
  """

  def __init__(self, topo: Topology, feature: Optional[Feature] = None, *,
               delta_capacity: int = 4096,
               edge_capacity: Optional[int] = None, device=None):
    self.device = resolve_device(device)
    self.delta_capacity = int(delta_capacity)
    self.edge_capacity = int(
        edge_capacity if edge_capacity is not None
        else topo.num_edges + 4 * self.delta_capacity)
    self._lock = threading.Lock()
    self._compact_serial = threading.Lock()
    if topo.indices.device != self.device:
      raise ValueError(f'topology lives on {topo.indices.device}, the '
                       f'manager on {self.device}')
    self._current = Snapshot(0, topo, feature, self.edge_capacity,
                             self.device)
    self._retired: List[Snapshot] = []
    eids = topo.edge_ids
    self._next_edge_id = int(eids.max()) + 1 if eids.numel() else 0
    self._empty_overlay: Optional[dict] = None
    self._overlay_cache = None  # ((buffer id, seq, version), overlay)
    self.compactions = 0
    self.capacity_growths = 0
    self.last_compaction_s = 0.0

  # -- geometry ----------------------------------------------------------

  @property
  def num_nodes(self) -> int:
    t = self.current().topo
    return max(t.num_rows, t.num_cols)

  @property
  def num_src_nodes(self) -> int:
    """Bound of edge-delta src endpoints: the row axis of a CSR base, the
    column axis of a CSC one."""
    t = self.current().topo
    return t.num_rows if t.layout == 'CSR' else t.num_cols

  @property
  def num_dst_nodes(self) -> int:
    t = self.current().topo
    return t.num_cols if t.layout == 'CSR' else t.num_rows

  @property
  def layout(self) -> str:
    return self.current().topo.layout

  # -- RCU read path -----------------------------------------------------

  def current(self) -> Snapshot:
    # RCU: a swap is one reference assignment under the lock, a reader one
    # GIL-atomic reference load; readers that pin use acquire(), which
    # locks
    return self._current  # gltlint: disable=GLT002

  def acquire(self) -> Snapshot:
    with self._lock:
      snap = self._current
      snap._refs += 1
      return snap

  def release(self, snap: Snapshot) -> None:
    with self._lock:
      if snap._refs <= 0:
        raise RuntimeError('unbalanced snapshot release')
      snap._refs -= 1
      self._reap_locked()

  def _reap_locked(self) -> None:
    alive = []
    for s in self._retired:
      if s._refs == 0:
        s._free()
      else:
        alive.append(s)
    self._retired = alive

  @property
  def num_retired(self) -> int:
    with self._lock:
      return len(self._retired)

  # -- delta overlays ----------------------------------------------------

  def _overlay(self, cut: EdgeDeltaCut, topo: Topology) -> dict:
    ip, ix = _delta_csr(cut.ins_src, cut.ins_dst, topo.num_rows,
                        topo.num_cols, self.delta_capacity, topo.layout,
                        self.device)
    dp, dx = _delta_csr(cut.del_src, cut.del_dst, topo.num_rows,
                        topo.num_cols, self.delta_capacity, topo.layout,
                        self.device)
    return {'ins_indptr': ip, 'ins_indices': ix,
            'del_indptr': dp, 'del_indices': dx}

  def empty_overlay(self) -> dict:
    """All-empty insert/tombstone overlays (cached; the steady-state
    argument between delta refreshes)."""
    if self._empty_overlay is None:
      zero = np.zeros(0, np.int64)
      # an RCU reference load (as in current()): the empty overlay depends
      # only on the row and column counts, which swaps keep
      cur = self._current  # gltlint: disable=GLT002
      self._empty_overlay = self._overlay(EdgeDeltaCut(zero, zero, zero, zero),
                                          cur.topo)
    return self._empty_overlay

  def build_overlay(self, buffer: EdgeDeltaBuffer) -> dict:
    """Device overlays for the buffer's current pending set (a
    non-draining view), ``[N + 1]`` indptr and ``[delta_capacity]``
    indices each. Memoized on the buffer's ``mutation_seq`` and the
    snapshot version, so an unchanged pending set costs a dict lookup."""
    if buffer.capacity > self.delta_capacity:
      raise ValueError(f'buffer capacity {buffer.capacity} exceeds the '
                       f'overlay capacity {self.delta_capacity}')
    # one reference load: the key's version and the geometry come from the
    # same snapshot even if compact() swaps mid-call (GLT002)
    cur = self._current  # gltlint: disable=GLT002
    key = (id(buffer), buffer.mutation_seq, cur.version)
    if self._overlay_cache is not None and self._overlay_cache[0] == key:
      return self._overlay_cache[1]
    cut = buffer.view()
    overlay = (self.empty_overlay() if cut.num_ops == 0
               else self._overlay(cut, cur.topo))
    self._overlay_cache = (key, overlay)
    return overlay

  # -- compaction --------------------------------------------------------

  def compact(self, edge_cut: Optional[EdgeDeltaCut] = None,
              feat_cut: Optional[FeatureDeltaCut] = None
              ) -> Tuple[Snapshot, dict]:
    """Merge a drained delta into a fresh snapshot and swap it in.

    Returns (new_snapshot, info). ``info['touched']`` is the node-id set
    whose cached embeddings the merge staled: the row-axis endpoints of
    inserted and deleted edges (sources on a CSR base, destinations on a
    CSC one: their sampled neighbourhood changed) plus feature-updated
    ids. ``info['capacity_grown']`` flags an edge-capacity growth. The new
    snapshot keeps the base's layout and edge weights (inserts weigh 1.0,
    as in the JAX package). Concurrent compactions are serialized (readers
    are never blocked).
    """
    with self._compact_serial:
      return self._compact_locked(edge_cut, feat_cut)

  def _compact_locked(self, edge_cut, feat_cut):
    t0 = time.perf_counter()
    old = self._current
    topo = old.topo
    layout = topo.layout
    dev = topo.indices.device
    # the base edge list in (src, dst) orientation, ids and weights aligned
    ptr_axis, other, eids = topo.to_coo()
    src, dst = (ptr_axis, other) if layout == 'CSR' else (other, ptr_axis)
    weights = topo.edge_weights
    touched: List[np.ndarray] = []
    if edge_cut is not None and edge_cut.del_src.size:
      space = max(topo.num_rows, topo.num_cols,
                  int(edge_cut.del_src.max(initial=0)) + 1,
                  int(edge_cut.del_dst.max(initial=0)) + 1)
      dels = _pair_key(torch.as_tensor(edge_cut.del_src, device=dev),
                       torch.as_tensor(edge_cut.del_dst, device=dev), space)
      keep = ~torch.isin(_pair_key(src, dst, space), dels)
      src, dst, eids = src[keep], dst[keep], eids[keep]
      if weights is not None:
        weights = weights[keep]
      touched.append(edge_cut.del_src if layout == 'CSR'
                     else edge_cut.del_dst)
    if edge_cut is not None and edge_cut.ins_src.size:
      n_ins = edge_cut.ins_src.shape[0]
      new_ids = torch.arange(self._next_edge_id, self._next_edge_id + n_ins,
                             device=dev)
      self._next_edge_id += n_ins
      src = torch.cat([src, torch.as_tensor(edge_cut.ins_src, device=dev)])
      dst = torch.cat([dst, torch.as_tensor(edge_cut.ins_dst, device=dev)])
      eids = torch.cat([eids, new_ids])
      if weights is not None:
        weights = torch.cat([weights, torch.ones(n_ins, dtype=weights.dtype,
                                                 device=dev)])
      touched.append(edge_cut.ins_src if layout == 'CSR'
                     else edge_cut.ins_dst)
    new_topo = Topology(torch.stack([src, dst]), edge_ids=eids,
                        edge_weights=weights, layout=layout,
                        num_rows=topo.num_rows, num_cols=topo.num_cols)

    feature = old.feature
    if feat_cut is not None and feat_cut.ids.size:
      if feature is None:
        raise ValueError('feature updates staged but the stream carries no '
                         'Feature')
      feature = feature.with_updated_rows(feat_cut.ids, feat_cut.values)
      touched.append(feat_cut.ids)

    capacity = self.edge_capacity
    grown = False
    if new_topo.num_edges > capacity:
      # round up in delta-sized steps: repeated pure-insert epochs pay one
      # growth per several compactions
      step = max(self.delta_capacity, 1)
      grow = new_topo.num_edges + 4 * self.delta_capacity - capacity
      capacity += -(-grow // step) * step
      grown = True
      self.capacity_growths += 1

    snap = Snapshot(old.version + 1, new_topo, feature, capacity,
                    self.device)
    with self._lock:
      self.edge_capacity = capacity
      self._current = snap
      old._retired = True
      self._retired.append(old)
      self._reap_locked()
    self.compactions += 1
    self.last_compaction_s = time.perf_counter() - t0
    info = {
        'version': snap.version,
        'num_edges': snap.num_edges,
        'touched': (np.unique(np.concatenate(touched)) if touched
                    else np.zeros(0, np.int64)),
        'capacity_grown': grown,
        'edge_capacity': capacity,
        'compaction_s': self.last_compaction_s,
    }
    return snap, info
