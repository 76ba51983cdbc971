"""DistFeature: a partitioned feature store with an exchange lookup
(counterpart of glt_tpu/distributed/dist_feature.py).

Unlike :class:`~glt_tpu_torch.parallel.ShardedFeature` (the range rule)
this store follows an arbitrary feature partition book: rank p keeps
partition p's rows and a dense ``id2index`` [N] from global id to its row
there (-1 for an id it does not hold). A lookup routes each id by the
*requesting* rank's book (a book rewritten for cached rows differs from
rank to rank), exchanges the requests, the owner reads its rows with the
``gather_rows`` kernel (K3; the counterpart of the ``resolve_row_gather``
seam, dist_feature.py:255) and the rows go back: the exchange of
``parallel/dist_feature.py`` (:func:`exchange_lookup`, its capped drain
included). Lanes that ask nothing, and ids the owner does not hold, read
zeros.

The ids are node ids, or, for an edge-feature store (``kind='edge'`` of
:meth:`DistFeature.from_dist_datasets`), global edge ids routed by the
edge partition book; :meth:`DistFeature.collate_edge_attr` fills a
sampler output's ``edge_attr`` from its ``edge`` ids.

A partition may spill (``split_ratio < 1`` of
:meth:`DistFeature.from_dist_datasets`): its rank copies its first
``hot`` rows to the card and the rest to host memory, pinned and mapped
(``utils.offload.pin_host``), and serves both blocks in one launch of
K3's two-block form (``gather_rows_mixed``), the counterpart of the
``compute_on('device_host')`` read (dist_feature.py:260-277). The owner
splits at its own hot count, as JAX's ``my_hot`` does. Load the
partition to the host (``DistDataset.load(..., device='cpu')``) for a
spilled store: the card then never holds more than the hot rows. On the
CPU the cold block is a plain tensor and the plain twin reads it.

With ``host_offload=False`` a spilled store keeps its cold rows in
ordinary host memory and a lookup has a host phase (dist_feature.py:
298-475): the owner serves its hot rows with K3 and flags the lanes whose
row is at or past its hot count, the flag riding back as one more column
of the response (dist_feature.py:282-286); the requester then resolves
the flagged lanes from its own cold block, or, for another rank's
partition, through ``cold_fetcher(partition, ids)`` (e.g. an rpc client
calling the owner's :meth:`DistFeature.cold_get`;
:func:`resilient_cold_fetcher` adds replicas and the staleness cache),
and writes them into its answer on the card. The rows are the pinned
path's, bit for bit. A training step cannot hold the host phase
(``host_spilled``; ``require_device_resident``).

:func:`dist_feature_from_partitions_multihost` builds a rank's store
straight from the layout on disk (a rank reads only its own partition).
A partition's contribution to a host-side lookup is a
:data:`PartialFeature`.
"""
from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import cuda_kernels
from ..parallel.dist_feature import exchange_lookup
from ..parallel.mesh import Mesh
from ..partition import dense_book
from ..utils import as_numpy
from ..utils.offload import pin_host
from .dist_graph import rank_entry

#: (rows [M, D], index [M]): a partition's rows of a lookup and their
#: positions in the requesting batch (the reference's PartialFeature,
#: dist_feature.py:37-41); it types the host side of a lookup (cold_get,
#: a cold fetcher's answer).
PartialFeature = Tuple[torch.Tensor, torch.Tensor]


class DistFeature:
  """This rank's partition of an ``[N, D]`` feature table.

  Args:
    mesh: the rank's mesh, one rank a partition.
    parts: per-partition ``(feats [R_p, D], id2index [N])``, a sequence or
      a dict holding at least this rank's entry; ``id2index`` maps a
      global id to its row in the block (-1 where absent).
    feat_pb: the feature partition book, or one a partition (this rank's
      routes its requests).
    num_ids: the global id space N.
    dtype: optional cast (e.g. ``torch.bfloat16``).
    bucket_cap: per-owner request capacity of an exchange (0: the whole
      request vector); overflowing requests drain in further rounds.
    hot_counts: rows kept on the card, one a partition (a sequence or a
      dict holding this rank's; None: all of them). A spilled block's hot
      rows are copied to the card, its cold rows to host memory.
    host_offload: None or True pins and maps a spilled block's cold rows;
      False keeps them in host memory and resolves them in a host phase.
    cold_fetcher: ``fetcher(partition, ids [M]) -> [M, D]``, the cold
      rows of another rank's partition for the host phase
      (:meth:`set_cold_fetcher`).
  """

  def __init__(self, mesh: Mesh, parts, feat_pb, num_ids: int,
               dtype: Optional[torch.dtype] = None, bucket_cap: int = 0,
               hot_counts=None, host_offload: Optional[bool] = None,
               cold_fetcher=None):
    feats, id2index = rank_entry(parts, mesh, 'parts')
    if not isinstance(feats, torch.Tensor):
      feats = torch.as_tensor(np.asarray(feats))
    if isinstance(feat_pb, (list, tuple, dict)):
      feat_pb = rank_entry(feat_pb, mesh, 'feat_pb')
    self.mesh = mesh
    self.num_ids = int(num_ids)
    self.num_partitions = mesh.world
    self.feature_dim = int(feats.shape[1])
    self.dtype = dtype or feats.dtype
    self.bucket_cap = int(bucket_cap)
    r = int(feats.shape[0])
    hot = (r if hot_counts is None
           else int(rank_entry(hot_counts, mesh, 'hot_counts')))
    #: this rank's rows on the card (all of them unless it spills)
    self.hot_count = min(max(hot, 0), r)
    #: the cold rows, a CPU tensor (pinned and mapped on a card), or None
    self.cold_array: Optional[torch.Tensor] = None
    #: the mapping of ``cold_array`` for the card (``PinnedHost``), or None
    self.cold_pinned = None
    #: the host phase: cold rows in ordinary host memory, flagged by the
    #: owner and resolved by the requester
    self.host_phase = self.hot_count < r and host_offload is False
    self._cold_fetcher = cold_fetcher
    if self.hot_count < r:
      self.cold_array = torch.empty((r - self.hot_count, self.feature_dim),
                                    dtype=self.dtype)
      self.cold_array.copy_(feats[self.hot_count:])
      if mesh.device.type == 'cuda' and not self.host_phase:
        self.cold_pinned = pin_host(self.cold_array, mesh.device)
    #: this rank's hot rows [hot_count, D] on its card (a resident empty
    #: partition keeps one zero row, which no valid request reads); a
    #: spilled block's own copy, which holds no storage of ``feats``
    self.array = feats[:self.hot_count].to(
        mesh.device, self.dtype, copy=self.cold_array is not None)
    if r == 0:
      self.array = self.array.new_zeros((1, self.feature_dim))
    self.array = self.array.contiguous()
    self.num_rows = r
    m = as_numpy(id2index).astype(np.int32)
    if m.shape[0] < self.num_ids:
      m = np.concatenate([m, np.full(self.num_ids - m.shape[0], -1,
                                     np.int32)])
    #: global id -> this rank's row (-1 where this rank holds no row)
    self.id2index = torch.as_tensor(m[:self.num_ids], device=mesh.device)
    #: this rank's routing book: the owner of every id
    book = dense_book(feat_pb, self.num_ids)
    self.feat_pb = torch.as_tensor(book, device=mesh.device)
    if self.host_phase:
      # the host phase's books: the requester's routing (its own book)
      # and the owner's id -> row map of its cold block
      self._host_pb = np.asarray(book)
      self._host_id2index = m[:self.num_ids].astype(np.int64)

  @property
  def host_spilled(self) -> bool:
    """Spilled with its cold rows in a host phase (``host_offload=False``):
    a lookup inside a training step, which runs as one body, cannot read
    them (``require_device_resident``)."""
    return self.host_phase

  def _serve_rows(self, rows: torch.Tensor) -> torch.Tensor:
    """This rank's rows ``rows [M]`` (clamped into its block), through K3
    or, for a spilled block, K3 mixed over both blocks in one launch. In
    the host phase: the hot rows through K3 (a cold lane reads row 0 and
    is masked by its caller)."""
    if self.host_phase:
      if not self.hot_count:
        return self.array.new_zeros((rows.numel(), self.feature_dim))
      return cuda_kernels.gather_rows(
          self.array, rows.clamp(0, self.hot_count - 1))
    if self.cold_array is None:
      return cuda_kernels.gather_rows(
          self.array, rows.clamp(0, self.array.shape[0] - 1))
    cold = (self.cold_pinned if self.cold_pinned is not None
            else self.cold_array)
    return cuda_kernels.gather_rows_mixed(
        self.array, cold, rows.clamp(0, self.num_rows - 1))

  def lookup_local(self, ids: torch.Tensor, valid: torch.Tensor,
                   static_rounds: bool = False) -> torch.Tensor:
    """Rows of this rank's global ``ids [B]`` (a collective: every rank
    calls it with the same B), ``[B, D]`` on its card, zero where
    ``~valid`` (dist_feature.py:214 ``lookup_local``)."""
    n = self.num_partitions
    hi = self.num_ids - 1
    ids = ids.reshape(-1).to(torch.int32)
    owner = self.feat_pb.index_select(0, ids.long().clamp(0, hi))
    owner = torch.where(valid, owner, torch.full_like(owner, n))

    def serve(req_in):
      rows = self.id2index.index_select(0, req_in.long().clamp(0, hi))
      ok = (req_in >= 0) & (rows >= 0)
      if self.host_phase:
        cold = ok & (rows >= self.hot_count)
        ok = ok & (rows < self.hot_count)
      got = self._serve_rows(rows)
      got = torch.where(ok[:, None], got, torch.zeros_like(got))
      if not self.host_phase:
        return got
      # the cold flag rides back as one more response column, so the
      # requester learns hot/cold without the owner's id2index
      return torch.cat([got, cold[:, None].to(got.dtype)], 1)

    if not self.host_phase:
      return exchange_lookup(ids, owner, self.mesh, self.bucket_cap, serve,
                             self.feature_dim, self.dtype, static_rounds)
    full = exchange_lookup(ids, owner, self.mesh, self.bucket_cap, serve,
                           self.feature_dim + 1, self.dtype, static_rounds)
    out = full[:, :self.feature_dim].contiguous()
    lanes = torch.nonzero(full[:, self.feature_dim] > 0).reshape(-1)
    if lanes.numel():
      out = self._resolve_cold(out, lanes, ids)
    return out

  # -- the host phase ----------------------------------------------------

  def _resolve_cold(self, out: torch.Tensor, lanes: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """Serves the flagged ``lanes`` of ``out`` (zero rows there) from the
    host: this rank's partition from its own cold block, another's
    through the cold fetcher, routed by this rank's book
    (dist_feature.py:333-390). The rows are written into ``out`` on its
    card by one scatter (JAX adds a delta that is zero elsewhere; an add
    would turn a -0.0 into +0.0)."""
    cold_ids = ids.index_select(0, lanes).long().cpu().numpy()
    owners = self._host_pb[np.clip(cold_ids, 0, self.num_ids - 1)]
    vals = torch.empty((cold_ids.shape[0], self.feature_dim),
                       dtype=self.dtype)
    for p in np.unique(owners):
      m = owners == p
      p = int(p)
      if p == self.mesh.rank:
        vals[torch.from_numpy(m)] = self.cold_get(p, cold_ids[m])
      elif self._cold_fetcher is not None:
        got = self._cold_fetcher(p, cold_ids[m])
        got = (got.cpu() if isinstance(got, torch.Tensor)
               else torch.as_tensor(np.asarray(got)))
        vals[torch.from_numpy(m)] = got.to(self.dtype)
      else:
        raise RuntimeError(
            f'partition {p} holds cold rows in another process and no '
            'cold_fetcher is registered (see set_cold_fetcher)')
    return out.index_copy(0, lanes, vals.to(out.device))

  def set_cold_fetcher(self, fetcher) -> None:
    """The host phase's resolver of another rank's cold rows:
    ``fetcher(partition: int, ids: np.int64 [M]) -> [M, D]`` (a tensor or
    numpy). Wrap it with :func:`resilient_cold_fetcher` for replicas and
    the staleness cache."""
    self._cold_fetcher = fetcher

  def cold_get(self, partition: int, ids) -> torch.Tensor:
    """Cold rows of this rank's partition by global id, a CPU tensor
    ``[M, D]``: the rpc callee behind another rank's cold fetcher
    (reference RpcFeatureLookupCallee, dist_feature.py:57-66). Only a
    host-phase store keeps them there."""
    if not self.host_phase:
      raise RuntimeError(
          'cold_get serves the host phase; this store reads its cold rows '
          'in K3 mixed (build it with host_offload=False)')
    if int(partition) != self.mesh.rank:
      raise ValueError(f'rank {self.mesh.rank} holds partition '
                       f'{self.mesh.rank}, not {partition}')
    rows = self._host_id2index[np.asarray(ids, np.int64)] - self.hot_count
    return self.cold_array.index_select(0, torch.from_numpy(rows))

  def lookup(self, ids, valid=None) -> torch.Tensor:
    """Whole-mesh lookup outside a step (a collective): ``ids [world *
    B]`` shard-major, the same on every rank; returns this rank's block,
    the rows of ``ids[rank*B:(rank+1)*B]``, ``[B, D]`` on its card."""
    mesh = self.mesh
    ids_np = as_numpy(ids).astype(np.int64).reshape(-1)
    if ids_np.shape[0] % mesh.world:
      raise ValueError(f'{ids_np.shape[0]} ids do not split over '
                       f'{mesh.world} ranks')
    b = ids_np.shape[0] // mesh.world
    mine = slice(mesh.rank * b, (mesh.rank + 1) * b)
    valid_np = (np.ones(ids_np.shape, bool) if valid is None
                else as_numpy(valid).astype(bool).reshape(-1))
    return self.lookup_local(
        torch.as_tensor(ids_np[mine].astype(np.int32), device=mesh.device),
        torch.as_tensor(valid_np[mine], device=mesh.device))

  def collate_edge_attr(self, out: dict,
                        static_rounds: bool = False) -> torch.Tensor:
    """``out['edge_attr']`` for a sampler output of this rank: the rows of
    its ``edge`` ids under its ``edge_mask`` (zero elsewhere), one
    exchange (dist_feature.py:407 ``collate_edge_attr``). Returns it."""
    eids = out['edge']
    out['edge_attr'] = self.lookup_local(
        eids.clamp(min=0), out['edge_mask'].reshape(-1),
        static_rounds=static_rounds).reshape(tuple(eids.shape) + (-1,))
    return out['edge_attr']

  @classmethod
  def from_dist_datasets(cls, mesh: Mesh, datasets, ntype=None,
                         dtype: Optional[torch.dtype] = None,
                         bucket_cap: int = 0, kind: str = 'node',
                         split_ratio: Optional[float] = None,
                         host_offload: Optional[bool] = None,
                         cold_fetcher=None) -> 'DistFeature':
    """This rank's store from its partition's
    :class:`~glt_tpu_torch.distributed.DistDataset` (``datasets``: one a
    partition, a sequence or a dict holding at least this rank's): its
    node features (of node type ``ntype`` for a hetero one) or, with
    ``kind='edge'``, its edge features over global edge ids (of edge type
    ``ntype``), routed by the edge book. ``split_ratio`` spills the store:
    ``round(R_p * split_ratio)`` rows on the card, as JAX counts them
    (default: all). A resident store takes a dataset table on the card as
    it is, not copied, when it already has the store's dtype; load the
    dataset to the host for a spilled one."""
    if kind not in ('node', 'edge'):
      raise ValueError(f"kind is 'node' or 'edge', got {kind!r}")
    ds = rank_entry(datasets, mesh, 'datasets')
    if kind == 'edge':
      feat, pb = ds.get_edge_feature(ntype), ds.get_edge_feat_pb(ntype)
      if feat is None:
        raise ValueError(f'partition {mesh.rank} holds no edge features '
                         f'(etype={ntype!r}); partition with edge_feat')
    else:
      feat, pb = ds.get_node_feature(ntype), ds.get_node_feat_pb(ntype)
    block = feat.table           # a partition Feature is never split
    hot = (None if split_ratio is None
           else {mesh.rank: int(round(block.shape[0] * float(split_ratio)))})
    return cls(mesh, {mesh.rank: (block, feat._id2index)}, pb,
               pb.table.shape[0], dtype=dtype, bucket_cap=bucket_cap,
               hot_counts=hot, host_offload=host_offload,
               cold_fetcher=cold_fetcher)


def resilient_cold_fetcher(fetchers, feature_dim: Optional[int] = None,
                           metrics=None, cache_capacity: int = 200_000):
  """Per-partition cold fetchers composed into one fault-tolerant
  ``fetcher(partition, ids) -> [M, D]`` for
  :meth:`DistFeature.set_cold_fetcher` (dist_feature.py:475-513).

  Args:
    fetchers: ``{partition: [fn, ...]}``, each ``fn(ids) -> [M, D]``
      (a tensor or numpy), the primary first and its replicas after.
    feature_dim: the row width for zero rows before any fetch succeeded.
    metrics: None, or an object with ``record_failover``,
      ``record_stale_serve`` and ``add_gauge``.

  The ladder of a lookup: the primary, then the replicas in order (each
  connection failure noted; the first success wins and refreshes the
  staleness cache), then the cached rows and zero rows for true misses,
  counted and logged. Raises only when it cannot degrade (no cached rows
  and no row width). Returns CPU tensors.
  """
  from ..resilience import DegradedFeatureCache
  stale = DegradedFeatureCache(capacity=cache_capacity)
  if feature_dim is not None:
    stale.feature_dim = int(feature_dim)
  fetchers = {int(p): list(fs) for p, fs in fetchers.items()}

  def fetch(partition: int, ids) -> torch.Tensor:
    ids = np.asarray(ids, np.int64)
    last: Optional[BaseException] = None
    for k, fn in enumerate(fetchers.get(int(partition), [])):
      try:
        rows = fn(ids)
      except (ConnectionError, OSError) as e:
        last = e
        continue
      rows = (rows.cpu() if isinstance(rows, torch.Tensor)
              else torch.as_tensor(np.asarray(rows)))
      if k > 0 and metrics is not None:
        metrics.record_failover()
      stale.update(ids, rows)
      return rows
    logging.getLogger(__name__).debug('cold fetch of partition %d failed '
                                      'on every replica', partition)
    return stale.serve_counted(
        ids, metrics, what=f'cold fetch(partition {partition})', cause=last)

  return fetch


def dist_feature_from_partitions_multihost(
    mesh: Mesh, root_dir: str, ntype=None,
    dtype: Optional[torch.dtype] = None, kind: str = 'node',
    split_ratio: float = 1.0, cold_fetcher=None, bucket_cap: int = 0,
    host_offload: Optional[bool] = None) -> DistFeature:
  """This rank's store straight from the layout at ``root_dir`` (glt_tpu/
  distributed/dist_feature.py:513): the rank loads only its own partition
  (to the host when ``split_ratio < 1``, else to the card) and builds
  through :meth:`DistFeature.from_dist_datasets`; ``kind='edge'`` reads
  the edge features (``ntype`` then names the edge type). The JAX
  ``row_gather`` seam has no counterpart (K3 serves every store)."""
  from ..partition import load_meta
  from .dist_dataset import DistDataset
  if kind not in ('node', 'edge'):
    raise ValueError(f"kind is 'node' or 'edge', got {kind!r}")
  meta = load_meta(root_dir)
  if meta['num_parts'] != mesh.world:
    raise ValueError(
        f"mesh has {mesh.world} devices but the partition dir holds "
        f"{meta['num_parts']} partitions")
  spill = float(split_ratio) < 1.0
  ds = DistDataset.load(root_dir, mesh.rank,
                        device='cpu' if spill else mesh.device)
  feat = (ds.get_edge_feature(ntype) if kind == 'edge'
          else ds.get_node_feature(ntype))
  if feat is None:
    raise ValueError(
        f'partition {mesh.rank} of {root_dir} holds no {kind} features '
        f'(ntype={ntype!r}); partition with '
        f'{"edge_feat" if kind == "edge" else "node_feat"} to use '
        f'kind={kind!r}')
  return DistFeature.from_dist_datasets(
      mesh, {mesh.rank: ds}, ntype=ntype, dtype=dtype, bucket_cap=bucket_cap,
      kind=kind, split_ratio=split_ratio if spill else None,
      host_offload=host_offload, cold_fetcher=cold_fetcher)
