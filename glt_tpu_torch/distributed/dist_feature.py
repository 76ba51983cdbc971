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

Not ported (ROADMAP A12): the host phase of a spilled store
(``host_offload=False``: ``_resolve_cold``, ``cold_get``,
``set_cold_fetcher``, ``resilient_cold_fetcher``), which waits for the
rpc stack, and the multihost loader
(``dist_feature_from_partitions_multihost``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import cuda_kernels
from ..parallel.dist_feature import exchange_lookup
from ..parallel.mesh import Mesh
from ..partition import dense_book
from ..utils import as_numpy
from ..utils.offload import pin_host
from .dist_graph import rank_entry


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
      False (the host phase) raises NotImplementedError.
  """

  def __init__(self, mesh: Mesh, parts, feat_pb, num_ids: int,
               dtype: Optional[torch.dtype] = None, bucket_cap: int = 0,
               hot_counts=None, host_offload: Optional[bool] = None):
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
    if self.hot_count < r:
      if host_offload is False:
        raise NotImplementedError(
            'a spilled DistFeature with host_offload=False needs the host '
            'phase and its cold fetcher over rpc, which are not ported; '
            'pin the cold block (host_offload None or True)')
      self.cold_array = torch.empty((r - self.hot_count, self.feature_dim),
                                    dtype=self.dtype)
      self.cold_array.copy_(feats[self.hot_count:])
      if mesh.device.type == 'cuda':
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
    self.feat_pb = torch.as_tensor(dense_book(feat_pb, self.num_ids),
                                   device=mesh.device)

  @property
  def host_spilled(self) -> bool:
    """Never: a spilled block is pinned (see ``require_device_resident``),
    and the host phase is not ported."""
    return False

  def _serve_rows(self, rows: torch.Tensor) -> torch.Tensor:
    """This rank's rows ``rows [M]`` (clamped into its block), through K3
    or, for a spilled block, K3 mixed over both blocks in one launch."""
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
      got = self._serve_rows(rows)
      return torch.where(ok[:, None], got, torch.zeros_like(got))

    return exchange_lookup(ids, owner, self.mesh, self.bucket_cap, serve,
                           self.feature_dim, self.dtype, static_rounds)

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
                         host_offload: Optional[bool] = None
                         ) -> 'DistFeature':
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
               hot_counts=hot, host_offload=host_offload)
