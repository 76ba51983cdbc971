"""DistFeature: a partitioned feature store with an exchange lookup
(counterpart of glt_tpu/distributed/dist_feature.py).

Unlike :class:`~glt_tpu_torch.parallel.ShardedFeature` (the range rule)
this store follows an arbitrary feature partition book: rank p keeps
partition p's rows on its card and a dense ``id2index`` [N] from global
id to its row there (-1 for an id it does not hold). A lookup routes each
id by the *requesting* rank's book (a book rewritten for cached rows
differs from rank to rank), exchanges the requests, the owner reads its
rows with the ``gather_rows`` kernel (K3; the counterpart of the
``resolve_row_gather`` seam, dist_feature.py:255) and the rows go back:
the exchange of ``parallel/dist_feature.py`` (:func:`exchange_lookup`,
its capped drain included).

Not ported (ROADMAP A12): the spill (``split_ratio < 1``, its host phase
and ``cold_fetcher``), edge-feature stores and the multihost builder.
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

  Every row stays on the card (the spilled store is not ported).
  """

  def __init__(self, mesh: Mesh, parts, feat_pb, num_ids: int,
               dtype: Optional[torch.dtype] = None, bucket_cap: int = 0):
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
    #: this rank's rows [max(R_p, 1), D] on its card (an empty partition
    #: keeps one zero row, which no valid request reads)
    self.array = feats.to(mesh.device, self.dtype)
    if self.array.shape[0] == 0:
      self.array = self.array.new_zeros((1, self.feature_dim))
    self.array = self.array.contiguous()
    m = as_numpy(id2index).astype(np.int32)
    if m.shape[0] < self.num_ids:
      m = np.concatenate([m, np.full(self.num_ids - m.shape[0], -1,
                                     np.int32)])
    #: global id -> row of ``array`` (-1 where this rank holds no row)
    self.id2index = torch.as_tensor(m[:self.num_ids], device=mesh.device)
    #: this rank's routing book: the owner of every id
    self.feat_pb = torch.as_tensor(dense_book(feat_pb, self.num_ids),
                                   device=mesh.device)

  @property
  def host_spilled(self) -> bool:
    """Every row is on the card (see ``require_device_resident``)."""
    return False

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
    rows_max = self.array.shape[0] - 1

    def serve(req_in):
      rows = self.id2index.index_select(0, req_in.long().clamp(0, hi))
      ok = (req_in >= 0) & (rows >= 0)
      got = cuda_kernels.gather_rows(self.array, rows.clamp(0, rows_max))
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

  @classmethod
  def from_dist_datasets(cls, mesh: Mesh, datasets, ntype=None,
                         dtype: Optional[torch.dtype] = None,
                         bucket_cap: int = 0) -> 'DistFeature':
    """This rank's store from its partition's
    :class:`~glt_tpu_torch.distributed.DistDataset` (``datasets``: one a
    partition, a sequence or a dict holding at least this rank's; the
    node features of ``ntype`` for a hetero one). The dataset's table on
    the card is taken as it is, not copied, when it already has the
    store's dtype."""
    ds = rank_entry(datasets, mesh, 'datasets')
    feat = ds.get_node_feature(ntype)
    if not feat.fully_device_resident:
      raise NotImplementedError(
          'a partition Feature with spilled rows; the spilled DistFeature '
          'is not ported')
    pb = ds.get_node_feat_pb(ntype)
    return cls(mesh, {mesh.rank: (feat.device_part, feat._id2index)},
               pb, pb.table.shape[0], dtype=dtype, bucket_cap=bucket_cap)
