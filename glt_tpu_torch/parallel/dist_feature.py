"""Row-sharded feature table with an exchange lookup (counterpart of
glt_tpu/parallel/dist_feature.py).

The table is split over the mesh's ranks by the range rule (owner = id //
rows_per_shard, the tail shard padded with zero rows); each rank keeps
only its own shard. A lookup from inside a training step is

    bucket ids by owner -> all_to_all -> serve from the local shard
    -> all_to_all back -> unbucket

(parallel/collectives.py) with fixed-capacity buckets, so every shape is
fixed and the step can be captured in a CUDA graph. A rank serves its
rows with the ``gather_rows`` kernel (K3), the counterpart of the
``resolve_row_gather`` seam (dist_feature.py:249).

A shard may spill (``split_ratio < 1``): its rows ``[hot_count,
rows_per_shard)`` stay in host memory. By default they are pinned and
mapped (``utils.offload.pin_host``) and served in the same launch as the
hot rows by K3's two-block form (``gather_rows_mixed``), the counterpart
of the ``compute_on('device_host')`` read (dist_feature.py:256-279). With
``host_offload=False`` they stay in ordinary host memory: :meth:`lookup`
then adds them on the host after the exchange, and a superstep trainer
stages them per window (:meth:`stage_cold_rows`,
``SPMDSageTrainStep(cold_streaming=True)``).

Unlike the JAX package nothing is compiled, so ``bucket_cap`` is read at
every lookup and may change between them, and there is no ``row_gather``
override: a card always serves through K3, the CPU through its plain
twin.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.feature import _host_numpy
from ..ops import cuda_kernels
from ..utils import as_numpy
from ..utils.offload import pin_host
from .collectives import (all_to_all, bucket_meta, bucket_payload,
                          capped_drain, unbucket)
from .mesh import Mesh


def overflow_lanes(owner_key: np.ndarray, n_shards: int, b: int,
                   cap: int) -> np.ndarray:
  """Host replay of the bucketing: True where a valid request
  (``owner_key < n_shards``) ranks past its owner's bucket capacity
  within its B-lane block. No lookup needs it (the drain runs in the
  step); it predicts how many rounds a capped exchange takes."""
  over = np.zeros(owner_key.shape[0], bool)
  for lo in range(0, owner_key.shape[0], b):
    ok = owner_key[lo:lo + b]
    order = np.argsort(ok, kind='stable')
    osort = ok[order]
    counts = np.bincount(np.minimum(osort, n_shards),
                         minlength=n_shards + 1)[:n_shards]
    offsets = np.cumsum(counts) - counts
    pos = np.arange(ok.shape[0]) - offsets[
        np.minimum(osort, n_shards - 1)]
    blk = np.zeros(ok.shape[0], bool)
    blk[order] = (osort < n_shards) & (pos >= cap)
    over[lo:lo + b] = blk
  return over


def require_device_resident(store, ctx: str) -> None:
  """A training step gathers its features inside one body that may run
  as a CUDA graph, where no host phase can run: a spilled store without
  its pinned block would train on zero rows for every cold row. Trainers
  call this first and raise instead."""
  if store is not None and store.host_spilled:
    raise NotImplementedError(
        f'{ctx}: the step samples, gathers and updates in one body and '
        'cannot read host-spilled feature rows; use the pinned cold block '
        '(host_offload other than False), a resident store '
        '(split_ratio=1.0), or cold_streaming=True, which stages the cold '
        'rows of each window on the host')


def exchange_lookup(ids: torch.Tensor, owner: torch.Tensor, mesh: Mesh,
                    bucket_cap: int, serve, dim: int, dtype: torch.dtype,
                    static_rounds: bool = False) -> torch.Tensor:
  """The exchange of a lookup from inside a step (a collective: every
  rank calls it with the same B): ``ids [B]`` int32 bucketed by ``owner``
  (``mesh.world`` for a lane that asks nothing), sent to their owners,
  served there by ``serve(requests [world * C]) -> [world * C, dim]``
  (zero rows for the requests it does not serve; a request slot past an
  owner's count holds -1) and sent back, ``[B, dim]`` in request order.

  With a ``bucket_cap`` C below B the exchange drains in rounds
  (:func:`~glt_tpu_torch.parallel.collectives.capped_drain`): as many as
  the mesh's fullest bucket needs, read on the host, or with
  ``static_rounds`` the worst case, which a CUDA graph can hold."""
  n_shards, b = mesh.world, ids.numel()
  meta = bucket_meta(owner, n_shards)
  cap = bucket_cap if 0 < bucket_cap < b else b

  def round_out(base):
    req = bucket_payload(ids, meta, n_shards, fill_value=-1, capacity=cap,
                         round_offset=base)
    # row p: what rank p asks of this rank
    req_in = all_to_all(req, mesh).reshape(-1)
    # row p: this rank's requests as rank p served them
    resp = all_to_all(serve(req_in).view(n_shards, cap, dim), mesh)
    return unbucket(resp, meta, n_shards, round_offset=base)

  if cap >= b:
    return round_out(0)     # one uncapped round serves everything
  return capped_drain(round_out, meta, n_shards, cap, b, mesh,
                      torch.zeros((b, dim), dtype=dtype, device=mesh.device),
                      static_rounds=static_rounds)


class ShardedFeature:
  """``[N, D]`` feature table row-sharded over ``mesh``'s ranks.

  Args:
    feats: the whole table (numpy or a tensor on any device); every rank
      passes the same table and keeps its own shard.
    mesh: the rank's :class:`~glt_tpu_torch.parallel.mesh.Mesh`.
    dtype: optional cast (e.g. ``torch.bfloat16``).
    split_ratio: the share of each shard on the card (at least one row
      when below 1).
    bucket_cap: per-owner request capacity of an exchange (0: the whole
      request vector); overflowing requests drain in further rounds.
    host_offload: None or True pins and maps a spilled shard's cold rows
      for the card; False keeps every shard's cold rows in host memory.
  """

  def __init__(self, feats, mesh: Mesh, dtype: Optional[torch.dtype] = None,
               split_ratio: float = 1.0, bucket_cap: int = 0,
               host_offload: Optional[bool] = None):
    if not isinstance(feats, torch.Tensor):
      feats = torch.as_tensor(np.asarray(feats))
    if dtype is not None:
      feats = feats.to(dtype)
    self.mesh = mesh
    n_shards, rank = mesh.world, mesh.rank
    n = feats.shape[0]
    self.num_rows = n
    self.feature_dim = feats.shape[1]
    self.dtype = feats.dtype
    self.rows_per_shard = r = math.ceil(n / n_shards)
    self.bucket_cap = int(bucket_cap)
    self.split_ratio = float(split_ratio)
    self.hot_count = (r if self.split_ratio >= 1.0
                      else max(1, int(round(r * self.split_ratio))))
    spill = self.hot_count < r
    shard = feats[rank * r:(rank + 1) * r]
    if shard.shape[0] < r:     # the tail shard's zero rows
      shard = torch.cat([shard, shard.new_zeros((r - shard.shape[0],
                                                 self.feature_dim))])
    #: this rank's hot rows [hot_count, D] on its card
    self.array = shard[:self.hot_count].to(mesh.device).contiguous()
    offload = spill and host_offload is not False
    self.cold_array: Optional[torch.Tensor] = None
    self.cold_pinned = None
    self._host_cold = None
    if offload:
      #: this rank's cold rows, a CPU tensor (pinned and mapped on a card)
      self.cold_array = torch.empty(
          (r - self.hot_count, self.feature_dim), dtype=self.dtype)
      self.cold_array.copy_(shard[self.hot_count:])
      if mesh.device.type == 'cuda':
        self.cold_pinned = pin_host(self.cold_array, mesh.device)
    elif spill:
      # every shard's cold rows, numpy: a rank stages the cold rows of
      # whichever owner its batch reads
      host = _host_numpy(feats)
      self._host_cold = [host[p * r + self.hot_count:(p + 1) * r]
                         for p in range(n_shards)]

  @property
  def host_spilled(self) -> bool:
    """Spilled without a pinned block: the cold rows are only on the host,
    so a lookup inside a step reads them as zeros."""
    return self._host_cold is not None

  # -- in-step lookup ----------------------------------------------------

  def lookup_local(self, ids: torch.Tensor, valid: torch.Tensor,
                   static_rounds: bool = False) -> torch.Tensor:
    """Rows of this rank's global ``ids`` [B] (a collective: every rank
    calls it with the same B); ``[B, D]`` on the rank's card, zero where
    ``~valid`` and, for a store without its pinned block, on cold rows.

    With a ``bucket_cap`` below B the exchange drains in rounds
    (:func:`~glt_tpu_torch.parallel.collectives.capped_drain`): as many
    as the mesh's fullest bucket needs, read on the host, or with
    ``static_rounds`` the worst case, which a CUDA graph can hold."""
    mesh, n_shards = self.mesh, self.mesh.world
    ids = ids.reshape(-1).to(torch.int32)
    r, h = self.rows_per_shard, self.hot_count
    owner = torch.where(valid, (ids // r).clamp(0, n_shards - 1),
                        torch.full_like(ids, n_shards))   # pads sort last
    base_row = mesh.rank * r

    def serve(req_in):
      local = req_in - base_row
      if self.cold_array is not None:
        # hot rows from the card, cold ones from the pinned block, one
        # launch
        ok = (local >= 0) & (local < r) & (req_in >= 0)
        cold = (self.cold_pinned if self.cold_pinned is not None
                else self.cold_array)
        rows = cuda_kernels.gather_rows_mixed(self.array, cold,
                                              local.clamp(0, r - 1))
      else:
        ok = (local >= 0) & (local < h) & (req_in >= 0)
        rows = cuda_kernels.gather_rows(self.array, local.clamp(0, h - 1))
      return torch.where(ok[:, None], rows, torch.zeros_like(rows))

    return exchange_lookup(ids, owner, mesh, self.bucket_cap, serve,
                           self.feature_dim, self.dtype, static_rounds)

  # -- host phase and staging --------------------------------------------

  def _cold_values_host(self, nodes: np.ndarray, valid: np.ndarray
                        ) -> Tuple[np.ndarray, bool]:
    """Spilled rows of ``nodes`` on the host: the range rule finds the
    cold lanes (owner = id // rows_per_shard, cold = local row >=
    hot_count), the owners' host blocks give the values. Returns ``([...,
    D] values, zero on every other lane, any_cold)``."""
    n_shards = self.mesh.world
    owner = np.clip(nodes // self.rows_per_shard, 0, n_shards - 1)
    local = nodes - owner * self.rows_per_shard
    cold = valid & (local >= self.hot_count) & (nodes >= 0) \
        & (nodes < self.num_rows)
    out = np.zeros(nodes.shape + (self.feature_dim,),
                   self._host_cold[0].dtype)
    lanes = np.nonzero(cold)
    own = owner[lanes]
    for p in np.unique(own):
      m = tuple(ax[own == p] for ax in lanes)
      out[m] = self._host_cold[int(p)][local[m] - self.hot_count]
    return out, bool(lanes[0].size)

  def stage_cold_rows(self, nodes, counts) -> np.ndarray:
    """Host gather of the spilled rows of pre-sampled node stacks, the
    staging half of the superstep trainer's cold streaming.

    Args:
      nodes: ``[..., n_shards * B]`` global node ids, shard-major (rank
        d's B sampled slots at ``[..., d*B:(d+1)*B]``); a rank staging
        only its own block passes ``[..., B]``.
      counts: ``[..., n_blocks]`` valid node counts per block of
        ``nodes``' last axis: ``n_shards`` for the mesh's stack, one for
        a rank's own block.

    Returns ``[..., n_blocks * B, D]`` numpy (bf16 widened to float32):
    cold rows on cold valid lanes, zeros elsewhere, exactly the lanes the
    hot lookup returns as zero, so one add merges them."""
    if not self.host_spilled:
      raise ValueError(
          'stage_cold_rows serves host-spilled stores without a pinned '
          'cold block; this store reads its cold rows in the lookup '
          '(cold_array) or holds every row on the card')
    nodes = as_numpy(nodes).astype(np.int64)
    counts = as_numpy(counts)
    nb, blocks = nodes.shape[-1], counts.shape[-1]
    if nb % blocks:
      raise ValueError(f'{nb} node slots do not split into {blocks} blocks')
    b = nb // blocks
    lane = np.arange(nb) % b
    block = np.arange(nb) // b
    return self._cold_values_host(nodes, lane < counts[..., block])[0]

  def lookup(self, ids, valid=None) -> torch.Tensor:
    """Whole-mesh lookup outside a step (a collective): ``ids [n_shards *
    B]`` shard-major, the same on every rank; returns this rank's block,
    the rows of ``ids[rank*B:(rank+1)*B]``, ``[B, D]`` on its card. A
    store without its pinned block adds its cold rows on the host."""
    mesh = self.mesh
    ids_np = as_numpy(ids).astype(np.int64).reshape(-1)
    if ids_np.shape[0] % mesh.world:
      raise ValueError(f'{ids_np.shape[0]} ids do not split over '
                       f'{mesh.world} ranks')
    b = ids_np.shape[0] // mesh.world
    mine = slice(mesh.rank * b, (mesh.rank + 1) * b)
    valid_np = (np.ones(ids_np.shape, bool) if valid is None
                else as_numpy(valid).astype(bool).reshape(-1))
    out = self.lookup_local(
        torch.as_tensor(ids_np[mine].astype(np.int32), device=mesh.device),
        torch.as_tensor(valid_np[mine], device=mesh.device))
    if not self.host_spilled:
      return out
    delta, any_cold = self._cold_values_host(ids_np[mine], valid_np[mine])
    if not any_cold:
      return out
    return out + torch.as_tensor(delta).to(out.device, out.dtype)
