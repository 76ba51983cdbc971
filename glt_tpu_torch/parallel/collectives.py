"""Bucket, exchange, unbucket: the data-parallel request/response pattern
(counterpart of glt_tpu/parallel/collectives.py:19-158).

Requests are packed into fixed-capacity per-owner buckets, exchanged
with one ``all_to_all``, served by their owners and sent back with a
second one; the unbucketing scatter puts each response back at its
request's position. Every shape is fixed by the request count and the
capacity, so a step that exchanges can be captured in a CUDA graph.

``torch.bincount`` reads its input's maximum on the host on a card, so
the per-owner counts here are a ``scatter_add_`` into ``n_shards + 1``
slots; the gathers and scatters go through flat ``index_select`` and
``index_copy_``/``scatter_`` for the same reason.

The sharded segment means (:func:`sharded_segment_mean`,
:func:`sharded_segment_mean_scattered`) aggregate messages whose rows are
spread over the ranks: each rank sums its rows by segment, and the sums
and counts are reduced over the group.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch
import torch.distributed as dist

from .mesh import Mesh


class BucketMeta(NamedTuple):
  order: torch.Tensor          # stable argsort of the owners
  owner_sorted: torch.Tensor   # [B]
  pos_in_bucket: torch.Tensor  # [B]


def _owner_counts(owner_sorted: torch.Tensor, n_shards: int) -> torch.Tensor:
  """Requests per owner [n_shards]; invalid owners (== n_shards) drop."""
  counts = torch.zeros(n_shards + 1, dtype=torch.int64,
                       device=owner_sorted.device)
  counts.scatter_add_(0, owner_sorted.clamp(max=n_shards),
                      torch.ones_like(owner_sorted))
  return counts[:n_shards]


def bucket_meta(owner: torch.Tensor, n_shards: int) -> BucketMeta:
  """The bucket layout of requests whose owners are ``owner`` (``[0,
  n_shards)`` for valid requests, ``n_shards`` for dropped ones): the
  stable sort by owner and each request's rank within its bucket."""
  owner = owner.long()
  b = owner.numel()
  owner_sorted, order = torch.sort(owner, stable=True)
  counts = _owner_counts(owner_sorted, n_shards)
  offsets = torch.cumsum(counts, 0) - counts
  pos = torch.arange(b, device=owner.device) - offsets.index_select(
      0, owner_sorted.clamp(max=n_shards - 1))
  return BucketMeta(order, owner_sorted, pos)


def bucket_by_owner(ids: torch.Tensor, owner: torch.Tensor, n_shards: int,
                    fill_value=-1, capacity: int = 0):
  """Pack ``ids`` into per-owner buckets ``[n_shards, C]``; returns
  ``(buckets, meta)``.

  ``owner`` is in ``[0, n_shards)`` for valid entries and ``n_shards``
  for dropped ones. Bucket slots past an owner's request count hold
  ``fill_value``. ``capacity`` (0: B, the worst case) caps each bucket;
  requests ranked past it are not packed and come back as
  ``invalid_value`` from :func:`unbucket` (drained by
  :func:`capped_drain`)."""
  b = ids.numel()
  cap = capacity if capacity and capacity < b else b
  meta = bucket_meta(owner, n_shards)
  return bucket_payload(ids, meta, n_shards, fill_value,
                        capacity=cap), meta


def unbucket(resp: torch.Tensor, meta: BucketMeta, n_shards: int,
             invalid_value=0, round_offset=0) -> torch.Tensor:
  """Invert :func:`bucket_by_owner` over a response ``[n_shards, C,
  ...]``: ``[B, ...]`` in request order; dropped and out-of-round slots
  get ``invalid_value``. ``round_offset`` selects the drain round: only
  requests ranked ``[round_offset, round_offset + C)`` in their bucket
  are decoded, the inverse of the same offset given to
  :func:`bucket_payload`."""
  cap = resp.shape[1]
  pos = meta.pos_in_bucket - round_offset
  ok = (meta.owner_sorted < n_shards) & (pos >= 0) & (pos < cap)
  flat = (meta.owner_sorted.clamp(max=n_shards - 1) * cap
          + pos.clamp(0, cap - 1))
  gathered = resp.reshape((n_shards * cap,) + resp.shape[2:]).index_select(
      0, flat)
  shape = (ok.shape[0],) + (1,) * (gathered.dim() - 1)
  gathered = torch.where(ok.reshape(shape), gathered,
                         torch.full_like(gathered, invalid_value))
  return torch.zeros_like(gathered).index_copy_(0, meta.order, gathered)


def bucket_payload(values: torch.Tensor, meta: BucketMeta, n_shards: int,
                   fill_value=0, capacity: int = 0,
                   round_offset=0) -> torch.Tensor:
  """Pack a payload in the order of an existing bucket layout;
  ``round_offset`` packs the requests ranked ``[round_offset,
  round_offset + cap)`` in each bucket (drain round k packs offset
  ``k * cap``)."""
  b = values.numel()
  cap = capacity if capacity and capacity < b else b
  vals_sorted = values.reshape(-1).index_select(0, meta.order)
  pos = meta.pos_in_bucket - round_offset
  ok = (meta.owner_sorted < n_shards) & (pos >= 0) & (pos < cap)
  # out-of-round and dropped requests land in a sink row, cut off below
  flat = torch.where(ok, meta.owner_sorted * cap + pos.clamp(0, cap - 1),
                     torch.full_like(pos, n_shards * cap))
  buckets = torch.full(((n_shards + 1) * cap,), fill_value,
                       dtype=values.dtype, device=values.device)
  buckets.scatter_(0, flat, vals_sorted)
  return buckets[:n_shards * cap].view(n_shards, cap)


def drain_rounds(meta: BucketMeta, n_shards: int, cap: int,
                 mesh: Mesh) -> torch.Tensor:
  """Capped-exchange rounds that serve every request: the largest bucket
  over the whole mesh (an ``all_reduce`` max), ceil-divided by the
  capacity; the same value on every rank, a 0-dim tensor on its
  device."""
  counts = _owner_counts(meta.owner_sorted, n_shards)
  rounds = ((counts.max() + cap - 1) // cap).reshape(1)
  if mesh.world > 1:
    dist.all_reduce(rounds, op=dist.ReduceOp.MAX, group=mesh.group)
  return rounds[0]


def capped_drain(round_out: Callable[[int], torch.Tensor], meta: BucketMeta,
                 n_shards: int, cap: int, b: int, mesh: Mesh,
                 zeros: torch.Tensor, static_rounds: bool = False):
  """Sum ``round_out(base)`` over the capped-exchange rounds that serve
  every request. ``round_out`` returns the responses of the requests
  ranked ``[base, base + cap)`` in each bucket and zeros elsewhere, so a
  round past the true occupancy adds exact zeros.

  By default the round count is :func:`drain_rounds`, read on the host
  (one ``all_reduce`` and one device read), and the rounds are that many.
  ``static_rounds`` runs the worst case ``ceil(b / cap)`` instead, with
  no read: the value is the same (the JAX package's own unrolled branch,
  collectives.py:113-117), and a CUDA graph can hold it, where a loop
  bounded by a value on the card cannot be captured."""
  if static_rounds:
    rounds = -(-b // cap)
  else:
    rounds = int(drain_rounds(meta, n_shards, cap, mesh))
  acc = zeros
  for k in range(rounds):
    acc = acc + round_out(k * cap)
  return acc


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
  """Row p of ``x [P, ...]`` goes to rank p; row p of the result came
  from rank p. On a mesh of one rank that is ``x`` itself, what the JAX
  ``all_to_all`` over a one-device axis computes, so no collective runs
  (nothing to capture or launch for a one-rank group)."""
  if mesh.world == 1:
    return x
  x = x.contiguous()
  out = torch.empty_like(x)
  dist.all_to_all_single(out, x, group=mesh.group)
  return out


def _group_of(group: Union[Mesh, 'dist.ProcessGroup', None]):
  """``(process group, world size, reduce)`` of a :class:`Mesh`, a process
  group or None (the default group): ``reduce`` is False only when
  ``torch.distributed`` has no group, where the result is this process's
  own."""
  if isinstance(group, Mesh):
    group = group.group
  if dist.is_available() and dist.is_initialized():
    return group, dist.get_world_size(group), True
  if group is not None:
    raise ValueError('a process group needs torch.distributed initialised')
  return None, 1, False


def _local_segment_sums(msgs: torch.Tensor, targets: torch.Tensor,
                        mask: torch.Tensor, num_segments: int):
  """This rank's masked ``(sum [S, D], count [S])`` per segment; masked
  rows go to a sink segment ``S``, cut off."""
  seg = torch.where(mask, targets.long(),
                    torch.full_like(targets, num_segments, dtype=torch.long))
  rows = torch.where(mask[:, None], msgs, torch.zeros_like(msgs))
  total = torch.zeros((num_segments + 1,) + tuple(msgs.shape[1:]),
                      dtype=msgs.dtype, device=msgs.device)
  total.index_add_(0, seg, rows)
  cnt = torch.zeros(num_segments + 1, dtype=msgs.dtype, device=msgs.device)
  cnt.index_add_(0, seg, mask.to(msgs.dtype))
  return total[:num_segments], cnt[:num_segments]


def sharded_segment_mean(msgs: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor, num_segments: int,
                         group: Union[Mesh, 'dist.ProcessGroup', None] = None
                         ) -> torch.Tensor:
  """Mean of the valid message rows by destination segment, the rows
  spread over the ranks of ``group`` (a :class:`Mesh`, a process group, or
  None for the default group): each rank sums its rows, one ``all_reduce``
  (sum) adds the sums and one the counts. An empty segment's mean is 0.

  Args:
    msgs: ``[M, D]`` this rank's message rows.
    targets: ``[M]`` each row's segment.
    mask: ``[M]`` bool, the valid rows.
    num_segments: the global segment count.

  Returns ``[num_segments, D]``, the same on every rank."""
  pg, _, reduce = _group_of(group)
  total, cnt = _local_segment_sums(msgs, targets, mask, num_segments)
  if reduce:
    dist.all_reduce(total, group=pg)
    dist.all_reduce(cnt, group=pg)
  return total / cnt.clamp(min=1.0)[:, None]


def sharded_segment_mean_scattered(
    msgs: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
    num_segments: int, group: Union[Mesh, 'dist.ProcessGroup', None] = None
) -> torch.Tensor:
  """:func:`sharded_segment_mean` whose result stays sharded: rank ``i``
  gets only its block of segments ``[i * S / P, (i + 1) * S / P)``, the
  sums and counts reduced and scattered in one ``reduce_scatter`` each, so
  a rank holds and receives ``1 / P`` of the output.

  Raises ValueError unless ``num_segments`` divides by the group size.
  Returns ``[num_segments / P, D]``."""
  pg, world, reduce = _group_of(group)
  if num_segments % world:
    raise ValueError(f'num_segments ({num_segments}) must divide by the '
                     f'group size ({world}) for the scattered layout')
  total, cnt = _local_segment_sums(msgs, targets, mask, num_segments)
  if reduce:
    per = num_segments // world
    blk = torch.empty((per,) + tuple(total.shape[1:]), dtype=total.dtype,
                      device=total.device)
    dist.reduce_scatter(blk, list(total.contiguous().split(per)), group=pg)
    cblk = torch.empty(per, dtype=cnt.dtype, device=cnt.device)
    dist.reduce_scatter(cblk, list(cnt.split(per)), group=pg)
    total, cnt = blk, cblk
  return total / cnt.clamp(min=1.0)[:, None]
