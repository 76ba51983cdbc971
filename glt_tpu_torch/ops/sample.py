"""Neighbour draws and one-hop reads (counterpart of
glt_tpu/ops/sample.py).

The walk's offsets are a pure function of (degree, uniforms): Floyd's
algorithm without replacement, or ``min(int(u * deg), deg - 1)`` with
replacement, in float32 with truncation toward zero -- the arithmetic of
the TPU draw, so injected ``jax.random`` uniforms reproduce its picks bit
for bit. The CUDA walk computes the same formula per thread; the helpers
here are the plain version's and the tests'.

:func:`sample_neighbors`, :func:`sample_neighbors_weighted` and
:func:`sample_full_neighbors` are the one-hop reads of the per-hop loop
(``ops.pipeline.multihop_sample_sorted``): the uniform hop draws here and
reads its neighbours through the ``sample_hop`` kernel; the weighted and
the full-neighbourhood hops read their ``[S, max_degree]`` windows through
the ``gather_windows`` kernel, as the JAX package reads them under
``GLT_USE_PALLAS=1``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import cuda_kernels


def walk_geometry(batch_size: int,
                  fanouts: Sequence[int]) -> List[Tuple[int, int]]:
  """``[(S_h, K_h)]`` per hop: hop h's frontier rows and fanout. Hop
  h+1's frontier is every slot of hop h, heads or not (non-heads carry
  INT32_MAX), so ``S_{h+1} = S_h * K_h``."""
  hops, s = [], max(int(batch_size), 1)
  for k in fanouts:
    k = int(k)
    if k <= 0:
      raise ValueError(f'the walk serves positive fanouts, got {k}')
    hops.append((s, k))
    s *= k
  return hops


def _floyd_offsets(deg: torch.Tensor, u: torch.Tensor,
                   fanout: int) -> torch.Tensor:
  """Floyd's uniform sampling of ``fanout`` distinct offsets from
  ``[0, deg)``; valid only where ``deg >= fanout``. ``u``: [S, fanout]."""
  cols: List[torch.Tensor] = []
  for j in range(fanout):
    bound = torch.clamp(deg - fanout + j, min=0)
    t = torch.minimum((u[:, j] * (bound + 1).to(u.dtype)).to(torch.int32),
                      bound)
    if cols:
      dup = (torch.stack(cols, 1) == t[:, None]).any(1)
      t = torch.where(dup, bound, t)
    cols.append(t)
  return torch.stack(cols, 1)


def _row_spans(indptr: torch.Tensor, ids: torch.Tensor,
               mask: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Row start and masked degree per frontier id. Ids clip into ``[0,
  len(indptr) - 1]`` as ``jnp.take(mode='clip')`` clips them, so an
  invalid id (INT32_MAX) starts at the last entry and reads degree 0:
  ``indptr[N]`` of an [N + 1] CSR pointer, the trailing ``num_edges``
  sentinel of an [N + 2] ``indptr_pad``."""
  n = indptr.numel() - 1
  ids = ids.long()
  start = indptr[ids.clamp(0, n)]
  deg = (indptr[(ids + 1).clamp(0, n)] - start).to(torch.int32)
  if mask is not None:
    deg = torch.where(mask, deg, torch.zeros_like(deg))
  return start.to(torch.int32), deg


def hop_valid_mask(deg: torch.Tensor, fanout: int,
                   replace: bool) -> torch.Tensor:
  """[S, K] lanes the draw marks valid, from the masked degrees alone."""
  if replace:
    return (deg[:, None] > 0).expand(deg.numel(), fanout)
  iota = torch.arange(fanout, device=deg.device)[None, :]
  return iota < torch.clamp(deg, max=fanout)[:, None]


def draw_offsets(deg: torch.Tensor, u: torch.Tensor, fanout: int,
                 replace: bool) -> Tuple[torch.Tensor, torch.Tensor]:
  """The uniform hop draw: ``(offsets [S, K] int32, mask [S, K])``."""
  if replace:
    off = torch.minimum((u * deg[:, None].to(u.dtype)).to(torch.int32),
                        torch.clamp(deg - 1, min=0)[:, None])
  else:
    iota = torch.arange(fanout, dtype=torch.int32,
                        device=deg.device)[None, :].expand(deg.numel(),
                                                           fanout)
    off = torch.where((deg <= fanout)[:, None], iota,
                      _floyd_offsets(deg, u, fanout))
  return off, hop_valid_mask(deg, fanout, replace)


class NeighborOutput(NamedTuple):
  """One-hop result in padded layout, [S, K] each: neighbour ids
  (undefined where ``~mask``), validity and, when the caller asked for
  them, the picked edges' ids (None otherwise)."""
  nbrs: torch.Tensor
  mask: torch.Tensor
  eids: Optional[torch.Tensor] = None

  @property
  def nbrs_num(self) -> torch.Tensor:
    """Valid neighbours a seed, ``[S]``."""
    return self.mask.sum(dim=-1)


def _empty_output(s: int, width: int, device,
                  with_eids: bool = False) -> NeighborOutput:
  """All-masked output of a graph with no edges (edge ids -1)."""
  return NeighborOutput(
      nbrs=torch.zeros((s, width), dtype=torch.int32, device=device),
      mask=torch.zeros((s, width), dtype=torch.bool, device=device),
      eids=(torch.full((s, width), -1, dtype=torch.int32, device=device)
            if with_eids else None))


def sample_neighbors(indptr: torch.Tensor, indices: torch.Tensor,
                     seeds: torch.Tensor, fanout: int, u: torch.Tensor,
                     seed_mask: Optional[torch.Tensor] = None,
                     edge_ids: Optional[torch.Tensor] = None,
                     replace: bool = False) -> NeighborOutput:
  """Uniformly sample up to ``fanout`` distinct neighbours per seed of a
  CSR: the draw of ``glt_tpu.ops.sample._draw_hop`` without replacement
  on the injected uniforms ``u`` ([S, fanout]: drawn ``(fanout, S)`` and
  transposed), then one ``sample_hop`` launch reads ``indices`` at the
  drawn slots. With ``replace`` each lane draws its own offset from
  ``u`` ([S, fanout] drawn as it is), every lane of a seed with a
  neighbour valid. Bit-identical on valid lanes to the JAX element, window
  and ``pallas`` engines; a seed of degree <= fanout is taken whole, in
  adjacency order. ``indices`` may be padded past the live edges (a
  snapshot's capacity): slots clip to its length, as ``_slots_i32`` clips
  them. ``edge_ids`` (int32, aligned with ``indices``) are read through
  the same slots into ``eids``."""
  if fanout <= 0:
    raise ValueError(f'fanout must be a positive int, got {fanout}')
  if indices.numel() == 0:
    return _empty_output(seeds.numel(), fanout, seeds.device)
  start, deg = _row_spans(indptr, seeds, seed_mask)
  offsets, mask = draw_offsets(deg, u, fanout, replace=replace)
  nbrs, eids = cuda_kernels.sample_hop(indices, edge_ids, start, offsets)
  return NeighborOutput(nbrs=nbrs, mask=mask, eids=eids)


def _masked_eids(eids: Optional[torch.Tensor],
                 mask: torch.Tensor) -> Optional[torch.Tensor]:
  """Edge ids with -1 on the masked lanes (None stays None)."""
  if eids is None:
    return None
  return torch.where(mask, eids, torch.full_like(eids, -1))


def sample_full_neighbors(indptr: torch.Tensor, indices: torch.Tensor,
                          seeds: torch.Tensor, max_degree: int,
                          seed_mask: Optional[torch.Tensor] = None,
                          edge_ids: Optional[torch.Tensor] = None
                          ) -> NeighborOutput:
  """Every neighbour of each seed, in adjacency order, inside a static
  ``[S, max_degree]`` window (degrees above it truncate): the JAX
  ``sample_full_neighbors`` with its ``window_gather``, one
  ``gather_windows`` launch over ``indices``. Lanes past a row's degree
  are masked; they read what the kernel's clip gives them. ``edge_ids``
  (int32, aligned with ``indices``) are read by a second launch over the
  same windows into ``eids``, -1 on the masked lanes."""
  if max_degree <= 0:
    raise ValueError(f'max_degree must be positive, got {max_degree}')
  if indices.numel() == 0:
    return _empty_output(seeds.numel(), max_degree, seeds.device,
                         edge_ids is not None)
  start, deg = _row_spans(indptr, seeds, seed_mask)
  win = torch.arange(max_degree, dtype=torch.int32,
                     device=seeds.device)[None, :]
  mask = win < deg.clamp(max=max_degree)[:, None]
  nbrs = cuda_kernels.gather_windows(indices, start, max_degree)
  eids = (None if edge_ids is None else
          cuda_kernels.gather_windows(edge_ids, start, max_degree))
  return NeighborOutput(nbrs=nbrs.to(torch.int32), mask=mask,
                        eids=_masked_eids(eids, mask))


def sample_neighbors_weighted(indptr: torch.Tensor, indices: torch.Tensor,
                              weights: torch.Tensor, seeds: torch.Tensor,
                              fanout: int, u: torch.Tensor, max_degree: int,
                              seed_mask: Optional[torch.Tensor] = None,
                              edge_ids: Optional[torch.Tensor] = None
                              ) -> NeighborOutput:
  """Weight-proportional sampling of up to ``fanout`` distinct neighbours
  per seed by Gumbel-top-k (the JAX ``sample_neighbors_weighted``): one
  ``gather_windows`` launch reads each seed's ``[max_degree]`` weight
  window, lanes past the degree or of weight <= 0 get key -inf, the
  others ``log(w) - log(-log(u))``, the top ``fanout`` keys are the
  picks, and one ``sample_hop`` launch reads their neighbour ids. A hub
  row draws among its first ``max_degree`` neighbours only.

  ``u``: [S, max_degree] float32 in (0, 1) (:func:`weighted_hop_uniforms`
  shapes them as the JAX draw does). The mask comes from the keys, as
  ``top_valid`` does: a seed with fewer positive-weight neighbours than
  ``fanout`` takes them all, and its other lanes are invalid. ``edge_ids``
  (int32, aligned with ``indices``) are read by the same ``sample_hop``
  launch into ``eids``, -1 on the invalid lanes (which ``topk`` fills
  in an order of its own)."""
  if not 0 < fanout <= max_degree:
    raise ValueError(f'fanout {fanout} must be in [1, max_degree = '
                     f'{max_degree}]')
  if indices.numel() == 0:
    return _empty_output(seeds.numel(), fanout, seeds.device,
                         edge_ids is not None)
  start, deg = _row_spans(indptr, seeds, seed_mask)
  win = torch.arange(max_degree, dtype=torch.int32,
                     device=seeds.device)[None, :]
  valid = win < deg.clamp(max=max_degree)[:, None]
  w = cuda_kernels.gather_windows(weights, start, max_degree).float()
  w = torch.where(valid & (w > 0), w, torch.zeros_like(w))
  g = -torch.log(-torch.log(u))
  keys = torch.where(w > 0, torch.log(w) + g,
                     torch.full_like(w, -float('inf')))
  top_keys, top = torch.topk(keys, fanout, dim=1)
  nbrs, eids = cuda_kernels.sample_hop(indices, edge_ids, start,
                                       top.to(torch.int32))
  mask = top_keys > -float('inf')
  return NeighborOutput(nbrs=nbrs, mask=mask, eids=_masked_eids(eids, mask))


def neighbor_probs(indptr: torch.Tensor, indices: torch.Tensor,
                   seed_probs: torch.Tensor, fanout: int,
                   num_nodes: int) -> torch.Tensor:
  """One hop of access probability (glt_tpu/ops/sample.py:713, the
  reference's ``CalNbrProbKernel``): each edge ``u -> v`` of the CSR adds
  ``p(u) * min(fanout / deg(u), 1)`` to ``v`` (rate 1 for a negative,
  full-neighbourhood fanout), and the sums clip to 1. ``seed_probs``
  [R] float32 over the pointer axis; returns ``[num_nodes]`` float32 on
  its device. A row search finds each edge's row, a ``take`` its rate and
  an ``index_add_`` sums them; slots at or past ``indptr[-1]`` (a padded
  tail) add nothing, and negative ids add to id 0 as the JAX clip sends
  them."""
  indptr = indptr.long()
  deg = (indptr[1:] - indptr[:-1]).float()
  if fanout < 0:
    rate = (deg > 0).float()
  else:
    rate = torch.where(deg > 0,
                       torch.clamp(fanout / deg.clamp(min=1.0), max=1.0),
                       torch.zeros_like(deg))
  per_src = seed_probs.float() * rate
  pos = torch.arange(indices.numel(), device=indices.device)
  rows = torch.searchsorted(indptr, pos, right=True) - 1
  contrib = per_src.take(rows.clamp(0, max(per_src.numel() - 1, 0)))
  contrib = torch.where(pos < indptr[-1], contrib, torch.zeros_like(contrib))
  out = torch.zeros(num_nodes, dtype=torch.float32, device=indices.device)
  out.index_add_(0, indices.long().clamp(min=0), contrib)
  return out.clamp_(max=1.0)


def weighted_hop_uniforms(generator: Optional[torch.Generator], s: int,
                          max_degree: int, device) -> torch.Tensor:
  """One weighted hop's ``[S, max_degree]`` float32 uniforms, drawn from
  ``generator`` on ``device`` and mapped as ``jax.random.uniform(key,
  (S, max_degree), minval=1e-20, maxval=1.0)`` maps its draws (``u *
  (maxval - minval) + minval``, then at least ``minval``), so the Gumbel
  noise never takes the log of 0."""
  u = torch.rand((s, max_degree), generator=generator, device=device)
  return (u * (1.0 - 1e-20) + 1e-20).clamp_(min=1e-20)


def walk_hop_uniforms(generator: Optional[torch.Generator],
                      batch_size: int, fanouts: Sequence[int],
                      replace: bool, device) -> Tuple[torch.Tensor, ...]:
  """Per-hop uniforms of a walk, drawn from ``generator`` on ``device``:
  hop h is ``[S_h, K_h]`` float32, ``u[row, j]``. Shapes and orientation
  are those of ``glt_tpu.ops.sample.walk_hop_uniforms`` without its block
  padding: the Floyd draw is made ``(K, S)`` and transposed, the
  with-replacement draw is ``(S, K)``."""
  us = []
  for s, k in walk_geometry(batch_size, fanouts):
    if replace:
      u = torch.rand((s, k), generator=generator, device=device)
    else:
      u = torch.rand((k, s), generator=generator, device=device).T
    us.append(u.contiguous())
  return tuple(us)


def hetero_hop_uniforms(generator: Optional[torch.Generator], trav,
                        num_neighbors, caps, replace: bool, device,
                        weight_windows: Optional[Dict] = None):
  """Per hop, per segment, the uniforms of a hetero walk, drawn from
  ``generator`` on ``device``. A segment is one traversal edge type
  whose frontier type has rows at that hop (``caps[h][row_t] > 0``) and
  whose fanout is non-zero, in traversal order -- exactly the segments
  that take a ``split`` of the JAX key sequence (an edge type with no
  edges still takes one). A uniform segment is ``[S, K]`` float32, ``S =
  caps[h][row_t]``: drawn ``(K, S)`` and transposed without replacement,
  ``(S, K)`` with, as the JAX draw shapes them. The per-hop loop's other
  segments: a full hop (``K < 0``) draws nothing (None), and a weighted
  one of an edge type in ``weight_windows`` ``[S, max(W, K)]``
  (:func:`weighted_hop_uniforms`, W the type's window)."""
  weight_windows = weight_windows or {}
  out = []
  for h in range(len(caps) - 1):
    hop = []
    for e, (row_t, _) in trav.items():
      k, s = int(num_neighbors[e][h]), int(caps[h][row_t])
      if s == 0 or k == 0:
        continue
      if k < 0:
        hop.append(None)
        continue
      if e in weight_windows:
        hop.append(weighted_hop_uniforms(
            generator, s, max(int(weight_windows[e]), k), device))
        continue
      if replace:
        u = torch.rand((s, k), generator=generator, device=device)
      else:
        u = torch.rand((k, s), generator=generator, device=device).T
      hop.append(u.contiguous())
    out.append(hop)
  return out


def build_type_plane(etypes, trav, node_counts, graphs, with_eids: bool):
  """The flat edge-type plane one ``sample_hop_dedup`` launch reads for
  every edge type of a hop (counterpart of
  glt_tpu/ops/pallas_kernels.py ``build_type_plane``, without the TPU's
  W-slot window pad: a thread reads ``indices_flat[start + offset]``).

  Node types share one type-tagged id space: type t's ids occupy
  ``[type_base[t], type_base[t+1])``, so one dedup table holds every
  type's seen-set and a sort of tagged ids groups them by type. Each edge
  type's indices are rebased into its dst type's range and concatenated
  in traversal order; ``edge_base[e]`` is where its block starts.

  Returns dict(types, type_base, edge_base, indices_flat, eids_flat).
  Raises ValueError when the tagged ids or the flat edges pass int32
  (the kernel addresses both with int32) or, with ``with_eids``, when an
  edge id does.
  """
  types = list(node_counts)
  type_base, base = {}, 0
  for t in types:
    type_base[t] = base
    base += int(node_counts[t])
  if base >= 2 ** 31:
    raise ValueError(f'{base} nodes across types exceed the int32 '
                     'type-tagged id space of the dedup table')
  edge_base, off, blocks, eid_blocks = {}, 0, [], []
  for e in etypes:
    g = graphs[e]
    edge_base[e] = off
    off += g.num_edges
    blocks.append((g.indices.long() + type_base[trav[e][1]]).to(torch.int32))
    if with_eids:
      if g.num_edges and int(g.edge_ids.max()) >= 2 ** 31:
        raise ValueError(f'edge ids of {e} exceed the int32 range of the '
                         'flat edge-id plane')
      eid_blocks.append(g.edge_ids.to(torch.int32))
  if off >= 2 ** 31:
    raise ValueError(f'{off} flat edge slots exceed the int32 range')
  device = graphs[etypes[0]].device if etypes else None
  empty = torch.zeros(0, dtype=torch.int32, device=device)
  return dict(
      types=types, type_base=type_base, edge_base=edge_base,
      indices_flat=torch.cat(blocks) if blocks else empty,
      eids_flat=(torch.cat(eid_blocks) if eid_blocks else empty)
      if with_eids else None)


class HeteroFusedPlan:
  """What the hetero walk reads of a graph, built once per sampler
  (counterpart of glt_tpu/ops/sample.py ``HeteroFusedPlan`` without
  windows or hub lists, and without the dedup-table size, which the
  caller passes per batch shape): the flat edge-type plane
  (:func:`build_type_plane`), each edge type's ``indptr_pad`` and edge
  count, and the draw mode."""

  def __init__(self, etypes, trav, node_counts, graphs,
               with_eids: bool = False, replace: bool = False):
    self.etypes = list(etypes)
    self.trav = dict(trav)
    self.replace = bool(replace)
    self.indptr_pad = {e: graphs[e].indptr_pad for e in self.etypes}
    self.num_edges = {e: graphs[e].num_edges for e in self.etypes}
    plane = build_type_plane(self.etypes, self.trav, node_counts, graphs,
                             with_eids)
    self.types = plane['types']
    self.type_base = plane['type_base']
    self.edge_base = plane['edge_base']
    self.indices_flat = plane['indices_flat']
    self.eids_flat = plane['eids_flat']
    total = sum(int(node_counts[t]) for t in self.types)
    #: the tagged ids' range, ``type_bounds[T]``, as a host int
    self.num_ids = total
    #: [T + 1] int32 type boundaries, the kernel's type lookup
    self.type_bounds = torch.tensor(
        [self.type_base[t] for t in self.types] + [total],
        dtype=torch.int32, device=self.indices_flat.device)


class FusedHopPlan:
  """What the walk reads of a graph, built once per sampler: the CSR with
  its ``indptr_pad`` sentinel, the optional edge-id plane, the draw mode
  and the dedup-table size for the sampler's batch shape."""

  def __init__(self, indptr_pad: torch.Tensor, indices: torch.Tensor,
               table_slots: int, edge_ids: Optional[torch.Tensor] = None,
               replace: bool = False):
    self.indptr_pad = indptr_pad
    self.indices = indices
    self.table_slots = int(table_slots)
    self.edge_ids = edge_ids
    self.replace = bool(replace)
