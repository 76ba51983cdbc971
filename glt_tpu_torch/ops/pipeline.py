"""The multi-hop sampling pipeline (counterpart of glt_tpu/ops/pipeline.py).

The port has one engine per graph kind. Homogeneous: the walk, an exact
seed dedup, then ``cuda_kernels.sample_walk_dedup`` for every uniform
hop, then the output dict; bit-identical to the JAX package's cross-hop
walk (``GLT_HOP_ENGINE=pallas_fused``, ``GLT_FUSED_WALK=cross``) and to
its ``GLT_DEDUP=sort GLT_FUSED_HOP=1`` reference, given the same
uniforms. Heterogeneous: :func:`multihop_sample_hetero`, one
``cuda_kernels.sample_hop_dedup`` per hop for every edge type,
bit-identical to the JAX hetero ``GLT_DEDUP=sort GLT_FUSED_HOP=1``
reference. Weighted, full-neighbourhood and live-update hops:
:func:`multihop_sample_sorted`, a per-hop loop over a ``one_hop``
callable with the ``sorted_hop_dedup_fused`` inducer, bit-identical to
the JAX ``GLT_DEDUP=sort GLT_FUSED_HOP=1`` hop loop.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from . import cuda_kernels
from .sample import (FusedHopPlan, HeteroFusedPlan, NeighborOutput,
                     _row_spans, draw_offsets, walk_hop_uniforms)
from .unique import (BIG, sorted_hop_dedup, sorted_hop_dedup_fused,
                     sorted_nodes_by_label)

#: ``one_hop(h, frontier_ids, frontier_mask, u) -> NeighborOutput`` of
#: width ``widths[h]``
OneHopFn = Callable[[int, torch.Tensor, torch.Tensor,
                     Optional[torch.Tensor]], NeighborOutput]


def sample_budget(batch_size: int, fanouts: Sequence[int]) -> int:
  budget, width = batch_size, batch_size
  for k in fanouts:
    width *= abs(k)
    budget += width
  return budget


def edge_hop_offsets(batch_size: int, fanouts: Sequence[int]) -> List[int]:
  offs, cap = [0], batch_size
  for k in fanouts:
    cap *= abs(k)
    offs.append(offs[-1] + cap)
  return offs


def multihop_sample(plan: FusedHopPlan, seeds: torch.Tensor, n_valid: int,
                    fanouts: Sequence[int],
                    generator: Optional[torch.Generator] = None,
                    u_hops=None, with_edge: bool = False
                    ) -> Dict[str, torch.Tensor]:
  """Runs the whole walk; returns the output dict of the JAX
  ``multihop_sample`` (``node``, ``node_count``, ``row`` (child labels),
  ``col`` (parent labels), ``edge_mask``, ``batch``, ``seed_labels``,
  ``seed_count``, ``num_sampled_nodes``, ``num_sampled_edges`` and, with
  ``with_edge``, ``edge``).

  ``u_hops`` injects the per-hop uniforms (tests pass the JAX draws);
  without it they are drawn from ``generator`` on the plan's device.
  Seeds past ``n_valid`` are padding."""
  if with_edge and plan.edge_ids is None:
    raise ValueError('with_edge needs the plan\'s edge_ids')
  batch_size = seeds.numel()
  if u_hops is None:
    u_hops = walk_hop_uniforms(generator, batch_size, fanouts,
                               plan.replace, plan.indices.device)
  budget = sample_budget(batch_size, fanouts)
  d, seed_labels = _fused_seed_hop(seeds, n_valid)
  seed_count = d['count2']
  stab_ids = torch.where(d['new_head3'], d['ids3'],
                         torch.full_like(d['ids3'], -1))
  hops = cuda_kernels.sample_walk_dedup(
      plan.indptr_pad, plan.indices, d['ids3'], d['new_head3'], stab_ids,
      d['labels3'], seed_count, u_hops, fanouts=tuple(fanouts),
      replace=plan.replace, table_slots=plan.table_slots,
      with_slots=with_edge)

  u_ids, u_labs, count = d['u_ids2'], d['u_labs2'], seed_count
  frontier_labels = d['labels3']
  rows_parent, cols_child, emasks, eid_list = [], [], [], []
  hop_node_counts = [seed_count]
  hop_edge_counts = []
  for hop, k in zip(hops, fanouts):
    ids_flat = hop['picks'].reshape(-1)
    mask_flat = hop['mask'].reshape(-1)
    nh, labels, new_count = hop['new_head'], hop['labels'], hop['new_count']
    rows_parent.append(torch.repeat_interleave(frontier_labels, k))
    cols_child.append(labels)
    emasks.append(mask_flat)
    if with_edge:
      slots = hop['slots'].reshape(-1).long()
      eid_list.append(plan.edge_ids[slots.clamp(min=0)])
    big = torch.full_like(ids_flat, BIG)
    u_ids = torch.cat([u_ids, torch.where(nh, ids_flat, big)])
    u_labs = torch.cat([u_labs, torch.where(nh, labels, big)])
    hop_node_counts.append(new_count)
    hop_edge_counts.append(mask_flat.sum(dtype=torch.int32))
    frontier_labels = labels
    count = count + new_count

  out = _output_dict(sorted_nodes_by_label(u_ids, u_labs, count, budget),
                     count, cols_child, rows_parent, emasks, batch_size,
                     seed_labels, seed_count, hop_node_counts,
                     hop_edge_counts)
  if with_edge:
    out['edge'] = torch.cat(eid_list)
  return out


def multihop_sample_many(plan: FusedHopPlan, seeds_stack: torch.Tensor,
                         n_valid_stack, fanouts: Sequence[int],
                         generator: Optional[torch.Generator] = None,
                         u_stack=None, with_edge: bool = False
                         ) -> Dict[str, torch.Tensor]:
  """T walks, one per row of ``seeds_stack [T, B]`` (``n_valid_stack
  [T]`` ints or a tensor), their outputs stacked on a leading ``[T]``
  axis (counterpart of glt_tpu/ops/pipeline.py:1275, which scans T
  batches in one dispatch): each is one :func:`multihop_sample`, one
  walk launch, so the result equals T such calls. ``u_stack`` injects
  the uniforms (per hop ``[T, S_h, K_h]``); without it each walk draws
  its own from ``generator`` in turn, as T calls would."""
  outs = []
  for t in range(seeds_stack.shape[0]):
    u = None if u_stack is None else [u[t] for u in u_stack]
    outs.append(multihop_sample(plan, seeds_stack[t], n_valid_stack[t],
                                fanouts, generator, u_hops=u,
                                with_edge=with_edge))
  return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def multihop_sample_sorted(one_hop: OneHopFn, seeds: torch.Tensor,
                           n_valid: int, fanouts: Sequence[int],
                           u_hops: Sequence[Optional[torch.Tensor]]
                           ) -> Dict[str, torch.Tensor]:
  """The per-hop loop (counterpart of the fused branch of
  glt_tpu/ops/pipeline.py ``_multihop_sample_sorted``): the exact seed
  hop, then per hop ``one_hop(h, frontier_ids, frontier_mask, u_hops[h])``
  of width ``abs(fanouts[h])`` (a negative fanout is a full-neighbourhood
  window) and :func:`sorted_hop_dedup_fused`, whose new heads (each new
  id's minimum slot, non-heads INT32_MAX) are the next frontier. Returns
  the output dict of :func:`multihop_sample` without ``edge``."""
  batch_size = seeds.numel()
  widths = [abs(int(f)) for f in fanouts]
  budget = sample_budget(batch_size, widths)
  d, seed_labels = _fused_seed_hop(seeds, n_valid)
  u_ids, u_labs, count = d['u_ids2'], d['u_labs2'], d['count2']
  seed_count = count
  frontier_ids, frontier_labels = d['ids3'], d['labels3']
  frontier_mask = d['new_head3']
  rows_parent, cols_child, emasks = [], [], []
  hop_node_counts, hop_edge_counts = [seed_count], []
  for h, width in enumerate(widths):
    hop = one_hop(h, frontier_ids, frontier_mask, u_hops[h])
    ids_flat = hop.nbrs.reshape(-1)
    mask_flat = hop.mask.reshape(-1)
    d = sorted_hop_dedup_fused(u_ids, u_labs, count, ids_flat, mask_flat)
    rows_parent.append(torch.repeat_interleave(frontier_labels, width))
    cols_child.append(d['labels3'])
    emasks.append(mask_flat)
    frontier_ids = torch.where(d['new_head3'], ids_flat.to(torch.int32),
                               torch.full_like(ids_flat, BIG,
                                               dtype=torch.int32))
    u_ids, u_labs, count = d['u_ids2'], d['u_labs2'], d['count2']
    hop_node_counts.append(d['new_count'])
    hop_edge_counts.append(mask_flat.sum(dtype=torch.int32))
    frontier_labels, frontier_mask = d['labels3'], d['new_head3']
  return _output_dict(sorted_nodes_by_label(u_ids, u_labs, count, budget),
                      count, cols_child, rows_parent, emasks, batch_size,
                      seed_labels, seed_count, hop_node_counts,
                      hop_edge_counts)


def _output_dict(nodes, count, cols_child, rows_parent, emasks, batch_size,
                 seed_labels, seed_count, hop_node_counts, hop_edge_counts):
  """The homogeneous output surface shared by the walk and the per-hop
  loop: ``row`` child labels, ``col`` parent labels."""
  return dict(
      node=nodes,
      node_count=count,
      row=torch.cat(cols_child),
      col=torch.cat(rows_parent),
      edge_mask=torch.cat(emasks),
      batch=nodes[:batch_size],
      seed_labels=seed_labels,
      seed_count=seed_count,
      num_sampled_nodes=torch.stack(hop_node_counts),
      num_sampled_edges=torch.stack(hop_edge_counts),
  )


def hetero_edge_hop_offsets(caps, trav, num_neighbors, num_hops):
  """Per traversal edge type, hop h's slots in its concatenated edge
  buffers are ``[offs[h], offs[h+1])`` (hierarchical per-layer trimming;
  counterpart of glt_tpu/ops/pipeline.py :747)."""
  offs = {e: [0] for e in trav}
  for h in range(num_hops):
    for e, (row_t, _) in trav.items():
      k = num_neighbors[e][h]
      w = caps[h][row_t] * abs(k) if (caps[h][row_t] and k) else 0
      offs[e].append(offs[e][-1] + w)
  return offs


def _empty_frontier(c0: int, dev):
  """Placeholder frontier of a type with no live rows (zero ids, -1
  labels, all-False mask), the reference's."""
  return (torch.zeros(c0, dtype=torch.int32, device=dev),
          torch.full((c0,), -1, dtype=torch.int32, device=dev),
          torch.zeros(c0, dtype=torch.bool, device=dev))


def multihop_sample_hetero(plan: HeteroFusedPlan, table_slots: int,
                           num_neighbors, num_hops, caps, budgets,
                           seeds: Dict[str, torch.Tensor],
                           n_valid: Dict[str, int], u_hops,
                           with_edge: bool = False):
  """The hetero walk from ``seeds`` (per seed type its ids; ``n_valid``
  per seed type its real ones, the rest padding): an exact seed hop a
  seed type, then one ``cuda_kernels.sample_hop_dedup`` for every edge
  type of a hop (counterpart of glt_tpu/ops/pipeline.py
  ``_multihop_sample_hetero_fused``, bit-identical to its per-edge-type
  sorted reference ``GLT_DEDUP=sort GLT_FUSED_HOP=1`` given the same
  uniforms). A link batch seeds both endpoint types at once.

  The seed uniques of every type go into one dedup table under their
  types' tag bases: ``cuda_kernels.dedup_table_init`` for one seed type,
  ``dedup_table_init_types`` for several, one launch either way. Each
  type's seeds are labelled ``0..`` in its own label space (JAX labels
  them in one provisional space and remaps before they leave its
  function).

  Per hop the segments (traversal edge types with live frontier rows and
  a non-zero fanout, in traversal order) draw their offsets from
  ``u_hops[h][i]`` (:func:`hetero_hop_uniforms` shapes), are rebased into
  the flat edge plane and padded to the hop's widest fanout behind
  invalid lanes; an edge type with no edges rides along as all-invalid
  rows. The kernel labels each type's new ids ``count_t..`` in value
  order; type t's next frontier is every lane of this hop's type-t picks,
  non-heads carrying INT32_MAX.

  ``table_slots`` sizes the dedup table (a power of two >= 2x the
  walk's node budget across types).

  Returns the result dict of the reference: per type ``node``,
  ``node_count``, ``num_sampled_nodes``, per seed type ``batch`` and
  ``seed_labels``, per traversal edge type ``row`` (parent labels),
  ``col`` (child labels), ``edge_mask``, ``num_sampled_edges`` and, with
  ``with_edge``, ``edge``.
  """
  if with_edge and plan.eids_flat is None:
    raise ValueError('with_edge needs the plan\'s edge-id plane')
  dev = plan.indices_flat.device
  types = plan.types
  unknown = set(seeds) - set(types)
  if unknown:
    raise ValueError(f'seed types {sorted(unknown)} are no node types of '
                     'the graph')
  zero = torch.zeros((), dtype=torch.int32, device=dev)
  frontier, u_ids, u_labs, count, seed_labels = {}, {}, {}, {}, {}
  inserts = []
  for t in types:
    u_ids[t], u_labs[t], count[t] = [], [], zero
    if t not in seeds:
      frontier[t] = _empty_frontier(max(1, caps[0][t]), dev)
      continue
    d, seed_labels[t] = _fused_seed_hop(seeds[t], n_valid[t])
    u_ids[t].append(d['u_ids2'])
    u_labs[t].append(d['u_labs2'])
    count[t] = d['count2']
    frontier[t] = (d['ids3'], d['labels3'], d['new_head3'])
    inserts.append((d['ids3'], d['labels3'], d['new_head3'],
                    plan.type_base[t]))
  if len(inserts) == 1:
    keys, vals, first = cuda_kernels.dedup_table_init(table_slots,
                                                      *inserts[0], dev)
  else:
    keys, vals, first = cuda_kernels.dedup_table_init_types(table_slots,
                                                            inserts, dev)
  counts = torch.stack([count[t] for t in types]).to(torch.int32)
  hop_nodes = {t: [count[t]] for t in types}
  rows_d, cols_d, mask_d, eid_d, hop_edges = {}, {}, {}, {}, {}
  for h in range(num_hops):
    segs = []
    for e, (row_t, col_t) in plan.trav.items():
      k = num_neighbors[e][h]
      if caps[h][row_t] == 0 or k == 0:
        continue
      f_ids, f_labels, f_mask = frontier[row_t]
      u = u_hops[h][len(segs)]
      sg = dict(e=e, col_t=col_t, k=k, s=f_ids.numel(), f_labels=f_labels)
      if plan.num_edges[e] == 0:
        sg.update(start=torch.zeros(sg['s'], dtype=torch.int32, device=dev),
                  off=torch.zeros((sg['s'], k), dtype=torch.int32,
                                  device=dev),
                  mask=torch.zeros((sg['s'], k), dtype=torch.bool,
                                   device=dev))
      else:
        start, deg = _row_spans(plan.indptr_pad[e], f_ids, f_mask)
        off, mask = draw_offsets(deg, u.to(dev), k, plan.replace)
        sg.update(start=start + plan.edge_base[e], off=off, mask=mask)
      segs.append(sg)
    if segs:
      k_max = max(sg['k'] for sg in segs)
      pad = lambda x, k: torch.nn.functional.pad(x, (0, k_max - k))
      hop = cuda_kernels.sample_hop_dedup(
          plan.indices_flat, plan.eids_flat if with_edge else None,
          torch.cat([sg['start'] for sg in segs]),
          torch.cat([pad(sg['off'], sg['k']) for sg in segs]),
          torch.cat([pad(sg['mask'], sg['k']) for sg in segs]),
          keys, vals, first, plan.type_bounds, counts,
          num_ids=plan.num_ids)
      picks, labels = hop['picks'], hop['labels'].view(-1, k_max)
      new_head = hop['new_head'].view(-1, k_max)
      r0 = 0
      for sg in segs:
        rows = slice(r0, r0 + sg['s'])
        k = sg['k']
        sg['picks'] = picks[rows, :k].reshape(-1)
        sg['labels'] = labels[rows, :k].reshape(-1)
        sg['nh'] = new_head[rows, :k].reshape(-1)
        if with_edge:
          sg['eid'] = hop['eid_picks'][rows, :k].reshape(-1)
        r0 += sg['s']
      counts = hop['counts']
    for t in types:
      tsegs = [sg for sg in segs if sg['col_t'] == t]
      if not tsegs:
        frontier[t] = _empty_frontier(max(1, caps[h + 1][t]), dev)
        hop_nodes[t].append(zero)
        continue
      nh = torch.cat([sg['nh'] for sg in tsegs])
      labels_t = torch.cat([sg['labels'] for sg in tsegs])
      local = torch.where(nh, torch.cat([sg['picks'] for sg in tsegs])
                          - plan.type_base[t],
                          torch.full_like(labels_t, BIG))
      frontier[t] = (local, labels_t, nh)
      u_ids[t].append(local)
      u_labs[t].append(torch.where(nh, labels_t,
                                   torch.full_like(labels_t, BIG)))
      hop_nodes[t].append(nh.sum(dtype=torch.int32))
    for sg in segs:
      e = sg['e']
      mask = sg['mask'].reshape(-1)
      rows_d.setdefault(e, []).append(
          torch.repeat_interleave(sg['f_labels'], sg['k']))
      cols_d.setdefault(e, []).append(sg['labels'])
      mask_d.setdefault(e, []).append(mask)
      if with_edge:
        eid_d.setdefault(e, []).append(sg['eid'])
      hop_edges.setdefault(e, []).append(mask.sum(dtype=torch.int32))

  node_count = {t: counts[i] for i, t in enumerate(types)}
  nodes = {t: sorted_nodes_by_label(torch.cat(u_ids[t]),
                                    torch.cat(u_labs[t]), node_count[t],
                                    budgets[t])
           if u_ids[t] else torch.full((budgets[t],), -1, dtype=torch.int32,
                                       device=dev)
           for t in types}
  out = dict(
      node=nodes, node_count=node_count,
      row={e: torch.cat(v) for e, v in rows_d.items()},
      col={e: torch.cat(v) for e, v in cols_d.items()},
      edge_mask={e: torch.cat(v) for e, v in mask_d.items()},
      batch={t: nodes[t][:s.numel()] for t, s in seeds.items()},
      seed_labels=seed_labels,
      num_sampled_nodes={t: torch.stack(v) for t, v in hop_nodes.items()},
      num_sampled_edges={e: torch.stack(v) for e, v in hop_edges.items()})
  if with_edge:
    out['edge'] = {e: torch.cat(v) for e, v in eid_d.items()}
  return out


def multihop_sample_hetero_sorted(one_hops, trav, num_neighbors, num_hops,
                                  caps, budgets, seeds, n_valid, u_hops):
  """The hetero per-hop loop over given one-hops (counterpart of the
  ``fused_hops()`` branch of glt_tpu/ops/pipeline.py
  ``_multihop_sample_hetero_sorted``: ``GLT_DEDUP=sort GLT_FUSED_HOP=1``),
  the loop of the partitioned sampler, whose one-hops exchange their
  requests with the rows' owners.

  Args:
    one_hops: per traversal edge type ``one_hop(ids [F], fanout, u, mask
      [F]) -> NeighborOutput`` ([F, fanout]).
    trav: per traversal edge type ``(row_type, col_type)``; the order of
      the loop over edge types.
    num_neighbors: per edge type the fanout of each hop.
    caps / budgets: per hop and node type the frontier capacity, per node
      type the node budget (``DistHeteroNeighborSampler._caps``).
    seeds / n_valid: per seed type ``[B]`` ids and the valid count.
    u_hops: ``u_hops[h][i]`` the uniforms of hop h's i-th segment (the
      edge types of ``trav`` whose row type has a frontier and whose
      fanout is not 0, in order), in the shape its one-hop takes.

  Seed types take the exact seed hop; every hop then dedups each node
  type's picks with :func:`sorted_hop_dedup_fused` (new ids labelled in
  value order, heads at their minimum slot, the next frontier every pick
  with non-heads INT32_MAX). Every shape is fixed by ``caps``, so a CUDA
  graph can hold the loop when the one-hops' can be held.

  Returns the reference's dict: per type ``node``, ``node_count``,
  ``num_sampled_nodes``, ``batch`` and ``seed_labels`` (the seed types),
  per traversal edge type ``row`` (parent labels), ``col`` (child labels,
  -1 where masked), ``edge_mask`` and ``num_sampled_edges``.
  """
  dev = next(iter(seeds.values())).device
  zero = torch.zeros((), dtype=torch.int32, device=dev)
  empty = torch.zeros(0, dtype=torch.int32, device=dev)
  seen, frontier, seed_labels = {}, {}, {}
  for t in budgets:
    if t in seeds:
      d, seed_labels[t] = _fused_seed_hop(seeds[t], n_valid[t])
      seen[t] = (d['u_ids2'], d['u_labs2'], d['count2'])
      frontier[t] = (d['ids3'], d['labels3'], d['new_head3'])
    else:
      seen[t] = (empty, empty, zero)
      frontier[t] = _empty_frontier(max(1, caps[0][t]), dev)
  rows_d, cols_d, mask_d = {}, {}, {}
  hop_nodes = {t: [seen[t][2]] for t in budgets}
  hop_edges = {}
  for h in range(num_hops):
    per_type = {t: [] for t in budgets}
    per_meta = []
    for e, (row_t, col_t) in trav.items():
      k = num_neighbors[e][h]
      if caps[h][row_t] == 0 or k == 0:
        continue
      f_ids, f_labels, f_mask = frontier[row_t]
      out = one_hops[e](f_ids, k, u_hops[h][len(per_meta)], f_mask)
      mflat = out.mask.reshape(-1)
      per_type[col_t].append((out.nbrs.reshape(-1), mflat))
      per_meta.append((e, col_t, torch.repeat_interleave(f_labels, k),
                       mflat, caps[h][row_t] * k))
    labels_by_type = {}
    for t, chunks in per_type.items():
      if not chunks:
        frontier[t] = _empty_frontier(max(1, caps[h + 1][t]), dev)
        hop_nodes[t].append(zero)
        continue
      ids = torch.cat([c[0] for c in chunks])
      ok = torch.cat([c[1] for c in chunks])
      d = sorted_hop_dedup_fused(*seen[t], ids, ok)
      labels_by_type[t] = d['labels3']
      frontier[t] = (torch.where(d['new_head3'], ids.to(torch.int32),
                                 torch.full_like(ids, BIG,
                                                 dtype=torch.int32)),
                     d['labels3'], d['new_head3'])
      seen[t] = (d['u_ids2'], d['u_labs2'], d['count2'])
      hop_nodes[t].append(d['new_count'])
    cursor = {t: 0 for t in budgets}
    for e, col_t, rows_parent, mask, width in per_meta:
      s = cursor[col_t]
      cursor[col_t] += width
      lab = labels_by_type[col_t][s:s + width]
      rows_d.setdefault(e, []).append(rows_parent)
      cols_d.setdefault(e, []).append(
          torch.where(mask, lab, torch.full_like(lab, -1)))
      mask_d.setdefault(e, []).append(mask)
      hop_edges.setdefault(e, []).append(mask.sum(dtype=torch.int32))
  nodes = {t: sorted_nodes_by_label(*seen[t], budgets[t]) for t in budgets}
  return dict(
      node=nodes, node_count={t: seen[t][2] for t in budgets},
      row={e: torch.cat(v) for e, v in rows_d.items()},
      col={e: torch.cat(v) for e, v in cols_d.items()},
      edge_mask={e: torch.cat(v) for e, v in mask_d.items()},
      batch={t: nodes[t][:s.numel()] for t, s in seeds.items()},
      seed_labels=seed_labels,
      num_sampled_nodes={t: torch.stack(v) for t, v in hop_nodes.items()},
      num_sampled_edges={e: torch.stack(v) for e, v in hop_edges.items()})


def multihop_sample_hetero_many(one_hops, trav, num_neighbors, num_hops,
                                caps, budgets, seeds_stack, n_valid_stack,
                                u_stack):
  """T batches of :func:`multihop_sample_hetero_sorted` (counterpart of
  glt_tpu/ops/pipeline.py:1247, which scans them in one dispatch):
  ``seeds_stack``/``n_valid_stack`` per seed type ``[T, B]``/``[T]``,
  ``u_stack[h][i]`` ``[T, ...]``; the outputs stacked on a leading
  ``[T]`` axis, equal to T calls."""
  outs = []
  for t in range(next(iter(seeds_stack.values())).shape[0]):
    outs.append(multihop_sample_hetero_sorted(
        one_hops, trav, num_neighbors, num_hops, caps, budgets,
        {k: v[t] for k, v in seeds_stack.items()},
        {k: v[t] for k, v in n_valid_stack.items()},
        [[u[t] for u in hop] for hop in u_stack]))
  return {k: {kk: torch.stack([o[k][kk] for o in outs]) for kk in outs[0][k]}
          for k in outs[0]}


def _fused_seed_hop(seeds: torch.Tensor, n_valid: int):
  """The exact seed hop: ``(d, seed_labels)`` with ``d`` the raw
  :func:`sorted_hop_dedup` dict (``batch``/``seed_labels`` bit-identical
  to every JAX engine)."""
  dev = seeds.device
  seed_mask = torch.arange(seeds.numel(), device=dev) < n_valid
  zero = torch.zeros(0, dtype=torch.int32, device=dev)
  d = sorted_hop_dedup(zero, zero, 0, seeds, seed_mask)
  seed_labels = torch.empty_like(d['labels3'])
  seed_labels[d['pos3']] = d['labels3']
  seed_labels = torch.where(seed_mask, seed_labels,
                            torch.full_like(seed_labels, -1))
  return d, seed_labels
