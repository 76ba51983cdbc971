"""The multi-hop sampling pipeline (counterpart of glt_tpu/ops/pipeline.py).

The port has one engine, the walk: an exact seed dedup, then
``cuda_kernels.sample_walk_dedup`` for every uniform hop, then the output
dict. Its outputs are bit-identical to the JAX package's cross-hop walk
(``GLT_HOP_ENGINE=pallas_fused``, ``GLT_FUSED_WALK=cross``) and to its
``GLT_DEDUP=sort GLT_FUSED_HOP=1`` reference, given the same uniforms.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from . import cuda_kernels
from .sample import FusedHopPlan, walk_hop_uniforms
from .unique import BIG, sorted_hop_dedup, sorted_nodes_by_label


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
    nh, labels = hop['new_head'], hop['labels']
    new_count = nh.sum(dtype=torch.int32)
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

  nodes = sorted_nodes_by_label(u_ids, u_labs, count, budget)
  out = dict(
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
  if with_edge:
    out['edge'] = torch.cat(eid_list)
  return out


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
