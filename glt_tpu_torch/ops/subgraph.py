"""Induced-subgraph extraction over a node set (counterpart of
glt_tpu/ops/subgraph.py).

The node set is labelled by :func:`ordered_unique` (first-occurrence
order); each node's neighbour window, capped at ``max_degree``, is read
from the CSR, and membership of each neighbour in the set is a binary
search over the sorted unique ids. The relabelled COO comes out padded,
``[U * max_degree]`` slots with a mask. Plain PyTorch: the JAX function
is XLA and reaches no Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .unique import ordered_unique


class SubGraph(NamedTuple):
  """An induced subgraph in padded layout."""
  nodes: torch.Tensor       # [U_cap] unique input nodes, -1 padded
  node_count: torch.Tensor  # scalar int32
  rows: torch.Tensor        # [U_cap * D] label of the edge's pointer end
  cols: torch.Tensor        # [U_cap * D] label of its other end
  eids: torch.Tensor        # [U_cap * D] edge ids (-1 without with_edge)
  edge_mask: torch.Tensor   # [U_cap * D]


def induced_subgraph(indptr: torch.Tensor, indices: torch.Tensor,
                     srcs: torch.Tensor, src_mask: torch.Tensor,
                     node_capacity: int, max_degree: int,
                     edge_ids: Optional[torch.Tensor] = None,
                     with_edge: bool = True) -> SubGraph:
  """Every edge of the CSR between two nodes of ``srcs[src_mask]``.

  Labels follow the first occurrence in ``srcs``. ``max_degree`` must
  bound every member's degree for the result to be exact. Edge slot
  ``u * max_degree + j`` holds member u's j-th edge (``rows`` = u's
  label, ``cols`` its neighbour's), valid where the neighbour is a
  member. With ``with_edge`` the slots carry ``edge_ids`` (or the CSR
  slot without them)."""
  dev = srcs.device
  cap, d = int(node_capacity), int(max_degree)
  uniq, count, _ = ordered_unique(srcs, src_mask, cap)
  node_valid = torch.arange(cap, device=dev) < count
  big = torch.iinfo(uniq.dtype).max
  masked = torch.where(node_valid, uniq, torch.full_like(uniq, big))
  sorted_ids, sort_order = torch.sort(masked, stable=True)

  num_edges = indices.numel()
  n = indptr.numel() - 1
  base = uniq.long().clamp(0, n)
  start = indptr[base].long()
  deg = indptr[(base + 1).clamp(0, n)].long() - start
  deg = torch.where(node_valid, deg, torch.zeros_like(deg))
  win = torch.arange(d, device=dev)[None, :]
  slot_valid = win < deg[:, None]                       # [U, D]
  slots = (start[:, None] + win).clamp(0, max(num_edges - 1, 0))
  if num_edges:
    nbr = indices[slots].reshape(-1).long()             # [U * D] global ids
  else:
    nbr = torch.zeros(cap * d, dtype=torch.long, device=dev)
  pos = torch.searchsorted(sorted_ids.long(), nbr)
  at = sorted_ids.long()[pos.clamp(0, cap - 1)]
  found = (pos < count) & (at == nbr)
  nbr_label = sort_order[pos.clamp(0, cap - 1)].to(torch.int32)
  edge_mask = slot_valid.reshape(-1) & found
  minus = torch.full((cap * d,), -1, dtype=torch.int32, device=dev)
  rows = torch.arange(cap, dtype=torch.int32,
                      device=dev).repeat_interleave(d)
  rows = torch.where(edge_mask, rows, minus)
  cols = torch.where(edge_mask, nbr_label, minus)
  if with_edge:
    flat = slots.reshape(-1)
    eids = edge_ids[flat] if edge_ids is not None else flat
    eids = torch.where(edge_mask, eids, torch.full_like(eids, -1))
  else:
    eids = minus
  return SubGraph(nodes=uniq, node_count=count, rows=rows, cols=cols,
                  eids=eids, edge_mask=edge_mask)
