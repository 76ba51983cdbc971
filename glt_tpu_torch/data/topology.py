"""COO -> CSR or CSC topology (counterpart of glt_tpu/data/topology.py).

The compressed order is the JAX package's exactly -- slots sorted by
(pointer id, other id), ties in input order -- because the walk's picks
index into it. The build runs on the device the edge tensors are on (one
stable sort of a (row, col) key), so a large graph compresses, and flips
between layouts, on the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _as_tensor(x, device=None) -> Optional[torch.Tensor]:
  if x is None:
    return None
  if isinstance(x, torch.Tensor):
    return x if device is None else x.to(device)
  return torch.as_tensor(np.asarray(x), device=device)


class Topology:
  """CSR ('out' edges, indptr over src) or CSC ('in' edges, indptr over
  dst) built from a [2, E] COO ``edge_index`` (row=src, col=dst);
  ``layout`` is the one to build. Or from a given compressed ``indptr``
  and ``indices`` of that ``layout`` (glt_tpu/data/topology.py:90-106):
  each row's columns are sorted (ties in their given order), ``edge_ids``
  and ``edge_weights`` (aligned with the given slots) follow them, and
  ``indptr`` is padded to ``num_rows`` rows when it is shorter.

  Bipartite edge types compress with independent axis sizes:
  ``num_rows`` (the pointer axis of the layout: the src type of a CSR,
  the dst type of a CSC) and ``num_cols`` (the other endpoint's type);
  ``num_nodes`` sets both for a square graph. An axis given no size is
  one past its own largest id (the pointer axis past the largest
  pointer id, the other past the largest other id), as the JAX package
  sizes it.

  ``indptr`` is int64 (graphs past 2^31 edges must not wrap; the device
  copy narrows it), ``indices`` int32, and ``edge_ids[k]`` the original
  id of compressed slot k (the input position unless ``edge_ids`` are
  given). ``edge_weights`` (optional, one per input edge) are permuted
  into the same slot order. Arrays live on ``device`` (default: where
  ``edge_index`` is).
  """

  def __init__(self, edge_index=None, edge_ids=None, edge_weights=None,
               num_nodes: Optional[int] = None,
               num_rows: Optional[int] = None,
               num_cols: Optional[int] = None, layout: str = 'CSR',
               device=None, indptr=None, indices=None):
    if layout not in ('CSR', 'CSC'):
      raise ValueError(f'unsupported layout {layout!r}')
    self.layout = layout
    if num_nodes is not None:
      num_rows = num_nodes if num_rows is None else num_rows
      num_cols = num_nodes if num_cols is None else num_cols
    if edge_index is None:
      if indptr is None or indices is None:
        raise ValueError('provide either edge_index or indptr+indices')
      self._from_compressed(indptr, indices, edge_ids, edge_weights,
                            num_rows, num_cols, device)
      return
    edge_index = _as_tensor(edge_index, device).long().reshape(2, -1)
    row, col = edge_index[0], edge_index[1]
    if layout == 'CSC':
      row, col = col, row
    self.num_rows = int(num_rows) if num_rows is not None else (
        int(row.max()) + 1 if row.numel() else 0)
    self.num_cols = int(num_cols) if num_cols is not None else (
        int(col.max()) + 1 if col.numel() else 0)
    self.indptr, self.indices, perm = _compress(row, col, self.num_rows,
                                                self.num_cols)
    edge_ids = _as_tensor(edge_ids, row.device)
    self.edge_ids = edge_ids.long()[perm] if edge_ids is not None else perm
    w = _as_tensor(edge_weights, row.device)
    self.edge_weights = w[perm] if w is not None else None

  def _from_compressed(self, indptr, indices, edge_ids, edge_weights,
                       num_rows, num_cols, device):
    indptr = _as_tensor(indptr, device).long().reshape(-1)
    indices = _as_tensor(indices, indptr.device).long().reshape(-1)
    self.num_rows = (int(num_rows) if num_rows is not None
                     else indptr.numel() - 1)
    self.num_cols = int(num_cols) if num_cols is not None else (
        int(indices.max()) + 1 if indices.numel() else 0)
    deg = indptr[1:] - indptr[:-1]
    row = torch.repeat_interleave(
        torch.arange(indptr.numel() - 1, device=indptr.device), deg)
    # the JAX package's np.lexsort((indices, row)): stable in given order
    width = int(indices.max()) + 1 if indices.numel() else 1
    perm = torch.sort(row * width + indices, stable=True).indices
    self.indices = indices[perm].to(torch.int32)
    if indptr.numel() - 1 < self.num_rows:
      indptr = torch.cat([indptr, indptr[-1:].expand(
          self.num_rows + 1 - indptr.numel())])
    self.indptr = indptr
    edge_ids = _as_tensor(edge_ids, indptr.device)
    self.edge_ids = edge_ids.long()[perm] if edge_ids is not None else perm
    w = _as_tensor(edge_weights, indptr.device)
    self.edge_weights = w[perm] if w is not None else None

  @property
  def num_nodes(self) -> int:
    """Node count of the pointer axis (square graphs: the node count)."""
    return self.num_rows

  @property
  def num_edges(self) -> int:
    return int(self.indices.numel())

  @property
  def degrees(self) -> torch.Tensor:
    return self.indptr[1:] - self.indptr[:-1]

  @property
  def max_degree(self) -> int:
    d = self.degrees
    return int(d.max()) if d.numel() else 0

  def to_coo(self):
    """``(pointer ids, other ids, edge_ids)`` in compressed-slot order,
    int64 on the topology's device (the JAX ``to_coo``: src, dst, eid of
    a CSR; dst, src, eid of a CSC); ``edge_ids`` is the topology's own
    tensor, not a copy."""
    row = torch.repeat_interleave(
        torch.arange(self.num_rows, device=self.indices.device),
        self.degrees)
    return row, self.indices.long(), self.edge_ids

  def flip_layout(self) -> 'Topology':
    """The same edges re-compressed in the other layout (CSR <-> CSC), on
    this topology's device; edge ids and weights follow their edges."""
    ptr, other, eids = self.to_coo()
    src_dst = (ptr, other) if self.layout == 'CSR' else (other, ptr)
    return Topology(torch.stack(src_dst), edge_ids=eids,
                    edge_weights=self.edge_weights,
                    num_rows=self.num_cols, num_cols=self.num_rows,
                    layout='CSC' if self.layout == 'CSR' else 'CSR')


def _compress(row: torch.Tensor, col: torch.Tensor, num_rows: int,
              num_cols: int):
  """COO -> CSR, sorted by (row, col) with ties in input order
  (``np.lexsort((col, row))``); returns (indptr int64, indices int32,
  perm: compressed slot -> input position)."""
  for name, x, n in (('row', row, num_rows), ('col', col, num_cols)):
    if x.numel() and n <= int(x.max()):
      raise ValueError(f'{name} id {int(x.max())} out of range for '
                       f'num_{name}s={n}')
  perm = torch.sort(row * max(num_cols, 1) + col, stable=True).indices
  counts = torch.bincount(row, minlength=num_rows)
  indptr = torch.zeros(num_rows + 1, dtype=torch.int64, device=row.device)
  torch.cumsum(counts, 0, out=indptr[1:])
  return indptr, col[perm].to(torch.int32), perm
