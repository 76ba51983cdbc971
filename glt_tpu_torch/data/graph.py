"""Device-resident graph storage (counterpart of glt_tpu/data/graph.py).

The CUDA kernels read elements directly and clip each one, so the TPU's
W-padded window copies (``window_arrays``) and hub counts have no
counterpart: the device holds the CSR once (and the edge weights, when
the topology has them), plus ``indptr_pad`` ([N + 2] int32 with a
trailing ``num_edges`` sentinel) so an invalid frontier id reads degree
0.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..typing import EdgeType, NodeType
from ..utils import resolve_device
from .topology import Topology


class Graph:
  """Binds a :class:`Topology` to ``device`` (default: the card; raises
  when there is none). A hetero dataset holds one per edge type, its
  ``indptr_pad`` over the edge type's pointer node type (src of a CSR,
  dst of a CSC)."""

  def __init__(self, topo: Topology, device=None):
    self.topo = topo
    self.device = resolve_device(device)
    if topo.num_edges >= torch.iinfo(torch.int32).max:
      raise ValueError('the walk kernels address edges with int32')
    self.indptr = topo.indptr.to(self.device, torch.int32)
    self.indices = topo.indices.to(self.device)
    self.edge_ids = topo.edge_ids.to(self.device)
    self.edge_weights = (topo.edge_weights.to(self.device, torch.float32)
                         if topo.edge_weights is not None else None)
    self.indptr_pad = torch.cat([
        self.indptr,
        torch.full((1,), topo.num_edges, dtype=torch.int32,
                   device=self.device)])

  @property
  def layout(self) -> str:
    """'CSR' (sampled along out-edges) or 'CSC' (along in-edges)."""
    return self.topo.layout

  @property
  def num_nodes(self) -> int:
    return self.topo.num_nodes

  @property
  def num_edges(self) -> int:
    return self.topo.num_edges

  def degree(self, ids) -> torch.Tensor:
    """The degree of each of ``ids`` (pointer-axis ids, in range) along
    the layout's axis, read from the card's ``indptr``."""
    ids = torch.as_tensor(ids, device=self.device).long()
    return self.indptr[ids + 1] - self.indptr[ids]


def hetero_node_counts(graphs: Dict[EdgeType, Graph]) -> Dict[NodeType, int]:
  """Per node type, the largest axis any edge type's graph gives it (rows
  for its pointer type, columns for the other), in first-appearance order
  over the edge types' (src, dst)."""
  counts: Dict[NodeType, int] = {}
  for (src, _, dst), g in graphs.items():
    counts.setdefault(src, 0)
    counts.setdefault(dst, 0)
    rows_t, cols_t = (src, dst) if g.layout == 'CSR' else (dst, src)
    counts[rows_t] = max(counts[rows_t], g.topo.num_rows)
    counts[cols_t] = max(counts[cols_t], g.topo.num_cols)
  return counts
