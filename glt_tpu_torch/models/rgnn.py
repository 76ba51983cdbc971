"""Relational GNNs over HeteroBatch (counterpart of glt_tpu/models/rgnn.py):
one conv per edge type, relation outputs summed per destination type,
and the RGNN stack (RGAT / RSAGE, the MLPerf IGBH models).

Batch contract: edge keys (s, r, d) carry ``row`` = s-type child labels
and ``col`` = d-type parent labels. A bipartite relation runs its conv
over the stacked rows ``[x_s || x_d]`` with ``col`` offset by ``n_s``, as
the reference does, so the homogeneous convs serve it unchanged.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..loader.transform import HeteroBatch
from ..typing import EdgeType, NodeType, as_str
from .conv import GATConv, SAGEConv


class HeteroConvLayer(nn.Module):
  """Applies a per-edge-type conv and sums relation outputs per dst type.

  The GAT relation is the reference's ``GATConv(out_features, heads,
  concat=False)``: every head is ``out_features`` wide and the heads are
  averaged. A node type that is the destination of none of
  ``edge_types`` keeps a transformed self-embedding (``self_<type>``);
  ``node_types`` names the types that need one."""

  def __init__(self, edge_types: Sequence[EdgeType], in_features: int,
               out_features: int, conv: str = 'sage', heads: int = 1,
               node_types: Sequence[NodeType] = ()):
    super().__init__()
    self.edge_types = [tuple(e) for e in edge_types]
    make = ((lambda: GATConv(in_features, out_features, heads=heads,
                             concat=False))
            if conv == 'gat'
            else (lambda: SAGEConv(in_features, out_features)))
    self.convs = nn.ModuleDict({as_str(e): make() for e in self.edge_types})
    dst_types = {e[2] for e in self.edge_types}
    self.self_lins = nn.ModuleDict({
        t: nn.Linear(in_features, out_features)
        for t in node_types if t not in dst_types})

  def forward(self, x_dict: Dict[NodeType, torch.Tensor], row_dict,
              col_dict, mask_dict) -> Dict[NodeType, torch.Tensor]:
    # promoted once per type here, not once per relation in the convs
    dtype = next(self.parameters()).dtype
    x_dict = {t: x.to(dtype) for t, x in x_dict.items()}
    out: Dict[NodeType, torch.Tensor] = {}
    for etype in self.edge_types:
      if etype not in row_dict:
        continue
      src_t, _, dst_t = etype
      if src_t not in x_dict or dst_t not in x_dict:
        continue
      n_src = x_dict[src_t].shape[0]
      bipartite = src_t != dst_t
      x_cat = (torch.cat([x_dict[src_t], x_dict[dst_t]]) if bipartite
               else x_dict[src_t])
      col = col_dict[etype] + n_src if bipartite else col_dict[etype]
      h = self.convs[as_str(etype)](x_cat, row_dict[etype], col,
                                    mask_dict[etype])
      h = h[n_src:] if bipartite else h
      out[dst_t] = out[dst_t] + h if dst_t in out else h
    for t, x in x_dict.items():
      if t not in out:
        if t not in self.self_lins:
          raise ValueError(f'node type {t!r} has no incoming relation and '
                           'no self_<type> layer (pass it in node_types)')
        out[t] = self.self_lins[t](x)
    return out


class RGNN(nn.Module):
  """Relational GNN stack (reference examples/igbh/rgnn.py): 'rsage' or
  'rgat' layers over a HeteroBatch, logits read off the seed type.

  With ``trim`` and a batch that carries ``edge_hop_offsets_dict``, layer
  i reads only the edge slots of hops ``[0, num_hops - i)`` per edge type
  (the reference's trim_to_layer, as static slices; at least one slot).
  ``dropout`` follows each hidden layer's ReLU, active under
  ``model.train()`` (the reference's ``train=True``)."""

  def __init__(self, edge_types: Sequence[EdgeType], in_features: int,
               hidden_features: int, out_features: int, num_layers: int = 2,
               conv: str = 'rsage', heads: int = 4, trim: bool = True,
               node_types: Optional[Sequence[NodeType]] = None,
               dropout: float = 0.0):
    super().__init__()
    self.num_layers, self.trim = num_layers, trim
    self.dropout = nn.Dropout(dropout) if dropout > 0 else None
    dims = ([in_features] + [hidden_features] * (num_layers - 1)
            + [out_features])
    kind = 'gat' if conv == 'rgat' else 'sage'
    self.layers = nn.ModuleList(
        HeteroConvLayer(edge_types, dims[i], dims[i + 1], conv=kind,
                        heads=heads, node_types=node_types or ())
        for i in range(num_layers))

  def forward(self, batch: HeteroBatch,
              return_all: bool = False) -> torch.Tensor:
    x_dict = dict(batch.x_dict)
    offs = batch.edge_hop_offsets_dict if self.trim else None
    num_hops = (max(len(v) for v in offs.values()) - 1) if offs else 0
    for i, layer in enumerate(self.layers):
      row_d, col_d, mask_d = (batch.row_dict, batch.col_dict,
                              batch.edge_mask_dict)
      if offs is not None:
        # layer i feeds num_layers-1-i later propagations, so hop h is
        # read iff h <= num_layers - i (clamped to the sampled hops)
        keep = max(min(num_hops, self.num_layers - i), 1)
        ends = {e: max(offs[e][min(keep, len(offs[e]) - 1)]
                       if e in offs else v.shape[0], 1)
                for e, v in row_d.items()}
        row_d = {e: v[:ends[e]] for e, v in row_d.items()}
        col_d = {e: v[:ends[e]] for e, v in col_d.items()}
        mask_d = {e: v[:ends[e]] for e, v in mask_d.items()}
      x_dict = layer(x_dict, row_d, col_d, mask_d)
      if i < self.num_layers - 1:
        x_dict = {t: torch.relu(v) for t, v in x_dict.items()}
        if self.dropout is not None:
          x_dict = {t: self.dropout(v) for t, v in x_dict.items()}
    if return_all:
      return x_dict
    return x_dict[batch.input_type][:batch.batch_size]
