"""GraphSAGE over Batch (counterpart of glt_tpu/models/sage.py).

With ``trim=True`` layer l only processes the edge slots of the hops it
still needs -- a static slice through ``edge_hop_offsets``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..loader.transform import Batch
from .conv import GATConv, GCNConv, SAGEConv

#: the reference's convolutions by name (glt_tpu/models/sage.py _CONVS)
_CONVS = {
    'sage': lambda i, o: SAGEConv(i, o),
    'gcn': lambda i, o: GCNConv(i, o),
    'gat': lambda i, o: GATConv(i, o, heads=1),
}


class GraphSAGE(nn.Module):
  """``num_layers`` of ``conv`` ('sage', 'gcn' or 'gat' with one head) +
  relu + dropout, logits read off the seed rows. The reference topology
  for ogbn-products: 3 SAGE layers, hidden 256. ``dropout`` follows each
  hidden ReLU and is active under ``model.train()`` (the reference's
  ``train=True``)."""

  def __init__(self, in_features: int, hidden_features: int,
               out_features: int, num_layers: int = 3, conv: str = 'sage',
               dropout: float = 0.0, trim: bool = True):
    super().__init__()
    if conv not in _CONVS:
      raise ValueError(f'conv must be one of {sorted(_CONVS)}, got {conv!r}')
    self.num_layers = num_layers
    self.trim = trim
    dims = ([in_features] + [hidden_features] * (num_layers - 1)
            + [out_features])
    self.convs = nn.ModuleList(
        _CONVS[conv](dims[i], dims[i + 1]) for i in range(num_layers))
    self.dropout = nn.Dropout(dropout) if dropout > 0 else None

  def forward(self, batch: Batch, return_all: bool = False) -> torch.Tensor:
    x = batch.x
    row, col, mask = batch.row, batch.col, batch.edge_mask
    offsets = batch.edge_hop_offsets
    num_hops = len(offsets) - 1 if offsets else self.num_layers
    for i, conv in enumerate(self.convs):
      if self.trim and offsets is not None:
        # layer i feeds num_layers-1-i later propagations, so hop h is
        # read iff h <= num_layers - i (clamped to the sampled hops)
        end = offsets[max(min(num_hops, self.num_layers - i), 1)]
        r, c, m = row[:end], col[:end], mask[:end]
      else:
        r, c, m = row, col, mask
      x = conv(x, r, c, m)
      if i < self.num_layers - 1:
        x = torch.relu(x)
        if self.dropout is not None:
          x = self.dropout(x)
    return x if return_all else x[:batch.batch_size]

  def embed(self, batch: Batch) -> torch.Tensor:
    """Embeddings of every sampled node (link tasks index them by
    ``edge_label_index`` or the triplet indices, which range over every
    seed endpoint, not just the first ``batch_size`` labels)."""
    return self.forward(batch, return_all=True)
