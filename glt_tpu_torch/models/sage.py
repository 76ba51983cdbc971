"""GraphSAGE over Batch (counterpart of glt_tpu/models/sage.py).

With ``trim=True`` layer l only processes the edge slots of the hops it
still needs -- a static slice through ``edge_hop_offsets``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..loader.transform import Batch
from .conv import SAGEConv


class GraphSAGE(nn.Module):
  """``num_layers`` of SAGEConv + relu, logits read off the seed rows.
  The reference topology for ogbn-products: 3 layers, hidden 256."""

  def __init__(self, in_features: int, hidden_features: int,
               out_features: int, num_layers: int = 3, trim: bool = True):
    super().__init__()
    self.num_layers = num_layers
    self.trim = trim
    dims = ([in_features] + [hidden_features] * (num_layers - 1)
            + [out_features])
    self.convs = nn.ModuleList(
        SAGEConv(dims[i], dims[i + 1]) for i in range(num_layers))

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
    return x if return_all else x[:batch.batch_size]

  def embed(self, batch: Batch) -> torch.Tensor:
    """Embeddings of every sampled node (link tasks index them by
    ``edge_label_index`` or the triplet indices, which range over every
    seed endpoint, not just the first ``batch_size`` labels)."""
    return self.forward(batch, return_all=True)
