"""GNN convolution layers over padded edge lists (counterpart of
glt_tpu/models/conv.py): invalid edge slots route to a sink segment, so
aggregation is one masked ``index_add_``."""
from __future__ import annotations

import torch
from torch import nn


def segment_mean(msgs: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor, num_segments: int) -> torch.Tensor:
  """Masked mean aggregation: invalid slots go to segment num_segments."""
  seg = torch.where(mask, targets, torch.full_like(targets, num_segments))
  seg = seg.long()
  msgs = torch.where(mask[:, None], msgs, torch.zeros_like(msgs))
  total = msgs.new_zeros((num_segments + 1, msgs.shape[1]))
  total.index_add_(0, seg, msgs)
  cnt = msgs.new_zeros(num_segments + 1)
  cnt.index_add_(0, seg, mask.to(msgs.dtype))
  return total[:num_segments] / torch.clamp(cnt[:num_segments, None],
                                            min=1.0)


class SAGEConv(nn.Module):
  """GraphSAGE convolution: W_root x + b + W_nbr mean(x[children])."""

  def __init__(self, in_features: int, out_features: int,
               bias: bool = True):
    super().__init__()
    self.lin_root = nn.Linear(in_features, out_features, bias=bias)
    self.lin_nbr = nn.Linear(in_features, out_features, bias=False)

  def forward(self, x: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
              edge_mask: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    msgs = x.index_select(0, row.long().clamp(0, n - 1))
    ok = edge_mask & (row >= 0) & (col >= 0)
    agg = segment_mean(msgs, col.clamp(0, n - 1), ok, n)
    return self.lin_root(x) + self.lin_nbr(agg)
