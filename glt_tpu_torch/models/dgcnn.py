"""DGCNN, the SEAL link-prediction model (counterpart of
glt_tpu/models/dgcnn.py): stacked GCNConvs -> sort-pool of the k nodes
with the largest sort key -> Conv1d/MaxPool1d stack -> MLP -> one logit.

Batched over padded subgraphs ([B, N] node slots, [B, E] edge slots),
where the JAX model is written for one subgraph and ``vmap``-ed. The
sort-pool takes a stable descending sort, so tied keys keep the lower
node first, as ``lax.top_k`` does (one-hot DRNL features tie often). The
JAX Conv stack is NWC, so its flatten before ``mlp0`` is position-major;
this one permutes torch's NCW to match. No dropout: the example's step
runs the JAX model deterministic.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .conv import GCNConv


class DGCNN(nn.Module):
  """Args:
    in_features: node feature width (SEAL: the DRNL one-hot, MAX_Z + 1).
    hidden: GCN width (reference: 32).
    num_layers: hidden GCN layers (reference: 3); one more 1-channel conv
      gives the sort key.
    k: sort-pool size (>= 10; the reference takes the 60th percentile of
      the training subgraphs' sizes).
  """

  def __init__(self, in_features: int, hidden: int = 32,
               num_layers: int = 3, k: int = 30,
               conv1d_channels: Sequence[int] = (16, 32),
               mlp_hidden: int = 128):
    super().__init__()
    if k < 10:
      raise ValueError('DGCNN sort-pool k must be >= 10')
    self.k = int(k)
    self.convs = nn.ModuleList(
        GCNConv(in_features if i == 0 else hidden, hidden)
        for i in range(num_layers))
    self.gcn_key = GCNConv(hidden, 1)
    f_total = hidden * num_layers + 1
    self.conv1 = nn.Conv1d(1, conv1d_channels[0], f_total, stride=f_total)
    self.conv2 = nn.Conv1d(conv1d_channels[0], conv1d_channels[1], 5)
    self.mlp0 = nn.Linear((self.k // 2 - 4) * conv1d_channels[1],
                          mlp_hidden)
    self.mlp1 = nn.Linear(mlp_hidden, 1)

  def forward(self, x: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
              edge_mask: torch.Tensor, node_mask: torch.Tensor
              ) -> torch.Tensor:
    """``x`` [B, N, F], ``row``/``col``/``edge_mask`` [B, E], ``node_mask``
    [B, N] -> logits [B]."""
    xs, h = [], x
    for conv in self.convs:
      h = torch.tanh(conv(h, row, col, edge_mask))
      xs.append(h)
    key = torch.tanh(self.gcn_key(h, row, col, edge_mask))
    xs.append(key)
    h = torch.cat(xs, -1)                               # [B, N, F_total]
    h = torch.where(node_mask[..., None], h, torch.zeros_like(h))
    keyv = torch.where(node_mask, key[..., 0],
                       torch.full_like(key[..., 0], float('-inf')))
    top = torch.sort(keyv, dim=-1, descending=True,
                     stable=True).indices[:, :self.k]   # [B, k]
    pooled = h.gather(1, top[..., None].expand(-1, -1, h.shape[-1]))
    pooled = pooled * node_mask.gather(1, top)[..., None].to(h.dtype)
    b = pooled.shape[0]
    z = torch.relu(self.conv1(pooled.reshape(b, 1, -1)))   # [B, C1, k]
    z = nn.functional.max_pool1d(z, 2, 2)
    z = torch.relu(self.conv2(z))                       # [B, C2, L]
    z = z.permute(0, 2, 1).reshape(b, -1)               # position-major
    z = torch.relu(self.mlp0(z))
    return self.mlp1(z)[:, 0]
