"""Heterogeneous Graph Transformer over a HeteroBatch (counterpart of
glt_tpu/models/hgt.py, the model of examples/hetero/train_hgt_mag.py).

The arithmetic is the JAX package's, not PyG's: typed Q/K/V projections a
node type (``[N, heads, d]``), a relation's attention logit
``q . (W_att k) * prior / sqrt(d)`` and message ``W_msg v``, weights
``exp(clip(logit, -30, 30))`` without a max subtraction (a masked edge
weighs 0), each destination's weighted messages and weights summed over
every relation into it and divided (the norm floored at 1e-9), then
``a_<type>``, a tanh-approximated GELU and a learned skip
``sigmoid(skip) * gelu(o) + (1 - sigmoid(skip)) * x`` (``x`` through
``res_<type>`` where the widths differ). The segment sums are XLA ops in
JAX and ``index_add_`` here: no Pallas kernel is involved.

A relation absent from the batch, or whose end types have no rows,
contributes nothing; a type no relation reaches keeps ``a(0)`` in its
attention branch (a padded author row of a paper-seeded batch stays
finite).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..loader.transform import HeteroBatch
from ..typing import EdgeType, NodeType, as_str


def _glorot(*shape: int) -> nn.Parameter:
  """flax's ``glorot_uniform`` for a ``(heads, d, d)`` kernel: the last
  two axes are in and out, the first a receptive field."""
  fan = shape[0] * shape[1]
  bound = math.sqrt(6.0 / (2 * fan))
  return nn.Parameter(torch.empty(shape).uniform_(-bound, bound))


class HGTConv(nn.Module):
  """One HGT layer.

  Args:
    node_types / edge_types: the types the layer has weights for (edge
      keys in message-flow orientation, as the batch carries them).
    in_features: the input width, one for every type or a dict by type.
    out_features: the output width, ``heads * d``.
    heads: attention heads.
  """

  def __init__(self, node_types: Sequence[NodeType],
               edge_types: Sequence[EdgeType],
               in_features: Union[int, Mapping[NodeType, int]],
               out_features: int, heads: int = 2):
    super().__init__()
    if out_features % heads:
      raise ValueError(f'out_features {out_features} is not a multiple of '
                       f'heads {heads}')
    self.node_types = list(node_types)
    self.edge_types = [tuple(e) for e in edge_types]
    self.heads, self.out_features = heads, out_features
    dims = (dict(in_features) if isinstance(in_features, Mapping)
            else {t: int(in_features) for t in self.node_types})
    d = out_features // heads
    lin = lambda make: nn.ModuleDict({t: make(t) for t in self.node_types})
    self.k_lins = lin(lambda t: nn.Linear(dims[t], out_features))
    self.q_lins = lin(lambda t: nn.Linear(dims[t], out_features))
    self.v_lins = lin(lambda t: nn.Linear(dims[t], out_features))
    self.a_lins = lin(lambda t: nn.Linear(out_features, out_features))
    self.res_lins = nn.ModuleDict({
        t: nn.Linear(dims[t], out_features) for t in self.node_types
        if dims[t] != out_features})
    self.skip = nn.ParameterDict({
        t: nn.Parameter(torch.ones(())) for t in self.node_types})
    names = [as_str(e) for e in self.edge_types]
    self.watt = nn.ParameterDict({n: _glorot(heads, d, d) for n in names})
    self.wmsg = nn.ParameterDict({n: _glorot(heads, d, d) for n in names})
    self.prior = nn.ParameterDict({
        n: nn.Parameter(torch.ones(heads)) for n in names})

  def forward(self, x_dict: Dict[NodeType, torch.Tensor], row_dict,
              col_dict, mask_dict) -> Dict[NodeType, torch.Tensor]:
    h, f = self.heads, self.out_features
    d = f // h
    proj = lambda lins: {t: lins[t](x).view(x.shape[0], h, d)
                         for t, x in x_dict.items()}
    k_dict, q_dict, v_dict = (proj(self.k_lins), proj(self.q_lins),
                              proj(self.v_lins))
    agg = {t: x.new_zeros((x.shape[0], h, d)) for t, x in x_dict.items()}
    norm = {t: x.new_zeros((x.shape[0], h)) for t, x in x_dict.items()}
    for etype in self.edge_types:
      if etype not in row_dict:
        continue
      src_t, _, dst_t = etype
      if src_t not in x_dict or dst_t not in x_dict:
        continue
      name = as_str(etype)
      row, col = row_dict[etype].long(), col_dict[etype].long()
      ok = mask_dict[etype]
      n_src, n_dst = x_dict[src_t].shape[0], x_dict[dst_t].shape[0]
      r, c = row.clamp(0, n_src - 1), col.clamp(0, n_dst - 1)
      k = k_dict[src_t].index_select(0, r)
      q = q_dict[dst_t].index_select(0, c)
      v = v_dict[src_t].index_select(0, r)
      kt = torch.einsum('ehd,hdf->ehf', k, self.watt[name])
      logit = (q * kt).sum(-1) * self.prior[name] / math.sqrt(d)
      msg = torch.einsum('ehd,hdf->ehf', v, self.wmsg[name])
      w = torch.where(ok[:, None], torch.exp(logit.clamp(-30.0, 30.0)),
                      torch.zeros_like(logit))
      seg = torch.where(ok, col, torch.full_like(col, n_dst))
      agg[dst_t] = agg[dst_t] + msg.new_zeros((n_dst + 1, h, d)).index_add_(
          0, seg, msg * w[:, :, None])[:n_dst]
      norm[dst_t] = norm[dst_t] + w.new_zeros((n_dst + 1, h)).index_add_(
          0, seg, w)[:n_dst]
    out = {}
    for t, x in x_dict.items():
      msg = agg[t] / norm[t][:, :, None].clamp(min=1e-9)
      o = self.a_lins[t](msg.reshape(msg.shape[0], f))
      alpha = torch.sigmoid(self.skip[t])
      base = x if x.shape[-1] == f else self.res_lins[t](x)
      out[t] = alpha * F.gelu(o, approximate='tanh') + (1 - alpha) * base
    return out


class HGT(nn.Module):
  """HGT stack with an input projection a node type (``in_<type>``) and a
  head on the seed type (the train_hgt_mag topology): logits of the
  batch's first ``batch_size`` seed rows."""

  def __init__(self, node_types: Sequence[NodeType],
               edge_types: Sequence[EdgeType],
               in_features: Union[int, Mapping[NodeType, int]],
               hidden_features: int, out_features: int, num_layers: int = 2,
               heads: int = 2):
    super().__init__()
    node_types = list(node_types)
    dims = (dict(in_features) if isinstance(in_features, Mapping)
            else {t: int(in_features) for t in node_types})
    self.in_lins = nn.ModuleDict({
        t: nn.Linear(dims[t], hidden_features) for t in node_types})
    self.convs = nn.ModuleList(
        HGTConv(node_types, edge_types, hidden_features, hidden_features,
                heads=heads) for _ in range(num_layers))
    self.head = nn.Linear(hidden_features, out_features)

  def forward(self, batch: HeteroBatch) -> torch.Tensor:
    # promoted once per type, as flax's Dense promotes a bf16 input
    dtype = self.head.weight.dtype
    x_dict = {t: self.in_lins[t](x.to(dtype))
              for t, x in batch.x_dict.items()}
    for conv in self.convs:
      x_dict = conv(x_dict, batch.row_dict, batch.col_dict,
                    batch.edge_mask_dict)
    return self.head(x_dict[batch.input_type])[:batch.batch_size]
