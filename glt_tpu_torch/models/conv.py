"""GNN convolution layers over padded edge lists (counterpart of
glt_tpu/models/conv.py): invalid edge slots route to a sink segment, so
aggregation is one masked ``index_add_`` (a segment max one
``scatter_reduce``): the mean, the sum or the max (``SAGEConv(aggr=)``).
:class:`GCNConv` also takes a leading batch
dimension (a batch of padded subgraphs, each its own node space). These are plain PyTorch: the JAX convolutions are
XLA and reach no Pallas kernel.

Features of a narrower type (a bf16 feature store) are promoted to the
parameters' dtype on the way in, as flax's ``Dense`` promotes its input
(``param_dtype`` float32, no ``dtype``), so the layers compute in
float32."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _sink(targets: torch.Tensor, mask: torch.Tensor,
          num_segments: int) -> torch.Tensor:
  """Each slot's segment, int64; an invalid slot's is num_segments."""
  return torch.where(mask, targets,
                     torch.full_like(targets, num_segments)).long()


def segment_sum_masked(msgs: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor, num_segments: int) -> torch.Tensor:
  """Masked sum aggregation: invalid slots go to segment num_segments."""
  msgs = torch.where(mask[:, None], msgs, torch.zeros_like(msgs))
  total = msgs.new_zeros((num_segments + 1, msgs.shape[1]))
  return total.index_add_(0, _sink(targets, mask, num_segments),
                          msgs)[:num_segments]


def segment_mean(msgs: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor, num_segments: int) -> torch.Tensor:
  """Masked mean aggregation: invalid slots go to segment num_segments."""
  cnt = msgs.new_zeros(num_segments + 1).index_add_(
      0, _sink(targets, mask, num_segments), mask.to(msgs.dtype))
  return (segment_sum_masked(msgs, targets, mask, num_segments)
          / torch.clamp(cnt[:num_segments, None], min=1.0))


def segment_max_masked(msgs: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor, num_segments: int) -> torch.Tensor:
  """Masked max aggregation; a segment with no valid slot (its max -inf)
  reads 0."""
  seg = _sink(targets, mask, num_segments)
  msgs = torch.where(mask[:, None], msgs,
                     torch.full_like(msgs, float('-inf')))
  out = msgs.new_full((num_segments + 1, msgs.shape[1]), float('-inf'))
  out = out.scatter_reduce(0, seg[:, None].expand_as(msgs), msgs,
                           'amax')[:num_segments]
  return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


_AGGRS = {'mean': segment_mean, 'sum': segment_sum_masked,
          'max': segment_max_masked}


class SAGEConv(nn.Module):
  """GraphSAGE convolution: W_root x + b + W_nbr aggr(x[children]), the
  aggregation ``aggr`` 'mean', 'sum' or 'max' over each parent's valid
  children."""

  def __init__(self, in_features: int, out_features: int,
               aggr: str = 'mean', bias: bool = True):
    super().__init__()
    if aggr not in _AGGRS:
      raise ValueError(f"aggr must be one of {sorted(_AGGRS)}, got {aggr!r}")
    self.aggr = aggr
    self.lin_root = nn.Linear(in_features, out_features, bias=bias)
    self.lin_nbr = nn.Linear(in_features, out_features, bias=False)

  def forward(self, x: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
              edge_mask: torch.Tensor) -> torch.Tensor:
    x = x.to(self.lin_root.weight.dtype)
    n = x.shape[0]
    msgs = x.index_select(0, row.long().clamp(0, n - 1))
    ok = edge_mask & (row >= 0) & (col >= 0)
    agg = _AGGRS[self.aggr](msgs, col.clamp(0, n - 1), ok, n)
    return self.lin_root(x) + self.lin_nbr(agg)


class GATConv(nn.Module):
  """Graph attention (GATv1): per-edge logits (leaky ReLU of slope
  ``negative_slope``) softmax-normalised over each parent's valid
  incoming edges, multi-head, each head ``out_features`` wide: with
  ``concat`` the heads side by side, ``[n, heads * out_features]``,
  else their mean, ``[n, out_features]`` (the form the RGAT layers use).
  Parameters: ``proj`` (no bias), ``att_src`` and ``att_dst`` [heads,
  out_features]."""

  def __init__(self, in_features: int, out_features: int, heads: int = 1,
               concat: bool = True, negative_slope: float = 0.2):
    super().__init__()
    self.heads, self.out_features = heads, out_features
    self.concat, self.negative_slope = concat, negative_slope
    self.proj = nn.Linear(in_features, heads * out_features, bias=False)
    self.att_src = nn.Parameter(torch.empty(heads, out_features))
    self.att_dst = nn.Parameter(torch.empty(heads, out_features))
    nn.init.xavier_uniform_(self.att_src)
    nn.init.xavier_uniform_(self.att_dst)

  def forward(self, x: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
              edge_mask: torch.Tensor) -> torch.Tensor:
    x = x.to(self.proj.weight.dtype)
    n, h, f = x.shape[0], self.heads, self.out_features
    ok = edge_mask & (row >= 0) & (col >= 0)
    proj = self.proj(x).view(n, h, f)
    # per-node halves of the logit, gathered per edge (the same products
    # as gathering the projections first, without two [E, h, f] copies)
    a_src = (proj * self.att_src).sum(-1)
    a_dst = (proj * self.att_dst).sum(-1)
    r = row.long().clamp(0, n - 1)
    logit = F.leaky_relu(a_src[r] + a_dst[col.long().clamp(0, n - 1)],
                         self.negative_slope)                     # [E, h]
    seg = torch.where(ok, col.long(), torch.full_like(col, n, dtype=torch.long))
    # numerically stable masked segment softmax over each parent; a
    # segment with no valid edge has max -inf, read as 0
    neg = torch.full_like(logit, float('-inf'))
    seg_max = torch.full((n + 1, h), float('-inf'), dtype=logit.dtype,
                         device=x.device).scatter_reduce(
        0, seg[:, None].expand(-1, h), torch.where(ok[:, None], logit, neg),
        'amax')
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    z = torch.exp(logit - seg_max[seg])
    z = torch.where(ok[:, None], z, torch.zeros_like(z))
    denom = z.new_zeros((n + 1, h)).index_add_(0, seg, z)
    alpha = z / torch.clamp(denom[seg], min=1e-16)
    out = proj.new_zeros((n + 1, h, f)).index_add_(
        0, seg, proj[r] * alpha[:, :, None])[:n]
    return out.reshape(n, h * f) if self.concat else out.mean(1)


class GCNConv(nn.Module):
  """GCN layer with symmetric normalisation computed on the (masked)
  sampled edges, as the JAX package's: both endpoints of an edge are
  normalised by the in-degree of the self-loop-augmented graph (``deg_in
  + 1``), the self-loop term by ``1 / deg_in``, then the bias.
  Parameters: ``lin`` (no bias) and ``bias``.

  ``x`` [N, F] with ``row``/``col``/``edge_mask`` [E], or a batch of
  padded graphs: ``x`` [B, N, F] with [B, E] edge slots, each graph's
  labels in its own ``[0, N)``."""

  def __init__(self, in_features: int, out_features: int,
               bias: bool = True):
    super().__init__()
    self.lin = nn.Linear(in_features, out_features, bias=False)
    self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

  def forward(self, x: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
              edge_mask: torch.Tensor) -> torch.Tensor:
    x = x.to(self.lin.weight.dtype)
    n = x.shape[-2]
    ok = edge_mask & (row >= 0) & (col >= 0)
    h = self.lin(x)
    if x.dim() == 3:   # node spaces of the batch side by side
      off = torch.arange(x.shape[0], device=x.device)[:, None] * n
      total = x.shape[0] * n
    else:
      off, total = 0, n
    h_flat = h.reshape(total, -1)
    r = (row.long().clamp(0, n - 1) + off).reshape(-1)
    c = (col.long().clamp(0, n - 1) + off).reshape(-1)
    ok = ok.reshape(-1)
    seg = torch.where(ok, c, torch.full_like(c, total))
    deg_in = h.new_zeros(total + 1).index_add_(0, seg, ok.to(h.dtype))
    deg_in = deg_in[:total] + 1.0
    norm = deg_in[r].rsqrt() * deg_in[c].rsqrt()
    msgs = h_flat.index_select(0, r) * norm[:, None]
    msgs = torch.where(ok[:, None], msgs, torch.zeros_like(msgs))
    agg = h.new_zeros((total + 1, h.shape[-1])).index_add_(0, seg,
                                                          msgs)[:total]
    agg = agg + h_flat / deg_in[:, None]
    if self.bias is not None:
      agg = agg + self.bias
    return agg.reshape(h.shape)
