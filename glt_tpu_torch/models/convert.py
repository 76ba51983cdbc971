"""Flax GraphSAGE / RGNN / DGCNN / HGT parameters -> this package's
state_dict.

Flax ``Dense`` keeps ``kernel`` as [in, out] and computes ``x @ kernel``;
``nn.Linear`` keeps ``weight`` as [out, in], so kernels are transposed.
Flax ``Conv`` kernels are [W, Cin, Cout] and ``nn.Conv1d`` weights
[Cout, Cin, W].
Input is the flax tree with numpy leaves (``jax.tree.map(np.asarray,
params)``); nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def sage_conv_params_from_flax(conv: Mapping,
                               prefix: str = '') -> Dict[str, torch.Tensor]:
  """One SAGEConv: ``{lin_root: {kernel, bias}, lin_nbr: {kernel}}``."""
  t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))
  out = {f'{prefix}lin_root.weight': t(conv['lin_root']['kernel']).T,
         f'{prefix}lin_nbr.weight': t(conv['lin_nbr']['kernel']).T}
  if 'bias' in conv['lin_root']:
    out[f'{prefix}lin_root.bias'] = t(conv['lin_root']['bias'])
  return {k: v.contiguous() for k, v in out.items()}


def sage_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
  """A flax GraphSAGE tree (``{'params': {'conv0': ..., ...}}`` or its
  inner dict) -> :class:`~glt_tpu_torch.models.GraphSAGE` state_dict,
  each conv a SAGEConv, a GCNConv or a GATConv by its fields."""
  params = tree.get('params', tree)
  out = {}
  i = 0
  while f'conv{i}' in params:
    conv = params[f'conv{i}']
    convert = (gat_conv_params_from_flax if 'proj' in conv
               else gcn_conv_params_from_flax if 'lin' in conv
               else sage_conv_params_from_flax)
    out.update(convert(conv, prefix=f'convs.{i}.'))
    i += 1
  return out


def gat_conv_params_from_flax(conv: Mapping,
                              prefix: str = '') -> Dict[str, torch.Tensor]:
  """One GATConv: ``{proj: {kernel}, att_src, att_dst}``."""
  t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))
  return {f'{prefix}proj.weight': t(conv['proj']['kernel']).T.contiguous(),
          f'{prefix}att_src': t(conv['att_src']),
          f'{prefix}att_dst': t(conv['att_dst'])}


def rgnn_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
  """A flax RGNN tree -> :class:`~glt_tpu_torch.models.RGNN` state_dict:
  ``layer<i>.conv_<etype>`` (GATConv or SAGEConv by its fields) and
  ``layer<i>.self_<type>`` (Dense)."""
  params = tree.get('params', tree)
  t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))
  out = {}
  i = 0
  while f'layer{i}' in params:
    for name, sub in params[f'layer{i}'].items():
      if name.startswith('conv_'):
        prefix = f'layers.{i}.convs.{name[len("conv_"):]}.'
        out.update(gat_conv_params_from_flax(sub, prefix) if 'proj' in sub
                   else sage_conv_params_from_flax(sub, prefix))
      elif name.startswith('self_'):
        prefix = f'layers.{i}.self_lins.{name[len("self_"):]}.'
        out[prefix + 'weight'] = t(sub['kernel']).T.contiguous()
        out[prefix + 'bias'] = t(sub['bias'])
      else:
        raise ValueError(f'unknown RGNN parameter group {name!r}')
    i += 1
  return out


def gcn_conv_params_from_flax(conv: Mapping,
                              prefix: str = '') -> Dict[str, torch.Tensor]:
  """One GCNConv: ``{lin: {kernel}, bias}``."""
  t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))
  out = {f'{prefix}lin.weight': t(conv['lin']['kernel']).T.contiguous()}
  if 'bias' in conv:
    out[f'{prefix}bias'] = t(conv['bias'])
  return out


def dgcnn_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
  """A flax DGCNN tree -> :class:`~glt_tpu_torch.models.DGCNN`
  state_dict: ``gcn<i>`` -> ``convs.<i>``, ``gcn_key``, the two Conv
  kernels permuted to [Cout, Cin, W], the MLP's Dense kernels
  transposed."""
  params = tree.get('params', tree)
  t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))
  out = {}
  i = 0
  while f'gcn{i}' in params:
    out.update(gcn_conv_params_from_flax(params[f'gcn{i}'], f'convs.{i}.'))
    i += 1
  out.update(gcn_conv_params_from_flax(params['gcn_key'], 'gcn_key.'))
  for name in ('conv1', 'conv2'):
    out[f'{name}.weight'] = t(params[name]['kernel']).permute(
        2, 1, 0).contiguous()
    out[f'{name}.bias'] = t(params[name]['bias'])
  for name in ('mlp0', 'mlp1'):
    out[f'{name}.weight'] = t(params[name]['kernel']).T.contiguous()
    out[f'{name}.bias'] = t(params[name]['bias'])
  return out


def hgt_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
  """A flax HGT tree -> :class:`~glt_tpu_torch.models.HGT` state_dict:
  ``in_<type>`` and ``head`` (Dense), and per layer ``hgt<i>``: the
  ``DenseGeneral((heads, d))`` kernels ``k_``, ``q_``, ``v_<type>``
  ([in, heads, d], flattened to [in, heads * d] and transposed),
  ``a_<type>`` and ``res_<type>`` (Dense), the scalars ``skip_<type>``
  and per relation ``watt_``, ``wmsg_`` ([heads, d, d]) and ``prior_``
  ([heads]). Flax makes a relation's weights only when a batch holds it
  and a projection only for a type with rows, so load with
  ``strict=False``: the port's other weights stay as they are."""
  params = tree.get('params', tree)
  t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))
  dense = lambda sub, prefix: {
      f'{prefix}.weight': t(sub['kernel']).reshape(
          sub['kernel'].shape[0], -1).T.contiguous(),
      f'{prefix}.bias': t(sub['bias']).reshape(-1)}
  out = {}
  for name, sub in params.items():
    if name == 'head' or name.startswith('in_'):
      key = 'head' if name == 'head' else f'in_lins.{name[len("in_"):]}'
      out.update(dense(sub, key))
      continue
    if not name.startswith('hgt'):
      raise ValueError(f'unknown HGT parameter group {name!r}')
    layer = f'convs.{int(name[len("hgt"):])}'
    for pname, p in sub.items():
      kind, rest = pname.split('_', 1)
      if kind in ('k', 'q', 'v', 'a', 'res'):
        out.update(dense(p, f'{layer}.{kind}_lins.{rest}'))
      elif kind in ('skip', 'watt', 'wmsg', 'prior'):
        out[f'{layer}.{kind}.{rest}'] = t(p)
      else:
        raise ValueError(f'unknown HGT parameter {pname!r}')
  return out
