"""Flax GraphSAGE / RGNN parameters -> this package's state_dict.

Flax ``Dense`` keeps ``kernel`` as [in, out] and computes ``x @ kernel``;
``nn.Linear`` keeps ``weight`` as [out, in], so kernels are transposed.
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
  inner dict) -> :class:`~glt_tpu_torch.models.GraphSAGE` state_dict."""
  params = tree.get('params', tree)
  out = {}
  i = 0
  while f'conv{i}' in params:
    out.update(sage_conv_params_from_flax(params[f'conv{i}'],
                                          prefix=f'convs.{i}.'))
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
