"""Flax GraphSAGE parameters -> this package's state_dict.

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
