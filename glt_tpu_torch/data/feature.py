"""Device-resident feature store (counterpart of glt_tpu/data/feature.py).

This slice serves fully device-resident tables; the hot/cold split with
pinned-host cold rows comes in a later slice. Rows are read through the
``gather_rows`` kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import cuda_kernels
from ..utils import as_numpy, resolve_device


class Feature:
  """2-D feature table on ``device`` (default: the card; raises when
  there is none)."""

  def __init__(self, feats, device=None, dtype: Optional[torch.dtype] = None):
    self.device = resolve_device(device)
    if not isinstance(feats, torch.Tensor):
      feats = torch.as_tensor(np.asarray(feats))
    if feats.dim() == 1:
      feats = feats[:, None]
    self.table = feats.to(self.device, dtype or feats.dtype).contiguous()

  @property
  def shape(self):
    return tuple(self.table.shape)

  @property
  def feature_dim(self) -> int:
    return self.table.shape[1]

  def with_updated_rows(self, ids, values) -> 'Feature':
    """A new Feature whose table is a copy of this one with rows ``ids``
    set to ``values`` [len(ids), D] (counterpart of the JAX functional
    ``.at[].set``): readers of this Feature keep the old rows, the
    snapshot isolation of the live-update stream. Costs one copy of the
    table on its device."""
    ids = torch.as_tensor(as_numpy(ids).astype(np.int64).reshape(-1),
                          device=self.device)
    values = torch.as_tensor(as_numpy(values)).reshape(ids.numel(), -1)
    if values.shape[1] != self.feature_dim:
      raise ValueError(f'expected {(ids.numel(), self.feature_dim)} update '
                       f'block, got {tuple(values.shape)}')
    n = self.table.shape[0]
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n):
      raise ValueError(f'feature row out of range [0, {n})')
    out = Feature.__new__(Feature)
    out.__dict__.update(self.__dict__)
    out.table = self.table.clone()
    out.table[ids] = values.to(self.device, self.table.dtype)
    return out

  def device_gather(self, rows: torch.Tensor) -> torch.Tensor:
    """Rows of the table, ``rows`` clamped to ``[0, N-1]``."""
    return cuda_kernels.gather_rows(self.table, rows.reshape(-1)).reshape(
        rows.shape + (self.feature_dim,))


def gather_features(feat: Optional[Feature],
                    node: torch.Tensor) -> Optional[torch.Tensor]:
  """The batch's feature rows (padded ``node`` lanes are -1 and read row
  0, as the JAX gather's clip does)."""
  if feat is None:
    return None
  return feat.device_gather(node)
