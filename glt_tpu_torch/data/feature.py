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
from ..utils import resolve_device


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
