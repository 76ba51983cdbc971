"""Stitch per-partition row blocks back into seed order (counterpart of
glt_tpu/ops/stitch.py).

Each partition answers for the seed positions it served, in fixed-size
blocks, so merging is a positional scatter ``out[idx_p] = part_p``: no
prefix scan over variable-length runs is needed.
"""
from __future__ import annotations

from typing import Sequence

import torch


def stitch_rows(idx_list: Sequence[torch.Tensor],
                parts: Sequence[torch.Tensor], total: int) -> torch.Tensor:
  """Scatter row blocks to their global positions: ``[total, ...]`` of
  ``parts[0]``'s dtype and device, zeros where no block wrote.

  Args:
    idx_list: per partition its ``[m_p]`` positions in the output; ``-1``
      pads are dropped.
    parts: per partition its ``[m_p, ...]`` rows.
    total: the output's row count.

  One sacrificial row at ``total`` takes the pads' writes, so a pad never
  lands on a real row. A later block overwrites an earlier one's rows at
  the same positions, as the JAX scatters do one after the other."""
  first = parts[0]
  out = torch.zeros((total + 1,) + tuple(first.shape[1:]), dtype=first.dtype,
                    device=first.device)
  for idx, part in zip(idx_list, parts):
    idx = torch.as_tensor(idx, device=first.device).long()
    safe = torch.where(idx >= 0, idx, torch.full_like(idx, total))
    out[safe] = part.to(first.dtype)
  return out[:total]
