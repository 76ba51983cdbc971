"""Row-index helpers (counterpart of glt_tpu/utils/tensor.py).

``id2idx`` and ``index_select`` take numpy arrays or tensors and answer in
kind. ``as_numpy`` lives in ``utils/common.py``. The JAX module's
``as_jax``, ``ensure_device`` and ``new_key`` have no counterpart: the
port places tensors through ``resolve_device`` (an entry point's
``device=``) and draws from explicit ``torch.Generator`` objects
(``utils/rng.py``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def id2idx(ids):
  """Dense global-id -> local-index map: ``out[ids[i]] = i`` over
  ``max(ids) + 1`` entries (0 where no id maps; one entry for no ids),
  int64, numpy for numpy input and a tensor on ``ids``' device for a
  tensor."""
  if isinstance(ids, torch.Tensor):
    ids = ids.long().reshape(-1)
    max_id = int(ids.max()) if ids.numel() else 0
    out = torch.zeros(max_id + 1, dtype=torch.int64, device=ids.device)
    out[ids] = torch.arange(ids.numel(), dtype=torch.int64,
                            device=ids.device)
    return out
  ids = np.asarray(ids).astype(np.int64)
  max_id = int(ids.max()) if ids.size else 0
  out = np.zeros(max_id + 1, dtype=np.int64)
  out[ids] = np.arange(ids.shape[0], dtype=np.int64)
  return out


def index_select(data: Any, index) -> Any:
  """Rows ``index`` of an array or tensor, or of each value of a dict of
  them (None stays None)."""
  if data is None:
    return None
  if isinstance(data, dict):
    return {k: index_select(v, index) for k, v in data.items()}
  if isinstance(data, torch.Tensor) and not isinstance(index, torch.Tensor):
    index = torch.as_tensor(np.asarray(index), device=data.device)
  return data[index]
