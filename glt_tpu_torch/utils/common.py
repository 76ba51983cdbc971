"""Helpers shared across the port (counterpart of glt_tpu/utils/common.py
and the ``as_numpy`` of glt_tpu/utils/tensor.py)."""
from __future__ import annotations

import random
from typing import Dict, Optional, Union

import numpy as np
import torch


def as_numpy(x) -> Optional[np.ndarray]:
  """Array-like (numpy, tensor on any device, list) -> numpy; None stays
  None."""
  if x is None:
    return None
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def seed_everything(seed: int) -> None:
  """Seed python's ``random``, numpy's global state, torch's default
  generators and the port's :class:`~glt_tpu_torch.utils.rng.
  RandomSeedManager` (glt_tpu/utils/common.py:10; the JAX package has no
  global torch state to seed, the reference's seeds torch too)."""
  random.seed(seed)
  np.random.seed(seed)
  torch.manual_seed(seed)
  from .rng import RandomSeedManager
  RandomSeedManager.getInstance().setSeed(seed)


def merge_dict(in_dict: Dict, out_dict: Dict) -> Dict:
  """Append each value of ``in_dict`` to the list ``out_dict`` keeps under
  its key (a new list for a new key); returns ``out_dict``."""
  for k, v in in_dict.items():
    vals = out_dict.get(k, [])
    vals.append(v)
    out_dict[k] = vals
  return out_dict


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
  """The device an entry point runs on: the caller's, else the card.
  Without a card and without an explicit device this raises -- the port
  never carries on on the CPU unasked. A bare ``'cuda'`` resolves to the
  current card's index, so it compares equal to a tensor's device."""
  if device is not None:
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
      device = torch.device('cuda', torch.cuda.current_device())
    return device
  if not torch.cuda.is_available():
    raise RuntimeError(
        'no CUDA device: pass device="cpu" to run the plain PyTorch path')
  return torch.device('cuda', torch.cuda.current_device())


_UNITS = {
    'k': 1024, 'm': 1024 ** 2, 'g': 1024 ** 3, 't': 1024 ** 4,
    'kb': 1024, 'mb': 1024 ** 2, 'gb': 1024 ** 3, 'tb': 1024 ** 4,
}


def parse_size(size: object) -> int:
  """A byte count from an int or a string such as ``'10GB'`` or ``'1.5m'``
  (binary units, case-insensitive; glt_tpu/utils/common.py:35)."""
  if isinstance(size, (int, np.integer)):
    return int(size)
  s = str(size).strip().lower()
  num, unit = s, ''
  for i, ch in enumerate(s):
    if not (ch.isdigit() or ch == '.'):
      num, unit = s[:i], s[i:].strip()
      break
  if unit and unit not in _UNITS:
    raise ValueError(f'unknown size unit {unit!r}')
  return int(float(num) * _UNITS.get(unit, 1))
