"""Training checkpoint and resume (counterpart of
glt_tpu/utils/checkpoint.py, with its signatures and return values).

A checkpoint is one step directory ``<ckpt_dir>/<step>/`` holding
``payload.pt``: ``{'params': ..., 'opt_state': ..., 'extra': ...}`` (the
last two when given) written by ``torch.save`` and read back by
``torch.load(weights_only=True)``, so a payload holds tensors, numbers,
strings and containers of them. At most ``max_to_keep`` step directories
stay; older ones are removed after a save. The JAX package's orbax
checkpoints are not read here: its parameters come across through
:mod:`glt_tpu_torch.models.convert`.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, List, Optional

import torch

_PAYLOAD = 'payload.pt'


def _steps(ckpt_dir: str) -> List[int]:
  """The steps saved under ``ckpt_dir``, ascending."""
  if not os.path.isdir(ckpt_dir):
    return []
  return sorted(int(d) for d in os.listdir(ckpt_dir)
                if d.isdigit() and os.path.isfile(
                    os.path.join(ckpt_dir, d, _PAYLOAD)))


def save_checkpoint(ckpt_dir: str, step: int, params: Any,
                    opt_state: Any = None, extra: Any = None,
                    max_to_keep: int = 3) -> None:
  ckpt_dir = os.path.abspath(ckpt_dir)
  os.makedirs(ckpt_dir, exist_ok=True)
  payload = {'params': params}
  if opt_state is not None:
    payload['opt_state'] = opt_state
  if extra is not None:
    payload['extra'] = extra
  # written beside the step directory, then renamed into place: a reader
  # never sees a half-written step
  tmp = tempfile.mkdtemp(prefix=f'.{int(step)}.', dir=ckpt_dir)
  try:
    torch.save(payload, os.path.join(tmp, _PAYLOAD))
    final = os.path.join(ckpt_dir, str(int(step)))
    if os.path.isdir(final):
      shutil.rmtree(final)
    os.rename(tmp, final)
  except BaseException:
    shutil.rmtree(tmp, ignore_errors=True)
    raise
  for old in _steps(ckpt_dir)[:-max(int(max_to_keep), 1)]:
    shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       template: Any = None):
  """Returns (step, payload dict), or (None, None) when nothing is saved.
  ``template`` (a matching tree of tensors) casts every restored tensor
  to its counterpart's dtype and device when given."""
  ckpt_dir = os.path.abspath(ckpt_dir)
  if step is None:
    steps = _steps(ckpt_dir)
    if not steps:
      return None, None
    step = steps[-1]
  out = torch.load(os.path.join(ckpt_dir, str(int(step)), _PAYLOAD),
                   map_location='cpu', weights_only=True)
  if template is not None:
    out = _like(out, template)
  return step, out


def _like(tree, template):
  """``tree`` with each tensor cast to its ``template`` counterpart's
  dtype and device (entries the template lacks pass through)."""
  if isinstance(tree, torch.Tensor) and isinstance(template, torch.Tensor):
    return tree.to(dtype=template.dtype, device=template.device)
  if isinstance(tree, dict) and isinstance(template, dict):
    return {k: _like(v, template[k]) if k in template else v
            for k, v in tree.items()}
  if isinstance(tree, (list, tuple)) and isinstance(template, (list, tuple)):
    return type(tree)(_like(v, t) for v, t in zip(tree, template))
  return tree
