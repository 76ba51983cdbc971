"""The data-parallel mesh over a process group (counterpart of
glt_tpu/parallel/mesh.py).

The JAX package lays one ``'data'`` axis over the devices of a
``jax.sharding.Mesh``: its ``pmean`` is the gradient all-reduce and its
``all_to_all`` the feature exchange. Here the axis is the ranks of a
``torch.distributed`` process group, one process a card (NCCL on cards,
gloo on the CPU): the ``pmean`` is an ``all_reduce`` average and the
``all_to_all`` an ``all_to_all_single``. Without an initialised process
group the mesh is one rank and needs no launcher. The caller initialises
the group (address, world size and rank) and binds each process to its
card.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..utils import resolve_device


class Mesh:
  """The ranks of ``group`` (every rank of the default group, or this
  process alone when none is initialised) along one axis, and this
  rank's ``device``.

  Attributes: ``group``, ``world`` (ranks), ``rank`` (this process's
  place on the axis), ``device``, ``axis`` (``'data'``) and ``shape``
  (``{axis: world}``, as ``jax.sharding.Mesh.shape`` reads)."""

  def __init__(self, group=None, device=None, axis: str = 'data'):
    distributed = dist.is_available() and dist.is_initialized()
    if group is not None and not distributed:
      raise ValueError('a process group needs torch.distributed initialised')
    self.group = group
    self.world = dist.get_world_size(group) if distributed else 1
    self.rank = dist.get_rank(group) if distributed else 0
    self.device = resolve_device(device)
    self.axis = axis

  @property
  def shape(self) -> Dict[str, int]:
    return {self.axis: self.world}

  def __repr__(self) -> str:
    return (f'Mesh({self.axis}={self.world}, rank={self.rank}, '
            f'device={self.device})')


def make_mesh(num_devices: Optional[int] = None, axis_names=('data',),
              group=None, device=None) -> Mesh:
  """This process's mesh: the ranks of ``group`` (the default group when
  ``torch.distributed`` is initialised, else this process alone) and its
  card (default, raises without one) or ``device='cpu'``.
  ``num_devices``, when given, must equal the group's size: a process
  drives one card, so the axis is as wide as the group."""
  if len(axis_names) != 1:
    raise ValueError('the mesh has one axis')
  mesh = Mesh(group, device, axis_names[0])
  if num_devices is not None and int(num_devices) != mesh.world:
    raise ValueError(f'{num_devices} devices asked of a group of '
                     f'{mesh.world} ranks (one card a rank)')
  return mesh


def replicated(mesh: Mesh):
  """Placement of a whole tensor on every rank: ``replicated(mesh)(x)``
  is ``x`` on this rank's device."""
  return lambda x: torch.as_tensor(x).to(mesh.device)


def row_sharded(mesh: Mesh):
  """Placement of a row-sharded tensor: ``row_sharded(mesh)(x)`` is this
  rank's block of ``ceil(len(x) / world)`` rows (the last block shorter
  when the rows do not divide), on this rank's device."""
  def place(x):
    x = torch.as_tensor(x)
    per = -(-x.shape[0] // mesh.world)
    return x[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)
  return place
