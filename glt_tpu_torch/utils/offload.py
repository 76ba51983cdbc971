"""Host-offload placement of a split feature store's cold rows
(counterpart of glt_tpu/utils/offload.py).

Spilled cold rows default to pinned host memory that the card reads in
place, over the host link (the UVA read of the reference's
UnifiedTensor): :func:`pin_host` page-locks a CPU tensor at its exact
size, maps it and returns the :class:`PinnedHost` that owns the mapping,
which the feature gather's kernel reads. A store opts out with
``host_offload=False`` and then gathers its cold rows on the host.

Unlike the JAX package there is no automatic demotion to that host phase
when pinning fails (``maybe_pin_host``), and no ``GLT_HOST_OFFLOAD``
switch: a store pins whenever rows spill unless told otherwise, and a
refused pin or map raises.
"""
from __future__ import annotations

import weakref

import torch

from ..ops.build import lazy_entry
from .common import resolve_device

glt_host_register = lazy_entry(globals(), 'glt_host_register')
glt_host_unregister = lazy_entry(globals(), 'glt_host_unregister')


class PinnedHost:
  """A contiguous CPU ``tensor`` page-locked in place and mapped for the
  card ``device`` at the device ``address`` of its first byte (0 for an
  empty tensor, which maps nothing). The block stays mapped while this
  object lives; when it goes, the card finishes the work already queued
  on it before the block is unmapped, and only then may the tensor's
  memory be freed."""

  __slots__ = ('tensor', 'address', 'device', '__weakref__')

  def __init__(self, tensor: torch.Tensor, address: int,
               device: torch.device):
    self.tensor, self.address, self.device = tensor, address, device

  @property
  def shape(self):
    return self.tensor.shape


def pin_host(t: torch.Tensor, device: torch.device) -> PinnedHost:
  """Page-locks the bytes of the contiguous CPU tensor ``t`` in place
  (its exact size, no copy) and maps them for the card ``device``;
  returns the owner of the mapping. Raises when CUDA refuses either step:
  nothing falls back to a device copy or to the host phase."""
  if t.device.type != 'cpu' or not t.is_contiguous():
    raise ValueError('pin_host takes a contiguous CPU tensor')
  device = resolve_device(device)
  if device.type != 'cuda':
    raise ValueError(f'pin_host maps for a card, got {device}')
  nbytes = t.numel() * t.element_size()
  if nbytes == 0:
    return PinnedHost(t, 0, device)
  ptr = t.data_ptr()
  address = torch.zeros(1, dtype=torch.int64)
  err = glt_host_register(ptr, nbytes, address.data_ptr(), device.index)
  if err != 0:
    raise RuntimeError(f'pinning and mapping {nbytes} bytes of host memory '
                       f'for {device} failed with CUDA error {err}')
  owner = PinnedHost(t, int(address), device)
  # the finalizer holds t, so its memory outlives the mapping; at exit
  # the process's memory goes anyway
  weakref.finalize(owner, _unpin, t, device).atexit = False
  return owner


def _unpin(t: torch.Tensor, device: torch.device) -> None:
  # kernels launched against the block, on any stream, end first
  torch.cuda.synchronize(device)
  glt_host_unregister(t.data_ptr(), device.index)
