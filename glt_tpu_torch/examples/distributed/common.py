"""The ranks, the device and the partition directory the distributed
examples share."""
from __future__ import annotations

import os
import shutil
import tempfile
from contextlib import contextmanager

import torch
import torch.distributed as dist


def init_rank(device_arg):
  """``(world, rank, device)`` of this process: torchrun's group when
  ``WORLD_SIZE`` > 1 (gloo on the CPU, NCCL on cards), this rank's card
  (default; raises without one) or the CPU."""
  world = int(os.environ.get('WORLD_SIZE', '1'))
  on_cpu = device_arg == 'cpu'
  if world > 1 and not dist.is_initialized():
    dist.init_process_group('gloo' if on_cpu else 'nccl')
  rank = dist.get_rank() if world > 1 else 0
  if device_arg is not None:
    device = torch.device(device_arg)
  elif torch.cuda.is_available():
    device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', '0')))
  else:
    raise SystemExit('no CUDA device: pass --device cpu to train on the CPU')
  if device.type == 'cuda':
    torch.cuda.set_device(device)
  return world, rank, device


@contextmanager
def partition_dir(world: int, rank: int, prefix: str, write):
  """A temporary directory that rank 0 makes and fills with ``write(root)``
  while the others wait; every rank gets its path, and rank 0 removes it
  at the end."""
  root = tempfile.mkdtemp(prefix=prefix) if rank == 0 else None
  if world > 1:
    box = [root]
    dist.broadcast_object_list(box, src=0)
    root = box[0]
  try:
    if rank == 0:
      write(root)
    if world > 1:
      dist.barrier()
    yield root
  finally:
    if world > 1:
      dist.barrier()
    if rank == 0:
      shutil.rmtree(root, ignore_errors=True)
