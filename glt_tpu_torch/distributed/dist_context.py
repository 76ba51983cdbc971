"""Distributed roles and this process's context (counterpart of
glt_tpu/distributed/dist_context.py; the reference's
distributed/dist_context.py: DistRole WORKER/SERVER/CLIENT groups with
local and global ranks, init_worker_group, assign_server_by_order).

A worker group takes its world size and rank from the default
``torch.distributed`` group when one exists (JAX: the process count and
index), else from the caller, else 1 and 0.
"""
from __future__ import annotations

import enum
from typing import Optional


class DistRole(enum.Enum):
  WORKER = 1    # collocated sampling + training (worker mode)
  SERVER = 2    # sampling/feature service (server-client mode)
  CLIENT = 3    # training client


class DistContext:
  def __init__(self, role: DistRole, world_size: int, rank: int,
               group_name: str = 'default',
               global_world_size: Optional[int] = None,
               global_rank: Optional[int] = None):
    self.role = role
    self.world_size = int(world_size)
    self.rank = int(rank)
    self.group_name = group_name
    self.global_world_size = (int(global_world_size)
                              if global_world_size is not None
                              else self.world_size)
    self.global_rank = (int(global_rank) if global_rank is not None
                        else self.rank)

  @property
  def is_worker(self) -> bool:
    return self.role == DistRole.WORKER

  @property
  def is_server(self) -> bool:
    return self.role == DistRole.SERVER

  @property
  def is_client(self) -> bool:
    return self.role == DistRole.CLIENT

  def __repr__(self):
    return (f'DistContext(role={self.role.name}, rank={self.rank}/'
            f'{self.world_size}, group={self.group_name!r})')


_context: Optional[DistContext] = None


def get_context() -> Optional[DistContext]:
  return _context


def init_worker_group(world_size: Optional[int] = None,
                      rank: Optional[int] = None,
                      group_name: str = 'worker') -> DistContext:
  """Reference dist_context.py init_worker_group: establish this process's
  role group. With no explicit ranks, adopt the default torch.distributed
  group's (world 1, rank 0 without one)."""
  global _context
  if world_size is None or rank is None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
      world_size, rank = dist.get_world_size(), dist.get_rank()
    else:
      world_size, rank = 1, 0
  _context = DistContext(DistRole.WORKER, world_size, rank, group_name)
  return _context


def init_server_context(num_servers: int, num_clients: int, rank: int,
                        group_name: str = 'server') -> DistContext:
  global _context
  _context = DistContext(
      DistRole.SERVER, num_servers, rank, group_name,
      global_world_size=num_servers + num_clients, global_rank=rank)
  return _context


def init_client_context(num_servers: int, num_clients: int, rank: int,
                        group_name: str = 'client') -> DistContext:
  global _context
  _context = DistContext(
      DistRole.CLIENT, num_clients, rank, group_name,
      global_world_size=num_servers + num_clients,
      global_rank=num_servers + rank)
  return _context


def shutdown() -> None:
  global _context
  _context = None


def assign_server_by_order(client_rank: int, num_servers: int,
                           num_clients: int):
  """Round-robin client -> server mapping (reference
  dist_context.py:174-196)."""
  if num_clients >= num_servers:
    per = num_clients // num_servers
    return [min(client_rank // max(per, 1), num_servers - 1)]
  per = num_servers // num_clients
  lo = client_rank * per
  hi = num_servers if client_rank == num_clients - 1 else lo + per
  return list(range(lo, hi))
