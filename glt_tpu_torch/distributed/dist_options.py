"""Sampling worker options (counterpart of
glt_tpu/distributed/dist_options.py; the reference's
distributed/dist_options.py:26-292).

Three deployment modes:
  * Collocated — sampling inline in the training process.
  * Mp — sampling worker processes streaming batches to the training
    process through the shared-memory channel.
  * Remote — sampling runs inside server processes (server-client mode).

A worker samples on the card by default (JAX's sample on the host CPU).
``worker_concurrency`` and ``pin_memory`` are accepted and unused, as in
the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union


@dataclasses.dataclass
class _BasicDistSamplingWorkerOptions:
  num_workers: int = 1
  worker_concurrency: int = 4            # accepted, unused
  master_addr: Optional[str] = None
  master_port: Optional[int] = None
  rpc_timeout: float = 180.0


@dataclasses.dataclass
class CollocatedDistSamplingWorkerOptions(_BasicDistSamplingWorkerOptions):
  """Reference dist_options.py:119-147."""
  num_workers: int = 1


@dataclasses.dataclass
class MpDistSamplingWorkerOptions(_BasicDistSamplingWorkerOptions):
  """Reference dist_options.py:149-208."""
  channel_capacity_bytes: int = 256 * 1024 * 1024
  pin_memory: bool = False               # accepted, unused
  use_shm: bool = True                   # False: the mp.Queue channel


@dataclasses.dataclass
class RemoteDistSamplingWorkerOptions(_BasicDistSamplingWorkerOptions):
  """Reference dist_options.py:210-292.

  ``degrade_on_server_failure``: when a server's connection is lost
  past the rpc retry budget (or its circuit is open), the loader logs
  the dropout, records it in the fabric metrics/health, and finishes
  the epoch with the surviving servers instead of raising. Set False
  for fail-stop (the error propagates out of ``recv``)."""
  server_rank: Union[int, List[int], None] = None
  buffer_capacity_bytes: int = 256 * 1024 * 1024
  prefetch_size: int = 4
  worker_key: str = 'default'
  degrade_on_server_failure: bool = True
