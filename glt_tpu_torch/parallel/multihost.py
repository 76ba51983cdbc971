"""Process-group bootstrap for runs across hosts (counterpart of
glt_tpu/parallel/multihost.py).

The JAX package joins one process a host into ``jax.distributed`` and
fuses their devices into one global mesh. The port runs one process a
card in a ``torch.distributed`` group, so :func:`initialize` starts that
group: from explicit arguments, from the environment ``torchrun`` sets
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), or not at all
on a plain single process (logged at debug level). The stores a rank then
builds hold only its own partition
(``distributed.dist_graph_from_partitions_multihost`` and the hetero and
feature builders beside it).

``global_from_local`` has no counterpart: it assembles a global sharded
array from each process's blocks, and a rank of the port already holds
exactly its own block.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

#: the variables torchrun (and the elastic launcher) sets for each process
_TORCHRUN_ENVS = ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE')


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
  """Start this process's ``torch.distributed`` group.

  Given any argument, ``init_process_group`` runs with them:
  ``coordinator_address`` (``host:port``, or a full ``init_method`` URL)
  as the rendezvous, ``num_processes`` as the world size and
  ``process_id`` as the rank. Given none, it runs from the environment
  when torchrun's variables are all set, and otherwise does nothing (a
  single process needs no group). The backend is NCCL when a card is
  present, gloo otherwise."""
  backend = 'nccl' if torch.cuda.is_available() else 'gloo'
  if (coordinator_address is not None or num_processes is not None
      or process_id is not None):
    init = coordinator_address
    if init is not None and '://' not in init:
      init = f'tcp://{init}'
    dist.init_process_group(backend, init_method=init,
                            world_size=-1 if num_processes is None
                            else int(num_processes),
                            rank=-1 if process_id is None else int(process_id))
    return
  if all(os.environ.get(k) for k in _TORCHRUN_ENVS):
    dist.init_process_group(backend)
    return
  logger.debug('multihost.initialize: no cluster environment detected; '
               'running single-process')
