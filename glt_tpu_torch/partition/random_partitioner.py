"""Random node partitioner (counterpart of
glt_tpu/partition/random_partitioner.py): ids assigned round-robin under
a seeded permutation, one permutation a node type."""
from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

from ..typing import NodeType
from .base import PartitionerBase


class RandomPartitioner(PartitionerBase):
  def __init__(self, *args, seed: int = 0, **kwargs):
    super().__init__(*args, **kwargs)
    self.seed = seed

  def _partition_node(self, ntype: Optional[NodeType] = None) -> np.ndarray:
    n = (self.num_nodes[ntype] if isinstance(self.num_nodes, dict)
         else self.num_nodes)
    # crc32, not hash(): Python's string hash is randomised per process
    rng = np.random.default_rng(
        self.seed if ntype is None
        else self.seed + zlib.crc32(ntype.encode()) % 9973)
    perm = rng.permutation(n)
    pb = np.empty(n, dtype=np.int32)
    pb[perm] = np.arange(n, dtype=np.int64) % self.num_parts
    return pb
