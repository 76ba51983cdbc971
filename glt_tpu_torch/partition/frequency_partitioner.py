"""Frequency (hotness) partitioner (counterpart of
glt_tpu/partition/frequency_partitioner.py): each partition's access
probabilities (``NeighborSampler.sample_prob`` over its training seeds)
drive a greedy chunked assignment of the nodes to the partitions that
want them most, and each partition then caches its hottest rows of other
partitions under a budget (``_cache_node``). numpy on the host; the files
it writes are the JAX partitioner's, byte for byte.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

from ..typing import NodeType
from ..utils import as_numpy, parse_size
from .base import PartitionerBase


class FrequencyPartitioner(PartitionerBase):
  """A :class:`PartitionerBase` over access probabilities.

  Args beyond the base's:
    probs: ``[num_parts, num_nodes]`` access probabilities, row p from
      partition p's training seeds (a dict of them by node type for a
      hetero graph); arrays or tensors.
    cache_ratio: a partition caches up to ``num_nodes * cache_ratio`` rows
      it does not own, its hottest with a probability above 0.
    cache_memory_budget: bytes (an int or a string such as ``'1GB'``) a
      partition may spend on cached rows, counted in feature rows; with a
      ratio too, the smaller count wins.
  """

  def __init__(self, *args, probs=None, cache_ratio: float = 0.0,
               cache_memory_budget: Union[int, str, None] = None,
               **kwargs):
    super().__init__(*args, **kwargs)
    if probs is None:
      raise ValueError('FrequencyPartitioner needs probs')
    self.probs = probs
    self.cache_ratio = float(cache_ratio)
    self.cache_memory_budget = cache_memory_budget
    self._pb_cache: Dict = {}

  def _get_probs(self, ntype) -> np.ndarray:
    p = self.probs[ntype] if isinstance(self.probs, dict) else self.probs
    return np.stack([as_numpy(row) for row in p])

  def _partition_node(self, ntype: Optional[NodeType] = None) -> np.ndarray:
    """Chunk by chunk, preference rank by rank, each partition takes its
    hottest still free candidates that prefer it, up to a balanced
    capacity of ``ceil(N / P)``; the leftovers fill the spare capacity,
    least loaded partition first (frequency_partitioner.py:56-99)."""
    if ntype in self._pb_cache:
      return self._pb_cache[ntype]
    probs = self._get_probs(ntype)          # [P, N]
    num_parts, n = probs.shape
    if num_parts != self.num_parts:
      raise ValueError(f'probs has {num_parts} rows for {self.num_parts} '
                       'partitions')
    pb = np.full(n, -1, dtype=np.int32)
    capacity = int(np.ceil(n / num_parts))
    sizes = np.zeros(num_parts, dtype=np.int64)
    for lo in range(0, n, self.chunk_size):
      hi = min(lo + self.chunk_size, n)
      chunk = probs[:, lo:hi]               # [P, C]
      order = np.argsort(-chunk, axis=0)    # partitions by desire
      assigned = np.zeros(hi - lo, dtype=bool)
      for rank in range(num_parts):
        pref = order[rank]
        for p in range(num_parts):
          room = capacity - sizes[p]
          if room <= 0:
            continue
          cand = np.nonzero((pref == p) & ~assigned)[0]
          if cand.size == 0:
            continue
          take = cand[np.argsort(-chunk[p, cand], kind='stable')[:room]]
          pb[lo + take] = p
          assigned[take] = True
          sizes[p] += take.shape[0]
      left = np.nonzero(~assigned)[0]
      if left.size:
        spare = np.maximum(capacity - sizes, 0)
        while spare.sum() < left.size:      # all full: grow evenly
          spare += 1
        by_load = np.argsort(sizes, kind='stable')
        targets = np.repeat(by_load, spare[by_load])
        targets = targets[:left.size].astype(np.int32)
        pb[lo + left] = targets
        np.add.at(sizes, targets, 1)
    self._pb_cache[ntype] = pb
    return pb

  def _cache_node(self, ntype: Optional[NodeType] = None
                  ) -> Optional[List[np.ndarray]]:
    """Per partition its cached ids: the hottest rows it does not own,
    probability above 0, at most the ratio's or the budget's count
    (frequency_partitioner.py:101-120)."""
    probs = self._get_probs(ntype)
    n = probs.shape[1]
    cache_num = int(n * self.cache_ratio)
    if self.cache_memory_budget:
      feat = as_numpy(self.node_feat.get(ntype)
                      if isinstance(self.node_feat, dict)
                      else self.node_feat)
      if feat is not None and feat.shape[0]:
        budget_num = int(parse_size(self.cache_memory_budget)
                         // max(feat[0].nbytes, 1))
        # the byte budget is an upper bound: the smaller count wins
        cache_num = min(cache_num, budget_num) if cache_num else budget_num
    cache_num = min(cache_num, n)
    if cache_num <= 0:
      return None
    pb = self._partition_node(ntype)
    out = []
    for p in range(self.num_parts):
      score = probs[p].copy()
      score[pb == p] = -1.0                 # owned rows need no cache
      hot = np.argsort(-score)[:cache_num]
      out.append(hot[score[hot] > 0])
    return out
