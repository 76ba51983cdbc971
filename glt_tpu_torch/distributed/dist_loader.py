"""DistNeighborLoader: epochs of node-seeded batches over the partitioned
sampler (counterpart of glt_tpu/distributed/dist_loader.py).

Every rank holds the seed lists of every rank (``input_nodes``, one a
rank, as the reference splits its training ids) and the same numpy
``rng``, so all ranks agree on the epoch's length and orders, as the JAX
loader's one process does; a rank then samples its own block, gathers
its nodes' (and edges') features through the exchange and returns its
own dict, where the JAX loader stacks the whole mesh's as ``[P, ...]``.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..utils import as_numpy
from .dist_feature import DistFeature
from .dist_graph import DistGraph
from .dist_neighbor_sampler import DistNeighborSampler


def seed_lists(per_rank, world: int) -> List[np.ndarray]:
  """Per-rank int64 seed (or edge) arrays from a list of ``world`` arrays
  or a stacked ``[world, ...]`` array."""
  if isinstance(per_rank, (list, tuple)):
    out = [as_numpy(s).astype(np.int64) for s in per_rank]
  else:
    arr = as_numpy(per_rank)
    out = [arr[p].astype(np.int64) for p in range(arr.shape[0])]
  if len(out) != world:
    raise ValueError(f'{len(out)} seed lists for {world} ranks')
  return out


def epoch_orders(rng: np.random.Generator, sizes: Sequence[int],
                 shuffle: bool) -> List[np.ndarray]:
  """Each rank's order of its seeds for one epoch (a permutation of each,
  drawn rank by rank from ``rng``, or the identity)."""
  return [rng.permutation(n) if shuffle else np.arange(n) for n in sizes]


def batch_count(n: int, batch_size: int, drop_last: bool) -> int:
  return n // batch_size if drop_last else -(-n // batch_size)


def padded_seed_block(seeds: Sequence[np.ndarray], orders, lo: int,
                      batch_size: int):
  """Seeds ``[world, batch_size]`` of the batch at ``lo`` (a short block
  padded with its last seed) and each rank's valid count."""
  world = len(seeds)
  out = np.zeros((world, batch_size), np.int64)
  n_valid = np.zeros(world, np.int32)
  for p in range(world):
    sel = orders[p][lo:lo + batch_size]
    n_valid[p] = sel.shape[0]
    if sel.shape[0]:
      chunk = seeds[p][sel]
      out[p, :sel.shape[0]] = chunk
      out[p, sel.shape[0]:] = chunk[-1]
  return out, n_valid


def node_features(feature: DistFeature, out: dict) -> torch.Tensor:
  """The sampled nodes' rows (zero past ``node_count``), one exchange."""
  node = out['node']
  valid = torch.arange(node.numel(), device=node.device) < out['node_count']
  return feature.lookup_local(node.clamp(min=0), valid)


class DistNeighborLoader:
  """Args:
    dist_graph / dist_feature: this rank's stores.
    num_neighbors: fanouts.
    input_nodes: every rank's seed list, ``[world, n]`` or a list of
      ``world`` arrays (the same on every rank).
    labels: optional ``[N]`` labels; ``y`` holds the batch's.
    batch_size: seeds a rank a batch.
    with_edge / edge_feature: sample edge ids (``edge``); with an edge
      store also ``edge_attr``.
    seed: seed of the sampler's generator; ``rng``: the numpy generator
      of the orders (default ``default_rng(0)``, as JAX's).

  Each batch is this rank's sampler output plus ``x``, ``y``,
  ``edge_attr`` and ``n_valid`` (its valid seeds).
  """

  def __init__(self, dist_graph: DistGraph, num_neighbors: Sequence[int],
               input_nodes, dist_feature: Optional[DistFeature] = None,
               labels=None, batch_size: int = 512, shuffle: bool = False,
               drop_last: bool = False, with_edge: bool = False,
               seed: Optional[int] = None,
               rng: Optional[np.random.Generator] = None,
               edge_feature: Optional[DistFeature] = None):
    self.sampler = DistNeighborSampler(
        dist_graph, num_neighbors,
        with_edge=with_edge or edge_feature is not None, seed=seed)
    self.mesh = dist_graph.mesh
    self.feature = dist_feature
    self.edge_feature = edge_feature
    self.labels = (None if labels is None else
                   torch.as_tensor(as_numpy(labels)).to(self.mesh.device))
    self.seeds = seed_lists(input_nodes, self.mesh.world)
    self.batch_size = int(batch_size)
    self.shuffle = shuffle
    self.drop_last = drop_last
    self.rng = rng or np.random.default_rng(0)

  def __len__(self):
    return batch_count(min(s.shape[0] for s in self.seeds), self.batch_size,
                       self.drop_last)

  def __iter__(self) -> Iterator[dict]:
    orders = epoch_orders(self.rng, [s.shape[0] for s in self.seeds],
                          self.shuffle)
    for it in range(len(self)):
      seeds, n_valid = padded_seed_block(self.seeds, orders,
                                         it * self.batch_size,
                                         self.batch_size)
      out = self.sampler.sample_from_nodes(seeds, n_valid)
      if self.feature is not None:
        out['x'] = node_features(self.feature, out)
      if self.edge_feature is not None:
        self.edge_feature.collate_edge_attr(out)
      if self.labels is not None:
        out['y'] = self.labels.index_select(0, out['batch'].clamp(min=0)
                                            .long())
      out['n_valid'] = int(n_valid[self.mesh.rank])
      yield out


#: the reference's name (distributed/dist_loader.py:46): node-seeded
#: loading is the generic entry, as in the JAX package
DistLoader = DistNeighborLoader
