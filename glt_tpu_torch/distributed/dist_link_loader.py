"""DistLinkNeighborLoader: edge-seeded batches over the partitioned
sampler (counterpart of glt_tpu/distributed/dist_link_loader.py).

Each rank seeds the endpoints of its edge batch (positives, then
negatives) into the partitioned sampler; the seed labels give
``edge_label_index`` (binary) or ``src_index`` / ``dst_pos_index`` /
``dst_neg_index`` (triplet). Non-strict negatives are uniform global
pairs from the loader's numpy ``rng``, drawn for every rank in turn as
the JAX loader draws them; ``NegativeSampling(strict=True)`` takes them
from :class:`~glt_tpu_torch.distributed.DistRandomNegativeSampler`,
strict across every partition. As :class:`DistNeighborLoader` does, a
rank returns its own dict.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..sampler.base import NegativeSampling
from ..utils import as_numpy
from .dist_feature import DistFeature
from .dist_graph import DistGraph
from .dist_loader import batch_count, epoch_orders, node_features
from .dist_negative import DistRandomNegativeSampler
from .dist_neighbor_sampler import DistNeighborSampler

#: proposal rounds of a strict negative (the JAX loader's)
STRICT_TRIALS = 5


class DistLinkNeighborLoader:
  """Args:
    dist_graph / dist_feature: this rank's stores.
    num_neighbors: fanouts.
    edge_label_index_per_device: every rank's ``[2, E_p]`` edge seed pool
      in (src, dst) orientation, a list of ``world`` (the same on every
      rank).
    neg_sampling: binary or triplet, strict or not.
    batch_size: positive edges a rank a batch.
    seed: seed of the samplers' generators; ``rng``: the numpy generator
      of the orders and non-strict negatives (default
      ``default_rng(seed or 0)``, as JAX's).
    edge_feature / with_edge: as for :class:`DistNeighborLoader`.
  """

  def __init__(self, dist_graph: DistGraph, num_neighbors: Sequence[int],
               edge_label_index_per_device,
               dist_feature: Optional[DistFeature] = None,
               neg_sampling: Optional[NegativeSampling] = None,
               batch_size: int = 256, shuffle: bool = False,
               drop_last: bool = False, seed: Optional[int] = None,
               rng: Optional[np.random.Generator] = None,
               edge_feature: Optional[DistFeature] = None,
               with_edge: bool = False):
    self.g = dist_graph
    self.mesh = dist_graph.mesh
    self.edges = [as_numpy(e).astype(np.int64)
                  for e in edge_label_index_per_device]
    if len(self.edges) != self.mesh.world:
      raise ValueError(f'{len(self.edges)} edge pools for '
                       f'{self.mesh.world} ranks')
    self.neg_sampling = NegativeSampling.cast(neg_sampling)
    self.batch_size = int(batch_size)
    self.shuffle = shuffle
    self.drop_last = drop_last
    self.rng = rng or np.random.default_rng(seed or 0)
    ns = self.neg_sampling
    self.num_neg = ns.sample_size(self.batch_size) if ns else 0
    if ns and ns.is_binary():
      self.seeds_per_device = 2 * (self.batch_size + self.num_neg)
    elif ns:
      self.seeds_per_device = 2 * self.batch_size + self.num_neg
    else:
      self.seeds_per_device = 2 * self.batch_size
    self.sampler = DistNeighborSampler(
        dist_graph, num_neighbors,
        with_edge=with_edge or edge_feature is not None, seed=seed)
    self.strict_neg = (DistRandomNegativeSampler(
        dist_graph, trials_num=STRICT_TRIALS, padding=True, seed=seed)
        if ns and ns.strict and self.num_neg else None)
    self.feature = dist_feature
    self.edge_feature = edge_feature

  def __len__(self):
    return batch_count(min(e.shape[1] for e in self.edges), self.batch_size,
                       self.drop_last)

  def _positives(self, p: int, orders, lo: int):
    """Rank p's positive (src, dst) of the batch at ``lo`` (a short batch
    padded with its last edge), or None for an empty one."""
    sel = orders[p][lo:lo + self.batch_size]
    if sel.shape[0] == 0:
      return None
    sel = np.concatenate([sel, np.full(self.batch_size - sel.shape[0],
                                       sel[-1])])
    return self.edges[p][0][sel], self.edges[p][1][sel]

  def strict_negatives(self, src: Optional[np.ndarray]):
    """This rank's strict negatives (dist_link_loader.py:101): free pairs
    (binary) or a dst for each of ``src``, the batch's own sources
    repeated ``amount`` times each (triplet). Returns (rows, cols)."""
    if self.neg_sampling.is_binary():
      neg = self.strict_neg.sample(self.num_neg)
    else:
      neg = self.strict_neg.sample_dst(src)
    return neg.rows.cpu().numpy(), neg.cols.cpu().numpy()

  def _strict_sources(self, orders, lo: int) -> np.ndarray:
    """Triplet mode: this rank's batch sources, ``amount`` consecutive
    lanes each (the layout of ``dst_neg_index``'s [bs, amount])."""
    pos = self._positives(self.mesh.rank, orders, lo)
    if pos is None:
      return np.zeros(self.num_neg, np.int64)
    amount = max(self.num_neg // max(self.batch_size, 1), 1)
    return np.repeat(pos[0], amount)[:self.num_neg]

  def _make_seeds(self, lo: int, orders, strict):
    """This rank's seed endpoints and its count of real positives (0 for
    an empty batch). The non-strict negatives of every rank come from
    ``rng`` in turn, as the JAX loader draws them."""
    bs, num_neg, me = self.batch_size, self.num_neg, self.mesh.rank
    ns = self.neg_sampling
    mine, n_pos = np.zeros(self.seeds_per_device, np.int64), 0
    for p in range(self.mesh.world):
      pos = self._positives(p, orders, lo)
      if pos is None:
        continue
      src, dst = pos
      if ns and ns.is_binary():
        if strict is not None:
          neg_s, neg_d = strict if p == me else (None, None)
        else:
          neg_s = self.rng.integers(0, self.g.num_nodes, num_neg)
          neg_d = self.rng.integers(0, self.g.num_nodes, num_neg)
        parts = (src, neg_s, dst, neg_d)
      elif ns:
        neg_d = (strict[1] if p == me else None) if strict is not None \
            else self.rng.integers(0, self.g.num_nodes, num_neg)
        parts = (src, dst, neg_d)
      else:
        parts = (src, dst)
      if p == me:
        mine = np.concatenate(parts)
        n_pos = orders[p][lo:lo + bs].shape[0]
    return mine, n_pos

  def __iter__(self) -> Iterator[dict]:
    orders = epoch_orders(self.rng, [e.shape[1] for e in self.edges],
                          self.shuffle)
    bs, num_neg, me = self.batch_size, self.num_neg, self.mesh.rank
    ns = self.neg_sampling
    for it in range(len(self)):
      lo = it * bs
      strict = None
      if self.strict_neg is not None:
        src = self._strict_sources(orders, lo) if ns.is_triplet() else None
        strict = self.strict_negatives(src)
      mine, n_pos = self._make_seeds(lo, orders, strict)
      seeds = np.zeros((self.mesh.world, self.seeds_per_device), np.int64)
      seeds[me] = mine
      n_valid = np.zeros(self.mesh.world, np.int32)
      n_valid[me] = self.seeds_per_device if n_pos else 0
      out = self.sampler.sample_from_nodes(seeds, n_valid)
      inv = out['seed_labels']
      if ns is None or ns.is_binary():
        half = bs + (num_neg if ns else 0)
        out['edge_label_index'] = torch.stack([inv[:half], inv[half:]])
        label = torch.zeros(half, dtype=torch.float32, device=inv.device)
        label[:bs] = 1.0
        out['edge_label'] = label
      else:
        out['src_index'] = inv[:bs]
        out['dst_pos_index'] = inv[bs:2 * bs]
        neg = inv[2 * bs:]
        out['dst_neg_index'] = (neg.reshape(bs, -1)
                                if num_neg // max(bs, 1) > 1 else neg)
      if self.feature is not None:
        out['x'] = node_features(self.feature, out)
      if self.edge_feature is not None:
        self.edge_feature.collate_edge_attr(out)
      out['n_pos'] = n_pos
      yield out
