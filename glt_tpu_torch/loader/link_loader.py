"""LinkLoader / LinkNeighborLoader: edge-seeded mini-batches
(counterpart of glt_tpu/loader/link_loader.py).

Iterates the seed edges (positions into ``edge_label_index``, shuffled
and padded as NodeLoader pads seed nodes: a ragged last batch repeats
its last edge), samples the endpoints' neighbourhood with binary or
triplet negative sampling (``NeighborSampler.sample_from_edges``) and
yields Batches whose metadata carries ``edge_label_index`` and
``edge_label`` or the triplet indices, plus ``n_valid`` (the batch's real
edges). ``edge_label_index`` defaults to every edge of the graph. Over a
hetero dataset the seed edges are of one edge type, ``(edge_type,
array)`` or ``(edge_type, None)`` for all of its edges, and the loader
yields HeteroBatches: one feature gather a node type, the link labels
indexing each endpoint type's node list.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from ..data import Dataset
from ..data.feature import gather_features
from ..sampler import (EdgeSamplerInput, HeteroSamplerOutput,
                       NegativeSampling, NeighborSampler)
from ..utils import as_numpy
from .node_loader import NodeLoader
from .transform import Batch, HeteroBatch, to_batch, to_hetero_batch


def get_edge_label_index(data: Dataset, edge_label_index=None,
                         input_type=None):
  """``(input_type, [2, E] numpy array)`` of the seed edges: the given
  array (or ``(edge_type, array)``), else every edge of the graph (of the
  edge type, over a hetero dataset) as (src, dst) in its compressed
  order."""
  if isinstance(edge_label_index, tuple) \
      and not isinstance(edge_label_index[0], (np.ndarray, list,
                                               torch.Tensor)):
    input_type, edge_label_index = edge_label_index
  if data.is_hetero != (input_type is not None):
    raise ValueError('link seeds of a hetero dataset name their edge type, '
                     'a homogeneous dataset\'s none; got '
                     f'{input_type!r}')
  if edge_label_index is None:
    g = data.get_graph(input_type)
    ptr, other, _ = g.topo.to_coo()
    pair = (ptr, other) if g.layout == 'CSR' else (other, ptr)
    edge_label_index = torch.stack(pair)
  return input_type, as_numpy(edge_label_index)


class LinkLoader(NodeLoader):
  """Edge-seeded loader over a sampler with ``sample_from_edges``.

  Args:
    data: the Dataset (graph and node features).
    sampler: the sampler (LinkNeighborLoader builds a NeighborSampler).
    edge_label_index: the seed edges, [2, E] (default: every edge); over
      a hetero dataset ``(edge_type, [2, E] or None)``.
    edge_label: a label per seed edge (binary sampling appends zeros for
      the negatives; default: ones).
    neg_sampling: a :class:`NegativeSampling` (or its arguments), or None.
    batch_size, shuffle, drop_last, collect_features, rng: as NodeLoader.
  """

  def __init__(self, data: Dataset, sampler, edge_label_index=None,
               edge_label=None,
               neg_sampling: Optional[NegativeSampling] = None,
               batch_size: int = 512, shuffle: bool = False,
               drop_last: bool = False, collect_features: bool = True,
               rng: Optional[np.random.Generator] = None):
    input_type, eli = get_edge_label_index(data, edge_label_index)
    self.edge_rows = eli[0].astype(np.int64)
    self.edge_cols = eli[1].astype(np.int64)
    self.edge_label = as_numpy(edge_label)
    self.neg_sampling = NegativeSampling.cast(neg_sampling)
    super().__init__(data, sampler, np.arange(self.edge_rows.shape[0]),
                     batch_size=batch_size, shuffle=shuffle,
                     drop_last=drop_last, collect_features=collect_features,
                     rng=rng)
    # the seeds NodeLoader iterates are edge positions: the input type is
    # the edge type
    self.input_type = input_type

  def _make_batch(self, seed_idx: np.ndarray,
                  n_valid: int) -> Union[Batch, HeteroBatch]:
    label = (self.edge_label[seed_idx] if self.edge_label is not None
             else None)
    inputs = EdgeSamplerInput(self.edge_rows[seed_idx],
                              self.edge_cols[seed_idx], label,
                              input_type=self.input_type,
                              neg_sampling=self.neg_sampling)
    with record_function('sample.multihop'):
      out = self.sampler.sample_from_edges(inputs)
    if self.input_type is not None:
      return self._collate_hetero_link(out, n_valid)
    x = None
    if self.collect_features and self.data.node_features is not None:
      with record_function('gather.features'):
        x = gather_features(self.data.get_node_feature(), out.node)
    batch = to_batch(out, x=x, batch_size=self.batch_size)
    batch.metadata = dict(batch.metadata, n_valid=n_valid)
    return batch

  def _collate_hetero_link(self, out: HeteroSamplerOutput,
                           n_valid: int) -> HeteroBatch:
    """Per node type with a feature table, its rows (one ``gather_rows``
    launch a type), then the HeteroBatch with the link labels in its
    metadata (the JAX ``_collate_hetero_link``)."""
    x_dict = {}
    feats = self.data.node_features
    if self.collect_features and isinstance(feats, dict):
      with record_function('gather.features'):
        x_dict = {t: gather_features(feats[t], node)
                  for t, node in out.node.items() if t in feats}
    batch = to_hetero_batch(out, x_dict=x_dict, batch_size=self.batch_size)
    batch.metadata['n_valid'] = n_valid
    return batch


class LinkNeighborLoader(LinkLoader):
  """:class:`LinkLoader` over a :class:`NeighborSampler` of ``data.graph``
  with ``num_neighbors`` and ``seed``, in the dataset's ``edge_dir``, on
  ``device`` (default: the card)."""

  def __init__(self, data: Dataset, num_neighbors, edge_label_index=None,
               edge_label=None,
               neg_sampling: Optional[NegativeSampling] = None,
               batch_size: int = 512, shuffle: bool = False,
               drop_last: bool = False, collect_features: bool = True,
               seed: Optional[int] = None, device=None,
               rng: Optional[np.random.Generator] = None):
    sampler = NeighborSampler(data.graph, num_neighbors, device=device,
                              edge_dir=data.edge_dir, seed=seed)
    super().__init__(data, sampler, edge_label_index=edge_label_index,
                     edge_label=edge_label, neg_sampling=neg_sampling,
                     batch_size=batch_size, shuffle=shuffle,
                     drop_last=drop_last,
                     collect_features=collect_features, rng=rng)
