"""DistDataset: a Dataset holding one partition plus its partition books
(counterpart of glt_tpu/distributed/dist_dataset.py).

``load`` reads one partition of the on-disk layout
(``glt_tpu_torch.partition``): its edges become this dataset's graph (an
edge type a graph for a hetero layout, over the global node counts), its
feature rows a :class:`~glt_tpu_torch.data.Feature` whose ``id2index``
maps a global id to its row (-1 for an id another partition holds), its
edge feature rows (``edge_feat.npz``) likewise over global edge ids, and
the books route ids to their owners. Not ported: hot-cache rows
(``cat_feature_cache``) and ``DistTableDataset`` (ROADMAP A12).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data import Dataset, Feature
from ..partition import TablePartitionBook, load_partition
from ..typing import EdgeType, FeaturePartitionData, NodeType


def _partition_feature(f: FeaturePartitionData, pb: TablePartitionBook,
                       dtype, device) -> Feature:
  """A partition's rows as a Feature with its global id -> row map."""
  if f.cache_ids is not None and len(f.cache_ids):
    raise NotImplementedError('hot-cache rows in a partition are not ported')
  ids = f.ids
  max_id = int(ids.max()) + 1 if ids.size else 0
  id2index = np.full(max(max_id, pb.table.shape[0]), -1, np.int64)
  id2index[ids] = np.arange(ids.shape[0])
  return Feature(f.feats, id2index=id2index, dtype=dtype, device=device)


class DistDataset(Dataset):
  """One partition of a partitioned dataset: its graph, its node and
  edge feature rows, ``num_partitions``, ``partition_idx`` and the
  partition books (``node_pb`` and ``edge_pb``: one, or a dict keyed by
  node or edge type), which also route the feature rows (a partition
  holds no hot-cache rows). Build one with :meth:`load`."""

  @classmethod
  def load(cls, root_dir: str, partition_idx: int,
           feature_dtype: Optional[torch.dtype] = None,
           device=None) -> 'DistDataset':
    """Partition ``partition_idx`` of ``root_dir`` on ``device`` (default:
    the card): its graph, its node and edge features (cast to
    ``feature_dtype``) and the books."""
    meta, graph, nfeat, efeat, node_pb, edge_pb = load_partition(
        root_dir, partition_idx)
    ds = cls(edge_dir=meta.get('edge_dir', 'out'))
    ds.num_partitions = meta['num_parts']
    ds.partition_idx = partition_idx
    ds.node_pb = node_pb
    ds.edge_pb = edge_pb
    ds.edge_features = None
    if meta['data_cls'] == 'hetero':
      if any(g.weights is not None for g in graph.values()):
        raise NotImplementedError('hetero edge weights are not ported')
      ds.init_graph(edge_index={e: g.edge_index for e, g in graph.items()},
                    edge_ids={e: g.eids for e, g in graph.items()},
                    num_nodes={nt: pb.table.shape[0]
                               for nt, pb in node_pb.items()},
                    device=device)
      if nfeat:
        ds.node_features = {
            nt: _partition_feature(f, node_pb[nt], feature_dtype, device)
            for nt, f in nfeat.items()}
      if efeat:
        ds.edge_features = {
            e: _partition_feature(f, edge_pb[e], feature_dtype, device)
            for e, f in efeat.items()}
    else:
      ds.init_graph(edge_index=graph.edge_index, edge_ids=graph.eids,
                    edge_weights=graph.weights,
                    num_nodes=node_pb.table.shape[0], device=device)
      if nfeat is not None:
        ds.node_features = _partition_feature(nfeat, node_pb,
                                              feature_dtype, device)
      if efeat is not None:
        ds.edge_features = _partition_feature(efeat, edge_pb,
                                              feature_dtype, device)
    return ds

  def get_node_pb(self, ntype: Optional[NodeType] = None):
    if isinstance(self.node_pb, dict) and ntype is not None:
      return self.node_pb[ntype]
    return self.node_pb

  get_node_feat_pb = get_node_pb

  def get_edge_feature(self, etype: Optional[EdgeType] = None):
    """The edge feature rows (of ``etype`` for a hetero layout), or
    None."""
    if isinstance(self.edge_features, dict):
      return self.edge_features.get(etype)
    return self.edge_features

  def get_edge_feat_pb(self, etype: Optional[EdgeType] = None):
    """The edge partition book (one an edge type for a hetero layout),
    which routes the edge feature rows."""
    if isinstance(self.edge_pb, dict) and etype is not None:
      return self.edge_pb[etype]
    return self.edge_pb
