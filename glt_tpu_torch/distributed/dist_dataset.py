"""DistDataset: a Dataset holding one partition plus its partition books
(counterpart of glt_tpu/distributed/dist_dataset.py).

``load`` reads one partition of the on-disk layout
(``glt_tpu_torch.partition``): its edges, with their weights, become this
dataset's graph (an edge type a graph for a hetero layout, over the global
node counts), its feature rows a :class:`~glt_tpu_torch.data.Feature`
whose ``id2index`` maps a global id to its row (-1 for an id this
partition holds no row of), its edge feature rows (``edge_feat.npz``)
likewise over global edge ids, and the books route ids to their owners.
A partition's hot-cache rows (``cache_ids``, written by a
``FrequencyPartitioner`` or ``build_partition_feature``) come first in
its table (``cat_feature_cache``), and its feature books
(``node_feat_pb``/``edge_feat_pb``) route its cached ids to itself, so a
:class:`~glt_tpu_torch.distributed.DistFeature` built from it answers
them at its own rank. :class:`DistTableDataset` partitions table slices
online (``dist_random_partitioner.py``) and loads this rank's partition.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..data import Dataset, Feature
from ..partition import PartitionBook, cat_feature_cache, load_partition
from ..typing import EdgeType, FeaturePartitionData, NodeType


def _partition_feature(part: int, f: FeaturePartitionData, pb: PartitionBook,
                       dtype, device):
  """A partition's rows as a Feature, its cached rows first, with its
  global id -> row map, and the feature book that routes its cached ids
  to it (:func:`~glt_tpu_torch.partition.cat_feature_cache`)."""
  feats, _, id2index, book = cat_feature_cache(part, f, pb)
  return Feature(feats, id2index=id2index, dtype=dtype, device=device), book


class DistDataset(Dataset):
  """One partition of a partitioned dataset: its graph, its node and
  edge feature rows, ``num_partitions``, ``partition_idx``, the partition
  books (``node_pb`` and ``edge_pb``: one, or a dict keyed by node or edge
  type) and the feature books (``node_feat_pb``, ``edge_feat_pb``, alike),
  which route the feature rows: the graph's books with this partition's
  cached ids sent to itself. Build one with :meth:`load`."""

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
    ds.node_feat_pb = ds.edge_feat_pb = None

    def features(f, pb):
      return _partition_feature(partition_idx, f, pb, feature_dtype, device)

    if meta['data_cls'] == 'hetero':
      weights = {e: g.weights for e, g in graph.items()
                 if g.weights is not None}
      ds.init_graph(edge_index={e: g.edge_index for e, g in graph.items()},
                    edge_ids={e: g.eids for e, g in graph.items()},
                    edge_weights=weights or None,
                    num_nodes={nt: pb.table.shape[0]
                               for nt, pb in node_pb.items()},
                    device=device)
      if nfeat:
        built = {nt: features(f, node_pb[nt]) for nt, f in nfeat.items()}
        ds.node_features = {nt: b[0] for nt, b in built.items()}
        ds.node_feat_pb = {nt: b[1] for nt, b in built.items()}
      if efeat:
        built = {e: features(f, edge_pb[e]) for e, f in efeat.items()}
        ds.edge_features = {e: b[0] for e, b in built.items()}
        ds.edge_feat_pb = {e: b[1] for e, b in built.items()}
    else:
      ds.init_graph(edge_index=graph.edge_index, edge_ids=graph.eids,
                    edge_weights=graph.weights,
                    num_nodes=node_pb.table.shape[0], device=device)
      if nfeat is not None:
        ds.node_features, ds.node_feat_pb = features(nfeat, node_pb)
      if efeat is not None:
        ds.edge_features, ds.edge_feat_pb = features(efeat, edge_pb)
    return ds

  def get_node_pb(self, ntype: Optional[NodeType] = None):
    if isinstance(self.node_pb, dict) and ntype is not None:
      return self.node_pb[ntype]
    return self.node_pb

  def get_node_feat_pb(self, ntype: Optional[NodeType] = None):
    """The book that routes the node feature rows (of ``ntype`` for a
    hetero layout): this partition's rewritten one, else the graph's."""
    pb = self.node_feat_pb if self.node_feat_pb is not None else self.node_pb
    if isinstance(pb, dict) and ntype is not None:
      return pb[ntype]
    return pb

  def get_edge_feature(self, etype: Optional[EdgeType] = None):
    """The edge feature rows (of ``etype`` for a hetero layout), or
    None."""
    if isinstance(self.edge_features, dict):
      return self.edge_features.get(etype)
    return self.edge_features

  def get_edge_feat_pb(self, etype: Optional[EdgeType] = None):
    """The book that routes the edge feature rows (of ``etype`` for a
    hetero layout): this partition's feature book, else the edge
    partition book."""
    pb = self.edge_feat_pb if self.edge_feat_pb is not None else self.edge_pb
    if isinstance(pb, dict) and etype is not None:
      return pb[etype]
    return pb


class DistTableDataset(DistDataset):
  """A rank's partition of tables partitioned online: it streams its table
  slices through :class:`~glt_tpu_torch.distributed.
  dist_random_partitioner.DistTableRandomPartitioner`, then loads its own
  partition (:meth:`DistDataset.load`)."""

  def load_tables(self, edge_reader, node_reader, rank: int,
                  world_size: int, num_nodes: int, output_dir: str,
                  edge_id_offset: int = 0, master_addr: str = '127.0.0.1',
                  master_port: int = 30800, peer_addrs=None,
                  device=None) -> 'DistTableDataset':
    """Partition this rank's slices into ``output_dir`` with the other
    ranks (the readers' records as they come, no densification; the
    edges' global ids ``edge_id_offset + local position``, offsets
    disjoint across ranks) and return partition ``rank`` loaded on
    ``device`` (default: the card)."""
    from .dist_random_partitioner import DistTableRandomPartitioner
    partitioner = DistTableRandomPartitioner(
        output_dir, rank=rank, world_size=world_size, num_nodes=num_nodes,
        edge_reader=edge_reader, node_reader=node_reader,
        edge_id_offset=edge_id_offset, master_addr=master_addr,
        master_port=master_port, peer_addrs=peer_addrs)
    try:
      partitioner.partition()
    finally:
      partitioner.shutdown()
    return self.load(output_dir, rank, device=device)
