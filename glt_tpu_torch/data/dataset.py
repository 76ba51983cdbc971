"""Dataset: graph + node features + labels (counterpart of
glt_tpu/data/dataset.py). ``edge_dir`` picks the layout, as in the
reference: ``'out'`` builds the CSR (indptr over src; the sampler draws
out-neighbours), ``'in'`` the CSC (indptr over dst; in-neighbours).

Homogeneous payloads are single objects; heterogeneous ones are dicts
keyed by EdgeType (graphs) and NodeType (features), as in the
reference."""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..typing import EdgeType, NodeType, Split
from ..utils import as_numpy, resolve_device
from .feature import Feature
from .graph import Graph, hetero_node_counts
from .topology import Topology


class Dataset:

  def __init__(self, graph: Union[None, Graph, Dict[EdgeType, Graph]] = None,
               node_features=None, node_labels=None, edge_dir: str = 'out'):
    if edge_dir not in ('out', 'in'):
      raise ValueError(f"edge_dir must be 'out' or 'in', got {edge_dir!r}")
    self.graph = graph
    self.node_features = node_features
    self.node_labels = node_labels
    #: edge features by edge id (a Feature), or a dict of them by EdgeType
    self.edge_features = None
    self.edge_dir = edge_dir
    self.node_split = None   # (train_idx, val_idx, test_idx)

  def init_graph(self, edge_index, edge_ids=None, edge_weights=None,
                 num_nodes=None, device=None, layout: str = 'COO'
                 ) -> 'Dataset':
    """Build the CSR (``edge_dir='out'``) or CSC (``'in'``) from a [2, E]
    COO ``edge_index`` on ``device`` (default: the card), with optional
    per-edge ``edge_weights`` (weighted sampling reads them). With
    ``layout='CSR'`` or ``'CSC'`` an ``edge_index`` is a compressed
    ``(indptr, indices)`` pair of that layout instead, flipped when the
    dataset's ``edge_dir`` wants the other one (glt_tpu/data/dataset.py
    :44-70). Hetero:
    ``edge_index`` (and ``edge_ids`` and ``edge_weights``, an edge type
    without an entry unweighted) are dicts keyed by EdgeType, and each
    edge type compresses into a rectangular graph
    over its (src, dst) node counts. ``num_nodes`` is then a dict keyed
    by NodeType (an edge type either of whose ends it names reads both
    ends from it), a dict keyed by EdgeType (a square count for that
    type), or one int for every type, as in the JAX package. An axis
    with no count is one past its largest id."""
    device = resolve_device(device)
    target = 'CSR' if self.edge_dir == 'out' else 'CSC'
    given = layout.upper()
    if given not in ('COO', 'CSR', 'CSC'):
      raise ValueError(f'unsupported layout {layout!r}')

    def build(ei, eid, ew, n_src, n_dst):
      # the pointer axis of the chosen layout: src of a CSR, dst of a CSC
      n_rows, n_cols = (n_src, n_dst) if target == 'CSR' else (n_dst, n_src)
      if given == 'COO':
        topo = Topology(ei, edge_ids=eid, edge_weights=ew, num_rows=n_rows,
                        num_cols=n_cols, layout=target, device=device)
      else:
        in_rows, in_cols = ((n_src, n_dst) if given == 'CSR'
                            else (n_dst, n_src))
        topo = Topology(indptr=ei[0], indices=ei[1], edge_ids=eid,
                        edge_weights=ew, num_rows=in_rows, num_cols=in_cols,
                        layout=given, device=device)
        if topo.layout != target:
          topo = topo.flip_layout()
      return Graph(topo, device=device)

    if not isinstance(edge_index, dict):
      self.graph = build(edge_index, edge_ids, edge_weights, num_nodes,
                         num_nodes)
      return self
    self.graph = {}
    for etype, ei in edge_index.items():
      src_t, _, dst_t = etype
      if not isinstance(num_nodes, dict):
        n_src = n_dst = num_nodes
      elif src_t in num_nodes or dst_t in num_nodes:
        n_src, n_dst = num_nodes.get(src_t), num_nodes.get(dst_t)
      else:
        n_src = n_dst = num_nodes.get(etype)
      eid = edge_ids.get(etype) if isinstance(edge_ids, dict) else None
      ew = (edge_weights.get(etype) if isinstance(edge_weights, dict)
            else None)
      self.graph[etype] = build(ei, eid, ew, n_src, n_dst)
    return self

  def init_node_features(self, node_feature_data, sort_func=None,
                         split_ratio: float = 1.0,
                         dtype: Optional[torch.dtype] = None, device=None,
                         host_offload: Optional[bool] = None
                         ) -> 'Dataset':
    """One table, or a dict of per-type tables keyed by NodeType, each a
    :class:`Feature` with ``split_ratio`` of its rows on the card and
    the rest in host memory (pinned unless ``host_offload=False``).
    ``sort_func`` (e.g. :func:`~glt_tpu_torch.data.reorder.
    sort_by_in_degree`) reorders a table over a topology, hottest rows
    first, and its old -> new map becomes the Feature's ``id2index``, so
    lookups keep taking the original ids: a homogeneous table over the
    graph's, a node type's over the first edge type whose pointer type
    it is (the JAX ``_topo_for_node_type``; for a CSR that counts the
    in-degrees of the edge type's other end), a type without one
    unsorted."""
    def build(feats, topo=None):
      id2index = None
      if sort_func is not None and topo is not None:
        feats, id2index = sort_func(as_numpy(feats), split_ratio, topo)
      return Feature(feats, split_ratio=split_ratio, id2index=id2index,
                     device=device, dtype=dtype, host_offload=host_offload)

    if isinstance(node_feature_data, dict):
      self.node_features = {t: build(f, self._topo_for_node_type(t))
                            for t, f in node_feature_data.items()}
    else:
      self.node_features = build(
          node_feature_data,
          self.graph.topo if isinstance(self.graph, Graph) else None)
    return self

  def init_edge_features(self, edge_feature_data,
                         dtype: Optional[torch.dtype] = None,
                         device=None) -> 'Dataset':
    """One table by edge id, or a dict of them keyed by EdgeType, each a
    :class:`Feature` on ``device`` (default: the card): what a sampling
    worker gathers for a batch's sampled edges (``with_edge``)."""
    if isinstance(edge_feature_data, dict):
      self.edge_features = {e: Feature(f, dtype=dtype, device=device)
                            for e, f in edge_feature_data.items()}
    else:
      self.edge_features = Feature(edge_feature_data, dtype=dtype,
                                   device=device)
    return self

  def get_edge_feature(self, etype: Optional[EdgeType] = None
                       ) -> Optional[Feature]:
    if isinstance(self.edge_features, dict):
      return self.edge_features.get(etype)
    return self.edge_features

  def init_node_labels(self, node_label_data) -> 'Dataset':
    """One label array, or a dict of them keyed by NodeType (hetero: the
    loader reads the seed type's)."""
    if isinstance(node_label_data, dict):
      self.node_labels = {t: as_numpy(v) for t, v in node_label_data.items()}
    else:
      self.node_labels = as_numpy(node_label_data)
    return self

  def random_node_split(self, num_val, num_test, seed: int = 0
                        ) -> 'Dataset':
    """(train, val, test) id arrays from one ``default_rng(seed)``
    permutation of the nodes, the JAX package's split exactly: the first
    ``num_val`` permuted ids validate, the next ``num_test`` test, the
    rest train; a float is a fraction of the nodes. Hetero: one such
    split a node type, over its :meth:`node_count`, each from its own
    ``default_rng(seed)``."""
    def split_one(n):
      perm = np.random.default_rng(seed).permutation(n)
      nv = int(num_val * n) if isinstance(num_val, float) else num_val
      nt = int(num_test * n) if isinstance(num_test, float) else num_test
      return (perm[nv + nt:], perm[:nv], perm[nv:nv + nt])

    if self.is_hetero:
      self.node_split = {t: split_one(self.node_count(t))
                         for t in self.get_node_types()}
    else:
      self.node_split = split_one(self.graph.num_nodes)
    return self

  def get_split(self, split: Split, ntype: Optional[NodeType] = None
                ) -> np.ndarray:
    """One split's ids; of node type ``ntype`` for a hetero split."""
    s = self.node_split
    if isinstance(s, dict):
      if ntype is None:
        raise ValueError('a hetero split needs the node type')
      s = s[ntype]
    return s[{Split.train: 0, Split.valid: 1, Split.test: 2}[Split(split)]]

  @property
  def is_hetero(self) -> bool:
    return isinstance(self.graph, dict)

  def get_graph(self, etype: Optional[EdgeType] = None) -> Graph:
    return self.graph[etype] if self.is_hetero else self.graph

  def get_node_feature(self, ntype: Optional[NodeType] = None) -> Feature:
    if isinstance(self.node_features, dict):
      return self.node_features.get(ntype)
    return self.node_features

  def get_node_label(self, ntype: Optional[NodeType] = None):
    if isinstance(self.node_labels, dict):
      return self.node_labels[ntype]
    return self.node_labels

  def get_node_types(self):
    return list(hetero_node_counts(self.graph)) if self.is_hetero else None

  def get_edge_types(self):
    return list(self.graph) if self.is_hetero else None

  def _topo_for_node_type(self, ntype: NodeType) -> Optional[Topology]:
    """The topology of the first edge type whose pointer type is
    ``ntype`` (src of a CSR, dst of a CSC), or None."""
    if not self.is_hetero:
      return None
    for (src, _, dst), g in self.graph.items():
      if (src if g.layout == 'CSR' else dst) == ntype:
        return g.topo
    return None

  def node_count(self, ntype: Optional[NodeType] = None) -> int:
    """Node count of ``ntype``: the largest axis any edge type gives it
    (:func:`hetero_node_counts`, what the sampler reads), or its feature
    table's rows."""
    if not self.is_hetero:
      return self.graph.num_nodes
    best = hetero_node_counts(self.graph).get(ntype, 0)
    feat = self.get_node_feature(ntype)
    return max(best, feat.shape[0]) if feat is not None else best
