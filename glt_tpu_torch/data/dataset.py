"""Dataset: graph + node features + labels (counterpart of
glt_tpu/data/dataset.py). The graph is the CSR of out-edges (the
reference's ``edge_dir='out'``): the sampler draws out-neighbours."""
from __future__ import annotations

from typing import Optional

import torch

from ..utils import as_numpy, resolve_device
from .feature import Feature
from .graph import Graph
from .topology import Topology


class Dataset:

  def __init__(self, graph: Optional[Graph] = None,
               node_features: Optional[Feature] = None, node_labels=None):
    self.graph = graph
    self.node_features = node_features
    self.node_labels = node_labels

  def init_graph(self, edge_index, edge_ids=None,
                 num_nodes: Optional[int] = None, device=None) -> 'Dataset':
    """Build the CSR from a [2, E] COO ``edge_index`` on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    topo = Topology(edge_index, edge_ids=edge_ids, num_nodes=num_nodes,
                    device=device)
    self.graph = Graph(topo, device=device)
    return self

  def init_node_features(self, node_feature_data,
                         dtype: Optional[torch.dtype] = None,
                         device=None) -> 'Dataset':
    self.node_features = Feature(node_feature_data, device=device,
                                 dtype=dtype)
    return self

  def init_node_labels(self, node_label_data) -> 'Dataset':
    self.node_labels = as_numpy(node_label_data)
    return self

  def get_graph(self) -> Graph:
    return self.graph

  def get_node_feature(self) -> Feature:
    return self.node_features

  def get_node_label(self):
    return self.node_labels
