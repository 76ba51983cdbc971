"""Sampler I/O dataclasses (counterpart of glt_tpu/sampler/base.py),
padded static layout: every variable-length field carries a mask or a
count. ``row`` holds message-source (child) labels and ``col``
message-destination (parent) labels."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..typing import EdgeType, NodeType


@dataclasses.dataclass
class NodeSamplerInput:
  """Seed nodes for node-based sampling."""
  node: np.ndarray
  input_type: Optional[NodeType] = None

  def __len__(self):
    return int(np.asarray(self.node).shape[0])

  def __getitem__(self, index) -> 'NodeSamplerInput':
    return NodeSamplerInput(np.asarray(self.node)[index], self.input_type)


@dataclasses.dataclass
class SamplerOutput:
  """Homogeneous sampling result, padded.

  node: [node_capacity] global ids (-1 padded); node_count valid.
  row/col: [edge_capacity] labels into ``node``; edge_mask valid.
  edge: [edge_capacity] edge ids (with_edge only).
  batch: [batch_size] the seeds' global ids (the first labels).
  num_sampled_nodes/num_sampled_edges: per-hop counts.
  edge_hop_offsets: hop h's edges occupy slots
  ``[edge_hop_offsets[h], edge_hop_offsets[h+1])``.
  metadata: ``seed_labels``, ``seed_count`` and, from a StreamSampler,
  ``snapshot_version`` (the stream snapshot the batch was sampled from).
  """
  node: torch.Tensor
  node_count: torch.Tensor
  row: torch.Tensor
  col: torch.Tensor
  edge_mask: torch.Tensor
  edge: Optional[torch.Tensor] = None
  batch: Optional[torch.Tensor] = None
  num_sampled_nodes: Optional[torch.Tensor] = None
  num_sampled_edges: Optional[torch.Tensor] = None
  edge_hop_offsets: Optional[List[int]] = None
  metadata: Optional[Dict] = None


@dataclasses.dataclass
class HeteroSamplerOutput:
  """Heterogeneous sampling result, padded: every per-type field mirrors
  :class:`SamplerOutput`. Edge keys are the message-flow types (with
  ``edge_dir='out'`` the reversed traversal types): ``row`` holds src-type
  child labels, ``col`` dst-type parent labels. ``metadata`` carries
  ``seed_labels`` and ``edge_hop_offsets`` (per edge key, hop h's slots
  are ``[offs[h], offs[h+1])``)."""
  node: Dict[NodeType, torch.Tensor]
  node_count: Dict[NodeType, torch.Tensor]
  row: Dict[EdgeType, torch.Tensor]
  col: Dict[EdgeType, torch.Tensor]
  edge_mask: Dict[EdgeType, torch.Tensor]
  edge: Optional[Dict[EdgeType, torch.Tensor]] = None
  batch: Optional[Dict[NodeType, torch.Tensor]] = None
  num_sampled_nodes: Optional[Dict[NodeType, torch.Tensor]] = None
  num_sampled_edges: Optional[Dict[EdgeType, torch.Tensor]] = None
  input_type: Optional[NodeType] = None
  metadata: Optional[Dict] = None


class BaseSampler:

  def sample_from_nodes(self, inputs: NodeSamplerInput, **kwargs):
    raise NotImplementedError
