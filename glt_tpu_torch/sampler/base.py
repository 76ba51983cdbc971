"""Sampler I/O dataclasses (counterpart of glt_tpu/sampler/base.py),
padded static layout: every variable-length field carries a mask or a
count. ``row`` holds message-source (child) labels and ``col``
message-destination (parent) labels."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..typing import NodeType


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


class BaseSampler:

  def sample_from_nodes(self, inputs: NodeSamplerInput, **kwargs):
    raise NotImplementedError
