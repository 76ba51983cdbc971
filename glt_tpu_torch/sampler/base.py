"""Sampler I/O dataclasses (counterpart of glt_tpu/sampler/base.py),
padded static layout: every variable-length field carries a mask or a
count. ``row`` holds message-source (child) labels and ``col``
message-destination (parent) labels."""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional, Union

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

  def share_memory(self) -> 'NodeSamplerInput':
    """Itself: the seeds are a process-local numpy array, as in the
    reference."""
    return self


@dataclasses.dataclass
class NegativeSampling:
  """Binary or triplet negative sampling of a link batch.

  ``amount`` negatives a positive (a float in binary mode; triplet mode
  takes the ceil, an integral count a positive). ``strict`` rejects
  proposals that are edges of the graph."""
  mode: str = 'binary'
  amount: Union[int, float] = 1
  strict: bool = False

  def __post_init__(self):
    if self.mode not in ('binary', 'triplet'):
      raise ValueError(f"mode must be 'binary' or 'triplet', got "
                       f'{self.mode!r}')
    if self.amount <= 0:
      raise ValueError(
          f'negative sampling amount must be positive, got {self.amount}')
    if self.is_triplet() and isinstance(self.amount, float):
      self.amount = int(math.ceil(self.amount))

  @classmethod
  def cast(cls, value) -> Optional['NegativeSampling']:
    """None, an instance, or the arguments as a tuple or a dict."""
    if value is None or isinstance(value, cls):
      return value
    if isinstance(value, (tuple, list)):
      return cls(*value)
    if isinstance(value, dict):
      return cls(**value)
    raise TypeError(f'cannot make a NegativeSampling of {value!r}')

  def is_binary(self) -> bool:
    return self.mode == 'binary'

  def is_triplet(self) -> bool:
    return self.mode == 'triplet'

  def sample_size(self, num_pos: int) -> int:
    """Negatives for ``num_pos`` positives: ``ceil(num_pos * amount)``."""
    return int(math.ceil(num_pos * float(self.amount)))


@dataclasses.dataclass
class EdgeSamplerInput:
  """Seed edges for link sampling: ``row[i] -> col[i]`` with an optional
  label each."""
  row: np.ndarray
  col: np.ndarray
  label: Optional[np.ndarray] = None
  input_type: Optional[EdgeType] = None
  neg_sampling: Optional[NegativeSampling] = None

  def __len__(self):
    return int(np.asarray(self.row).shape[0])

  def __getitem__(self, index) -> 'EdgeSamplerInput':
    return EdgeSamplerInput(
        np.asarray(self.row)[index], np.asarray(self.col)[index],
        np.asarray(self.label)[index] if self.label is not None else None,
        self.input_type, self.neg_sampling)

  def share_memory(self) -> 'EdgeSamplerInput':
    """Itself, as :meth:`NodeSamplerInput.share_memory`."""
    return self


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
  metadata: ``seed_labels``, ``seed_count``; from a StreamSampler
  ``snapshot_version`` (the stream snapshot the batch was sampled from);
  from ``sample_from_edges`` the link labels (``edge_label_index`` and
  ``edge_label``, or ``src_index``, ``dst_pos_index`` and
  ``dst_neg_index``) with ``num_pos`` and ``num_neg``.
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

  @property
  def batch_size(self) -> Optional[int]:
    """The number of seeds (None without ``batch``)."""
    return None if self.batch is None else int(self.batch.shape[0])


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

  def get_edge_index(self) -> Dict[EdgeType, torch.Tensor]:
    """Per edge key, ``[2, edge_capacity]``: ``row`` over ``col``."""
    return {k: torch.stack([self.row[k], self.col[k]]) for k in self.row}


class SamplingType(enum.Enum):
  NODE = 'node'
  LINK = 'link'
  SUBGRAPH = 'subgraph'
  RANDOM_WALK = 'random_walk'


@dataclasses.dataclass
class SamplingConfig:
  """The one sampling descriptor a sampling worker receives (reference
  base.py:339-352)."""
  sampling_type: SamplingType = SamplingType.NODE
  num_neighbors: Optional[Union[List[int], Dict[EdgeType, List[int]]]] = None
  batch_size: int = 1
  shuffle: bool = False
  drop_last: bool = False
  with_edge: bool = False
  with_weight: bool = False
  collect_features: bool = False
  edge_dir: str = 'out'
  seed: Optional[int] = None
  neg_sampling: Optional[NegativeSampling] = None


class BaseSampler:

  def sample_from_nodes(self, inputs: NodeSamplerInput, **kwargs):
    raise NotImplementedError

  def sample_from_edges(self, inputs: EdgeSamplerInput, **kwargs):
    raise NotImplementedError

  @property
  def edge_permutation(self):
    """None: the samplers keep the graph's own edge order."""
    return None
