"""Core type aliases and enums (counterpart of glt_tpu/typing.py)."""
from __future__ import annotations

import enum
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np

NodeType = str
#: (src_node_type, relation, dst_node_type)
EdgeType = Tuple[str, str, str]

_REV_PREFIX = 'rev_'


def as_str(type_: Union[NodeType, EdgeType]) -> str:
  """A node type as is, an edge type as ``src__rel__dst`` (parameter
  names of the hetero models)."""
  return type_ if isinstance(type_, str) else '__'.join(type_)


def reverse_edge_type(etype: EdgeType) -> EdgeType:
  """The 'rev_' naming convention for reversed relations."""
  src, rel, dst = etype
  if src != dst:
    if rel.startswith(_REV_PREFIX):
      rel = rel[len(_REV_PREFIX):]
    else:
      rel = _REV_PREFIX + rel
  return (dst, rel, src)


class Split(enum.Enum):
  train = 'train'
  valid = 'valid'
  test = 'test'


class GraphMode(enum.Enum):
  """Where the topology lives. The port keeps it in device memory."""
  HBM = 'HBM'


class GraphPartitionData(NamedTuple):
  """Edges assigned to one partition. ``edge_index``: [2, E] (row, col)."""
  edge_index: np.ndarray
  eids: np.ndarray
  weights: Optional[np.ndarray] = None


class FeaturePartitionData(NamedTuple):
  """Features of one partition: owned rows plus the hot-cache rows."""
  feats: Optional[np.ndarray]
  ids: Optional[np.ndarray]
  cache_feats: Optional[np.ndarray]
  cache_ids: Optional[np.ndarray]
