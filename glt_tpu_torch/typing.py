"""Core type aliases and enums (counterpart of glt_tpu/typing.py)."""
from __future__ import annotations

import enum
from typing import Tuple

NodeType = str
#: (src_node_type, relation, dst_node_type)
EdgeType = Tuple[str, str, str]

class Split(enum.Enum):
  train = 'train'
  valid = 'valid'
  test = 'test'


class GraphMode(enum.Enum):
  """Where the topology lives. The port keeps it in device memory."""
  HBM = 'HBM'
