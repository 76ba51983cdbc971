"""Batch structure and SamplerOutput -> Batch (counterpart of
glt_tpu/loader/transform.py): the fields PyG models read, padded."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..sampler.base import SamplerOutput


@dataclasses.dataclass
class Batch:
  """Homogeneous mini-batch, padded static shapes throughout."""
  x: Optional[torch.Tensor]          # [node_cap, D]
  row: torch.Tensor                  # [edge_cap] child labels
  col: torch.Tensor                  # [edge_cap] parent labels
  edge_mask: torch.Tensor            # [edge_cap]
  node: torch.Tensor                 # [node_cap] global node ids
  node_count: torch.Tensor
  y: Optional[torch.Tensor] = None   # [batch_size] seed labels
  edge: Optional[torch.Tensor] = None
  num_sampled_nodes: Optional[torch.Tensor] = None
  num_sampled_edges: Optional[torch.Tensor] = None
  batch_size: int = 0
  edge_hop_offsets: Optional[Tuple[int, ...]] = None


def to_batch(out: SamplerOutput, x: Optional[torch.Tensor] = None,
             y: Optional[torch.Tensor] = None,
             batch_size: Optional[int] = None) -> Batch:
  """Assemble a Batch from a SamplerOutput (+ gathered payloads)."""
  return Batch(
      x=x, y=y, row=out.row, col=out.col, edge_mask=out.edge_mask,
      node=out.node, node_count=out.node_count, edge=out.edge,
      num_sampled_nodes=out.num_sampled_nodes,
      num_sampled_edges=out.num_sampled_edges,
      batch_size=batch_size if batch_size is not None
      else (out.batch.shape[0] if out.batch is not None else 0),
      edge_hop_offsets=tuple(out.edge_hop_offsets)
      if out.edge_hop_offsets else None)
