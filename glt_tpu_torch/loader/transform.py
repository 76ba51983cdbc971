"""Batch structures and sampler output -> batch (counterpart of
glt_tpu/loader/transform.py): the fields PyG models read, padded."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..sampler.base import HeteroSamplerOutput, SamplerOutput
from ..typing import EdgeType, NodeType


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
  #: the sampler's metadata; a loader adds ``n_valid`` (real seeds)
  metadata: Optional[Dict[str, Any]] = None


def to_batch(out: SamplerOutput, x: Optional[torch.Tensor] = None,
             y: Optional[torch.Tensor] = None,
             batch_size: Optional[int] = None) -> Batch:
  """Assemble a Batch from a SamplerOutput (+ gathered payloads)."""
  return Batch(
      x=x, y=y, row=out.row, col=out.col, edge_mask=out.edge_mask,
      node=out.node, node_count=out.node_count, edge=out.edge,
      num_sampled_nodes=out.num_sampled_nodes,
      num_sampled_edges=out.num_sampled_edges, metadata=out.metadata,
      batch_size=batch_size if batch_size is not None
      else (out.batch.shape[0] if out.batch is not None else 0),
      edge_hop_offsets=tuple(out.edge_hop_offsets)
      if out.edge_hop_offsets else None)


@dataclasses.dataclass
class HeteroBatch:
  """Heterogeneous mini-batch, padded. Edge keys (s, r, d) carry ``row`` =
  s-type child labels and ``col`` = d-type parent labels (message flow);
  ``y_dict`` the seed type's labels [batch_size] (from a loader over a
  labelled dataset); ``edge_hop_offsets_dict`` gives each key's per-hop
  slots for hierarchical trimming."""
  x_dict: Dict[NodeType, torch.Tensor]
  row_dict: Dict[EdgeType, torch.Tensor]
  col_dict: Dict[EdgeType, torch.Tensor]
  edge_mask_dict: Dict[EdgeType, torch.Tensor]
  node_dict: Dict[NodeType, torch.Tensor]
  node_count_dict: Dict[NodeType, torch.Tensor]
  y_dict: Optional[Dict[NodeType, torch.Tensor]] = None
  edge_dict: Optional[Dict[EdgeType, torch.Tensor]] = None
  num_sampled_nodes: Optional[Dict[NodeType, torch.Tensor]] = None
  num_sampled_edges: Optional[Dict[EdgeType, torch.Tensor]] = None
  #: the sampler's metadata without its hop offsets; a loader adds
  #: ``n_valid`` (real seeds)
  metadata: Optional[Dict[str, Any]] = None
  input_type: Optional[NodeType] = None
  batch_size: int = 0
  edge_hop_offsets_dict: Optional[Dict[EdgeType, Tuple[int, ...]]] = None


def to_hetero_batch(out: HeteroSamplerOutput,
                    x_dict: Optional[Dict[NodeType, torch.Tensor]] = None,
                    y_dict: Optional[Dict[NodeType, torch.Tensor]] = None,
                    batch_size: Optional[int] = None) -> HeteroBatch:
  """Assemble a HeteroBatch from a HeteroSamplerOutput (+ per-type
  gathered features and the seed type's labels). The hop offsets move
  from the sampler's metadata into ``edge_hop_offsets_dict``; the rest of
  it stays, a link batch's labels too (``edge_label_index`` and
  ``edge_label``, or ``src_index``, ``dst_pos_index`` and
  ``dst_neg_index``, with ``num_pos`` and ``num_neg``), whose
  ``input_type`` is its edge type. ``batch_size`` defaults to the seed
  type's seeds (0 for a link batch: its loader passes its own)."""
  meta = dict(out.metadata or {})
  offs = meta.pop('edge_hop_offsets', None)
  return HeteroBatch(
      x_dict=x_dict or {}, row_dict=out.row, col_dict=out.col,
      edge_mask_dict=out.edge_mask, node_dict=out.node,
      node_count_dict=out.node_count, y_dict=y_dict, edge_dict=out.edge,
      num_sampled_nodes=out.num_sampled_nodes,
      num_sampled_edges=out.num_sampled_edges, metadata=meta,
      input_type=out.input_type,
      batch_size=batch_size if batch_size is not None
      else (out.batch[out.input_type].shape[0]
            if out.input_type in (out.batch or {}) else 0),
      edge_hop_offsets_dict={k: tuple(v) for k, v in offs.items()}
      if offs else None)
