"""Batch structures and sampler output -> batch (counterpart of
glt_tpu/loader/transform.py): the fields PyG models read, padded, the
PyG-v1 ``(batch_size, n_id, adjs)`` view of a batch (:func:`to_pyg_v1`)
and a PyG ``Data`` of its valid slots (:func:`to_torch_data`, when
torch_geometric is installed)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

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
  #: [edge_cap, De] features of the sampled edges (an edge store's)
  edge_attr: Optional[torch.Tensor] = None
  num_sampled_nodes: Optional[torch.Tensor] = None
  num_sampled_edges: Optional[torch.Tensor] = None
  batch_size: int = 0
  edge_hop_offsets: Optional[Tuple[int, ...]] = None
  #: the sampler's metadata; a loader adds ``n_valid`` (real seeds)
  metadata: Optional[Dict[str, Any]] = None

  @property
  def edge_index(self) -> torch.Tensor:
    """``[2, edge_cap]``: ``row`` over ``col``, masked slots included."""
    return torch.stack([self.row, self.col])

  @property
  def num_nodes(self) -> int:
    """The node capacity (``node``'s length; ``node_count`` are valid)."""
    return self.node.shape[0]

  @property
  def batch(self) -> torch.Tensor:
    """Global ids of the seed nodes (the first ``batch_size`` labels)."""
    return self.node[:self.batch_size]


def to_batch(out: SamplerOutput, x: Optional[torch.Tensor] = None,
             y: Optional[torch.Tensor] = None,
             edge_attr: Optional[torch.Tensor] = None,
             batch_size: Optional[int] = None) -> Batch:
  """Assemble a Batch from a SamplerOutput (+ gathered payloads)."""
  return Batch(
      x=x, y=y, edge_attr=edge_attr, row=out.row, col=out.col,
      edge_mask=out.edge_mask,
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
  #: per edge key the sampled edges' feature rows (a partitioned trainer
  #: given edge stores), zero on masked lanes
  edge_attr_dict: Optional[Dict[EdgeType, torch.Tensor]] = None

  def edge_index_dict(self) -> Dict[EdgeType, torch.Tensor]:
    """Per edge key, ``[2, edge_cap]``: ``row`` over ``col``."""
    return {k: torch.stack([self.row_dict[k], self.col_dict[k]])
            for k in self.row_dict}

  @property
  def batch(self) -> torch.Tensor:
    """Global ids of the seed type's seeds (its first ``batch_size``
    labels)."""
    return self.node_dict[self.input_type][:self.batch_size]


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


class EdgeIndex(NamedTuple):
  """A PyG-v1 ``EdgeIndex`` adjacency (glt_tpu/loader/transform.py:138,
  vendored there as here, so the v1 training-loop idiom works without
  torch_geometric): ``edge_index [2, m]`` in message-flow orientation,
  ``e_id [m]`` the global edge ids or None, ``size`` (src count, dst
  count)."""
  edge_index: torch.Tensor
  e_id: Optional[torch.Tensor]
  size: Tuple[int, int]

  def to(self, device) -> 'EdgeIndex':
    return EdgeIndex(self.edge_index.to(device),
                     None if self.e_id is None else self.e_id.to(device),
                     self.size)


def to_pyg_v1(batch: Batch):
  """The PyG-v1 ``(batch_size, n_id, adjs)`` view of a homogeneous batch
  (glt_tpu/loader/transform.py:154-178, the reference's ``as_pyg_v1``
  mode): ``n_id`` the batch's ``node_count`` global ids, ``adjs`` one
  :class:`EdgeIndex` a hop, outermost hop first, each holding that hop's
  valid edges and its ``(nodes up to this hop, nodes before it)`` size.
  Tensors stay on the batch's device; the counts are read on the host.
  Needs the batch's ``edge_hop_offsets``."""
  if batch.edge_hop_offsets is None:
    raise ValueError('to_pyg_v1 needs the batch edge_hop_offsets')
  offs = batch.edge_hop_offsets
  counts = batch.num_sampled_nodes.tolist()
  n_id = batch.node[:int(batch.node_count)]
  adjs = []
  for h in range(len(offs) - 1):
    sl = slice(offs[h], offs[h + 1])
    keep = batch.edge_mask[sl]
    edge_index = torch.stack([batch.row[sl][keep], batch.col[sl][keep]])
    e_id = None if batch.edge is None else batch.edge[sl][keep]
    adjs.append(EdgeIndex(edge_index, e_id,
                          (int(sum(counts[:h + 2])), int(sum(counts[:h + 1])))))
  return batch.batch_size, n_id, list(reversed(adjs))


def to_torch_data(batch: Batch):
  """A PyG ``Data`` of the batch's valid slots, field for field as
  glt_tpu/loader/transform.py builds it: ``x`` and ``node`` of the
  ``node_count`` valid nodes, ``edge_index`` of the valid edges (int64),
  ``y``, ``batch_size`` and the per-hop counts as lists. Tensors stay on
  the batch's device. Needs torch_geometric (ImportError without it)."""
  from torch_geometric.data import Data
  em = batch.edge_mask
  nc = int(batch.node_count)
  data = Data(x=None if batch.x is None else batch.x[:nc],
              edge_index=torch.stack([batch.row[em], batch.col[em]]).long(),
              y=batch.y)
  data.node = batch.node[:nc]
  data.batch_size = batch.batch_size
  if batch.num_sampled_nodes is not None:
    data.num_sampled_nodes = batch.num_sampled_nodes.tolist()
    data.num_sampled_edges = batch.num_sampled_edges.tolist()
  return data
