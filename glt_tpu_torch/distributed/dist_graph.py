"""DistGraph: a partitioned topology, one block a rank (counterpart of
glt_tpu/distributed/dist_graph.py).

The JAX package stacks every partition's CSR into padded arrays sharded
over the mesh, device p holding partition p. Here rank p holds the same
row of those stacks on its card: its partition's CSR over the rows it
owns, padded to the largest partition's row and edge counts (the ranks
agree on them with an ``all_reduce``), plus

  * ``local_row`` [N]: global row id -> local CSR row on this rank (-1
    for a row another rank owns);
  * ``node_pb`` [N]: the owner of every row id (the partition book,
    dense), the same on every rank.

A rank loads only its own partition's edges.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..data.topology import Topology
from ..parallel.mesh import Mesh
from ..partition import dense_book, load_meta, load_partition_graph
from ..typing import GraphPartitionData


class DistGraph:
  """This rank's block of a partitioned CSR (see the module docstring).

  Args:
    mesh: the rank's :class:`~glt_tpu_torch.parallel.mesh.Mesh`, one rank
      a partition.
    num_nodes: the global node count.
    parts: per-partition GraphPartitionData (``edge_index`` in (src, dst)
      orientation, as the partitioner writes it), a sequence or a dict
      holding at least this rank's entry.
    node_pb: the node partition book.
    edge_dir: ``'out'`` builds the CSR over src, ``'in'`` the CSC over
      dst.

  Attributes: ``indptr`` [max_rows + 1] int32, ``indices`` [max_edges]
  int32 (column ids, global), ``edge_ids`` [max_edges] int64 (-1 past the
  live edges), ``edge_weights`` [max_edges] float32 (0 past the live
  edges) or None, ``local_row``, ``node_pb``, and ``mesh``, ``num_nodes``
  (the row id space), ``edge_dir``, ``num_partitions``, ``max_rows``,
  ``max_edges``, ``max_degree`` (the maxima over every partition). The
  weights are kept when every partition has them (agreed over the mesh,
  all or nothing), as the JAX stores keep them.
  """

  def __init__(self, mesh: Mesh, num_nodes: int, parts, node_pb,
               edge_dir: str = 'out'):
    part = _oriented(rank_entry(parts, mesh, 'parts'), edge_dir)
    _fill_store(self, mesh, part, node_pb, int(num_nodes), int(num_nodes),
                edge_dir)

  @classmethod
  def from_dataset_partitions(cls, mesh: Mesh, root_dir: str,
                              edge_dir: str = 'out') -> 'DistGraph':
    """This rank's block of a homogeneous partition layout on disk (a
    rank reads only its own partition's edges)."""
    _check_layout(load_meta(root_dir), mesh, edge_dir, 'homo')
    _, g, node_pb, _ = load_partition_graph(root_dir, mesh.rank)
    return cls(mesh, node_pb.table.shape[0], {mesh.rank: g}, node_pb,
               edge_dir)


def _check_layout(meta: dict, mesh: Mesh, edge_dir: str, data_cls: str):
  """The layout must be of ``data_cls``, have a partition a rank, and be
  edge-assigned by the endpoint sampling expands from (edges assigned by
  the other end would be missing from their row's owner)."""
  if meta['data_cls'] != data_cls:
    raise ValueError(f"a {meta['data_cls']} partition layout, expected "
                     f'{data_cls}')
  if meta['num_parts'] != mesh.world:
    raise ValueError(f"the layout holds {meta['num_parts']} partitions, "
                     f'the mesh {mesh.world} ranks: one a rank')
  need = 'by_src' if edge_dir == 'out' else 'by_dst'
  got = meta.get('edge_assign', 'by_src')
  if got != need:
    raise ValueError(f'partition was edge-assigned {got!r} but edge_dir='
                     f'{edge_dir!r} sampling requires {need!r}; '
                     f're-partition with edge_assign_strategy={need!r}')
  return meta


def _oriented(g: GraphPartitionData, edge_dir: str) -> GraphPartitionData:
  """``g`` with ``edge_index`` as (row, col): (src, dst) for ``'out'``,
  (dst, src) for ``'in'``."""
  src, dst = g.edge_index
  rows = (src, dst) if edge_dir == 'out' else (dst, src)
  return GraphPartitionData(edge_index=np.stack(rows), eids=g.eids,
                            weights=g.weights)


def build_store(mesh: Mesh, part: GraphPartitionData, node_pb,
                num_rows: int, num_cols: int,
                edge_dir: str = 'out') -> DistGraph:
  """A DistGraph from this rank's already oriented edges (see
  :func:`_fill_store`)."""
  store = DistGraph.__new__(DistGraph)
  _fill_store(store, mesh, part, node_pb, num_rows, num_cols, edge_dir)
  return store


def _fill_store(store: DistGraph, mesh: Mesh, part: GraphPartitionData,
                node_pb, num_rows: int, num_cols: int, edge_dir: str):
  """This rank's store from its partition's edges, ``part.edge_index``
  already (row, col): rows in ``[0, num_rows)`` of the row type, columns
  in ``[0, num_cols)`` of the column type (glt_tpu/distributed/
  dist_graph.py ``_build_partition_block`` and ``_pad_block``, and
  dist_hetero.py ``_build_etype_store`` with its two id spaces). The
  CSR is built on the rank's device; the padding maxima, and whether the
  store keeps weights (every partition has them), are agreed over the
  mesh (one ``all_reduce``, a collective: every rank calls this for the
  same stores in the same order)."""
  dev = mesh.device
  row = torch.as_tensor(np.asarray(part.edge_index[0]), device=dev).long()
  col = torch.as_tensor(np.asarray(part.edge_index[1]), device=dev).long()
  owned = torch.unique(row)
  local_of = torch.full((num_rows,), -1, dtype=torch.int32, device=dev)
  local_of[owned] = torch.arange(owned.numel(), dtype=torch.int32,
                                 device=dev)
  weights = (None if part.weights is None else torch.as_tensor(
      np.asarray(part.weights, np.float32), device=dev))
  topo = Topology(torch.stack([local_of[row].long(), col]),
                  edge_ids=torch.as_tensor(np.asarray(part.eids),
                                           device=dev),
                  edge_weights=weights, num_rows=owned.numel(),
                  num_cols=num_cols, layout='CSR', device=dev)
  # the last entry is minus the weights flag: its max is minus the min
  sizes = torch.tensor([max(owned.numel(), 1), max(topo.num_edges, 1),
                        max(topo.max_degree, 1), -int(weights is not None)],
                       dtype=torch.int64, device=dev)
  if mesh.world > 1:
    dist.all_reduce(sizes, op=dist.ReduceOp.MAX, group=mesh.group)
  max_rows, max_edges, max_degree, no_weights = (int(v) for v in sizes.cpu())
  store.mesh = mesh
  store.num_nodes = int(num_rows)
  store.edge_dir = edge_dir
  store.num_partitions = mesh.world
  store.max_rows, store.max_edges, store.max_degree = (max_rows, max_edges,
                                                       max_degree)
  ip = topo.indptr.to(torch.int32)
  store.indptr = torch.cat([ip, ip[-1:].expand(max_rows + 1 - ip.numel())])
  pad = max_edges - topo.num_edges
  store.indices = torch.cat([topo.indices, topo.indices.new_zeros(pad)])
  store.edge_ids = torch.cat([topo.edge_ids.long(),
                              torch.full((pad,), -1, dtype=torch.int64,
                                         device=dev)])
  store.edge_weights = (None if no_weights == 0 else torch.cat(
      [topo.edge_weights.float(), torch.zeros(pad, device=dev)]))
  store.local_row = local_of
  store.node_pb = torch.as_tensor(dense_book(node_pb, num_rows),
                                  device=dev)


def store_tensors(store: DistGraph, with_edge: bool = False,
                  with_weight: bool = False) -> dict:
  """The arrays a one-hop reads (glt_tpu's ``graph_shards`` dict):
  ``indptr``, ``indices``, ``local_row``, ``node_pb``; with ``with_edge``
  the edge ids narrowed to int32 (``sample_hop`` and ``gather_windows``
  read int32 planes; a partition's edge ids fit it, as the JAX slots do);
  with ``with_weight``, when the store keeps them, ``edge_weights``."""
  out = dict(indptr=store.indptr, indices=store.indices,
             local_row=store.local_row, node_pb=store.node_pb)
  if with_edge:
    out['edge_ids'] = store.edge_ids.to(torch.int32)
  if with_weight and store.edge_weights is not None:
    out['edge_weights'] = store.edge_weights
  return out


def rank_entry(per_part, mesh: Mesh, what: str):
  """``per_part[mesh.rank]`` of a per-partition sequence or dict (a
  caller may hold only this rank's entry in a dict)."""
  try:
    return per_part[mesh.rank]
  except (IndexError, KeyError):
    raise ValueError(f'{what} has no entry for rank {mesh.rank}') from None



def dist_graph_from_partitions_multihost(mesh: Mesh, root_dir: str,
                                         edge_dir: str = 'out') -> DistGraph:
  """This rank's DistGraph under a multi-process group (glt_tpu/
  distributed/dist_graph.py:231): the rank loads only its own partition
  and the ranks agree on the padding in :meth:`DistGraph.
  from_dataset_partitions`. The JAX package's
  ``make_array_from_process_local_data`` assembly has no counterpart: a
  rank already holds only its own block."""
  meta = load_meta(root_dir)
  need = 'by_src' if edge_dir == 'out' else 'by_dst'
  got = meta.get('edge_assign', 'by_src')
  if got != need:
    raise ValueError(f'edge_assign {got!r} incompatible with '
                     f'edge_dir {edge_dir!r}')
  if meta['num_parts'] != mesh.world:
    raise ValueError(
        f"mesh has {mesh.world} devices but the partition dir holds "
        f"{meta['num_parts']} partitions — they must match")
  return DistGraph.from_dataset_partitions(mesh, root_dir, edge_dir)
