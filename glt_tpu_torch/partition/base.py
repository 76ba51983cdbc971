"""Offline graph and feature partitioning and the on-disk partition layout
(counterpart of glt_tpu/partition/base.py).

The layout is the JAX package's, file for file, so either package reads
what the other wrote::

    root/
      META.json                  {num_parts, data_cls, edge_dir,
                                  edge_assign, node_types?, edge_types?}
      node_pb.npy | node_pb/<ntype>.npy
      edge_pb.npy | edge_pb/<src__rel__dst>.npy
      part{i}/
        graph.npz | graph/<src__rel__dst>.npz      rows, cols, eids[, weights]
        node_feat.npz | node_feat/<ntype>.npz      feats, ids[, cache_feats,
                                                   cache_ids]
        edge_feat.npz | edge_feat/<src__rel__dst>.npz  feats, ids

(homogeneous payloads are ``graph/data.npz`` and the like). A partition's
``cache_ids`` are hot rows other partitions own, copied to it (a
partitioner's ``_cache_node``, or :func:`build_partition_feature`);
:func:`cat_feature_cache` puts them in front of the owned rows when a
partition loads. Everything here is numpy on the host. npz holds no
bfloat16: tables are written in their own dtype, and a store casts them
when it loads them.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..typing import (EdgeType, FeaturePartitionData, GraphPartitionData,
                      NodeType, as_str)
from ..utils import as_numpy
from .partition_book import PartitionBook, TablePartitionBook

CHUNK = 4 * 1024 * 1024


def _write_node_feat(root_dir: str, part: int, ntype, feats, ids,
                     cache_feats=None, cache_ids=None) -> None:
  """A partition's node feature payload: its rows and, when it caches
  any, the cached rows and their ids."""
  payload = dict(feats=feats, ids=ids)
  if cache_feats is not None and cache_ids is not None and len(cache_ids):
    payload['cache_feats'] = cache_feats
    payload['cache_ids'] = cache_ids
  d = os.path.join(root_dir, f'part{part}', 'node_feat')
  os.makedirs(d, exist_ok=True)
  np.savez(os.path.join(d, f'{ntype}.npz' if ntype else 'data.npz'),
           **payload)


class PartitionerBase:
  """Chunked offline partitioner (abstract :meth:`_partition_node`; a
  subclass may cache hot rows through :meth:`_cache_node`).

  Args:
    output_dir: layout root.
    num_parts: partition count.
    num_nodes: int (homogeneous) or a dict keyed by node type.
    edge_index: ``[2, E]`` COO (src, dst), or a dict keyed by edge type.
    node_feat / edge_feat / edge_weights: optional arrays or dicts.
    edge_assign_strategy: ``'by_src'`` or ``'by_dst'``: the endpoint whose
      owner an edge goes to.
    chunk_size: edges a processing chunk.
  """

  def __init__(self, output_dir: str, num_parts: int, num_nodes,
               edge_index, node_feat=None, edge_feat=None,
               edge_weights=None, edge_assign_strategy: str = 'by_src',
               chunk_size: int = CHUNK, edge_dir: str = 'out'):
    if edge_assign_strategy not in ('by_src', 'by_dst'):
      raise ValueError(f'edge_assign_strategy {edge_assign_strategy!r}: '
                       "expected 'by_src' or 'by_dst'")
    self.output_dir = output_dir
    self.num_parts = int(num_parts)
    self.is_hetero = isinstance(edge_index, dict)
    self.num_nodes = num_nodes
    self.edge_index = edge_index
    self.node_feat = node_feat
    self.edge_feat = edge_feat
    self.edge_weights = edge_weights
    self.edge_assign_strategy = edge_assign_strategy
    self.chunk_size = int(chunk_size)
    self.edge_dir = edge_dir

  def _partition_node(self, ntype: Optional[NodeType] = None) -> np.ndarray:
    """The node partition table ``[num_nodes]`` int32."""
    raise NotImplementedError

  def _cache_node(self, ntype: Optional[NodeType] = None
                  ) -> Optional[List[np.ndarray]]:
    """Per partition the ids of the rows it caches (rows other partitions
    own), or None: no cache."""
    return None

  def partition(self) -> None:
    os.makedirs(self.output_dir, exist_ok=True)
    if self.is_hetero:
      ntypes = set()
      for (s, _, d) in self.edge_index:
        ntypes.update((s, d))
      node_pbs = {}
      for nt in sorted(ntypes):
        node_pbs[nt] = self._partition_node(nt)
        self._save_pb(os.path.join('node_pb', nt), node_pbs[nt])
      for etype, ei in self.edge_index.items():
        self._partition_etype(etype, as_numpy(ei), node_pbs)
      for nt in sorted(ntypes):
        self._save_node_feat(nt, node_pbs[nt])
      meta = dict(num_parts=self.num_parts, data_cls='hetero',
                  edge_dir=self.edge_dir,
                  edge_assign=self.edge_assign_strategy,
                  node_types=sorted(ntypes),
                  edge_types=[list(e) for e in self.edge_index])
    else:
      node_pb = self._partition_node()
      self._save_pb('node_pb', node_pb)
      self._partition_etype(None, as_numpy(self.edge_index),
                            {None: node_pb})
      self._save_node_feat(None, node_pb)
      meta = dict(num_parts=self.num_parts, data_cls='homo',
                  edge_dir=self.edge_dir,
                  edge_assign=self.edge_assign_strategy)
    with open(os.path.join(self.output_dir, 'META.json'), 'w') as f:
      json.dump(meta, f)

  def _save_pb(self, rel: str, pb: np.ndarray) -> None:
    path = os.path.join(self.output_dir, rel + '.npy')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, pb.astype(np.int32))

  def _partition_etype(self, etype: Optional[EdgeType], ei: np.ndarray,
                       node_pbs: Dict) -> None:
    """Assign edges by their anchor endpoint's owner, chunk by chunk, and
    write each partition's edges and the edge book."""
    num_edges = ei.shape[1]
    if etype is None:
      src_pb = dst_pb = node_pbs[None]
    else:
      src_pb, dst_pb = node_pbs[etype[0]], node_pbs[etype[2]]
    by_src = self.edge_assign_strategy == 'by_src'
    anchor_pb, anchor_row = (src_pb, 0) if by_src else (dst_pb, 1)
    edge_pb = np.zeros(num_edges, dtype=np.int32)
    per_part: List[List[np.ndarray]] = [[] for _ in range(self.num_parts)]
    for lo in range(0, num_edges, self.chunk_size):
      hi = min(lo + self.chunk_size, num_edges)
      owner = anchor_pb[ei[anchor_row, lo:hi]]
      edge_pb[lo:hi] = owner
      for p in range(self.num_parts):
        sel = np.nonzero(owner == p)[0] + lo
        if sel.size:
          per_part[p].append(sel)
    ename = as_str(etype) if etype else None
    self._save_pb(os.path.join('edge_pb', ename) if ename else 'edge_pb',
                  edge_pb)
    w = as_numpy(self.edge_weights.get(etype)
                 if isinstance(self.edge_weights, dict)
                 else self.edge_weights)
    ef = as_numpy(self.edge_feat.get(etype)
                  if isinstance(self.edge_feat, dict) else self.edge_feat)
    fname = f'{ename}.npz' if ename else 'data.npz'
    for p in range(self.num_parts):
      eids = (np.concatenate(per_part[p]) if per_part[p]
              else np.zeros(0, np.int64))
      payload = dict(rows=ei[0, eids], cols=ei[1, eids], eids=eids)
      if w is not None:
        payload['weights'] = w[eids]
      d = os.path.join(self.output_dir, f'part{p}', 'graph')
      os.makedirs(d, exist_ok=True)
      np.savez(os.path.join(d, fname), **payload)
      if ef is not None:
        fd = os.path.join(self.output_dir, f'part{p}', 'edge_feat')
        os.makedirs(fd, exist_ok=True)
        np.savez(os.path.join(fd, fname), feats=ef[eids], ids=eids)

  def _save_node_feat(self, ntype: Optional[NodeType],
                      node_pb: np.ndarray) -> None:
    feat = as_numpy(self.node_feat.get(ntype)
                    if isinstance(self.node_feat, dict) else self.node_feat)
    if feat is None:
      return
    cache = self._cache_node(ntype)
    for p in range(self.num_parts):
      ids = np.nonzero(node_pb == p)[0]
      hot = cache[p] if cache is not None and cache[p].size else None
      _write_node_feat(self.output_dir, p, ntype, feat[ids], ids,
                       cache_feats=None if hot is None else feat[hot],
                       cache_ids=hot)


# -- loading -----------------------------------------------------------------

def _load_npz(path: str) -> dict:
  with np.load(path) as z:
    return {k: z[k] for k in z.files}


def load_meta(root: str) -> dict:
  with open(os.path.join(root, 'META.json')) as f:
    return json.load(f)


def _load_graph(fname: str) -> GraphPartitionData:
  z = _load_npz(fname)
  return GraphPartitionData(edge_index=np.stack([z['rows'], z['cols']]),
                            eids=z['eids'], weights=z.get('weights'))


def _load_feat(fname: str) -> FeaturePartitionData:
  z = _load_npz(fname)
  return FeaturePartitionData(feats=z['feats'], ids=z['ids'],
                              cache_feats=z.get('cache_feats'),
                              cache_ids=z.get('cache_ids'))


def load_partition_graph(root: str, part: int):
  """One partition's edges and the books, without its features: ``(meta,
  graph, node_pb, edge_pb)``, the graph payload a GraphPartitionData (a
  dict of them keyed by edge type for a hetero layout)."""
  meta = load_meta(root)
  gdir = os.path.join(root, f'part{part}', 'graph')
  if meta['data_cls'] == 'hetero':
    etypes = [tuple(e) for e in meta['edge_types']]
    graph = {e: _load_graph(os.path.join(gdir, f'{as_str(e)}.npz'))
             for e in etypes}
    node_pb = {nt: TablePartitionBook(
        np.load(os.path.join(root, 'node_pb', f'{nt}.npy')))
        for nt in meta['node_types']}
    edge_pb = {e: TablePartitionBook(
        np.load(os.path.join(root, 'edge_pb', f'{as_str(e)}.npy')))
        for e in etypes}
    return meta, graph, node_pb, edge_pb
  graph = _load_graph(os.path.join(gdir, 'data.npz'))
  node_pb = TablePartitionBook(np.load(os.path.join(root, 'node_pb.npy')))
  edge_pb = TablePartitionBook(np.load(os.path.join(root, 'edge_pb.npy')))
  return meta, graph, node_pb, edge_pb


def load_partition(root: str, part: int):
  """One partition: ``(meta, graph, node_feat, edge_feat, node_pb,
  edge_pb)``, payloads GraphPartitionData / FeaturePartitionData (dicts
  keyed by type for a hetero layout; a missing feature payload is
  None)."""
  meta, graph, node_pb, edge_pb = load_partition_graph(root, part)
  pdir = os.path.join(root, f'part{part}')

  def feat(kind, name):
    path = os.path.join(pdir, kind, f'{name}.npz')
    return _load_feat(path) if os.path.exists(path) else None

  if meta['data_cls'] == 'hetero':
    nfeat = {nt: f for nt in meta['node_types']
             if (f := feat('node_feat', nt)) is not None}
    efeat = {e: f for e in graph
             if (f := feat('edge_feat', as_str(e))) is not None}
    return meta, graph, nfeat or None, efeat or None, node_pb, edge_pb
  return (meta, graph, feat('node_feat', 'data'), feat('edge_feat', 'data'),
          node_pb, edge_pb)


def cat_feature_cache(part: int, feat: FeaturePartitionData,
                      pb: PartitionBook):
  """A partition's feature rows as a store reads them (glt_tpu/partition/
  base.py:276): the cached rows first, then the owned rows, the global id
  -> row map over both (-1 elsewhere), and the feature book rewritten so
  that this partition's cached ids route to itself. Returns ``(feats,
  ids, id2index, book)``; without cached rows the rows, the map and a copy
  of ``pb``."""
  table = (pb.table.copy() if isinstance(pb, TablePartitionBook)
           else pb[np.arange(pb.bounds[-1])].copy())
  if feat.cache_feats is None or feat.cache_ids is None:
    feats, ids = feat.feats, feat.ids
  else:
    feats = np.concatenate([feat.cache_feats, feat.feats])
    ids = np.concatenate([feat.cache_ids, feat.ids])
    table[feat.cache_ids] = part
  max_id = int(ids.max()) + 1 if ids.size else 0
  id2index = np.full(max(max_id, table.shape[0]), -1, np.int64)
  id2index[ids] = np.arange(ids.shape[0])
  return feats, ids, id2index, TablePartitionBook(table)


def build_partition_feature(root_dir: str, node_feat, ntype=None,
                            cache_probs=None, cache_ratio: float = 0.0
                            ) -> None:
  """The second stage of a two-stage partitioning (glt_tpu/partition/
  base.py:296): over a layout whose node books are on disk, write each
  partition's node feature rows, and, given ``cache_probs`` [N] and a
  ``cache_ratio``, each partition's hottest rows of other partitions (at
  most ``N * cache_ratio``, probability above 0) as its cached rows."""
  meta = load_meta(root_dir)
  node_feat = as_numpy(node_feat)
  if meta['data_cls'] == 'hetero':
    if ntype is None:
      raise ValueError('a hetero layout needs the node type')
    pb = np.load(os.path.join(root_dir, 'node_pb', f'{ntype}.npy'))
  else:
    pb = np.load(os.path.join(root_dir, 'node_pb.npy'))
  probs = as_numpy(cache_probs)
  cache_num = int(pb.shape[0] * cache_ratio) if cache_ratio else 0
  for p in range(meta['num_parts']):
    ids = np.nonzero(pb == p)[0]
    cache_feats = cache_ids = None
    if cache_num and probs is not None:
      score = probs.copy()
      score[ids] = -1.0
      hot = np.argsort(-score)[:cache_num]
      hot = hot[score[hot] > 0]
      if hot.size:
        cache_feats, cache_ids = node_feat[hot], hot
    _write_node_feat(root_dir, p, ntype, node_feat[ids], ids,
                     cache_feats=cache_feats, cache_ids=cache_ids)
