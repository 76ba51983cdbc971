"""TableDataset: a Dataset assembled from table readers (counterpart of
glt_tpu/data/table_dataset.py).

A reader is any iterable of record chunks: an edge reader yields
``(src_ids, dst_ids[, weights])``, a node reader ``(node_ids,
feature_rows[, labels])``, numpy arrays or tensors. ``odps_table_reader``
reads an ``odps://`` table on PAI (it needs the ``common_io`` package);
``csv_edge_reader`` and ``csv_node_reader`` yield the same chunks from CSV
files. The records are gathered on the host, node rows densified by id,
and the graph, features and labels built through the Dataset's
``init_*`` on ``device`` (default: the card).
"""
from __future__ import annotations

import itertools
from typing import Iterable, Optional

import numpy as np

from ..utils import as_numpy
from .dataset import Dataset

#: edge readers yield (src_ids, dst_ids[, weights]); node readers yield
#: (node_ids, feature_rows[, labels])
TableReader = Iterable


def _edge_records(reader):
  """The reader's chunks as (src int64, dst int64, weights float32 or
  None), concatenated."""
  srcs, dsts, ws = [], [], []
  for rec in reader:
    srcs.append(as_numpy(rec[0]).astype(np.int64))
    dsts.append(as_numpy(rec[1]).astype(np.int64))
    if len(rec) > 2 and rec[2] is not None:
      ws.append(as_numpy(rec[2]).astype(np.float32))
  if not srcs:
    return None, None, None
  return (np.concatenate(srcs), np.concatenate(dsts),
          np.concatenate(ws) if ws else None)


def _node_records(reader):
  """The reader's chunks as (ids int64, rows, labels or None),
  concatenated."""
  ids, feats, labels = [], [], []
  for rec in reader:
    ids.append(as_numpy(rec[0]).astype(np.int64))
    feats.append(as_numpy(rec[1]))
    if len(rec) > 2 and rec[2] is not None:
      labels.append(as_numpy(rec[2]))
  if not ids:
    return None, None, None
  return (np.concatenate(ids), np.concatenate(feats),
          np.concatenate(labels) if labels else None)


def _dense(ids, values, n_rows):
  """``values`` scattered by ``ids`` into ``n_rows`` zero rows."""
  out = np.zeros((n_rows,) + values.shape[1:], values.dtype)
  out[ids] = values
  return out


class TableDataset(Dataset):
  """A Dataset built by streaming table readers."""

  def load(self, edge_reader: Optional[TableReader] = None,
           node_reader: Optional[TableReader] = None,
           num_nodes: Optional[int] = None, directed: bool = True,
           device=None) -> 'TableDataset':
    """One homogeneous graph from ``edge_reader`` over ``num_nodes`` (one
    past the largest id when not given), both directions of every edge
    with ``directed=False``; the node table from ``node_reader``, its rows
    placed by id over the widest of the ids, ``num_nodes`` and the graph's
    nodes (rows no record names stay zero), and its labels when the
    records carry them."""
    src, dst, w = (_edge_records(edge_reader) if edge_reader is not None
                   else (None, None, None))
    if src is not None:
      if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if w is not None:
          w = np.concatenate([w, w])
      n = num_nodes or int(max(src.max(), dst.max())) + 1
      self.init_graph(edge_index=np.stack([src, dst]), edge_weights=w,
                      num_nodes=n, device=device)
    ids, feats, labels = (_node_records(node_reader)
                          if node_reader is not None else (None,) * 3)
    if ids is not None:
      n_rows = max(int(ids.max()) + 1, num_nodes or 0,
                   self.graph.num_nodes if self.graph is not None else 0)
      self.init_node_features(_dense(ids, feats, n_rows), device=device)
      if labels is not None:
        self.init_node_labels(_dense(ids, labels, n_rows))
    return self

  def load_tables(self, edge_tables=None, node_tables=None, num_nodes=None,
                  directed: bool = True, reader_batch_size: int = 1024,
                  reader_threads: int = 10, device=None) -> 'TableDataset':
    """The hetero form: ``edge_tables`` maps an EdgeType, ``node_tables``
    a NodeType, to a reader or an ``odps://`` URL (read through
    :func:`odps_table_reader`). Dicts of one entry each collapse to a
    homogeneous dataset. A type's node count widens to the ids its node
    records and its edges show and to ``num_nodes`` (an int for every
    type, or a dict by node type)."""
    def resolve(source, kind):
      if isinstance(source, str):
        return odps_table_reader(source, kind=kind,
                                 batch_size=reader_batch_size,
                                 num_threads=reader_threads)
      return source

    edge_tables = edge_tables or {}
    node_tables = node_tables or {}
    hetero = len(edge_tables) > 1 or len(node_tables) > 1

    edge_index, weights = {}, {}
    for etype, source in edge_tables.items():
      s, d, w = _edge_records(resolve(source, 'edge'))
      if not directed:
        s, d = np.concatenate([s, d]), np.concatenate([d, s])
        w = np.concatenate([w, w]) if w is not None else None
      edge_index[etype] = np.stack([s, d])
      if w is not None:
        weights[etype] = w

    feats, labels, counts = {}, {}, {}
    for ntype, source in node_tables.items():
      ids, rows, labs = _node_records(resolve(source, 'node'))
      n_rows = int(ids.max()) + 1
      if isinstance(num_nodes, dict):
        n_rows = max(n_rows, num_nodes.get(ntype, 0))
      elif num_nodes:
        n_rows = max(n_rows, num_nodes)
      feats[ntype] = _dense(ids, rows, n_rows)
      counts[ntype] = n_rows
      if labs is not None:
        labels[ntype] = _dense(ids, labs, n_rows)

    if edge_index and hetero:
      nn = dict(counts)
      for (s_t, _, d_t), ei in edge_index.items():
        for t, col in ((s_t, ei[0]), (d_t, ei[1])):
          nn[t] = max(nn.get(t, 0), int(col.max()) + 1 if col.size else 0)
      if isinstance(num_nodes, dict):
        for t, v in num_nodes.items():
          nn[t] = max(nn.get(t, 0), v)
      self.init_graph(edge_index=edge_index, edge_weights=weights or None,
                      num_nodes=nn, device=device)
    elif edge_index:
      (etype, ei), = edge_index.items()
      if isinstance(num_nodes, dict):   # a one-entry hetero spec
        num_nodes = max(num_nodes.values())
      n = max(num_nodes or 0, (int(ei.max()) + 1) if ei.size else 1,
              *(counts.values() or [0]))
      self.init_graph(edge_index=ei, edge_weights=weights.get(etype),
                      num_nodes=n, device=device)
    if feats and hetero:
      self.init_node_features(feats, device=device)
      if labels:
        self.init_node_labels(labels)
    elif feats:
      (feat,) = feats.values()
      self.init_node_features(feat, device=device)
      if labels:
        (lab,) = labels.values()
        self.init_node_labels(lab)
    return self


def odps_table_reader(url: str, kind: str = 'edge', batch_size: int = 1024,
                      num_threads: int = 10):
  """Record chunks of an ``odps://project/tables/name`` table through PAI's
  ``common_io`` reader: an edge table's ``(src, dst[, weight])``, a node
  table's ``(id, features[, label])`` with the features a ``:``-joined
  string or a list. Raises ImportError without ``common_io``; elsewhere
  pass a reader iterable such as :func:`csv_edge_reader`."""
  try:
    import common_io
  except ImportError as e:
    raise ImportError(
        'odps:// table sources need the common_io package (available '
        'on PAI); pass a reader iterable such as csv_edge_reader '
        'instead') from e
  reader = common_io.table.TableReader(url, num_threads=num_threads,
                                       capacity=batch_size * 10)
  try:
    while True:
      try:
        recs = reader.read(batch_size, allow_smaller_final_batch=True)
      except common_io.exception.OutOfRangeException:
        return
      if not recs:
        return
      cols = list(zip(*recs))
      if kind == 'edge':
        yield (np.asarray(cols[0], np.int64),
               np.asarray(cols[1], np.int64)) + (
                   (np.asarray(cols[2], np.float32),)
                   if len(cols) > 2 else ())
      else:
        ids = np.asarray(cols[0], np.int64)
        feats = np.stack([np.fromstring(c, sep=':', dtype=np.float32)
                          if isinstance(c, (str, bytes))
                          else np.asarray(c, np.float32) for c in cols[1]])
        rest = (np.asarray(cols[2]),) if len(cols) > 2 else ()
        yield (ids, feats) + rest
  finally:
    reader.close()


def _csv_chunks(path: str, chunk_size: int, delimiter: str):
  """The non-blank rows of ``path``, split on ``delimiter``, a list of at
  most ``chunk_size`` lines at a time."""
  with open(path) as f:
    while True:
      rows = list(itertools.islice(f, chunk_size))
      if not rows:
        return
      yield [r.rstrip('\n').split(delimiter) for r in rows if r.strip()]


def csv_edge_reader(path: str, chunk_size: int = 1_000_000,
                    src_col: int = 0, dst_col: int = 1,
                    weight_col: Optional[int] = None,
                    delimiter: str = ','):
  """Edge chunks ``(src, dst[, weight])`` of a CSV file, ``chunk_size``
  lines at a time."""
  for parts in _csv_chunks(path, chunk_size, delimiter):
    src = np.array([int(p[src_col]) for p in parts], np.int64)
    dst = np.array([int(p[dst_col]) for p in parts], np.int64)
    if weight_col is not None:
      yield src, dst, np.array([float(p[weight_col]) for p in parts],
                               np.float32)
    else:
      yield src, dst


def csv_node_reader(path: str, chunk_size: int = 1_000_000,
                    id_col: int = 0, label_col: Optional[int] = None,
                    delimiter: str = ',', feat_delimiter: str = ':'):
  """Node chunks ``(ids, rows[, labels])`` of a CSV file of
  ``id,<f0:f1:...>[,label]`` lines, ``chunk_size`` lines at a time."""
  for parts in _csv_chunks(path, chunk_size, delimiter):
    ids = np.array([int(p[id_col]) for p in parts], np.int64)
    feats = np.stack([np.array(p[id_col + 1].split(feat_delimiter),
                               np.float32) for p in parts])
    if label_col is not None:
      yield ids, feats, np.array([int(p[label_col]) for p in parts],
                                 np.int32)
    else:
      yield ids, feats
