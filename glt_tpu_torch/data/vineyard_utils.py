"""Fragment loaders over a vineyard-style fragment store (counterpart of
glt_tpu/data/vineyard_utils.py).

Every loader works against the :class:`FragmentClient` protocol: five
methods over a fragment's CSR, its vertex and edge property columns and
its global-id window, the subset of the vineyard ArrowFragment surface the
reference reads. :class:`InMemoryFragmentStore` implements it over
partitioned COO graphs and property tables held in this process;
connecting by a socket path needs the ``vineyard`` package and an adapter
of the protocol, which neither package has (no live service exists
here). :func:`load_vineyard_dataset` assembles a whole-graph
:class:`~glt_tpu_torch.data.Dataset` from a set of fragments on
``device`` (default: the card).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..utils import as_numpy, resolve_device
from .dataset import Dataset
from .topology import Topology


class FragmentClient:
  """What the loaders need from a fragment store:

  - ``frag_csr(fid, v_label, e_label, edge_dir)`` -> (indptr [Nv+1],
    indices [E], edge_ids [E] or None), the pointer axis local to the
    fragment's window;
  - ``frag_vertex_feature(fid, v_label, columns)`` -> [Nv, len(columns)];
  - ``frag_edge_feature(fid, e_label, columns)`` -> [E, len(columns)];
  - ``frag_vertex_offset(fid, v_label)`` / ``frag_vertex_num(fid,
    v_label)`` -> the fragment's global-id window.
  """

  def frag_csr(self, fid, v_label, e_label, edge_dir='out'):
    raise NotImplementedError

  def frag_vertex_feature(self, fid, v_label, columns):
    raise NotImplementedError

  def frag_edge_feature(self, fid, e_label, columns):
    raise NotImplementedError

  def frag_vertex_offset(self, fid, v_label) -> int:
    raise NotImplementedError

  def frag_vertex_num(self, fid, v_label) -> int:
    raise NotImplementedError


class InMemoryFragmentStore(FragmentClient):
  """Partitioned COO graphs and per-vertex/edge property columns held in
  process memory. ``add_fragment`` registers one partition: vertices
  ``[offset, offset + num_vertices)`` of ``v_label`` and the edges whose
  source falls in that window. A fragment's CSR is built through
  :class:`~glt_tpu_torch.data.Topology` on ``device`` (default: the
  card); the property columns are returned as numpy."""

  def __init__(self, device=None):
    self.device = device
    self._frags: Dict[tuple, dict] = {}

  def add_fragment(self, fid, v_label: str, e_label: str, offset: int,
                   num_vertices: int, edge_index, edge_ids=None,
                   vertex_feats: Optional[Dict[str, np.ndarray]] = None,
                   edge_feats: Optional[Dict[str, np.ndarray]] = None):
    self._frags[(fid, v_label, e_label)] = dict(
        offset=int(offset), num=int(num_vertices),
        edge_index=as_numpy(edge_index), edge_ids=as_numpy(edge_ids),
        vfeats=vertex_feats or {}, efeats=edge_feats or {})

  def _get(self, fid, v_label, e_label=None):
    if e_label is None:
      for (f, v, _), frag in self._frags.items():
        if f == fid and v == v_label:
          return frag
      raise KeyError((fid, v_label))
    return self._frags[(fid, v_label, e_label)]

  def frag_csr(self, fid, v_label, e_label, edge_dir='out'):
    frag = self._get(fid, v_label, e_label)
    ei = frag['edge_index']
    # the pointer axis is local to the window: shift it by the offset
    local = ei.copy()
    ptr_axis = 0 if edge_dir == 'out' else 1
    local[ptr_axis] = local[ptr_axis] - frag['offset']
    topo = Topology(local, edge_ids=frag['edge_ids'],
                    layout='CSR' if edge_dir == 'out' else 'CSC',
                    num_rows=frag['num'],
                    num_cols=(int(ei.max()) + 1) if ei.size else 1,
                    device=resolve_device(self.device))
    return topo.indptr, topo.indices, topo.edge_ids

  def frag_vertex_feature(self, fid, v_label, columns):
    frag = self._get(fid, v_label)
    return np.stack([np.asarray(frag['vfeats'][c]) for c in columns], 1)

  def frag_edge_feature(self, fid, e_label, columns):
    for (f, _, e), frag in self._frags.items():
      if f == fid and e == e_label:
        return np.stack([np.asarray(frag['efeats'][c]) for c in columns],
                        1)
    raise KeyError((fid, e_label))

  def frag_vertex_offset(self, fid, v_label) -> int:
    return self._get(fid, v_label)['offset']

  def frag_vertex_num(self, fid, v_label) -> int:
    return self._get(fid, v_label)['num']


def _client(sock_or_client) -> FragmentClient:
  if isinstance(sock_or_client, FragmentClient):
    return sock_or_client
  try:
    import vineyard  # noqa: F401
  except ImportError as e:
    raise ImportError(
        'connecting by socket path requires the vineyard client '
        '(pip install vineyard) and a running vineyard/GraphScope '
        'instance; alternatively pass any FragmentClient '
        'implementation (e.g. InMemoryFragmentStore)') from e
  raise NotImplementedError(
      'socket-path connection requires wiring a vineyard '
      'ArrowFragment adapter over FragmentClient (5 methods, see '
      'class docstring); no live service exists in this environment')


def vineyard_to_csr(sock, fid, v_label, e_label, edge_dir: str = 'out'):
  """A fragment's (indptr, indices, edge_ids)."""
  return _client(sock).frag_csr(fid, v_label, e_label, edge_dir)


def load_vertex_feature_from_vineyard(sock, fid, vcols: Sequence[str],
                                      v_label):
  """A fragment's vertex property columns, [Nv, len(vcols)]."""
  return _client(sock).frag_vertex_feature(fid, v_label, vcols)


def load_edge_feature_from_vineyard(sock, fid, ecols: Sequence[str],
                                    e_label):
  """A fragment's edge property columns, [E, len(ecols)]."""
  return _client(sock).frag_edge_feature(fid, e_label, ecols)


def get_frag_vertex_offset(sock, fid, v_label) -> int:
  return _client(sock).frag_vertex_offset(fid, v_label)


def get_frag_vertex_num(sock, fid, v_label) -> int:
  return _client(sock).frag_vertex_num(fid, v_label)


def load_vineyard_dataset(sock, fids: Sequence, v_label, e_label,
                          vcols: Sequence[str] = (), edge_dir: str = 'out',
                          device=None) -> Dataset:
  """One Dataset of the fragments ``fids`` on ``device`` (default: the
  card): their CSRs back to global COO in window order, the edge ids when
  every fragment has them, the vertex columns ``vcols`` as float32
  features."""
  device = resolve_device(device)
  client = _client(sock)
  rows_l, cols_l, eids_l, feats_l = [], [], [], []
  total = 0
  for fid in sorted(fids, key=lambda f: client.frag_vertex_offset(
      f, v_label)):
    off = client.frag_vertex_offset(fid, v_label)
    num = client.frag_vertex_num(fid, v_label)
    indptr, indices, eids = client.frag_csr(fid, v_label, e_label,
                                            edge_dir)
    indptr = torch.as_tensor(indptr, device=device)
    deg = (indptr[1:] - indptr[:-1])[:num]
    rows_l.append(torch.repeat_interleave(
        torch.arange(num, device=device), deg) + off)
    cols_l.append(torch.as_tensor(indices, device=device).long())
    if eids is not None:
      eids_l.append(torch.as_tensor(eids, device=device))
    if vcols:
      feats_l.append(client.frag_vertex_feature(fid, v_label, vcols))
    total = max(total, off + num)
  rows, cols = torch.cat(rows_l), torch.cat(cols_l)
  if edge_dir == 'in':   # CSC fragments: the pointer axis was dst
    rows, cols = cols, rows
  ds = Dataset(edge_dir=edge_dir)
  # edge ids only when EVERY fragment supplied them: a partial set would
  # misattribute ids across fragments
  eids = torch.cat(eids_l) if len(eids_l) == len(fids) else None
  ds.init_graph(edge_index=torch.stack([rows, cols]), edge_ids=eids,
                num_nodes=max(total, (int(cols.max()) + 1)
                              if cols.numel() else 1), device=device)
  if feats_l:
    ds.init_node_features(np.concatenate(feats_l).astype(np.float32),
                          device=device)
  return ds
