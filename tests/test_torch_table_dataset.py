"""The port's table readers and TableDataset
(glt_tpu_torch.data.table_dataset) against the JAX package's: the same
records through both packages' ``load`` and ``load_tables`` give equal
CSRs, edge ids and weights, feature tables and labels; the CSV readers
yield equal chunks from the same files; ``odps_table_reader`` refuses
without ``common_io`` in both; a NeighborLoader batch over the table
dataset, on the JAX key's draws, equals JAX's; the port's
examples/pai_table_train.py runs end to end on the CPU; and the
utils counterparts (``id2idx``, ``index_select``, ``seed_everything``,
``merge_dict``) answer as the JAX package's.
"""
import random

import numpy as np
import pytest
import torch

from glt_tpu.data.table_dataset import TableDataset as JaxTableDataset
from glt_tpu.data.table_dataset import csv_edge_reader as jax_csv_edges
from glt_tpu.data.table_dataset import csv_node_reader as jax_csv_nodes
from glt_tpu.data.table_dataset import odps_table_reader as jax_odps
from glt_tpu.typing import Split as JaxSplit
from glt_tpu.utils import common as jax_common
from glt_tpu.utils import tensor as jax_tensor
from glt_tpu_torch.data import (TableDataset, csv_edge_reader,
                                csv_node_reader, odps_table_reader)
from glt_tpu_torch.typing import Split
from glt_tpu_torch.utils import (RandomSeedManager, id2idx, index_select,
                                 merge_dict, seed_everything)
from test_torch_csc import _assert_topo_equal
from test_torch_training import BATCH_KEYS, _loaders

N, E, F, C = 60, 400, 6, 4
U2I, I2I = ('user', 'buys', 'item'), ('item', 'sim', 'item')


def _records(rng, n=N, e=E, weighted=True, labelled=True, chunks=3):
  """Edge and node record chunks over ids below ``n``; the node records
  in a shuffled id order, missing two ids."""
  src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
  w = (1.0 - rng.random(e)).astype(np.float32)
  ids = rng.permutation(n)[:-2]
  x = rng.standard_normal((ids.size, F)).astype(np.float32)
  y = rng.integers(0, C, ids.size).astype(np.int32)
  edges = [tuple(a[s] for a in ((src, dst, w) if weighted else (src, dst)))
           for s in np.array_split(np.arange(e), chunks)]
  nodes = [tuple(a[s] for a in ((ids, x, y) if labelled else (ids, x)))
           for s in np.array_split(np.arange(ids.size), chunks)]
  return edges, nodes


def _assert_store_equal(jds, ds, ntype=None):
  jf, pf = jds.get_node_feature(ntype), ds.get_node_feature(ntype)
  np.testing.assert_array_equal(pf.table.numpy(),
                                jf[np.arange(jf.shape[0])])
  jy, py = jds.get_node_label(ntype), ds.get_node_label(ntype)
  if jy is None:
    assert py is None
  else:
    np.testing.assert_array_equal(py, jy)
    assert py.dtype == jy.dtype


@pytest.mark.parametrize('case', [
    dict(), dict(directed=False), dict(weighted=False),
    dict(labelled=False), dict(num_nodes=N + 9),
    dict(directed=False, num_nodes=N + 4)])
def test_load_matches_jax(case):
  case = dict(case)
  rng = np.random.default_rng(len(case))
  edges, nodes = _records(rng, weighted=case.pop('weighted', True),
                          labelled=case.pop('labelled', True))
  jds = JaxTableDataset(edge_dir='out').load(edge_reader=edges,
                                             node_reader=nodes, **case)
  ds = TableDataset(edge_dir='out').load(edge_reader=edges,
                                         node_reader=nodes, device='cpu',
                                         **case)
  _assert_topo_equal(jds.get_graph().topo, ds.get_graph().topo)
  _assert_store_equal(jds, ds)


def test_load_reads_tensor_records_and_nodes_alone():
  rng = np.random.default_rng(7)
  edges, nodes = _records(rng)
  as_t = [tuple(torch.as_tensor(a) for a in rec) for rec in edges]
  jds = JaxTableDataset().load(edge_reader=edges)
  ds = TableDataset().load(edge_reader=as_t, device='cpu')
  _assert_topo_equal(jds.get_graph().topo, ds.get_graph().topo)
  jds = JaxTableDataset().load(node_reader=nodes, num_nodes=N + 3)
  ds = TableDataset().load(node_reader=nodes, num_nodes=N + 3, device='cpu')
  assert ds.graph is None and jds.graph is None
  _assert_store_equal(jds, ds)


def _tables(rng):
  u2i = [(rng.integers(0, 30, 90), rng.integers(0, 50, 90),
          rng.random(90).astype(np.float32))]
  i2i = [(rng.integers(0, 50, 70), rng.integers(0, 50, 70))]
  users = [(rng.permutation(25), rng.standard_normal((25, F))
            .astype(np.float32))]
  items = [(np.arange(50), rng.standard_normal((50, F)).astype(np.float32),
            rng.integers(0, C, 50).astype(np.int32))]
  return u2i, i2i, users, items


@pytest.mark.parametrize('num_nodes', [None, {'user': 40}, 55])
def test_load_tables_hetero_matches_jax(num_nodes):
  u2i, i2i, users, items = _tables(np.random.default_rng(3))
  kw = dict(edge_tables={U2I: u2i, I2I: i2i},
            node_tables={'user': users, 'item': items}, num_nodes=num_nodes)
  jds = JaxTableDataset().load_tables(**kw)
  ds = TableDataset().load_tables(device='cpu', **kw)
  assert ds.get_edge_types() == jds.get_edge_types()
  for e in (U2I, I2I):
    _assert_topo_equal(jds.get_graph(e).topo, ds.get_graph(e).topo)
  for t in ('user', 'item'):
    assert ds.node_count(t) == jds.node_count(t)
    np.testing.assert_array_equal(
        ds.get_node_feature(t).table.numpy(),
        jds.get_node_feature(t)[np.arange(jds.get_node_feature(t).shape[0])])
  np.testing.assert_array_equal(ds.get_node_label('item'),
                                jds.get_node_label('item'))


@pytest.mark.parametrize('num_nodes', [None, {'item': 70}])
def test_load_tables_single_entry_collapses_like_jax(num_nodes):
  _, i2i, _, items = _tables(np.random.default_rng(4))
  kw = dict(edge_tables={I2I: i2i}, node_tables={'item': items},
            num_nodes=num_nodes, directed=False)
  jds = JaxTableDataset().load_tables(**kw)
  ds = TableDataset().load_tables(device='cpu', **kw)
  assert not ds.is_hetero and not jds.is_hetero
  _assert_topo_equal(jds.get_graph().topo, ds.get_graph().topo)
  _assert_store_equal(jds, ds)


def _write_csv(tmp_path, rng, n=23):
  edges = tmp_path / 'edges.csv'
  edges.write_text(''.join(f'{s},{d},{w:.5f}\n' for s, d, w in zip(
      rng.integers(0, n, 50), rng.integers(0, n, 50), rng.random(50))))
  nodes = tmp_path / 'nodes.csv'
  nodes.write_text(''.join(
      f'{i},{":".join(f"{v:.4f}" for v in rng.standard_normal(3))},'
      f'{rng.integers(0, 5)}\n' for i in rng.permutation(n)) + '\n')
  return str(edges), str(nodes)


@pytest.mark.parametrize('kind', ['edges', 'weighted edges', 'nodes',
                                  'labelled nodes'])
def test_csv_readers_yield_jax_chunks(tmp_path, kind):
  e_path, n_path = _write_csv(tmp_path, np.random.default_rng(5))
  if 'edges' in kind:
    kw = dict(chunk_size=16, weight_col=2 if 'weighted' in kind else None)
    want, got = (list(jax_csv_edges(e_path, **kw)),
                 list(csv_edge_reader(e_path, **kw)))
  else:
    kw = dict(chunk_size=7, label_col=2 if 'labelled' in kind else None)
    want, got = (list(jax_csv_nodes(n_path, **kw)),
                 list(csv_node_reader(n_path, **kw)))
  assert len(got) == len(want) > 1
  for g, w in zip(got, want):
    assert len(g) == len(w)
    for a, b in zip(g, w):
      assert a.dtype == b.dtype
      np.testing.assert_array_equal(a, b)


def test_odps_reader_needs_common_io_in_both():
  with pytest.raises(ImportError) as want:
    next(iter(jax_odps('odps://proj/tables/edges')))
  with pytest.raises(ImportError) as got:
    next(iter(odps_table_reader('odps://proj/tables/edges')))
  assert str(got.value) == str(want.value)
  with pytest.raises(ImportError):
    TableDataset().load_tables(edge_tables={I2I: 'odps://proj/tables/e'},
                               device='cpu')


def test_neighbor_loader_over_tables_matches_jax(monkeypatch):
  rng = np.random.default_rng(11)
  edges, nodes = _records(rng, n=300, e=3000)
  jds = JaxTableDataset().load(edge_reader=edges, node_reader=nodes,
                               num_nodes=300)
  ds = TableDataset().load(edge_reader=edges, node_reader=nodes,
                           num_nodes=300, device='cpu')
  jds.random_node_split(num_val=0.1, num_test=0.1)
  ds.random_node_split(num_val=0.1, num_test=0.1)
  np.testing.assert_array_equal(ds.get_split(Split.train),
                                jds.get_split(JaxSplit.train))
  jl, pl = _loaders(jds, ds, False, monkeypatch)
  for jb, pb in zip(jl, pl):
    for f in BATCH_KEYS:
      np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                    np.asarray(getattr(jb, f)), err_msg=f)
    assert pb.metadata['n_valid'] == jb.metadata['n_valid']


def test_pai_table_train_runs_on_the_cpu():
  from glt_tpu_torch.examples import pai_table_train
  out = pai_table_train.main(['--device', 'cpu', '--epochs', '1'])
  assert len(out['losses']) == 1 and np.isfinite(out['losses']).all()


def test_pai_tables_are_jax_tables(tmp_path):
  import importlib.util
  import os
  from glt_tpu_torch.examples import pai_table_train
  spec = importlib.util.spec_from_file_location(
      'jax_pai', os.path.join(os.path.dirname(__file__), '..', 'examples',
                              'pai_table_train.py'))
  src = open(spec.origin).read()
  ns = {}
  # the JAX example's write_tables alone (its module imports its trainer)
  exec(src[src.index('def write_tables'):src.index('def main')],
       {'np': np, 'os': os}, ns)
  (tmp_path / 'j').mkdir()
  (tmp_path / 'p').mkdir()
  want = ns['write_tables'](str(tmp_path / 'j'), num_nodes=50)
  got = pai_table_train.write_tables(str(tmp_path / 'p'), num_nodes=50)
  assert got[2:] == want[2:]
  for a, b in zip(got[:2], want[:2]):
    assert open(a).read() == open(b).read()


def test_tensor_and_common_helpers_match_jax():
  ids = np.array([5, 2, 9, 0])
  np.testing.assert_array_equal(id2idx(ids), jax_tensor.id2idx(ids))
  np.testing.assert_array_equal(id2idx(torch.as_tensor(ids)).numpy(),
                                jax_tensor.id2idx(ids))
  data = {'a': np.arange(12).reshape(6, 2), 'b': None}
  want = jax_tensor.index_select(data, np.array([4, 1]))
  got = index_select({'a': torch.arange(12).reshape(6, 2), 'b': None},
                     np.array([4, 1]))
  np.testing.assert_array_equal(got['a'].numpy(), want['a'])
  assert got['b'] is None and want['b'] is None
  assert merge_dict({'x': 1, 'y': 2}, {'x': [0]}) == jax_common.merge_dict(
      {'x': 1, 'y': 2}, {'x': [0]})
  seed_everything(13)
  got = (random.random(), np.random.rand(), torch.rand(1).item())
  assert RandomSeedManager.getInstance().getSeed() == 13
  jax_common.seed_everything(13)
  assert (random.random(), np.random.rand()) == got[:2]
  seed_everything(13)
  assert torch.rand(1).item() == got[2]
