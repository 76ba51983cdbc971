"""The port's partitioner and loader against the JAX package's: the same
inputs and seed give the same ``META.json`` and the same arrays under the
same names in every ``.npy``/``.npz`` (arrays compared, not bytes: a zip
entry carries its write time), homogeneous and hetero, two parts; each
package loads the other's files; ``DistDataset.load`` of a partition
equals the JAX one's graph, feature rows, id maps and books; the ported
partition books and the IGBH example's data equal their originals.
"""
import json
import os

import numpy as np
import pytest
import torch

from glt_tpu.distributed import DistDataset as JaxDistDataset
from glt_tpu.partition import RandomPartitioner as JaxRandomPartitioner
from glt_tpu.partition import RangePartitionBook as JaxRangePartitionBook
from glt_tpu.partition import load_partition as jax_load_partition
from glt_tpu_torch.distributed import DistDataset
from glt_tpu_torch.partition import (RandomPartitioner, RangePartitionBook,
                                     TablePartitionBook, dense_book,
                                     infer_partition_book, load_partition)

PARTS = 2


def _homo(rng):
  n = 50
  ei = rng.integers(0, n, (2, 300))
  feat = rng.normal(size=(n, 6)).astype(np.float32)
  w = rng.random(300).astype(np.float32)
  return dict(num_nodes=n, edge_index=ei, node_feat=feat, edge_weights=w)


def _hetero(rng):
  nodes = {'paper': 40, 'author': 25, 'institute': 5}
  ei = {('paper', 'cites', 'paper'): np.stack(
            [rng.integers(0, 40, 200), rng.integers(0, 40, 200)]),
        ('author', 'writes', 'paper'): np.stack(
            [rng.integers(0, 25, 90), rng.integers(0, 40, 90)]),
        ('author', 'affiliated', 'institute'): np.stack(
            [rng.integers(0, 25, 25), rng.integers(0, 5, 25)])}
  for (s, r, d), e in list(ei.items()):
    if s != d:
      ei[(d, f'rev_{r}', s)] = e[::-1].copy()
  feat = {t: rng.normal(size=(n, 4)).astype(np.float32)
          for t, n in nodes.items()}
  return dict(num_nodes=nodes, edge_index=ei, node_feat=feat)


CASES = {'homo': _homo, 'hetero': _hetero}


def _files(root):
  out = {}
  for d, _, names in os.walk(root):
    for name in names:
      path = os.path.join(d, name)
      rel = os.path.relpath(path, root)
      if name.endswith('.json'):
        with open(path) as f:
          out[rel] = json.load(f)
      elif name.endswith('.npy'):
        out[rel] = {'': np.load(path)}
      elif name.endswith('.npz'):
        with np.load(path) as z:
          out[rel] = {k: z[k] for k in z.files}
  return out


@pytest.fixture(scope='module', params=list(CASES))
def layouts(request, tmp_path_factory):
  """(case, kwargs, the JAX partitioner's root, the port's root)."""
  kw = CASES[request.param](np.random.default_rng(3))
  roots = {}
  for side, cls in (('jax', JaxRandomPartitioner),
                    ('port', RandomPartitioner)):
    roots[side] = str(tmp_path_factory.mktemp(f'{request.param}_{side}'))
    cls(roots[side], num_parts=PARTS, seed=7, chunk_size=64,
        **kw).partition()
  return request.param, kw, roots['jax'], roots['port']


def test_partitioner_writes_the_jax_layout(layouts):
  _, _, jroot, proot = layouts
  want, got = _files(jroot), _files(proot)
  assert sorted(got) == sorted(want)
  for rel, w in want.items():
    g = got[rel]
    if rel.endswith('.json'):
      assert g == w
      continue
    assert sorted(g) == sorted(w), rel
    for k in w:
      assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (rel, k)
      np.testing.assert_array_equal(g[k], w[k], err_msg=f'{rel}:{k}')


def _flat(loaded):
  """A load_partition result as {path: array} (books by their tables)."""
  out = {}

  def walk(x, key):
    if x is None:
      return
    if isinstance(x, dict):
      for k, v in x.items():
        walk(v, f'{key}/{k}')
    elif hasattr(x, '_fields'):
      for f in x._fields:
        walk(getattr(x, f), f'{key}.{f}')
    elif hasattr(x, 'table'):
      out[key] = np.asarray(x.table)
    elif isinstance(x, list):
      for i, v in enumerate(x):
        walk(v, f'{key}[{i}]')
    else:
      out[key] = np.asarray(x)
  meta, *rest = loaded
  walk(rest, 'p')
  return meta, out


@pytest.mark.parametrize('part', range(PARTS))
def test_each_package_loads_the_others_files(layouts, part):
  _, _, jroot, proot = layouts
  for loader in (load_partition, jax_load_partition):
    wmeta, want = _flat(jax_load_partition(jroot, part))
    for root in (jroot, proot):
      meta, got = _flat(loader(root, part))
      assert meta == wmeta
      assert sorted(got) == sorted(want)
      for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('part', range(PARTS))
def test_dist_dataset_load_matches_jax(layouts, part):
  """The loaded graph (compressed order, edge ids), each feature table's
  rows and id map, and the books, against the JAX DistDataset's."""
  case, _, _, proot = layouts
  jds = JaxDistDataset().load(proot, part)
  ds = DistDataset.load(proot, part, device='cpu')
  assert ds.num_partitions == jds.num_partitions == PARTS
  if case == 'homo':
    graphs = {None: (ds.graph, jds.graph)}
    feats = {None: (ds.node_features, jds.node_features)}
  else:
    graphs = {e: (ds.graph[e], g) for e, g in jds.graph.items()}
    feats = {t: (ds.node_features[t], f)
             for t, f in jds.node_features.items()}
  for g, jg in graphs.values():
    for field in ('indptr', 'indices', 'edge_ids', 'edge_weights'):
      want = getattr(jg.topo, field)
      if want is None:
        continue
      np.testing.assert_array_equal(getattr(g.topo, field).numpy(),
                                    np.asarray(want), err_msg=field)
  for t, (f, jf) in feats.items():
    jf.lazy_init()
    np.testing.assert_array_equal(f.device_part.numpy(),
                                  np.asarray(jf.device_part))
    np.testing.assert_array_equal(f._id2index, np.asarray(jf._id2index))
    np.testing.assert_array_equal(ds.get_node_feat_pb(t).table,
                                  jds.get_node_feat_pb(t).table)
    np.testing.assert_array_equal(ds.get_node_pb(t).table,
                                  jds.get_node_pb(t).table)


def test_partition_books_match_jax():
  bounds = np.array([3, 3, 10, 16])
  ids = np.array([0, 2, 3, 9, 10, 15])
  jpb, pb = JaxRangePartitionBook(bounds), RangePartitionBook(bounds)
  np.testing.assert_array_equal(pb[ids], jpb[ids])
  np.testing.assert_array_equal(pb.id2index(ids), jpb.id2index(ids))
  assert pb.num_partitions == jpb.num_partitions
  np.testing.assert_array_equal(dense_book(pb, 16), jpb[np.arange(16)])
  table = TablePartitionBook([1, 0, 1])
  np.testing.assert_array_equal(dense_book(table, 5), [1, 0, 1, 0, 0])
  assert infer_partition_book(table) is table
  np.testing.assert_array_equal(infer_partition_book([2, 0]).table, [2, 0])
  assert table.num_partitions == 2
  with pytest.raises(ValueError):
    RangePartitionBook([4, 2])


def test_igbh_data_matches_the_example(tmp_path):
  """The port's synthesize and split_seeds write the arrays of
  examples/igbh/compress_graph.py and split_seeds.py."""
  import sys
  sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), 'examples', 'igbh'))
  try:
    import compress_graph
    import split_seeds
  finally:
    sys.path.pop(0)
  from glt_tpu_torch.examples.igbh import data
  a, b = str(tmp_path / 'jax'), str(tmp_path / 'port')
  compress_graph.synthesize(a, 300, seed=5)
  split_seeds.split_seeds(a)
  data.synthesize(b, 300, seed=5)
  data.split_seeds(b)
  want, got = _files(a), _files(b)
  assert sorted(got) == sorted(want)
  for rel, w in want.items():
    if isinstance(w, dict):
      np.testing.assert_array_equal(got[rel][''], w[''], err_msg=rel)
  with open(os.path.join(a, 'processed', 'meta.txt')) as f, \
      open(os.path.join(b, 'processed', 'meta.txt')) as g:
    assert f.read() == g.read()
  counts, edges, feats, labels, tr, va = data.load_igbh_root(b)
  assert counts == {'paper': 300, 'author': 150, 'institute': 6}
  assert tr.size == 180 and va.size == 3 and labels.shape == (300,)
  assert isinstance(torch.as_tensor(feats['paper']), torch.Tensor)
