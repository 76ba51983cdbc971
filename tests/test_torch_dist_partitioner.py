"""The port's online partitioners (glt_tpu_torch.distributed.
dist_random_partitioner), DistTableDataset and the multihost builders
against the JAX package's:

- the owner hash equals JAX's over ids up to 2^40 and three seeds;
- one rank writes JAX's files array for array (dtype and order; the
  ``.npz`` zip entries carry their write time, so not their bytes), the
  books byte for byte and META.json as JSON;
- two ranks (threads over loopback rpc on free consecutive ports) write
  JAX's two ranks' files by content (each file's rows sorted by edge id:
  the rows of a file are in their chunks' arrival order in both packages),
  and so do a JAX rank and a port rank pushing to each other over one
  fabric;
- the cases of tests/test_server_client.py:247-389 (every edge once at
  its source's owner, every row at its id's owner; the output loads;
  DistTableDataset leaves no zero rows and gives disjoint edge ids);
- DistTrainStep over a one-rank online partition within 1e-5 of JAX's
  DistTrainStep over the same directory, three Adam steps
  (tests/test_torch_dist_train.py's harness);
- ``multihost.initialize()`` does nothing without a cluster environment,
  and each multihost builder equals its builder at world size 1 and
  raises JAX's errors.

Every rank thread is joined within 60 s and every server stopped in a
``finally``.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from fixtures import ring_edges
from glt_tpu.distributed import DistDataset as JaxDistDataset
from glt_tpu.distributed import DistFeature as JaxDistFeature
from glt_tpu.distributed import DistGraph as JaxDistGraph
from glt_tpu.distributed import DistRandomPartitioner as JaxPartitioner
from glt_tpu.distributed import DistTableDataset as JaxDistTableDataset
from glt_tpu.parallel import make_mesh as jax_make_mesh
from glt_tpu_torch.distributed import (DistDataset, DistFeature, DistGraph,
                                       DistHeteroGraph, DistRandomPartitioner,
                                       DistTableDataset,
                                       DistTableRandomPartitioner,
                                       dist_feature_from_partitions_multihost,
                                       dist_graph_from_partitions_multihost,
                                       dist_hetero_graph_from_partitions_multihost)
from glt_tpu_torch.parallel import make_mesh, multihost
from glt_tpu_torch.partition import RandomPartitioner
from test_server_client import _free_consecutive_base
from test_torch_dist_homo import N, homo_graph
from test_torch_dist_train import LOSS_RTOL, PARAM_ATOL, _train_case

JOIN_S = 60
PKG = {'jax': JaxPartitioner, 'port': DistRandomPartitioner}


def _slices(world, n=40, dim=4, seed=0):
  """Each rank's edge slice, edge ids and feature rows of a ring graph
  with value-coded rows (row i is i, i + 0.5, ...)."""
  rows, cols, eids = ring_edges(n)
  feats = (np.arange(n, dtype=np.float32)[:, None]
           + np.arange(dim, dtype=np.float32) / 2)
  perm = np.random.default_rng(seed).permutation(n)   # rows in any order
  e_sl = np.array_split(np.arange(rows.size), world)
  n_sl = np.array_split(perm, world)
  return [dict(edge_slice=np.stack([rows[e], cols[e]]), eid_slice=eids[e],
               node_ids=n_sl[r], node_feat=feats[n_sl[r]])
          for r, e in enumerate(e_sl)], feats, (rows, cols, eids)


def _partition(tmp, pkgs, n=40, chunk_size=16, seed=0):
  """Partition the ring with rank r of package ``pkgs[r]``."""
  slices, feats, edges = _slices(len(pkgs), n)
  base = _free_consecutive_base(len(pkgs))
  worker.partition_on_threads([
      (lambda r=r: PKG[pkgs[r]](
          str(tmp), rank=r, world_size=len(pkgs), num_nodes=n,
          master_port=base, chunk_size=chunk_size, seed=seed, **slices[r]))
      for r in range(len(pkgs))], JOIN_S)
  return feats, edges


def _files(root, world):
  """Every array of the layout: ``{path: {key: array}}``."""
  out = {}
  for r in range(world):
    for kind in ('graph', 'node_feat'):
      path = os.path.join(root, f'part{r}', kind, 'data.npz')
      with np.load(path) as z:
        out[path[len(root):]] = {k: z[k] for k in z.files}
  return out


@pytest.mark.parametrize('seed', [0, 1, 2 ** 31 + 7])
def test_owner_hash_matches_jax(seed):
  ids = np.concatenate([np.arange(5000), np.random.default_rng(seed)
                        .integers(0, 2 ** 40, 20000), [2 ** 40]])
  for world in (1, 2, 3, 8):
    got = DistRandomPartitioner._owner_of(
        types.SimpleNamespace(seed=seed, world=world), ids)
    want = JaxPartitioner._owner_of(
        types.SimpleNamespace(seed=seed, world=world), ids)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
  # an int64 product and an arithmetic shift would disagree here
  top = ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
  assert (top >= np.uint64(2 ** 63)).any()


def test_one_rank_writes_jax_files(tmp_path):
  for pkg in ('jax', 'port'):
    _partition(tmp_path / pkg, [pkg], seed=5)
  want, got = (_files(str(tmp_path / p), 1) for p in ('jax', 'port'))
  assert got.keys() == want.keys()
  for path, arrays in want.items():
    assert got[path].keys() == arrays.keys()
    for k, v in arrays.items():
      assert got[path][k].dtype == v.dtype, (path, k)
      np.testing.assert_array_equal(got[path][k], v, err_msg=f'{path} {k}')
  for name in ('node_pb.npy', 'edge_pb.npy'):
    assert ((tmp_path / 'port' / name).read_bytes()
            == (tmp_path / 'jax' / name).read_bytes())
  assert (json.loads((tmp_path / 'port' / 'META.json').read_text())
          == json.loads((tmp_path / 'jax' / 'META.json').read_text()))


def _by_content(files):
  """Each file's rows sorted by edge id (graph) or id (features)."""
  out = {}
  for path, arrays in files.items():
    order = np.argsort(arrays['eids'] if 'eids' in arrays else arrays['ids'],
                       kind='stable')
    out[path] = {k: v[order] for k, v in arrays.items()}
  return out


@pytest.mark.parametrize('pkgs', [('port', 'port'), ('jax', 'port'),
                                  ('port', 'jax')])
def test_two_ranks_write_jax_files_by_content(tmp_path, pkgs):
  _partition(tmp_path / 'want', ['jax', 'jax'])
  feats, (rows, cols, eids) = _partition(tmp_path / 'got', list(pkgs))
  want = _by_content(_files(str(tmp_path / 'want'), 2))
  got = _by_content(_files(str(tmp_path / 'got'), 2))
  assert got.keys() == want.keys()
  for path, arrays in want.items():
    for k, v in arrays.items():
      assert got[path][k].dtype == v.dtype
      np.testing.assert_array_equal(got[path][k], v, err_msg=f'{path} {k}')
  for name in ('node_pb.npy', 'edge_pb.npy'):
    assert ((tmp_path / 'got' / name).read_bytes()
            == (tmp_path / 'want' / name).read_bytes())
  # every edge once, at its source's owner; every row at its id's owner
  node_pb = np.load(tmp_path / 'got' / 'node_pb.npy')
  seen = []
  for r in range(2):
    g = got[f'/part{r}/graph/data.npz']
    np.testing.assert_array_equal(node_pb[g['rows']], r)
    np.testing.assert_array_equal(g['rows'], rows[g['eids']])
    np.testing.assert_array_equal(g['cols'], cols[g['eids']])
    f = got[f'/part{r}/node_feat/data.npz']
    np.testing.assert_array_equal(node_pb[f['ids']], r)
    np.testing.assert_array_equal(f['feats'], feats[f['ids']])
    seen.append(g['eids'])
  np.testing.assert_array_equal(np.sort(np.concatenate(seen)), eids)


def test_online_partition_loads(tmp_path):
  feats, _ = _partition(tmp_path, ['port', 'port'])
  for r in range(2):
    ds = DistDataset.load(str(tmp_path), r, device='cpu')
    assert ds.num_partitions == 2
    owned = np.nonzero(ds.node_pb.table == r)[0]
    f = ds.get_node_feature()
    assert f.table.shape[0] == owned.size
    np.testing.assert_array_equal(
        f.table.numpy()[np.asarray(f._id2index)[owned]], feats[owned])


def test_dist_table_dataset_two_ranks(tmp_path):
  """DistTableDataset over two ranks' disjoint table slices: no zero
  rows, disjoint global edge ids (JAX's test_dist_table_dataset)."""
  rows, cols, _ = ring_edges(40)
  feats = np.tile(np.arange(40, dtype=np.float32)[:, None], (1, 4))
  base = _free_consecutive_base(2)
  out = worker.run_on_threads([
      (lambda r=r: DistTableDataset().load_tables(
          edge_reader=[(rows[r * 40:(r + 1) * 40], cols[r * 40:(r + 1) * 40])],
          node_reader=[(np.arange(r * 20, (r + 1) * 20),
                        feats[r * 20:(r + 1) * 20])],
          rank=r, world_size=2, num_nodes=40, output_dir=str(tmp_path),
          edge_id_offset=r * 40, master_port=base, device='cpu'))
      for r in range(2)], JOIN_S)
  node_pb = np.load(tmp_path / 'node_pb.npy')
  for r in range(2):
    assert isinstance(out[r], DistTableDataset)
    owned = np.nonzero(node_pb == r)[0]
    f = out[r].get_node_feature()
    np.testing.assert_array_equal(
        f.table.numpy()[np.asarray(f._id2index)[owned]][:, 0], owned)
  all_eids = np.concatenate([
      np.load(tmp_path / f'part{r}' / 'graph' / 'data.npz')['eids']
      for r in range(2)])
  assert np.unique(all_eids).shape[0] == 80


def test_dist_table_dataset_matches_jax_one_rank(tmp_path):
  """One rank of each package over the same table records: the same
  files, and the port's dataset holds JAX's graph and rows."""
  ei, feats, _, _ = homo_graph(np.random.default_rng(1))
  ids = np.random.default_rng(2).permutation(N)
  got = {}
  for pkg, cls in (('jax', JaxDistTableDataset), ('port', DistTableDataset)):
    kw = dict(device='cpu') if pkg == 'port' else {}
    got[pkg] = cls().load_tables(
        edge_reader=[(ei[0][:70], ei[1][:70]), (ei[0][70:], ei[1][70:])],
        node_reader=[(ids, feats[ids])], rank=0, world_size=1, num_nodes=N,
        output_dir=str(tmp_path / pkg), edge_id_offset=1000,
        master_port=_free_consecutive_base(1), **kw)
  want, files = (_files(str(tmp_path / p), 1) for p in ('jax', 'port'))
  for path, arrays in want.items():
    for k, v in arrays.items():
      np.testing.assert_array_equal(files[path][k], v, err_msg=k)
  jg, pg = got['jax'].get_graph().topo, got['port'].get_graph().topo
  np.testing.assert_array_equal(pg.indptr.numpy(), jg.indptr)
  np.testing.assert_array_equal(pg.indices.numpy(), jg.indices)
  np.testing.assert_array_equal(pg.edge_ids.numpy(), jg.edge_ids)
  np.testing.assert_array_equal(got['port'].get_node_feature().table.numpy(),
                                got['jax'].get_node_feature()[np.arange(N)])


def test_dist_train_step_over_an_online_partition_matches_jax(
    tmp_path, monkeypatch):
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  ei, feats, _, labels = homo_graph(np.random.default_rng(23))
  root = str(tmp_path / 'online')
  part = DistTableRandomPartitioner(
      root, rank=0, world_size=1, num_nodes=N,
      edge_reader=[(ei[0], ei[1])], node_reader=[(np.arange(N), feats)],
      master_port=_free_consecutive_base(1), seed=3)
  try:
    part.partition()
  finally:
    part.shutdown()
  mesh = jax_make_mesh(1)
  hg = JaxDistGraph.from_dataset_partitions(mesh, root)
  store = JaxDistFeature.from_dist_datasets(
      mesh, [JaxDistDataset().load(root, 0)], kind='node')
  case, want = _train_case(1, np.random.default_rng(91), hg, {'node': store},
                           labels, root, 'sage', None)
  got = worker.run_cases(make_mesh(device='cpu'), {'train': case})['train']
  assert len(got) == len(want) == 3
  for i, ((wloss, wparams), g) in enumerate(zip(want, got)):
    np.testing.assert_allclose(np.atleast_1d(g['result']), wloss,
                               rtol=LOSS_RTOL, err_msg=f'call {i}')
    assert sorted(g['params']) == sorted(wparams)
    for k, v in wparams.items():
      np.testing.assert_allclose(g['params'][k], v, rtol=0, atol=PARAM_ATOL,
                                 err_msg=f'call {i} {k}')


def test_initialize_does_nothing_without_a_cluster(monkeypatch):
  for k in ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE'):
    monkeypatch.delenv(k, raising=False)
  multihost.initialize()
  assert not torch.distributed.is_initialized()
  monkeypatch.setenv('MASTER_ADDR', '127.0.0.1')  # a partial environment
  multihost.initialize()
  assert not torch.distributed.is_initialized()
  # explicit arguments start the group (one process, gloo on the CPU)
  multihost.initialize(f'127.0.0.1:{_free_consecutive_base(1)}', 1, 0)
  try:
    assert torch.distributed.is_initialized()
    assert (torch.distributed.get_world_size(),
            torch.distributed.get_rank()) == (1, 0)
    assert make_mesh(device='cpu').world == 1
  finally:
    torch.distributed.destroy_process_group()


def _homo_layout(root, parts=1):
  ei, feats, efeats, _ = homo_graph(np.random.default_rng(4))
  RandomPartitioner(root, num_parts=parts, num_nodes=N, edge_index=ei,
                    node_feat=feats, edge_feat=efeats, seed=2).partition()


def _assert_graphs_equal(got, want):
  for f in ('indptr', 'indices', 'edge_ids', 'local_row', 'node_pb'):
    assert torch.equal(getattr(got, f), getattr(want, f)), f
  assert (got.max_rows, got.max_edges, got.max_degree) == (
      want.max_rows, want.max_edges, want.max_degree)


def test_multihost_builders_equal_the_builders(tmp_path):
  mesh = make_mesh(device='cpu')
  root = str(tmp_path / 'homo')
  _homo_layout(root)
  _assert_graphs_equal(dist_graph_from_partitions_multihost(mesh, root),
                       DistGraph.from_dataset_partitions(mesh, root))
  dss = {0: DistDataset.load(root, 0, device='cpu')}
  ids = torch.arange(N)
  for kind in ('node', 'edge'):
    for split in (1.0, 0.5):
      got = dist_feature_from_partitions_multihost(mesh, root, kind=kind,
                                                   split_ratio=split)
      want = DistFeature.from_dist_datasets(
          mesh, dss, kind=kind, split_ratio=None if split == 1.0 else split)
      assert got.hot_count == want.hot_count
      assert torch.equal(got.lookup(ids), want.lookup(ids))
  hroot = str(tmp_path / 'hetero')
  etypes = _hetero_layout(hroot)
  got = dist_hetero_graph_from_partitions_multihost(mesh, hroot)
  want = DistHeteroGraph.from_dataset_partitions(mesh, hroot)
  assert got.node_counts == want.node_counts
  for e in etypes:
    _assert_graphs_equal(got.graphs[e], want.graphs[e])


def _hetero_layout(root, **kw):
  rng = np.random.default_rng(6)
  edges = {('u', 'to', 'i'): np.stack([rng.integers(0, 20, 50),
                                       rng.integers(0, 30, 50)]),
           ('i', 'rev_to', 'u'): np.stack([rng.integers(0, 30, 50),
                                           rng.integers(0, 20, 50)])}
  RandomPartitioner(root, num_parts=1, num_nodes={'u': 20, 'i': 30},
                    edge_index=edges, **kw).partition()
  return list(edges)


def test_multihost_builders_raise_jax_errors(tmp_path):
  from glt_tpu.distributed import dist_graph as jax_dg
  from glt_tpu.distributed import dist_hetero as jax_dh
  from glt_tpu.distributed.dist_feature import (
      dist_feature_from_partitions_multihost as jax_feature_mh)
  mesh, jmesh = make_mesh(device='cpu'), jax_make_mesh(1)
  two = str(tmp_path / 'two')
  _homo_layout(two, parts=2)
  by_dst = str(tmp_path / 'by_dst')
  ei, _, _, _ = homo_graph(np.random.default_rng(4))
  RandomPartitioner(by_dst, num_parts=1, num_nodes=N, edge_index=ei,
                    edge_assign_strategy='by_dst').partition()
  hdst = str(tmp_path / 'hdst')
  _hetero_layout(hdst, edge_assign_strategy='by_dst')
  hetero_mh = jax_dh.dist_hetero_graph_from_partitions_multihost
  cases = [
      (dist_graph_from_partitions_multihost,
       jax_dg.dist_graph_from_partitions_multihost, two, {}),
      (dist_graph_from_partitions_multihost,
       jax_dg.dist_graph_from_partitions_multihost, by_dst, {}),
      (dist_hetero_graph_from_partitions_multihost, hetero_mh, hdst, {}),
      (dist_feature_from_partitions_multihost, jax_feature_mh, two, {}),
      (dist_feature_from_partitions_multihost, jax_feature_mh, by_dst,
       dict(kind='edge')),
  ]
  for port_fn, jax_fn, root, kw in cases:
    with pytest.raises(ValueError) as want:
      jax_fn(jmesh, root, **kw)
    with pytest.raises(ValueError) as got:
      port_fn(mesh, root, **kw)
    assert str(got.value) == str(want.value), root
