"""The port's fragment loaders (glt_tpu_torch.data.vineyard_utils) against
the JAX package's: the cases of tests/test_vineyard.py, each holding the
port's answer to JAX's over the same in-memory fragments (a ring over 20
nodes in two fragments of 10 by source, and in two by destination read as
CSC fragments), and the assembled dataset's sample against JAX's on the
JAX key's draws."""
import jax
import numpy as np
import pytest
import torch

from fixtures import ring_edges
from glt_tpu.data import vineyard_utils as J
from glt_tpu.sampler import NeighborSampler as JaxNeighborSampler
from glt_tpu_torch.data import vineyard_utils as P
from glt_tpu_torch.sampler import NeighborSampler
from test_torch_csc import _assert_topo_equal


def _store(mod, edge_dir='out', **kw):
  """Two fragments of 10 nodes each, holding the edges whose source
  (``'out'``) or destination (``'in'``) lies in their window."""
  rows, cols, eids = ring_edges(20)
  s = mod.InMemoryFragmentStore(**kw)
  ptr = rows if edge_dir == 'out' else cols
  for fid, off in ((0, 0), (1, 10)):
    m = (ptr >= off) & (ptr < off + 10)
    s.add_fragment(
        fid, 'person', 'knows', offset=off, num_vertices=10,
        edge_index=np.stack([rows[m], cols[m]]), edge_ids=eids[m],
        vertex_feats={'age': np.arange(off, off + 10, dtype=np.float32),
                      'w': np.full(10, float(fid), np.float32)},
        edge_feats={'since': eids[m].astype(np.float32)})
  return s


@pytest.fixture()
def stores():
  return _store(J), _store(P, device='cpu')


def _csc_stores():
  return _store(J, 'in'), _store(P, 'in', device='cpu')


@pytest.mark.parametrize('fid', [0, 1])
@pytest.mark.parametrize('edge_dir', ['out', 'in'])
def test_vineyard_to_csr_matches_jax(stores, fid, edge_dir):
  if edge_dir == 'in':
    stores = _csc_stores()
  want = J.vineyard_to_csr(stores[0], fid, 'person', 'knows', edge_dir)
  got = P.vineyard_to_csr(stores[1], fid, 'person', 'knows', edge_dir)
  for g, w in zip(got, want):
    assert isinstance(g, torch.Tensor)
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert g.numpy().dtype == np.asarray(w).dtype


def test_vineyard_feature_columns_match_jax(stores):
  for fid in (0, 1):
    np.testing.assert_array_equal(
        P.load_vertex_feature_from_vineyard(stores[1], fid, ['age', 'w'],
                                            'person'),
        J.load_vertex_feature_from_vineyard(stores[0], fid, ['age', 'w'],
                                            'person'))
    np.testing.assert_array_equal(
        P.load_edge_feature_from_vineyard(stores[1], fid, ['since'],
                                          'knows'),
        J.load_edge_feature_from_vineyard(stores[0], fid, ['since'],
                                          'knows'))
  with pytest.raises(KeyError):
    P.load_edge_feature_from_vineyard(stores[1], 5, ['since'], 'knows')


def test_vineyard_offsets_match_jax(stores):
  for fid in (0, 1):
    assert (P.get_frag_vertex_offset(stores[1], fid, 'person')
            == J.get_frag_vertex_offset(stores[0], fid, 'person'))
    assert (P.get_frag_vertex_num(stores[1], fid, 'person')
            == J.get_frag_vertex_num(stores[0], fid, 'person'))


@pytest.mark.parametrize('edge_dir', ['out', 'in'])
def test_vineyard_dataset_matches_jax(stores, edge_dir):
  if edge_dir == 'in':
    stores = _csc_stores()
  jds = J.load_vineyard_dataset(stores[0], [1, 0], 'person', 'knows',
                                vcols=['age', 'w'], edge_dir=edge_dir)
  ds = P.load_vineyard_dataset(stores[1], [1, 0], 'person', 'knows',
                               vcols=['age', 'w'], edge_dir=edge_dir,
                               device='cpu')
  assert ds.edge_dir == edge_dir
  _assert_topo_equal(jds.get_graph().topo, ds.get_graph().topo)
  np.testing.assert_array_equal(ds.get_node_feature().table.numpy(),
                                jds.get_node_feature()[np.arange(20)])


def test_vineyard_dataset_samples_as_jax(stores):
  jds = J.load_vineyard_dataset(stores[0], [0, 1], 'person', 'knows',
                                vcols=['age'])
  ds = P.load_vineyard_dataset(stores[1], [0, 1], 'person', 'knows',
                               vcols=['age'], device='cpu')
  seeds = np.array([0, 15])
  key = jax.random.key(3)
  want = JaxNeighborSampler(jds.get_graph(), [2, 1], seed=0
                            ).sample_from_nodes(seeds, key=key)
  from test_torch_weighted_sampling import hop_uniforms_from_key
  ps = NeighborSampler(ds.get_graph(), [2, 1], device='cpu', seed=0)
  got = ps.sample_from_nodes(seeds, uniforms=hop_uniforms_from_key(key, 2,
                                                                    ps))
  n = int(want.node_count)
  assert int(got.node_count) == n
  np.testing.assert_array_equal(got.node.numpy()[:n],
                                np.asarray(want.node)[:n])
  assert set(got.node.numpy()[:n].tolist()) >= {0, 15, 1, 2, 16, 17}


def test_socket_path_raises_as_jax():
  with pytest.raises((ImportError, NotImplementedError)) as want:
    J.vineyard_to_csr('/tmp/vineyard.sock', 0, 'person', 'knows')
  with pytest.raises((ImportError, NotImplementedError)) as got:
    P.load_vineyard_dataset('/tmp/vineyard.sock', [0], 'person', 'knows',
                            device='cpu')
  assert type(got.value) is type(want.value)
  assert str(got.value) == str(want.value)
