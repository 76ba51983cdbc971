"""The CSC layout in the port (``Topology(layout='CSC')``,
``Topology.flip_layout``, ``Dataset(edge_dir='in')``) and sampling along
in-edges (``NeighborSampler(edge_dir='in')``) against the JAX package on
the same numpy inputs and the same uniforms.

The compressed arrays must equal the JAX ones exactly (indptr, indices,
edge ids, weights, axis sizes). The samplers' outputs must match bit for
bit: the homogeneous walk and the per-hop loop against the JAX sampler on
``GLT_DEDUP=sort GLT_FUSED_HOP=1`` (weighted and -1 hops on its TPU
path: window reads through the interpret-mode Pallas ``gather_windows``),
the hetero sampler against its per-edge-type sorted reference, with the
edge keys kept as the traversal types.
"""
import jax
import numpy as np
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.data import Topology as JaxTopology
from glt_tpu.ops.sample import walk_hop_uniforms as jax_walk_hop_uniforms
from glt_tpu.sampler import NeighborSampler as JaxSampler
from glt_tpu.sampler.base import NodeSamplerInput as JaxInput
from glt_tpu.utils.rng import make_key
from glt_tpu_torch.data import Dataset, Topology
from glt_tpu_torch.ops.sample import walk_geometry
from glt_tpu_torch.sampler import NeighborSampler
from glt_tpu_torch.sampler.base import NodeSamplerInput
from test_torch_hetero_sampling import _jax_hetero_uniforms
from test_torch_weighted_sampling import hop_uniforms_from_key, to_tpu_path

N = 70
EXACT_KEYS = ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch',
              'num_sampled_nodes', 'num_sampled_edges')
U2I = ('user', 'u2i', 'item')
I2I = ('item', 'i2i', 'item')
I2T = ('item', 'i2t', 'tag')


def _edges(seed=0, n=N, e=600):
  """Skewed in-degrees (dst squared-uniform), duplicate edges, weights in
  (0, 1] with some zeros."""
  rng = np.random.default_rng(seed)
  ei = np.stack([rng.integers(0, n, e), (rng.random(e) ** 2 * n).astype(
      np.int64)])
  ei[:, :30] = ei[:, 30:60]
  w = (1.0 - rng.random(e)).astype(np.float32)
  w[::13] = 0.0
  return ei, w


def _assert_topo_equal(want, got):
  assert got.layout == want.layout
  assert (got.num_rows, got.num_cols) == (want.num_rows, want.num_cols)
  np.testing.assert_array_equal(got.indptr.numpy(), want.indptr)
  np.testing.assert_array_equal(got.indices.numpy(), want.indices)
  np.testing.assert_array_equal(got.edge_ids.numpy(), want.edge_ids)
  if want.edge_weights is None:
    assert got.edge_weights is None
  else:
    np.testing.assert_array_equal(got.edge_weights.numpy(),
                                  want.edge_weights)


@pytest.mark.parametrize('axes', [dict(num_nodes=N),
                                  dict(num_rows=N + 3, num_cols=N + 5)])
def test_csc_topology_and_flip_match_jax(axes):
  ei, w = _edges()
  eids = np.random.default_rng(1).permutation(ei.shape[1]) * 3
  for layout in ('CSR', 'CSC'):
    want = JaxTopology(edge_index=ei, edge_ids=eids, edge_weights=w,
                       layout=layout, **axes)
    got = Topology(ei, edge_ids=eids, edge_weights=w, layout=layout,
                   device='cpu', **axes)
    _assert_topo_equal(want, got)
    flipped = got.flip_layout()
    _assert_topo_equal(want.flip_layout(), flipped)
    _assert_topo_equal(want, flipped.flip_layout())
  with pytest.raises(ValueError, match='layout'):
    Topology(ei, layout='DCSR', device='cpu')


def _three_type_edges():
  rng = np.random.default_rng(7)
  nu, ni, nt = 9, 25, 6
  ei = {U2I: np.stack([rng.integers(0, nu, 30), rng.integers(0, ni, 30)]),
        I2I: np.stack([rng.integers(0, ni, 70), rng.integers(0, ni, 70)]),
        I2T: np.stack([rng.integers(0, ni, 20), rng.integers(0, nt, 20)])}
  eids = {e: np.arange(v.shape[1]) * 2 + 1 for e, v in ei.items()}
  return ei, eids, {'user': nu, 'item': ni, 'tag': nt}


def _hetero_datasets():
  ei, eids, counts = _three_type_edges()
  jds = JaxDataset(edge_dir='in').init_graph(edge_index=ei, edge_ids=eids,
                                             num_nodes=counts)
  ds = Dataset(edge_dir='in').init_graph(ei, edge_ids=eids, num_nodes=counts,
                                         device='cpu')
  return jds, ds


def test_in_edge_datasets_match_jax():
  ei, w = _edges(2)
  jds = JaxDataset(edge_dir='in').init_graph(edge_index=ei, edge_weights=w,
                                             num_nodes=N)
  ds = Dataset(edge_dir='in').init_graph(ei, edge_weights=w, num_nodes=N,
                                         device='cpu')
  assert ds.get_graph().layout == 'CSC'
  _assert_topo_equal(jds.get_graph().topo, ds.get_graph().topo)
  jds, ds = _hetero_datasets()
  assert ds.get_node_types() == jds.get_node_types()
  assert ds.get_edge_types() == jds.get_edge_types()
  for t in ds.get_node_types():
    assert ds.node_count(t) == jds.node_count(t)
  for e in ds.get_edge_types():
    assert ds.get_graph(e).layout == 'CSC'
    _assert_topo_equal(jds.get_graph(e).topo, ds.get_graph(e).topo)
  with pytest.raises(ValueError, match='edge_dir'):
    Dataset(edge_dir='both')
  # a sampler reads the layout its edge_dir names
  with pytest.raises(ValueError, match='CSC'):
    NeighborSampler(ds.graph, [2], device='cpu')


def _homo_samplers(fanouts, with_weight, monkeypatch):
  ei, w = _edges(3)
  jds = JaxDataset(edge_dir='in').init_graph(edge_index=ei, edge_weights=w,
                                             num_nodes=N)
  js = JaxSampler(jds.get_graph(), fanouts, with_weight=with_weight,
                  edge_dir='in', seed=5)
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  if with_weight or any(f < 0 for f in fanouts):
    to_tpu_path(js, monkeypatch)
  ds = Dataset(edge_dir='in').init_graph(ei, edge_weights=w, num_nodes=N,
                                         device='cpu')
  ps = NeighborSampler(ds.get_graph(), fanouts, device='cpu',
                       with_weight=with_weight, edge_dir='in', seed=5)
  return js, ps


@pytest.mark.parametrize('fanouts,with_weight', [
    ([3, 2], False), ([3, 2], True), ([3, -1], False)])
def test_homogeneous_in_edge_sampling_matches_jax(fanouts, with_weight,
                                                  monkeypatch):
  """The walk (uniform positive fanouts) and the per-hop loop (weighted
  and -1 hops) read the CSC's indptr and indices as they read a CSR's."""
  js, ps = _homo_samplers(fanouts, with_weight, monkeypatch)
  assert ps._per_hop == (with_weight or -1 in fanouts)
  seeds = np.array([3, 0, 3, 41, 69, 12, 1, 60], np.int32)
  for step, nv in ((1, 8), (2, 6)):
    key = jax.random.fold_in(make_key(5), step)
    want = js.sample_from_nodes(seeds, n_valid=nv)
    if ps._per_hop:
      u = hop_uniforms_from_key(key, 8, ps)
    else:
      u = [torch.as_tensor(np.array(x)[:s]) for x, (s, _) in zip(
          jax_walk_hop_uniforms(key, 8, tuple(fanouts), False),
          walk_geometry(8, fanouts))]
    got = ps.sample_from_nodes(seeds, n_valid=nv, uniforms=u)
    for f in EXACT_KEYS:
      np.testing.assert_array_equal(getattr(got, f).numpy(),
                                    np.asarray(getattr(want, f)), err_msg=f)
    assert got.edge_hop_offsets == want.edge_hop_offsets
    assert int(got.num_sampled_edges[-1]) > 0


@pytest.mark.parametrize('seed_type,seeds,nv,with_edge,replace', [
    ('item', [5, 5, 17, 0, 24], 5, False, False),
    ('tag', [1, 4, 4, 0], 3, True, False),
    ('item', [0, 7, 7, 3, 19], 4, False, True)])
def test_hetero_in_edge_sampler_matches_jax(seed_type, seeds, nv, with_edge,
                                            replace, monkeypatch):
  """In-edges of a CSC expand dst into src: seeds of 'tag' reach items
  through i2t, items reach users through u2i. The keys stay the traversal
  types."""
  jds, ds = _hetero_datasets()
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  kw = dict(with_edge=with_edge, replace=replace, edge_dir='in', seed=5)
  js = JaxSampler(jds.graph, [3, 2], **kw)
  ps = NeighborSampler(ds.graph, [3, 2], device='cpu', **kw)
  assert ps._traversal_types() == js._traversal_types()
  seeds = np.asarray(seeds, np.int64)
  want = js.sample_from_nodes(JaxInput(seeds, seed_type), n_valid=nv)
  u = _jax_hetero_uniforms(jax.random.fold_in(make_key(5), 1), js,
                           {seed_type: seeds.size}, replace=replace)
  got = ps.sample_from_nodes(NodeSamplerInput(seeds, seed_type), n_valid=nv,
                             uniforms=u)
  assert set(got.row) == set(want.row) <= set(ds.get_edge_types())
  for f in ('node', 'node_count', 'batch', 'num_sampled_nodes'):
    assert set(getattr(got, f)) == set(getattr(want, f)), f
    for t, v in getattr(want, f).items():
      np.testing.assert_array_equal(getattr(got, f)[t].numpy(),
                                    np.asarray(v), err_msg=f'{f}[{t}]')
  for f in ('row', 'col', 'edge_mask', 'num_sampled_edges'):
    for e, v in getattr(want, f).items():
      np.testing.assert_array_equal(getattr(got, f)[e].numpy(),
                                    np.asarray(v), err_msg=f'{f}[{e}]')
  assert got.metadata['edge_hop_offsets'] == want.metadata['edge_hop_offsets']
  if with_edge:
    for e, v in want.edge.items():
      m = np.asarray(want.edge_mask[e]).astype(bool)
      np.testing.assert_array_equal(got.edge[e].numpy()[m], np.asarray(v)[m],
                                    err_msg=f'edge[{e}]')
  assert sum(int(c) for c in got.node_count.values()) > len(set(
      seeds[:nv].tolist()))
