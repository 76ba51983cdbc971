"""Graph sizes in the port when no node count is given, against the JAX
package: each axis one past its own largest id, in CSR and CSC,
homogeneous and hetero (``num_nodes`` absent, keyed by NodeType, keyed
by EdgeType, one int), and what reads the sizes: ``random_node_split``
and the rows ``RandomNegativeSampler`` draws from.

The graph's largest src (49) is below its largest dst (89), so a square
graph over the largest id at either end would differ from JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.data import Topology as JaxTopology
from glt_tpu.sampler import RandomNegativeSampler as JaxRandomNegativeSampler
from glt_tpu_torch.data import Dataset, Topology
from glt_tpu_torch.sampler import RandomNegativeSampler
from glt_tpu_torch.typing import Split

E, N_SRC, N_DST = 300, 50, 90
U2V, V2U, U2U = ('u', 'to', 'v'), ('v', 'rev', 'u'), ('u', 'self', 'u')


def _edges(seed=0):
  rng = np.random.default_rng(seed)
  ei = np.stack([rng.integers(0, N_SRC, E), rng.integers(0, N_DST, E)])
  ei[:, 0] = (N_SRC - 1, N_DST - 1)      # both axes reach their largest id
  return ei


def _assert_topo_equal(want, got):
  assert (got.num_rows, got.num_cols) == (want.num_rows, want.num_cols)
  np.testing.assert_array_equal(got.indptr.numpy(), want.indptr)
  np.testing.assert_array_equal(got.indices.numpy(), want.indices)
  np.testing.assert_array_equal(got.edge_ids.numpy(), want.edge_ids)


@pytest.mark.parametrize('layout', ['CSR', 'CSC'])
def test_topology_sizes_each_axis_on_its_own(layout):
  ei = _edges()
  want = JaxTopology(edge_index=ei, layout=layout)
  got = Topology(ei, layout=layout, device='cpu')
  _assert_topo_equal(want, got)
  rows, cols = (N_SRC, N_DST) if layout == 'CSR' else (N_DST, N_SRC)
  assert (got.num_rows, got.num_cols) == (rows, cols)
  # one axis given: the other is still one past its own largest id
  for kw in (dict(num_rows=rows + 7), dict(num_cols=cols + 3)):
    _assert_topo_equal(JaxTopology(edge_index=ei, layout=layout, **kw),
                       Topology(ei, layout=layout, device='cpu', **kw))


@pytest.mark.parametrize('edge_dir', ['out', 'in'])
def test_dataset_split_and_negatives_match_jax(edge_dir):
  ei = _edges()
  jds = JaxDataset(edge_dir=edge_dir).init_graph(edge_index=ei)
  ds = Dataset(edge_dir=edge_dir).init_graph(ei, device='cpu')
  _assert_topo_equal(jds.get_graph().topo, ds.get_graph().topo)
  assert ds.node_count() == jds.node_count()
  jds.random_node_split(0.1, 0.1)
  ds.random_node_split(0.1, 0.1)
  for split in (Split.train, Split.valid, Split.test):
    np.testing.assert_array_equal(ds.get_split(split),
                                  jds.get_split(split.value))
  n = N_SRC if edge_dir == 'out' else N_DST
  assert sum(ds.get_split(s).size for s in Split) == n
  # the negatives: JAX's key, drawn over the port graph's own axes
  g, req, trials = ds.get_graph(), 200, 3
  for strict in (True, False):
    js = JaxRandomNegativeSampler(jds.get_graph(), edge_dir=edge_dir,
                                  mode='strict' if strict else 'non-strict')
    key = jax.random.key(5)
    want = js.sample(req, trials_num=trials, padding=False, key=key)
    props = tuple(torch.as_tensor(np.array(jax.random.randint(
        k, (trials, req), 0, m, dtype=jnp.int32)))
                  for k, m in zip(jax.random.split(key),
                                  (g.topo.num_rows, g.topo.num_cols)))
    got = RandomNegativeSampler(g, edge_dir=edge_dir).sample(
        req, trials_num=trials, padding=False, strict=strict,
        proposals=props)
    for f in ('rows', 'cols', 'mask'):
      np.testing.assert_array_equal(getattr(got, f).numpy(),
                                    np.asarray(getattr(want, f)), err_msg=f)
    assert int(got.rows[got.mask].max()) < N_SRC


@pytest.mark.parametrize('edge_dir', ['out', 'in'])
@pytest.mark.parametrize('num_nodes', [
    None, {'u': 60, 'v': 95}, {'v': 95}, {U2V: 100, V2U: 110, U2U: 70}, 120],
    ids=['absent', 'by-node-type', 'one-node-type', 'by-edge-type', 'int'])
def test_hetero_graph_sizes_match_jax(edge_dir, num_nodes):
  ei = _edges()
  rng = np.random.default_rng(1)
  edges = {U2V: ei, V2U: ei[::-1].copy(),
           U2U: np.stack([rng.integers(0, 30, 40), rng.integers(0, 45, 40)])}
  jds = JaxDataset(edge_dir=edge_dir).init_graph(edge_index=edges,
                                                 num_nodes=num_nodes)
  ds = Dataset(edge_dir=edge_dir).init_graph(edges, num_nodes=num_nodes,
                                             device='cpu')
  for etype in edges:
    _assert_topo_equal(jds.get_graph(etype).topo, ds.get_graph(etype).topo)
  assert ds.get_node_types() == jds.get_node_types()
  for t in ('u', 'v'):
    assert ds.node_count(t) == jds.node_count(t), t
