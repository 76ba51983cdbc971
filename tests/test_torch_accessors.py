"""The port's public accessors against the JAX package's on the same data:
the batch and sampler-output views, the sampler inputs' ``share_memory``,
``NeighborOutput.nbrs_num``, ``Graph.degree``, ``Snapshot.num_rows``, the
client's health and metrics getters, ``to_torch_data`` and the profiler
trace. Integer views compare exactly.

A homogeneous sampler output comes from the port's sampler on the CPU;
the JAX structures are built from the same arrays, so each accessor reads
the same values in both packages.
"""
import dataclasses
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.data.graph import Graph as JaxGraph
from glt_tpu.data.topology import Topology as JaxTopology
from glt_tpu.distributed import dist_client as jax_client
from glt_tpu.loader import transform as jax_transform
from glt_tpu.ops.sample import NeighborOutput as JaxNeighborOutput
from glt_tpu.sampler import base as jax_base
from glt_tpu.stream.snapshot import Snapshot as JaxSnapshot
from glt_tpu_torch.data import Graph, Topology
from glt_tpu_torch.distributed import dist_client
from glt_tpu_torch.loader import (HeteroBatch, to_batch, to_hetero_batch,
                                  to_torch_data)
from glt_tpu_torch.ops.sample import NeighborOutput
from glt_tpu_torch.sampler import (BaseSampler, EdgeSamplerInput,
                                   HeteroSamplerOutput, NeighborSampler,
                                   NodeSamplerInput, SamplerOutput)
from glt_tpu_torch.stream.snapshot import Snapshot
from glt_tpu_torch.utils import profile

N, E = 200, 1500
U2I = ('user', 'u2i', 'item')
I2U = ('item', 'rev_u2i', 'user')


def _edge_index(seed=0):
  rng = np.random.default_rng(seed)
  return np.stack([rng.integers(0, N, E), rng.integers(0, N, E)])


@pytest.fixture(scope='module')
def sampled():
  """A port sampler output over a 200-node graph (8 seeds, [3, 2]) and
  the same arrays as JAX's SamplerOutput."""
  graph = Graph(Topology(edge_index=torch.as_tensor(_edge_index()),
                         num_nodes=N), device='cpu')
  sampler = NeighborSampler(graph, [3, 2], device='cpu', with_edge=True,
                            seed=0)
  out = sampler.sample_from_nodes(np.arange(0, 16, 2))
  fields = {f.name: getattr(out, f.name)
            for f in dataclasses.fields(SamplerOutput)}
  jout = jax_base.SamplerOutput(**{
      k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
      for k, v in fields.items()})
  return sampler, out, jout


def _np(a):
  return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_batch_views_match_jax(sampled):
  _, out, jout = sampled
  rng = np.random.default_rng(1)
  cap = out.node.shape[0]
  x = rng.standard_normal((cap, 5)).astype(np.float32)
  y = rng.integers(0, 3, 8).astype(np.int32)
  attr = rng.standard_normal((out.row.shape[0], 2)).astype(np.float32)
  b = to_batch(out, x=torch.as_tensor(x), y=torch.as_tensor(y),
               edge_attr=torch.as_tensor(attr))
  jb = jax_transform.to_batch(jout, x=jnp.asarray(x), y=jnp.asarray(y),
                              edge_attr=jnp.asarray(attr))
  assert out.batch_size == jout.batch_size == 8
  assert b.batch_size == jb.batch_size == 8
  assert b.num_nodes == jb.num_nodes == cap
  np.testing.assert_array_equal(_np(b.edge_index), _np(jb.edge_index))
  assert tuple(b.edge_index.shape) == (2, out.row.shape[0])
  np.testing.assert_array_equal(_np(b.batch), _np(jb.batch))
  np.testing.assert_array_equal(_np(b.edge_attr), _np(jb.edge_attr))
  empty = dataclasses.replace(out, batch=None)
  assert empty.batch_size is None
  assert jax_base.SamplerOutput(**{**vars(jout), 'batch': None}
                                ).batch_size is None


def _hetero_output(pkg):
  """A padded two-type output: 3 user seeds, -1 padding, in the
  structures of ``pkg`` (the port's sampler module or JAX's)."""
  rng = np.random.default_rng(2)
  arr = (lambda a: torch.as_tensor(a)) if pkg is None else jnp.asarray
  node = {'user': np.array([4, 9, 1, 7, -1, -1], np.int32),
          'item': np.array([3, 0, 8, 2, 5, -1, -1, -1], np.int32)}
  row = {I2U: rng.integers(0, 5, 10).astype(np.int32),
         U2I: rng.integers(0, 4, 7).astype(np.int32)}
  col = {I2U: rng.integers(0, 4, 10).astype(np.int32),
         U2I: rng.integers(0, 5, 7).astype(np.int32)}
  mask = {k: rng.random(v.shape[0]) < 0.7 for k, v in row.items()}
  cls = HeteroSamplerOutput if pkg is None else pkg.HeteroSamplerOutput
  return cls(
      node={k: arr(v) for k, v in node.items()},
      node_count={'user': arr(np.int32(4)), 'item': arr(np.int32(5))},
      row={k: arr(v) for k, v in row.items()},
      col={k: arr(v) for k, v in col.items()},
      edge_mask={k: arr(v) for k, v in mask.items()},
      batch={'user': arr(node['user'][:3])}, input_type='user',
      metadata={'edge_hop_offsets': {I2U: [0, 4, 10], U2I: [0, 3, 7]}})


def test_hetero_views_match_jax():
  out, jout = _hetero_output(None), _hetero_output(jax_base)
  got, want = out.get_edge_index(), jout.get_edge_index()
  assert set(got) == set(want) == {I2U, U2I}
  for k in got:
    np.testing.assert_array_equal(_np(got[k]), _np(want[k]))
  b = to_hetero_batch(out)
  jb = jax_transform.to_hetero_batch(jout)
  assert isinstance(b, HeteroBatch) and b.batch_size == jb.batch_size == 3
  np.testing.assert_array_equal(_np(b.batch), _np(jb.batch))
  got, want = b.edge_index_dict(), jb.edge_index_dict()
  assert set(got) == set(want)
  for k in got:
    np.testing.assert_array_equal(_np(got[k]), _np(want[k]))


def test_share_memory_and_edge_permutation_match_jax(sampled):
  seeds = np.arange(5)
  for cls, jcls, args in (
      (NodeSamplerInput, jax_base.NodeSamplerInput, (seeds,)),
      (EdgeSamplerInput, jax_base.EdgeSamplerInput, (seeds, seeds[::-1]))):
    port, ref = cls(*args), jcls(*args)
    assert port.share_memory() is port and ref.share_memory() is ref
  assert BaseSampler().edge_permutation is None
  assert jax_base.BaseSampler().edge_permutation is None
  assert sampled[0].edge_permutation is None


def test_nbrs_num_matches_jax():
  rng = np.random.default_rng(3)
  mask = rng.random((9, 4)) < 0.6
  nbrs = rng.integers(0, 50, (9, 4)).astype(np.int32)
  got = NeighborOutput(torch.as_tensor(nbrs), torch.as_tensor(mask)).nbrs_num
  want = JaxNeighborOutput(jnp.asarray(nbrs), jnp.asarray(mask),
                           None).nbrs_num
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('layout', ['CSR', 'CSC'])
def test_graph_degree_matches_jax(layout):
  ei = _edge_index(4)
  graph = Graph(Topology(edge_index=torch.as_tensor(ei), num_nodes=N,
                         layout=layout), device='cpu')
  jgraph = JaxGraph(JaxTopology(edge_index=ei, num_nodes=N, layout=layout))
  ids = np.array([0, 5, 199, 77, 5])
  np.testing.assert_array_equal(graph.degree(ids).numpy(),
                                jgraph.degree(ids))
  np.testing.assert_array_equal(graph.degree(torch.arange(N)).numpy(),
                                jgraph.degree(np.arange(N)))


def test_snapshot_num_rows_matches_jax():
  # a bipartite CSR: 150 rows (the pointer axis), 300 columns
  rng = np.random.default_rng(5)
  ei = np.stack([rng.integers(0, 150, 400), rng.integers(0, 300, 400)])
  snap = Snapshot(3, Topology(edge_index=torch.as_tensor(ei), num_rows=150,
                              num_cols=300), None, 512, torch.device('cpu'))
  jsnap = JaxSnapshot(3, JaxTopology(edge_index=ei, num_rows=150,
                                     num_cols=300), None, 512)
  assert snap.num_rows == jsnap.num_rows == 150
  assert snap.num_edges == jsnap.num_edges == 400


def test_client_getters_read_the_session(monkeypatch):
  for mod in (dist_client, jax_client):
    health, metrics = object(), object()
    monkeypatch.setattr(mod, '_health', health)
    monkeypatch.setattr(mod, '_metrics', metrics)
    assert mod.get_health() is health and mod.get_metrics() is metrics
    monkeypatch.setattr(mod, '_health', None)
    monkeypatch.setattr(mod, '_metrics', None)
    assert mod.get_health() is None and mod.get_metrics() is None


def test_to_torch_data_matches_jax(sampled, monkeypatch):
  _, out, jout = sampled
  cap = out.node.shape[0]
  x = np.random.default_rng(6).standard_normal((cap, 3)).astype(np.float32)
  y = np.arange(8, dtype=np.int32)
  b = to_batch(out, x=torch.as_tensor(x), y=torch.as_tensor(y))
  jb = jax_transform.to_batch(jout, x=jnp.asarray(x), y=jnp.asarray(y))
  if 'torch_geometric' not in sys.modules:
    # neither machine has torch_geometric: both raise ImportError
    import importlib.util
    if importlib.util.find_spec('torch_geometric') is None:
      with pytest.raises(ImportError):
        to_torch_data(b)
      with pytest.raises(ImportError):
        jax_transform.to_torch_data(jb)
  # field for field against JAX's, through a stand-in Data class
  class Data:
    def __init__(self, **kw):
      self.__dict__.update(kw)
  pyg = types.ModuleType('torch_geometric')
  pyg_data = types.ModuleType('torch_geometric.data')
  pyg_data.Data = Data
  pyg.data = pyg_data
  monkeypatch.setitem(sys.modules, 'torch_geometric', pyg)
  monkeypatch.setitem(sys.modules, 'torch_geometric.data', pyg_data)
  got, want = to_torch_data(b), jax_transform.to_torch_data(jb)
  assert set(vars(got)) == set(vars(want))
  for k, v in vars(want).items():
    g = vars(got)[k]
    if isinstance(v, torch.Tensor):
      assert g.dtype == v.dtype, k
      np.testing.assert_array_equal(g.numpy(), v.numpy(), err_msg=k)
    else:
      assert g == v, k


def test_profile_trace_writes_a_chrome_trace(tmp_path):
  log_dir = str(tmp_path / 'trace')
  with profile.trace(log_dir):
    with profile.annotate('glt.test.region'):
      torch.ones(64).sum()
  path = os.path.join(log_dir, 'trace.json')
  with open(path) as f:
    events = json.load(f)['traceEvents']
  assert any(e.get('name') == 'glt.test.region' for e in events)
