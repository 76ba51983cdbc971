"""The port's storage and sampling path (glt_tpu_torch.data, ops.pipeline,
sampler) against the JAX package on the same numpy inputs and the same
uniforms (drawn from the JAX key sequence and injected).

References: the JAX cross-hop walk (``GLT_HOP_ENGINE=pallas_fused``,
``GLT_FUSED_WALK=cross``, its kernel in interpret mode) and the fast XLA
``GLT_DEDUP=sort GLT_FUSED_HOP=1`` engine it is bit-identical to. The
output surfaces of ``EXACT_KEYS`` must match bit for bit; ``edge`` on
valid lanes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.data import Topology as JaxTopology
from glt_tpu.ops.pallas_kernels import fused_table_slots
from glt_tpu.ops.pipeline import make_dedup_tables
from glt_tpu.ops.pipeline import multihop_sample as jax_multihop_sample
from glt_tpu.ops.pipeline import sample_budget
from glt_tpu.ops.sample import FusedHopPlan as JaxPlan
from glt_tpu.ops.sample import sample_neighbors
from glt_tpu.ops.sample import walk_hop_uniforms as jax_walk_hop_uniforms
from glt_tpu_torch.data import Dataset, Topology
from glt_tpu_torch.ops.cuda_kernels import walk_table_slots
from glt_tpu_torch.ops.pipeline import multihop_sample
from glt_tpu_torch.ops.sample import FusedHopPlan, walk_geometry
from glt_tpu_torch.sampler import NeighborSampler

W = 8

EXACT_KEYS = ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch',
              'seed_labels', 'seed_count', 'num_sampled_nodes',
              'num_sampled_edges')


def _edges(n=64, e=600, seed=0, src_hi=None):
  """COO edges; ``src_hi`` < n leaves rows src_hi..n-1 with degree 0."""
  rng = np.random.default_rng(seed)
  return np.stack([rng.integers(0, src_hi or n, e), rng.integers(0, n, e)])


def _jax_graph(ei, n):
  t = JaxTopology(edge_index=ei, num_nodes=n)
  indptr = jnp.asarray(t.indptr.astype(np.int32))
  indices = jnp.asarray(t.indices)
  eids = jnp.arange(indices.shape[0], dtype=jnp.int32) * 3
  return dict(n=n, topo=t, indptr=indptr, indices=indices, eids=eids,
              iw=jnp.concatenate([indices, jnp.full((W,), -1, jnp.int32)]),
              ew=jnp.concatenate([eids, jnp.full((W,), -1, jnp.int32)]),
              n_hub=int((np.diff(t.indptr) > W).sum()))


_SORT_FUSED = {}


def _jax_sort_fused(g, seeds, nv, fanouts, key, monkeypatch,
                    with_edge=False, replace=False):
  """The sort+fused reference as one jitted program, the graph passed as
  arguments, so cases of one shape share a compile."""
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  sig = (tuple(fanouts), with_edge, replace)
  if sig not in _SORT_FUSED:
    def run(indptr, indices, eids, seeds, nv, key, table, scratch):
      def one_hop(ids, f, k, m):
        return sample_neighbors(indptr, indices, ids, f, k, seed_mask=m,
                                replace=replace,
                                edge_ids=eids if with_edge else None)
      return jax_multihop_sample(one_hop, seeds, nv, fanouts, key, table,
                                 scratch, with_edge=with_edge)[0]
    _SORT_FUSED[sig] = jax.jit(run)
  table, scratch = make_dedup_tables(g['n'])
  out = _SORT_FUSED[sig](g['indptr'], g['indices'], g['eids'],
                         jnp.asarray(seeds), jnp.asarray(nv, jnp.int32), key,
                         table, scratch)
  monkeypatch.delenv('GLT_DEDUP')
  monkeypatch.delenv('GLT_FUSED_HOP')
  return jax.tree.map(np.asarray, out)


def _jax_walk(g, seeds, nv, fanouts, key, monkeypatch, with_edge=False):
  monkeypatch.setenv('GLT_FUSED_WALK', 'cross')
  b = seeds.shape[0]
  plan = JaxPlan(g['indptr'], g['indices'], g['iw'], W, g['n_hub'],
                 fused_table_slots(sample_budget(b, list(fanouts))),
                 edge_ids=g['eids'] if with_edge else None,
                 edge_ids_win=g['ew'] if with_edge else None,
                 interpret=True)
  table, scratch = make_dedup_tables(g['n'])
  out, _, _ = jax_multihop_sample(None, jnp.asarray(seeds),
                                  jnp.asarray(nv), fanouts, key, table,
                                  scratch, with_edge=with_edge,
                                  fused_plan=plan)
  return jax.tree.map(np.asarray, out)


def _port(ei, n, seeds, nv, fanouts, key, with_edge=False, replace=False):
  topo = Topology(ei, num_nodes=n, device='cpu')
  indptr_pad = torch.cat([topo.indptr.to(torch.int32),
                          torch.tensor([topo.num_edges], dtype=torch.int32)])
  b = seeds.shape[0]
  plan = FusedHopPlan(indptr_pad, topo.indices,
                      walk_table_slots(sample_budget(b, list(fanouts))),
                      edge_ids=torch.arange(topo.num_edges) * 3,
                      replace=replace)
  u = [torch.as_tensor(np.asarray(x)[:s]) for x, (s, _) in zip(
      jax_walk_hop_uniforms(key, b, fanouts, replace),
      walk_geometry(b, fanouts))]
  out = multihop_sample(plan, torch.as_tensor(seeds), nv, fanouts,
                        u_hops=u, with_edge=with_edge)
  return {k: v.numpy() for k, v in out.items()}


def _assert_same(ref, got, with_edge=False):
  for k in EXACT_KEYS:
    np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
  if with_edge:
    m = ref['edge_mask'].astype(bool)
    np.testing.assert_array_equal(ref['edge'][m], got['edge'][m])


def test_topology_csr_order_matches_jax():
  ei = _edges(seed=1)
  ei[:, :40] = ei[:, 40:80]  # duplicate edges keep input order
  want = JaxTopology(edge_index=ei, num_nodes=64)
  got = Topology(ei, num_nodes=64, device='cpu')
  np.testing.assert_array_equal(want.indptr, got.indptr.numpy())
  np.testing.assert_array_equal(want.indices, got.indices.numpy())
  np.testing.assert_array_equal(want.edge_ids, got.edge_ids.numpy())


def test_walk_bit_identical_to_jax_cross_walk(monkeypatch):
  ei = _edges(seed=2)
  g = _jax_graph(ei, 64)
  seeds = np.array([5, 0, 5, 17, 63, 2, 2, 9], np.int32)
  key = jax.random.key(9)
  # no edge-id plane: the interpret-mode kernel then compiles to the same
  # program as test_torch_kernels.py's (one compile per process)
  ref = _jax_walk(g, seeds, 7, (3, 2), key, monkeypatch)
  _assert_same(ref, _port(ei, 64, seeds, 7, (3, 2), key))


@pytest.mark.parametrize('case', [
    'dup_seeds', 'n_valid_lt_batch', 'no_valid_seeds', 'degree0_rows',
    'replace', 'with_edge'])
def test_walk_bit_identical_to_sort_fused(monkeypatch, case):
  n, fanouts, nv, replace, with_edge = 64, (3, 2), 8, False, False
  seeds = np.array([5, 0, 5, 17, 63, 2, 2, 9], np.int32)
  ei = _edges(seed=3)
  if case == 'n_valid_lt_batch':
    nv = 5
  elif case == 'no_valid_seeds':
    nv = 0
  elif case == 'degree0_rows':
    ei = _edges(seed=3, src_hi=40)
    seeds = np.array([50, 3, 60, 41, 7, 63, 40, 1], np.int32)
  elif case == 'replace':
    replace = True
  elif case == 'with_edge':
    with_edge, nv = True, 7
  key = jax.random.key(11)
  ref = _jax_sort_fused(_jax_graph(ei, n), seeds, nv, fanouts, key,
                        monkeypatch, with_edge=with_edge, replace=replace)
  got = _port(ei, n, seeds, nv, fanouts, key, with_edge=with_edge,
              replace=replace)
  _assert_same(ref, got, with_edge=with_edge)
  if case == 'no_valid_seeds':
    assert int(got['node_count']) == 0


def test_sampler_matches_jax_sampler_on_injected_uniforms(monkeypatch):
  # the homogeneous NeighborSampler end to end: JAX's sampler forced onto
  # the sort+fused engine draws with fold_in(key(seed), step); the port's
  # takes the same uniforms injected
  from glt_tpu.data import Dataset as JaxDataset
  from glt_tpu.sampler import NeighborSampler as JaxSampler
  from glt_tpu.utils.rng import make_key
  ei = _edges(seed=4)
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  jds = JaxDataset().init_graph(edge_index=ei, num_nodes=64)
  js = JaxSampler(jds.get_graph(), [3, 2], seed=5)
  ds = Dataset().init_graph(ei, num_nodes=64, device='cpu')
  ps = NeighborSampler(ds.get_graph(), [3, 2], device='cpu', seed=5)
  seeds = np.array([9, 9, 1, 30, 2, 2, 60, 4], np.int32)
  for step in (1, 2):
    want = js.sample_from_nodes(seeds, n_valid=6)
    u = jax_walk_hop_uniforms(jax.random.fold_in(make_key(5), step), 8,
                              (3, 2), False)
    u = [torch.as_tensor(np.asarray(x)[:s])
         for x, (s, _) in zip(u, walk_geometry(8, (3, 2)))]
    got = ps.sample_from_nodes(seeds, n_valid=6, uniforms=u)
    for f in ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch',
              'num_sampled_nodes', 'num_sampled_edges'):
      np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                    getattr(got, f).numpy(), err_msg=f)
    assert got.edge_hop_offsets == want.edge_hop_offsets


def test_sampler_draws_from_its_own_generator():
  ei = _edges(seed=6)
  ds = Dataset().init_graph(ei, num_nodes=64, device='cpu')
  a = NeighborSampler(ds.get_graph(), [4, 3], device='cpu', seed=1)
  b = NeighborSampler(ds.get_graph(), [4, 3], device='cpu', seed=1)
  seeds = np.arange(8)
  for _ in range(2):
    oa, ob = a.sample_from_nodes(seeds), b.sample_from_nodes(seeds)
    assert torch.equal(oa.node, ob.node) and torch.equal(oa.row, ob.row)
  # -1 hops run the per-hop loop, which samples edge ids too
  full = NeighborSampler(ds.get_graph(), [-1], device='cpu', with_edge=True)
  assert full.sample_from_nodes(seeds).edge is not None
  # without injected uniforms multihop_sample draws from the generator
  plan = a._fused_plan(8)
  outs = [multihop_sample(plan, torch.arange(8, dtype=torch.int32), 8,
                          [4, 3], generator=torch.Generator().manual_seed(2))
          for _ in range(2)]
  for k in EXACT_KEYS:
    assert torch.equal(outs[0][k], outs[1][k]), k
  assert int(outs[0]['num_sampled_edges'].sum()) > 0


def _hub_edges(n=300, seed=7):
  """COO edges whose 12 hub rows have degree 150-250, above the wide
  fanouts, and receive half of all edges, so hop 2 meets hubs too."""
  rng = np.random.default_rng(seed)
  deg = rng.integers(0, 12, n)
  hubs = rng.choice(n, 12, replace=False)
  deg[hubs] = rng.integers(150, 251, hubs.size)
  src = np.repeat(np.arange(n), deg)
  dst = np.where(rng.random(src.size) < 0.5, rng.choice(hubs, src.size),
                 rng.integers(0, n, src.size))
  return np.stack([src, dst]), hubs


@pytest.mark.parametrize('fanouts', [(100,), (3, 80)])
def test_wide_fanout_sampler_matches_jax_sampler(monkeypatch, fanouts):
  # fanouts above 64 run the walk too (its kernel keeps a wide row's
  # offsets in global scratch); Floyd runs on every hub row. The JAX
  # reference is the sort+fused engine, which the cross-hop walk is
  # bit-identical to: the interpret-mode walk kernel unrolls block x k
  # table probes and does not compile in a test's time at k = 100.
  from glt_tpu.data import Dataset as JaxDataset
  from glt_tpu.sampler import NeighborSampler as JaxSampler
  from glt_tpu.utils.rng import make_key
  ei, hubs = _hub_edges()
  b = 8
  geometry = [(b, fanouts[0])] + ([(b * 3, 80)] if len(fanouts) > 1 else [])
  assert walk_geometry(b, fanouts) == geometry
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  js = JaxSampler(JaxDataset().init_graph(edge_index=ei, num_nodes=300)
                  .get_graph(), list(fanouts), seed=5)
  ps = NeighborSampler(Dataset().init_graph(ei, num_nodes=300,
                                            device='cpu').get_graph(),
                       list(fanouts), device='cpu', seed=5)
  seeds = np.concatenate([hubs[:5], [5, 0, 5]]).astype(np.int32)
  want = js.sample_from_nodes(seeds, n_valid=7)
  u = jax_walk_hop_uniforms(jax.random.fold_in(make_key(5), 1), b, fanouts,
                            False)
  got = ps.sample_from_nodes(seeds, n_valid=7, uniforms=[
      torch.as_tensor(np.array(x)[:s]) for x, (s, _) in zip(u, geometry)])
  for f in ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch',
            'num_sampled_nodes', 'num_sampled_edges'):
    np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                  getattr(got, f).numpy(), err_msg=f)
  # Floyd drew on the hub rows: hop 1 samples 100 (or 3) of each
  assert int(got.num_sampled_edges[0]) >= 5 * fanouts[0]
