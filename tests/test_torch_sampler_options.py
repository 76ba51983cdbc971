"""The single-device sampler's, loader's and dataset's last options in the
port against the JAX package, on the same numpy inputs and the same
uniforms (drawn from the JAX keys and injected):

- weighted and ``-1`` hetero hops (each edge type's in-memory one-hop:
  B3's weight window, a Gumbel top-k and B2's picks; B3's neighbour
  window) through ``multihop_sample_hetero_sorted``, ``full_neighbor_cap``
  and ``max_weighted_degree``, and a public hetero ``sample_from_nodes``
  seeded with several node types;
- ``with_edge`` and ``replace`` on the homogeneous per-hop loop;
- ``NeighborLoader(with_edge=, replace=, prefetch_depth=, as_pyg_v1=)``,
  ``NodeLoader(prefetch_depth=)`` and ``to_pyg_v1``;
- ``Topology(indptr=, indices=)``, ``Dataset.init_graph(layout=)``, the
  hetero ``random_node_split``/``get_split(split, ntype)`` and the hetero
  ``init_node_features(sort_func=)``.

The JAX side runs its per-hop loop on ``GLT_DEDUP=sort GLT_FUSED_HOP=1``
(what its ``pallas_fused`` engine demotes weighted and ``-1`` hops to) with
its plain window reads. Samples match bit for bit on every output field;
edge ids on the valid lanes (a window hop's masked lanes hold -1 in the
port, what ``top_k`` left in JAX's).
"""
import jax
import numpy as np
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.data import Topology as JaxTopology
from glt_tpu.data.reorder import sort_by_in_degree as jax_sort_by_in_degree
from glt_tpu.loader import NeighborLoader as JaxNeighborLoader
from glt_tpu.sampler import NeighborSampler as JaxNeighborSampler
from glt_tpu.sampler.base import NodeSamplerInput as JaxInput
from glt_tpu_torch.data import Dataset, Topology, sort_by_in_degree
from glt_tpu_torch.loader import NeighborLoader, NodeLoader
from glt_tpu_torch.loader.transform import to_pyg_v1
from glt_tpu_torch.sampler import NeighborSampler
from glt_tpu_torch.sampler.base import NodeSamplerInput
from glt_tpu_torch.typing import Split

N, E = 80, 700
HOMO_KEYS = ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch',
             'num_sampled_nodes', 'num_sampled_edges')
HETERO_KEYS = ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch',
               'num_sampled_nodes', 'num_sampled_edges')
NODES = {'paper': 50, 'author': 30, 'inst': 6}
CITES = ('paper', 'cites', 'paper')
WRITES = ('author', 'writes', 'paper')
REV_WRITES = ('paper', 'rev_writes', 'author')
AFF = ('author', 'aff', 'inst')


@pytest.fixture(autouse=True)
def _sorted_reference(monkeypatch):
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')


def _homo_graph(seed=0):
  """A CSR with degrees 0 to ~20 (rows 70.. have none), a few zero
  weights among weights in (0, 1]."""
  rng = np.random.default_rng(seed)
  src = (rng.random(E) ** 2 * 70).astype(np.int64)
  ei = np.stack([src, rng.integers(0, N, E)])
  w = (1.0 - rng.random(E)).astype(np.float32)
  w[::17] = 0.0
  return ei, w


def _hetero_graph(seed=1):
  """Four edge types over three node types, a few degree-0 rows, float32
  weights on three of them (``AFF`` has none)."""
  rng = np.random.default_rng(seed)
  p, a, i = NODES['paper'], NODES['author'], NODES['inst']
  ei = {CITES: np.stack([(rng.random(4 * p) ** 2 * (p - 5)).astype(np.int64),
                         rng.integers(0, p, 4 * p)]),
        WRITES: np.stack([rng.integers(0, a, 3 * p),
                          rng.integers(0, p, 3 * p)]),
        AFF: np.stack([np.arange(a), rng.integers(0, i, a)])}
  ei[REV_WRITES] = ei[WRITES][::-1].copy()
  w = {e: (1.0 - rng.random(x.shape[1])).astype(np.float32)
       for e, x in ei.items() if e != AFF}
  return ei, w


def _np(x):
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, keys, what=''):
  for f in keys:
    g, w = getattr(got, f), getattr(want, f)
    if isinstance(w, dict):
      assert sorted(map(str, g)) == sorted(map(str, w)), (what, f)
      for k, v in w.items():
        np.testing.assert_array_equal(_np(g[k]), np.asarray(v),
                                      err_msg=f'{what} {f}[{k}]')
    else:
      np.testing.assert_array_equal(_np(g), np.asarray(w),
                                    err_msg=f'{what} {f}')


def _same_edges(got, want, what=''):
  """Edge ids equal on the valid lanes."""
  if isinstance(want.edge_mask, dict):
    for k, m in want.edge_mask.items():
      m = np.asarray(m)
      np.testing.assert_array_equal(np.where(m, _np(got.edge[k]), 0),
                                    np.where(m, np.asarray(want.edge[k]), 0),
                                    err_msg=f'{what} edge[{k}]')
    return
  m = np.asarray(want.edge_mask)
  np.testing.assert_array_equal(np.where(m, _np(got.edge), 0),
                                np.where(m, np.asarray(want.edge), 0),
                                err_msg=f'{what} edge')


def homo_uniforms_from_key(key, batch_size, sampler):
  """The draws the JAX per-hop loop makes from ``key``: per hop ``key,
  sub = split(key)``; a uniform hop ``uniform(sub, (K, S_h))`` transposed
  (``(S_h, K)`` with replacement), a weighted hop ``uniform(sub, (S_h,
  window), minval=1e-20, maxval=1.0)``, a full hop nothing."""
  us, s = [], batch_size
  for f in sampler.num_neighbors:
    key, sub = jax.random.split(key)
    if f < 0:
      us.append(None)
    elif sampler._weighted:
      us.append(torch.as_tensor(np.array(jax.random.uniform(
          sub, (s, sampler._weight_window(f)), minval=1e-20, maxval=1.0))))
    elif sampler.replace:
      us.append(torch.as_tensor(np.array(jax.random.uniform(sub, (s, f)))))
    else:
      us.append(torch.as_tensor(np.asarray(
          jax.random.uniform(sub, (f, s))).T.copy()))
    s *= abs(f)
  return us


def hetero_uniforms_from_key(key, sampler, sizes):
  """The draws the JAX hetero per-hop loop makes from ``key``: per hop and
  segment (an edge type whose row type has a frontier and whose fanout is
  not 0, in traversal order) ``key, sub = split(key)``, drawn as
  :func:`homo_uniforms_from_key` draws a hop."""
  caps = sampler._hetero_caps(sizes)[0]
  out = []
  for h in range(sampler.num_hops):
    hop = []
    for e, (row_t, _) in sampler._traversal_types().items():
      k, s = sampler.num_neighbors[e][h], caps[h][row_t]
      if s == 0 or k == 0:
        continue
      key, sub = jax.random.split(key)
      if k < 0:
        hop.append(None)
      elif e in sampler._weighted_types:
        hop.append(torch.as_tensor(np.array(jax.random.uniform(
            sub, (s, sampler._weight_window(k, e)), minval=1e-20,
            maxval=1.0))))
      elif sampler.replace:
        hop.append(torch.as_tensor(np.array(jax.random.uniform(sub,
                                                               (s, k)))))
      else:
        hop.append(torch.as_tensor(np.asarray(
            jax.random.uniform(sub, (k, s))).T.copy()))
    out.append(hop)
  return out


def _hetero_pair(fanouts, **kw):
  ei, w = _hetero_graph()
  jds = JaxDataset().init_graph(edge_index=ei, edge_weights=w,
                                num_nodes=NODES)
  ds = Dataset().init_graph(ei, edge_weights=w, num_nodes=NODES,
                            device='cpu')
  js = JaxNeighborSampler(jds.graph, fanouts, seed=5, **kw)
  ps = NeighborSampler(ds.graph, fanouts, device='cpu', seed=5, **kw)
  return js, ps


# -- the hetero per-hop loop -------------------------------------------------

@pytest.mark.parametrize('fanouts,kw', [
    ([2, -1], dict(with_weight=True, with_edge=True)),
    ([3, 2], dict(with_weight=True, max_weighted_degree=6, with_edge=True)),
    ([-1, 2], dict(full_neighbor_cap=4, replace=True, with_edge=True)),
], ids=['weighted_full_edges', 'weight_window_edges',
        'capped_full_replace_edges'])
def test_hetero_per_hop_matches_jax(fanouts, kw):
  js, ps = _hetero_pair(fanouts, **kw)
  assert ps._per_hop and ps.num_neighbors == js.num_neighbors
  if kw.get('with_weight'):
    assert ps._weighted_types == {CITES, WRITES, REV_WRITES}
  seeds = np.array([3, 0, 3, 41, 12, 1])        # a repeat
  for step, nv in enumerate((6, 4)):
    key = jax.random.key(30 + step)
    want = js.sample_from_nodes(JaxInput(seeds, 'paper'), n_valid=nv,
                                key=key)
    got = ps.sample_from_nodes(
        NodeSamplerInput(seeds, 'paper'), n_valid=nv,
        uniforms=hetero_uniforms_from_key(key, ps, {'paper': 6}))
    _same(got, want, HETERO_KEYS, f'step {step}')
    assert got.input_type == want.input_type == 'paper'
    assert got.metadata['edge_hop_offsets'] == \
        want.metadata['edge_hop_offsets']
    for t, v in want.metadata['seed_labels'].items():
      np.testing.assert_array_equal(got.metadata['seed_labels'][t].numpy(),
                                    np.asarray(v))
    if kw.get('with_edge'):
      _same_edges(got, want, f'step {step}')
    assert sum(int(m.sum()) for m in got.edge_mask.values()) > 0


def test_hetero_several_seed_types_match_jax():
  """A public ``sample_from_nodes`` seeded with papers and authors in one
  walk (the JAX dict form with ``seed_type``) over weighted hops, and the
  ``(type, seeds)`` pair form. (The uniform B1 walk seeds
  several types through ``sample_from_edges``,
  tests/test_torch_hetero_link.py.)"""
  seeds = {'paper': np.array([4, 9, 4, 33]), 'author': np.array([2, 7, 11])}
  nv = {'paper': 4, 'author': 2}
  js, ps = _hetero_pair([2], with_weight=True)
  key = jax.random.key(44)
  want = js.sample_from_nodes(dict(seeds), n_valid=dict(nv), key=key,
                              seed_type='author')
  got = ps.sample_from_nodes(
      dict(seeds), n_valid=nv, seed_type='author',
      uniforms=hetero_uniforms_from_key(key, ps, {'paper': 4, 'author': 3}))
  _same(got, want, HETERO_KEYS, 'two types')
  assert got.input_type == 'author'
  # the (type, seeds) pair is the NodeSamplerInput form, as in JAX
  u = hetero_uniforms_from_key(key, ps, {'paper': 4})
  pair = ps.sample_from_nodes(('paper', seeds['paper']), uniforms=u)
  _same(pair, ps.sample_from_nodes(NodeSamplerInput(seeds['paper'], 'paper'),
                                   uniforms=u), HETERO_KEYS, 'pair')
  with pytest.raises(ValueError, match='node type'):
    ps.sample_from_nodes(seeds['paper'])


def test_hetero_per_hop_draws_from_its_generator():
  """Without injected uniforms a hetero per-hop sampler draws each
  segment's uniforms from its own generator: two samplers of one seed
  agree, and the draws have the JAX shapes."""
  _, a = _hetero_pair([3, -1], with_weight=True)
  _, b = _hetero_pair([3, -1], with_weight=True)
  seeds = NodeSamplerInput(np.array([1, 5, 8]), 'paper')
  for _ in range(2):
    oa, ob = a.sample_from_nodes(seeds), b.sample_from_nodes(seeds)
    for k in ('node', 'row', 'col'):
      for t, v in getattr(oa, k).items():
        assert torch.equal(v, getattr(ob, k)[t]), (k, t)
  shapes = [[None if u is None else tuple(u.shape) for u in hop]
            for hop in a.hop_uniforms(3, 'paper')]
  w = a._weight_window(3, CITES)
  assert shapes[0] == [(3, w), (3, a._weight_window(3, REV_WRITES))]
  assert all(s is None for s in shapes[1])


# -- the homogeneous per-hop loop ------------------------------------------

@pytest.mark.parametrize('fanouts,kw', [
    ([3, 2], dict(with_weight=True, with_edge=True, max_weighted_degree=5)),
    ([3, -1], dict(with_weight=True, with_edge=True, replace=True)),
    ([-1, 4], dict(full_neighbor_cap=6, replace=True, with_edge=True)),
], ids=['weight_window_edges', 'weighted_full_edges_replace',
        'capped_full_replace_edges'])
def test_homo_per_hop_options_match_jax(fanouts, kw):
  ei, w = _homo_graph(4)
  jds = JaxDataset().init_graph(edge_index=ei, edge_weights=w, num_nodes=N)
  ds = Dataset().init_graph(ei, edge_weights=w, num_nodes=N, device='cpu')
  js = JaxNeighborSampler(jds.get_graph(), fanouts, seed=5, **kw)
  ps = NeighborSampler(ds.get_graph(), fanouts, device='cpu', seed=5, **kw)
  assert ps._per_hop and ps.num_neighbors == js.num_neighbors
  seeds = np.array([3, 0, 3, 41, 75, 12, 1, 60])   # a repeat, a leaf
  for step, nv in enumerate((8, 6)):
    key = jax.random.key(20 + step)
    want = js.sample_from_nodes(seeds, n_valid=nv, key=key)
    got = ps.sample_from_nodes(seeds, n_valid=nv,
                               uniforms=homo_uniforms_from_key(key, 8, ps))
    _same(got, want, HOMO_KEYS, f'step {step}')
    if kw.get('with_edge'):
      _same_edges(got, want, f'step {step}')
    else:
      assert got.edge is None
    assert got.edge_hop_offsets == want.edge_hop_offsets


# -- the loaders -----------------------------------------------------------

def _products(n=120, e=900, seed=7):
  rng = np.random.default_rng(seed)
  ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
  x = rng.normal(size=(n, 4)).astype(np.float32)
  y = rng.integers(0, 3, n)
  w = (1.0 - rng.random(e)).astype(np.float32)
  return ei, x, y, w


def _loaders(fanouts, kw, split_ratio=1.0, host_offload=None):
  ei, x, y, w = _products()
  jds = JaxDataset().init_graph(edge_index=ei, edge_weights=w, num_nodes=120)
  jds.init_node_features(x).init_node_labels(y)
  ds = Dataset().init_graph(ei, edge_weights=w, num_nodes=120, device='cpu')
  ds.init_node_features(x, split_ratio=split_ratio, device='cpu',
                        host_offload=host_offload).init_node_labels(y)
  seeds = np.arange(0, 120, 3)
  jl = JaxNeighborLoader(jds, fanouts, seeds, batch_size=16, shuffle=True,
                         seed=3, **kw)
  pl = NeighborLoader(ds, fanouts, seeds, batch_size=16, shuffle=True,
                      seed=3, device='cpu', **kw)
  return jl, pl


def _recording(sampler, keys):
  """Wrap the JAX sampler's ``sample_from_nodes`` to record the key each
  batch's walk reads."""
  real = sampler.sample_from_nodes

  def rec(inputs, **kwargs):
    key = sampler._next_key()
    keys.append(key)
    return real(inputs, key=key, **{k: v for k, v in kwargs.items()
                                    if k != 'key'})
  sampler.sample_from_nodes = rec


def _inject(sampler, keys, batch_size):
  """The port sampler's i-th batch reads the uniforms of the JAX loader's
  i-th."""
  real = sampler.sample_from_nodes
  made = []

  def inj(inputs, n_valid=None, uniforms=None, **kw):
    made.append(len(made))
    return real(inputs, n_valid=n_valid, uniforms=homo_uniforms_from_key(
        keys[made[-1]], batch_size, sampler), **kw)
  sampler.sample_from_nodes = inj


@pytest.mark.parametrize('kw', [
    dict(with_weight=True, with_edge=True, fanouts=[3, 2]),
    dict(replace=True, fanouts=[3, -1], with_edge=True),
    dict(with_weight=True, fanouts=[3, 2], prefetch_depth=2),
], ids=['weighted_edges', 'replace_full', 'prefetch'])
def test_neighbor_loader_options_match_jax(kw):
  kw = dict(kw)
  fanouts = kw.pop('fanouts')
  jl, pl = _loaders(fanouts, kw)
  assert pl.prefetch_depth == kw.get('prefetch_depth', 0)
  keys = []
  _recording(jl.sampler, keys)
  _inject(pl.sampler, keys, 16)
  n = 0
  for jb, pb in zip(list(jl), pl):
    for f in ('node', 'node_count', 'row', 'col', 'edge_mask', 'x', 'y',
              'num_sampled_nodes', 'num_sampled_edges'):
      np.testing.assert_array_equal(_np(getattr(pb, f)),
                                    np.asarray(getattr(jb, f)), err_msg=f)
    assert pb.metadata['n_valid'] == jb.metadata['n_valid']
    if kw.get('with_edge'):
      m = np.asarray(jb.edge_mask)
      np.testing.assert_array_equal(np.where(m, pb.edge.numpy(), 0),
                                    np.where(m, np.asarray(jb.edge), 0))
    n += 1
  assert n == len(pl) == len(jl) == 3


def test_as_pyg_v1_matches_jax():
  """``as_pyg_v1`` batches over the walk, with edge ids: the seed count,
  the node ids and each hop's adjacency (outermost first), its edge ids
  and its sizes as the JAX loader gives them; ``to_pyg_v1`` of a plain
  batch gives the same."""
  jl, pl = _loaders([3, 2], dict(with_edge=True, as_pyg_v1=True))
  assert not pl.sampler._per_hop
  keys = []
  _recording(jl.sampler, keys)
  _inject(pl.sampler, keys, 16)
  for (jbs, jn, jadjs), (pbs, pn, padjs) in zip(list(jl), pl):
    assert pbs == jbs == 16
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    assert len(padjs) == len(jadjs) == 2
    for pa, ja in zip(padjs, jadjs):
      np.testing.assert_array_equal(pa.edge_index.numpy(), ja.edge_index)
      np.testing.assert_array_equal(pa.e_id.numpy(), ja.e_id)
      assert pa.size == ja.size
      assert pa.to('cpu').edge_index.device.type == 'cpu'
  plain = NeighborLoader(pl.data, [3, 2], pl.seeds, batch_size=16,
                         with_edge=True, device='cpu')
  b = next(iter(plain))
  bs, n_id, adjs = to_pyg_v1(b)
  assert bs == 16 and n_id.numel() == int(b.node_count)
  assert sum(a.edge_index.shape[1] for a in adjs) == int(b.edge_mask.sum())


def test_node_loader_prefetch_depth():
  """``prefetch_depth`` defaults to 2 where the feature store has a host
  phase (``host_offload=False`` with spilled rows) and to 0 otherwise, as
  in JAX; a prefetching loader yields the plain loader's batches through
  a worker thread."""
  _, spilled = _loaders([3, 2], {}, split_ratio=0.5, host_offload=False)
  _, pinned = _loaders([3, 2], {}, split_ratio=0.5)
  _, resident = _loaders([3, 2], {})
  assert (spilled.prefetch_depth, pinned.prefetch_depth,
          resident.prefetch_depth) == (2, 0, 0)
  ds = resident.data
  sampler = NeighborSampler(ds.graph, [3, 2], device='cpu', seed=1)
  twin = NeighborSampler(ds.graph, [3, 2], device='cpu', seed=1)
  a = NodeLoader(ds, sampler, np.arange(40), batch_size=16,
                 prefetch_depth=2)
  b = NodeLoader(ds, twin, np.arange(40), batch_size=16)
  it = iter(a)
  got = list(it)
  assert a._prefetcher.worker_thread is not None
  assert not a._prefetcher.worker_thread.is_alive()
  want = list(b)
  assert len(got) == len(want) == 3
  for x, y in zip(got, want):
    for f in ('node', 'row', 'col', 'x', 'y'):
      assert torch.equal(getattr(x, f), getattr(y, f)), f


# -- the data options ------------------------------------------------------

def test_topology_from_indptr_and_init_graph_layout_match_jax():
  """A given indptr/indices (columns unsorted within rows, weights and
  edge ids riding along) against JAX's ``Topology``, and
  ``init_graph(layout=)`` of a CSR or a CSC into either edge_dir."""
  ei, w = _homo_graph(9)
  jt = JaxTopology(edge_index=ei, layout='CSR', num_nodes=N)
  rng = np.random.default_rng(2)
  indices = jt.indices.copy()
  for r in range(N):                      # shuffle each row's columns
    lo, hi = jt.indptr[r], jt.indptr[r + 1]
    indices[lo:hi] = rng.permutation(indices[lo:hi])
  eids = rng.permutation(indices.size)
  kws = [dict(), dict(num_rows=N + 3, num_cols=N + 1)]
  for kw in kws:
    want = JaxTopology(indptr=jt.indptr, indices=indices, edge_ids=eids,
                       edge_weights=w[:indices.size], layout='CSR', **kw)
    got = Topology(indptr=jt.indptr, indices=indices, edge_ids=eids,
                   edge_weights=w[:indices.size], layout='CSR',
                   device='cpu', **kw)
    for f in ('indptr', 'indices', 'edge_ids', 'edge_weights'):
      np.testing.assert_array_equal(_np(getattr(got, f)),
                                    getattr(want, f), err_msg=f)
    assert (got.num_rows, got.num_cols) == (want.num_rows, want.num_cols)
  with pytest.raises(ValueError, match='edge_index or indptr'):
    Topology(device='cpu')
  for edge_dir in ('out', 'in'):
    for layout in ('CSR', 'CSC'):
      t = JaxTopology(edge_index=ei, layout=layout, num_nodes=N)
      jds = JaxDataset(edge_dir=edge_dir).init_graph(
          edge_index=(t.indptr, t.indices), layout=layout, num_nodes=N)
      ds = Dataset(edge_dir=edge_dir).init_graph(
          (t.indptr, t.indices), layout=layout, num_nodes=N, device='cpu')
      jt2, pt2 = jds.get_graph().topo, ds.get_graph().topo
      assert pt2.layout == jt2.layout
      for f in ('indptr', 'indices', 'edge_ids'):
        np.testing.assert_array_equal(_np(getattr(pt2, f)),
                                      getattr(jt2, f),
                                      err_msg=f'{edge_dir} {layout} {f}')


def test_hetero_split_and_sort_match_jax():
  """The hetero ``random_node_split`` (every node type's split from its
  node count) and ``get_split(split, ntype)``; the hetero
  ``init_node_features(sort_func=)``: each type sorted over the topology
  of the first edge type it is the pointer type of, hottest rows first,
  and a split store's lookups by original id equal."""
  ei, w = _hetero_graph()
  jds = JaxDataset().init_graph(edge_index=ei, num_nodes=NODES)
  ds = Dataset().init_graph(ei, num_nodes=NODES, device='cpu')
  jds.random_node_split(0.2, 5, seed=3)
  ds.random_node_split(0.2, 5, seed=3)
  for t in NODES:
    for s in Split:
      np.testing.assert_array_equal(ds.get_split(s, t),
                                    jds.get_split(s.value, t),
                                    err_msg=f'{t} {s}')
  rng = np.random.default_rng(6)
  feats = {t: rng.normal(size=(n, 3)).astype(np.float32)
           for t, n in NODES.items()}
  jds.init_node_features(feats, sort_func=jax_sort_by_in_degree,
                         split_ratio=0.5)
  ds.init_node_features(feats, sort_func=sort_by_in_degree, split_ratio=0.5,
                        device='cpu')
  for t, n in NODES.items():
    jf, pf = jds.get_node_feature(t), ds.get_node_feature(t)
    jf.lazy_init()
    sorted_here = jds._topo_for_node_type(t) is not None
    assert (pf.id2index is not None) == sorted_here, t
    if sorted_here:
      np.testing.assert_array_equal(pf.id2index.numpy(),
                                    np.asarray(jf.id2index), err_msg=t)
    assert pf.hot_count == jf.hot_count
    np.testing.assert_array_equal(pf.device_part.numpy(),
                                  np.asarray(jf.device_part), err_msg=t)
    every = np.arange(n)
    np.testing.assert_array_equal(pf[every], np.asarray(jf[every]),
                                  err_msg=t)
