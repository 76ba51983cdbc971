"""The port's hetero sampling path (glt_tpu_torch.data hetero storage,
ops.cuda_kernels ``sample_hop_dedup``, ops.pipeline
``multihop_sample_hetero``, the hetero NeighborSampler) against the JAX
package on the same numpy inputs and the same uniforms.

References: the JAX ``sample_hop_dedup`` Pallas kernel in interpret mode
for one hop, and the JAX hetero sampler on ``GLT_DEDUP=sort
GLT_FUSED_HOP=1``, the per-edge-type sorted reference that the JAX suite
holds bit-identical to its fused hetero engine
(tests/test_pallas_fused.py). Every output surface of the sampler must
match bit for bit; ``edge`` on valid lanes (masked lanes are undefined
per engine in the reference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.data import Topology as JaxTopology
from glt_tpu.ops import pallas_kernels as jpk
from glt_tpu.ops.sample import _hub_fixup_inputs
from glt_tpu.sampler import NeighborSampler as JaxSampler
from glt_tpu.sampler.base import NodeSamplerInput as JaxInput
from glt_tpu.utils.rng import make_key
from glt_tpu_torch.data import Dataset, Topology
from glt_tpu_torch.ops import cuda_kernels as K
from glt_tpu_torch.ops.sample import build_type_plane, draw_offsets
from glt_tpu_torch.sampler import NeighborSampler
from glt_tpu_torch.sampler.base import NodeSamplerInput

W = 8  # JAX window width: rows of degree > W take the hub fix-up
U2I = ('user', 'u2i', 'item')
I2I = ('item', 'i2i', 'item')
I2T = ('item', 'i2t', 'tag')
T2U = ('tag', 't2u', 'user')


# -- (c) the rectangular CSR ------------------------------------------------

def test_rectangular_topology_matches_jax():
  rng = np.random.default_rng(0)
  ei = np.stack([rng.integers(0, 7, 90), rng.integers(0, 23, 90)])
  ei[:, :10] = ei[:, 10:20]             # duplicate edges keep input order
  eids = rng.permutation(90) * 5
  for kw in (dict(num_rows=7, num_cols=23), dict(num_rows=11, num_cols=30)):
    want = JaxTopology(edge_index=ei, edge_ids=eids, layout='CSR', **kw)
    got = Topology(ei, edge_ids=eids, device='cpu', **kw)
    np.testing.assert_array_equal(want.indptr, got.indptr.numpy())
    np.testing.assert_array_equal(want.indices, got.indices.numpy())
    np.testing.assert_array_equal(want.edge_ids, got.edge_ids.numpy())
    assert (got.num_rows, got.num_cols) == (want.num_rows, want.num_cols)
  with pytest.raises(ValueError, match='out of range'):
    Topology(ei, num_rows=6, num_cols=23, device='cpu')


# -- (a) one hop of sample_hop_dedup ----------------------------------------

def _csr(rng, n_rows, n_cols, e, hub_row=None):
  src = rng.integers(0, n_rows, e)
  if hub_row is not None:               # a row of degree > W
    src[:W + 4] = hub_row
  t = JaxTopology(edge_index=np.stack([src, rng.integers(0, n_cols, e)]),
                  layout='CSR', num_rows=n_rows, num_cols=n_cols)
  return dict(indptr=t.indptr.astype(np.int32),
              indices=t.indices.astype(np.int32),
              eids=(t.edge_ids * 3 + 1).astype(np.int32))


def test_sample_hop_dedup_plain_matches_pallas_kernel():
  """One hop over two edge types (S = 16 rows, K_max = 3) against a
  table seeded with some of the ids the hop picks.

  The provisional labels of ids new in the hop are not compared: the TPU
  kernel numbers them in the order of its sequential grid and its
  caller rewrites them into per-type value order, while the port writes
  the value-order labels at once (tests below hold the whole walk's
  labels equal)."""
  rng = np.random.default_rng(3)
  counts = {'user': 12, 'item': 30}
  base = {'user': 0, 'item': 12}
  trav = {U2I: ('user', 'item'), I2I: ('item', 'item')}
  g = {U2I: _csr(rng, 12, 30, 40, hub_row=4),
       I2I: _csr(rng, 30, 30, 120, hub_row=7)}
  segs = [(U2I, 6, 3), (I2I, 10, 2)]      # (edge type, rows, fanout)
  k_max = 3

  # the TPU plane: each edge type's W-padded block, values type-tagged
  parts = {e: dict(indptr=g[e]['indptr'], num_edges=g[e]['indices'].size,
                   indices_win=np.concatenate(
                       [g[e]['indices'], np.full(W, -1, np.int32)]),
                   edge_ids_win=np.concatenate(
                       [g[e]['eids'], np.full(W, -1, np.int32)]))
           for e in trav}
  jplane = jpk.build_type_plane(list(trav), trav, counts, parts, W)

  class _G:                                # the port plane's graph view
    def __init__(self, d):
      self.indices = torch.as_tensor(d['indices'])
      self.edge_ids = torch.as_tensor(d['eids'])
      self.num_edges = d['indices'].size
      self.device = torch.device('cpu')
  pplane = build_type_plane(list(trav), trav, counts,
                            {e: _G(g[e]) for e in trav}, with_eids=True)

  j_starts, p_starts, offs, valid, hub_idx, hub_slots = [], [], [], [], [], []
  row0 = 0
  for e, s, k in segs:
    ids = rng.integers(0, g[e]['indptr'].size - 1, s)
    ids[0] = 4 if e == U2I else 7        # the hub rows are in the frontier
    ok = rng.random(s) < 0.85
    ok[0] = True
    start = g[e]['indptr'][ids]
    deg = np.where(ok, g[e]['indptr'][ids + 1] - start, 0).astype(np.int32)
    off, mask = draw_offsets(torch.as_tensor(deg),
                             torch.as_tensor(rng.random((s, k)),
                                             dtype=torch.float32), k, False)
    off, mask = off.numpy(), mask.numpy()
    pad = ((0, 0), (0, k_max - k))
    offs.append(np.pad(off, pad))
    valid.append(np.pad(mask, pad))
    j_starts.append(start + jplane['edge_base'][e])
    p_starts.append(start + pplane['edge_base'][e])
    slots = np.clip(start[:, None] + off, 0, g[e]['indices'].size - 1)
    hi, hs = _hub_fixup_inputs(jnp.asarray(deg),
                               jnp.asarray(slots + jplane['edge_base'][e],
                                           jnp.int32), W, s, k, s)
    hub_idx.append(np.where(np.asarray(hi) >= 0, np.asarray(hi) + row0, -1))
    hub_slots.append(np.pad(np.asarray(hs), pad))
    row0 += s
  offs, valid = np.concatenate(offs), np.concatenate(valid)
  assert (np.concatenate(hub_idx) >= 0).any()

  # the table before the hop: every third id the hop picks, and ids the
  # hop never reaches, tagged and pre-labelled
  flat = np.concatenate([
      np.asarray(jplane['indices_flat'])[
          np.clip(j + o, 0, None)][m]
      for j, o, m in zip(np.concatenate(j_starts)[:, None], offs, valid)])
  pre = np.unique(np.concatenate([flat[::3], [0, 41, 13]])).astype(np.int32)
  pre_labs = np.arange(pre.size, dtype=np.int32) + 100
  jt = jpk.dedup_table_insert(*jpk.make_dedup_table(1024),
                              jnp.asarray(pre), jnp.asarray(pre_labs),
                              jnp.ones(pre.size, jnp.int32), interpret=True)
  picks, eidp, prov, newh, tids, _ = jpk.sample_hop_dedup(
      jplane['indices_flat'], jplane['eids_flat'],
      jnp.asarray(np.concatenate(j_starts), jnp.int32), jnp.asarray(offs),
      jnp.asarray(valid.astype(np.int32)),
      jnp.asarray(np.concatenate(hub_idx), jnp.int32),
      jnp.asarray(np.concatenate(hub_slots), jnp.int32), *jt,
      jnp.asarray(pre.size, jnp.int32), width=W, interpret=True)

  keys, vals, first = K.make_dedup_table(1024, 'cpu')
  K.dedup_table_insert(keys, vals, torch.as_tensor(pre),
                       torch.as_tensor(pre_labs),
                       torch.ones(pre.size, dtype=torch.bool))
  bounds = torch.tensor([0, 12, 42], dtype=torch.int32)
  out = K.sample_hop_dedup(
      pplane['indices_flat'], pplane['eids_flat'],
      torch.as_tensor(np.concatenate(p_starts)), torch.as_tensor(offs),
      torch.as_tensor(valid), keys, vals, first, bounds,
      torch.tensor([4, 9], dtype=torch.int32))
  assert K.sample_hop_dedup.launches == 0   # the CPU runs the plain version

  np.testing.assert_array_equal(np.asarray(picks)[valid],
                                out['picks'].numpy()[valid])
  np.testing.assert_array_equal(np.asarray(eidp)[valid],
                                out['eid_picks'].numpy()[valid])
  assert (out['picks'].numpy()[~valid] == -1).all()
  np.testing.assert_array_equal(np.asarray(newh).reshape(-1) != 0,
                                out['new_head'].numpy())
  seen = ~valid.reshape(-1) | np.isin(out['picks'].numpy().reshape(-1), pre)
  np.testing.assert_array_equal(np.asarray(prov).reshape(-1)[seen],
                                out['labels'].numpy()[seen])
  assert out['new_head'].any() and (seen & valid.reshape(-1)).any()
  jkeys = np.asarray(tids).ravel()
  assert set(jkeys[jkeys >= 0]) == set(keys[keys >= 0].tolist())
  # the port's labels of new ids: value order within each type
  new = out['new_head'].numpy()
  nid = out['picks'].numpy().reshape(-1)[new]
  nlab = out['labels'].numpy()[new]
  for t, lo, hi, c0 in (('user', 0, 12, 4), ('item', 12, 42, 9)):
    sel = (nid >= lo) & (nid < hi)
    np.testing.assert_array_equal(nlab[sel][np.argsort(nid[sel])],
                                  c0 + np.arange(sel.sum()), err_msg=t)
    assert int(out['counts'][int(t == 'item')]) == c0 + sel.sum()


# -- (b) the hetero sampler against the JAX sorted reference ---------------

def _coo(jgraph):
  """COO of a JAX Graph in its CSR order, with its edge ids."""
  t = jgraph.topo
  rows = np.repeat(np.arange(t.indptr.size - 1), np.diff(t.indptr))
  return np.stack([rows, t.indices]), t.edge_ids


def _port_dataset(jds):
  """The port's Dataset over the JAX dataset's graph; its node types and
  counts must be the JAX dataset's."""
  counts = {t: jds.node_count(t) for t in jds.get_node_types()}
  coo = {e: _coo(g) for e, g in jds.graph.items()}
  ds = Dataset().init_graph({e: c[0] for e, c in coo.items()},
                            edge_ids={e: c[1] for e, c in coo.items()},
                            num_nodes=counts, device='cpu')
  assert ds.get_node_types() == jds.get_node_types()
  assert ds.get_edge_types() == jds.get_edge_types()
  assert {t: ds.node_count(t) for t in counts} == counts
  return ds


def _three_type_dataset(with_empty_etype=False):
  """user -> item (bipartite), item -> item, item -> tag (bipartite), and
  optionally tag -> user with no edges."""
  rng = np.random.default_rng(7)
  nu, ni, nt = 9, 25, 6
  ei = {U2I: np.stack([rng.integers(0, nu, 30), rng.integers(0, ni, 30)]),
        I2I: np.stack([rng.integers(0, ni, 70), rng.integers(0, ni, 70)]),
        I2T: np.stack([rng.integers(0, ni, 20), rng.integers(0, nt, 20)])}
  if with_empty_etype:
    ei[T2U] = np.zeros((2, 0), np.int64)
  eids = {e: np.arange(v.shape[1]) * 2 + 1 for e, v in ei.items()}
  return JaxDataset(edge_dir='out').init_graph(
      edge_index=ei, edge_ids=eids,
      num_nodes={'user': nu, 'item': ni, 'tag': nt})


def _jax_hetero_uniforms(key, sampler, batch_sizes, replace=False):
  """The draws the JAX sorted reference makes from ``key``: per hop, one
  ``split`` per segment in traversal order, ``uniform(sub, (K, S))``
  transposed (``(S, K)`` with replacement)."""
  caps, _ = sampler._hetero_caps(batch_sizes)
  out = []
  for h in range(sampler.num_hops):
    hop = []
    for e, (row_t, _) in sampler._traversal_types().items():
      k, s = sampler.num_neighbors[e][h], caps[h][row_t]
      if s == 0 or k == 0:
        continue
      key, sub = jax.random.split(key)
      u = (jax.random.uniform(sub, (s, k)) if replace
           else jax.random.uniform(sub, (k, s)).T)
      hop.append(torch.as_tensor(np.array(u)))
    out.append(hop)
  return out


CASES = {
    # case: (dataset, fanouts, seed type, seeds, n_valid, with_edge,
    #        replace)
    'ring_dup_seeds': ('ring', [2, 2], 'user', [3, 0, 3, 7, 9, 1], 6, False,
                       False),
    'ring_n_valid_lt_batch': ('ring', [3, 2], 'user', [3, 0, 3, 7, 9, 1], 4,
                              False, False),
    'ring_with_edge': ('ring', [2, 2], 'user', [4, 4, 0, 9], 3, True, False),
    'three_types_zero_budget_user': ('three', [3, 2], 'item',
                                     [5, 5, 17, 0, 24], 5, False, False),
    'three_types_empty_etype': ('three_empty', [2, 2, 2], 'user',
                                [1, 2, 8, 1], 4, True, False),
    'three_types_no_valid_seed': ('three', [2, 2], 'user', [1, 2, 8], 0,
                                  False, False),
    'ring_item_seeds_replace': ('ring', [3, 2], 'item', [0, 7, 7, 3, 19], 4,
                                False, True),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_hetero_sampler_bit_identical_to_jax_sorted_ref(monkeypatch, case):
  from fixtures import hetero_ring_dataset
  name, fanouts, seed_type, seeds, nv, with_edge, replace = CASES[case]
  jds = (hetero_ring_dataset(num_users=10, num_items=20) if name == 'ring'
         else _three_type_dataset(with_empty_etype=name == 'three_empty'))
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  js = JaxSampler(jds.graph, fanouts, seed=5, with_edge=with_edge,
                  replace=replace)
  ps = NeighborSampler(_port_dataset(jds).graph, fanouts, device='cpu',
                       seed=5, with_edge=with_edge, replace=replace)
  seeds = np.asarray(seeds, np.int64)
  want = js.sample_from_nodes(JaxInput(seeds, seed_type), n_valid=nv)
  u = _jax_hetero_uniforms(jax.random.fold_in(make_key(5), 1), js,
                           {seed_type: seeds.size}, replace=replace)
  got = ps.sample_from_nodes(NodeSamplerInput(seeds, seed_type), n_valid=nv,
                             uniforms=u)
  assert got.input_type == want.input_type
  assert set(got.node) == set(want.node) and set(got.row) == set(want.row)
  for f in ('node', 'node_count', 'batch', 'num_sampled_nodes'):
    for t, v in getattr(want, f).items():
      np.testing.assert_array_equal(np.asarray(v), getattr(got, f)[t].numpy(),
                                    err_msg=f'{f}[{t}]')
  for t, v in want.metadata['seed_labels'].items():
    np.testing.assert_array_equal(
        np.asarray(v), got.metadata['seed_labels'][t].numpy())
  for f in ('row', 'col', 'edge_mask', 'num_sampled_edges'):
    for e, v in getattr(want, f).items():
      np.testing.assert_array_equal(np.asarray(v), getattr(got, f)[e].numpy(),
                                    err_msg=f'{f}[{e}]')
  assert got.metadata['edge_hop_offsets'] == want.metadata['edge_hop_offsets']
  if with_edge:
    for e, v in want.edge.items():
      m = np.asarray(want.edge_mask[e]).astype(bool)
      np.testing.assert_array_equal(np.asarray(v)[m], got.edge[e].numpy()[m],
                                    err_msg=f'edge[{e}]')
  total = sum(int(c) for c in got.node_count.values())
  assert (total == 0) == (nv == 0)
  if name == 'three_empty':
    # hop 3 expands the tags through t2u, which holds no edges
    assert got.num_sampled_edges[('user', 'rev_t2u', 'tag')].tolist() == [0]


def test_hetero_sampler_draws_from_its_own_generator():
  jds = _three_type_dataset()
  a, b = (NeighborSampler(_port_dataset(jds).graph, [3, 2], device='cpu',
                          seed=1) for _ in range(2))
  inp = NodeSamplerInput(np.arange(5), 'user')
  for _ in range(2):
    oa, ob = a.sample_from_nodes(inp), b.sample_from_nodes(inp)
    for t in oa.node:
      assert torch.equal(oa.node[t], ob.node[t])
  assert int(oa.node_count['item']) > 0
  with pytest.raises(ValueError, match='node type'):
    a.sample_from_nodes(NodeSamplerInput(np.arange(5)))
  # a dict of seeds by type is the several-type form of the JAX sampler
  # (tests/test_torch_sampler_options.py holds it to JAX's)
  assert a.sample_from_nodes({'user': np.arange(5)}).input_type == 'user'
  with pytest.raises(ValueError, match='node type'):
    a.sample_from_nodes(np.arange(5))
