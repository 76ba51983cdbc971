"""Subgraph extraction and SEAL in the port (``ops.unique.ordered_unique``,
``ops.subgraph.induced_subgraph``, ``NeighborSampler.subgraph``,
``SubGraphLoader``, ``ops.drnl``, ``GCNConv``, ``DGCNN`` and the SEAL
example) against the JAX package on the same numpy inputs.

Extraction and labels are exact, so they must match bit for bit (the JAX
sampler on its sort+fused reference, ``GLT_DEDUP=sort GLT_FUSED_HOP=1``,
its draws injected where the fanouts draw). The models are float32 sums
in another order: GCNConv and DGCNN forwards under converted weights to
atol 1e-5, on one-hot DRNL features whose sort keys tie (DGCNN's
sort-pool must order ties as ``lax.top_k`` does), and three Adam steps of
the example's step to atol 1e-5 in every parameter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.loader import SubGraphLoader as JaxSubGraphLoader
from glt_tpu.models.conv import GCNConv as JaxGCNConv
from glt_tpu.models.dgcnn import DGCNN as JaxDGCNN
from glt_tpu.ops.drnl import bfs_distances as jax_bfs_distances
from glt_tpu.ops.drnl import drnl_node_labeling as jax_drnl_node_labeling
from glt_tpu.ops.subgraph import induced_subgraph as jax_induced_subgraph
from glt_tpu.ops.unique import ordered_unique as jax_ordered_unique
from glt_tpu.sampler import NeighborSampler as JaxNeighborSampler
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.examples import seal_link_pred as seal
from glt_tpu_torch.loader import SubGraphLoader
from glt_tpu_torch.models import (DGCNN, GCNConv, dgcnn_params_from_flax,
                                  gcn_conv_params_from_flax)
from glt_tpu_torch.ops.drnl import INF, bfs_distances
from glt_tpu_torch.ops.subgraph import induced_subgraph
from glt_tpu_torch.ops.unique import ordered_unique
from glt_tpu_torch.parallel import SageTrainStep
from glt_tpu_torch.sampler import NeighborSampler
from test_torch_weighted_sampling import hop_uniforms_from_key

N, E = 60, 400
ATOL = 1e-5
SUB_KEYS = ('nodes', 'node_count', 'rows', 'cols', 'eids', 'edge_mask')


def _edges(seed=0):
  rng = np.random.default_rng(seed)
  src = (rng.random(E) ** 2 * 55).astype(np.int64)
  return np.stack([src, rng.integers(0, N, E)])


def _np(x):
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_sub(got, want, keys=SUB_KEYS):
  for f in keys:
    np.testing.assert_array_equal(_np(getattr(got, f)),
                                  np.asarray(getattr(want, f)), err_msg=f)


def _sort_fused(monkeypatch):
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')


# -- ordered_unique and induced_subgraph ---------------------------------------

@pytest.mark.parametrize('capacity', [40, 64])
def test_ordered_unique_matches_jax(capacity):
  rng = np.random.default_rng(1)
  ids = rng.integers(0, 40, 64).astype(np.int32)
  valid = rng.random(64) < 0.8
  ids[:3], valid[:3] = [39, 7, 39], True
  want = jax_ordered_unique(jnp.asarray(ids), jnp.asarray(valid), capacity)
  got = ordered_unique(torch.as_tensor(ids), torch.as_tensor(valid),
                       capacity)
  for a, b in zip(got, want):
    np.testing.assert_array_equal(_np(a), np.asarray(b))
  uniq, count, inverse = (x.numpy() for x in got)
  assert uniq[:2].tolist() == [39, 7] and inverse[2] == 0
  np.testing.assert_array_equal(uniq[inverse[valid]], ids[valid])
  assert (uniq[count:] == -1).all() and (inverse[~valid] == -1).all()


@pytest.mark.parametrize('with_edge', [False, True])
def test_induced_subgraph_matches_jax(with_edge):
  ei = _edges()
  jg = JaxDataset().init_graph(edge_index=ei, num_nodes=N).get_graph()
  g = Dataset().init_graph(ei, num_nodes=N, device='cpu').get_graph()
  rng = np.random.default_rng(2)
  srcs = rng.integers(0, N, 48).astype(np.int32)
  srcs[:4] = [58, 3, 58, 0]          # a leaf first, a repeat
  mask = rng.random(48) < 0.9
  mask[:4] = True
  max_degree = g.topo.max_degree
  for cap, d in ((48, max_degree), (40, max(max_degree // 2, 1))):
    want = jax_induced_subgraph(jg.indptr, jg.indices, jnp.asarray(srcs),
                                jnp.asarray(mask), cap, d,
                                edge_ids=jg.edge_ids, with_edge=with_edge)
    got = induced_subgraph(g.indptr, g.indices, torch.as_tensor(srcs),
                           torch.as_tensor(mask), cap, d,
                           edge_ids=g.edge_ids, with_edge=with_edge)
    _assert_sub(got, want)
  # every induced edge is an edge of the graph between two members
  nodes, m = got.nodes.numpy(), got.edge_mask.numpy()
  edges = set(zip(ei[0].tolist(), ei[1].tolist()))
  assert m.sum() > 0 and all(
      (int(nodes[r]), int(nodes[c])) in edges
      for r, c in zip(got.rows.numpy()[m], got.cols.numpy()[m]))


# -- the sampler and the loader --------------------------------------------------

def _recording(js):
  """Records the keys the JAX sampler draws."""
  keys, next_key = [], js._next_key

  def record():
    keys.append(next_key())
    return keys[-1]
  js._next_key = record
  return keys


@pytest.mark.parametrize('fanouts', [[-1, -1], [3, 2]])
def test_sampler_subgraph_matches_jax(fanouts, monkeypatch):
  _sort_fused(monkeypatch)
  ei = _edges(3)
  jds = JaxDataset().init_graph(edge_index=ei, num_nodes=N)
  ds = Dataset().init_graph(ei, num_nodes=N, device='cpu')
  js = JaxNeighborSampler(jds.get_graph(), fanouts, seed=2)
  ps = NeighborSampler(ds.get_graph(), fanouts, device='cpu', seed=2)
  keys = _recording(js)
  for seeds, cap in ((np.array([4, 9]), None), (np.array([7, 7, 30]), 50)):
    want = js.subgraph(seeds, node_capacity=cap)
    u = hop_uniforms_from_key(keys[-1], seeds.size, ps)
    got = ps.subgraph(seeds, node_capacity=cap, uniforms=u)
    _assert_sub(got, want)
    assert int(got.edge_mask.sum()) > 0


def test_subgraph_loader_batches_match_jax(monkeypatch):
  _sort_fused(monkeypatch)
  ei = _edges(4)
  rng = np.random.default_rng(4)
  x = rng.standard_normal((N, 6)).astype(np.float32)
  y = rng.integers(0, 3, N).astype(np.int32)
  jds = JaxDataset().init_graph(edge_index=ei, num_nodes=N)
  jds.init_node_features(x)
  jds.init_node_labels(y)
  ds = Dataset().init_graph(ei, num_nodes=N, device='cpu')
  ds.init_node_features(x, device='cpu')
  ds.init_node_labels(y)
  seeds = np.arange(0, N, 3)                  # 20 seeds: 2 full + 4
  jl = JaxSubGraphLoader(jds, [3, 2], seeds, batch_size=8, shuffle=True,
                         seed=1)
  pl = SubGraphLoader(ds, [3, 2], seeds, batch_size=8, shuffle=True, seed=1,
                      device='cpu')
  keys = _recording(jl.sampler)
  real = pl.sampler.subgraph
  pl.sampler.subgraph = lambda s: real(s, uniforms=hop_uniforms_from_key(
      keys[-1], 8, pl.sampler))
  n = 0
  for jb, pb in zip(jl, pl):
    for f in ('x', 'row', 'col', 'edge_mask', 'node', 'node_count', 'y',
              'edge'):
      np.testing.assert_array_equal(_np(getattr(pb, f)),
                                    np.asarray(getattr(jb, f)), err_msg=f)
    for f in ('mapping', 'n_valid'):
      np.testing.assert_array_equal(_np(pb.metadata[f]),
                                    np.asarray(jb.metadata[f]))
    assert pb.batch_size == jb.batch_size == 8
    # row is the message source: an induced edge (col -> row) of the CSR
    node, m = pb.node.numpy(), pb.edge_mask.numpy()
    edges = set(zip(ei[0].tolist(), ei[1].tolist()))
    assert all((int(node[c]), int(node[r])) in edges
               for r, c in zip(pb.row.numpy()[m], pb.col.numpy()[m]))
    n += 1
  assert n == 3 and pb.metadata['n_valid'] == 4


# -- DRNL ---------------------------------------------------------------------

def test_bfs_distances_matches_jax():
  rng = np.random.default_rng(6)
  n, e = 20, 50
  row = rng.integers(0, n, e).astype(np.int32)
  col = rng.integers(0, n, e).astype(np.int32)
  mask = rng.random(e) < 0.85
  jfn = jax.jit(jax.vmap(lambda s: jax_bfs_distances(
      jnp.asarray(row), jnp.asarray(col), jnp.asarray(mask), n, s)))
  sources = np.array([0, 3, 11, 19], np.int32)
  want = np.asarray(jfn(jnp.asarray(sources)))
  stats = {}
  got = bfs_distances(torch.as_tensor(row).expand(4, -1),
                      torch.as_tensor(col).expand(4, -1),
                      torch.as_tensor(mask).expand(4, -1), n,
                      torch.as_tensor(sources), stats=stats).numpy()
  np.testing.assert_array_equal(got, want)
  assert stats['rounds'] >= 2 and (got == INF).any() and (got == 0).any()
  one = bfs_distances(torch.as_tensor(row), torch.as_tensor(col),
                      torch.as_tensor(mask), n, 3).numpy()
  np.testing.assert_array_equal(one, want[1])


def _seal_setup(nodes=120, chords=40, hops=2):
  """A SEAL-sized setup: the example's graph and split, its sampler and
  the JAX sampler over the same training graph."""
  rng = np.random.default_rng(0)
  und = seal.ring_chord_graph(n=nodes, chords=chords, seed=0)
  split = seal.link_split(und, rng, n=nodes)
  both = np.array(split[0] + [(b, a) for a, b in split[0]], np.int64)
  jds = JaxDataset(edge_dir='out')
  jds.init_graph(edge_index=both.T.copy(), num_nodes=nodes)
  ds = seal.build_train_dataset(split[0], nodes, device='cpu')
  js = JaxNeighborSampler(jds.get_graph(), [-1] * hops, seed=0)
  ps = NeighborSampler(ds.get_graph(), [-1] * hops, seed=0, device='cpu')
  return split, js, ps


def _jax_drnl_fn(n_cap):
  """examples/seal_link_pred.py's drnl_fn, vmapped over links."""
  def one(rows, cols, emask, node_count):
    keep = emask & ~(((rows == 0) & (cols == 1)) |
                     ((rows == 1) & (cols == 0)))
    z = jax_drnl_node_labeling(rows, cols, keep, n_cap, jnp.int32(0),
                               jnp.int32(1), seal.MAX_Z)
    z = jnp.where(jnp.arange(n_cap) < node_count, z, 0)
    return z, rows, cols, keep
  return jax.jit(jax.vmap(one))


def _jax_items(js, links, n_cap):
  subs = [js.subgraph(np.array(link, np.int64), node_capacity=n_cap)
          for link in links]
  stack = lambda f: jnp.stack([getattr(s, f) for s in subs])
  z, rows, cols, keep = _jax_drnl_fn(n_cap)(
      stack('rows'), stack('cols'), stack('edge_mask'), stack('node_count'))
  nmask = np.arange(n_cap)[None, :] < np.asarray(stack('node_count'))[:, None]
  return [np.asarray(a) for a in (z, rows, cols, keep)] + [nmask]


def test_seal_extraction_and_drnl_match_jax(monkeypatch):
  _sort_fused(monkeypatch)
  split, js, ps = _seal_setup()
  n_cap = seal.sample_budget(2, ps.num_neighbors)
  assert ps.num_neighbors == js.num_neighbors
  links = split[0][:12] + split[1][:12]       # positives, negatives
  want = _jax_items(js, links, n_cap)
  stats = {}
  items = seal.extract_enclosing(ps, links, 1.0,
                                 seal.make_drnl_fn(n_cap, stats), n_cap)
  for i, name in enumerate(('z', 'rows', 'cols', 'keep', 'nmask')):
    got = torch.stack([it[i] for it in items]).numpy()
    np.testing.assert_array_equal(got, want[i], err_msg=name)
  z = want[0]
  assert z.max() > 2 and (z[:, :2] == 1).all() and stats['rounds'] >= 3
  # the target link is gone from every subgraph
  rows, cols, keep = want[1:4]
  assert not (keep & (((rows == 0) & (cols == 1))
                      | ((rows == 1) & (cols == 0)))).any()


# -- GCNConv, DGCNN and the training step -----------------------------------------

def test_gcn_conv_matches_flax():
  rng = np.random.default_rng(8)
  n, e, f, o = 15, 60, 7, 5
  x = rng.standard_normal((3, n, f)).astype(np.float32)
  row = rng.integers(-1, n, (3, e)).astype(np.int32)
  col = rng.integers(0, n, (3, e)).astype(np.int32)
  mask = rng.random((3, e)) < 0.8
  jconv = JaxGCNConv(o)
  params = jconv.init(jax.random.key(1), x[0], row[0], col[0], mask[0])
  params = jax.tree.map(lambda a: a + 0.1, params)   # a non-zero bias
  want = np.asarray(jax.vmap(lambda *a: jconv.apply(params, *a))(
      x, row, col, mask))
  conv = GCNConv(f, o)
  conv.load_state_dict(gcn_conv_params_from_flax(
      jax.tree.map(np.asarray, params['params'])))
  t = [torch.as_tensor(a) for a in (x, row, col, mask)]
  with torch.no_grad():
    np.testing.assert_allclose(conv(*t).numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(conv(*(a[1] for a in t)).numpy(), want[1],
                               rtol=0, atol=ATOL)


def _seal_batch(monkeypatch, links=16):
  _sort_fused(monkeypatch)
  split, _, ps = _seal_setup()
  n_cap = seal.sample_budget(2, ps.num_neighbors)
  drnl = seal.make_drnl_fn(n_cap)
  items = (seal.extract_enclosing(ps, split[0][:links // 2], 1.0, drnl,
                                  n_cap)
           + seal.extract_enclosing(ps, split[1][:links // 2], 0.0, drnl,
                                    n_cap))
  return seal.collate(items)


def _flax_dgcnn(batch, k):
  model = JaxDGCNN(hidden=8, num_layers=2, k=k)
  one = [jnp.asarray(a[0].numpy()) for a in batch[:5]]
  params = jax.jit(model.init)(jax.random.key(0), *one)
  fwd = jax.vmap(model.apply, in_axes=(None, 0, 0, 0, 0, 0))
  return model, params, fwd


def test_dgcnn_matches_flax_with_tied_sort_keys(monkeypatch):
  batch = _seal_batch(monkeypatch)
  k = 12
  _, params, fwd = _flax_dgcnn(batch, k)
  jb = [jnp.asarray(a.numpy()) for a in batch[:5]]
  want = np.asarray(jax.jit(fwd)(params, *jb))
  model = DGCNN(seal.MAX_Z + 1, hidden=8, num_layers=2, k=k)
  model.load_state_dict(dgcnn_params_from_flax(
      jax.tree.map(np.asarray, params)))
  with torch.no_grad():
    got = model(*batch[:5]).numpy()
    # the sort keys tie among the valid nodes of every subgraph
    key = torch.tanh(model.gcn_key(
        _hidden(model, batch), *batch[1:4]))[..., 0]
  np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
  nmask = batch[4]
  ties = [len(set(np.round(key[i][nmask[i]].numpy(), 7).tolist()))
          < int(nmask[i].sum()) for i in range(len(got))]
  assert all(ties)


def _hidden(model, batch):
  h = batch[0]
  for conv in model.convs:
    h = torch.tanh(conv(h, *batch[1:4]))
  return h


def test_dgcnn_adam_steps_match_the_example(monkeypatch):
  batch = _seal_batch(monkeypatch)
  model_j, params, fwd = _flax_dgcnn(batch, 12)
  tx = optax.adam(1e-3)
  opt = tx.init(params)

  @jax.jit
  def train_step(params, opt, b):     # examples/seal_link_pred.py's step
    x, rows, cols, emask, nmask, y = b
    def loss_fn(p):
      logits = fwd(p, x, rows, cols, emask, nmask)
      return optax.sigmoid_binary_cross_entropy(logits, y).mean()
    loss, grads = jax.value_and_grad(loss_fn)(params)
    ups, opt = tx.update(grads, opt)
    return optax.apply_updates(params, ups), opt, loss

  model = DGCNN(seal.MAX_Z + 1, hidden=8, num_layers=2, k=12)
  model.load_state_dict(dgcnn_params_from_flax(
      jax.tree.map(np.asarray, params)))
  step = SageTrainStep(model, lr=1e-3, loss=seal.seal_loss)
  jb = tuple(jnp.asarray(a.numpy()) for a in batch)
  for i in range(3):
    params, opt, jloss = train_step(params, opt, jb)
    loss = step(batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=ATOL)
    want = dgcnn_params_from_flax(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
      np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                 atol=ATOL, err_msg=f'step {i} {k}')


def test_seal_example_learns_on_the_cpu(capsys):
  auc = seal.main(['--device', 'cpu', '--epochs', '4', '--nodes', '200'])
  out = capsys.readouterr().out
  aucs = [float(line.split('Test: ')[1]) for line in out.splitlines()
          if 'Test: ' in line]
  assert len(aucs) == 4 and aucs[-1] == round(auc, 4) and max(aucs) > 0.6, out
