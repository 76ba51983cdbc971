"""Hetero link prediction in the port against the JAX package on the same
numpy inputs: ``NeighborSampler.sample_from_edges`` over an edge type
(two endpoint types seeded in one walk, or one type), the hetero
``LinkNeighborLoader``, K2's multi-type seed phase in its plain version,
and examples/hetero/bipartite_sage_unsup.py's training step.

References: the JAX hetero sampler on ``GLT_DEDUP=sort GLT_FUSED_HOP=1``
(the per-edge-type sorted reference of its fused engine), its key's
negatives and walk uniforms injected into the port (``kneg, key =
split(key)``, then one ``split`` a segment a hop), as
tests/test_torch_link.py does for the homogeneous path.

Tolerances: sampler and loader outputs bit for bit; three Adam steps of
the bipartite example's step from the same flax weights, the loss to
rtol 1e-5 and every parameter to atol 1e-5 (float32 sums in another
order: XLA's segment sums against ``index_add_``, the two Adam
formulas).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.loader import LinkNeighborLoader as JaxLinkNeighborLoader
from glt_tpu.models.rgnn import RGNN as JaxRGNN
from glt_tpu.sampler import EdgeSamplerInput as JaxEdgeSamplerInput
from glt_tpu.sampler import NegativeSampling as JaxNegativeSampling
from glt_tpu.sampler import NeighborSampler as JaxNeighborSampler
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.examples.hetero import bipartite_sage_unsup as bp
from glt_tpu_torch.loader import LinkNeighborLoader
from glt_tpu_torch.models import RGNN, rgnn_params_from_flax
from glt_tpu_torch.ops import cuda_kernels as K
from glt_tpu_torch.ops.pipeline import _fused_seed_hop
from glt_tpu_torch.parallel import SageTrainStep, link_bce_loss
from glt_tpu_torch.sampler import (EdgeSamplerInput, NegativeSampling,
                                   NeighborSampler)
from glt_tpu_torch.typing import reverse_edge_type
from test_torch_hetero_sampling import _jax_hetero_uniforms, _port_dataset
from test_torch_link import _proposals

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U2I = ('user', 'u2i', 'item')
I2I = ('item', 'i2i', 'item')
FANOUTS = [2, 2]
PARAM_ATOL = LOSS_RTOL = 1e-5
TYPE_FIELDS = ('node', 'node_count', 'batch', 'num_sampled_nodes')
EDGE_FIELDS = ('row', 'col', 'edge_mask', 'num_sampled_edges')
LINK_KEYS = ('edge_label_index', 'edge_label', 'src_index',
             'dst_pos_index', 'dst_neg_index')


def _sort_fused(monkeypatch):
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')


def _ring(num_users=10, num_items=20):
  """The JAX hetero ring fixture (u2i, i2i) and the port's Dataset over
  the same graph and feature rows."""
  from fixtures import hetero_ring_dataset
  jds = hetero_ring_dataset(num_users=num_users, num_items=num_items)
  ds = _port_dataset(jds)
  ds.init_node_features(
      {t: np.asarray(jds.get_node_feature(t)[np.arange(jds.node_count(t))])
       for t in ('user', 'item')}, device='cpu')
  return jds, ds


def _seed_sizes(etype, num_pos, neg):
  """The walk's seeds by node type of a link batch of ``num_pos``
  positives of ``etype``."""
  num_neg = neg.sample_size(num_pos) if neg is not None else 0
  n_src = num_pos + (num_neg if neg is None or neg.is_binary() else 0)
  n_dst = num_pos + num_neg
  if etype[0] != etype[-1]:
    return {etype[0]: n_src, etype[-1]: n_dst}
  return {etype[0]: n_src + n_dst}


def _port_draws(key, js, ps, etype, num_pos, neg):
  """The proposals and walk uniforms the JAX ``sample_from_edges`` takes
  from ``key`` (with negatives ``kneg, key = split(key)``)."""
  sizes = _seed_sizes(etype, num_pos, neg)
  if neg is None:
    return None, _jax_hetero_uniforms(key, js, sizes)
  kneg, kwalk = jax.random.split(key)
  return (_proposals(kneg, neg.sample_size(num_pos), ps.graph[etype]),
          _jax_hetero_uniforms(kwalk, js, sizes))


def _np(x):
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want):
  assert got.input_type == want.input_type
  for f in TYPE_FIELDS + EDGE_FIELDS:
    w, g = getattr(want, f), getattr(got, f)
    assert set(g) == set(w), f
    for k, v in w.items():
      np.testing.assert_array_equal(_np(g[k]), np.asarray(v),
                                    err_msg=f'{f}[{k}]')
  for t, v in want.metadata['seed_labels'].items():
    np.testing.assert_array_equal(_np(got.metadata['seed_labels'][t]),
                                  np.asarray(v), err_msg=f'seed_labels[{t}]')
  assert got.metadata['edge_hop_offsets'] == want.metadata['edge_hop_offsets']
  for f in LINK_KEYS:
    assert (f in got.metadata) == (f in want.metadata), f
    if f in want.metadata:
      a, b = got.metadata[f], want.metadata[f]
      if b is None:
        assert a is None, f
        continue
      np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=f)
  for f in ('num_pos', 'num_neg'):
    assert got.metadata[f] == want.metadata[f]


CASES = {
    # case: (edge type, negative sampling (mode, amount, strict) or None,
    #        labels given)
    'bipartite_binary': (U2I, ('binary', 1, False), False),
    'bipartite_binary_strict': (U2I, ('binary', 1, True), False),
    'bipartite_triplet': (U2I, ('triplet', 1, False), False),
    'bipartite_triplet_strict': (U2I, ('triplet', 2, True), False),
    'bipartite_labels_no_negatives': (U2I, None, True),
    'same_type_binary_strict': (I2I, ('binary', 2, True), False),
    'same_type_triplet': (I2I, ('triplet', 2, False), False),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_hetero_sample_from_edges_matches_jax(case, monkeypatch):
  _sort_fused(monkeypatch)
  etype, neg, labelled = CASES[case]
  jds, ds = _ring()
  js = JaxNeighborSampler(jds.graph, FANOUTS, seed=3)
  ps = NeighborSampler(ds.graph, FANOUTS, device='cpu', seed=3)
  if etype == U2I:     # users with repeats, their items (a repeated edge)
    rows = np.array([0, 3, 3, 7, 9, 0])
    cols = (2 * rows + np.array([0, 1, 1, 0, 1, 1])) % 20
  else:
    rows = np.array([5, 5, 11, 19, 0])
    cols = (rows + np.array([1, 2, 1, 1, 2])) % 20
  label = (np.arange(rows.size, dtype=np.float32) + 2 if labelled
           else None)
  pneg = NegativeSampling(*neg) if neg else None
  jneg = JaxNegativeSampling(*neg) if neg else None
  for step in range(2):
    key = jax.random.key(40 + step)
    want = js.sample_from_edges(JaxEdgeSamplerInput(
        rows, cols, label, input_type=etype, neg_sampling=jneg), key=key)
    props, u = _port_draws(key, js, ps, etype, rows.size, pneg)
    got = ps.sample_from_edges(EdgeSamplerInput(
        rows, cols, label, input_type=etype, neg_sampling=pneg),
        proposals=props, uniforms=u)
    _assert_same(got, want)
    src_t, _, dst_t = etype
    src_nodes, dst_nodes = got.node[src_t].numpy(), got.node[dst_t].numpy()
    meta = got.metadata
    if pneg is None or pneg.is_binary():
      eli = meta['edge_label_index'].numpy()
      # every positive slot resolves to its endpoint in its type's list
      np.testing.assert_array_equal(src_nodes[eli[0, :rows.size]], rows)
      np.testing.assert_array_equal(dst_nodes[eli[1, :rows.size]], cols)
    else:
      np.testing.assert_array_equal(src_nodes[meta['src_index'].numpy()],
                                    rows)
      np.testing.assert_array_equal(
          dst_nodes[meta['dst_pos_index'].numpy()], cols)


def test_hetero_link_sampler_draws_on_its_own_and_checks_the_edge_type():
  _, ds = _ring()
  a, b = (NeighborSampler(ds.graph, FANOUTS, device='cpu', seed=1)
          for _ in range(2))
  inp = EdgeSamplerInput(np.array([1, 2]), np.array([2, 5]), input_type=U2I,
                         neg_sampling=NegativeSampling('binary', 1, True))
  oa, ob = a.sample_from_edges(inp), b.sample_from_edges(inp)
  for t in oa.node:
    assert torch.equal(oa.node[t], ob.node[t])
  assert torch.equal(oa.metadata['edge_label_index'],
                     ob.metadata['edge_label_index'])
  assert oa.input_type == U2I and set(oa.batch) == {'user', 'item'}
  with pytest.raises(ValueError, match='edge type'):
    a.sample_from_edges(EdgeSamplerInput(np.array([1]), np.array([2])))
  with pytest.raises(ValueError, match='edge type'):
    a.sample_from_edges(EdgeSamplerInput(np.array([1]), np.array([2]),
                                         input_type=('user', 'x', 'item')))


# -- the loader --------------------------------------------------------------

def _loaders(jds, ds, eli, batch_size, neg, monkeypatch, fanouts=FANOUTS):
  """The JAX hetero LinkNeighborLoader and the port's, whose sampler takes
  the draws of the key the JAX sampler used for the same batch."""
  _sort_fused(monkeypatch)
  jl = JaxLinkNeighborLoader(jds, fanouts, edge_label_index=eli,
                             batch_size=batch_size, shuffle=True, seed=0,
                             neg_sampling=JaxNegativeSampling(*neg))
  js = jl.sampler
  keys, jax_sample = [], js.sample_from_edges

  def record_key(inputs):
    keys.append(js._next_key())
    return jax_sample(inputs, key=keys[-1])
  js.sample_from_edges = record_key
  pl = LinkNeighborLoader(ds, fanouts, edge_label_index=eli,
                          batch_size=batch_size, shuffle=True, seed=0,
                          neg_sampling=NegativeSampling(*neg), device='cpu')
  ps = pl.sampler
  real = ps.sample_from_edges

  def sample_from_edges(inputs):
    # zip pulls the JAX batch first, so its key is the last recorded
    props, u = _port_draws(keys[-1], js, ps, inputs.input_type,
                           len(inputs), NegativeSampling(*neg))
    return real(inputs, proposals=props, uniforms=u)
  ps.sample_from_edges = sample_from_edges
  return jl, pl


@pytest.mark.parametrize('neg,every_edge', [(('binary', 1), True),
                                            (('triplet', 2, True), False)])
def test_hetero_link_loader_epoch_matches_jax(neg, every_edge, monkeypatch):
  jds, ds = _ring(num_users=20, num_items=40)
  eli = (U2I, None if every_edge else
         np.stack([np.arange(30) % 20, (7 * np.arange(30)) % 40]))
  jl, pl = _loaders(jds, ds, eli, 16, neg, monkeypatch)
  assert len(pl) == len(jl) == (3 if every_edge else 2)
  n_valid = []
  for jb, pb in zip(jl, pl):
    assert pb.input_type == jb.input_type == U2I
    assert pb.batch_size == jb.batch_size == 16
    for f in ('x_dict', 'row_dict', 'col_dict', 'edge_mask_dict',
              'node_dict', 'node_count_dict', 'num_sampled_nodes',
              'num_sampled_edges'):
      want, got = getattr(jb, f), getattr(pb, f)
      assert set(got) == set(want), f
      for k, v in want.items():
        np.testing.assert_array_equal(_np(got[k]), np.asarray(v),
                                      err_msg=f'{f}[{k}]')
    assert pb.edge_hop_offsets_dict == jb.edge_hop_offsets_dict
    for f in LINK_KEYS:
      if f in jb.metadata:
        np.testing.assert_array_equal(_np(pb.metadata[f]),
                                      np.asarray(jb.metadata[f]), err_msg=f)
    assert pb.metadata['n_valid'] == jb.metadata['n_valid']
    n_valid.append(pb.metadata['n_valid'])
  assert n_valid == ([16, 16, 8] if every_edge else [16, 14])


def test_link_loader_needs_the_edge_type_of_a_hetero_dataset():
  _, ds = _ring()
  with pytest.raises(ValueError, match='edge type'):
    LinkNeighborLoader(ds, FANOUTS, device='cpu')
  loader = LinkNeighborLoader(ds, FANOUTS, edge_label_index=(U2I, None),
                              batch_size=8, device='cpu', seed=0,
                              neg_sampling=('binary', 1))
  b = next(iter(loader))
  assert b.input_type == U2I and tuple(b.x_dict) == ('user', 'item')
  assert tuple(b.metadata['edge_label_index'].shape) == (2, 16)


# -- K2's multi-type seed phase (plain) --------------------------------------

def test_multi_type_table_init_plain_equals_init_then_insert():
  # two seed types at their tag bases in one init, against the chain it
  # replaces on the card: the one-type init, then an in-place insert of
  # the second type's uniques
  gen = torch.Generator().manual_seed(4)
  slots, bases = 1 << 12, (0, 700)
  segs = []
  for n, hi, nv, base in ((64, 700, 60, bases[0]), (96, 900, 96, bases[1])):
    d, _ = _fused_seed_hop(torch.randint(0, hi, (n,), generator=gen,
                                         dtype=torch.int32), nv)
    segs.append((d['ids3'], d['labels3'], d['new_head3'], base))
  got = K.dedup_table_init_types(slots, segs, 'cpu')
  keys, vals, first = K.dedup_table_init_plain(slots, *segs[0], 'cpu')
  ids, labs, heads, base = segs[1]
  x = torch.where(heads & (ids < K.BIG), ids + base, torch.full_like(ids, -1))
  K.dedup_table_insert(keys, vals, x, labs, x >= 0)
  for a, b in zip(got, (keys, vals, first)):
    assert torch.equal(a, b)
  probe = torch.cat([torch.where(s[2], s[0] + s[3], -1) for s in segs])
  want = torch.cat([torch.where(s[2], s[1], -1) for s in segs]).long()
  assert torch.equal(K.dedup_table_lookup(got[0], got[1], probe), want)
  one = K.dedup_table_init_types(slots, segs[:1], 'cpu')
  for a, b in zip(one, K.dedup_table_init_plain(slots, *segs[0], 'cpu')):
    assert torch.equal(a, b)
  with pytest.raises(ValueError, match='seed types'):
    K.dedup_table_init_types(slots, [], 'cpu')


# -- the example's step ------------------------------------------------------

def _jax_example():
  path = os.path.join(ROOT, 'examples', 'hetero', 'bipartite_sage_unsup.py')
  spec = importlib.util.spec_from_file_location('jax_bipartite_example',
                                                path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def test_toy_taobao_matches_the_jax_example():
  jex = _jax_example()
  for kw in (dict(num_users=120, num_items=60), {}):
    want, got = jex.synthetic_taobao(**kw), bp.synthetic_taobao(**kw)
    for a, b in zip(want, got):
      np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _bipartite_data(nu=120):
  """The example's toy graph, its 80/20 split and features, as the JAX
  Dataset and the port's."""
  ui, ii, nu, ni = bp.synthetic_taobao(num_users=nu, num_items=nu // 2)
  train, test = bp.link_split(ui)
  rngf = np.random.default_rng(2)
  feats = {'user': rngf.normal(size=(nu, bp.FEAT)).astype(np.float32),
           'item': rngf.normal(size=(ni, bp.FEAT)).astype(np.float32)}
  jds = JaxDataset(edge_dir='out').init_graph(
      edge_index={bp.U2I: train, bp.I2U: train[::-1].copy(), bp.I2I: ii},
      num_nodes={'user': nu, 'item': ni})
  jds.init_node_features(feats)
  ds = bp.build_dataset(train, ii, nu, ni, feats, device='cpu')
  return jds, ds, train, test


def test_bipartite_train_steps_match_the_jax_example(monkeypatch):
  jds, ds, train, _ = _bipartite_data()
  jl, pl = _loaders(jds, ds, (bp.U2I, train), 32, ('binary', 1),
                    monkeypatch, fanouts=bp.FANOUTS)
  hidden, embed = 16, 8
  mp = [reverse_edge_type(e) for e in (bp.U2I, bp.I2U, bp.I2I)]
  jmodel = JaxRGNN(edge_types=mp, hidden_features=hidden, out_features=embed,
                   num_layers=2, conv='rsage', trim=False)
  model = RGNN(mp, bp.FEAT, hidden, embed, num_layers=2, conv='rsage',
               trim=False)
  tx = optax.adam(bp.LR)

  @jax.jit
  def jstep(params, opt, batch):   # the JAX example's step
    def loss_fn(p):
      emb = jmodel.apply(p, batch, return_all=True)
      eli = batch.metadata['edge_label_index']
      zu = jnp.take(emb['user'], eli[0], axis=0)
      zi = jnp.take(emb['item'], eli[1], axis=0)
      logit = (zu * zi).sum(-1)
      return optax.sigmoid_binary_cross_entropy(
          logit, batch.metadata['edge_label']).mean()
    loss, g = jax.value_and_grad(loss_fn)(params)
    up, opt = tx.update(g, opt)
    return optax.apply_updates(params, up), opt, loss

  step = SageTrainStep(model, lr=bp.LR, loss=link_bce_loss)
  params = opt = None
  for i, (jb, pb) in enumerate(zip(jl, pl)):
    if i == 3:
      break
    jb = jb.replace(metadata={k: jb.metadata[k] for k in
                              ('edge_label_index', 'edge_label')})
    if params is None:
      params = jax.jit(lambda k, b: jmodel.init(k, b, return_all=True))(
          jax.random.key(0), jb)
      opt = tx.init(params)
      model.load_state_dict(rgnn_params_from_flax(
          jax.tree.map(np.asarray, params)))
      with torch.no_grad():
        emb = model(pb, return_all=True)
      want = jax.jit(lambda p, b: jmodel.apply(p, b, return_all=True))(
          params, jb)
      assert set(emb) == set(want) == {'user', 'item'}
      for t in want:
        np.testing.assert_allclose(emb[t].numpy(), np.asarray(want[t]),
                                   rtol=0, atol=PARAM_ATOL, err_msg=t)
    params, opt, jloss = jstep(params, opt, jb)
    loss = step(pb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    want = rgnn_params_from_flax(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
      np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                 atol=PARAM_ATOL, err_msg=f'step {i} {k}')


def test_bipartite_example_trains_on_the_cpu(capsys):
  out = bp.main(['--device', 'cpu', '--epochs', '2', '--users', '160'])
  lines = capsys.readouterr().out.splitlines()
  assert len(lines) == 2 and lines[-1].startswith('epoch 1: loss=')
  assert np.isfinite(out['loss']) and 0 < out['loss'] < 2, lines
  assert 0.5 < out['auc'] <= 1, lines


def test_taobao_graph_keeps_links_in_a_category():
  ui, ii, nu, ni = bp.taobao_graph(num_users=300, num_items=2000,
                                   num_groups=40, links_per_user=7,
                                   sim_per_item=4, seed=1, device='cpu')
  group = torch.randint(0, 40, (ni,),
                        generator=torch.Generator().manual_seed(1))
  assert tuple(ui.shape) == (2, 300 * 7) and int(ui[1].max()) < ni
  cat = group[ui[1]].view(nu, 7)
  assert bool((cat == cat[:, :1]).all())
  assert bool((group[ii[0]] == group[ii[1]]).all())
  assert bool((ii[0] != ii[1]).all()) and ii.shape[1] == 4 * ni
  train, test = bp.link_split(ui)
  assert train.shape[1] + test.shape[1] == ui.shape[1]
  assert test.shape[1] == ui.shape[1] // 5
