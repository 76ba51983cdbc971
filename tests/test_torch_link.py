"""Link prediction in the port (``ops.negative``, ``RandomNegativeSampler``,
``NeighborSampler.sample_from_edges``, ``LinkNeighborLoader``,
``GraphSAGE.embed`` and ``link_bce_loss``) against the JAX package on the
same numpy inputs, with the JAX draws injected: the negatives' ``randint``
proposals and the walk's uniforms, both from the key the JAX sampler
splits.

The JAX sampler runs its sort+fused reference (``GLT_DEDUP=sort
GLT_FUSED_HOP=1``), which its cross-hop walk is bit-identical to.
Membership, negatives and sampled batches must match bit for bit; the
example's training step (examples/graph_sage_unsup.py: embed -> dot
product -> sigmoid BCE -> ``optax.adam(3e-3)``) to atol 1e-5 in every
parameter over three steps (float32 sums in another order on a
bit-identical batch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.loader import LinkNeighborLoader as JaxLinkNeighborLoader
from glt_tpu.models.sage import GraphSAGE as JaxGraphSAGE
from glt_tpu.ops.negative import edge_in_csr as jax_edge_in_csr
from glt_tpu.ops.negative import \
    random_negative_sample as jax_random_negative_sample
from glt_tpu.sampler import EdgeSamplerInput as JaxEdgeSamplerInput
from glt_tpu.sampler import NegativeSampling as JaxNegativeSampling
from glt_tpu.sampler import NeighborSampler as JaxNeighborSampler
from glt_tpu.sampler.negative_sampler import \
    RandomNegativeSampler as JaxRandomNegativeSampler
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.examples import graph_sage_unsup as unsup
from glt_tpu_torch.loader import LinkNeighborLoader
from glt_tpu_torch.models import GraphSAGE, sage_params_from_flax
from glt_tpu_torch.ops.negative import edge_in_csr, random_negative_sample
from glt_tpu_torch.parallel import SageTrainStep, link_bce_loss
from glt_tpu_torch.sampler import (EdgeSamplerInput, NegativeSampling,
                                   NeighborSampler, RandomNegativeSampler)
from test_torch_weighted_sampling import hop_uniforms_from_key

N, E, F, FANOUTS = 90, 700, 12, [3, 2]
TRIALS = 5
PARAM_ATOL = LOSS_RTOL = 1e-5
OUT_KEYS = ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch',
            'num_sampled_nodes', 'num_sampled_edges')
META_KEYS = ('seed_labels', 'seed_count', 'edge_label_index', 'edge_label',
             'src_index', 'dst_pos_index', 'dst_neg_index')


def _edges(seed=0):
  """A small skewed multigraph: rows 80.. have no out-edges, some
  duplicate edges."""
  rng = np.random.default_rng(seed)
  src = (rng.random(E) ** 2 * 80).astype(np.int64)
  dst = rng.integers(0, N, E)
  src[-20:], dst[-20:] = src[:20], dst[:20]
  return np.stack([src, dst])


def _datasets(edge_dir='out', seed=0, feats=False):
  ei = _edges(seed)
  jds = JaxDataset(edge_dir=edge_dir)
  jds.init_graph(edge_index=ei, num_nodes=N)
  ds = Dataset(edge_dir=edge_dir).init_graph(ei, num_nodes=N, device='cpu')
  if feats:
    x = np.random.default_rng(seed + 1).standard_normal(
        (N, F)).astype(np.float32)
    jds.init_node_features(x)
    ds.init_node_features(x, device='cpu')
  return jds, ds


def _np(x):
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _proposals(key, req, g):
  """The JAX negative sampler's draws from ``key``."""
  kr, kc = jax.random.split(key)
  t = max(TRIALS, 1)
  return tuple(torch.as_tensor(np.array(jax.random.randint(
      k, (t, req), 0, n, dtype=jnp.int32)))
               for k, n in ((kr, g.topo.num_rows), (kc, g.topo.num_cols)))


# -- membership and negatives ---------------------------------------------------

def test_edge_in_csr_matches_jax():
  jds, ds = _datasets()
  g, jg = ds.get_graph(), jds.get_graph()
  ei = _edges()
  rng = np.random.default_rng(3)
  rows = np.concatenate([ei[0], rng.integers(0, N, 3000), [0, N - 1, 85]])
  cols = np.concatenate([ei[1], rng.integers(0, N, 3000), [N - 1, 0, 3]])
  want = np.asarray(jax_edge_in_csr(jg.indptr, jg.indices,
                                    jnp.asarray(rows, jnp.int32),
                                    jnp.asarray(cols, jnp.int32)))
  # an int64 pointer, as Topology holds it, and the device's int32 one
  for indptr in (g.topo.indptr, g.indptr):
    got = edge_in_csr(indptr, g.indices, torch.as_tensor(rows),
                      torch.as_tensor(cols)).numpy()
    np.testing.assert_array_equal(got, want)
  assert got[:E].all() and 0 < got[E:].sum() < 3000
  edges = set(zip(ei[0].tolist(), ei[1].tolist()))
  assert got.tolist() == [(int(r), int(c)) in edges
                          for r, c in zip(rows, cols)]


@pytest.mark.parametrize('strict,padding', [(True, False), (True, True),
                                            (False, False), (False, True)])
def test_random_negative_sample_matches_jax(strict, padding):
  # a dense graph, so that strict rounds fail often and some requests
  # exhaust every round
  rng = np.random.default_rng(5)
  n, e = 12, 130
  ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
  jds = JaxDataset().init_graph(edge_index=ei, num_nodes=n)
  g = Dataset().init_graph(ei, num_nodes=n, device='cpu').get_graph()
  jg = jds.get_graph()
  req, trials = 400, 2
  key = jax.random.key(7)
  want = jax_random_negative_sample(jg.indptr, jg.indices, req, trials, key,
                                    n, n, strict=strict, padding=padding)
  kr, kc = jax.random.split(key)
  props = tuple(torch.as_tensor(np.array(jax.random.randint(
      k, (trials, req), 0, n, dtype=jnp.int32))) for k in (kr, kc))
  got = random_negative_sample(g.indptr, g.indices, req, trials, n, n,
                               strict=strict, padding=padding,
                               proposals=props)
  for f in ('rows', 'cols', 'mask'):
    np.testing.assert_array_equal(_np(getattr(got, f)),
                                  np.asarray(getattr(want, f)), err_msg=f)
  if strict and not padding:
    assert 0 < int(got.mask.sum()) < req
    hit = edge_in_csr(g.indptr, g.indices, got.rows, got.cols)
    assert not bool((hit & got.mask).any())
  # the default draws come from a generator, in the same shapes
  gen = torch.Generator().manual_seed(0)
  out = random_negative_sample(g.indptr, g.indices, req, trials, n, n,
                               strict=strict, padding=padding, generator=gen)
  assert out.rows.dtype == torch.int32 and out.rows.shape == (req,)


def test_negative_sampler_swaps_under_edge_dir_in():
  jds, ds = _datasets(edge_dir='in')
  g = ds.get_graph()
  assert g.layout == 'CSC'
  for strict in (True, False):
    js = JaxRandomNegativeSampler(jds.get_graph(),
                                  mode='strict' if strict else 'non-strict',
                                  edge_dir='in')
    ps = RandomNegativeSampler(g, edge_dir='in')
    key = jax.random.key(11)
    want = js.sample(300, trials_num=TRIALS, padding=False, key=key)
    got = ps.sample(300, trials_num=TRIALS, padding=False, strict=strict,
                    proposals=_proposals(key, 300, g))
    for f in ('rows', 'cols', 'mask'):
      np.testing.assert_array_equal(_np(getattr(got, f)),
                                    np.asarray(getattr(want, f)))
    # (src, dst) pairs: a strict negative is no edge of the original COO
    if strict:
      ei = _edges()
      edges = set(zip(ei[0].tolist(), ei[1].tolist()))
      ok = got.mask.numpy()
      assert not any((int(r), int(c)) in edges for r, c in
                     zip(got.rows.numpy()[ok], got.cols.numpy()[ok]))


def test_negative_sampling_config_matches_jax():
  for mode, amount, size in (('binary', 1, 7), ('binary', 0.5, 4),
                             ('binary', 1.5, 11), ('triplet', 2, 14),
                             ('triplet', 1.2, 14)):
    a, b = NegativeSampling(mode, amount), JaxNegativeSampling(mode, amount)
    assert a.amount == b.amount and a.sample_size(7) == b.sample_size(7)
    assert a.sample_size(7) == size
  assert NegativeSampling.cast(('triplet', 2)).is_triplet()
  assert NegativeSampling.cast({'amount': 3}).amount == 3
  assert NegativeSampling.cast(None) is None
  for bad in (dict(mode='pairs'), dict(amount=0)):
    with pytest.raises(ValueError):
      NegativeSampling(**bad)
  inp = EdgeSamplerInput(np.arange(5), np.arange(5) + 1, np.ones(5))
  assert len(inp) == 5 and inp[1:3].col.tolist() == [2, 3]


# -- sample_from_edges ----------------------------------------------------------

def _sort_fused(monkeypatch):
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')


def _port_draws(key, num_neg, num_seeds, ps):
  """The proposals and walk uniforms the JAX ``sample_from_edges`` takes
  from ``key`` (with negatives ``kneg, key = split(key)``)."""
  if not num_neg:
    return None, hop_uniforms_from_key(key, num_seeds, ps)
  kneg, kwalk = jax.random.split(key)
  return (_proposals(kneg, num_neg, ps.graph),
          hop_uniforms_from_key(kwalk, num_seeds, ps))


def _assert_same(got, want):
  for f in OUT_KEYS:
    np.testing.assert_array_equal(_np(getattr(got, f)),
                                  np.asarray(getattr(want, f)), err_msg=f)
  for f in META_KEYS:
    if f in want.metadata:
      a, b = got.metadata[f], want.metadata[f]
      if b is None:
        assert a is None, f
        continue
      np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=f)
  for f in ('num_pos', 'num_neg'):
    assert got.metadata[f] == want.metadata[f]
  assert got.edge_hop_offsets == list(want.edge_hop_offsets)


@pytest.mark.parametrize('mode,amount,strict', [
    ('binary', 1, False), ('binary', 1, True), ('triplet', 1, False),
    ('triplet', 2, True)])
def test_sample_from_edges_matches_jax(mode, amount, strict, monkeypatch):
  _sort_fused(monkeypatch)
  jds, ds = _datasets()
  js = JaxNeighborSampler(jds.get_graph(), FANOUTS, seed=3)
  ps = NeighborSampler(ds.get_graph(), FANOUTS, device='cpu', seed=3)
  ei = _edges()
  # positives with repeated endpoints and a repeated edge; a leaf dst
  pos = np.array([0, 5, 5, 17, 40, 0, 3, 5])
  rows, cols = ei[0][pos], ei[1][pos]
  cols[3] = 85
  neg = NegativeSampling(mode, amount, strict)
  jneg = JaxNegativeSampling(mode, amount, strict)
  num_pos, num_neg = len(pos), neg.sample_size(len(pos))
  n_seeds = 2 * (num_pos + num_neg) if mode == 'binary' else (
      2 * num_pos + num_neg)
  for step in range(2):
    key = jax.random.key(30 + step)
    want = js.sample_from_edges(
        JaxEdgeSamplerInput(rows, cols, neg_sampling=jneg), key=key)
    props, u = _port_draws(key, num_neg, n_seeds, ps)
    got = ps.sample_from_edges(EdgeSamplerInput(rows, cols, neg_sampling=neg),
                               proposals=props, uniforms=u)
    _assert_same(got, want)
    node = got.node.numpy()
    if mode == 'binary':
      eli = got.metadata['edge_label_index'].numpy()
      assert eli.shape == (2, num_pos + num_neg)
      # every slot, repeats included, resolves to its endpoint
      np.testing.assert_array_equal(node[eli[0, :num_pos]], rows)
      np.testing.assert_array_equal(node[eli[1, :num_pos]], cols)
      np.testing.assert_array_equal(got.metadata['edge_label'].numpy(),
                                    [1] * num_pos + [0] * num_neg)
    else:
      np.testing.assert_array_equal(
          node[got.metadata['src_index'].numpy()], rows)
      dneg = got.metadata['dst_neg_index'].numpy()
      assert dneg.shape == ((num_pos, amount) if amount > 1 else (num_pos,))
    if strict and mode == 'binary':
      # (a triplet keeps only the negative's dst, so its pair is not
      # the one the strict test checked)
      src, dst = node[got.metadata['edge_label_index'].numpy()[:, num_pos:]]
      edges = set(zip(ei[0].tolist(), ei[1].tolist()))
      hits = [(int(a), int(b)) in edges for a, b in zip(src, dst)]
      # padding keeps a request's last proposal when every round hit
      assert sum(hits) <= 1


def test_sample_from_edges_keeps_given_labels(monkeypatch):
  _sort_fused(monkeypatch)
  jds, ds = _datasets()
  js = JaxNeighborSampler(jds.get_graph(), FANOUTS, seed=4)
  ps = NeighborSampler(ds.get_graph(), FANOUTS, device='cpu', seed=4)
  rows, cols = np.array([1, 2, 3]), np.array([4, 4, 6])
  label = np.array([3.0, 2.0, 5.0], np.float32)
  key = jax.random.key(1)
  for neg in (None, ('binary', 2)):
    want = js.sample_from_edges(JaxEdgeSamplerInput(
        rows, cols, label,
        neg_sampling=JaxNegativeSampling(*neg) if neg else None), key=key)
    n_neg = 6 if neg else 0
    props, u = _port_draws(key, n_neg, 2 * (3 + n_neg), ps)
    got = ps.sample_from_edges(EdgeSamplerInput(
        rows, cols, label, neg_sampling=neg and NegativeSampling(*neg)),
        proposals=props, uniforms=u)
    _assert_same(got, want)
  with pytest.raises(NotImplementedError):
    ps.sample_from_edges(EdgeSamplerInput(rows, cols,
                                          input_type=('a', 'to', 'a')))


# -- the loader and the example's step --------------------------------------------

def _loaders(jds, ds, batch_size, neg, monkeypatch):
  """The JAX LinkNeighborLoader and the port's, whose sampler takes the
  draws of the key the JAX sampler used for the same batch."""
  _sort_fused(monkeypatch)
  jl = JaxLinkNeighborLoader(jds, FANOUTS, batch_size=batch_size,
                             shuffle=True, seed=0,
                             neg_sampling=JaxNegativeSampling(*neg))
  js = jl.sampler
  keys, jax_sample = [], js.sample_from_edges

  def record_key(inputs):
    # the batch's key, drawn as sample_from_edges draws it (its inner
    # sample_from_nodes draws one more and does not use it)
    keys.append(js._next_key())
    return jax_sample(inputs, key=keys[-1])
  js.sample_from_edges = record_key
  pl = LinkNeighborLoader(ds, FANOUTS, batch_size=batch_size, shuffle=True,
                          seed=0, neg_sampling=NegativeSampling(*neg),
                          device='cpu')
  ps = pl.sampler
  real = ps.sample_from_edges
  num_neg = NegativeSampling(*neg).sample_size(batch_size)
  n_seeds = (2 * (batch_size + num_neg) if neg[0] == 'binary'
             else 2 * batch_size + num_neg)

  def sample_from_edges(inputs):
    # zip pulls the JAX batch first, so its key is the last recorded
    props, u = _port_draws(keys[-1], num_neg, n_seeds, ps)
    return real(inputs, proposals=props, uniforms=u)
  ps.sample_from_edges = sample_from_edges
  return jl, pl


@pytest.mark.parametrize('neg', [('binary', 1), ('triplet', 2)])
def test_link_neighbor_loader_epoch_matches_jax(neg, monkeypatch):
  jds, ds = _datasets(feats=True)
  batch_size = 128                      # 700 edges: 5 full + 60
  jl, pl = _loaders(jds, ds, batch_size, neg, monkeypatch)
  assert len(pl) == len(jl) == 6
  n_valid = []
  for jb, pb in zip(jl, pl):
    for f in OUT_KEYS[:-3] + ('x', 'num_sampled_nodes', 'num_sampled_edges'):
      if f == 'batch':
        continue
      np.testing.assert_array_equal(_np(getattr(pb, f)),
                                    np.asarray(getattr(jb, f)), err_msg=f)
    for f in META_KEYS:
      if f in jb.metadata:
        np.testing.assert_array_equal(_np(pb.metadata[f]),
                                      np.asarray(jb.metadata[f]), err_msg=f)
    assert pb.metadata['n_valid'] == jb.metadata['n_valid']
    assert pb.batch_size == jb.batch_size == batch_size
    assert pb.edge_hop_offsets == jb.edge_hop_offsets
    n_valid.append(pb.metadata['n_valid'])
  assert n_valid == [batch_size] * 5 + [60]


def test_link_train_steps_match_the_example(monkeypatch):
  jds, ds = _datasets(feats=True)
  jl, pl = _loaders(jds, ds, 128, ('binary', 1), monkeypatch)
  hidden, embed = 16, 8
  jmodel = JaxGraphSAGE(hidden_features=hidden, out_features=embed,
                        num_layers=len(FANOUTS))
  tx = optax.adam(3e-3)

  @jax.jit
  def jstep(params, opt, batch):     # examples/graph_sage_unsup.py's step
    def loss_fn(p):
      emb = jmodel.apply(p, batch, method=JaxGraphSAGE.embed)
      eli = batch.metadata['edge_label_index']
      lab = batch.metadata['edge_label']
      logit = (emb[eli[0]] * emb[eli[1]]).sum(-1)
      return optax.sigmoid_binary_cross_entropy(logit, lab).mean()
    loss, g = jax.value_and_grad(loss_fn)(params)
    up, opt = tx.update(g, opt)
    return optax.apply_updates(params, up), opt, loss

  model = GraphSAGE(F, hidden, embed, num_layers=len(FANOUTS))
  step = SageTrainStep(model, lr=3e-3, loss=link_bce_loss)
  params = opt = None
  for i, (jb, pb) in enumerate(zip(jl, pl)):
    if i == 3:
      break
    jb = jb.replace(metadata={k: jb.metadata[k] for k in
                              ('edge_label_index', 'edge_label')})
    if params is None:
      params = jax.jit(jmodel.init)(jax.random.key(0), jb)
      opt = tx.init(params)
      model.load_state_dict(sage_params_from_flax(
          jax.tree.map(np.asarray, params)))
      emb = model.embed(pb).detach().numpy()
      np.testing.assert_allclose(
          emb, np.asarray(jmodel.apply(params, jb, method=JaxGraphSAGE.embed)),
          rtol=0, atol=PARAM_ATOL)
      assert emb.shape == (pb.node.numel(), embed)
    params, opt, jloss = jstep(params, opt, jb)
    loss = step(pb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    want = sage_params_from_flax(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
      np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                 atol=PARAM_ATOL, err_msg=f'step {i} {k}')


def test_link_loader_draws_on_its_own_and_refuses_hetero():
  _, ds = _datasets(feats=True)
  pl = LinkNeighborLoader(ds, FANOUTS, batch_size=100,
                          neg_sampling=('binary', 1), device='cpu', seed=0)
  b = next(iter(pl))
  eli = b.metadata['edge_label_index']
  assert tuple(eli.shape) == (2, 200) and b.x.shape[1] == F
  ei = _edges()
  node = b.node.numpy()
  np.testing.assert_array_equal(node[eli[0, :100].numpy()],
                                pl.edge_rows[:100])
  hds = Dataset().init_graph({('a', 'to', 'b'): ei}, num_nodes=N,
                             device='cpu')
  # a hetero dataset's link seeds name their edge type
  # (tests/test_torch_hetero_link.py loads them)
  with pytest.raises(ValueError, match='edge type'):
    LinkNeighborLoader(hds, FANOUTS, device='cpu')


# -- the port's example ----------------------------------------------------------

def test_unsup_example_graph_matches_the_jax_examples():
  from examples.common import synthetic_products as jax_synthetic_products
  jds, _ = jax_synthetic_products(num_nodes=300)
  ds, classes = unsup.synthetic_products(num_nodes=300, device='cpu')
  assert classes == 47
  jg, g = jds.get_graph(), ds.get_graph()
  for f in ('indptr', 'indices'):
    np.testing.assert_array_equal(_np(getattr(g, f)),
                                  np.asarray(getattr(jg, f)), err_msg=f)
  np.testing.assert_array_equal(ds.get_node_feature().table.numpy(),
                                jds.get_node_feature()[np.arange(300)])
  np.testing.assert_array_equal(_np(ds.get_node_label()),
                                np.asarray(jds.get_node_label()))
  for split in ('train', 'valid', 'test'):
    np.testing.assert_array_equal(ds.get_split(split), jds.get_split(split))


def test_unsup_example_trains_on_the_cpu(monkeypatch, capsys):
  # main() end to end on the CPU, its graph cut from 3,000 nodes to 300
  # (59 batches of 128 links an epoch)
  build = unsup.synthetic_products
  monkeypatch.setattr(unsup, 'synthetic_products',
                      lambda num_nodes, device: build(300, device=device))
  loss = unsup.main(['--device', 'cpu', '--epochs', '2'])
  out = capsys.readouterr().out.splitlines()
  losses = [float(line.split('loss=')[1]) for line in out]
  assert len(losses) == 2 and losses[-1] == round(loss, 4), out
  assert np.isfinite(loss) and 0 < loss < 2, out
