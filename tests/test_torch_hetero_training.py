"""Hetero RGNN training in the port (the hetero ``NeighborLoader`` ->
``NeighborSampler`` -> per-type feature gather -> RGNN -> masked
cross-entropy on ``y_dict['paper']`` -> Adam, through
``glt_tpu_torch.parallel.SageTrainStep``) against the JAX package on the
same numpy data, with the JAX draws injected.

The toy is built like examples/common.py's ``synthetic_hetero_mag`` (300
papers, 150 authors, 12 features, 5 learnable classes) with the
reversed ``writes`` relation beside it, as the IGBH trainer adds them;
fanouts [3, 2] on every edge type, batch 32 over a seeded 60% of the
papers (180 seeds: five full batches and a padded tail of 20).

Tolerances:
- the loaders' batches match bit for bit (the JAX hetero sampler on
  ``GLT_DEDUP=sort GLT_FUSED_HOP=1``, the per-edge-type sorted reference
  of its fused engine), bf16 features too;
- three Adam steps from the same flax parameters against a jitted copy
  of examples/hetero/train_rgnn.py's step with ``optax.adam(1e-3)``:
  the loss to rtol 1e-5, every parameter to atol 1e-5 after each step
  (float32 sums in another order: XLA's segment sums against
  ``index_add_``, the two Adam formulas; measured on this toy: losses
  within 1.7e-7 relative, parameters within 3.6e-7 for RGAT and 1.2e-7
  for RSAGE, so RGAT's segment softmax needs no looser bound);
- RGNN on a bf16 feature dict against the flax RGNN on the same input:
  rtol 0, atol 1e-5 (RGAT: flax's ``Dense`` promotes the bf16 input to
  float32 exactly where the port promotes it; measured 1.8e-7). RSAGE is
  held to the flax model on the input promoted to float32, at the same
  bound: the flax SAGEConv averages the bf16 messages in bf16 before its
  ``Dense`` promotes them, the port promotes once per layer input and
  averages in float32, which moved the logits by up to 6.2e-3 against
  the flax model on bf16 (ROADMAP C, deliberate differences).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.loader import NeighborLoader as JaxNeighborLoader
from glt_tpu.models.rgnn import RGNN as JaxRGNN
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.models import RGNN, rgnn_params_from_flax
from glt_tpu_torch.parallel import SageTrainStep, sage_loss
from glt_tpu_torch.typing import reverse_edge_type
from test_torch_hetero_sampling import _jax_hetero_uniforms

P, A, F, C, B, FANOUTS, HIDDEN, HEADS = 300, 150, 12, 5, 32, [3, 2], 16, 2
CITES = ('paper', 'cites', 'paper')
WRITES = ('author', 'writes', 'paper')
REV_WRITES = ('paper', 'rev_writes', 'author')
EDGES = (CITES, WRITES, REV_WRITES)
LOSS_RTOL = PARAM_ATOL = BF16_ATOL = 1e-5
DICT_KEYS = ('row_dict', 'col_dict', 'edge_mask_dict', 'node_dict',
             'node_count_dict', 'num_sampled_nodes', 'num_sampled_edges',
             'y_dict')


def _numpy_data():
  rng = np.random.default_rng(0)
  pp = np.stack([rng.integers(0, P, P * 8), rng.integers(0, P, P * 8)])
  ap = np.stack([rng.integers(0, A, P * 3), rng.integers(0, P, P * 3)])
  x = {'paper': rng.standard_normal((P, F)).astype(np.float32),
       'author': rng.standard_normal((A, F)).astype(np.float32)}
  y = np.argmax(x['paper'] @ rng.standard_normal((F, C)).astype(np.float32),
                1).astype(np.int32)
  train = rng.permutation(P)[:int(0.6 * P)]
  edges = {CITES: pp, WRITES: ap, REV_WRITES: np.ascontiguousarray(ap[::-1])}
  return edges, x, y, train


def _datasets(edge_dir='out', bf16=False):
  """The JAX and the port's Dataset over the same arrays."""
  edges, x, y, train = _numpy_data()
  counts = {'paper': P, 'author': A}
  jds = JaxDataset(edge_dir=edge_dir).init_graph(edge_index=edges,
                                                 num_nodes=counts)
  jds.init_node_features(x, dtype=jnp.bfloat16 if bf16 else None)
  jds.init_node_labels({'paper': y})
  ds = Dataset(edge_dir=edge_dir).init_graph(edges, num_nodes=counts,
                                             device='cpu')
  ds.init_node_features(x, dtype=torch.bfloat16 if bf16 else None,
                        device='cpu')
  ds.init_node_labels({'paper': y})
  return jds, ds, train


def _loaders(jds, ds, train, monkeypatch, **kw):
  """The JAX hetero loader on the sorted reference and the port's, whose
  sampler draws what the JAX sampler's key for the same batch draws."""
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  fanouts = {e: FANOUTS for e in EDGES}
  jl = JaxNeighborLoader(jds, fanouts, input_nodes=('paper', train),
                         batch_size=B, shuffle=True, seed=0, **kw)
  js = jl.sampler
  keys, next_key = [], js._next_key

  def record_key():
    keys.append(next_key())
    return keys[-1]
  js._next_key = record_key
  pl = NeighborLoader(ds, fanouts, ('paper', train), batch_size=B,
                      shuffle=True, seed=0, device='cpu', **kw)
  # zip pulls the JAX batch first, so its key is the last recorded
  pl.sampler.hop_uniforms = lambda b, t: _jax_hetero_uniforms(
      keys[-1], js, {t: b})
  return jl, pl


def _bits(a):
  """Array bits for a bit-for-bit compare (bf16 has no numpy dtype in
  torch)."""
  if isinstance(a, torch.Tensor):
    return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
  a = np.asarray(a)
  return a.view(np.int16) if a.dtype.name == 'bfloat16' else a


def _assert_batches_equal(jb, pb):
  assert pb.input_type == jb.input_type == 'paper'
  assert pb.batch_size == jb.batch_size == B
  for f in DICT_KEYS + ('x_dict',):
    want, got = getattr(jb, f), getattr(pb, f)
    assert set(got) == set(want), f
    for k, v in want.items():
      np.testing.assert_array_equal(_bits(got[k]), _bits(v),
                                    err_msg=f'{f}[{k}]')
  assert pb.edge_hop_offsets_dict == jb.edge_hop_offsets_dict
  assert set(pb.metadata) == set(jb.metadata) == {'seed_labels', 'n_valid'}
  assert pb.metadata['n_valid'] == jb.metadata['n_valid']
  np.testing.assert_array_equal(
      pb.metadata['seed_labels']['paper'].numpy(),
      np.asarray(jb.metadata['seed_labels']['paper']))


@pytest.mark.parametrize('edge_dir,bf16', [('out', False), ('out', True),
                                           ('in', False)])
def test_hetero_loader_batches_match_jax(edge_dir, bf16, monkeypatch):
  jds, ds, train = _datasets(edge_dir, bf16)
  jl, pl = _loaders(jds, ds, train, monkeypatch)
  assert len(pl) == len(jl) == 6          # 180 seeds: 5 full + 20
  n_valid = []
  for _ in range(2):
    for jb, pb in zip(jl, pl):
      _assert_batches_equal(jb, pb)
      assert pb.x_dict['paper'].dtype == (torch.bfloat16 if bf16
                                          else torch.float32)
      n_valid.append(pb.metadata['n_valid'])
  assert n_valid == [B] * 5 + [20] + [B] * 5 + [20]
  # 'out' reverses the traversal types into message-flow keys, 'in' keeps
  # them: with every relation's reverse in the graph both give these keys
  assert set(pb.row_dict) == set(EDGES)
  assert int(pb.node_count_dict['author']) > 0


def _jax_step(jmodel, tx):
  """examples/hetero/train_rgnn.py's step, its loss on ``y_dict['paper']``."""
  @jax.jit
  def step(params, opt, batch):
    def loss_fn(p):
      logits = jmodel.apply(p, batch)
      mask = jnp.arange(logits.shape[0]) < batch.metadata['n_valid']
      l = optax.softmax_cross_entropy_with_integer_labels(
          logits, batch.y_dict['paper'])
      return jnp.where(mask, l, 0).sum() / jnp.maximum(mask.sum(), 1)
    loss, g = jax.value_and_grad(loss_fn)(params)
    up, opt = tx.update(g, opt)
    return optax.apply_updates(params, up), opt, loss
  return step


def _models(conv):
  mp = [reverse_edge_type(e) for e in EDGES]
  jmodel = JaxRGNN(edge_types=mp, hidden_features=HIDDEN, out_features=C,
                   num_layers=len(FANOUTS), conv=conv, heads=HEADS)
  model = RGNN(mp, F, HIDDEN, C, num_layers=len(FANOUTS), conv=conv,
               heads=HEADS)
  return jmodel, model


def _np_tree(params):
  return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize('conv', ['rgat', 'rsage'])
def test_train_steps_match_jax_step(conv, monkeypatch):
  jds, ds, train = _datasets()
  jl, pl = _loaders(jds, ds, train, monkeypatch)
  jmodel, model = _models(conv)
  tx = optax.adam(1e-3)
  jstep = _jax_step(jmodel, tx)
  step = SageTrainStep(model, lr=1e-3)
  params = opt = None
  for i, (jb, pb) in enumerate(zip(jl, pl)):
    if i == 3:
      break
    if params is None:
      params = jax.jit(jmodel.init)(jax.random.key(0), jb)
      opt = tx.init(params)
      model.load_state_dict(rgnn_params_from_flax(_np_tree(params)))
    with torch.no_grad():
      before = float(sage_loss(model, pb))
    meta = dict(jb.metadata, n_valid=jnp.asarray(jb.metadata['n_valid']))
    params, opt, jloss = jstep(params, opt, jb.replace(metadata=meta))
    loss = step(pb)
    assert float(loss) == before
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    want = rgnn_params_from_flax(_np_tree(params))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
      np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                 atol=PARAM_ATOL, err_msg=f'step {i} {k}')


@pytest.mark.parametrize('conv', ['rgat', 'rsage'])
def test_rgnn_on_bf16_features_matches_flax(conv, monkeypatch):
  jds, ds, train = _datasets(bf16=True)
  jl, pl = _loaders(jds, ds, train, monkeypatch)
  jb, pb = next(zip(jl, pl))
  assert pb.x_dict['paper'].dtype == torch.bfloat16
  jmodel, model = _models(conv)
  if conv == 'rsage':     # flax averages bf16 messages in bf16
    jb = jb.replace(x_dict={t: v.astype(jnp.float32)
                            for t, v in jb.x_dict.items()})
  params = jax.jit(jmodel.init)(jax.random.key(1), jb)
  want = jax.jit(jmodel.apply)(params, jb)
  model.load_state_dict(rgnn_params_from_flax(_np_tree(params)))
  with torch.no_grad():
    got = model(pb)
  assert got.dtype == torch.float32 and got.shape == (B, C)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=BF16_ATOL)


def test_hetero_loss_masks_padded_seeds():
  _, ds, train = _datasets()
  pl = NeighborLoader(ds, FANOUTS, ('paper', train), batch_size=B,
                      device='cpu', seed=0)
  tail = list(pl)[-1]
  assert tail.metadata['n_valid'] == 20
  _, model = _models('rgat')
  with torch.no_grad():
    logits = model(tail)
    want = torch.nn.functional.cross_entropy(
        logits[:20], tail.y_dict['paper'][:20].long())
    np.testing.assert_allclose(float(sage_loss(model, tail)), float(want),
                               rtol=1e-6)


def test_drop_last_and_collect_features_as_jax(monkeypatch):
  # hetero: the same batches, the tail dropped, no feature dict
  jds, ds, train = _datasets()
  jl, pl = _loaders(jds, ds, train, monkeypatch, drop_last=True,
                    collect_features=False)
  assert len(pl) == len(jl) == 5
  got = 0
  for jb, pb in zip(jl, pl):
    _assert_batches_equal(jb, pb)
    assert pb.x_dict == {} and jb.x_dict == {}
    assert pb.metadata['n_valid'] == B
    got += 1
  assert got == 5
  # homogeneous: the cites graph alone, labels of every paper
  edges, x, y, _ = _numpy_data()
  jh = JaxDataset().init_graph(edge_index=edges[CITES], num_nodes=P)
  ph = Dataset().init_graph(edges[CITES], num_nodes=P, device='cpu')
  for d in (jh, ph):
    d.init_node_features(x['paper'], device='cpu' if d is ph else None)
    d.init_node_labels(y)
  for drop_last in (False, True):
    kw = dict(batch_size=64, drop_last=drop_last, collect_features=False)
    jbs = list(JaxNeighborLoader(jh, FANOUTS, np.arange(P), **kw))
    pbs = list(NeighborLoader(ph, FANOUTS, np.arange(P), device='cpu', **kw))
    assert len(jbs) == len(pbs) == (4 if drop_last else 5)
    assert ([b.metadata['n_valid'] for b in pbs]
            == [b.metadata['n_valid'] for b in jbs])
    for jb, pb in zip(jbs, pbs):
      assert pb.x is None and jb.x is None
      np.testing.assert_array_equal(pb.y.numpy(), np.asarray(jb.y))
