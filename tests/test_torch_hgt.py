"""The port's HGT (``HGTConv``, ``HGT``) against the flax models, with the
flax weights carried over by ``hgt_params_from_flax``, and
examples/hetero/train_hgt_mag.py's step (the hetero NeighborLoader over
the ogbn-mag-shaped graph seeded on papers -> HGT -> masked
cross-entropy -> Adam(2e-3)) against the JAX step on the same batches,
the JAX draws injected; then the port's hetero examples on the CPU.

Tolerances: the forward rtol = atol = 1e-5 (the two frameworks sum the
attention weights, the messages and the products in other orders);
three Adam steps from the same flax weights, the loss to rtol 1e-5 and
every parameter flax made to atol 1e-5. The port makes every relation's
weights up front; flax makes those of the relations a batch holds, so
the port's others (``rev_writes``: no paper-seeded batch reaches an
author) are loaded with ``strict=False`` and must not move.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glt_tpu.loader import NeighborLoader as JaxNeighborLoader
from glt_tpu.loader.transform import HeteroBatch as JaxHeteroBatch
from glt_tpu.models.hgt import HGT as JaxHGT
from glt_tpu.models.hgt import HGTConv as JaxHGTConv
from glt_tpu_torch.examples import common
from glt_tpu_torch.examples.hetero import (hierarchical_sage, train_hgt_mag,
                                           train_rgnn)
from glt_tpu_torch.loader import HeteroBatch, NeighborLoader
from glt_tpu_torch.models import HGT, HGTConv, hgt_params_from_flax
from glt_tpu_torch.parallel import SageTrainStep, sage_loss
from glt_tpu_torch.typing import as_str, reverse_edge_type
from test_torch_hetero_sampling import _jax_hetero_uniforms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL = LOSS_RTOL = 1e-5
CITES = ('paper', 'cites', 'paper')
WRITES = ('author', 'writes', 'paper')
REV_WRITES = ('paper', 'rev_writes', 'author')


def _np_tree(params):
  return jax.tree.map(np.asarray, params)


def _edges(rng, n_src, n_dst, n):
  row = rng.integers(0, n_src, n).astype(np.int32)
  col = rng.integers(0, n_dst, n).astype(np.int32)
  mask = rng.random(n) < 0.8
  row[~mask] = -1    # padded lanes carry -1 children, as the sampler emits
  col[-3:] = -1
  mask[-3:] = False
  return row, col, mask


def _batch(rng, feat, author_rows=20, relations=(CITES, WRITES, REV_WRITES)):
  """A sampler-shaped paper-seeded batch: papers and authors, the given
  relations (edge keys in message-flow orientation), a few padded
  lanes; ``author_rows=1`` with ``relations=(CITES,)`` is the author-less
  batch a paper-seeded loader yields."""
  counts = {'paper': 40, 'author': author_rows}
  x = {t: rng.standard_normal((n, feat)).astype(np.float32)
       for t, n in counts.items()}
  edges = {e: _edges(rng, counts[e[0]], counts[e[2]], 60)
           for e in relations}
  return dict(
      x_dict=x, row_dict={e: v[0] for e, v in edges.items()},
      col_dict={e: v[1] for e, v in edges.items()},
      edge_mask_dict={e: v[2] for e, v in edges.items()},
      node_dict={t: np.arange(n, dtype=np.int32) for t, n in counts.items()},
      node_count_dict={t: np.int32(n) for t, n in counts.items()})


def _both(fields, batch_size=8):
  jb = JaxHeteroBatch(input_type='paper', batch_size=batch_size,
                      **{k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
                         for k, v in fields.items()})
  pb = HeteroBatch(input_type='paper', batch_size=batch_size,
                   **{k: {kk: torch.as_tensor(vv) for kk, vv in v.items()}
                      for k, v in fields.items()})
  return jb, pb


def _load(model, params):
  """flax weights into the port; every key flax has must land."""
  missing, unexpected = model.load_state_dict(
      hgt_params_from_flax(_np_tree(params)), strict=False)
  assert not unexpected, unexpected
  return set(missing)


@pytest.mark.parametrize('feat,out', [(16, 16), (12, 16)])
def test_hgt_conv_matches_flax(feat, out):
  """One layer over every relation; below ``out`` wide the skip takes
  ``res_<type>``."""
  rng = np.random.default_rng(1)
  fields = _batch(rng, feat)
  args = [fields[k] for k in ('x_dict', 'row_dict', 'col_dict',
                              'edge_mask_dict')]
  conv = JaxHGTConv(node_types=['paper', 'author'],
                    edge_types=[CITES, WRITES, REV_WRITES],
                    out_features=out, heads=2)
  jargs = [{k: jnp.asarray(v) for k, v in a.items()} for a in args]
  params = jax.jit(conv.init)(jax.random.key(0), *jargs)
  want = jax.jit(conv.apply)(params, *jargs)
  port = HGTConv(['paper', 'author'], [CITES, WRITES, REV_WRITES], feat, out,
                 heads=2)
  tree = _np_tree(params)['params']
  got_sd = {k[len('convs.0.'):]: v for k, v in
            hgt_params_from_flax({'hgt0': tree}).items()}
  assert set(got_sd) == set(port.state_dict())
  assert ('res_lins.paper.weight' in got_sd) == (feat != out)
  port.load_state_dict(got_sd)
  with torch.no_grad():
    got = port(*[{k: torch.as_tensor(v) for k, v in a.items()}
                 for a in args])
  assert set(got) == {'paper', 'author'}
  for t in got:
    assert got[t].shape == (fields['x_dict'][t].shape[0], out)
    np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]), **TOL,
                               err_msg=t)


@pytest.mark.parametrize('author_less', [False, True])
def test_hgt_matches_flax(author_less):
  """The stack; ``author_less``: one padded author row and no relation
  into or out of it but ``cites`` (a paper-seeded batch), finite."""
  rng = np.random.default_rng(2)
  fields = (_batch(rng, 10, author_rows=1, relations=(CITES,)) if author_less
            else _batch(rng, 10))
  jb, pb = _both(fields)
  mp = [CITES, REV_WRITES]
  jmodel = JaxHGT(node_types=['paper', 'author'], edge_types=mp,
                  hidden_features=16, out_features=5, num_layers=2, heads=2)
  params = jax.jit(jmodel.init)(jax.random.key(3), jb)
  want = jax.jit(jmodel.apply)(params, jb)
  model = HGT(['paper', 'author'], mp, 10, 16, 5, num_layers=2, heads=2)
  missing = _load(model, params)
  # flax made no weights for a relation the batch lacks
  unmade = {f'convs.{i}.{k}.{as_str(e)}' for i in range(2)
            for k in ('watt', 'wmsg', 'prior')
            for e in mp if e not in fields['row_dict']}
  assert missing == unmade
  with torch.no_grad():
    got = model(pb)
  assert got.shape == (8, 5) and bool(torch.isfinite(got).all())
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the example's step ------------------------------------------------------

def _jax_common():
  from examples.common import synthetic_hetero_mag
  return synthetic_hetero_mag


def test_synthetic_hetero_mag_matches_the_jax_examples():
  kw = dict(num_papers=300, num_authors=150, feat_dim=12, num_classes=5)
  jds, jc, jcites, jwrites = _jax_common()(**kw)
  ds, c, cites, writes = common.synthetic_hetero_mag(device='cpu', **kw)
  assert (c, cites, writes) == (jc, jcites, jwrites)
  for e in (cites, writes):
    for f in ('indptr', 'indices'):
      np.testing.assert_array_equal(
          getattr(ds.get_graph(e), f).numpy(),
          np.asarray(getattr(jds.get_graph(e), f)), err_msg=f'{e} {f}')
  for t in ('paper', 'author'):
    np.testing.assert_array_equal(
        ds.get_node_feature(t).table.numpy(),
        jds.get_node_feature(t)[np.arange(jds.node_count(t))])
  np.testing.assert_array_equal(ds.get_node_label('paper'),
                                np.asarray(jds.get_node_label('paper')))
  # ogbn-mag's counts at full scale
  assert common.MAG_COUNTS['num_cites'] == 5_416_271
  assert common.MAG_COUNTS['num_writes'] == 7_145_660


def test_hgt_train_steps_match_the_jax_example(monkeypatch):
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  kw = dict(num_papers=300, num_authors=150, feat_dim=12, num_classes=5)
  jds, classes, cites, writes = _jax_common()(**kw)
  ds, _, _, _ = common.synthetic_hetero_mag(device='cpu', **kw)
  fanouts = {cites: train_hgt_mag.FANOUTS, writes: train_hgt_mag.FANOUTS}
  seeds = np.arange(200)
  jl = JaxNeighborLoader(jds, fanouts, input_nodes=('paper', seeds),
                         batch_size=32, shuffle=True, seed=0)
  js = jl.sampler
  keys, next_key = [], js._next_key

  def record_key():
    keys.append(next_key())
    return keys[-1]
  js._next_key = record_key
  pl = NeighborLoader(ds, fanouts, ('paper', seeds), batch_size=32,
                      shuffle=True, seed=0, device='cpu')
  pl.sampler.hop_uniforms = lambda b, t: _jax_hetero_uniforms(
      keys[-1], js, {t: b})
  mp = [reverse_edge_type(cites), reverse_edge_type(writes)]
  jmodel = JaxHGT(node_types=['paper', 'author'], edge_types=mp,
                  hidden_features=16, out_features=classes, num_layers=2,
                  heads=2)
  model = train_hgt_mag.make_model(ds, classes, cites, writes, hidden=16,
                                   heads=2)
  tx = optax.adam(train_hgt_mag.LR)

  @jax.jit
  def jstep(params, opt, batch):     # the JAX example's step
    def loss_fn(p):
      logits = jmodel.apply(p, batch)
      mask = jnp.arange(logits.shape[0]) < batch.metadata['n_valid']
      l = optax.softmax_cross_entropy_with_integer_labels(
          logits, batch.y_dict['paper'])
      return jnp.where(mask, l, 0).sum() / jnp.maximum(mask.sum(), 1)
    loss, g = jax.value_and_grad(loss_fn)(params)
    up, opt = tx.update(g, opt)
    return optax.apply_updates(params, up), opt, loss, g

  step = SageTrainStep(model, lr=train_hgt_mag.LR)
  params = opt = None
  for i, (jb, pb) in enumerate(zip(jl, pl)):
    if i == 3:
      break
    # no paper-seeded batch reaches an author: one padded row, no
    # rev_writes, as the JAX sampler emits them
    assert set(pb.row_dict) == set(jb.row_dict) == {cites}
    assert pb.x_dict['author'].shape[0] == 1
    assert int(pb.node_count_dict['author']) == 0
    for t in ('paper', 'author'):
      np.testing.assert_array_equal(pb.x_dict[t].numpy(),
                                    np.asarray(jb.x_dict[t]))
    if params is None:
      params = jax.jit(jmodel.init)(jax.random.key(0), jb)
      opt = tx.init(params)
      _load(model, params)
      untouched = {k: v.clone() for k, v in model.state_dict().items()
                   if 'rev_writes' in k}
      assert untouched
    with torch.no_grad():
      before = float(sage_loss(model, pb))
    meta = dict(jb.metadata, n_valid=jnp.asarray(jb.metadata['n_valid']))
    params, opt, jloss, jgrad = jstep(params, opt,
                                      jb.replace(metadata=meta))
    loss = step(pb)
    assert float(loss) == before and np.isfinite(before)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    want = hgt_params_from_flax(_np_tree(params))
    grads = hgt_params_from_flax(_np_tree(jgrad))
    got = model.state_dict()
    port_grads = dict(model.named_parameters())
    assert set(want) <= set(got)
    for k in want:
      if '.k_lins.' in k and k.endswith('.bias'):
        # a key bias shifts every logit into a destination by the same
        # amount, which its normalisation cancels: its gradient is 0 up
        # to float noise in both frameworks, and Adam turns that noise
        # into moves of up to lr, so its value is not compared
        g = port_grads[k].grad
        for noise in (grads[k].numpy(), np.zeros(1) if g is None
                      else g.numpy()):
          assert np.abs(noise).max() < 1e-6, (k, np.abs(noise).max())
        continue
      np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                 atol=PARAM_ATOL, err_msg=f'step {i} {k}')
    for k, v in untouched.items():
      assert torch.equal(got[k], v), k


# -- the examples on the CPU --------------------------------------------------

def _losses(capsys):
  return [float(ln.split('loss=')[1].split()[0])
          for ln in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize('example,argv', [
    (train_hgt_mag, []), (train_rgnn, ['--conv', 'rgat']),
    (train_rgnn, ['--conv', 'rsage']),
    (hierarchical_sage, ['--papers', '800'])])
def test_hetero_examples_train_on_the_cpu(example, argv, capsys):
  loss = example.main(argv + ['--device', 'cpu', '--epochs', '2',
                              '--max-steps', '4'])
  losses = _losses(capsys)
  assert len(losses) == 2 and losses[-1] == round(loss, 4), losses
  assert all(np.isfinite(losses)) and 0 < loss < 5, losses


def test_rgnn_example_model_is_the_flax_models_parameter_set(monkeypatch):
  """The port's RGNN over a paper-seeded batch's relations has the
  parameters the flax RGNN makes on the same batch (``conv_cites``, a
  ``self_author`` layer a layer), so its weights load strictly."""
  from glt_tpu.models.rgnn import RGNN as JaxRGNN
  from glt_tpu_torch.models import rgnn_params_from_flax
  kw = dict(num_papers=200, num_authors=100, feat_dim=8, num_classes=4)
  jds, classes, cites, writes = _jax_common()(**kw)
  ds, _, _, _ = common.synthetic_hetero_mag(device='cpu', **kw)
  fanouts = {cites: [5, 5], writes: [5, 5]}
  jb = next(iter(JaxNeighborLoader(jds, fanouts, ('paper', np.arange(64)),
                                   batch_size=32, seed=0)))
  pb = next(iter(NeighborLoader(ds, fanouts, ('paper', np.arange(64)),
                                batch_size=32, seed=0, device='cpu')))
  jmodel = JaxRGNN(edge_types=[reverse_edge_type(cites),
                               reverse_edge_type(writes)],
                   hidden_features=16, out_features=classes, num_layers=2,
                   conv='rsage')
  params = jax.jit(jmodel.init)(jax.random.key(0), jb)
  model = train_rgnn.batch_model(pb, 8, 16, classes, 'cpu', conv='rsage')
  model.load_state_dict(rgnn_params_from_flax(_np_tree(params)))
  with torch.no_grad():
    assert model(pb).shape == (32, classes)
