"""The port's GATConv and RGNN (rgat and rsage) against the flax models,
with the flax weights carried over by ``rgnn_params_from_flax``, float32
on the CPU.

Tolerance rtol = atol = 1e-5: the two frameworks sum the attention
denominators, the messages and the matmul products in different orders.

The flax models are initialised and applied under ``jax.jit``: one
compile each, where eager flax compiles every op on first use (most of
this file's time).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.loader.transform import HeteroBatch as JaxHeteroBatch
from glt_tpu.models.conv import GATConv as JaxGATConv
from glt_tpu.models.rgnn import RGNN as JaxRGNN
from glt_tpu_torch.loader import HeteroBatch
from glt_tpu_torch.models import (RGNN, GATConv, gat_conv_params_from_flax,
                                  rgnn_params_from_flax)
from test_torch_models import check_train_dropout

TOL = dict(rtol=1e-5, atol=1e-5)
U2I = ('user', 'u2i', 'item')
I2U = ('item', 'rev_u2i', 'user')
I2I = ('item', 'i2i', 'item')


def _np_tree(params):
  return jax.tree.map(np.asarray, params)


def _padded_edges(rng, n_src, n_dst, n_edges):
  row = rng.integers(0, n_src, n_edges).astype(np.int32)
  col = rng.integers(0, n_dst, n_edges).astype(np.int32)
  mask = rng.random(n_edges) < 0.8
  row[~mask] = -1  # padded lanes carry -1 children, as the sampler emits
  col[-3:] = -1
  mask[-3:] = False
  return row, col, mask


@pytest.mark.parametrize('heads', [1, 3])
def test_gat_conv_matches_flax(heads):
  """The port's GATConv averages its heads: the flax ``concat=False``."""
  rng = np.random.default_rng(1)
  x = rng.standard_normal((40, 16)).astype(np.float32)
  row, col, mask = _padded_edges(rng, 40, 40, 150)
  col[:5] = 7   # a parent with many children; others with none
  conv = JaxGATConv(6, heads=heads, concat=False)
  args = tuple(jnp.asarray(a) for a in (x, row, col, mask))
  params = jax.jit(conv.init)(jax.random.key(0), *args)
  want = jax.jit(conv.apply)(params, *args)
  port = GATConv(16, 6, heads=heads, concat=False)
  port.load_state_dict(gat_conv_params_from_flax(_np_tree(params)['params']))
  with torch.no_grad():
    got = port(*(torch.as_tensor(a) for a in (x, row, col, mask)))
  assert got.shape == (40, 6)
  np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)


@pytest.mark.parametrize('concat', [True, False])
def test_gat_conv_concat_and_slope_match_flax(concat):
  """Two heads side by side or averaged, a leaky slope of 0.01."""
  rng = np.random.default_rng(3)
  x = rng.standard_normal((40, 16)).astype(np.float32)
  row, col, mask = _padded_edges(rng, 40, 40, 150)
  col[:5] = 7
  conv = JaxGATConv(6, heads=2, concat=concat, negative_slope=0.01)
  args = tuple(jnp.asarray(a) for a in (x, row, col, mask))
  params = jax.jit(conv.init)(jax.random.key(2), *args)
  want = jax.jit(conv.apply)(params, *args)
  port = GATConv(16, 6, heads=2, concat=concat, negative_slope=0.01)
  port.load_state_dict(gat_conv_params_from_flax(_np_tree(params)['params']))
  with torch.no_grad():
    got = port(*(torch.as_tensor(a) for a in (x, row, col, mask)))
  assert got.shape == ((40, 12) if concat else (40, 6))
  np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)


def _hetero_batch(rng, feat=12):
  """A sampler-shaped batch: 4 user seeds, two hops of hop-ordered edges
  per key, and a 'tag' type that no relation reaches (self layer)."""
  counts = {'user': 30, 'item': 50, 'tag': 5}
  x = {t: rng.standard_normal((n, feat)).astype(np.float32)
       for t, n in counts.items()}
  offs = {I2U: (0, 12, 20), I2I: (0, 0, 36), U2I: (0, 10, 18)}
  ends = {e: o[-1] for e, o in offs.items()}
  edges = {e: _padded_edges(rng, counts[e[0]], counts[e[2]], ends[e])
           for e in offs}
  fields = dict(
      x_dict=x, row_dict={e: v[0] for e, v in edges.items()},
      col_dict={e: v[1] for e, v in edges.items()},
      edge_mask_dict={e: v[2] for e, v in edges.items()},
      node_dict={t: np.arange(n, dtype=np.int32) for t, n in counts.items()},
      node_count_dict={t: np.int32(n) for t, n in counts.items()})
  return fields, offs


@pytest.mark.parametrize('conv', ['rgat', 'rsage'])
def test_rgnn_matches_flax(conv):
  rng = np.random.default_rng(2)
  fields, offs = _hetero_batch(rng)
  etypes = [I2U, I2I, U2I]
  for trim in (True, False):
    jmodel = JaxRGNN(edge_types=etypes, hidden_features=16, out_features=7,
                     num_layers=2, conv=conv, heads=2, trim=trim)
    jb = JaxHeteroBatch(
        input_type='user', batch_size=4, edge_hop_offsets_dict=offs,
        **{k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
           for k, v in fields.items()})
    params = jax.jit(jmodel.init)(jax.random.key(3), jb)
    want, want_all = jax.jit(lambda p, b: (
        jmodel.apply(p, b), jmodel.apply(p, b, return_all=True)))(params, jb)
    port = RGNN(etypes, 12, 16, 7, num_layers=2, conv=conv, heads=2,
                trim=trim, node_types=['user', 'item', 'tag'])
    port.load_state_dict(rgnn_params_from_flax(_np_tree(params)))
    pb = HeteroBatch(
        input_type='user', batch_size=4, edge_hop_offsets_dict=offs,
        **{k: {kk: torch.as_tensor(vv) for kk, vv in v.items()}
           for k, v in fields.items()})
    with torch.no_grad():
      got = port(pb)
      every = port(pb, return_all=True)
    assert got.shape == (4, 7) and set(every) == {'user', 'item', 'tag'}
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL,
                               err_msg=f'trim={trim}')
    for t, v in want_all.items():
      np.testing.assert_allclose(np.asarray(v), every[t].numpy(), **TOL,
                                 err_msg=f'{t} trim={trim}')


def test_rgnn_needs_a_self_layer_for_an_unreached_type():
  rng = np.random.default_rng(4)
  fields, offs = _hetero_batch(rng)
  model = RGNN([I2U, I2I, U2I], 12, 16, 7, conv='rgat', heads=2)
  pb = HeteroBatch(input_type='user', batch_size=4,
                   edge_hop_offsets_dict=offs,
                   **{k: {kk: torch.as_tensor(vv) for kk, vv in v.items()}
                      for k, v in fields.items()})
  with pytest.raises(ValueError, match="'tag'"):
    model(pb)


def _batches(fields, offs):
  jb = JaxHeteroBatch(
      input_type='user', batch_size=4, edge_hop_offsets_dict=offs,
      **{k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
         for k, v in fields.items()})
  pb = HeteroBatch(
      input_type='user', batch_size=4, edge_hop_offsets_dict=offs,
      **{k: {kk: torch.as_tensor(vv) for kk, vv in v.items()}
         for k, v in fields.items()})
  return jb, pb


def test_rgnn_dropout_eval_matches_flax_deterministic():
  # eval() is flax's train=False: dropout at p = 0.5 passes values through
  fields, offs = _hetero_batch(np.random.default_rng(5))
  etypes = [I2U, I2I, U2I]
  jb, pb = _batches(fields, offs)
  jmodel = JaxRGNN(edge_types=etypes, hidden_features=16, out_features=7,
                   num_layers=2, conv='rsage', dropout=0.5)
  params = jax.jit(jmodel.init)(jax.random.key(6), jb)
  want = jax.jit(jmodel.apply)(params, jb)
  port = RGNN(etypes, 12, 16, 7, num_layers=2, conv='rsage', dropout=0.5,
              node_types=['user', 'item', 'tag']).eval()
  port.load_state_dict(rgnn_params_from_flax(_np_tree(params)))
  with torch.no_grad():
    got = port(pb)
  np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)


def test_rgnn_dropout_trains_at_its_rate():
  fields, offs = _hetero_batch(np.random.default_rng(7))
  _, pb = _batches(fields, offs)
  torch.manual_seed(2)
  model = RGNN([I2U, I2I, U2I], 12, 256, 7, num_layers=2, conv='rsage',
               dropout=0.5, node_types=['user', 'item', 'tag'])
  check_train_dropout(model, lambda: model(pb), 0.5)
