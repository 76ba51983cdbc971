"""The port's SAGEConv / GraphSAGE against the flax models with converted
parameters, float32 on the CPU.

Tolerance rtol = atol = 1e-5: the two frameworks sum the neighbour
messages and the matmul products in different orders. The segment
aggregations alone hold to 1e-6 (a sum of at most a few float32 terms;
the max is exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.loader.transform import Batch as JaxBatch
from glt_tpu.models.conv import SAGEConv as JaxSAGEConv
from glt_tpu.models.sage import GraphSAGE as JaxGraphSAGE
from glt_tpu_torch.loader import Batch
from glt_tpu_torch.models import (GraphSAGE, SAGEConv, segment_max_masked,
                                  segment_mean, segment_sum_masked,
                                  sage_conv_params_from_flax,
                                  sage_params_from_flax)

TOL = dict(rtol=1e-5, atol=1e-5)
AGGR_TOL = dict(rtol=1e-6, atol=1e-6)


def _padded_edges(rng, n_nodes, n_edges):
  row = rng.integers(0, n_nodes, n_edges).astype(np.int32)
  col = rng.integers(0, n_nodes, n_edges).astype(np.int32)
  mask = rng.random(n_edges) < 0.8
  row[~mask] = -1  # padded lanes carry -1 children, as the sampler emits
  return row, col, mask


def _np_tree(params):
  return jax.tree.map(np.asarray, params)


def test_segment_mean_matches_jax():
  from glt_tpu.models.conv import segment_mean as jax_segment_mean
  rng = np.random.default_rng(0)
  msgs = rng.standard_normal((50, 6)).astype(np.float32)
  tgt = rng.integers(0, 9, 50).astype(np.int32)
  mask = rng.random(50) < 0.7
  want = jax_segment_mean(jnp.asarray(msgs), jnp.asarray(tgt),
                          jnp.asarray(mask), 9)
  got = segment_mean(torch.as_tensor(msgs), torch.as_tensor(tgt),
                     torch.as_tensor(mask), 9)
  np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)


def test_sage_conv_matches_flax():
  rng = np.random.default_rng(1)
  x = rng.standard_normal((40, 16)).astype(np.float32)
  row, col, mask = _padded_edges(rng, 40, 120)
  conv = JaxSAGEConv(24)
  args = tuple(jnp.asarray(a) for a in (x, row, col, mask))
  params = conv.init(jax.random.key(0), *args)
  want = conv.apply(params, *args)
  port = SAGEConv(16, 24)
  port.load_state_dict(sage_conv_params_from_flax(
      _np_tree(params)['params']))
  with torch.no_grad():
    got = port(*(torch.as_tensor(a) for a in (x, row, col, mask)))
  np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)


def test_graphsage_matches_flax_with_trimming():
  # a sampler-shaped batch: batch 4, fanouts (3, 2), hop-ordered edges
  rng = np.random.default_rng(2)
  b, fanouts = 4, (3, 2)
  offsets = [0, 12, 36]
  n_nodes = 4 + 12 + 24
  x = rng.standard_normal((n_nodes, 10)).astype(np.float32)
  row, col, mask = _padded_edges(rng, n_nodes, offsets[-1])
  fields = dict(row=row, col=col, edge_mask=mask,
                node=np.arange(n_nodes, dtype=np.int32),
                node_count=np.int32(n_nodes))
  for trim in (True, False):
    model = JaxGraphSAGE(hidden_features=32, out_features=7, num_layers=3,
                         trim=trim)
    jb = JaxBatch(x=jnp.asarray(x), batch_size=b,
                  edge_hop_offsets=tuple(offsets),
                  **{k: jnp.asarray(v) for k, v in fields.items()})
    params = model.init(jax.random.key(3), jb)
    want = model.apply(params, jb)
    port = GraphSAGE(10, 32, 7, num_layers=3, trim=trim)
    port.load_state_dict(sage_params_from_flax(_np_tree(params)))
    pb = Batch(x=torch.as_tensor(x), batch_size=b,
               edge_hop_offsets=tuple(offsets),
               **{k: torch.as_tensor(v) for k, v in fields.items()})
    with torch.no_grad():
      got = port(pb)
    assert got.shape == (b, 7)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL,
                               err_msg=f'trim={trim}')


@pytest.mark.parametrize('aggr', ['sum', 'max'])
def test_segment_aggregation_matches_jax(aggr):
  # segments 9-11 get no slot and segment 8 only masked ones: both read 0
  from glt_tpu.models import conv as jax_conv
  rng = np.random.default_rng(5)
  msgs = rng.standard_normal((60, 6)).astype(np.float32)
  tgt = rng.integers(0, 9, 60).astype(np.int32)
  mask = rng.random(60) < 0.7
  mask[tgt == 8] = False
  fn = {'sum': segment_sum_masked, 'max': segment_max_masked}[aggr]
  want = getattr(jax_conv, fn.__name__)(jnp.asarray(msgs), jnp.asarray(tgt),
                                        jnp.asarray(mask), 12)
  got = fn(torch.as_tensor(msgs), torch.as_tensor(tgt),
           torch.as_tensor(mask), 12)
  assert got.shape == (12, 6) and not got[8:].any()
  np.testing.assert_allclose(np.asarray(want), got.numpy(), **AGGR_TOL)


@pytest.mark.parametrize('aggr', ['sum', 'max'])
def test_sage_conv_aggr_matches_flax(aggr):
  # masked lanes, and parents 30-39 with no child at all
  rng = np.random.default_rng(6)
  x = rng.standard_normal((40, 16)).astype(np.float32)
  row, col, mask = _padded_edges(rng, 40, 120)
  col %= 30
  conv = JaxSAGEConv(24, aggr=aggr)
  args = tuple(jnp.asarray(a) for a in (x, row, col, mask))
  params = jax.jit(conv.init)(jax.random.key(0), *args)
  want = jax.jit(conv.apply)(params, *args)
  port = SAGEConv(16, 24, aggr=aggr)
  port.load_state_dict(sage_conv_params_from_flax(
      _np_tree(params)['params']))
  with torch.no_grad():
    got = port(*(torch.as_tensor(a) for a in (x, row, col, mask)))
  np.testing.assert_allclose(np.asarray(want), got.numpy(), **AGGR_TOL)


def _sampled_batches(x, b=4, offsets=(0, 12, 36), seed=2):
  """One sampler-shaped batch (batch ``b``, hop-ordered edges) for both
  packages: (flax Batch, port Batch)."""
  rng = np.random.default_rng(seed)
  n_nodes = x.shape[0]
  row, col, mask = _padded_edges(rng, n_nodes, offsets[-1])
  fields = dict(row=row, col=col, edge_mask=mask,
                node=np.arange(n_nodes, dtype=np.int32),
                node_count=np.int32(n_nodes))
  jb = JaxBatch(x=jnp.asarray(x), batch_size=b,
                edge_hop_offsets=tuple(offsets),
                **{k: jnp.asarray(v) for k, v in fields.items()})
  pb = Batch(x=torch.as_tensor(x), batch_size=b,
             edge_hop_offsets=tuple(offsets),
             **{k: torch.as_tensor(v) for k, v in fields.items()})
  return jb, pb


@pytest.mark.parametrize('trim', [True, False])
@pytest.mark.parametrize('conv', ['gcn', 'gat'])
def test_graphsage_convs_match_flax(conv, trim):
  x = np.random.default_rng(7).standard_normal((40, 10)).astype(np.float32)
  jb, pb = _sampled_batches(x)
  model = JaxGraphSAGE(hidden_features=32, out_features=7, num_layers=3,
                       conv=conv, trim=trim)
  params = jax.jit(model.init)(jax.random.key(3), jb)
  want = jax.jit(model.apply)(params, jb)
  port = GraphSAGE(10, 32, 7, num_layers=3, conv=conv, trim=trim)
  port.load_state_dict(sage_params_from_flax(_np_tree(params)))
  with torch.no_grad():
    got = port(pb)
  assert got.shape == (4, 7)
  np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)


def test_graphsage_dropout_eval_matches_flax_deterministic():
  # eval() is flax's train=False: dropout at p = 0.5 passes values through
  x = np.random.default_rng(8).standard_normal((40, 10)).astype(np.float32)
  jb, pb = _sampled_batches(x)
  model = JaxGraphSAGE(hidden_features=32, out_features=7, num_layers=3,
                       dropout=0.5)
  params = jax.jit(model.init)(jax.random.key(4), jb)
  want = jax.jit(model.apply)(params, jb)       # train=False
  port = GraphSAGE(10, 32, 7, num_layers=3, dropout=0.5).eval()
  port.load_state_dict(sage_params_from_flax(_np_tree(params)))
  with torch.no_grad():
    got = port(pb)
  np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)


def dropout_io(model, run):
  """(input, output) of ``model.dropout``'s first call inside ``run()``:
  the first hidden layer's activations before and after dropout."""
  seen = []
  hook = model.dropout.register_forward_hook(
      lambda m, i, o: seen.append((i[0].detach().clone(),
                                   o.detach().clone())))
  try:
    with torch.no_grad():
      run()
  finally:
    hook.remove()
  return seen[0]


def check_train_dropout(model, run, p):
  """Under train() the first hidden layer's dropout zeroes a share p
  (within 0.05) of its nonzero activations, and each value kept is the
  eval-mode activation over (1 - p), within 1e-6."""
  model.eval()
  before, after = dropout_io(model, run)
  assert torch.equal(before, after)
  model.train()
  torch.manual_seed(0)
  inp, out = dropout_io(model, run)
  assert torch.equal(inp, before)      # nothing drops before the layer
  live = before != 0                    # ReLU's zeros stay zero
  assert int(live.sum()) >= 2000
  zero_share = float((out[live] == 0).float().mean())
  assert abs(zero_share - p) <= 0.05, zero_share
  kept = out != 0
  torch.testing.assert_close(out[kept], before[kept] / (1 - p), rtol=1e-6,
                             atol=1e-6)


def test_graphsage_dropout_trains_at_its_rate():
  x = np.random.default_rng(9).standard_normal((80, 10)).astype(np.float32)
  _, pb = _sampled_batches(x, offsets=(0, 20, 60))
  torch.manual_seed(1)
  model = GraphSAGE(10, 64, 7, num_layers=3, dropout=0.5)
  check_train_dropout(model, lambda: model(pb, return_all=True), 0.5)
