"""GraphSAGE training in the port (``NeighborLoader`` -> sampler ->
feature gather -> GraphSAGE -> masked cross-entropy -> Adam, through
``glt_tpu_torch.parallel.SageTrainStep``) against the JAX package on the
same numpy data, with the JAX draws injected.

The loaders' batches must match bit for bit over two shuffled epochs
with a padded ragged tail, weighted (the JAX sampler on its TPU path:
window reads through the interpret-mode Pallas ``gather_windows``, the
sort inducer with fused hops) and uniform (the port's walk against the
JAX sort+fused reference). Three training steps from the same flax
parameters against ``_sage_update`` (``value_and_grad`` +
``optax.adam(1e-3)``): the loss to rtol 1e-5 and every parameter to
atol 1e-5 after each step -- float32 sums in another order (XLA's
segment sums against ``index_add_``, the two Adam formulas) on a
bit-identical batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.loader import NeighborLoader as JaxNeighborLoader
from glt_tpu.models.sage import GraphSAGE as JaxGraphSAGE
from glt_tpu.parallel.train import _sage_update
from glt_tpu.typing import Split as JaxSplit
from glt_tpu.utils.profile import ThroughputMeter as JaxThroughputMeter
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.models import GraphSAGE, sage_params_from_flax
from glt_tpu_torch.parallel import SageTrainStep, sage_loss
from glt_tpu_torch.typing import Split
from glt_tpu_torch.utils.profile import ThroughputMeter
from test_torch_weighted_sampling import hop_uniforms_from_key, to_tpu_path

N, E, F, C, B, FANOUTS = 300, 3000, 12, 5, 64, [3, 2]
HIDDEN = 16
LOSS_RTOL = PARAM_ATOL = 1e-5
BATCH_KEYS = ('node', 'node_count', 'row', 'col', 'edge_mask', 'x', 'y',
              'num_sampled_nodes', 'num_sampled_edges')


def _data():
  """A products-like toy: learnable labels ``argmax(x @ w)`` as
  examples/common.py builds them, weights in (0, 1], the 0.1/0.1 split."""
  rng = np.random.default_rng(0)
  ei = np.stack([rng.integers(0, N, E),
                 (rng.random(E) ** 2 * N).astype(np.int64)])
  w = (1.0 - rng.random(E)).astype(np.float32)
  x = rng.standard_normal((N, F)).astype(np.float32)
  y = np.argmax(x @ rng.standard_normal((F, C)).astype(np.float32),
                1).astype(np.int32)
  jds = JaxDataset(edge_dir='out')
  jds.init_graph(edge_index=ei, edge_weights=w, num_nodes=N)
  jds.init_node_features(x)
  jds.init_node_labels(y)
  jds.random_node_split(num_val=0.1, num_test=0.1)
  ds = Dataset().init_graph(ei, edge_weights=w, num_nodes=N, device='cpu')
  ds.init_node_features(x, device='cpu')
  ds.init_node_labels(y)
  ds.random_node_split(num_val=0.1, num_test=0.1)
  return jds, ds


def _loaders(jds, ds, with_weight, monkeypatch):
  """The JAX loader on its TPU-path settings and the port's, whose
  sampler draws what the JAX sampler's key for the same batch draws."""
  jl = JaxNeighborLoader(jds, FANOUTS, input_nodes=jds.get_split(
      JaxSplit.train), batch_size=B, shuffle=True, with_weight=with_weight,
                         seed=0)
  js = jl.sampler
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  if with_weight:
    to_tpu_path(js, monkeypatch)
  keys, next_key = [], js._next_key

  def record_key():
    keys.append(next_key())
    return keys[-1]
  js._next_key = record_key
  pl = NeighborLoader(ds, FANOUTS, ds.get_split(Split.train), batch_size=B,
                      shuffle=True, with_weight=with_weight, seed=0,
                      device='cpu')
  ps = pl.sampler
  # zip pulls the JAX batch first, so its key is the last recorded
  ps.hop_uniforms = lambda b: hop_uniforms_from_key(keys[-1], b, ps)
  return jl, pl


def test_splits_match_jax():
  jds, ds = _data()
  for split, jsplit in ((Split.train, JaxSplit.train),
                        (Split.valid, JaxSplit.valid),
                        (Split.test, JaxSplit.test)):
    np.testing.assert_array_equal(ds.get_split(split),
                                  jds.get_split(jsplit))
  assert len(ds.get_split('train')) == N - 2 * int(0.1 * N)


@pytest.mark.parametrize('with_weight', [True, False])
def test_neighbor_loader_batches_match_jax(with_weight, monkeypatch):
  jds, ds = _data()
  jl, pl = _loaders(jds, ds, with_weight, monkeypatch)
  assert len(pl) == len(jl) == 4          # 240 seeds: 3 full + 48
  assert pl.sampler._per_hop == with_weight
  n_valid = []
  for _ in range(2):
    for jb, pb in zip(jl, pl):
      for f in BATCH_KEYS:
        np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
      assert pb.metadata['n_valid'] == jb.metadata['n_valid']
      assert pb.batch_size == jb.batch_size == B
      assert pb.edge_hop_offsets == jb.edge_hop_offsets
      n_valid.append(pb.metadata['n_valid'])
  assert n_valid == [B, B, B, 48] * 2
  if with_weight:
    assert len(jl.sampler.window_reads) == len(FANOUTS)


def test_train_steps_match_sage_update(monkeypatch):
  jds, ds = _data()
  jl, pl = _loaders(jds, ds, True, monkeypatch)
  jmodel = JaxGraphSAGE(hidden_features=HIDDEN, out_features=C,
                        num_layers=len(FANOUTS))
  tx = optax.adam(1e-3)

  @jax.jit
  def jstep(params, opt, batch, n_valid):
    # _sage_update pmeans over its axis: one member here
    f = lambda _: _sage_update(jmodel, tx, 'd', B, params, opt, batch,
                               n_valid)
    return jax.tree.map(lambda a: a[0],
                        jax.vmap(f, axis_name='d')(jnp.zeros(1)))

  model = GraphSAGE(F, HIDDEN, C, num_layers=len(FANOUTS))
  step = SageTrainStep(model)
  params = opt = None
  for i, (jb, pb) in enumerate(zip(jl, pl)):
    if i == 3:
      break
    if params is None:
      params = jax.jit(jmodel.init)(jax.random.key(0), jb)
      opt = tx.init(params)
      model.load_state_dict(sage_params_from_flax(
          jax.tree.map(np.asarray, params)))
    with torch.no_grad():
      before = float(sage_loss(model, pb))
    nv = jb.metadata['n_valid']
    params, opt, jloss = jstep(params, opt, jb.replace(metadata=None),
                               jnp.asarray(nv))
    loss = step(pb)
    assert float(loss) == before
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    want = sage_params_from_flax(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
      np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                 atol=PARAM_ATOL, err_msg=f'step {i} {k}')


def test_loss_masks_padded_seeds():
  _, ds = _data()
  pl = NeighborLoader(ds, FANOUTS, ds.get_split(Split.train), batch_size=B,
                      device='cpu', seed=0)
  tail = list(pl)[-1]
  model = GraphSAGE(F, HIDDEN, C, num_layers=len(FANOUTS))
  with torch.no_grad():
    logits = model(tail)
    want = torch.nn.functional.cross_entropy(logits[:48], tail.y[:48].long())
    np.testing.assert_allclose(float(sage_loss(model, tail)), float(want),
                               rtol=1e-6)


def test_throughput_meter_matches_jax():
  for count, secs in ((5, 2.0), (12_345, 1.5), (62_000_000, 0.25), (0, 0)):
    a, b = ThroughputMeter('edges'), JaxThroughputMeter('edges')
    for m in (a, b):
      m.update(count, secs)
      m.update(count, secs)
    assert a.rate == b.rate and a.report() == b.report()
