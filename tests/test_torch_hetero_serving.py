"""The port's hetero InferenceEngine (sample every edge type -> gather per
node type -> RGNN -> cache) against the JAX hetero engine on its
per-edge-type sorted reference (``GLT_DEDUP=sort GLT_FUSED_HOP=1``),
with the JAX sampler's uniforms injected into the port's sampler and the
flax weights converted.

Everything upstream of the forward is bit-identical; logits match to
rtol = atol = 1e-5 (sums in another order).
"""
import jax
import numpy as np
import pytest
import torch

from glt_tpu.models.rgnn import RGNN as JaxRGNN
from glt_tpu.serving import InferenceEngine as JaxEngine
from glt_tpu.utils.rng import make_key
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.models import RGNN, rgnn_params_from_flax
from glt_tpu_torch.serving import InferenceEngine

from test_torch_hetero_sampling import _jax_hetero_uniforms, _port_dataset

U2I = ('user', 'u2i', 'item')
I2I = ('item', 'i2i', 'item')
# message-flow keys of the sampled batch (edge_dir='out' reverses them)
ETYPES = [('item', 'rev_u2i', 'user'), I2I]
FANOUTS, BUCKET, SEED, FEAT = [2, 2], 8, 0, 8


def _engines(monkeypatch, conv):
  from fixtures import hetero_ring_dataset
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  jds = hetero_ring_dataset(num_users=10, num_items=20, feat_dim=FEAT)
  rng = np.random.default_rng(0)
  feats = {t: rng.standard_normal((n, FEAT)).astype(np.float32)
           for t, n in (('user', 10), ('item', 20))}
  jds.init_node_features(feats)
  jmodel = JaxRGNN(edge_types=ETYPES, hidden_features=16, out_features=5,
                   num_layers=2, conv=conv, heads=2)
  jeng = JaxEngine(jds, jmodel, None, FANOUTS, buckets=(BUCKET,), seed=SEED,
                   input_type='user')
  params = jeng.init_params(jax.random.key(1))   # the sampler's step 1

  ds = _port_dataset(jds)
  ds.init_node_features(feats, device='cpu')
  eng = InferenceEngine(ds, RGNN(ETYPES, FEAT, 16, 5, num_layers=2,
                                 conv=conv, heads=2),
                        rgnn_params_from_flax(jax.tree.map(np.asarray,
                                                           params)),
                        FANOUTS, buckets=(BUCKET,), seed=SEED, device='cpu',
                        input_type='user')
  steps = iter(range(2, 100))
  monkeypatch.setattr(eng.sampler, 'hop_uniforms', lambda b, t: (
      _jax_hetero_uniforms(jax.random.fold_in(make_key(SEED), next(steps)),
                           jeng.sampler, {t: b})))
  return jeng, eng


@pytest.mark.parametrize('conv', ['rgat', 'rsage'])
def test_hetero_infer_matches_jax_engine(monkeypatch, conv):
  jeng, eng = _engines(monkeypatch, conv)
  # one bucket, batch by batch (the sampler's step 2)
  seeds = np.array([3, 0, 3, 7, 9, 1, 3, 3])
  jb = jeng.make_batch(seeds, 6, BUCKET)
  pb = eng.make_batch(seeds, 6, BUCKET)
  assert pb.batch_size == jb.batch_size == BUCKET
  assert pb.edge_hop_offsets_dict == jb.edge_hop_offsets_dict
  for f in ('x_dict', 'node_dict', 'node_count_dict', 'row_dict',
            'col_dict', 'edge_mask_dict'):
    want, got = getattr(jb, f), getattr(pb, f)
    assert set(want) == set(got), f
    for k, v in want.items():
      np.testing.assert_array_equal(np.asarray(v), got[k].numpy(),
                                    err_msg=f'{f}[{k}]')
  with torch.no_grad():
    # jitted: eager flax compiles every op on first use
    want = jax.jit(jeng.model.apply)(jeng.params, jb)
    np.testing.assert_allclose(np.asarray(want), eng.model(pb).numpy(),
                               rtol=1e-5, atol=1e-5)

  # infer: the second request's cached ids (0, 9, 2) skip the pipeline, the
  # third is served from the cache alone
  got = {}
  for ids in ([5, 0, 5, 9, 2, 2], [0, 9, 4, 2, 8, 6, 1], [2, 0, 0]):
    want = jeng.infer(np.array(ids))
    got[len(got)] = eng.infer(np.array(ids))
    assert got[len(got) - 1].shape == (len(ids), 5)
    np.testing.assert_allclose(want, got[len(got) - 1], rtol=1e-5, atol=1e-5)
  assert eng.cache.hits == jeng.cache.hits == 6
  assert eng.forward_calls == jeng.forward_calls == 2
  # cached repeats are the rows first computed
  np.testing.assert_array_equal(eng.infer(np.array([9, 5, 4])),
                                np.stack([got[0][3], got[0][0], got[1][2]]))
  assert eng.forward_calls == 2


def test_hetero_engine_contract(monkeypatch):
  from fixtures import hetero_ring_dataset
  jds = hetero_ring_dataset(num_users=10, num_items=20, feat_dim=FEAT)
  ds = _port_dataset(jds)
  model = RGNN(ETYPES, FEAT, 16, 5, conv='rgat', heads=2)
  with pytest.raises(ValueError, match='input_type'):
    InferenceEngine(ds, model, None, FANOUTS, device='cpu')
  ds.init_node_features({t: np.ones((n, FEAT), np.float32)
                         for t, n in (('user', 10), ('item', 20))},
                        device='cpu')
  eng = InferenceEngine(ds, model, None, FANOUTS, buckets=(4, 8),
                        device='cpu', input_type='user')
  assert eng.num_nodes == 10
  eng.warmup()
  assert eng.forward_calls == 0 and len(eng.cache) == 0
  state = eng.init_params(3)
  assert torch.equal(state['layers.0.convs.item__i2i__item.att_src'],
                     eng.init_params(3)['layers.0.convs.item__i2i__item.'
                                        'att_src'])
  a = eng.infer(np.arange(10))              # a bucket of 8 and one of 4
  assert a.shape == (10, 5) and np.isfinite(a).all()
  assert eng.forward_calls == 2
  np.testing.assert_array_equal(eng.infer([3, 3, 9]), a[[3, 3, 9]])
  assert eng.forward_calls == 2
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    Dataset().init_graph({U2I: np.zeros((2, 1), np.int64)},
                         num_nodes={'user': 1, 'item': 1})
  with pytest.raises(RuntimeError, match='no CUDA device'):
    InferenceEngine(ds, model, None, FANOUTS, input_type='user')
