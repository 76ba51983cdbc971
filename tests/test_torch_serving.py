"""The port's InferenceEngine end to end (sample -> gather -> GraphSAGE ->
cache) against the JAX engine on the fused-walk path
(``GLT_HOP_ENGINE=pallas_fused``, ``GLT_FUSED_WALK=cross``; its walk
kernel in interpret mode), with the JAX engine's uniforms injected into
the port's sampler and the flax weights converted.

JAX's CPU default (element hops + table dedup) labels new ids in slot
order and is not the reference: the port implements the walk's
value-order label contract. Logits match to rtol = atol = 1e-5 (sums in
another order); everything upstream of the forward is bit-identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.loader.transform import Batch as JaxBatch
from glt_tpu.models.sage import GraphSAGE as JaxGraphSAGE
from glt_tpu.ops.sample import walk_hop_uniforms as jax_walk_hop_uniforms
from glt_tpu.serving import InferenceEngine as JaxEngine
from glt_tpu.utils.rng import make_key
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.models import GraphSAGE, sage_params_from_flax
from glt_tpu_torch.ops.sample import walk_geometry
from glt_tpu_torch.serving import InferenceEngine

N, E, F, FANOUTS, BUCKET, SEED = 64, 600, 12, [3, 2], 8, 0


def _data():
  rng = np.random.default_rng(0)
  ei = np.stack([rng.integers(0, N, E), rng.integers(0, N, E)])
  x = rng.standard_normal((N, F)).astype(np.float32)
  return ei, x


def _flax_params(model):
  # parameter shapes depend only on the feature widths
  z = jnp.zeros((4,), jnp.int32)
  batch = JaxBatch(x=jnp.zeros((4, F)), row=z, col=z,
                   edge_mask=jnp.zeros((4,), bool), node=z,
                   node_count=jnp.zeros((), jnp.int32), batch_size=2)
  return model.init(jax.random.key(1), batch)


def _jax_uniforms(step, batch_size):
  """The draws JAX's sampler makes on its ``step``-th call."""
  u = jax_walk_hop_uniforms(jax.random.fold_in(make_key(SEED), step),
                            batch_size, FANOUTS, False)
  return [torch.as_tensor(np.asarray(a)[:s])
          for a, (s, _) in zip(u, walk_geometry(batch_size, FANOUTS))]


def test_infer_matches_jax_fused_walk_engine(monkeypatch):
  monkeypatch.setenv('GLT_HOP_ENGINE', 'pallas_fused')
  monkeypatch.setenv('GLT_FUSED_WALK', 'cross')
  monkeypatch.setenv('GLT_WINDOW_W', '8')   # hub rows exist at W = 8
  ei, x = _data()
  jmodel = JaxGraphSAGE(hidden_features=16, out_features=5, num_layers=2)
  params = _flax_params(jmodel)
  jds = JaxDataset().init_graph(edge_index=ei, num_nodes=N)
  jds.init_node_features(x)
  jeng = JaxEngine(jds, jmodel, params, FANOUTS, buckets=(BUCKET,),
                   seed=SEED)

  ds = Dataset().init_graph(ei, num_nodes=N, device='cpu')
  ds.init_node_features(x, device='cpu')
  eng = InferenceEngine(ds, GraphSAGE(F, 16, 5, num_layers=2),
                        sage_params_from_flax(jax.tree.map(np.asarray,
                                                           params)),
                        FANOUTS, buckets=(BUCKET,), seed=SEED,
                        device='cpu')
  steps = iter(range(1, 100))
  monkeypatch.setattr(eng.sampler, 'hop_uniforms',
                      lambda b: _jax_uniforms(next(steps), b))

  for ids in ([5, 0, 5, 17, 63, 2], [0, 9, 9, 40, 2, 33, 61]):
    want = jeng.infer(np.array(ids))
    got = eng.infer(np.array(ids))
    np.testing.assert_allclose(want, got, rtol=1e-5, atol=1e-5)
  # the second request's cached ids (0, 2) did not reach the pipeline
  assert eng.cache.hits == jeng.cache.hits == 2


def test_cache_and_versioning():
  ei, x = _data()
  ds = Dataset().init_graph(ei, num_nodes=N, device='cpu')
  ds.init_node_features(x, device='cpu')
  eng = InferenceEngine(ds, GraphSAGE(F, 16, 5), None, FANOUTS,
                        buckets=(4, 8), device='cpu')
  eng.warmup()
  assert eng.forward_calls == 0 and len(eng.cache) == 0
  state = eng.init_params(3)
  assert torch.equal(state['convs.0.lin_root.weight'],
                     eng.init_params(3)['convs.0.lin_root.weight'])
  a = eng.infer(np.arange(10))            # 8 + a chunk of 2 in bucket 4
  assert a.shape == (10, 5) and np.isfinite(a).all()
  assert eng.forward_calls == 2
  b = eng.infer([3, 3, 9])
  np.testing.assert_array_equal(b, a[[3, 3, 9]])
  assert eng.forward_calls == 2           # all cached
  eng.set_params(eng.init_params(4))
  eng.infer([3])
  assert eng.forward_calls == 3           # version bump misses
  eng.infer([9])
  assert eng.cache.invalidate(ids=[9]) == 2   # both versions of node 9
  eng.infer([9])
  assert eng.forward_calls == 5
  assert eng.cache.invalidate(version=0) == 9   # nodes 0-8 at version 0
  assert eng.cache.invalidate() == 2 and len(eng.cache) == 0
  assert eng.infer([]).shape == (0, 5)


def test_entry_points_refuse_to_run_on_the_cpu_unasked(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  ei, x = _data()
  with pytest.raises(RuntimeError, match='no CUDA device'):
    Dataset().init_graph(ei, num_nodes=N)
  ds = Dataset().init_graph(ei, num_nodes=N, device='cpu')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    ds.init_node_features(x)
  ds.init_node_features(x, device='cpu')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    InferenceEngine(ds, GraphSAGE(F, 16, 5), None, FANOUTS)
