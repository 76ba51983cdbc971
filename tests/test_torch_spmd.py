"""The port's data-parallel stack against the JAX package's at world
sizes 1 and 2: ``ShardedFeature.lookup`` and ``stage_cold_rows`` bit for
bit, and ``SPMDSageTrainStep``'s losses and parameters within 1e-5 over
two supersteps of K = 3 and one per-batch step, from the same flax
weights carried over (``models/convert.py``).

The JAX side runs on a mesh of that many CPU devices, its walk on the
sort inducer with fused hops (``GLT_DEDUP=sort GLT_FUSED_HOP=1``), which
the port's walk reproduces; the port's uniforms are the draws the JAX
body makes from ``fold_in(keys[t, d], d)``. World 1 runs the port in this
process with no process group; world 2 runs it in two spawned ranks of a
gloo group over a ``FileStore`` in ``tmp_path`` (tests/torch_spmd_worker.py,
which imports no JAX), each rank's block held against the JAX result's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_spmd_worker as worker
from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.models import GraphSAGE as JaxGraphSAGE
from glt_tpu.parallel import ShardedFeature as JaxShardedFeature
from glt_tpu.parallel import SPMDSageTrainStep as JaxSPMDSageTrainStep
from glt_tpu.parallel import make_mesh as jax_make_mesh
from glt_tpu_torch.models import sage_params_from_flax
from glt_tpu_torch.parallel import make_mesh

N, F, HIDDEN, C, BS, K, LR = 64, 8, 8, 4, 4, 3, 1e-2
FANOUTS = [3, 2]
LOSS_RTOL = PARAM_ATOL = 1e-5
WORLDS = (1, 2)
JOIN_S = 240
TRAIN = {'resident': {}, 'with_edge': {'with_edge': True},
         'cold_streaming': {'cold_streaming': True, 'split_ratio': 0.5,
                            'host_offload': False}}
LOOKUP = {'resident': {}, 'capped': {'bucket_cap': 3},
          'spilled': {'split_ratio': 0.5, 'host_offload': False},
          'spilled_pinned': {'split_ratio': 0.5},
          'all_cold': {'split_ratio': 0.0, 'host_offload': False}}


def _setting():
  """The JAX superstep tests' toy (tests/test_superstep.py): a ring-ish
  graph of 64 nodes, 8 features, 4 classes."""
  rng = np.random.default_rng(23)
  src = np.repeat(np.arange(N), 3)
  dst = (src + rng.integers(1, N, src.shape[0])) % N
  feats = rng.normal(size=(N, F)).astype(np.float32)
  labels = rng.integers(0, C, N).astype(np.int32)
  return np.stack([src, dst]), feats, labels


@jax.jit
def _draws(key):
  """One body's walk uniforms from its device key, as the JAX sorted hop
  loop draws them: per hop ``key, sub = split(key)``, ``uniform(sub, (K,
  S)).T``."""
  us, s = [], BS
  for f in FANOUTS:
    key, sub = jax.random.split(key)
    us.append(jax.random.uniform(sub, (f, s)).T)
    s *= f
  return us


def uniforms_from_keys(keys):
  """Per hop ``[..., world, S_h, K_h]`` uniforms for ``keys [..., world]``:
  rank d of a batch draws from ``fold_in(keys[..., d], d)``."""
  lead = keys.shape
  flat = keys.reshape(-1)
  world = lead[-1]
  per = [_draws(jax.random.fold_in(flat[i], i % world))
         for i in range(flat.shape[0])]
  return [np.stack([np.asarray(p[h]) for p in per]).reshape(
      lead + per[0][h].shape) for h in range(len(FANOUTS))]


def _lookup_cases(world, feats):
  rng = np.random.default_rng(5 + world)
  b = 16
  ids = rng.integers(0, N, world * b)
  ids[::3] = rng.integers(0, N // (2 * world), ids[::3].shape[0])  # a hot spot
  ids[1] = -1
  valid = rng.random(world * b) > 0.15
  cases, want = {}, {}
  mesh = jax_make_mesh(world)
  for name, kw in LOOKUP.items():
    jkw = {k: v for k, v in kw.items() if k != 'host_offload'}
    jsf = JaxShardedFeature(feats, mesh, host_offload=False, **jkw)
    want[name] = np.asarray(jsf.lookup(ids, jnp.asarray(valid)))
    cases[f'lookup_{name}'] = dict(kind='lookup', feats=feats, ids=ids,
                                   valid=valid, **kw)
  # the staging of a pre-sampled stack [T, world * B] over every shard
  nodes = rng.integers(-1, N, (2, world * b))
  counts = rng.integers(0, b + 1, (2, world))
  jsf = JaxShardedFeature(feats, mesh, split_ratio=0.5, host_offload=False)
  want['stage'] = jsf.stage_cold_rows(nodes, counts)
  cases['stage'] = dict(kind='stage', feats=feats, nodes=nodes,
                        counts=counts, split_ratio=0.5, host_offload=False)
  return cases, want


def _train_cases(world, edge_index, feats, labels):
  jds = JaxDataset(edge_dir='out')
  jds.init_graph(edge_index=edge_index, num_nodes=N)
  mesh = jax_make_mesh(world)
  tx = optax.adam(LR)
  rng = np.random.default_rng(11 + world)
  seeds = rng.integers(0, N, (2 * K + 1, world * BS))
  nv = np.full((2 * K + 1, world), BS)
  nv[K + 1, -1] = BS - 1                      # ragged blocks
  nv[2 * K, 0] = BS - 2
  keys = jax.random.split(jax.random.key(7 + world), (2 * K + 1, world))
  u = uniforms_from_keys(keys)
  cases, want = {}, {}
  for name, kw in TRAIN.items():
    skw = {k: v for k, v in kw.items() if k in worker.STORE_KW}
    tkw = {k: v for k, v in kw.items() if k not in worker.STORE_KW}
    jsf = JaxShardedFeature(feats, mesh, **skw)
    step = JaxSPMDSageTrainStep(
        mesh, JaxGraphSAGE(hidden_features=HIDDEN, out_features=C,
                           num_layers=len(FANOUTS)),
        tx, jds.get_graph(), jsf, labels, fanouts=FANOUTS,
        batch_size_per_device=BS, **tkw)
    params = step.init_params(jax.random.key(0))
    opt = tx.init(params)
    case = dict(kind='train', edge_index=edge_index, num_nodes=N,
                feats=feats, labels=labels, hidden=HIDDEN, classes=C,
                fanouts=FANOUTS, bs=BS, lr=LR,
                with_edge=tkw.get('with_edge', False),
                cold_streaming=tkw.get('cold_streaming', False),
                params={k: v.numpy() for k, v in sage_params_from_flax(
                    jax.tree.map(np.asarray, params)).items()},
                calls=[], **skw)
    losses = []
    for lo in (0, K):
      w = slice(lo, lo + K)
      params, opt, loss = step.superstep(params, opt, seeds[w], nv[w],
                                         keys[w])
      losses.append(np.asarray(loss)[:, 0])
      case['calls'].append(dict(kind='superstep', seeds=seeds[w],
                                n_valid=nv[w], u=[x[w] for x in u]))
    if not tkw.get('cold_streaming'):
      t = 2 * K
      params, opt, loss = step(params, opt, seeds[t], nv[t], keys[t])
      losses.append(np.asarray(loss)[:1])
      case['calls'].append(dict(kind='step', seeds=seeds[t], n_valid=nv[t],
                                u=[x[t] for x in u]))
    cases[f'train_{name}'] = case
    want[f'train_{name}'] = dict(
        losses=losses, params={k: v.numpy() for k, v in sage_params_from_flax(
            jax.tree.map(np.asarray, params)).items()})
  return cases, want


@pytest.fixture(scope='module')
def reference():
  """Per world: the cases and the JAX results."""
  edge_index, feats, labels = _setting()
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv('GLT_DEDUP', 'sort')
    mp.setenv('GLT_FUSED_HOP', '1')
    for world in WORLDS:
      cases, want = _lookup_cases(world, feats)
      c2, w2 = _train_cases(world, edge_index, feats, labels)
      cases.update(c2)
      want.update(w2)
      out[world] = (cases, want)
  return out


@pytest.fixture(scope='module')
def port(reference, tmp_path_factory):
  """Per world: each rank's results (world 1 in this process)."""
  out = {}
  for world in WORLDS:
    cases = reference[world][0]
    if world == 1:
      out[1] = [worker.run_cases(make_mesh(device='cpu'), cases)]
    else:
      out[world] = worker.spawn_ranks(
          worker.main, world, cases,
          str(tmp_path_factory.mktemp(f'w{world}')), JOIN_S)
  return out


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', list(LOOKUP))
def test_lookup_matches_jax(reference, port, world, name):
  want = reference[world][1][name]
  got = np.concatenate([r[f'lookup_{name}'] for r in port[world]])
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('world', WORLDS)
def test_stage_cold_rows_matches_jax(reference, port, world):
  want = reference[world][1]['stage']
  assert np.abs(want).sum() > 0
  for r in port[world]:
    np.testing.assert_array_equal(r['stage'], want)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', list(TRAIN))
def test_spmd_train_matches_jax(reference, port, world, name):
  want = reference[world][1][f'train_{name}']
  for rank, r in enumerate(port[world]):
    got = r[f'train_{name}']
    n_calls = len(want['losses'])
    assert n_calls == (2 if name == 'cold_streaming' else 3)
    for i in range(n_calls):
      loss = np.atleast_1d(got[f'loss{i}'])
      np.testing.assert_allclose(loss, want['losses'][i], rtol=LOSS_RTOL,
                                 err_msg=f'rank {rank} call {i}')
    for k, v in want['params'].items():
      np.testing.assert_allclose(got[f'param:{k}'], v, rtol=0,
                                 atol=PARAM_ATOL, err_msg=f'rank {rank} {k}')
