"""DistTrainStep against the JAX package's at world sizes 1 and 2, over
the partition layout of tests/test_torch_dist_homo.py (its graph, node and
edge features, the JAX RandomPartitioner): losses and parameters within
1e-5 of JAX's after three Adam steps, from a resident store, a spilled one
(split 0.5: each owner's cold rows through K3 mixed's plain twin), and
with an edge store under a probe model (the JAX suite's
``_EdgeSumModel``) whose edge-feature weights move only if ``edge_attr``
arrives; then the partitioned example at toy size. The JAX steps draw
their hops as the JAX sampler does, and the port takes those draws
(``homo_draws``); world 2 of the port runs in two gloo ranks
(tests/torch_dist_worker.py).
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_dist_worker as worker
from glt_tpu.distributed import DistTrainStep as JaxDistTrainStep
from glt_tpu.models import GraphSAGE as JaxGraphSAGE
from glt_tpu_torch.models import sage_params_from_flax
from glt_tpu_torch.parallel import make_mesh
from test_torch_dist_hetero import _np_tree
from test_torch_dist_homo import (BS, CLASSES, DIM, EDIM, FANOUTS, N, SPLIT,
                                  STORES, WORLDS, homo_draws, homo_graph,
                                  jax_layout, run_port)

HIDDEN, LR = 8, 1e-2
PARAM_ATOL = LOSS_RTOL = 1e-5


class EdgeSumProbe(nn.Module):
  """The JAX suite's ``_EdgeSumModel``: logits from the node features and
  the sum of each node's incoming edge features."""
  num_classes: int = CLASSES

  @nn.compact
  def __call__(self, batch):
    n = batch.node.shape[0]
    seg = jnp.where(batch.edge_mask, jnp.clip(batch.col, 0, n - 1), n)
    agg = jax.ops.segment_sum(
        jnp.where(batch.edge_mask[:, None], batch.edge_attr, 0.0),
        seg, n + 1)[:n]
    h = jnp.concatenate([batch.x, agg], axis=-1)
    return nn.Dense(self.num_classes)(h)[:batch.batch_size]


def probe_params(tree):
  d = tree['params']['Dense_0']
  return {'lin.weight': np.array(d['kernel']).T.copy(),
          'lin.bias': np.array(d['bias'])}


def port_params(model, params):
  if model == 'probe':
    return probe_params(params)
  return {k: v.numpy() for k, v in sage_params_from_flax(
      _np_tree(params)).items()}


TRAIN_CASES = {'resident': ('sage', None), 'spilled': ('sage', SPLIT),
               'edge_probe': ('probe', None)}
def _train_case(world, rng, hg, stores, labels, root, model_kind, split):
  """JAX's DistTrainStep over three steps and the case that replays them
  on the port."""
  model = (EdgeSumProbe() if model_kind == 'probe' else
           JaxGraphSAGE(hidden_features=HIDDEN, out_features=CLASSES,
                        num_layers=len(FANOUTS)))
  tx = optax.adam(LR)
  step = JaxDistTrainStep(
      hg, stores['node_spill' if split else 'node'], model, tx, labels,
      FANOUTS, batch_size_per_device=BS,
      edge_feature=stores['edge'] if model_kind == 'probe' else None)
  params = step.init_params(jax.random.key(1))
  opt = tx.init(params)
  case = dict(kind='dist_train', root=root, model=model_kind,
              params=port_params(model_kind, params), in_dim=DIM,
              edge_dim=EDIM, hidden=HIDDEN, classes=CLASSES,
              fanouts=FANOUTS, bs=BS, lr=LR, labels=labels,
              split_ratio=split, calls=[])
  results = []
  for t in range(3):
    s = rng.integers(0, N, (world, BS))
    v = np.full(world, BS)
    v[0] = BS - t % 2
    key = jax.random.key(100 * world + t)
    params, opt, loss = step(params, opt, s, v, key)
    results.append((np.asarray(loss)[:1],
                    port_params(model_kind, _np_tree(params))))
    case['calls'].append(dict(
        seeds=s, n_valid=v,
        u=homo_draws(jax.random.split(key, world), world, FANOUTS, BS)))
  return case, results


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
  """Per world: the trainer cases and JAX's losses and parameters."""
  ei, feats, efeats, labels = homo_graph(np.random.default_rng(23))
  stores = {k: STORES[k] for k in ('node', 'node_spill', 'edge')}
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv('GLT_DEDUP', 'sort')
    mp.setenv('GLT_FUSED_HOP', '1')
    for world in WORLDS:
      rng = np.random.default_rng(90 + world)
      root, hg, jstores = jax_layout(
          world, tmp_path_factory.mktemp(f'w{world}'), ei, feats, efeats,
          stores)
      cases, want = {}, {}
      for name, (model_kind, split) in TRAIN_CASES.items():
        cases[f'train_{name}'], want[f'train_{name}'] = _train_case(
            world, rng, hg, jstores, labels, root, model_kind, split)
      if world == 2:   # two parts, and the one part it is held against
        roots = [str(tmp_path_factory.mktemp(f'det{w}')) for w in (2, 1)]
        cases['det'] = dict(kind='det', root=roots[0],
                            labels=worker.det_layout(roots[0], 2),
                            seeds=worker.det_seeds(2))
        want['det'] = dict(root=roots[1],
                           labels=worker.det_layout(roots[1], 1))
      out[world] = cases, want
  return out


@pytest.fixture(scope='module')
def port(reference, tmp_path_factory):
  return run_port(reference, tmp_path_factory)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', list(TRAIN_CASES))
def test_dist_train_step_matches_jax(reference, port, world, name):
  want = reference[world][1][f'train_{name}']
  init = reference[world][0][f'train_{name}']['params']
  for rank, res in enumerate(port[world]):
    got = res[f'train_{name}']
    assert len(got) == len(want) == 3
    for i, ((wloss, wparams), g) in enumerate(zip(want, got)):
      np.testing.assert_allclose(np.atleast_1d(g['result']), wloss,
                                 rtol=LOSS_RTOL, err_msg=f'{name} call {i}')
      assert sorted(g['params']) == sorted(wparams)
      for k, v in wparams.items():
        np.testing.assert_allclose(g['params'][k], v, rtol=0,
                                   atol=PARAM_ATOL,
                                   err_msg=f'{name} rank {rank} call {i} {k}')
    if name == 'edge_probe':   # edge_attr reached the gradients
      moved = np.abs(got[0]['params']['lin.weight'][:, DIM:]
                     - init['lin.weight'][:, DIM:])
      assert moved.min() > 0


def test_two_ranks_train_as_one_rank_on_both_blocks(reference, port):
  """Over a graph whose every row a hop takes whole, two gloo ranks over
  two parts (each rank its seed block, the gradients' mean) train as one
  rank over one part on both blocks at once: the same losses and
  weights, to float noise."""
  case, one = reference[2][0]['det'], reference[2][1]['det']
  seeds = case['seeds']
  want = worker.det_train(make_mesh(device='cpu'), one['root'],
                          one['labels'], seeds.reshape(seeds.shape[0], 1, -1))
  two = port[2]
  for res in two:
    np.testing.assert_allclose(res['det']['losses'], want['losses'],
                               rtol=1e-5)
    for k, v in want['params'].items():
      np.testing.assert_allclose(res['det']['params'][k], v, rtol=0,
                                 atol=1e-5, err_msg=k)


def test_dist_train_sage_example_end_to_end():
  from glt_tpu_torch.examples.distributed import dist_train_sage
  res = dist_train_sage.main(['--device', 'cpu', '--num-nodes', '1500',
                              '--steps', '4', '--batch-size', '16',
                              '--split-ratio', '0.5'])
  assert len(res['losses']) == 4 and np.isfinite(res['losses']).all()
  assert res['spilled']
