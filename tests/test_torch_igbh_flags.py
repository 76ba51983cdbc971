"""The IGBH trainer beyond the resident store, in the port against the JAX
package where JAX computes the same thing:

- ``DistHeteroTrainStep`` over spilled per-type stores (``split_ratio``
  0.5: each owner serves its hot and cold rows through K3 mixed's plain
  twin): the losses and parameters within 1e-5 of JAX's spilled trainer
  after three Adam steps, at world sizes 1 and 2 (the JAX side on meshes
  of 1 and 2 CPU devices with ``GLT_DEDUP=sort GLT_FUSED_HOP=1``; world 2
  of the port in two spawned gloo ranks, tests/torch_dist_worker.py); a
  window over the spilled stores as one superstep against per-batch
  calls, and spilled against resident stores on the same batches (the
  same rows, so the same losses, parameters and eval counts);
- a checkpoint round trip (``utils.checkpoint``: the model's and Adam's
  state bit for bit) and a resumed trainer equal to an uninterrupted one,
  each step's draws a function of ``(seed, global step, rank)``
  (``dist_train_rgnn.step_uniforms``);
- the IGBH example's three modes: ``--split-ratio``, ``--ckpt-dir``/
  ``--ckpt-steps``/``--resume``, and the multihost mode
  (``--coordinator``/``--nprocs``/``--rank``) as two gloo ranks, each
  opening only its own partition's blocks and no feature table or edge
  payload of the tree.
"""
import os

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_dist_worker as worker
import torch_spmd_worker
from glt_tpu.distributed import DistDataset as JaxDistDataset
from glt_tpu.distributed import DistFeature as JaxDistFeature
from glt_tpu.distributed import DistHeteroGraph as JaxDistHeteroGraph
from glt_tpu.distributed import DistHeteroTrainStep as JaxDistHeteroTrainStep
from glt_tpu.models import RGNN as JaxRGNN
from glt_tpu.parallel import make_mesh as jax_make_mesh
from glt_tpu.partition import RandomPartitioner as JaxRandomPartitioner
from glt_tpu.typing import reverse_edge_type
from glt_tpu_torch.examples.igbh import dist_train_rgnn as example
from glt_tpu_torch.parallel import make_mesh
from glt_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                            save_checkpoint)
from test_torch_dist_hetero import (BS, CLASSES, DIM, FANOUTS, HEADS, HIDDEN,
                                    LR, NODES, _hetero_graph, _hetero_shapes,
                                    _np_tree, _port_params, _stacked_draws)

WORLDS = (1, 2)
SPLIT = 0.5
PARAM_ATOL = LOSS_RTOL = 1e-5
WINDOW = 2
JOIN_S = 240
EXAMPLE = ['--device', 'cpu', '--steps-per-epoch', '3', '--batch-size', '8',
           '--fanout', '3,2', '--hidden', '16', '--val-batches', '1']


def _spill_cases(world, tmp, ei, feats, labels):
  """JAX's spilled RSAGE trainer over three steps, the case replaying them
  on the port, and a port-only window over the same layout."""
  root = str(tmp / 'hetero')
  JaxRandomPartitioner(root, num_parts=world, num_nodes=NODES,
                       edge_index=ei, node_feat=feats, seed=3).partition()
  mesh = jax_make_mesh(world)
  dg = JaxDistHeteroGraph.from_dataset_partitions(mesh, root)
  dss = [JaxDistDataset().load(root, p) for p in range(world)]
  jfeats = {t: JaxDistFeature.from_dist_datasets(mesh, dss, ntype=t,
                                                 split_ratio=SPLIT)
            for t in NODES}
  model = JaxRGNN(edge_types=[reverse_edge_type(e) for e in dg.graphs],
                  hidden_features=HIDDEN, out_features=CLASSES,
                  num_layers=len(FANOUTS), conv='rsage', heads=HEADS)
  tx = optax.adam(LR)
  step = JaxDistHeteroTrainStep(dg, jfeats, model, tx, {'paper': labels},
                                FANOUTS, batch_size_per_device=BS,
                                seed_type='paper', seed=0)
  # flax init and the optimizer state jitted and placed as the step's
  # outputs are, so that neither the init nor a second step compiles again
  rep = NamedSharding(mesh, P())
  params = jax.device_put(jax.jit(model.init)(jax.random.key(0),
                                              step.dummy_batch()), rep)
  opt = jax.device_put(tx.init(params), rep)
  case = dict(kind='train', hetero=root, split_ratio=SPLIT, in_dim=DIM,
              hidden=HIDDEN, heads=HEADS, classes=CLASSES, conv='rsage',
              fanouts=FANOUTS, bs=BS, lr=LR, labels=labels,
              params=_port_params(params), calls=[])
  rng = np.random.default_rng(70 + world)
  shapes = _hetero_shapes(world, FANOUTS)
  want = []
  for t in range(3):
    s = rng.integers(0, NODES['paper'], (world, BS))
    v = np.full(world, BS)
    v[0] = BS - t % 2
    key = jax.random.key(300 * world + t)
    params, opt, loss = step(params, opt, s, v, key)
    want.append((np.asarray(loss)[:1], _np_tree(params)))
    case['calls'].append(dict(kind='step', seeds=s, n_valid=v,
                              u=_stacked_draws(jax.random.split(key, world),
                                               shapes)))
  nv = np.full((WINDOW, world), BS)
  nv[-1, -1] = BS - 3
  window = dict(seeds=rng.integers(0, NODES['paper'], (WINDOW, world * BS)),
                n_valid=nv,
                u=[[rng.random((WINDOW, world) + s).astype(np.float32)
                    for s in hop] for hop in shapes])
  ev = dict(seeds=rng.integers(0, NODES['paper'], (world, BS)),
            n_valid=np.full(world, BS),
            u=[[rng.random((world,) + s).astype(np.float32) for s in hop]
               for hop in shapes])
  sup = dict(case, kind='split_super', window=window, eval=ev)
  sup.pop('calls')
  return dict(train=case, super=sup), want


@pytest.fixture(scope='module')
def spilled(tmp_path_factory):
  """Per world: JAX's results and the port's, each rank's."""
  ei, feats, labels = _hetero_graph(np.random.default_rng(17))
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv('GLT_DEDUP', 'sort')
    mp.setenv('GLT_FUSED_HOP', '1')
    for world in WORLDS:
      cases, want = _spill_cases(
          world, tmp_path_factory.mktemp(f'spill{world}'), ei, feats, labels)
      if world == 1:
        got = [worker.run_cases(make_mesh(device='cpu'), cases)]
      else:
        got = torch_spmd_worker.spawn_ranks(
            worker.main, world, cases,
            str(tmp_path_factory.mktemp(f'ranks{world}')), JOIN_S)
      out[world] = want, got
  return out


@pytest.mark.parametrize('world', WORLDS)
def test_spilled_hetero_trainer_matches_jax(spilled, world):
  want, got = spilled[world]
  for rank, res in enumerate(got):
    assert len(res['train']) == len(want) == 3
    for i, ((wloss, wparams), g) in enumerate(zip(want, res['train'])):
      np.testing.assert_allclose(np.atleast_1d(g['result']), wloss,
                                 rtol=LOSS_RTOL, err_msg=f'step {i}')
      wp = _port_params(wparams)
      assert sorted(g['params']) == sorted(wp)
      for k, v in wp.items():
        np.testing.assert_allclose(g['params'][k], v, rtol=0,
                                   atol=PARAM_ATOL,
                                   err_msg=f'rank {rank} step {i} {k}')


@pytest.mark.parametrize('world', WORLDS)
def test_spilled_superstep_and_resident_twin(spilled, world):
  """A window over spilled stores as one superstep equals its batches a
  step at a time, and spilled stores equal resident ones on the same
  batches: the same losses bit for bit, the same parameters and eval
  counts."""
  _, got = spilled[world]
  for rank, res in enumerate(got):
    r = res['super']
    assert r['spilled'] == {t: True for t in NODES}
    np.testing.assert_allclose(r['super'], np.stack(r['split']),
                               rtol=LOSS_RTOL, err_msg=f'rank {rank}')
    np.testing.assert_array_equal(np.stack(r['split']),
                                  np.stack(r['resident']))
    window, split, resident = r['params']
    for k, v in resident.items():
      np.testing.assert_array_equal(split[k], v, err_msg=k)
      np.testing.assert_allclose(window[k], v, rtol=0, atol=PARAM_ATOL,
                                 err_msg=k)
    assert tuple(r['evals'][0]) == tuple(r['evals'][1])
    assert r['evals'][0][1] == world * BS


# -- checkpoints and resume ------------------------------------------------

def _one_rank_trainer(root, labels, seed=0):
  from glt_tpu_torch.distributed import (DistHeteroNeighborSampler,
                                         DistHeteroTrainStep)
  from glt_tpu_torch.models import RGNN
  mesh = make_mesh(device='cpu')
  dg = worker.DistHeteroGraph.from_dataset_partitions(mesh, root)
  feats = worker._features(mesh, root, split_ratio=SPLIT)
  keys = DistHeteroNeighborSampler(dg, FANOUTS).message_passing_types(
      BS, 'paper')
  model = RGNN(keys, worker.CARD_DIM, HIDDEN, worker.CARD_CLASSES,
               num_layers=len(FANOUTS), conv='rgat', heads=HEADS,
               node_types=list(dg.node_counts))
  step = DistHeteroTrainStep(dg, feats, model, {'paper': labels}, FANOUTS,
                             BS, 'paper', lr=LR, seed=seed)
  step.init_params(5)
  return step


def _state(step):
  return dict(params={k: v.clone() for k, v in
                      step.model.state_dict().items()},
              opt_state=step.optimizer.state_dict())


def _equal_trees(a, b, what=''):
  if isinstance(a, torch.Tensor):
    assert isinstance(b, torch.Tensor) and torch.equal(a, b), what
  elif isinstance(a, dict):
    assert sorted(map(str, a)) == sorted(map(str, b)), what
    for k in a:
      _equal_trees(a[k], b[k], f'{what}/{k}')
  elif isinstance(a, (list, tuple)):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
      _equal_trees(x, y, f'{what}/{i}')
  else:
    assert a == b, (what, a, b)


def test_checkpoint_round_trip_and_resume_equal_uninterrupted(tmp_path):
  """Four steps in one go against two steps, a checkpoint, a fresh trainer
  restored from it and two more steps over the same seeds and the same
  per-step draws: the restored state is the saved one bit for bit, and
  the parameters after the fourth step equal the uninterrupted run's (the
  CPU step is deterministic)."""
  root = str(tmp_path / 'layout')
  labels = worker.card_layout(root, 1)
  rng = np.random.default_rng(3)
  seeds = [rng.integers(0, 4000, (1, BS)) for _ in range(4)]
  one = np.full(1, BS)
  whole = _one_rank_trainer(root, labels)
  for i in range(4):
    whole(seeds[i], one, example.step_uniforms(whole, 7, i))
  first = _one_rank_trainer(root, labels)
  for i in range(2):
    first(seeds[i], one, example.step_uniforms(first, 7, i))
  saved = _state(first)
  ck = str(tmp_path / 'ck')
  save_checkpoint(ck, 2, saved['params'], opt_state=saved['opt_state'])
  second = _one_rank_trainer(root, labels)
  got, payload = restore_checkpoint(
      ck, template={'params': second.model.state_dict()})
  assert got == 2
  second.model.load_state_dict(payload['params'])
  second.optimizer.load_state_dict(payload['opt_state'])
  _equal_trees(_state(second), saved)
  for i in range(2, 4):
    second(seeds[i], one, example.step_uniforms(second, 7, i))
  _equal_trees(_state(second), _state(whole))
  # the draws are a function of (seed, step, rank), not of the generator
  a = example.step_uniforms(first, 7, 3)
  b = example.step_uniforms(second, 7, 3)
  assert all(torch.equal(x, y) for ha, hb in zip(a, b)
             for x, y in zip(ha, hb) if x is not None)
  assert not torch.equal(a[0][0], example.step_uniforms(first, 8, 3)[0][0])


# -- the example's modes ---------------------------------------------------

def test_igbh_example_split_checkpoints_and_resume(tmp_path, capsys):
  data, part = worker.igbh_tree(tmp_path)
  ck = str(tmp_path / 'ck')
  args = EXAMPLE + ['--data-root', data, '--part-root', part,
                    '--split-ratio', '0.5', '--ckpt-dir', ck,
                    '--ckpt-steps', '2', '--lr-schedule', 'cosine',
                    '--lr-warmup-steps', '1']
  a = example.main(args)
  out = capsys.readouterr().out
  assert a['steps'] == 3 and a['start_step'] == 0
  assert a['spilled'] == {'paper': True, 'author': True, 'institute': True}
  assert 'host-offloaded cold blocks active' in out
  assert sorted(os.listdir(ck)) == ['2', '3']
  got, payload = restore_checkpoint(ck)
  assert got == 3
  for k, v in a['params'].items():
    assert torch.equal(payload['params'][k], v), k
  b = example.main(args + ['--resume'])
  out = capsys.readouterr().out
  assert 'resumed from checkpoint step 3' in out
  assert (b['start_step'], b['steps']) == (3, 6)
  assert all(np.isfinite(b['losses']))
  assert sorted(os.listdir(ck)) == ['3', '4', '6']     # the last three
  # the schedule resumed at step 3: the lr of step 6 is the cosine's
  lr = restore_checkpoint(ck)[1]['opt_state']['param_groups'][0]['lr']
  want = 1e-3 * example.lr_lambda('cosine', 1, 3)(6)
  assert lr == pytest.approx(want, rel=1e-12)


def test_igbh_example_multihost_two_ranks(tmp_path):
  data, part = worker.igbh_tree(tmp_path, parts=2)
  res = worker.run_multihost(data, part, tmp_path, ['--device', 'cpu'])
  worker.check_own_blocks(res, data, part)
  assert res[0]['losses'] == res[1]['losses']     # the mesh's mean


def test_igbh_example_multihost_needs_its_trees(tmp_path):
  with pytest.raises(SystemExit, match='pre-built --part-root'):
    example.main(EXAMPLE + ['--coordinator', '127.0.0.1:1'])
  with pytest.raises(SystemExit, match='pre-built --part-root'):
    example.main(EXAMPLE + ['--coordinator', '127.0.0.1:1', '--part-root',
                            str(tmp_path / 'none')])
  os.makedirs(tmp_path / 'parts')
  (tmp_path / 'parts' / 'META.json').write_text('{}')
  with pytest.raises(SystemExit, match='pre-built shared --data-root'):
    example.main(EXAMPLE + ['--coordinator', '127.0.0.1:1', '--part-root',
                            str(tmp_path / 'parts'), '--data-root',
                            str(tmp_path / 'none')])
