"""The partitioned hetero stack against the JAX package's at world sizes 1
and 2, over the same partition layouts on disk (written by the JAX
RandomPartitioner; tests/test_torch_partition.py holds the two
partitioners equal):

- every store (each edge type's, the homogeneous graph's) equal to the
  JAX stacked arrays' row of its rank;
- ``make_dist_one_hop`` (with edge ids), ``DistNeighborSampler`` and
  ``DistHeteroNeighborSampler.sample_from_nodes`` bit-identical on every
  output field;
- ``DistFeature.lookup`` equal for float32 (uncapped) and bf16 (capped:
  the exchange drains in rounds);
- ``DistHeteroTrainStep``, an RSAGE: losses and parameters within 1e-5
  of JAX's after three Adam steps, the ``eval_step`` counts equal, and a
  superstep of K = 2 within 1e-5 of JAX's superstep; an RGAT: each
  step's mean gradient at JAX's weights, the losses, the eval counts and
  the first step's weights but the entries whose gradient is float noise
  (``_noise_grad``);
- the static-shape ``sorted_hop_dedup_fused`` equal to the version it
  replaced (``torch.unique``) on random cases, an empty hop and an
  all-seen hop; ``MLLogger``'s lines equal apart from ``time_ms``; the
  IGBH example end to end at 2,000 papers and its learning-rate schedules
  against optax's.

The JAX side runs on meshes of 1 and 2 CPU devices with ``GLT_DEDUP=sort
GLT_FUSED_HOP=1``; the port's uniforms are the draws a JAX device makes
when it serves a hop: ``uniform(fold_in(sub, d), (fanout, world * F)).T``
with ``sub`` device d's hop key (its key ``fold_in(keys[d], d)`` split
once per hop and segment). World 1 runs the port in this process; world
2 in two spawned ranks of a gloo group (tests/torch_dist_worker.py, which
imports no JAX).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_worker as worker
import torch_spmd_worker
from glt_tpu.distributed import DistDataset as JaxDistDataset
from glt_tpu.distributed import DistFeature as JaxDistFeature
from glt_tpu.distributed import DistGraph as JaxDistGraph
from glt_tpu.distributed import DistHeteroGraph as JaxDistHeteroGraph
from glt_tpu.distributed import (DistHeteroNeighborSampler as
                                 JaxDistHeteroNeighborSampler)
from glt_tpu.distributed import DistHeteroTrainStep as JaxDistHeteroTrainStep
from glt_tpu.distributed import DistNeighborSampler as JaxDistNeighborSampler
from glt_tpu.distributed.dist_neighbor_sampler import (
    make_dist_one_hop as jax_make_dist_one_hop)
from glt_tpu.models import RGNN as JaxRGNN
from glt_tpu.parallel import make_mesh as jax_make_mesh
from glt_tpu.partition import RandomPartitioner as JaxRandomPartitioner
from glt_tpu.typing import reverse_edge_type
from glt_tpu.utils.mlperf_logging import MLLogger as JaxMLLogger
from glt_tpu_torch.models import rgnn_params_from_flax
from glt_tpu_torch.ops.unique import BIG, sorted_hop_dedup_fused
from glt_tpu_torch.parallel import make_mesh
from glt_tpu_torch.utils.mlperf_logging import MLLogger

WORLDS = (1, 2)
NODES = {'paper': 60, 'author': 30, 'institute': 6}
DIM, HIDDEN, HEADS, CLASSES, BS, LR = 8, 8, 2, 4, 4, 1e-2
FANOUTS = [3, 2]
CONV = 'rsage'
PARAM_ATOL = LOSS_RTOL = 1e-5
GRAD_ZERO = 1e-7
GRAD_RTOL = 1e-4
JOIN_S = 240


def _hetero_graph(rng):
  p, a, i = NODES['paper'], NODES['author'], NODES['institute']
  ei = {('paper', 'cites', 'paper'): np.stack(
            [rng.integers(0, p, 4 * p), rng.integers(0, p, 4 * p)]),
        ('author', 'writes', 'paper'): np.stack(
            [rng.integers(0, a, 2 * p), rng.integers(0, p, 2 * p)]),
        ('author', 'affiliated', 'institute'): np.stack(
            [np.arange(a), rng.integers(0, i, a)])}
  for (s, r, d), e in list(ei.items()):
    if s != d:
      ei[(d, f'rev_{r}', s)] = e[::-1].copy()
  feats = {t: rng.normal(size=(n, DIM)).astype(np.float32)
           for t, n in NODES.items()}
  w = rng.normal(size=(DIM, CLASSES)).astype(np.float32)
  labels = np.argmax(feats['paper'] @ w, 1).astype(np.int32)
  return ei, feats, labels


def _draws(dev_key, d, shapes):
  """Device d's serving draws, per hop and segment: its key
  ``fold_in(dev_key, d)`` split once per segment, each sub-key folded by
  d and drawn ``(fanout, world * F)``, transposed."""
  key = jax.random.fold_in(dev_key, d)
  out = []
  for hop in shapes:
    us = []
    for s, k in hop:
      key, sub = jax.random.split(key)
      us.append(np.asarray(jax.random.uniform(
          jax.random.fold_in(sub, d), (k, s)).T))
    out.append(us)
  return out


def _stacked_draws(keys, shapes):
  """Per hop and segment ``[..., world, S, K]`` for device keys
  ``[..., world]``."""
  lead = keys.shape
  flat = keys.reshape(-1)
  world = lead[-1]
  per = [_draws(flat[j], j % world, shapes) for j in range(flat.shape[0])]
  return [[np.stack([p[h][i] for p in per]).reshape(lead + per[0][h][i].shape)
           for i in range(len(shapes[h]))] for h in range(len(shapes))]


def _hetero_shapes(world, fanouts, bs=BS):
  """The segments of a walk from papers (every edge type's fanouts
  ``fanouts``), in the JAX loop's order: ``[(world * F, k)]`` a hop."""
  trav = {('paper', 'cites', 'paper'): ('paper', 'paper'),
          ('author', 'writes', 'paper'): ('author', 'paper'),
          ('author', 'affiliated', 'institute'): ('author', 'institute'),
          ('paper', 'rev_writes', 'author'): ('paper', 'author'),
          ('institute', 'rev_affiliated', 'author'): ('institute', 'author')}
  caps = {t: (bs if t == 'paper' else 0) for t in NODES}
  shapes = []
  for k in fanouts:
    hop, nxt = [], {t: 0 for t in NODES}
    for row_t, col_t in trav.values():
      if caps[row_t]:
        hop.append((world * caps[row_t], k))
      nxt[col_t] += caps[row_t] * k
    shapes.append(hop)
    caps = nxt
  return shapes


def _np_tree(x):
  """Numpy copies (a donated buffer is reused by the next call)."""
  return jax.tree.map(np.array, x)


def _jax_one_hop(g, mesh, ids, mask, keys, fanout):
  sp = P('data')

  def device_fn(indptr, indices, eids, local_row, node_pb, ids, mask, key):
    hop = jax_make_dist_one_hop(
        dict(indptr=indptr[0], indices=indices[0], edge_ids=eids[0],
             local_row=local_row[0], node_pb=node_pb),
        g.num_nodes, g.num_partitions, g.max_rows, 'data')
    out = hop(ids[0], fanout, key[0], mask[0])
    return out.nbrs[None], out.mask[None], out.eids[None]
  fn = jax.jit(jax.shard_map(device_fn, mesh=mesh,
                             in_specs=(sp, sp, sp, sp, P(), sp, sp, sp),
                             out_specs=(sp, sp, sp), check_vma=False))
  nbrs, m, e = fn(g.indptr, g.indices, g.edge_ids, g.local_row, g.node_pb,
                  jnp.asarray(ids), jnp.asarray(mask), keys)
  return dict(nbrs=np.asarray(nbrs), mask=np.asarray(m), eids=np.asarray(e))


def _world_cases(world, tmp, ei, feats, labels):
  """The cases of one world and the JAX results they are held to."""
  rng = np.random.default_rng(40 + world)
  hroot, oroot = str(tmp / 'hetero'), str(tmp / 'homo')
  JaxRandomPartitioner(hroot, num_parts=world, num_nodes=NODES,
                       edge_index=ei, node_feat=feats, seed=3).partition()
  n = NODES['paper']
  JaxRandomPartitioner(oroot, num_parts=world, num_nodes=n,
                       edge_index=ei[('paper', 'cites', 'paper')],
                       node_feat=feats['paper'], seed=4).partition()
  mesh = jax_make_mesh(world)
  cases, want = {}, {}
  base = dict(hetero=hroot, homo=oroot)

  # stores
  dg = JaxDistHeteroGraph.from_dataset_partitions(mesh, hroot)
  hg = JaxDistGraph.from_dataset_partitions(mesh, oroot)
  want['stores'] = {e: st for e, st in dg.graphs.items()}
  want['stores']['homo'] = hg
  cases['stores'] = dict(kind='stores', **base)

  # one hop, with edge ids; some requests masked, some ids out of range
  f, k = 6, 3
  ids = rng.integers(0, n, (world, f)).astype(np.int32)
  mask = rng.random((world, f)) > 0.2
  ids[0, 0] = BIG
  mask[0, 0] = False
  keys = jax.random.split(jax.random.key(5 + world), world)
  want['one_hop'] = _jax_one_hop(hg, mesh, ids, mask, keys, k)
  u = np.stack([np.asarray(jax.random.uniform(
      jax.random.fold_in(keys[d], d), (k, world * f)).T)
      for d in range(world)])
  cases['one_hop'] = dict(kind='one_hop', ids=ids, mask=mask, u=u,
                          fanout=k, **base)

  # the homogeneous sampler
  seeds = rng.integers(0, n, (world, BS))
  nv = np.full(world, BS)
  nv[-1] = BS - 1
  key = jax.random.key(9 + world)
  out = JaxDistNeighborSampler(hg, FANOUTS, seed=0).sample_from_nodes(
      seeds, nv, key=key)
  want['sample_homo'] = {k_: np.asarray(v) for k_, v in out.items()
                         if k_ != 'edge_hop_offsets'}
  shapes, fw = [], BS
  for k_ in FANOUTS:
    shapes.append([(world * fw, k_)])
    fw *= k_
  u = _stacked_draws(jax.random.split(key, world), shapes)
  cases['sample_homo'] = dict(kind='sample_homo', seeds=seeds, n_valid=nv,
                              fanouts=FANOUTS, u=[h[0] for h in u], **base)

  # the hetero sampler, at three hops
  fan3 = [3, 2, 2]
  out = JaxDistHeteroNeighborSampler(dg, fan3, seed=0).sample_from_nodes(
      'paper', seeds, nv, key=key)
  out.pop('input_type')
  want['sample_hetero'] = _np_tree(out)
  cases['sample_hetero'] = dict(
      kind='sample_hetero', seeds=seeds, n_valid=nv, seed_type='paper',
      fanouts=fan3,
      u=_stacked_draws(jax.random.split(key, world),
                       _hetero_shapes(world, fan3)), **base)

  # DistFeature lookups: float32 and bf16, uncapped and capped
  dss = [JaxDistDataset().load(hroot, p) for p in range(world)]
  lids = {t: rng.integers(-1, c, world * 10) for t, c in NODES.items()}
  lvalid = {t: rng.random(world * 10) > 0.1 for t in NODES}
  for dname, jdt, cap in (('float32', None, 0), ('bfloat16', jnp.bfloat16, 3)):
    name = f'lookup_{dname}_{cap}'
    want[name] = {t: np.asarray(JaxDistFeature.from_dist_datasets(
        mesh, dss, ntype=t, dtype=jdt, bucket_cap=cap).lookup(
            lids[t], jnp.asarray(lvalid[t])), np.float32)
        for t in NODES}
    cases[name] = dict(kind='lookup', dtype=dname, bucket_cap=cap,
                       ids=lids, valid=lvalid, **base)

  # the trainer: three steps, an eval, a superstep of two; an RSAGE and
  # an RGAT (its batches from an rng of their own, its gradients probed)
  jfeats = {t: JaxDistFeature.from_dist_datasets(mesh, dss, ntype=t)
            for t in NODES}
  for name, conv, trng in (('train', 'rsage', rng),
                           ('train_rgat', 'rgat',
                            np.random.default_rng(60 + world))):
    cases[name], want[name], grads = _train_case(
        world, conv, trng, dg, jfeats, labels, base, probe=conv == 'rgat')
    if grads:
      cases[f'{name}_grads'], want[f'{name}_grads'] = grads
  return cases, want


def _grad_probe():
  """An optax transformation that applies no update and keeps the
  gradient it was given (the step's mean over devices) as its state."""
  return optax.GradientTransformation(
      lambda p: jax.tree.map(jnp.zeros_like, p),
      lambda g, state, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _port_params(params):
  return {k: v.numpy() for k, v in rgnn_params_from_flax(
      _np_tree(params)).items()}


def _train_case(world, conv, rng, dg, jfeats, labels, base, probe=False):
  """JAX's DistHeteroTrainStep over three steps, an eval and a superstep
  of two, and the case that replays them on the port. ``probe``: also
  each per-batch step's mean gradient at JAX's weights before it (port
  names), and the case that takes the port's at those weights."""
  n = NODES['paper']
  etypes = list(dg.graphs)
  model = JaxRGNN(edge_types=[reverse_edge_type(e) for e in etypes],
                  hidden_features=HIDDEN, out_features=CLASSES,
                  num_layers=len(FANOUTS), conv=conv, heads=HEADS)

  def trainer(tx):
    return JaxDistHeteroTrainStep(dg, jfeats, model, tx, {'paper': labels},
                                  FANOUTS, batch_size_per_device=BS,
                                  seed_type='paper', seed=0)
  tx, probe_tx = optax.adam(LR), _grad_probe()
  step = trainer(tx)
  prober = trainer(probe_tx) if probe else None
  params = step.init_params(jax.random.key(0))
  opt = tx.init(params)
  model_args = dict(in_dim=DIM, hidden=HIDDEN, heads=HEADS, classes=CLASSES,
                    conv=conv, fanouts=FANOUTS, bs=BS, lr=LR, labels=labels,
                    **base)
  case = dict(kind='train', calls=[], params=_port_params(params),
              **model_args)
  gcase = dict(kind='grads', calls=[], **model_args)
  results, grads = [], []
  hshapes = _hetero_shapes(world, FANOUTS)
  for t in range(3):
    s = rng.integers(0, n, (world, BS))
    v = np.full(world, BS)
    v[0] = BS - t % 2
    key = jax.random.key(100 * world + t)
    u = [[x for x in hop] for hop in _stacked_draws(
        jax.random.split(key, world), hshapes)]
    if probe:
      p0 = jax.tree.map(jnp.array, params)
      _, g, _ = prober(p0, probe_tx.init(p0), s, v, key)
      grads.append(_port_params(g))
      gcase['calls'].append(dict(params=_port_params(params), seeds=s,
                                 n_valid=v, u=u))
    params, opt, loss = step(params, opt, s, v, key)
    results.append((np.asarray(loss)[:1], _np_tree(params)))
    case['calls'].append(dict(kind='step', seeds=s, n_valid=v, u=u))
  s = rng.integers(0, n, (world, BS))
  key = jax.random.key(7)
  counts = step.eval_step(params, s, np.full(world, BS), key)
  results.append((counts, None))
  case['calls'].append(dict(kind='eval', seeds=s, n_valid=np.full(world, BS),
                            u=_stacked_draws(jax.random.split(key, world),
                                             hshapes)))
  ss = rng.integers(0, n, (2, world * BS))
  sv = np.full((2, world), BS)
  sv[1, -1] = BS - 2
  skeys = jnp.stack([jax.random.split(jax.random.key(50 + t), world)
                     for t in range(2)])
  params, opt, loss = step.superstep(params, opt, ss, sv, skeys)
  results.append((np.asarray(loss)[:, 0], _np_tree(params)))
  case['calls'].append(dict(kind='superstep', seeds=ss, n_valid=sv,
                            u=_stacked_draws(skeys, hshapes)))
  return case, results, ((gcase, grads) if probe else None)


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
  """Per world: the cases and the JAX results."""
  ei, feats, labels = _hetero_graph(np.random.default_rng(17))
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv('GLT_DEDUP', 'sort')
    mp.setenv('GLT_FUSED_HOP', '1')
    for world in WORLDS:
      out[world] = _world_cases(world, tmp_path_factory.mktemp(f'w{world}'),
                                ei, feats, labels)
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
      out[world] = torch_spmd_worker.spawn_ranks(
          worker.main, world, cases,
          str(tmp_path_factory.mktemp(f'ranks{world}')), JOIN_S)
  return out


def _eq(got, want, what):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)


@pytest.mark.parametrize('world', WORLDS)
def test_stores_match_jax(reference, port, world):
  want = reference[world][1]['stores']
  for rank, res in enumerate(port[world]):
    got = res['stores']
    assert sorted(map(str, got)) == sorted(map(str, want))
    for key, st in want.items():
      g = got[key]
      for f in worker.STORE_FIELDS:
        w = np.asarray(getattr(st, f))
        _eq(g[f], w if f == 'node_pb' else w[rank], f'{key} {f}')
      for f in ('max_rows', 'max_edges', 'max_degree', 'num_nodes'):
        assert g[f] == getattr(st, f), (key, f)


@pytest.mark.parametrize('world', WORLDS)
def test_dist_one_hop_matches_jax(reference, port, world):
  want = reference[world][1]['one_hop']
  assert want['mask'].any() and not want['mask'].all()
  for rank, res in enumerate(port[world]):
    for f in ('nbrs', 'mask', 'eids'):
      _eq(res['one_hop'][f], want[f][rank], f)


@pytest.mark.parametrize('world', WORLDS)
def test_dist_neighbor_sampler_matches_jax(reference, port, world):
  want = reference[world][1]['sample_homo']
  for rank, res in enumerate(port[world]):
    got = res['sample_homo']
    assert sorted(k for k in got if k != 'edge_hop_offsets') == sorted(want)
    for k, v in want.items():
      _eq(got[k], v[rank], k)


@pytest.mark.parametrize('world', WORLDS)
def test_dist_hetero_sampler_matches_jax(reference, port, world):
  want = reference[world][1]['sample_hetero']
  for rank, res in enumerate(port[world]):
    got = dict(res['sample_hetero'])
    assert got.pop('shapes') == _hetero_shapes(world, [3, 2, 2])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
      if isinstance(v, dict):
        assert sorted(map(str, got[k])) == sorted(map(str, v)), k
        for kk, vv in v.items():
          _eq(got[k][kk], vv[rank], f'{k}[{kk}]')
      else:
        _eq(got[k], v[rank], k)
    assert int(sum(m.sum() for m in got['edge_mask'].values())) > 0


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', ['lookup_float32_0', 'lookup_bfloat16_3'])
def test_dist_feature_lookup_matches_jax(reference, port, world, name):
  want = reference[world][1][name]
  for rank, res in enumerate(port[world]):
    for t, w in want.items():
      b = w.shape[0] // world
      _eq(res[name][t], w[rank * b:(rank + 1) * b], f'{name} {t}')
      assert np.abs(res[name][t]).sum() > 0


def _noise_grad(grad):
  """Per parameter, the elements whose gradient (JAX's mean over devices)
  is zero to rounding: below ``GRAD_ZERO``, where the smallest other here
  is ~2e-5. Adam's first step moves such an element by up to lr in the
  direction of its float noise, which differs between two correct
  programs. In an RGAT these are attention entries of softmax groups whose
  scores all keep one side of the leaky ReLU, where the destination term
  shifts every score alike."""
  return {k: np.abs(g) < GRAD_ZERO for k, g in grad.items()}


def _check_train(reference, port, world, name, param_calls=None,
                 left_out=None):
  """Losses and eval counts against JAX's, and the parameters after the
  calls ``param_calls`` (default: all), every element but those
  ``left_out`` marks."""
  want = reference[world][1][name]
  for rank, res in enumerate(port[world]):
    got = res[name]
    assert len(got) == len(want) == 5
    for i, ((wres, wparams), g) in enumerate(zip(want, got)):
      if wparams is None:       # the eval step's counts
        assert tuple(g['result']) == tuple(int(c) for c in wres), rank
        assert wres[1] == world * BS
        continue
      np.testing.assert_allclose(np.atleast_1d(g['result']), wres,
                                 rtol=LOSS_RTOL, err_msg=f'call {i}')
      if param_calls is not None and i not in param_calls:
        continue
      wp = rgnn_params_from_flax(wparams)
      assert sorted(g['params']) == sorted(wp)
      for k, v in wp.items():
        keep = (~left_out[k] if left_out is not None
                else np.ones(v.shape, bool))
        np.testing.assert_allclose(g['params'][k][keep], v.numpy()[keep],
                                   rtol=0, atol=PARAM_ATOL,
                                   err_msg=f'rank {rank} call {i} {k}')


@pytest.mark.parametrize('world', WORLDS)
def test_dist_hetero_train_matches_jax(reference, port, world):
  _check_train(reference, port, world, 'train')


@pytest.mark.parametrize('world', WORLDS)
def test_dist_hetero_rgat_train_matches_jax(reference, port, world):
  """The RGAT of the path on the card: each per-batch step's mean gradient
  at JAX's weights before it, every element; the losses of the three
  steps and the superstep and the eval counts; the weights after the first
  step, every element but those whose gradient is zero to rounding
  (``_noise_grad``: a whole parameter the loss does not reach, a few
  entries of one it does). After that the two runs hold different values
  in those entries (up to 1e-3 apart), which shifts some later gradients
  by ~1%, so later weights are held through the losses only."""
  want = reference[world][1]['train_rgat_grads']
  for rank, res in enumerate(port[world]):
    for t, (g, w) in enumerate(zip(res['train_rgat_grads'], want)):
      assert sorted(g) == sorted(w)
      for k, v in w.items():
        np.testing.assert_allclose(g[k], v, rtol=GRAD_RTOL, atol=GRAD_ZERO,
                                   err_msg=f'rank {rank} step {t} {k}')
  left_out = _noise_grad(want[0])
  reached = [m for m in left_out.values() if not m.all()]
  n_out = sum(int(m.sum()) for m in reached)
  assert n_out < 0.02 * sum(m.size for m in reached), n_out
  _check_train(reference, port, world, 'train_rgat', param_calls=(0,),
               left_out=left_out)


# -- the static-shape dedup ----------------------------------------------

def _unique_dedup(u_ids, u_labs, count, ids, valid):
  """The version ``sorted_hop_dedup_fused`` replaced: new ids ranked by
  ``torch.unique`` (a size read on the host), heads by a scatter-min."""
  m = ids.numel()
  x = torch.where(valid, ids.to(torch.int32),
                  torch.full_like(ids, BIG, dtype=torch.int32))
  seen_ids, order = torch.sort(u_ids.to(torch.int32))
  seen_labs = u_labs.to(torch.int32)[order]
  if seen_ids.numel():
    pos = torch.searchsorted(seen_ids, x).clamp(max=seen_ids.numel() - 1)
    found = valid & (seen_ids[pos] == x)
    seen_lab = seen_labs[pos]
  else:
    found = torch.zeros_like(valid)
    seen_lab = torch.full_like(x, -1)
  new_el = valid & ~found
  uniq = torch.unique(x[new_el])
  n_new = uniq.numel()
  rank = torch.searchsorted(uniq, x).clamp(max=max(n_new - 1, 0))
  iota = torch.arange(m)
  first = torch.full((n_new + 1,), m, dtype=torch.long)
  first.scatter_reduce_(0, torch.where(new_el, rank, n_new), iota, 'amin')
  new_head3 = new_el & (first[rank] == iota)
  labels3 = torch.where(found, seen_lab, torch.where(
      new_el, (count + rank).to(torch.int32),
      torch.full_like(x, -1))).to(torch.int32)
  new_count = torch.tensor(n_new, dtype=torch.int32)
  big = torch.full_like(x, BIG)
  return dict(
      labels3=labels3, new_head3=new_head3,
      u_ids2=torch.cat([u_ids.to(torch.int32), torch.where(new_head3, x, big)]),
      u_labs2=torch.cat([u_labs.to(torch.int32),
                         torch.where(new_head3, labels3, big)]),
      count2=(count + new_count).to(torch.int32), new_count=new_count)


def _dedup_case(rng, c, m, kind):
  seen = rng.choice(200, c, replace=False)
  pad = rng.integers(0, 4)
  u_ids = torch.tensor(np.concatenate([seen, np.full(pad, BIG)]),
                       dtype=torch.int32)
  u_labs = torch.tensor(np.concatenate([rng.permutation(c),
                                        np.full(pad, BIG)]),
                        dtype=torch.int32)
  if kind == 'all_seen' and c:
    ids = rng.choice(seen, m)
  else:
    ids = rng.integers(0, 200, m)
  valid = rng.random(m) > 0.25
  if kind == 'empty_hop':
    valid[:] = False
  return (u_ids, u_labs, torch.tensor(c, dtype=torch.int32),
          torch.tensor(ids, dtype=torch.int32), torch.tensor(valid))


@pytest.mark.parametrize('kind', ['random', 'empty_hop', 'all_seen',
                                  'no_lanes'])
def test_static_dedup_equals_the_unique_version(kind):
  rng = np.random.default_rng(hash(kind) % 1000)
  for trial in range(60):
    c = int(rng.integers(0, 30)) if kind != 'all_seen' else \
        int(rng.integers(1, 30))
    m = 0 if kind == 'no_lanes' else int(rng.integers(1, 80))
    args = _dedup_case(rng, c, m, kind)
    got, want = sorted_hop_dedup_fused(*args), _unique_dedup(*args)
    assert sorted(got) == sorted(want)
    for k in want:
      assert got[k].dtype == want[k].dtype, k
      assert torch.equal(got[k], want[k]), (kind, trial, k)
    if kind in ('empty_hop', 'all_seen', 'no_lanes'):
      assert int(got['new_count']) == 0


# -- MLLOG, the example ---------------------------------------------------

def test_mllogger_lines_match_jax():
  lines = {'jax': [], 'port': []}
  for side, cls in (('jax', JaxMLLogger), ('port', MLLogger)):
    log = cls(emit=lines[side].append)
    log.submission_info(platform='h100')
    log.init_start()
    log.event('global_batch_size', 64)
    log.init_stop()
    log.run_start()
    log.epoch_start(0)
    log.eval_start(0)
    log.eval_accuracy(0.25, 0)
    log.eval_stop(0)
    log.epoch_stop(0)
    log.run_stop(epoch=0)
  assert len(lines['port']) == len(lines['jax']) == 16

  def strip(line):
    assert line.startswith(':::MLLOG ')
    rec = json.loads(line[len(':::MLLOG '):])
    assert isinstance(rec.pop('time_ms'), int)
    return rec
  assert [strip(x) for x in lines['port']] == [strip(x) for x in lines['jax']]


@pytest.mark.parametrize('schedule', ['constant', 'cosine', 'linear'])
@pytest.mark.parametrize('warm', [0, 3])
def test_lr_schedule_matches_optax(schedule, warm):
  from glt_tpu_torch.examples.igbh.dist_train_rgnn import lr_lambda
  lr, total = 1e-3, 12
  if schedule == 'cosine':
    sched = optax.warmup_cosine_decay_schedule(
        0.0 if warm else lr, lr, warm, total, end_value=lr * 0.01)
  elif schedule == 'linear':
    body = optax.linear_schedule(lr, lr * 0.01, max(total - warm, 1))
    sched = (optax.join_schedules([optax.linear_schedule(0.0, lr, warm),
                                   body], [warm]) if warm else body)
  else:
    sched = optax.linear_schedule(0.0, lr, warm) if warm else (lambda n: lr)
  f = lr_lambda(schedule, warm, total)
  for n in range(total + 3):
    np.testing.assert_allclose(lr * f(n), float(sched(n)), rtol=1e-5,
                               atol=1e-12, err_msg=f'step {n}')


def test_igbh_example_end_to_end(capsys):
  from glt_tpu_torch.examples.igbh import dist_train_rgnn
  res = dist_train_rgnn.main(
      ['--device', 'cpu', '--papers', '2000', '--steps-per-epoch', '4',
       '--batch-size', '8', '--fanout', '3,2', '--hidden', '16',
       '--val-batches', '2', '--lr-schedule', 'cosine',
       '--lr-warmup-steps', '2', '--mlperf', '--epochs', '2'])
  out = capsys.readouterr().out
  assert res['steps'] == 8 and len(res['accs']) == 2
  assert all(np.isfinite(res['losses'])) and 0 <= res['accs'][-1] <= 1
  keys = [json.loads(x[len(':::MLLOG '):])['key']
          for x in out.splitlines() if x.startswith(':::MLLOG ')]
  assert keys[0] == 'submission_benchmark' and keys[-1] == 'run_stop'
  assert keys.count('eval_accuracy') == 2


# -- port-only surfaces ---------------------------------------------------

@pytest.fixture(scope='module')
def one_rank(tmp_path_factory):
  """A one-part layout (the port's partitioner) and a trainer over it."""
  from glt_tpu_torch.distributed import (DistHeteroNeighborSampler,
                                         DistHeteroTrainStep)
  from glt_tpu_torch.models import RGNN
  root = str(tmp_path_factory.mktemp('one_rank'))
  labels = worker.card_layout(root, 1)
  mesh = make_mesh(device='cpu')
  dg = worker.DistHeteroGraph.from_dataset_partitions(mesh, root)
  feats = worker._features(mesh, root)
  keys = DistHeteroNeighborSampler(dg, FANOUTS).message_passing_types(
      BS, 'paper')
  torch.manual_seed(0)
  model = RGNN(keys, worker.CARD_DIM, HIDDEN, worker.CARD_CLASSES,
               num_layers=len(FANOUTS), conv='rgat', heads=HEADS,
               node_types=list(dg.node_counts))
  return DistHeteroTrainStep(dg, feats, model, {'paper': labels}, FANOUTS,
                             BS, 'paper')


def test_hetero_many_equals_single_calls(one_rank):
  from glt_tpu_torch.ops.pipeline import (multihop_sample_hetero_many,
                                          multihop_sample_hetero_sorted)
  s = one_rank.sampler
  core, caps, budgets, etypes = s._make_device_core(BS, 'paper')
  trav = {e: s._trav()[e] for e in etypes}
  t, gen = 3, torch.Generator().manual_seed(2)
  seeds = torch.randint(0, 4000, (t, BS), generator=gen, dtype=torch.int32)
  nv = torch.tensor([BS, BS - 1, 1], dtype=torch.int32)
  u = [[torch.rand((t,) + shape, generator=gen) for shape in hop]
       for hop in s.uniform_shapes(BS, 'paper')]
  args = (s._one_hops, trav, s.num_neighbors, s.num_hops, caps, budgets)
  many = multihop_sample_hetero_many(*args, {'paper': seeds},
                                     {'paper': nv}, u)
  for i in range(t):
    one = multihop_sample_hetero_sorted(
        *args, {'paper': seeds[i]}, {'paper': nv[i]},
        [[x[i] for x in hop] for hop in u])
    for k, v in one.items():
      for kk, vv in v.items():
        assert torch.equal(many[k][kk][i], vv), (i, k, kk)


def test_dummy_batch_and_init_params(one_rank):
  step = one_rank
  batch = step.dummy_batch()
  assert set(batch.row_dict) == set(step.sampler.message_passing_types(
      BS, 'paper'))
  with torch.no_grad():
    assert step.model(batch).shape == (BS, worker.CARD_CLASSES)
  a = step.init_params(3)
  b = step.init_params(3)
  assert all(torch.equal(a[k], b[k]) for k in a)
  assert not all(torch.equal(a[k], v) for k, v in step.init_params(4).items())
  got = step.model.state_dict()
  assert all(torch.equal(got[k], v) for k, v in step.init_params(5).items())
