"""The partitioned sampler's weighted and full-neighbourhood hops against
the JAX package's at world sizes 1 and 2, over the same weighted partition
layouts on disk (written by the JAX RandomPartitioner, float32 weights on
every edge type, some of them 0):

- ``DistNeighborSampler(with_weight=True)`` with weighted and ``-1``
  fanouts and ``DistHeteroNeighborSampler(with_weight=True)`` with a
  weighted and a ``-1`` hop, each with and without edge ids: nodes, rows,
  cols, masks and counts bit-identical to JAX's sampler with edge ids;
  edge ids equal on every valid lane and -1 on the masked ones (JAX's
  masked weighted lanes carry what its ``top_k`` put in its tied ``-inf``
  slots, a full window's what its clip read); the draw shapes and
  resolved fanouts as JAX resolves them;
- ``DistHeteroTrainStep(with_weight=True, edge_features=...)`` (an RSAGE
  over the same weighted and ``-1`` hops): losses and parameters within
  1e-5 of JAX's after three Adam steps, each batch's ``edge_attr_dict``
  bit-equal to JAX's edge store's rows of JAX's sampled edges; a weighted
  superstep of two batches within 1e-5 of the per-batch calls (world 1).

The port's uniforms are the draws a JAX device makes when it serves a hop
(``fold_in(sub, d)`` of device d's hop key): a uniform hop's ``uniform(k,
(fanout, world * F)).T``, a weighted hop's ``uniform(k, (world * F, W),
1e-20, 1)``, nothing for a full hop. The JAX side runs with ``GLT_DEDUP=sort
GLT_FUSED_HOP=1``; world 2 of the port in two gloo ranks
(tests/torch_dist_worker.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

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
from glt_tpu.models import RGNN as JaxRGNN
from glt_tpu.parallel import make_mesh as jax_make_mesh
from glt_tpu.partition import RandomPartitioner as JaxRandomPartitioner
from glt_tpu.typing import reverse_edge_type
from glt_tpu_torch.parallel import make_mesh
from test_torch_dist_hetero import _port_params

WORLDS = (1, 2)
NODES = {'paper': 60, 'author': 30}
BS, DIM, HIDDEN, CLASSES, LR, EDIM = 4, 8, 8, 4, 1e-2, 3
PARAM_ATOL = LOSS_RTOL = 1e-5
JOIN_S = 240
CITES = ('paper', 'cites', 'paper')
WRITES = ('author', 'writes', 'paper')
EDGE_TYPES = (CITES, WRITES)       # the trainer's edge stores
HOMO = {'weighted': [3, 2], 'full': [-1, -1]}
FANOUTS = [3, -1]                  # the hetero sampler's and trainer's


def weighted_graph(rng):
  """Papers citing papers and authors writing papers (and the reverse),
  float32 weights in (0, 1] on every edge type (a sixth of them 0), edge
  features on two types, node features and learnable labels."""
  p, a = NODES['paper'], NODES['author']
  ei = {CITES: np.stack([rng.integers(0, p, 4 * p),
                         rng.integers(0, p, 4 * p)]),
        WRITES: np.stack([rng.integers(0, a, 2 * p),
                          rng.integers(0, p, 2 * p)])}
  ei[('paper', 'rev_writes', 'author')] = ei[WRITES][::-1].copy()
  weights, efeats = {}, {}
  for e, x in ei.items():
    w = rng.uniform(0.05, 1.0, x.shape[1]).astype(np.float32)
    w[rng.random(x.shape[1]) < 1 / 6] = 0.0
    weights[e] = w
    if e in EDGE_TYPES:
      efeats[e] = rng.normal(size=(x.shape[1], EDIM)).astype(np.float32)
  feats = {t: rng.normal(size=(n, DIM)).astype(np.float32)
           for t, n in NODES.items()}
  w = rng.normal(size=(DIM, CLASSES)).astype(np.float32)
  labels = np.argmax(feats['paper'] @ w, 1).astype(np.int32)
  return ei, weights, feats, efeats, labels


def _hop_draw(sub, d, shape):
  """Device d's draw of one hop or segment: ``('u', S, k)`` a uniform
  hop's, ``('w', S, W)`` a weighted one's, None a full one's."""
  if shape is None:
    return None
  kind, s, k = shape
  key = jax.random.fold_in(sub, d)
  if kind == 'w':
    return np.asarray(jax.random.uniform(key, (s, k), minval=1e-20,
                                         maxval=1.0))
  return np.asarray(jax.random.uniform(key, (k, s)).T)


def stacked_draws(keys, shapes):
  """Per hop and segment ``[world, S, ...]`` (None for a full hop): the
  draws of the JAX devices whose keys are ``keys [world]``, each folding
  its key by its index and splitting it once a segment."""
  world = keys.shape[0]
  per = []
  for d in range(world):
    key = jax.random.fold_in(keys[d], d)
    hops = []
    for hop in shapes:
      us = []
      for shape in hop:
        key, sub = jax.random.split(key)
        us.append(_hop_draw(sub, d, shape))
      hops.append(us)
    per.append(hops)
  return [[None if per[0][h][i] is None
           else np.stack([p[h][i] for p in per])
           for i in range(len(shapes[h]))] for h in range(len(shapes))]


def homo_shapes(sampler, world, bs):
  """Per hop the one segment of a JAX DistNeighborSampler's walk."""
  shapes, f = [], bs
  for k in sampler.num_neighbors:
    if k < 0:
      shapes.append([None])
    elif sampler.with_weight:
      shapes.append([('w', world * f, max(sampler.max_weighted_degree, k))])
    else:
      shapes.append([('u', world * f, k)])
    f *= abs(k)
  return shapes


def hetero_shapes(sampler, world, bs):
  """Per hop the segments of a JAX DistHeteroNeighborSampler's walk from
  papers, in its loop's order."""
  caps, _ = sampler._caps(bs, 'paper')
  shapes = []
  for h in range(sampler.num_hops):
    hop = []
    for e, (row_t, _) in sampler._trav().items():
      k = sampler.num_neighbors[e][h]
      if not caps[h][row_t] or not k:
        continue
      s = world * caps[h][row_t]
      if k < 0:
        hop.append(None)
      elif sampler.with_weight:
        w = sampler.max_weighted_degree or sampler.g.graphs[e].max_degree
        hop.append(('w', s, max(w, k)))
      else:
        hop.append(('u', s, k))
    shapes.append(hop)
  return shapes


def _as_port_shapes(shapes):
  return [[None if s is None else (s[1], s[2]) for s in hop]
          for hop in shapes]


def _tree(out):
  return {k: (_tree(v) if isinstance(v, dict) else np.asarray(v))
          for k, v in out.items() if k not in ('edge_hop_offsets',
                                               'input_type')}


def _layouts(world, tmp, graph):
  ei, weights, feats, efeats, _ = graph
  hroot, oroot = str(tmp / 'hetero'), str(tmp / 'homo')
  JaxRandomPartitioner(hroot, num_parts=world, num_nodes=NODES,
                       edge_index=ei, edge_weights=weights, node_feat=feats,
                       edge_feat=efeats, seed=3).partition()
  JaxRandomPartitioner(oroot, num_parts=world, num_nodes=NODES['paper'],
                       edge_index=ei[CITES], edge_weights=weights[CITES],
                       node_feat=feats['paper'], seed=4).partition()
  return hroot, oroot


def _draw_cases(kind, root, seeds, nv, key, shapes, **kw):
  """The port's case with and without edge ids, on the draws of JAX's
  devices for ``key``."""
  world = seeds.shape[0]
  u = stacked_draws(jax.random.split(key, world), shapes)
  if kind == 'wsample_homo':
    u = [h[0] for h in u]
  return {e: dict(kind=kind, root=root, seeds=seeds, n_valid=nv, u=u,
                  with_edge=e, **kw) for e in (True, False)}


def _world_cases(world, tmp, graph):
  """The cases of one world and the JAX results they are held to: the
  homogeneous and the hetero samplers (JAX's with edge ids), then JAX's
  weighted DistHeteroTrainStep with edge stores over three steps and, for
  each of its batches, JAX's edge rows of the batch's edges (from the
  hetero sampler, whose draws for a key are the step's)."""
  rng = np.random.default_rng(80 + world)
  hroot, oroot = _layouts(world, tmp, graph)
  mesh = jax_make_mesh(world)
  hg = JaxDistGraph.from_dataset_partitions(mesh, oroot)
  dg = JaxDistHeteroGraph.from_dataset_partitions(mesh, hroot)
  assert hg.edge_weights is not None
  assert all(st.edge_weights is not None for st in dg.graphs.values())
  cases, want = {}, {}
  n = NODES['paper']
  for i, (name, fanouts) in enumerate(HOMO.items()):
    seeds = rng.integers(0, n, (world, BS))
    nv = np.full(world, BS)
    nv[-1] = BS - 1
    key = jax.random.key(20 + 10 * world + i)
    s = JaxDistNeighborSampler(hg, fanouts, with_edge=True,
                               with_weight=True, seed=0)
    assert s.with_weight
    shapes = homo_shapes(s, world, BS)
    want[f'homo_{name}'] = dict(
        _tree(s.sample_from_nodes(seeds, nv, key=key)),
        shapes=[h[0] for h in _as_port_shapes(shapes)],
        fanouts=list(s.num_neighbors))
    for e, case in _draw_cases('wsample_homo', oroot, seeds, nv, key,
                               shapes, fanouts=fanouts).items():
      cases[f'homo_{name}_{e}'] = case
  sampler = JaxDistHeteroNeighborSampler(dg, FANOUTS, with_edge=True,
                                         with_weight=True, seed=0)
  assert sampler.with_weight
  shapes = hetero_shapes(sampler, world, BS)
  seeds = rng.integers(0, n, (world, BS))
  nv = np.full(world, BS)
  nv[0] = BS - 1
  key = jax.random.key(60 + world)
  want['hetero'] = dict(
      _tree(sampler.sample_from_nodes('paper', seeds, nv, key=key)),
      shapes=_as_port_shapes(shapes))
  for e, case in _draw_cases('wsample_hetero', hroot, seeds, nv, key,
                             shapes, fanouts=FANOUTS,
                             with_weight=True).items():
    cases[f'hetero_{e}'] = case

  dss = [JaxDistDataset().load(hroot, p) for p in range(world)]
  jfeats = {t: JaxDistFeature.from_dist_datasets(mesh, dss, ntype=t)
            for t in NODES}
  edfs = {e: JaxDistFeature.from_dist_datasets(mesh, dss, ntype=e,
                                               kind='edge')
          for e in EDGE_TYPES}
  model = JaxRGNN(edge_types=[reverse_edge_type(e) for e in dg.graphs],
                  hidden_features=HIDDEN, out_features=CLASSES,
                  num_layers=len(FANOUTS), conv='rsage')
  tx = optax.adam(LR)
  step = JaxDistHeteroTrainStep(dg, jfeats, model, tx, {'paper': graph[4]},
                                FANOUTS, batch_size_per_device=BS,
                                seed_type='paper', seed=0,
                                edge_features=edfs, with_weight=True)
  assert step.sampler.with_weight
  # flax init and the optimizer state jitted and placed as the step's
  # outputs are, so that neither the init nor a second step compiles again
  rep = NamedSharding(mesh, P())
  params = jax.device_put(jax.jit(model.init)(jax.random.key(0),
                                              step.dummy_batch()), rep)
  opt = jax.device_put(tx.init(params), rep)
  train = dict(kind='wtrain', root=hroot, params=_port_params(params),
               in_dim=DIM, hidden=HIDDEN, classes=CLASSES, fanouts=FANOUTS,
               bs=BS, lr=LR, labels=graph[4], edge_types=list(EDGE_TYPES),
               calls=[])
  results = []
  for t in range(3):
    s = rng.integers(0, n, (world, BS))
    v = np.full(world, BS)
    v[0] = BS - t % 2
    key = jax.random.key(300 * world + t)
    out = sampler.sample_from_nodes('paper', s, v, key=key)
    attrs = {}
    for e in EDGE_TYPES:
      k = reverse_edge_type(e)
      eids, em = np.asarray(out['edge'][k]), np.asarray(out['edge_mask'][k])
      rows = edfs[e].lookup(np.maximum(eids, 0).reshape(-1),
                            jnp.asarray(em.reshape(-1)))
      attrs[k] = (eids, em, np.asarray(rows).reshape(eids.shape + (-1,)))
    params, opt, loss = step(params, opt, s, v, key)
    results.append(dict(loss=np.asarray(loss)[:1],
                        params=_port_params(params), attrs=attrs))
    train['calls'].append(dict(seeds=s, n_valid=v,
                               u=stacked_draws(jax.random.split(key, world),
                                               shapes)))
  cases['train'], want['train'] = train, results
  if world == 1:
    # a window of two batches on fresh uniforms in (0, 1)
    u = [[None if sh is None else rng.uniform(
        1e-3, 1.0, (2, world, sh[1], sh[2])).astype(np.float32)
        for sh in hop] for hop in shapes]
    cases['super'] = dict(train, kind='wsuper', window=dict(
        seeds=rng.integers(0, n, (2, world * BS)),
        n_valid=np.array([[BS], [BS - 1]]), u=u))
  return cases, want


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
  """Per world: the cases and the JAX results."""
  graph = weighted_graph(np.random.default_rng(31))
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv('GLT_DEDUP', 'sort')
    mp.setenv('GLT_FUSED_HOP', '1')
    for world in WORLDS:
      out[world] = _world_cases(world, tmp_path_factory.mktemp(f'w{world}'),
                                graph)
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


def _check_edges(got, want, mask, what):
  """Edge ids equal to JAX's on the valid lanes, -1 on the others."""
  got, want, mask = np.asarray(got), np.asarray(want), np.asarray(mask)
  assert got.shape == want.shape == mask.shape, what
  _eq(got[mask], want[mask], what)
  assert (got[~mask] == -1).all(), what
  assert (got[mask] >= 0).all(), what


def _check_sample(got, want, rank, with_edge):
  """Every field of JAX's output (edge ids given ``with_edge``) at
  ``rank``."""
  got = dict(got)
  keys = {k for k in want if k not in ('shapes', 'fanouts')}
  if not with_edge:
    keys.discard('edge')
  assert set(got) == keys
  for k in keys:
    v = want[k]
    if isinstance(v, dict):
      assert sorted(map(str, got[k])) == sorted(map(str, v)), k
      for kk, vv in v.items():
        if k == 'edge':
          _check_edges(got[k][kk], vv[rank], got['edge_mask'][kk],
                       f'{k}[{kk}]')
        else:
          _eq(got[k][kk], vv[rank], f'{k}[{kk}]')
    elif k == 'edge':
      _check_edges(got[k], v[rank], got['edge_mask'], k)
    else:
      _eq(got[k], v[rank], k)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('with_edge', [True, False])
@pytest.mark.parametrize('name', list(HOMO))
def test_homo_weighted_and_full_hops_match_jax(reference, port, world,
                                               with_edge, name):
  want = reference[world][1][f'homo_{name}']
  for rank, res in enumerate(port[world]):
    got = dict(res[f'homo_{name}_{with_edge}'])
    assert [None if s is None else tuple(s)
            for s in got.pop('shapes')] == want['shapes']
    assert got.pop('fanouts') == want['fanouts']
    _check_sample(got, want, rank, with_edge)
    em = got['edge_mask']
    assert em.any() and not em.all()


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('with_edge', [True, False])
def test_hetero_weighted_and_full_hops_match_jax(reference, port, world,
                                                 with_edge):
  want = reference[world][1]['hetero']
  for rank, res in enumerate(port[world]):
    got = dict(res[f'hetero_{with_edge}'])
    assert [[None if s is None else tuple(s) for s in hop]
            for hop in got.pop('shapes')] == want['shapes']
    _check_sample(got, want, rank, with_edge)
    assert int(sum(m.sum() for m in got['edge_mask'].values())) > 0


@pytest.mark.parametrize('world', WORLDS)
def test_weighted_hetero_train_step_with_edge_stores_matches_jax(
    reference, port, world):
  want = reference[world][1]['train']
  for rank, res in enumerate(port[world]):
    got = res['train']
    assert len(got) == len(want) == 3
    for i, (w, g) in enumerate(zip(want, got)):
      np.testing.assert_allclose(np.atleast_1d(g['result']), w['loss'],
                                 rtol=LOSS_RTOL, err_msg=f'call {i}')
      assert sorted(g['params']) == sorted(w['params'])
      for k, v in w['params'].items():
        np.testing.assert_allclose(g['params'][k], v, rtol=0,
                                   atol=PARAM_ATOL,
                                   err_msg=f'rank {rank} call {i} {k}')
      assert sorted(map(str, g['edge_attr'])) == sorted(
          map(str, w['attrs']))
      for k, (eids, em, rows) in w['attrs'].items():
        _eq(g['edge_mask'][k], em[rank], f'call {i} mask {k}')
        _check_edges(g['edge'][k], eids[rank], em[rank], f'call {i} {k}')
        _eq(g['edge_attr'][k], rows[rank], f'call {i} edge_attr {k}')
        assert np.abs(g['edge_attr'][k][em[rank]]).sum() > 0


def test_weighted_superstep_equals_per_batch_calls(port):
  res = port[1][0]['super']
  np.testing.assert_allclose(res['got'], np.concatenate(
      [np.atleast_1d(x) for x in res['want']]), rtol=1e-5, atol=1e-6)
  for k, v in res['b'].items():
    np.testing.assert_allclose(res['a'][k], v, rtol=0, atol=1e-5,
                               err_msg=k)
