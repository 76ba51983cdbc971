"""The partition hot cache against the JAX package's:

- ``neighbor_probs`` (full and positive fanouts, a padded tail) and
  ``NeighborSampler.sample_prob``, homogeneous and hetero: within 1e-6 of
  JAX's;
- ``FrequencyPartitioner`` with ``cache_ratio`` (homogeneous and hetero)
  and with ``cache_memory_budget``, and ``build_partition_feature``: the
  same files as JAX's writes, byte for byte (each ``.npy`` whole, each
  ``.npz`` member's bytes: a zip entry also carries its write time);
- ``DistDataset.load`` of a cached layout: the cached rows first, then
  the owned rows, ``id2index`` and the rewritten feature book equal to
  JAX's; a ``DistFeature`` lookup over it at world sizes 1 and 2 equal to
  JAX's rows, and no cached id requested from the other rank;
- ``DistTrainStep`` over the cached frequency layout at world 2: losses
  and parameters within 1e-5 of JAX's after three Adam steps.

World 2 of the port runs in two gloo ranks (tests/torch_dist_worker.py);
the JAX side with ``GLT_DEDUP=sort GLT_FUSED_HOP=1``.
"""
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.distributed import DistDataset as JaxDistDataset
from glt_tpu.distributed import DistFeature as JaxDistFeature
from glt_tpu.distributed import DistGraph as JaxDistGraph
from glt_tpu.ops.sample import neighbor_probs as jax_neighbor_probs
from glt_tpu.parallel import make_mesh as jax_make_mesh
from glt_tpu.partition import FrequencyPartitioner as JaxFrequencyPartitioner
from glt_tpu.partition import RandomPartitioner as JaxRandomPartitioner
from glt_tpu.partition import (build_partition_feature as
                               jax_build_partition_feature)
from glt_tpu.sampler import NeighborSampler as JaxNeighborSampler
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.distributed import DistDataset
from glt_tpu_torch.ops.sample import neighbor_probs
from glt_tpu_torch.parallel import make_mesh
from glt_tpu_torch.partition import (FrequencyPartitioner,
                                     build_partition_feature)
from glt_tpu_torch.sampler import NeighborSampler
from test_torch_dist_homo import N, homo_graph, run_port
from test_torch_dist_train import _train_case

PROB_TOL = 1e-6
FANOUTS = [3, 2]
CACHE_RATIO = 0.2
HETERO_NODES = {'paper': 50, 'author': 30}


def _hetero_graph(rng):
  p, a = HETERO_NODES['paper'], HETERO_NODES['author']
  ei = {('paper', 'cites', 'paper'): np.stack(
            [rng.integers(0, p, 3 * p), rng.integers(0, p, 3 * p)]),
        ('author', 'writes', 'paper'): np.stack(
            [rng.integers(0, a, 2 * p), rng.integers(0, p, 2 * p)])}
  ei[('paper', 'rev_writes', 'author')] = ei[
      ('author', 'writes', 'paper')][::-1].copy()
  feats = {t: rng.normal(size=(n, 5)).astype(np.float32)
           for t, n in HETERO_NODES.items()}
  return ei, feats


def _halves(rng, n):
  """Two disjoint seed sets: the halves of a shuffled training split."""
  ids = rng.permutation(n)[:n // 2]
  return ids[:ids.size // 2], ids[ids.size // 2:]


def _port_sampler(ei, fanouts, num_nodes):
  ds = Dataset().init_graph(ei, num_nodes=num_nodes, device='cpu')
  return NeighborSampler(ds.graph, fanouts, device='cpu')


def _jax_sampler(ei, fanouts, num_nodes):
  ds = JaxDataset().init_graph(edge_index=ei, num_nodes=num_nodes)
  return JaxNeighborSampler(ds.graph, fanouts, seed=0)


@pytest.mark.parametrize('fanout', [3, 1, -1])
def test_neighbor_probs_matches_jax(fanout):
  rng = np.random.default_rng(2)
  n, e = 40, 160
  ind = rng.integers(0, n, e).astype(np.int32)
  indptr = np.concatenate([[0], np.cumsum(rng.multinomial(
      e, np.ones(n) / n))]).astype(np.int32)
  # a padded tail past the live edges adds nothing (-1 sentinels)
  padded = np.concatenate([ind, np.full(7, -1, np.int32)])
  p = rng.random(n).astype(np.float32)
  p[rng.random(n) < 0.3] = 0.0
  want = np.asarray(jax_neighbor_probs(jnp.asarray(indptr),
                                       jnp.asarray(padded), jnp.asarray(p),
                                       fanout, n))
  got = neighbor_probs(torch.as_tensor(indptr), torch.as_tensor(padded),
                       torch.as_tensor(p), fanout, n).numpy()
  assert got.dtype == np.float32 and got.shape == (n,)
  np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)
  assert (got > 0).any() and got.max() <= 1.0


@pytest.mark.parametrize('fanouts', [[3, 2], [2, -1]])
def test_homo_sample_prob_matches_jax(fanouts):
  ei, _, _, _ = homo_graph(np.random.default_rng(5))
  seeds = _halves(np.random.default_rng(6), N)[0]
  want = np.asarray(_jax_sampler(ei, fanouts, N).sample_prob(seeds, N))
  got = _port_sampler(ei, fanouts, N).sample_prob(seeds, N).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)
  assert (got[seeds] == 1.0).all() and 0 < (got > 0).sum() < N


def test_hetero_sample_prob_matches_jax():
  ei, _ = _hetero_graph(np.random.default_rng(7))
  seeds = _halves(np.random.default_rng(8), HETERO_NODES['paper'])[0]
  want = _jax_sampler(ei, FANOUTS, HETERO_NODES).sample_prob(
      ('paper', seeds))
  got = _port_sampler(ei, FANOUTS, HETERO_NODES).sample_prob(
      ('paper', seeds))
  assert sorted(got) == sorted(want)
  for t, v in want.items():
    np.testing.assert_allclose(got[t].numpy(), np.asarray(v), rtol=0,
                               atol=PROB_TOL, err_msg=t)
    assert got[t].numpy().sum() > 0


def _payloads(root):
  """Every file of a layout: a ``.npy``'s bytes, each ``.npz`` member's
  bytes by name, a ``.json``'s object."""
  out = {}
  for d, _, names in os.walk(root):
    for name in names:
      path = os.path.join(d, name)
      rel = os.path.relpath(path, root)
      if name.endswith('.npz'):
        with zipfile.ZipFile(path) as z:
          out[rel] = {m: z.read(m) for m in z.namelist()}
      elif name.endswith('.json'):
        with open(path) as f:
          out[rel] = json.load(f)
      else:
        with open(path, 'rb') as f:
          out[rel] = f.read()
  return out


def _same_files(a, b):
  fa, fb = _payloads(a), _payloads(b)
  assert sorted(fa) == sorted(fb)
  for rel, v in fa.items():
    assert fb[rel] == v, rel
  return fa


def _homo_probs(ei, fanouts=FANOUTS):
  """Per partition the access probabilities of one half of the training
  seeds, through the port's sampler."""
  s = _port_sampler(ei, fanouts, N)
  return np.stack([s.sample_prob(h, N).numpy()
                   for h in _halves(np.random.default_rng(9), N)])


CACHES = {'ratio': dict(cache_ratio=CACHE_RATIO),
          'budget': dict(cache_memory_budget=f'{8 * 4 * 7}'),
          'both': dict(cache_ratio=CACHE_RATIO, cache_memory_budget='0.1k')}


@pytest.mark.parametrize('cache', list(CACHES))
def test_frequency_partitioner_writes_jax_files(tmp_path, cache):
  ei, feats, _, _ = homo_graph(np.random.default_rng(10))
  probs = _homo_probs(ei)
  roots = [str(tmp_path / side) for side in ('jax', 'port')]
  for root, cls in zip(roots, (JaxFrequencyPartitioner,
                               FrequencyPartitioner)):
    cls(root, num_parts=2, num_nodes=N, edge_index=ei, node_feat=feats,
        probs=probs, chunk_size=16, **CACHES[cache]).partition()
  files = _same_files(*roots)
  cached = [files[f'part{p}/node_feat/data.npz'].get('cache_ids.npy')
            for p in range(2)]
  assert all(c is not None for c in cached)


def test_hetero_frequency_partitioner_writes_jax_files(tmp_path):
  ei, feats = _hetero_graph(np.random.default_rng(11))
  s = _port_sampler(ei, FANOUTS, HETERO_NODES)
  halves = _halves(np.random.default_rng(12), HETERO_NODES['paper'])
  per = [s.sample_prob(('paper', h)) for h in halves]
  probs = {t: np.stack([p[t].numpy() for p in per]) for t in HETERO_NODES}
  roots = [str(tmp_path / side) for side in ('jax', 'port')]
  for root, cls in zip(roots, (JaxFrequencyPartitioner,
                               FrequencyPartitioner)):
    cls(root, num_parts=2, num_nodes=HETERO_NODES, edge_index=ei,
        node_feat=feats, probs=probs, cache_ratio=CACHE_RATIO,
        chunk_size=16).partition()
  files = _same_files(*roots)
  assert 'cache_ids.npy' in files['part1/node_feat/author.npz']


def test_build_partition_feature_writes_jax_files(tmp_path):
  ei, feats, _, _ = homo_graph(np.random.default_rng(13))
  probs = _homo_probs(ei)[0]
  roots = [str(tmp_path / side) for side in ('jax', 'port')]
  for root, build in zip(roots, (jax_build_partition_feature,
                                 build_partition_feature)):
    JaxRandomPartitioner(root, num_parts=2, num_nodes=N, edge_index=ei,
                         seed=2).partition()
    build(root, feats, cache_probs=probs, cache_ratio=CACHE_RATIO)
  files = _same_files(*roots)
  assert 'cache_ids.npy' in files['part1/node_feat/data.npz']


# -- the cached layout, loaded and trained over ------------------------------

def _cached_layout(root, world, ei, feats, efeats):
  probs = _homo_probs(ei)
  probs = np.concatenate([probs] * (world // 2) or [probs[:1]])
  JaxFrequencyPartitioner(root, num_parts=world, num_nodes=N, edge_index=ei,
                          node_feat=feats, edge_feat=efeats, probs=probs,
                          cache_ratio=CACHE_RATIO).partition()


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
  """Per world: the cases and the JAX results over a cached frequency
  layout (one part at world 1: probabilities of one half, nothing to
  cache; two at world 2)."""
  ei, feats, efeats, labels = homo_graph(np.random.default_rng(23))
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv('GLT_DEDUP', 'sort')
    mp.setenv('GLT_FUSED_HOP', '1')
    for world in (1, 2):
      root = str(tmp_path_factory.mktemp(f'cache{world}') / 'layout')
      _cached_layout(root, world, ei, feats, efeats)
      mesh = jax_make_mesh(world)
      dss = [JaxDistDataset().load(root, p) for p in range(world)]
      store = JaxDistFeature.from_dist_datasets(mesh, dss)
      rng = np.random.default_rng(40 + world)
      ids = np.tile(np.arange(N), world)
      valid = rng.random(world * N) > 0.1
      cases = {'lookup': dict(kind='cache_lookup', root=root, ids=ids,
                              valid=valid)}
      want = {'lookup': np.asarray(store.lookup(ids, jnp.asarray(valid))),
              'datasets': [dict(
                  table=np.asarray(ds.node_features.device_part),
                  id2index=np.asarray(ds.node_features._id2index),
                  book=ds.get_node_feat_pb().table.copy()) for ds in dss]}
      if world == 2:
        hg = JaxDistGraph.from_dataset_partitions(mesh, root)
        cases['train'], want['train'] = _train_case(
            world, rng, hg, {'node': store}, labels, root, 'sage', None)
      out[world] = cases, want
  return out


@pytest.fixture(scope='module')
def port(reference, tmp_path_factory):
  return run_port(reference, tmp_path_factory)


@pytest.mark.parametrize('world', (1, 2))
def test_cached_partition_loads_as_jax(reference, world):
  """Each partition's table holds its cached rows, then its owned rows;
  ``id2index`` maps every one of them; the feature book routes the cached
  ids to the partition; all equal to JAX's load."""
  root = reference[world][0]['lookup']['root']
  for p, want in enumerate(reference[world][1]['datasets']):
    ds = DistDataset.load(root, p, device='cpu')
    f = ds.get_node_feature()
    z = np.load(os.path.join(root, f'part{p}', 'node_feat', 'data.npz'))
    cache_ids = z['cache_ids'] if 'cache_ids' in z.files else np.zeros(0, int)
    np.testing.assert_array_equal(
        f.table.numpy(), np.concatenate([z['cache_feats'], z['feats']])
        if cache_ids.size else z['feats'])
    held = np.concatenate([cache_ids, z['ids']])
    np.testing.assert_array_equal(f._id2index[held], np.arange(held.size))
    book = ds.get_node_feat_pb().table
    assert (book[cache_ids] == p).all()
    assert (ds.get_node_pb().table[cache_ids] != p).all()
    np.testing.assert_array_equal(f.table.numpy(), want['table'])
    np.testing.assert_array_equal(f._id2index, want['id2index'])
    np.testing.assert_array_equal(book, want['book'])
    assert cache_ids.size == (0 if world == 1 else int(N * CACHE_RATIO))


@pytest.mark.parametrize('world', (1, 2))
def test_cached_lookup_matches_jax_and_keeps_cached_ids_home(
    reference, port, world):
  want = reference[world][1]['lookup']
  case = reference[world][0]['lookup']
  for rank, res in enumerate(port[world]):
    got = res['lookup']
    block = slice(rank * N, (rank + 1) * N)
    np.testing.assert_array_equal(got['rows'], want[block])
    ids, valid = case['ids'][block], case['valid'][block]
    cached = got['book'] != got['graph_book']
    away = valid & (got['book'][ids] != rank)
    # exactly the ids the rewritten book sends away, none of them cached
    np.testing.assert_array_equal(np.sort(got['sent']), np.sort(ids[away]))
    assert not cached[got['sent']].any()
    if world == 2:
      assert cached.sum() == int(N * CACHE_RATIO)
      # the graph's book would have sent the valid cached ids away too
      assert (valid & cached[ids]).sum() > 0


def test_dist_train_step_over_a_cached_layout_matches_jax(reference, port):
  want = reference[2][1]['train']
  for rank, res in enumerate(port[2]):
    got = res['train']
    assert len(got) == len(want) == 3
    for i, ((wloss, wparams), g) in enumerate(zip(want, got)):
      np.testing.assert_allclose(np.atleast_1d(g['result']), wloss,
                                 rtol=1e-5, err_msg=f'call {i}')
      for k, v in wparams.items():
        np.testing.assert_allclose(g['params'][k], v, rtol=0, atol=1e-5,
                                   err_msg=f'rank {rank} call {i} {k}')
