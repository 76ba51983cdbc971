"""Partitioned link sampling against the JAX package's at world sizes 1
and 2, over the partition layout of tests/test_torch_dist_homo.py:

- ``DistLinkNeighborLoader`` epochs, binary and triplet, strict and not,
  with node and edge stores: every field of every batch bit-identical
  (``edge_label_index``/``edge_label`` or ``src_index``/``dst_pos_index``/
  ``dst_neg_index``, ``n_pos``, ``x``, ``edge_attr``, the sample). The
  non-strict negatives come from the loader's numpy ``rng`` on both sides;
  the strict ones from each side's ``DistRandomNegativeSampler``, the
  port's given the JAX ``randint`` proposals of each batch;
- ``DistRandomNegativeSampler.sample`` and ``sample_dst`` without padding,
  over layouts sampled along out- and in-edges (rows and columns swap for
  ``edge_dir='in'``), bit-identical, and every pair they keep no edge;
- the partitioned unsupervised example at toy size.

The JAX side runs on meshes of 1 and 2 CPU devices with ``GLT_DEDUP=sort
GLT_FUSED_HOP=1``; world 2 of the port runs in two gloo ranks
(tests/torch_dist_worker.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glt_tpu.distributed import DistGraph as JaxDistGraph
from glt_tpu.distributed import DistLinkNeighborLoader as JaxLinkLoader
from glt_tpu.distributed import (DistRandomNegativeSampler as
                                 JaxDistRandomNegativeSampler)
from glt_tpu.parallel import make_mesh as jax_make_mesh
from glt_tpu.partition import RandomPartitioner as JaxRandomPartitioner
from glt_tpu.sampler import NegativeSampling as JaxNegativeSampling
from glt_tpu.utils.rng import make_key
from test_torch_dist_homo import (FANOUTS, N, STORES, WORLDS, _check_batches,
                                  _eq, batch_tree, homo_graph, jax_layout,
                                  recording, run_port)

LINK_CASES = {'binary': ('binary', 1, False),
              'binary_strict': ('binary', 1, True),
              'triplet': ('triplet', 2, False),
              'triplet_strict': ('triplet', 2, True)}
LINK_BS, LINK_SEED, TRIALS = 3, 3, 5


def jax_proposals(key, world, trials, req):
  """Each JAX device's strict proposals under ``key``: ``(rows, cols)``
  ``[world, trials, req]`` (dist_negative.py: the device key folded by
  its index, split into a row and a column key, ``randint`` each)."""
  rows, cols = [], []
  for d, k in enumerate(jax.random.split(key, world)):
    kr, kc = jax.random.split(jax.random.fold_in(k, d))
    rows.append(np.asarray(jax.random.randint(kr, (trials, req), 0, N,
                                              dtype=jnp.int32)))
    cols.append(np.asarray(jax.random.randint(kc, (trials, req), 0, N,
                                              dtype=jnp.int32)))
  return np.stack(rows), np.stack(cols)


def source_pools(hg, ei, world, n):
  """Each rank's first ``n`` edges whose source it owns."""
  owner = np.asarray(hg.node_pb)[ei[0]]
  return [ei[:, owner == p][:, :n] for p in range(world)]


def _world_cases(world, tmp, ei, feats, efeats):
  rng = np.random.default_rng(50 + world)
  stores = {k: STORES[k] for k in ('node', 'edge')}
  root, hg, jstores = jax_layout(world, tmp, ei, feats, efeats, stores)
  cases, want = {}, {}
  pools = source_pools(hg, ei, world, 8)
  for name, neg in LINK_CASES.items():
    loader = JaxLinkLoader(
        hg, FANOUTS, pools, dist_feature=jstores['node'],
        neg_sampling=JaxNegativeSampling(*neg), batch_size=LINK_BS,
        shuffle=True, seed=LINK_SEED, edge_feature=jstores['edge'])
    draws = recording(loader.sampler, FANOUTS, world)
    want[name] = [batch_tree(b) for b in loader]
    props = [jax_proposals(jax.random.fold_in(make_key(LINK_SEED), it),
                           world, TRIALS, loader.num_neg)
             for it in range(len(loader))] if neg[2] else None
    cases[name] = dict(kind='link', root=root, fanouts=FANOUTS, pools=pools,
                       neg=neg, bs=LINK_BS, seed=LINK_SEED, u=draws,
                       props=props)

  # the negative sampler alone, along out- and in-edges
  for edge_dir, assign in (('out', 'by_src'), ('in', 'by_dst')):
    droot = str(tmp / f'neg_{edge_dir}')
    JaxRandomPartitioner(droot, num_parts=world, num_nodes=N,
                         edge_index=ei, edge_assign_strategy=assign,
                         seed=6).partition()
    g = JaxDistGraph.from_dataset_partitions(jax_make_mesh(world), droot,
                                             edge_dir=edge_dir)
    s = JaxDistRandomNegativeSampler(g, trials_num=3, padding=False)
    key, dkey = jax.random.key(30 + world), jax.random.key(40 + world)
    src = rng.integers(0, N, (world, 6))
    free = s.sample(8, key=key)
    dst = s.sample_dst(src, key=dkey)
    want[f'neg_{edge_dir}'] = dict(
        free=[np.asarray(x) for x in free], dst=[np.asarray(x) for x in dst])
    cases[f'neg_{edge_dir}'] = dict(
        kind='negative', root=droot, edge_dir=edge_dir, trials=3,
        padding=False, req=8, props=jax_proposals(key, world, 3, 8),
        src=src, dst_props=jax_proposals(dkey, world, 3, 6)[1])
  return cases, want


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
  ei, feats, efeats, _ = homo_graph(np.random.default_rng(23))
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv('GLT_DEDUP', 'sort')
    mp.setenv('GLT_FUSED_HOP', '1')
    for world in WORLDS:
      out[world] = _world_cases(world, tmp_path_factory.mktemp(f'w{world}'),
                                ei, feats, efeats)
  return out, {tuple(e) for e in ei.T}


@pytest.fixture(scope='module')
def port(reference, tmp_path_factory):
  return run_port(reference[0], tmp_path_factory)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', list(LINK_CASES))
def test_dist_link_loader_matches_jax(reference, port, world, name):
  want = reference[0][world][1][name]
  edges = reference[1]
  mode, _, strict = LINK_CASES[name]
  for rank, res in enumerate(port[world]):
    got = res[name]
    _check_batches([{**b, 'n_valid': b['n_pos']} for b in got],
                   [{**w, 'n_valid': w['n_pos']} for w in want], rank, name)
    for b in got:
      node = b['node']
      if mode == 'binary':
        assert b['edge_label_index'].shape == (2, 2 * LINK_BS)
        pairs = zip(node[b['edge_label_index'][0, LINK_BS:]],
                    node[b['edge_label_index'][1, LINK_BS:]])
      else:
        assert b['dst_neg_index'].shape == (LINK_BS, 2)
        src = np.repeat(node[b['src_index']], 2)
        pairs = zip(src, node[b['dst_neg_index'].reshape(-1)])
      if strict:
        assert not any((int(u), int(v)) in edges for u, v in pairs)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('edge_dir', ['out', 'in'])
def test_dist_negative_sampler_matches_jax(reference, port, world, edge_dir):
  want = reference[0][world][1][f'neg_{edge_dir}']
  edges = reference[1]
  for rank, res in enumerate(port[world]):
    got = res[f'neg_{edge_dir}']
    for kind in ('free', 'dst'):
      for f, w in zip(('rows', 'cols', 'mask'), want[kind]):
        _eq(got[kind][f], w[rank], f'{kind} {f}')
      g = got[kind]
      kept = list(zip(g['rows'][g['mask']], g['cols'][g['mask']]))
      assert kept and not any((int(u), int(v)) in edges for u, v in kept)


def test_dist_sage_unsup_example_end_to_end():
  from glt_tpu_torch.examples.distributed import dist_sage_unsup
  res = dist_sage_unsup.main(['--device', 'cpu', '--nodes', '600',
                              '--epochs', '1', '--batch-size', '16',
                              '--max-steps', '4', '--strict'])
  assert len(res['losses']) == 4 and np.isfinite(res['losses']).all()
  ei, _ = dist_sage_unsup.ring_and_random(600)
  pb = np.random.default_rng(0).integers(0, 2, 600)
  pools = dist_sage_unsup.positive_pools(ei, pb, 2)
  assert sum(p.shape[1] for p in pools) == ei.shape[1]
  for p, pool in enumerate(pools):
    assert (pb[pool[0]] == p).all()
