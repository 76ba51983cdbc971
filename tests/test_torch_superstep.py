"""The superstep stack of the port on the CPU: the epoch staging
(``stack_epoch_batches``, ``shard_n_valid``, ``DeviceEpochLoader``),
``Feature.stage_cold_rows``, the bucket collectives and
``multihop_sample_many`` bit for bit against the JAX package on the same
numpy inputs (uniforms from the JAX keys); then, port only, a T-step
``SPMDSageTrainStep.superstep`` against T per-batch calls of one trainer
(equal on the CPU, where the body runs eagerly and every sum runs in one
order), ``run_epoch`` against its windows, cold streaming against the
resident store, the lifts of ``ops/superstep.py``, the prefetch thread,
the mesh and the engine A/B of ``benchmarks/bench_train.py``.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.data import Feature as JaxFeature
from glt_tpu.loader import DeviceEpochLoader as JaxDeviceEpochLoader
from glt_tpu.loader import pad_seed_batch as jax_pad_seed_batch
from glt_tpu.loader import shard_n_valid as jax_shard_n_valid
from glt_tpu.loader import stack_epoch_batches as jax_stack_epoch_batches
from glt_tpu.ops.pipeline import make_dedup_tables
from glt_tpu.ops.pipeline import multihop_sample_many as jax_sample_many
from glt_tpu.ops.sample import sample_neighbors as jax_sample_neighbors
from glt_tpu.parallel import collectives as JC
from glt_tpu.parallel.dist_feature import overflow_lanes as jax_overflow
from glt_tpu_torch.benchmarks import bench_train
from glt_tpu_torch.data import Dataset, Feature
from glt_tpu_torch.loader import (DeviceEpochLoader, pad_seed_batch,
                                  shard_n_valid, stack_epoch_batches)
from glt_tpu_torch.models import GraphSAGE
from glt_tpu_torch.ops import superstep as S
from glt_tpu_torch.ops.cuda_kernels import walk_table_slots
from glt_tpu_torch.ops.pipeline import (multihop_sample,
                                        multihop_sample_many, sample_budget)
from glt_tpu_torch.ops.sample import FusedHopPlan
from glt_tpu_torch.parallel import (ShardedFeature, SPMDSageTrainStep,
                                    collectives as PC, make_mesh,
                                    overflow_lanes, replicated,
                                    require_device_resident, row_sharded)
from glt_tpu_torch.utils.prefetch import PrefetchIterator, prefetch

N, F, BS, K = 64, 8, 4, 3
FANOUTS = [3, 2]
SAMPLE_KEYS = ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch',
               'seed_labels', 'seed_count', 'num_sampled_nodes',
               'num_sampled_edges')


def _setting():
  rng = np.random.default_rng(23)
  src = np.repeat(np.arange(N), 3)
  dst = (src + rng.integers(1, N, src.shape[0])) % N
  feats = rng.normal(size=(N, F)).astype(np.float32)
  labels = rng.integers(0, 4, N).astype(np.int32)
  return np.stack([src, dst]), feats, labels


# -- epoch staging -------------------------------------------------------------

@pytest.mark.parametrize('n,batch', [(1, 4), (5, 8), (16, 8), (37, 8)])
def test_pad_seed_batch_matches_jax(n, batch):
  seeds = np.arange(100, 100 + n)
  a, nv = pad_seed_batch(seeds, batch)
  b, jnv = jax_pad_seed_batch(seeds, batch)
  np.testing.assert_array_equal(a, b)
  assert nv == jnv
  with pytest.raises(ValueError, match='empty'):
    pad_seed_batch(seeds[:0], batch)


@pytest.mark.parametrize('n,batch,drop_last', [
    (37, 8, False), (37, 8, True), (32, 8, True), (5, 8, True), (5, 8, False)])
def test_stack_epoch_batches_matches_jax(n, batch, drop_last):
  seeds = np.arange(1000, 1000 + n)
  order = np.random.default_rng(n).permutation(n)
  got = stack_epoch_batches(seeds, order, batch, drop_last)
  want = jax_stack_epoch_batches(seeds, order, batch, drop_last)
  for a, b in zip(got, want):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('shards,shard_batch', [(1, 8), (2, 4), (4, 2)])
def test_shard_n_valid_matches_jax(shards, shard_batch):
  n_valid = np.array([8, 7, 5, 4, 3, 1, 0], np.int32)
  got = shard_n_valid(n_valid, shards, shard_batch)
  want = jax_shard_n_valid(n_valid, shards, shard_batch)
  assert got.dtype == want.dtype
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('n,batch,k,shards,shuffle,drop_last,drop_ss', [
    (37, 8, 2, 1, False, False, False),
    (37, 8, 2, 2, True, False, False),
    (40, 8, 3, 2, True, False, True),
    (37, 8, 2, 4, True, True, False),
    (5, 8, 2, 1, True, True, False),      # drop_last eats the one batch
    (12, 4, 4, 1, False, False, True),    # drop_last_superstep eats it
])
def test_device_epoch_loader_matches_jax(n, batch, k, shards, shuffle,
                                         drop_last, drop_ss):
  kw = dict(batch_size=batch, superstep_len=k, num_shards=shards,
            shuffle=shuffle, drop_last=drop_last, drop_last_superstep=drop_ss)
  seeds = np.arange(500, 500 + n)
  got = DeviceEpochLoader(seeds, rng=np.random.default_rng(3), device='cpu',
                          **kw)
  want = JaxDeviceEpochLoader(seeds, rng=np.random.default_rng(3), **kw)
  assert len(got) == len(want)
  assert got.batches_per_epoch == want.batches_per_epoch
  for _ in range(2):         # two epochs: the shuffle moves on
    a, b = list(got), list(want)
    assert len(a) == len(b) == len(got)
    for wa, wb in zip(a, b):
      assert wa.length == wb.length
      assert wa.seeds.dtype == torch.int32 and wa.n_valid.dtype == torch.int32
      np.testing.assert_array_equal(wa.seeds.numpy(), np.asarray(wb.seeds))
      np.testing.assert_array_equal(wa.n_valid.numpy(),
                                    np.asarray(wb.n_valid))


def test_device_epoch_loader_checks():
  with pytest.raises(ValueError, match='at least one seed'):
    DeviceEpochLoader(np.zeros(0), 4, device='cpu')
  with pytest.raises(ValueError, match='divisible'):
    DeviceEpochLoader(np.arange(8), 6, num_shards=4, device='cpu')


def test_feature_stage_cold_rows_matches_jax():
  rng = np.random.default_rng(4)
  feats = rng.normal(size=(30, 5)).astype(np.float32)
  nodes = rng.integers(-1, 32, (3, 2, 12))
  counts = rng.integers(0, 13, (3, 2))
  jf = JaxFeature(feats, split_ratio=0.4, host_offload=False)
  jf.lazy_init()
  want = jf.stage_cold_rows(nodes, counts)
  for offload in (False, None):
    got = Feature(feats, split_ratio=0.4, device='cpu',
                  host_offload=offload).stage_cold_rows(nodes, counts)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
  assert np.abs(want).sum() > 0


# -- collectives ---------------------------------------------------------------

def _requests(seed, b=24, n_shards=3):
  rng = np.random.default_rng(seed)
  ids = rng.integers(0, 90, b).astype(np.int32)
  owner = np.minimum(ids // 30, n_shards - 1)
  owner[::5] = n_shards          # dropped
  owner[:6] = 1                  # a hot owner
  return ids, owner


@pytest.mark.parametrize('cap', [0, 5, 2])
def test_bucket_by_owner_and_unbucket_match_jax(cap):
  ids, owner = _requests(cap)
  got, meta = PC.bucket_by_owner(torch.as_tensor(ids), torch.as_tensor(owner),
                                 3, fill_value=-1, capacity=cap)
  want, jmeta = JC.bucket_by_owner(jnp.asarray(ids), jnp.asarray(owner), 3,
                                   fill_value=-1, capacity=cap)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  for a, b in zip(meta, jmeta):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
  c = got.shape[1]
  for base in (0, c, 2 * c):
    resp = np.arange(3 * c * 2, dtype=np.float32).reshape(3, c, 2)
    pay = PC.bucket_payload(torch.as_tensor(ids * 2), meta, 3, capacity=c,
                            round_offset=base)
    jpay = JC.bucket_payload(jnp.asarray(ids * 2), jmeta, 3, capacity=c,
                             round_offset=base)
    np.testing.assert_array_equal(pay.numpy(), np.asarray(jpay))
    un = PC.unbucket(torch.as_tensor(resp), meta, 3, round_offset=base)
    jun = JC.unbucket(jnp.asarray(resp), jmeta, 3, round_offset=base)
    np.testing.assert_array_equal(un.numpy(), np.asarray(jun))


def test_drain_rounds_and_overflow_lanes():
  ids, owner = _requests(9)
  mesh = make_mesh(device='cpu')
  meta = PC.bucket_meta(torch.as_tensor(owner), 3)
  counts = np.bincount(owner[owner < 3], minlength=3)
  for cap in (1, 2, 5, 24):
    assert int(PC.drain_rounds(meta, 3, cap, mesh)) == -(-counts.max() // cap)
    np.testing.assert_array_equal(overflow_lanes(owner, 3, 12, cap),
                                  jax_overflow(owner, 3, 12, cap))
  # the drain with its read-back round count equals the static worst case
  def round_out(base):
    resp = torch.arange(3 * 4, dtype=torch.float32).reshape(3, 4) + 1
    return PC.unbucket(resp, meta, 3, round_offset=base)
  zeros = torch.zeros(ids.shape[0])
  a = PC.capped_drain(round_out, meta, 3, 4, 24, mesh, zeros)
  b = PC.capped_drain(round_out, meta, 3, 4, 24, mesh, zeros,
                      static_rounds=True)
  assert torch.equal(a, b) and int((a > 0).sum()) == int((owner < 3).sum())
  x = torch.arange(6.).reshape(3, 2)
  assert PC.all_to_all(x, mesh) is x


# -- sampling many batches -----------------------------------------------------

def _walk_draws(key, t, fanouts):
  """The draws of batch t of the JAX ``multihop_sample_many``: ``key, sub =
  split(key)`` a batch, then the sorted hop loop's draws from ``sub``."""
  us = []
  for _ in range(t):
    key, sub = jax.random.split(key)
    hop, s = [], BS
    for f in fanouts:
      sub, h = jax.random.split(sub)
      hop.append(np.asarray(jax.random.uniform(h, (f, s))).T.copy())
      s *= f
    us.append(hop)
  return [torch.as_tensor(np.stack(h)) for h in zip(*us)]


@pytest.mark.parametrize('with_edge', [False, True])
def test_multihop_sample_many_matches_jax(with_edge, monkeypatch):
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  edge_index = _setting()[0]
  jg = JaxDataset(edge_dir='out')
  jg.init_graph(edge_index=edge_index, num_nodes=N)
  jg = jg.get_graph()
  g = Dataset().init_graph(edge_index, num_nodes=N, device='cpu').get_graph()
  rng = np.random.default_rng(8)
  seeds = rng.integers(0, N, (K, BS)).astype(np.int32)
  nv = np.array([BS, BS - 1, 2], np.int32)
  key = jax.random.key(3)
  table, scratch = make_dedup_tables(N)
  want, _, _ = jax.jit(lambda s, v, k: jax_sample_many(
      lambda ids, f, kk, m: jax_sample_neighbors(
          jg.indptr, jg.indices, ids, f, kk, seed_mask=m,
          edge_ids=jg.edge_ids if with_edge else None),
      s, v, FANOUTS, k, table, scratch, with_edge=with_edge))(
          jnp.asarray(seeds), jnp.asarray(nv), key)
  plan = FusedHopPlan(g.indptr_pad, g.indices,
                      walk_table_slots(sample_budget(BS, FANOUTS)),
                      edge_ids=g.edge_ids if with_edge else None)
  u = _walk_draws(key, K, FANOUTS)
  got = multihop_sample_many(plan, torch.as_tensor(seeds),
                             torch.as_tensor(nv), FANOUTS, u_stack=u,
                             with_edge=with_edge)
  for k in SAMPLE_KEYS:
    np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                  err_msg=k)
  if with_edge:
    m = got['edge_mask'].numpy()
    np.testing.assert_array_equal(got['edge'].numpy()[m],
                                  np.asarray(want['edge'])[m])
  # and T single walks on the same draws
  for t in range(K):
    one = multihop_sample(plan, torch.as_tensor(seeds[t]), int(nv[t]),
                          FANOUTS, u_hops=[x[t] for x in u],
                          with_edge=with_edge)
    for k in one:
      assert torch.equal(one[k], got[k][t]), k


# -- the trainer ---------------------------------------------------------------

STORES = {'resident': {}, 'with_edge': {'with_edge': True},
          'capped': {'bucket_cap': 7}, 'pinned_split': {'split_ratio': 0.4}}


def _trainer(**kw):
  edge_index, feats, labels = _setting()
  skw = {k: v for k, v in kw.items()
         if k in ('split_ratio', 'bucket_cap', 'host_offload')}
  tkw = {k: v for k, v in kw.items() if k not in skw}
  mesh = make_mesh(device='cpu')
  g = Dataset().init_graph(edge_index, num_nodes=N, device='cpu').get_graph()
  torch.manual_seed(0)
  model = GraphSAGE(F, 8, 4, num_layers=len(FANOUTS))
  return SPMDSageTrainStep(mesh, model, g, ShardedFeature(feats, mesh, **skw),
                           labels, FANOUTS, BS, lr=1e-2, **tkw)


def _window(seed, t=K):
  rng = np.random.default_rng(seed)
  seeds = rng.integers(0, N, (t, BS))
  nv = np.full((t, 1), BS)
  nv[-1] = BS - 2
  return seeds, nv


def _same_state(a, b):
  for p, q in zip(a.model.parameters(), b.model.parameters()):
    assert torch.equal(p, q)
  for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
    for k in sa:
      assert torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k])), k


@pytest.mark.parametrize('store', list(STORES))
def test_superstep_equals_per_batch_calls(store):
  a, b = _trainer(**STORES[store]), _trainer(**STORES[store])
  for w in range(2):
    seeds, nv = _window(w)
    got = a.superstep(seeds, nv)
    want = torch.stack([b(seeds[t], nv[t]) for t in range(K)])
    assert torch.equal(got, want)
    _same_state(a, b)
  assert a.superstep_captures == 0 and a.graph_replays == 0  # eager on CPU


def test_cold_streaming_equals_resident():
  a = _trainer(split_ratio=0.4, host_offload=False, cold_streaming=True)
  b = _trainer()
  for w in range(2):
    seeds, nv = _window(w)
    assert torch.equal(a.superstep(seeds, nv), b.superstep(seeds, nv))
  _same_state(a, b)
  with pytest.raises(NotImplementedError, match='cold_streaming'):
    a(seeds[0], nv[0])


@pytest.mark.parametrize('store', ['resident', 'streaming'])
def test_run_epoch_equals_its_windows(store):
  kw = dict(split_ratio=0.4, host_offload=False, cold_streaming=True) \
      if store == 'streaming' else {}
  a, b = _trainer(**kw), _trainer()
  ld = lambda t: t.make_epoch_loader(np.arange(N - 5), superstep_len=4,
                                     rng=np.random.default_rng(2))
  la, lb = ld(a), ld(b)
  # 59 seeds: 14 full batches and one of 3, windows of 4, 4, 4 and 3
  assert len(la) == 4
  for _ in range(2):
    got = a.run_epoch(la)
    want = torch.cat([b.superstep(ss.seeds, ss.n_valid) for ss in lb])
    assert got.shape == (15,) and torch.equal(got, want)
  _same_state(a, b)
  empty = a.make_epoch_loader(np.arange(3), superstep_len=K,
                              drop_last_superstep=True)
  assert a.run_epoch(empty).shape == (0,)


def test_trainer_refuses_what_it_cannot_train():
  with pytest.raises(NotImplementedError, match='host-spilled'):
    _trainer(split_ratio=0.4, host_offload=False)
  with pytest.raises(ValueError, match='cold_streaming'):
    _trainer(cold_streaming=True)
  with pytest.raises(ValueError, match='cold_streaming'):
    _trainer(split_ratio=0.4, cold_streaming=True)     # pinned block
  require_device_resident(None, 'x')
  edge_index, feats, labels = _setting()
  sf = ShardedFeature(feats, make_mesh(device='cpu'))
  with pytest.raises(ValueError, match='stage_cold_rows'):
    sf.stage_cold_rows(np.zeros((1, 8), np.int64), np.ones((1, 1)))


@pytest.mark.parametrize('kw, host_spilled', [
    ({}, False), (dict(split_ratio=0.4), False),
    (dict(split_ratio=0.4, host_offload=False), True)])
def test_host_spilled_is_a_spill_without_its_pinned_block(kw, host_spilled):
  _, feats, _ = _setting()
  sf = ShardedFeature(feats, make_mesh(device='cpu'), **kw)
  assert sf.host_spilled == host_spilled


def test_stage_cold_rows_of_one_block_equals_its_slice_of_the_stack():
  # a rank staging its own block (one count a batch) gets what the
  # mesh's stack gives that block
  _, feats, _ = _setting()
  sf = ShardedFeature(feats, make_mesh(device='cpu'), split_ratio=0.3,
                      host_offload=False)
  rng = np.random.default_rng(9)
  nodes = rng.integers(-1, N + 2, (3, 2 * 10))
  counts = rng.integers(0, 11, (3, 2))
  stack = sf.stage_cold_rows(nodes, counts)
  assert np.abs(stack).sum() > 0
  for blk in range(2):
    own = sf.stage_cold_rows(nodes[:, blk * 10:(blk + 1) * 10],
                             counts[:, blk:blk + 1])
    np.testing.assert_array_equal(own, stack[:, blk * 10:(blk + 1) * 10])
  with pytest.raises(ValueError, match='3 blocks'):
    sf.stage_cold_rows(nodes, np.ones((3, 3), np.int64))


def test_a_call_recorded_in_a_capture_counts_apart():
  from glt_tpu_torch.ops import cuda_kernels as CK
  from glt_tpu_torch.ops import probe_kernels as PK
  CK.reset_launch_counts()
  PK.reset_launch_counts()
  # the capture state as the entry point returns it (csrc/entry.cuh)
  CK.count_launch(CK.gather_rows, CK._check(0, 'gather_rows'))
  CK.count_launch(CK.gather_rows, CK._check(CK.RECORDED, 'gather_rows'))
  CK.count_launch(CK.sample_walk_dedup, True)
  CK.count_launch(PK.vt, True, 1)
  assert (CK.gather_rows.launches, CK.gather_rows.recorded) == (1, 1)
  assert (CK.sample_walk_dedup.launches,
          CK.sample_walk_dedup.recorded) == (0, 1)
  assert (PK.vt.launches, PK.vt.recorded) == (0, 1)
  CK.reset_launch_counts()
  PK.reset_launch_counts()
  assert all(fn.launches == fn.recorded == 0
             for fn in CK.KERNELS + PK.KERNELS)


def test_graph_launches_are_recorded_launches_times_replays():
  from glt_tpu_torch.parallel.train import _Window
  a = _trainer()
  assert a.graph_launches() == {}
  for key, rec, replays in ((('fused', 8), 8, 3), (('fused', 3), 3, 1),
                            (('consume', 8), 8, 0)):
    w = _Window({})
    w.recorded = {'sample_walk_dedup': rec, 'gather_rows': 2 * rec}
    w.replays = replays
    a.windows[key] = w
  assert a.graph_launches() == {'sample_walk_dedup': 27, 'gather_rows': 54}


def test_tree_helpers():
  tree = {'a': [torch.arange(3), None], 'b': (torch.ones(2, 2),)}
  like = S.tree_map(torch.empty_like, tree)
  assert like['a'][1] is None and isinstance(like['b'], tuple)
  assert [x.shape for x in S.tree_leaves(like)] == [(3,), (2, 2)]
  assert [x.tolist() for x in S.tree_leaves(S._at(tree, 1))] == [1, [1., 1.]]


def test_superstep_lifts():
  seen = []
  run = S.superstep(lambda s, nv, u: (seen.append(int(nv)), s.sum() + u[0])[1])
  aux = run(torch.arange(6).view(3, 2), torch.tensor([1, 2, 3]),
            [torch.tensor([10, 20, 30])])
  assert aux.tolist() == [11, 25, 39] and seen == [1, 2, 3]
  run_h = S.superstep_hetero(lambda st, s, nv, u: (st + 1, {'x': s * st}))
  st, aux = run_h(1, torch.arange(3), torch.zeros(3), None)
  assert st == 4 and aux['x'].tolist() == [0, 2, 6]
  run_c = S.scan_consume(lambda c, x: (c + x['a'], x['b'] * 2))
  c, aux = run_c(torch.tensor(0), {'a': torch.arange(4), 'b': torch.ones(4)})
  assert int(c) == 6 and aux.tolist() == [2.0] * 4


# -- prefetch, mesh, bench ----------------------------------------------------

def test_prefetch_orders_propagates_and_joins():
  assert list(prefetch(range(20), depth=3)) == list(range(20))

  def boom():
    yield 1
    raise KeyError('producer failed')
  with pytest.raises(KeyError, match='producer failed'):
    list(prefetch(boom()))
  started = threading.Event()

  def endless():
    i = 0
    while True:
      started.set()
      yield i
      i += 1
  it = PrefetchIterator(endless(), depth=2)
  gen = iter(it)
  assert next(gen) == 0 and started.is_set()
  gen.close()
  it.worker_thread.join(timeout=5)
  assert not it.worker_thread.is_alive()


def test_mesh_of_one_rank():
  mesh = make_mesh(device='cpu')
  assert (mesh.world, mesh.rank, mesh.shape) == (1, 0, {'data': 1})
  assert make_mesh(1, device='cpu').world == 1
  with pytest.raises(ValueError, match='2 devices'):
    make_mesh(2, device='cpu')
  x = torch.arange(10).view(5, 2)
  assert torch.equal(replicated(mesh)(x), x)
  assert torch.equal(row_sharded(mesh)(x), x)


def test_bench_train_engines_agree_on_cpu():
  out = bench_train.measure_engines(num_nodes=300, avg_degree=4,
                                    batch_size=16, k=4, supersteps=2,
                                    warmup=1, device='cpu')
  d = out['detail']
  assert out['metric'] == 'train_steps_per_sec'
  assert d['loss_max_abs_diff'] == 0.0 and d['loss_parity'] == 'exact'
  assert d['steps_timed'] == 8 and d['recaptures'] == 0
  assert d['device'] == 'cpu' and 'superstep_busy' not in d
