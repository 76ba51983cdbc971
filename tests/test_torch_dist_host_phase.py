"""The host phase of a spilled DistFeature (``host_offload=False``:
``_resolve_cold``, ``cold_get``, ``set_cold_fetcher``,
``resilient_cold_fetcher``) against the JAX package's, over partition
layouts the JAX RandomPartitioner writes:

- at world size 1 the host phase equals the pinned path (K3 mixed's
  plain twin) and JAX's ``DistFeature(host_offload=False)`` lookup bit
  for bit, uncapped and capped, with half and with none of the rows hot;
- two gloo ranks (tests/torch_dist_worker.py) resolve each other's cold
  rows over the port's rpc fabric (``init_rpc``, the owner's
  ``cold_get`` as a callee): each rank's block equals the table's rows
  and JAX's two-device lookup; the fabric's partition map, router and
  gather come back as the reference shapes them;
- ``resilient_cold_fetcher``'s ladder (primary, replica, staleness cache
  and zero rows) matches JAX's on the same scripted fetchers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
import torch_spmd_worker
from glt_tpu.distributed import DistDataset as JaxDistDataset
from glt_tpu.distributed import DistFeature as JaxDistFeature
from glt_tpu.distributed import resilient_cold_fetcher as jax_fetcher
from glt_tpu.parallel import make_mesh as jax_make_mesh
from glt_tpu.partition import RandomPartitioner as JaxRandomPartitioner
from glt_tpu_torch.distributed import (DistDataset, DistFeature,
                                       free_port_base,
                                       resilient_cold_fetcher)
from glt_tpu_torch.parallel import make_mesh
from test_torch_dist_homo import N, homo_graph

STORES = {'half': (0.5, 0), 'half_capped': (0.5, 3), 'all_cold': (0.0, 0)}
JOIN_S = 240


@pytest.fixture(scope='module')
def layouts(tmp_path_factory):
  """Per world: the layout root, the lookup ids and mask, JAX's host-phase
  rows per store, and the whole table."""
  rng = np.random.default_rng(31)
  ei, feats, _, _ = homo_graph(rng)
  out = {}
  for world in (1, 2):
    root = str(tmp_path_factory.mktemp(f'host{world}'))
    JaxRandomPartitioner(root, num_parts=world, num_nodes=N, edge_index=ei,
                         node_feat=feats, seed=5).partition()
    ids = rng.integers(-1, N, world * 16)
    valid = (rng.random(world * 16) > 0.15) & (ids >= 0)
    mesh = jax_make_mesh(world)
    dss = [JaxDistDataset().load(root, p) for p in range(world)]
    want = {name: np.asarray(JaxDistFeature.from_dist_datasets(
        mesh, dss, split_ratio=split, bucket_cap=cap,
        host_offload=False).lookup(ids, jnp.asarray(valid)))
        for name, (split, cap) in STORES.items()}
    out[world] = dict(root=root, ids=ids, valid=valid, want=want)
  out['feats'] = feats
  return out


def _table_rows(feats, ids, valid):
  return np.where(valid[:, None], feats[np.clip(ids, 0, N - 1)], 0)


@pytest.mark.parametrize('store', list(STORES))
def test_world_one_equals_the_pinned_path_and_jax(layouts, store):
  split, cap = STORES[store]
  lay = layouts[1]
  mesh = make_mesh(device='cpu')
  ds = {0: DistDataset.load(lay['root'], 0, device='cpu')}
  host = DistFeature.from_dist_datasets(mesh, ds, split_ratio=split,
                                        bucket_cap=cap, host_offload=False)
  pinned = DistFeature.from_dist_datasets(mesh, ds, split_ratio=split,
                                          bucket_cap=cap)
  assert host.host_spilled and not pinned.host_spilled
  assert host.cold_pinned is None and host.cold_array.shape[0] == (
      N - host.hot_count)
  got = host.lookup(lay['ids'], lay['valid'])
  assert torch.equal(got, pinned.lookup(lay['ids'], lay['valid']))
  np.testing.assert_array_equal(got.numpy(), lay['want'][store])
  np.testing.assert_array_equal(
      got.numpy(), _table_rows(layouts['feats'], lay['ids'], lay['valid']))
  # the rpc callee serves this rank's cold rows by global id
  cold = np.nonzero(host._host_id2index >= host.hot_count)[0][:5]
  np.testing.assert_array_equal(host.cold_get(0, cold).numpy(),
                                layouts['feats'][cold])
  with pytest.raises(RuntimeError, match='host_offload=False'):
    pinned.cold_get(0, cold)


@pytest.fixture(scope='module')
def two_ranks(layouts, tmp_path_factory):
  lay = layouts[2]
  case = dict(kind='host_phase', root=lay['root'], stores=STORES,
              ids=lay['ids'], valid=lay['valid'],
              master_port=free_port_base(1))
  return torch_spmd_worker.spawn_ranks(
      worker.main, 2, {'host': case},
      str(tmp_path_factory.mktemp('host_ranks')), JOIN_S)


@pytest.mark.parametrize('store', list(STORES))
def test_two_ranks_fetch_each_others_cold_rows_over_rpc(layouts, two_ranks,
                                                        store):
  lay = layouts[2]
  table = _table_rows(layouts['feats'], lay['ids'], lay['valid'])
  b = lay['ids'].shape[0] // 2
  for rank, res in enumerate(two_ranks):
    got = res['host'][store]
    assert got['host_spilled']
    mine = slice(rank * b, (rank + 1) * b)
    np.testing.assert_array_equal(got['rows'], table[mine])
    np.testing.assert_array_equal(got['rows'], lay['want'][store][mine])
  # each rank asked the other, over rpc, for cold rows of its partition
  assert all(res['host'][store]['fetched'] > 0 for res in two_ranks)


def test_two_ranks_fabric_collectives(two_ranks):
  for rank, res in enumerate(two_ranks):
    fab = res['host']['fabric']
    assert fab['p2w'] == {0: [0], 1: [1]}
    assert fab['gathered'] == {0: 0, 1: 10}
    assert fab['routed'] == [0, 1]


class _Metrics:
  def __init__(self):
    self.log = []

  def record_failover(self):
    self.log.append('failover')

  def record_stale_serve(self, n):
    self.log.append(('stale', n))

  def add_gauge(self, name, v):
    self.log.append((name, v))


def _ladder(make):
  """One script through a composed fetcher: partition 0's primary works;
  partition 1's primary is dead and its replica works, then dies too;
  partition 2 has no live fetcher and a known width. Every result as
  numpy, and the metrics' log."""
  table = np.arange(40, dtype=np.float32).reshape(10, 4)
  alive = {'replica': True}

  def ok(ids):
    return table[np.asarray(ids)]

  def dead(ids):
    raise ConnectionError('dead')

  def replica(ids):
    if not alive['replica']:
      raise ConnectionError('replica dead')
    return table[np.asarray(ids)]
  metrics = _Metrics()
  fetch = make({0: [ok], 1: [dead, replica], 2: [dead]}, feature_dim=4,
               metrics=metrics)
  out = [fetch(0, np.array([1, 2])), fetch(1, np.array([3, 4]))]
  alive['replica'] = False
  out += [fetch(1, np.array([3, 5])), fetch(2, np.array([7]))]
  return [np.asarray(o).tolist() for o in out], metrics.log


def test_resilient_cold_fetcher_ladder_matches_jax():
  got, want = _ladder(resilient_cold_fetcher), _ladder(jax_fetcher)
  assert got == want
  rows, log = got
  assert rows[2] == [[12.0, 13.0, 14.0, 15.0], [0.0] * 4]   # stale, zero
  assert log.count('failover') == 1
