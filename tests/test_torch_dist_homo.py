"""The partitioned homogeneous stack against the JAX package's at world
sizes 1 and 2, over the same partition layout on disk (written by the JAX
RandomPartitioner with node and edge features):

- ``DistNeighborSampler(with_edge=True)`` bit-identical on every output
  field, ``edge`` included;
- ``DistFeature.lookup`` of node and edge stores, resident and spilled
  (split 0.5: the owner's cold rows through K3 mixed's plain twin),
  uncapped and capped (the exchange drains in rounds), equal to JAX's
  and to JAX's resident store;
- ``DistNeighborLoader`` (node and edge stores, labels, a shuffled order
  over two epochs) and ``DistSubGraphLoader`` (``max_degree`` windows,
  the extraction pass, edge features of the induced edges) bit-identical
  on every field;
- a spilled store without its pinned block (the host phase) serves every
  row and a training step refuses it, and a store of no hot rows serves
  every row from its cold block.

``DistTrainStep`` and the example are held in
tests/test_torch_dist_train.py over the same layout.

The JAX side runs on meshes of 1 and 2 CPU devices with ``GLT_DEDUP=sort
GLT_FUSED_HOP=1``; the port's draws are those a JAX device makes when it
serves a hop (``_stacked_draws`` of tests/test_torch_dist_hetero.py), the
loaders' recorded from the keys the JAX samplers used. World 1 runs the
port in this process; world 2 in two spawned ranks of a gloo group
(tests/torch_dist_worker.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as worker
import torch_spmd_worker
from glt_tpu.distributed import DistDataset as JaxDistDataset
from glt_tpu.distributed import DistFeature as JaxDistFeature
from glt_tpu.distributed import DistGraph as JaxDistGraph
from glt_tpu.distributed import DistNeighborLoader as JaxDistNeighborLoader
from glt_tpu.distributed import DistNeighborSampler as JaxDistNeighborSampler
from glt_tpu.distributed import DistSubGraphLoader as JaxDistSubGraphLoader
from glt_tpu.parallel import make_mesh as jax_make_mesh
from glt_tpu.partition import RandomPartitioner as JaxRandomPartitioner
from glt_tpu_torch.parallel import make_mesh
from test_torch_dist_hetero import _stacked_draws

WORLDS = (1, 2)
N, DEG, DIM, EDIM, CLASSES, BS = 60, 3, 8, 3, 4, 4
FANOUTS = [3, 2]
SPLIT = 0.5
JOIN_S = 240


def homo_graph(rng):
  """A graph of N nodes, each with DEG out-edges (a ring edge and two
  random ones, so ``max_degree`` is DEG), node and edge features and
  learnable labels."""
  src = np.repeat(np.arange(N), DEG)
  dst = np.stack([(np.arange(N) + 1) % N] + [rng.integers(0, N, N)
                                             for _ in range(DEG - 1)],
                 1).reshape(-1)
  feats = rng.normal(size=(N, DIM)).astype(np.float32)
  efeats = rng.normal(size=(src.shape[0], EDIM)).astype(np.float32)
  w = rng.normal(size=(DIM, CLASSES)).astype(np.float32)
  labels = np.argmax(feats @ w, 1).astype(np.int32)
  return np.stack([src, dst]), feats, efeats, labels


def homo_shapes(world, fanouts, bs):
  """Per hop the one segment ``[(world * F, k)]`` of a homogeneous walk."""
  shapes, f = [], bs
  for k in fanouts:
    shapes.append([(world * f, k)])
    f *= k
  return shapes


def homo_draws(keys, world, fanouts, bs):
  """Per hop ``[..., world, world * F, k]``: the draws of the JAX devices
  whose keys are ``keys [..., world]``."""
  return [h[0] for h in _stacked_draws(keys, homo_shapes(world, fanouts,
                                                         bs))]


def recording(sampler, fanouts, world):
  """Wrap a JAX DistNeighborSampler so that every call records the port's
  draws for it (from the key it uses); returns the list they go to."""
  draws = []
  real = sampler.sample_from_nodes

  def call(seeds, n_valid=None, key=None):
    key = sampler._next_key() if key is None else key
    bs = np.asarray(seeds).reshape(-1).shape[0] // world
    draws.append(homo_draws(jax.random.split(key, world), world, fanouts,
                            bs))
    return real(seeds, n_valid, key=key)
  sampler.sample_from_nodes = call
  return draws


def batch_tree(b):
  """A JAX loader batch as numpy (``induced`` a list of dicts)."""
  return {k: (v if k in ('induced', 'edge_hop_offsets')
              else np.array(v)) for k, v in b.items()}


def per_rank_pools(node_pb, world, n):
  """Each rank's first ``n`` owned nodes."""
  pb = np.asarray(node_pb)
  return [np.nonzero(pb == p)[0][:n] for p in range(world)]


STORES = {'node': ('node', None, 0), 'node_spill': ('node', SPLIT, 0),
          'node_spill_cap': ('node', SPLIT, 3), 'edge': ('edge', None, 0),
          'edge_cap': ('edge', None, 3), 'edge_spill_cap': ('edge', SPLIT, 3)}


def jax_layout(world, tmp, ei, feats, efeats, stores=STORES):
  """The layout of ``world`` parts at ``tmp`` (the JAX partitioner), its
  JAX DistGraph and the named JAX stores."""
  root = str(tmp / 'homo')
  JaxRandomPartitioner(root, num_parts=world, num_nodes=N, edge_index=ei,
                       node_feat=feats, edge_feat=efeats, seed=5).partition()
  mesh = jax_make_mesh(world)
  hg = JaxDistGraph.from_dataset_partitions(mesh, root)
  dss = [JaxDistDataset().load(root, p) for p in range(world)]
  return root, hg, {name: JaxDistFeature.from_dist_datasets(
      mesh, dss, kind=kind, split_ratio=split, bucket_cap=cap)
      for name, (kind, split, cap) in stores.items()}


def run_port(reference, tmp_path_factory):
  """Per world: each rank's results of the reference's cases (world 1 in
  this process, world 2 in two gloo ranks)."""
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


def _world_cases(world, tmp, ei, feats, efeats, labels):
  rng = np.random.default_rng(70 + world)
  root, hg, stores = jax_layout(world, tmp, ei, feats, efeats)
  cases, want = {}, {}

  # the sampler with edge ids
  seeds = rng.integers(0, N, (world, BS))
  nv = np.full(world, BS)
  nv[-1] = BS - 1
  key = jax.random.key(11 + world)
  out = JaxDistNeighborSampler(hg, FANOUTS, with_edge=True,
                               seed=0).sample_from_nodes(seeds, nv, key=key)
  want['edge_sample'] = {k: np.asarray(v) for k, v in out.items()
                         if k != 'edge_hop_offsets'}
  cases['edge_sample'] = dict(
      kind='edge_sample', root=root, seeds=seeds, n_valid=nv,
      fanouts=FANOUTS,
      u=homo_draws(jax.random.split(key, world), world, FANOUTS, BS))

  # lookups through every store
  ne = ei.shape[1]
  ids = {'node': rng.integers(-1, N, world * 10),
         'edge': rng.integers(-1, ne, world * 10)}
  valid = {k: rng.random(world * 10) > 0.15 for k in ids}
  want['store_lookup'] = {
      name: np.asarray(st.lookup(ids[STORES[name][0]],
                                 jnp.asarray(valid[STORES[name][0]])))
      for name, st in stores.items()}
  cases['store_lookup'] = dict(kind='store_lookup', root=root, ids=ids,
                               valid=valid, stores=STORES)

  # the loader: node and edge stores, labels, a shuffled order, two epochs
  pools = per_rank_pools(hg.node_pb, world, 10)
  loader = JaxDistNeighborLoader(
      hg, FANOUTS, input_nodes=pools, dist_feature=stores['node'],
      labels=labels, batch_size=BS, shuffle=True,
      rng=np.random.default_rng(8), edge_feature=stores['edge'])
  draws = recording(loader.sampler, FANOUTS, world)
  want['dist_loader'] = [batch_tree(b) for _ in range(2) for b in loader]
  cases['dist_loader'] = dict(kind='dist_loader', root=root,
                              fanouts=FANOUTS, input_nodes=pools,
                              labels=labels, bs=BS, rng=8, epochs=2,
                              u=draws)

  # the subgraph loader: DEG-wide windows over two hops
  sub = JaxDistSubGraphLoader(
      hg, num_hops=2, input_nodes_per_device=per_rank_pools(
          hg.node_pb, world, 5), max_degree=DEG,
      dist_feature=stores['node'], batch_size=3, shuffle=True,
      rng=np.random.default_rng(9), edge_feature=stores['edge'])
  walk = recording(sub.sampler, [DEG, DEG], world)
  extract = recording(sub._extract, [DEG], world)
  want['subgraph'] = [batch_tree(b) for b in sub]
  cases['subgraph'] = dict(kind='subgraph', root=root, hops=2,
                           input_nodes=per_rank_pools(hg.node_pb, world, 5),
                           max_degree=DEG, bs=3, rng=9, u=walk,
                           u_extract=extract)
  return cases, want


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
  """Per world: the cases and the JAX results."""
  ei, feats, efeats, labels = homo_graph(np.random.default_rng(23))
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv('GLT_DEDUP', 'sort')
    mp.setenv('GLT_FUSED_HOP', '1')
    for world in WORLDS:
      out[world] = _world_cases(world, tmp_path_factory.mktemp(f'w{world}'),
                                ei, feats, efeats, labels)
  return out


@pytest.fixture(scope='module')
def port(reference, tmp_path_factory):
  return run_port(reference, tmp_path_factory)


def _eq(got, want, what):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)


@pytest.mark.parametrize('world', WORLDS)
def test_sampler_edge_ids_match_jax(reference, port, world):
  want = reference[world][1]['edge_sample']
  for rank, res in enumerate(port[world]):
    got = res['edge_sample']
    assert sorted(got) == sorted(want) and 'edge' in got
    for k, v in want.items():
      _eq(got[k], v[rank], k)
    em = got['edge_mask']
    assert em.any() and (got['edge'][em] >= 0).all()
    assert (got['edge'][~em] == -1).all()


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('store', list(STORES))
def test_store_lookup_matches_jax(reference, port, world, store):
  """Each store's rows equal JAX's and JAX's resident store of the same
  kind; the spilled ones hold half their rows off the device block."""
  want = reference[world][1]['store_lookup']
  kind, split, _ = STORES[store]
  for rank, res in enumerate(port[world]):
    got = res['store_lookup'][store]
    b = want[store].shape[0] // world
    mine = slice(rank * b, (rank + 1) * b)
    _eq(got['rows'], want[store][mine], store)
    _eq(got['rows'], want[kind][mine], f'{store} vs resident')
    assert np.abs(got['rows']).sum() > 0
    assert got['spilled'] == (split is not None)


def _check_batches(got, want, rank, what):
  assert len(got) == len(want) > 0, what
  for i, (g, w) in enumerate(zip(got, want)):
    keys = set(w) - {'edge_hop_offsets', 'n_valid', 'induced'}
    assert keys <= set(g), (what, keys - set(g))
    for k in keys:
      _eq(g[k], w[k][rank], f'{what} batch {i} {k}')
    assert g['n_valid'] == int(np.asarray(w['n_valid'])[rank])
    if 'induced' in w:
      for k, v in w['induced'][rank].items():
        _eq(g['induced'][k], v, f'{what} batch {i} induced {k}')


@pytest.mark.parametrize('world', WORLDS)
def test_dist_neighbor_loader_matches_jax(reference, port, world):
  want = reference[world][1]['dist_loader']
  for rank, res in enumerate(port[world]):
    _check_batches(res['dist_loader'], want, rank, 'loader')
    b = res['dist_loader'][0]
    for k in ('x', 'y', 'edge', 'edge_attr'):
      assert k in b, k
    assert np.abs(b['edge_attr'][b['edge_mask']]).sum() > 0
    assert not b['edge_attr'][~b['edge_mask']].any()


@pytest.mark.parametrize('world', WORLDS)
def test_dist_subgraph_loader_matches_jax(reference, port, world):
  want = reference[world][1]['subgraph']
  for rank, res in enumerate(port[world]):
    _check_batches(res['subgraph'], want, rank, 'subgraph')
    ind = res['subgraph'][0]['induced']
    assert ind['eids'].size and len(set(ind['eids'])) == ind['eids'].size
    assert ind['edge_attr'].shape == (ind['eids'].size, EDIM)


def test_spilled_store_refuses_the_host_phase_and_serves_all_cold(tmp_path):
  from glt_tpu_torch.distributed import DistDataset, DistFeature
  from glt_tpu_torch.partition import RandomPartitioner
  ei, feats, efeats, _ = homo_graph(np.random.default_rng(1))
  root = str(tmp_path)
  RandomPartitioner(root, num_parts=1, num_nodes=N, edge_index=ei,
                    node_feat=feats, edge_feat=efeats).partition()
  mesh = make_mesh(device='cpu')
  ds = {0: DistDataset.load(root, 0, device='cpu')}
  # host_offload=False builds the host phase (tests/test_torch_dist_host_
  # phase.py), which a training step refuses
  hp = DistFeature.from_dist_datasets(mesh, ds, split_ratio=0.5,
                                      host_offload=False)
  assert hp.host_spilled and hp.cold_pinned is None
  np.testing.assert_array_equal(hp.lookup(np.arange(N)).numpy(), feats)
  from glt_tpu_torch.parallel import require_device_resident
  with pytest.raises(NotImplementedError, match='host-spilled'):
    require_device_resident(hp, 'DistTrainStep')
  st = DistFeature.from_dist_datasets(mesh, ds, split_ratio=0.0)
  assert st.hot_count == 0 and st.cold_array.shape == (N, DIM)
  np.testing.assert_array_equal(st.lookup(np.arange(N)).numpy(), feats)
  ds[0].edge_features = None
  with pytest.raises(ValueError, match='edge features'):
    DistFeature.from_dist_datasets(mesh, ds, kind='edge')


@pytest.mark.parametrize('split', [None, 0.3, 0.0])
def test_spilled_store_holds_only_its_hot_rows(tmp_path, split):
  """A spilled store copies its hot rows into a block of their own (the
  dataset's table is not kept alive through a view) and its cold rows to
  host memory; a resident one takes the dataset's table as it is. Both
  read the same rows."""
  from glt_tpu_torch.distributed import DistDataset, DistFeature
  from glt_tpu_torch.partition import RandomPartitioner
  ei, feats, _, _ = homo_graph(np.random.default_rng(2))
  root = str(tmp_path)
  RandomPartitioner(root, num_parts=1, num_nodes=N, edge_index=ei,
                    node_feat=feats).partition()
  mesh = make_mesh(device='cpu')
  ds = {0: DistDataset.load(root, 0, device='cpu')}
  table = ds[0].get_node_feature().table
  st = DistFeature.from_dist_datasets(mesh, ds, split_ratio=split)
  hot = N if split is None else round(N * split)
  assert st.hot_count == hot
  if split is None:
    assert st.cold_array is None and st.array.data_ptr() == table.data_ptr()
  else:
    assert st.array.untyped_storage().nbytes() == hot * DIM * 4
    assert st.cold_array.shape == (N - hot, DIM)
    assert (st.cold_array.untyped_storage().data_ptr()
            != table.untyped_storage().data_ptr())
  np.testing.assert_array_equal(st.lookup(np.arange(N)).numpy(), feats)
