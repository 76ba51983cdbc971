"""Live-update serving in the port (glt_tpu_torch.stream + the engine's
``sampler=`` / ``update_snapshot``) against the JAX package, through one
scenario on both sides: serve on the startup snapshot, stage inserts,
deletes and feature rows (the overlay refreshes), serve, ``flush`` (the
compaction swaps to version 1 and drops the cache entries of the touched
ids and their in-neighbours: ``expand_invalidation``, as
examples/stream_updates.py sets it), serve again.

The JAX side is its StreamSampler on the ``pallas`` one-hop engine (the
interpret-mode ``sample_hop`` kernel, ``GLT_WINDOW_W=8`` so hub rows
exist), the sort inducer with fused hops (``GLT_DEDUP=sort
GLT_FUSED_HOP=1``), under its InferenceEngine and StreamIngestor. The
port draws nothing: the JAX key sequence's uniforms are injected. The
sampled subgraph must match bit for bit in all three states; logits to
rtol = atol = 1e-5 (float32 sums in another order; everything upstream of
the forward is bit-identical). The scenario runs once per process, with
one compile of the JAX stream program (one batch shape throughout).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.loader.transform import Batch as JaxBatch
from glt_tpu.models.sage import GraphSAGE as JaxGraphSAGE
from glt_tpu.ops.pallas_kernels import kernel_launch_count
from glt_tpu.serving import InferenceEngine as JaxEngine
from glt_tpu.stream import CompactionPolicy as JaxPolicy
from glt_tpu.stream import SnapshotManager as JaxSnapshotManager
from glt_tpu.stream import StreamIngestor as JaxIngestor
from glt_tpu.stream import StreamSampler as JaxStreamSampler
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.models import GraphSAGE, sage_params_from_flax
from glt_tpu_torch.serving import InferenceEngine
from glt_tpu_torch.stream import (CompactionPolicy, SnapshotManager,
                                  StreamIngestor, StreamSampler)

N, E, F, FANOUTS, B, SEED = 200, 1600, 12, [3, 2], 8, 0
ENV = {'GLT_WINDOW_W': '8', 'GLT_DEDUP': 'sort', 'GLT_FUSED_HOP': '1'}
SEEDS = np.array([5, 0, 5, 17, 63, 2, 150, 9])
STATES = ('startup', 'overlay', 'compacted')
SAMPLE_KEYS = ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch',
               'num_sampled_nodes', 'num_sampled_edges')


def _uniforms(key, batch_size, sampler):
  """The draws JAX's stream makes from ``key``: per hop ``key, sub =
  split(key)``, ``uniform(sub, (K, S_h))`` transposed, S_h the frontier of
  the effective widths."""
  us, s = [], batch_size
  for f, width in zip(sampler._base_fanouts, sampler.num_neighbors):
    key, sub = jax.random.split(key)
    us.append(torch.as_tensor(np.asarray(jax.random.uniform(sub, (f, s))).T
                              .copy()))
    s *= abs(width)   # JAX encodes the effective widths negative
  return us


def _pairs(node, row, col, mask):
  """(parent, child) global-id pairs of the valid edges."""
  node, row, col, mask = (np.asarray(a) for a in (node, row, col, mask))
  return {(int(node[c]), int(node[r]))
          for r, c, m in zip(row, col, mask) if m}


def _scenario():
  rng = np.random.default_rng(0)
  ei = np.stack([rng.integers(0, N, E), rng.integers(0, N, E)])
  ei[:, :30] = ei[:, 30:60]            # multigraph: duplicated edges
  x = rng.standard_normal((N, F)).astype(np.float32)
  jmodel = JaxGraphSAGE(hidden_features=16, out_features=5, num_layers=2)
  z = jnp.zeros((4,), jnp.int32)
  params = jax.jit(jmodel.init)(jax.random.key(1), JaxBatch(
      x=jnp.zeros((4, F)), row=z, col=z, edge_mask=jnp.zeros((4,), bool),
      node=z, node_count=jnp.zeros((), jnp.int32), batch_size=2))
  policy = dict(occupancy_threshold=2.0, max_staleness_s=1e9)

  jds = JaxDataset().init_graph(edge_index=ei, num_nodes=N)
  jds.init_node_features(x)
  jm = JaxSnapshotManager(jds.get_graph().topo, jds.get_node_feature(),
                          delta_capacity=64)
  js = JaxStreamSampler(jm, FANOUTS, seed=SEED)
  js._hop_engine_override = 'pallas'
  keys, next_key = [], js._next_key

  def record_key():
    keys.append(next_key())
    return keys[-1]
  js._next_key = record_key
  jeng = JaxEngine(jds, jmodel, params, FANOUTS, buckets=(B,), sampler=js)
  jing = JaxIngestor(jm, sampler=js, engine=jeng,
                     policy=JaxPolicy(**policy), expand_invalidation=True)

  ds = Dataset().init_graph(ei, num_nodes=N, device='cpu')
  ds.init_node_features(x, device='cpu')
  pm = SnapshotManager(ds.get_graph().topo, ds.get_node_feature(),
                       delta_capacity=64, device='cpu')
  ps = StreamSampler(pm, FANOUTS, seed=SEED)
  # an engine request draws what the JAX engine's request just drew
  ps.hop_uniforms = lambda b: _uniforms(keys[-1], b, js)
  eng = InferenceEngine(ds, GraphSAGE(F, 16, 5, num_layers=2),
                        sage_params_from_flax(jax.tree.map(np.asarray,
                                                           params)),
                        FANOUTS, buckets=(B,), device='cpu', sampler=ps)
  ping = StreamIngestor(pm, sampler=ps, engine=eng,
                        policy=CompactionPolicy(**policy),
                        expand_invalidation=True)

  topo = jm.current().topo
  nbrs5 = set(topo.indices[topo.indptr[5]:topo.indptr[6]].tolist())
  new_nbr = min(set(range(100, N)) - nbrs5)   # not a base neighbour of 5
  out = {'new_nbr': new_nbr, 'sample': {}, 'logits': [], 'info': None}

  def serve(state, step, requests):
    key = jax.random.key(100 + step)
    want = js.sample_from_nodes(SEEDS, n_valid=7, key=key)
    got = ps.sample_from_nodes(SEEDS, n_valid=7,
                               uniforms=_uniforms(key, B, js))
    out['sample'][state] = (want, got)
    for ids in requests:
      out['logits'].append((state, jeng.infer(np.array(ids)),
                            eng.infer(np.array(ids))))

  traced = kernel_launch_count()
  serve('startup', 0, ([5, 0, 5, 17, 63, 2], [0, 9, 9, 40, 2, 33, 61]))
  out['jax_kernels'] = kernel_launch_count() - traced
  for ing in (jing, ping):
    ing.insert_edges([5, 5, 17, 0, 40], [new_nbr, 151, 152, 5,
                                         int(ei[1, 0])])
    ing.delete_edges(ei[0, 30:33], ei[1, 30:33])   # multigraph deletes
    ing.delete_edges([17, 63], [int(topo.indices[topo.indptr[17]]),
                                int(topo.indices[topo.indptr[63]])])
    ing.update_features([5, 63, 120], np.full((3, F), 3.5, np.float32))
  serve('overlay', 1, ([5, 150, 11, 12], [0, 9]))
  out['cached'] = (len(jeng.cache), len(eng.cache),
                   {k[0] for k in eng.cache._data})
  infos = (jing.flush(), ping.flush())
  out['info'] = infos
  out['csr'] = (jm.current(), pm.current())
  out['versions'] = (jeng.snapshot_version, eng.snapshot_version)
  serve('compacted', 2, ([5, 0, 5, 17, 63, 2], [11, 12, 120, 150]))
  out['hits'] = (jeng.cache.hits, eng.cache.hits)
  out['dropped'] = (jeng.invalidate_nodes([5, 0, 77]),
                    eng.invalidate_nodes([5, 0, 77]))
  out['jax_plans'] = [k[2] for k in js._fn_cache]
  return out


@pytest.fixture(scope='module')
def scenario():
  with pytest.MonkeyPatch.context() as mp:
    for k, v in ENV.items():
      mp.setenv(k, v)
    yield _scenario()


@pytest.mark.parametrize('state', STATES)
def test_stream_sampler_bit_identical_to_jax(scenario, state):
  want, got = scenario['sample'][state]
  for f in SAMPLE_KEYS:
    np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                  getattr(got, f).numpy(), err_msg=f)
  for f in ('seed_labels', 'seed_count', 'snapshot_version'):
    np.testing.assert_array_equal(np.asarray(want.metadata[f]),
                                  np.asarray(got.metadata[f]), err_msg=f)
  assert got.edge_hop_offsets == want.edge_hop_offsets
  assert got.metadata['snapshot_version'] == (state == 'compacted')
  # the reference really read its base hops through the Pallas kernel:
  # one traced sample_hop per positive hop, one compiled program, whose
  # plan is the pallas engine at W = 8 (never the element fallback)
  assert scenario['jax_kernels'] == len(FANOUTS)
  assert [p[:2] for p in scenario['jax_plans']] == [('pallas', 8)]
  assert scenario['jax_plans'][0][2] > 8   # hub rows (degree > W) exist


def test_overlay_shows_inserted_edge_before_compaction(scenario):
  pairs = {s: _pairs(*(getattr(scenario['sample'][s][1], f)
                       for f in ('node', 'row', 'col', 'edge_mask')))
           for s in STATES}
  edge = (5, scenario['new_nbr'])
  assert edge not in pairs['startup']
  # the insert window is exhaustive: every pending insert of a row shows
  assert edge in pairs['overlay'] and (5, 151) in pairs['overlay']


def test_engine_logits_match_jax(scenario):
  for state, want, got in scenario['logits']:
    assert got.shape == want.shape
    np.testing.assert_allclose(want, got, rtol=1e-5, atol=1e-5,
                               err_msg=state)
  assert scenario['hits'][0] == scenario['hits'][1] > 0
  # invalidate_nodes: 5 and 0 are cached (served after the swap), 77 not
  assert scenario['dropped'][0] == scenario['dropped'][1] == 2


def test_flush_matches_jax(scenario):
  want, got = scenario['info']
  for k in ('version', 'num_edges', 'capacity_grown', 'edge_capacity',
            'invalidated'):
    assert want[k] == got[k], k
  np.testing.assert_array_equal(want['touched'], got['touched'])
  assert got['version'] == 1 and got['invalidated'] > 0
  # expand_invalidation: the touched ids and their in-neighbours on the
  # new snapshot went, more than the touched ids alone
  jsnap, psnap = scenario['csr']
  n_jax, n_port, cached = scenario['cached']
  assert n_jax == n_port
  affected = psnap.expand_affected(got['touched'])
  np.testing.assert_array_equal(
      affected, jsnap.expand_affected(want['touched']))
  assert got['invalidated'] == len(cached & set(affected.tolist()))
  assert got['invalidated'] > len(cached & set(got['touched'].tolist()))
  assert scenario['versions'] == (1, 1)
  for k in ('indptr', 'indices'):
    np.testing.assert_array_equal(np.asarray(jsnap.arrays[k]),
                                  psnap.arrays[k].numpy(), err_msg=k)
  np.testing.assert_array_equal(jsnap.topo.edge_ids,
                                psnap.topo.edge_ids.numpy())
  # the updated rows reach the forward after the swap: node 5's logits
  # changed between the startup and the compacted request
  logits = scenario['logits']
  assert not np.allclose(logits[0][2][0], logits[4][2][0])
