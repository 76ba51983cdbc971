"""The port's snapshot chain (glt_tpu_torch.stream.snapshot) against the
JAX package's on both layouts: a CSR base (sampled along out-edges) and a
CSC base (along in-edges), weighted and not.

- A compaction orients the base edges and every delta by the layout, keeps
  the layout and the edge weights (inserts weigh 1.0), and reports the
  row-axis endpoints as ``touched``: ``indptr``, the padded ``indices``,
  edge ids, weights, layout and ``touched`` equal JAX's bit for bit, over
  two compactions in a row.
- The insert and tombstone overlays compress on the base's pointer axis,
  as JAX's do, and the flipped view (``flipped_topo``,
  ``expand_affected``) is the opposite layout's.
- The live-update scenario of tests/test_torch_stream_serving.py on a CSC
  base through ``StreamSampler(edge_dir='in')``: the samples equal JAX's
  bit for bit in the startup, overlay and compacted states; logits to
  rtol = atol = 1e-5. The JAX side samples through its default one-hop
  engine with the sort inducer and fused hops (``GLT_DEDUP=sort
  GLT_FUSED_HOP=1``), the port draws nothing (JAX's uniforms are
  injected).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.data import Topology as JaxTopology
from glt_tpu.loader.transform import Batch as JaxBatch
from glt_tpu.models.sage import GraphSAGE as JaxGraphSAGE
from glt_tpu.serving import InferenceEngine as JaxEngine
from glt_tpu.stream import CompactionPolicy as JaxPolicy
from glt_tpu.stream import EdgeDeltaBuffer as JaxEdgeBuffer
from glt_tpu.stream import SnapshotManager as JaxSnapshotManager
from glt_tpu.stream import StreamIngestor as JaxIngestor
from glt_tpu.stream import StreamSampler as JaxStreamSampler
from glt_tpu_torch.data import Dataset, Topology
from glt_tpu_torch.models import GraphSAGE, sage_params_from_flax
from glt_tpu_torch.serving import InferenceEngine
from glt_tpu_torch.stream import (CompactionPolicy, EdgeDeltaBuffer,
                                  SnapshotManager, StreamIngestor,
                                  StreamSampler)
from test_torch_stream_serving import SAMPLE_KEYS, STATES, _uniforms

N_ROWS, N_COLS, E = 23, 31, 140


def _edges(seed=0):
  """A bipartite multigraph (src < N_ROWS, dst < N_COLS) with duplicated
  edges, its float32 weights, and the deltas of two compactions: inserts
  (some duplicating a base edge), deletes of base edges (one of a
  duplicated pair, so both copies go) and a delete that cancels a pending
  insert."""
  rng = np.random.default_rng(seed)
  ei = np.stack([rng.integers(0, N_ROWS, E), rng.integers(0, N_COLS, E)])
  ei[:, :10] = ei[:, 10:20]
  w = rng.random(E).astype(np.float32)
  ins1 = np.stack([rng.integers(0, N_ROWS, 9), rng.integers(0, N_COLS, 9)])
  ins1[:, 0] = ei[:, 50]
  dels1 = np.concatenate([ei[:, [10, 33, 71]], ins1[:, [4]]], axis=1)
  ins2 = np.stack([rng.integers(0, N_ROWS, 5), rng.integers(0, N_COLS, 5)])
  dels2 = ei[:, [90, 91]]
  return ei, w, [(ins1, dels1), (ins2, dels2)]


def _stage(buf, ins, dels):
  buf.insert_edges(ins[0], ins[1])
  buf.delete_edges(dels[0], dels[1])


def _np(x):
  return None if x is None else (x.numpy() if isinstance(x, torch.Tensor)
                                 else np.asarray(x))


def _managers(layout, weighted):
  ei, w, deltas = _edges()
  w = w if weighted else None
  jm = JaxSnapshotManager(
      JaxTopology(edge_index=ei, edge_weights=w, layout=layout,
                  num_rows=N_ROWS if layout == 'CSR' else N_COLS,
                  num_cols=N_COLS if layout == 'CSR' else N_ROWS),
      None, delta_capacity=16)
  pm = SnapshotManager(
      Topology(ei, edge_weights=w, layout=layout,
               num_rows=N_ROWS if layout == 'CSR' else N_COLS,
               num_cols=N_COLS if layout == 'CSR' else N_ROWS,
               device='cpu'),
      None, delta_capacity=16, device='cpu')
  return jm, pm, deltas


def _buffers(jm, pm):
  return (JaxEdgeBuffer(capacity=16, num_src=jm.num_src_nodes,
                        num_dst=jm.num_dst_nodes),
          EdgeDeltaBuffer(capacity=16, num_src=pm.num_src_nodes,
                          num_dst=pm.num_dst_nodes))


CASES = [('CSR', False), ('CSR', True), ('CSC', False), ('CSC', True)]


@pytest.mark.parametrize('layout,weighted', CASES)
def test_compaction_matches_jax(layout, weighted):
  jm, pm, deltas = _managers(layout, weighted)
  assert (pm.layout, pm.num_nodes, pm.num_src_nodes, pm.num_dst_nodes) == (
      jm.layout, jm.num_nodes, jm.num_src_nodes, jm.num_dst_nodes)
  assert (pm.num_src_nodes, pm.num_dst_nodes) == (N_ROWS, N_COLS)
  jb, pb = _buffers(jm, pm)
  for step, (ins, dels) in enumerate(deltas, 1):
    _stage(jb, ins, dels)
    _stage(pb, ins, dels)
    jsnap, jinfo = jm.compact(jb.drain())
    psnap, pinfo = pm.compact(pb.drain())
    assert psnap.topo.layout == jsnap.topo.layout == layout
    for k in ('indptr', 'indices'):
      np.testing.assert_array_equal(_np(psnap.arrays[k]),
                                    _np(jsnap.arrays[k]), err_msg=k)
    np.testing.assert_array_equal(_np(psnap.topo.edge_ids),
                                  jsnap.topo.edge_ids)
    jw, pw = jsnap.topo.edge_weights, _np(psnap.topo.edge_weights)
    assert (pw is None) == (jw is None) == (not weighted)
    if weighted:
      np.testing.assert_array_equal(pw, jw)
      assert (pw == 1.0).sum() >= len(ins[0]) - 1  # inserts at unit weight
    np.testing.assert_array_equal(pinfo['touched'], jinfo['touched'])
    for k in ('version', 'num_edges', 'capacity_grown', 'edge_capacity'):
      assert pinfo[k] == jinfo[k], k
    assert pm.compactions == jm.compactions == step
    assert pm.last_compaction_s > 0
  old = pm._retired
  assert not old                     # no reader held the old snapshots


@pytest.mark.parametrize('layout', ['CSR', 'CSC'])
def test_overlays_and_flipped_view_match_jax(layout):
  jm, pm, deltas = _managers(layout, weighted=False)
  jb, pb = _buffers(jm, pm)
  _stage(jb, *deltas[0])
  _stage(pb, *deltas[0])
  jo, po = jm.build_overlay(jb), pm.build_overlay(pb)
  assert set(po) == set(jo)
  for k in jo:
    np.testing.assert_array_equal(_np(po[k]), _np(jo[k]), err_msg=k)
  empty_j, empty_p = jm.empty_overlay(), pm.empty_overlay()
  for k in empty_j:
    np.testing.assert_array_equal(_np(empty_p[k]), _np(empty_j[k]))
  jf, pf = jm.current().flipped_topo(), pm.current().flipped_topo()
  assert pf.layout == jf.layout != layout
  np.testing.assert_array_equal(_np(pf.indptr), jf.indptr)
  np.testing.assert_array_equal(_np(pf.indices), jf.indices)
  ids = np.array([0, 3, 7, 11, 40])
  np.testing.assert_array_equal(pm.current().expand_affected(ids),
                                jm.current().expand_affected(ids))
  snap = pm.current()
  pm.compact(pb.drain())
  assert snap._retired and snap.freed


# -- the stream scenario on a CSC base -------------------------------------

N, EN, F, FANOUTS, B, SEED = 200, 1600, 12, [3, 2], 8, 0
ENV = {'GLT_DEDUP': 'sort', 'GLT_FUSED_HOP': '1'}
SEEDS = np.array([5, 0, 5, 17, 63, 2, 150, 9])


def _csc_scenario():
  rng = np.random.default_rng(1)
  ei = np.stack([rng.integers(0, N, EN), rng.integers(0, N, EN)])
  ei[:, :30] = ei[:, 30:60]
  x = rng.standard_normal((N, F)).astype(np.float32)
  jmodel = JaxGraphSAGE(hidden_features=16, out_features=5, num_layers=2)
  z = jnp.zeros((4,), jnp.int32)
  params = jax.jit(jmodel.init)(jax.random.key(1), JaxBatch(
      x=jnp.zeros((4, F)), row=z, col=z, edge_mask=jnp.zeros((4,), bool),
      node=z, node_count=jnp.zeros((), jnp.int32), batch_size=2))
  policy = dict(occupancy_threshold=2.0, max_staleness_s=1e9)

  jds = JaxDataset(edge_dir='in').init_graph(edge_index=ei, num_nodes=N)
  jds.init_node_features(x)
  jm = JaxSnapshotManager(jds.get_graph().topo, jds.get_node_feature(),
                          delta_capacity=64)
  js = JaxStreamSampler(jm, FANOUTS, edge_dir='in', seed=SEED)
  keys, next_key = [], js._next_key

  def record_key():
    keys.append(next_key())
    return keys[-1]
  js._next_key = record_key
  jeng = JaxEngine(jds, jmodel, params, FANOUTS, buckets=(B,), sampler=js)
  jing = JaxIngestor(jm, sampler=js, engine=jeng,
                     policy=JaxPolicy(**policy), expand_invalidation=True)

  ds = Dataset(edge_dir='in').init_graph(ei, num_nodes=N, device='cpu')
  ds.init_node_features(x, device='cpu')
  pm = SnapshotManager(ds.get_graph().topo, ds.get_node_feature(),
                       delta_capacity=64, device='cpu')
  ps = StreamSampler(pm, FANOUTS, edge_dir='in', seed=SEED)
  ps.hop_uniforms = lambda b: _uniforms(keys[-1], b, js)
  eng = InferenceEngine(ds, GraphSAGE(F, 16, 5, num_layers=2),
                        sage_params_from_flax(jax.tree.map(np.asarray,
                                                           params)),
                        FANOUTS, buckets=(B,), device='cpu', sampler=ps)
  ping = StreamIngestor(pm, sampler=ps, engine=eng,
                        policy=CompactionPolicy(**policy),
                        expand_invalidation=True)

  topo = jm.current().topo          # CSC: rows are destinations
  in5 = set(topo.indices[topo.indptr[5]:topo.indptr[6]].tolist())
  new_src = min(set(range(100, N)) - in5)   # not an in-neighbour of 5
  out = {'new_src': new_src, 'sample': {}, 'logits': []}

  def serve(state, step, requests):
    key = jax.random.key(100 + step)
    want = js.sample_from_nodes(SEEDS, n_valid=7, key=key)
    got = ps.sample_from_nodes(SEEDS, n_valid=7,
                               uniforms=_uniforms(key, B, js))
    out['sample'][state] = (want, got)
    for ids in requests:
      out['logits'].append((state, jeng.infer(np.array(ids)),
                            eng.infer(np.array(ids))))

  serve('startup', 0, ([5, 0, 5, 17, 63, 2], [0, 9, 9, 40, 2, 33, 61]))
  for ing in (jing, ping):
    # in-edges of 5, 151, 152 (the rows of a CSC base) from new sources
    ing.insert_edges([new_src, 151, 0, 17, int(ei[0, 0])],
                     [5, 5, 152, 0, 40])
    ing.delete_edges(ei[0, 30:33], ei[1, 30:33])   # multigraph deletes
    ing.delete_edges([int(topo.indices[topo.indptr[17]]),
                      int(topo.indices[topo.indptr[63]])], [17, 63])
    ing.update_features([5, 63, 120], np.full((3, F), 3.5, np.float32))
  serve('overlay', 1, ([5, 150, 11, 12], [0, 9]))
  out['info'] = (jing.flush(), ping.flush())
  out['snap'] = (jm.current(), pm.current())
  serve('compacted', 2, ([5, 0, 5, 17, 63, 2], [11, 12, 120, 150]))
  out['hits'] = (jeng.cache.hits, eng.cache.hits)
  return out


@pytest.fixture(scope='module')
def csc():
  with pytest.MonkeyPatch.context() as mp:
    for k, v in ENV.items():
      mp.setenv(k, v)
    yield _csc_scenario()


@pytest.mark.parametrize('state', STATES)
def test_csc_stream_samples_bit_identical_to_jax(csc, state):
  want, got = csc['sample'][state]
  for f in SAMPLE_KEYS:
    np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                  getattr(got, f).numpy(), err_msg=f)
  for f in ('seed_labels', 'seed_count', 'snapshot_version'):
    np.testing.assert_array_equal(np.asarray(want.metadata[f]),
                                  np.asarray(got.metadata[f]), err_msg=f)
  assert got.edge_hop_offsets == want.edge_hop_offsets


def test_csc_stream_reads_in_edges_and_compacts_as_jax(csc):
  # the overlay shows the pending in-edge (new_src -> 5) of seed 5: its
  # (parent, child) pair is (5, new_src), the child the in-neighbour
  _, got = csc['sample']['overlay']
  node, row, col, mask = (getattr(got, f).numpy()
                          for f in ('node', 'row', 'col', 'edge_mask'))
  pairs = {(int(node[c]), int(node[r])) for r, c, m in zip(row, col, mask)
           if m}
  assert (5, csc['new_src']) in pairs
  want, info = csc['info']
  np.testing.assert_array_equal(info['touched'], want['touched'])
  assert {5, 152, 0, 40, 17, 63} <= set(info['touched'].tolist())
  for k in ('version', 'num_edges', 'invalidated'):
    assert info[k] == want[k], k
  jsnap, psnap = csc['snap']
  assert psnap.topo.layout == 'CSC'
  for k in ('indptr', 'indices'):
    np.testing.assert_array_equal(psnap.arrays[k].numpy(),
                                  np.asarray(jsnap.arrays[k]), err_msg=k)
  np.testing.assert_array_equal(psnap.topo.edge_ids.numpy(),
                                jsnap.topo.edge_ids)


def test_csc_stream_logits_match_jax(csc):
  for state, want, got in csc['logits']:
    assert got.shape == want.shape
    np.testing.assert_allclose(want, got, rtol=1e-5, atol=1e-5,
                               err_msg=state)
  assert csc['hits'][0] == csc['hits'][1] > 0


def test_stream_sampler_refuses_the_other_layout():
  ds = Dataset(edge_dir='in').init_graph(np.array([[0, 1], [1, 2]]),
                                         num_nodes=3, device='cpu')
  mgr = SnapshotManager(ds.get_graph().topo, None, delta_capacity=4,
                        device='cpu')
  with pytest.raises(ValueError, match="edge_dir 'out' needs a CSR base, "
                     'manager holds CSC'):
    StreamSampler(mgr, [2], edge_dir='out')
  s = StreamSampler(mgr, [2, 1], tombstone_window=3)
  assert (s.edge_dir, s.num_hops, s.tombstone_window, s.delta_window) == (
      'in', 2, 3, 8)
  assert not s.is_hetero and not s.with_edge
  before = s._overlay
  s.set_overlay({'marker': 1})
  assert s._overlay == {'marker': 1}
  s.clear_overlay()
  assert s._overlay is before is mgr.empty_overlay()
