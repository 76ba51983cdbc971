"""The live-update stream's building blocks in the port (glt_tpu_torch.ops
sample_hop / delta / unique, glt_tpu_torch.stream buffers and snapshots)
against the JAX package on the same numpy inputs.

``sample_hop_plain`` is held against the interpret-mode Pallas
``sample_hop`` on the lanes its contract defines (valid lanes: invalid
lanes read the TPU window's clipped slot, the port the exact one). Every
other surface must match bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.data import Feature as JaxFeature
from glt_tpu.data import Topology as JaxTopology
from glt_tpu.ops.delta import delta_one_hop as jax_delta_one_hop
from glt_tpu.ops.sample import _hop_degrees as jax_hop_degrees
from glt_tpu.ops.pallas_kernels import sample_hop as jax_sample_hop
from glt_tpu.ops.unique import \
    sorted_hop_dedup_fused as jax_sorted_hop_dedup_fused
from glt_tpu.stream import EdgeDeltaBuffer as JaxEdgeDeltaBuffer
from glt_tpu.stream import FeatureDeltaCut as JaxFeatureDeltaCut
from glt_tpu.stream import SnapshotManager as JaxSnapshotManager
from glt_tpu.stream import StreamSampler as JaxStreamSampler
from glt_tpu_torch.data import Feature, Topology
from glt_tpu_torch.ops import cuda_kernels as K
from glt_tpu_torch.ops.delta import delta_one_hop
from glt_tpu_torch.ops.sample import _row_spans
from glt_tpu_torch.ops.unique import BIG, sorted_hop_dedup_fused
from glt_tpu_torch.stream import (EdgeDeltaBuffer, FeatureDeltaCut,
                                  SnapshotManager, StreamSampler)

W = 8


def _np(x):
  return np.asarray(x)


def test_sample_hop_plain_matches_pallas_sample_hop():
  # zeros, sub-fanout, mid, exactly W, hubs (> W) and a tail row whose
  # window crosses the real edge-array end (tests/test_pallas_hop.py's)
  deg = np.array([0, 2, 5, W, 20, 3, 17, 1, W - 1, 6], np.int64)
  rng = np.random.default_rng(7)
  indptr = np.zeros(len(deg) + 1, np.int64)
  np.cumsum(deg, out=indptr[1:])
  e = int(indptr[-1])
  indices = rng.integers(0, len(deg), e).astype(np.int32)
  eids = (np.arange(e) * 3 + 1).astype(np.int32)
  k = 4
  starts = indptr[:-1].astype(np.int32)
  offsets = np.minimum((rng.random((len(deg), k)) * deg[:, None]).astype(
      np.int32), np.maximum(deg[:, None] - 1, 0)).astype(np.int32)
  valid = np.arange(k)[None, :] < np.minimum(deg, k)[:, None]
  hubs = np.nonzero(deg > W)[0].astype(np.int32)
  hub_slots = np.clip(starts[hubs, None] + offsets[hubs], 0, e - 1)
  pad = np.full(W, -1, np.int32)
  want, want_e = jax_sample_hop(
      jnp.asarray(np.concatenate([indices, pad])),
      jnp.asarray(np.concatenate([eids, pad])), jnp.asarray(starts),
      jnp.asarray(offsets), jnp.asarray(hubs), jnp.asarray(hub_slots),
      width=W, interpret=True)
  got, got_e = K.sample_hop(torch.as_tensor(indices), torch.as_tensor(eids),
                            torch.as_tensor(starts), torch.as_tensor(offsets))
  assert K.sample_hop.launches == 0   # CPU tensors take the plain version
  np.testing.assert_array_equal(_np(want)[valid], got.numpy()[valid])
  np.testing.assert_array_equal(_np(want_e)[valid], got_e.numpy()[valid])
  # every lane is the clipped element read, hub rows past any cap included
  slots = np.clip(starts[:, None].astype(np.int64) + offsets, 0, e - 1)
  np.testing.assert_array_equal(got.numpy(), indices[slots])
  with pytest.raises(ValueError, match='empty edge array'):
    K.sample_hop_plain(torch.zeros(0, dtype=torch.int32), None,
                       torch.zeros(2, dtype=torch.int32),
                       torch.zeros((2, 3), dtype=torch.int32))


def test_edge_delta_buffer_matches_jax():
  ops = [('ins', [1, 2, 1], [3, 4, 3]), ('del', [1], [3]),
         ('ins', [1], [3]), ('del', [5, 6], [7, 8]), ('ins', [9], [2])]
  bufs = (JaxEdgeDeltaBuffer(capacity=16, num_nodes=12),
          EdgeDeltaBuffer(capacity=16, num_nodes=12))
  for kind, src, dst in ops:
    for b in bufs:
      (b.insert_edges if kind == 'ins' else b.delete_edges)(src, dst)
  for want, got in zip(bufs[0].view(), bufs[1].view()):
    np.testing.assert_array_equal(want, got)
  assert bufs[0].stats()['pending'] == bufs[1].stats()['pending']


def _graph(n=40, e=300, seed=1):
  rng = np.random.default_rng(seed)
  ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
  ei[:, :20] = ei[:, 20:40]   # multigraph: duplicated edges
  ei[:, 40:70] = [[3] * 30, rng.integers(0, n, 30)]   # a hub row
  return ei


def _managers(ei, n, delta_capacity=32, **kw):
  x = np.random.default_rng(2).standard_normal((n, 6)).astype(np.float32)
  jm = JaxSnapshotManager(JaxTopology(edge_index=ei, num_nodes=n),
                          JaxFeature(x), delta_capacity=delta_capacity, **kw)
  pm = SnapshotManager(Topology(ei, num_nodes=n, device='cpu'),
                       Feature(x, device='cpu'),
                       delta_capacity=delta_capacity, device='cpu', **kw)
  return jm, pm


def _stage(bufs, ei):
  # inserts (one duplicating a base edge), multigraph deletes of base
  # edges, a delete of an edge the base never held, then its reinsert
  for b in bufs:
    b.insert_edges([3, 3, 0, 7, 7], [11, 12, 5, 1, int(ei[1, 0])])
    b.delete_edges(ei[0, :3], ei[1, :3])
    b.delete_edges([3], [int(ei[1, 45])])
    b.delete_edges([8], [39])
    b.insert_edges([8], [39])


@pytest.mark.parametrize('fanout', [4, -1])
def test_delta_one_hop_matches_jax(fanout):
  n = 40
  ei = _graph(n)
  jm, pm = _managers(ei, n)
  bufs = (JaxEdgeDeltaBuffer(capacity=32, num_nodes=n),
          EdgeDeltaBuffer(capacity=32, num_nodes=n))
  _stage(bufs, ei)
  jo, po = jm.build_overlay(bufs[0]), pm.build_overlay(bufs[1])
  for k in jo:
    np.testing.assert_array_equal(_np(jo[k]), po[k].numpy(), err_msg=k)
  ja, pa = jm.current().arrays, pm.current().arrays
  frontier = np.array([3, 0, 7, 8, int(ei[0, 1]), 3, 25, BIG, 12],
                      np.int32)
  mask = np.array([1, 1, 1, 1, 1, 0, 1, 0, 1], bool)
  max_deg = int(np.diff(jm.current().topo.indptr).max())
  f = fanout if fanout > 0 else -max_deg
  key = jax.random.key(3)
  u = np.asarray(jax.random.uniform(key, (fanout, len(frontier)))).T \
      if fanout > 0 else None
  want = jax_delta_one_hop(
      ja['indptr'], ja['indices'], jo['ins_indptr'], jo['ins_indices'],
      jo['del_indptr'], jo['del_indices'], jnp.asarray(frontier), f, key,
      jnp.asarray(mask), ins_window=4, del_window=4)
  got = delta_one_hop(
      pa['indptr'], pa['indices'], po['ins_indptr'], po['ins_indices'],
      po['del_indptr'], po['del_indices'], torch.as_tensor(frontier), f,
      None if u is None else torch.as_tensor(u.copy()),
      torch.as_tensor(mask), ins_window=4, del_window=4)
  m = _np(want.mask)
  np.testing.assert_array_equal(m, got.mask.numpy())
  np.testing.assert_array_equal(_np(want.nbrs)[m], got.nbrs.numpy()[m])
  # the multigraph tombstone cleared every base copy under row 3
  row3 = got.nbrs.numpy()[0][got.mask.numpy()[0]]
  assert int(ei[1, 45]) not in row3.tolist()
  assert {11, 12} <= set(row3.tolist())


@pytest.mark.parametrize('layout', ['indptr', 'indptr_pad'])
def test_row_spans_match_jax_hop_degrees(layout):
  # one helper for the stream's [N + 1] CSR pointer and the walk's [N + 2]
  # indptr_pad (trailing num_edges sentinel): padded lanes (INT32_MAX),
  # out-of-range and masked ids read what jnp.take(mode='clip') reads
  indptr = np.array([0, 3, 3, 7, 12], np.int64)
  if layout == 'indptr_pad':
    indptr = np.append(indptr, indptr[-1])
  ids = np.array([0, 1, 2, 3, 4, 2 ** 31 - 1, 2, 0], np.int32)
  mask = np.array([1, 1, 1, 1, 1, 0, 0, 1], bool)
  want = jax.jit(jax_hop_degrees)(jnp.asarray(indptr.astype(np.int32)),
                                  jnp.asarray(ids), jnp.asarray(mask))
  got = _row_spans(torch.as_tensor(indptr), torch.as_tensor(ids),
                   torch.as_tensor(mask))
  for w, g in zip(want, got):
    np.testing.assert_array_equal(_np(w), g.numpy())


def test_sorted_hop_dedup_fused_matches_jax():
  rng = np.random.default_rng(4)
  u_ids = np.concatenate([rng.permutation(50)[:12],
                          np.full(5, BIG)]).astype(np.int32)
  u_labs = np.concatenate([np.arange(12), np.full(5, BIG)]).astype(np.int32)
  ids = rng.integers(0, 50, 64).astype(np.int32)
  valid = rng.random(64) < 0.8
  for case in ('mixed', 'none_valid', 'empty_seen'):
    v = valid if case != 'none_valid' else np.zeros(64, bool)
    ui, ul = (u_ids, u_labs) if case != 'empty_seen' else (
        u_ids[:0], u_labs[:0])
    # jitted: eager JAX would compile every op of it on first use
    want = jax.jit(jax_sorted_hop_dedup_fused)(
        jnp.asarray(ui), jnp.asarray(ul), jnp.asarray(12, jnp.int32),
        jnp.asarray(ids), jnp.asarray(v))
    got = sorted_hop_dedup_fused(torch.as_tensor(ui), torch.as_tensor(ul),
                                 torch.tensor(12, dtype=torch.int32),
                                 torch.as_tensor(ids), torch.as_tensor(v))
    for k in ('labels3', 'new_head3', 'u_ids2', 'u_labs2', 'count2',
              'new_count'):
      np.testing.assert_array_equal(_np(want[k]), got[k].numpy(),
                                    err_msg=f'{case} {k}')


def test_compaction_matches_jax():
  n = 40
  ei = _graph(n)
  jm, pm = _managers(ei, n, delta_capacity=8, edge_capacity=ei.shape[1] + 4)
  bufs = (JaxEdgeDeltaBuffer(capacity=32, num_nodes=n),
          EdgeDeltaBuffer(capacity=32, num_nodes=n))
  _stage(bufs, ei)
  rows = np.full((2, 6), 7.5, np.float32)
  old = pm.acquire()
  for step in range(2):
    cuts = [b.drain() for b in bufs]
    fids = np.array([4, 9]) + step
    js, jinfo = jm.compact(cuts[0], JaxFeatureDeltaCut(fids, rows))
    ps, pinfo = pm.compact(cuts[1], FeatureDeltaCut(fids, rows))
    for a, b in zip(js.topo.to_coo(), ps.topo.to_coo()):
      np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(js.topo.indptr, ps.topo.indptr.numpy())
    for k in ('indptr', 'indices'):
      np.testing.assert_array_equal(_np(js.arrays[k]), ps.arrays[k].numpy())
    for k in ('version', 'num_edges', 'capacity_grown', 'edge_capacity'):
      assert jinfo[k] == pinfo[k], k
    np.testing.assert_array_equal(jinfo['touched'], pinfo['touched'])
    np.testing.assert_array_equal(
        _np(js.feature.device_part), ps.feature.table.numpy())
    # one copy of the neighbour array per version: the Topology's live
    # edges are a view of the capacity-padded array the sampler reads
    assert (ps.topo.indices.untyped_storage().data_ptr()
            == ps.arrays['indices'].untyped_storage().data_ptr())
    for b in bufs:   # the second round: inserts only, past the capacity
      b.insert_edges(np.arange(12), np.full(12, 20))
  assert pinfo['capacity_grown'] and pm.capacity_growths == 1
  # RCU: the reader of version 0 keeps its arrays until it releases
  assert not old.freed and old.arrays['indices'].numel() == ei.shape[1] + 4
  assert old.feature.table[4, 0] != 7.5   # snapshot isolation
  pm.release(old)
  assert old.freed and old.arrays == {} and pm.num_retired == 0
  # the in-neighbour expansion used by cache invalidation
  np.testing.assert_array_equal(jm.current().expand_affected([5, 11]),
                                pm.current().expand_affected([5, 11]))



def test_full_neighbourhood_stream_matches_jax(monkeypatch):
  # -1 hops: the window is the startup max degree + the delta window, the
  # overlays exact over (base minus tombstones) plus inserts; no draw
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  n = 40
  ei = _graph(n)
  jm, pm = _managers(ei, n)
  js = JaxStreamSampler(jm, [-1, -1], delta_window=4, seed=0)
  ps = StreamSampler(pm, [-1, -1], delta_window=4, seed=0)
  assert ps.num_neighbors == [-f for f in js.num_neighbors]
  bufs = (JaxEdgeDeltaBuffer(capacity=32, num_nodes=n),
          EdgeDeltaBuffer(capacity=32, num_nodes=n))
  _stage(bufs, ei)
  js.refresh_overlay(bufs[0])
  ps.refresh_overlay(bufs[1])
  seeds = np.array([3, 0, 7, 8, 3, 25])
  want = js.sample_from_nodes(seeds, n_valid=5)
  got = ps.sample_from_nodes(seeds, n_valid=5)
  for f in ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch',
            'num_sampled_nodes', 'num_sampled_edges'):
    np.testing.assert_array_equal(_np(getattr(want, f)),
                                  getattr(got, f).numpy(), err_msg=f)
