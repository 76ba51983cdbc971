"""What the per-hop loop hands the window and hop kernels.

On the card ``sample_hop`` (B2) and ``gather_windows`` (B3) check their
inputs and convert nothing: int32 ``starts`` and ``offsets``, int32
neighbour ids, a one-dimensional array of 4-byte elements, all
contiguous. These tests run the weighted, full, uniform and stream hops
on the CPU with both wrappers replaced by recorders and hold every call
to that contract, for the hop functions and for the samplers that drive
them on the main paths.
"""
import numpy as np
import pytest
import torch

from glt_tpu_torch.data import Dataset, Feature, Topology
from glt_tpu_torch.ops import cuda_kernels as K
from glt_tpu_torch.ops.delta import delta_one_hop
from glt_tpu_torch.ops.sample import (sample_full_neighbors,
                                      sample_neighbors,
                                      sample_neighbors_weighted,
                                      weighted_hop_uniforms)
from glt_tpu_torch.sampler import NeighborSampler
from glt_tpu_torch.stream import EdgeDeltaBuffer, SnapshotManager, StreamSampler

N, E = 60, 500


def _edges(seed=0):
  rng = np.random.default_rng(seed)
  src = (rng.random(E) ** 2 * 50).astype(np.int64)   # rows 50.. are leaves
  ei = np.stack([src, rng.integers(0, N, E)])
  w = (1.0 - rng.random(E)).astype(np.float32)
  w[::11] = 0.0
  return ei, w


def _contiguous_1d(t, dtype=None):
  return (t.dim() == 1 and t.is_contiguous()
          and (t.element_size() == 4 if dtype is None else t.dtype == dtype))


@pytest.fixture
def calls(monkeypatch):
  """Replace both wrappers by recorders that check every call against
  the contract and answer with the plain version."""
  seen = {'sample_hop': 0, 'gather_windows': 0}

  def sample_hop(indices, eids, starts, offsets):
    assert _contiguous_1d(indices, torch.int32), (indices.dtype,
                                                  indices.stride())
    assert eids is None or _contiguous_1d(eids, torch.int32)
    assert _contiguous_1d(starts, torch.int32), (starts.dtype,
                                                 starts.stride())
    assert (offsets.dim() == 2 and offsets.dtype == torch.int32
            and offsets.is_contiguous()), (offsets.dtype, offsets.stride())
    seen['sample_hop'] += 1
    return K.sample_hop_plain(indices, eids, starts, offsets)

  def gather_windows(arr, starts, width):
    assert _contiguous_1d(arr), (arr.dtype, arr.shape, arr.stride())
    assert _contiguous_1d(starts, torch.int32), (starts.dtype,
                                                 starts.stride())
    assert isinstance(width, int) and width > 0
    seen['gather_windows'] += 1
    return K.gather_windows_plain(arr, starts, width)

  monkeypatch.setattr(K, 'sample_hop', sample_hop)
  monkeypatch.setattr(K, 'gather_windows', gather_windows)
  return seen


def _stream_manager(ei, staged=True):
  mgr = SnapshotManager(Topology(ei, num_nodes=N, device='cpu'),
                        Feature(np.zeros((N, 4), np.float32), device='cpu'),
                        delta_capacity=32, device='cpu')
  buf = EdgeDeltaBuffer(capacity=32, num_nodes=N)
  if staged:
    buf.insert_edges([3, 3, 0, 7], [11, 12, 5, 1])
    buf.delete_edges(ei[0, :3], ei[1, :3])
  return mgr, buf


@pytest.mark.parametrize('hop', ['weighted', 'full', 'uniform', 'stream'])
def test_hop_hands_the_kernels_their_contract(hop, calls):
  ei, w = _edges()
  g = Dataset().init_graph(ei, edge_weights=w, num_nodes=N,
                           device='cpu').get_graph()
  # int64 seeds with an invalid lane: the hop functions narrow them
  seeds = torch.tensor([3, 0, 41, 55, 12, 1, 3, 2 ** 31 - 1])
  mask = torch.tensor([1, 1, 1, 1, 1, 1, 0, 0], dtype=torch.bool)
  d = g.topo.max_degree
  gen = torch.Generator().manual_seed(0)
  if hop == 'weighted':
    out = sample_neighbors_weighted(
        g.indptr, g.indices, g.edge_weights, seeds, 3,
        weighted_hop_uniforms(gen, seeds.numel(), d, 'cpu'), d,
        seed_mask=mask)
    want = {'sample_hop': 1, 'gather_windows': 1}
  elif hop == 'full':
    out = sample_full_neighbors(g.indptr, g.indices, seeds, d,
                                seed_mask=mask)
    want = {'sample_hop': 0, 'gather_windows': 1}
  elif hop == 'uniform':
    out = sample_neighbors(g.indptr, g.indices, seeds, 4,
                           torch.rand((seeds.numel(), 4), generator=gen),
                           seed_mask=mask)
    want = {'sample_hop': 1, 'gather_windows': 0}
  else:
    mgr, buf = _stream_manager(ei)
    a = dict(mgr.current().arrays, **mgr.build_overlay(buf))
    out = delta_one_hop(
        a['indptr'], a['indices'], a['ins_indptr'], a['ins_indices'],
        a['del_indptr'], a['del_indices'], seeds, 4,
        torch.rand((seeds.numel(), 4), generator=gen), mask, ins_window=4,
        del_window=4)
    want = {'sample_hop': 1, 'gather_windows': 2}
  assert calls == want
  assert int(out.mask.sum()) > 0 and not bool(out.mask[-2:].any())


@pytest.mark.parametrize('path', ['weighted', 'mixed', 'stream',
                                  'stream_full'])
def test_samplers_hand_the_kernels_their_contract(path, calls):
  ei, w = _edges(1)
  seeds = np.array([3, 0, 3, 41, 55, 12, 1, 20])
  if path in ('weighted', 'mixed'):
    ds = Dataset().init_graph(ei, edge_weights=w, num_nodes=N, device='cpu')
    s = NeighborSampler(ds.get_graph(), [3, 2] if path == 'weighted'
                        else [3, -1], device='cpu',
                        with_weight=path == 'weighted', seed=5)
    want = ({'sample_hop': 2, 'gather_windows': 2} if path == 'weighted'
            else {'sample_hop': 1, 'gather_windows': 1})
  else:
    mgr, buf = _stream_manager(ei)
    s = StreamSampler(mgr, [3, 2] if path == 'stream' else [-1, -1],
                      delta_window=4, seed=0)
    s.refresh_overlay(buf)
    want = {'sample_hop': 2 if path == 'stream' else 0,
            'gather_windows': 4 if path == 'stream' else 6}
  out = s.sample_from_nodes(seeds, n_valid=7)
  assert calls == want
  assert int(out.num_sampled_edges.sum()) > 0
