"""Weighted and full-neighbourhood sampling in the port (the B3
``gather_windows`` window read, ``sample_neighbors_weighted``,
``sample_full_neighbors`` and the NeighborSampler's per-hop route)
against the JAX package on the same numpy inputs and the same uniforms
(drawn from the JAX keys and injected).

The JAX side is set up as on its TPU path: the window reads go through
its Pallas ``gather_windows`` (interpret mode, over the W-padded arrays
``Graph.window_arrays`` makes), the hop loop is the sort inducer with
fused hops (``GLT_DEDUP=sort GLT_FUSED_HOP=1``, what ``pallas_fused``
demotes to for weighted and -1 hops), and a uniform hop of a mixed list
reads through its ``pallas`` one-hop kernel. The sampled subgraph must
match bit for bit; a hop's picks on valid lanes and its mask too (masked
lanes read whatever each side's clip gives them).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.ops.pallas_kernels import gather_windows as jax_gather_windows
from glt_tpu.ops.sample import \
    sample_full_neighbors as jax_sample_full_neighbors
from glt_tpu.ops.sample import \
    sample_neighbors_weighted as jax_sample_neighbors_weighted
from glt_tpu.sampler import NeighborSampler as JaxNeighborSampler
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.ops import cuda_kernels as K
from glt_tpu_torch.ops.sample import (sample_full_neighbors,
                                      sample_neighbors_weighted)
from glt_tpu_torch.sampler import NeighborSampler

N, E = 80, 700
EXACT_KEYS = ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch',
              'num_sampled_nodes', 'num_sampled_edges')


def _graph(seed=0):
  """A CSR with degrees 0 to ~20 (rows 70.. have none), a few zero
  weights among weights in (0, 1]."""
  rng = np.random.default_rng(seed)
  src = (rng.random(E) ** 2 * 70).astype(np.int64)
  ei = np.stack([src, rng.integers(0, N, E)])
  w = (1.0 - rng.random(E)).astype(np.float32)
  w[::17] = 0.0
  return ei, w


def _csr(ei, w):
  ds = Dataset().init_graph(ei, edge_weights=w, num_nodes=N, device='cpu')
  g = ds.get_graph()
  return g.indptr.numpy(), g.indices.numpy(), g.edge_weights.numpy()


def _padded(a, width, fill):
  return jnp.concatenate([jnp.asarray(a), jnp.full((width,), fill, a.dtype)])


def _window_fn():
  return functools.partial(jax_gather_windows, interpret=True)


# -- B3 ------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [np.int32, np.float32])
def test_gather_windows_plain_matches_pallas(dtype):
  rng = np.random.default_rng(1)
  arr = rng.integers(0, 999, 500).astype(dtype)
  width = 24
  deg = rng.integers(0, width + 1, 37)
  starts = rng.integers(0, 500 - width, 37)
  starts[-3:] = [500 - 2, 500 - width, 0]      # tail rows, the first row
  deg[-3:] = [2, width, 5]
  got = K.gather_windows_plain(torch.as_tensor(arr),
                               torch.as_tensor(starts, dtype=torch.int32),
                               width).numpy()
  # the TPU kernel over the array padded by ``width`` sentinels, as
  # Graph.window_arrays pads it
  want = np.asarray(jax_gather_windows(
      _padded(arr, width, -1 if dtype == np.int32 else 0),
      jnp.asarray(starts, jnp.int32), width, interpret=True))
  assert got.dtype == dtype and got.shape == (37, width)
  valid = np.arange(width)[None, :] < deg[:, None]
  np.testing.assert_array_equal(got[valid], want[valid])
  # the port's contract on the unpadded array: every lane clips into it
  slots = np.clip(starts[:, None] + np.arange(width), 0, 499)
  np.testing.assert_array_equal(got, arr[slots])
  # the wrapper runs the plain version on CPU tensors and counts nothing
  before = K.gather_windows.launches
  out = K.gather_windows(torch.as_tensor(arr), torch.as_tensor(starts), 1)
  np.testing.assert_array_equal(out.numpy()[:, 0], arr[starts])
  assert K.gather_windows.launches == before


# -- one hop -------------------------------------------------------------------

def _hop_inputs(seed):
  indptr, indices, w = _csr(*_graph(seed))
  rng = np.random.default_rng(seed + 10)
  seeds = rng.integers(0, N, 40).astype(np.int32)
  seeds[:3] = np.argsort(-np.diff(indptr))[:3]   # the hub rows
  seeds[3] = 75                                  # degree 0
  mask = np.ones(40, bool)
  mask[5:8] = False
  return indptr, indices, w, seeds, mask


@pytest.mark.parametrize('fanout,max_degree', [(3, 12), (4, 24)])
def test_sample_neighbors_weighted_matches_jax(fanout, max_degree):
  indptr, indices, w, seeds, mask = _hop_inputs(2)
  assert np.diff(indptr).max() > 12          # 12 truncates the hubs
  key = jax.random.key(fanout)
  wk = dict(window_gather=lambda a, st, d: jax_gather_windows(
      a, st, width=d, interpret=True),
            window_sources={'edge_weights': _padded(w, max_degree, 0.0)})
  want = jax.jit(lambda *a: jax_sample_neighbors_weighted(
      *a, fanout, key, max_degree, seed_mask=jnp.asarray(mask), **wk))(
          jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(w),
          jnp.asarray(seeds))
  u = jax.random.uniform(key, (seeds.size, max_degree), minval=1e-20,
                         maxval=1.0)
  got = sample_neighbors_weighted(
      torch.as_tensor(indptr), torch.as_tensor(indices), torch.as_tensor(w),
      torch.as_tensor(seeds), fanout, torch.as_tensor(np.array(u)),
      max_degree, seed_mask=torch.as_tensor(mask))
  m = np.asarray(want.mask)
  np.testing.assert_array_equal(got.mask.numpy(), m)
  np.testing.assert_array_equal(got.nbrs.numpy()[m], np.asarray(want.nbrs)[m])
  assert m[:3].all() and not m[3].any() and not m[5:8].any()


@pytest.mark.parametrize('max_degree', [6, 30])
def test_sample_full_neighbors_matches_jax(max_degree):
  indptr, indices, _, seeds, mask = _hop_inputs(3)
  wk = dict(window_gather=lambda a, st, d: jax_gather_windows(
      a, st, width=d, interpret=True),
            window_sources={'indices': _padded(indices, max_degree, -1)})
  want = jax.jit(lambda *a: jax_sample_full_neighbors(
      *a, max_degree, seed_mask=jnp.asarray(mask), **wk))(
          jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(seeds))
  got = sample_full_neighbors(torch.as_tensor(indptr),
                              torch.as_tensor(indices),
                              torch.as_tensor(seeds), max_degree,
                              seed_mask=torch.as_tensor(mask))
  m = np.asarray(want.mask)
  np.testing.assert_array_equal(got.mask.numpy(), m)
  np.testing.assert_array_equal(got.nbrs.numpy()[m], np.asarray(want.nbrs)[m])
  assert int(m.sum()) > 0


# -- the sampler -------------------------------------------------------------

def hop_uniforms_from_key(key, batch_size, sampler):
  """The draws the JAX sampler's hop loop makes from ``key``: per hop
  ``key, sub = split(key)``; a uniform hop ``uniform(sub, (K, S_h))``
  transposed, a weighted hop ``uniform(sub, (S_h, window), minval=1e-20,
  maxval=1.0)``, a full hop nothing. ``sampler`` is the port's, whose
  resolved fanouts and windows equal the JAX sampler's."""
  us, s = [], batch_size
  for f in sampler.num_neighbors:
    key, sub = jax.random.split(key)
    if f < 0:
      us.append(None)
    elif sampler._weighted:
      us.append(torch.as_tensor(np.array(jax.random.uniform(
          sub, (s, sampler._weight_window(f)), minval=1e-20, maxval=1.0))))
    else:
      us.append(torch.as_tensor(np.asarray(
          jax.random.uniform(sub, (f, s))).T.copy()))
    s *= abs(f)
  return us


def to_tpu_path(s, monkeypatch):
  """Set the JAX NeighborSampler ``s`` up as the TPU path runs weighted
  and -1 hops: window reads through the (interpret-mode) Pallas gather,
  counted into ``s.window_reads`` while its program traces; the sort
  inducer with fused hops; uniform hops on the ``pallas`` engine."""
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  monkeypatch.setenv('GLT_WINDOW_W', '8')
  gather, s.window_reads = _window_fn(), []

  def counted(*a, **k):
    s.window_reads.append(k['width'])
    return gather(*a, **k)
  s._window_gather_fn = counted
  if not s.with_weight and any(f > 0 for f in s.num_neighbors):
    s._hop_engine_override = 'pallas'
  return s


@pytest.mark.parametrize('fanouts,with_weight', [
    ([3, 2], True), ([-1, -1], True), ([3, -1], True), ([3, -1], False)])
def test_sampler_matches_jax_tpu_path(fanouts, with_weight, monkeypatch):
  ei, w = _graph(4)
  jds = JaxDataset().init_graph(edge_index=ei, edge_weights=w, num_nodes=N)
  js = to_tpu_path(JaxNeighborSampler(jds.get_graph(), fanouts,
                                      with_weight=with_weight, seed=5),
                   monkeypatch)
  ds = Dataset().init_graph(ei, edge_weights=w, num_nodes=N, device='cpu')
  ps = NeighborSampler(ds.get_graph(), fanouts, device='cpu',
                       with_weight=with_weight, seed=5)
  assert ps.num_neighbors == js.num_neighbors
  seeds = np.array([3, 0, 3, 41, 75, 12, 1, 60])   # a repeat, a leaf
  for step, nv in enumerate((8, 6)):
    key = jax.random.key(20 + step)
    want = js.sample_from_nodes(seeds, n_valid=nv, key=key)
    got = ps.sample_from_nodes(seeds, n_valid=nv,
                               uniforms=hop_uniforms_from_key(key, 8, ps))
    for f in EXACT_KEYS:
      np.testing.assert_array_equal(getattr(got, f).numpy(),
                                    np.asarray(getattr(want, f)), err_msg=f)
    for f in ('seed_labels', 'seed_count'):
      np.testing.assert_array_equal(got.metadata[f].numpy(),
                                    np.asarray(want.metadata[f]), err_msg=f)
    assert got.edge_hop_offsets == want.edge_hop_offsets
    assert int(got.num_sampled_edges[-1]) > 0
  # every weighted or -1 hop of the JAX program read through the window
  # kernel; a uniform hop ran the pallas engine
  assert len(js.window_reads) == sum(f < 0 or with_weight for f in fanouts)
  assert js._resolved_hop_engine() == ('element' if with_weight
                                       else 'pallas')


def test_sampler_refuses_what_is_not_ported():
  ei, w = _graph(5)
  g = Dataset().init_graph(ei, edge_weights=w, num_nodes=N,
                           device='cpu').get_graph()
  # with_edge and replace are served by the per-hop loop since the
  # single-device options came across (tests/test_torch_sampler_options.py)
  for kw in (dict(with_edge=True), dict(replace=True)):
    s = NeighborSampler(g, [3, 2], device='cpu', with_weight=True, **kw)
    out = s.sample_from_nodes(np.arange(4))
    assert s._per_hop and (out.edge is not None) == ('with_edge' in kw)
  with pytest.raises(ValueError, match='positive or -1'):
    NeighborSampler(g, [3, -2], device='cpu')
  # without weights a weighted sampler's hops stay uniform (per-hop loop)
  ds = Dataset().init_graph(ei, num_nodes=N, device='cpu')
  s = NeighborSampler(ds.get_graph(), [3, 2], device='cpu', with_weight=True)
  assert s._per_hop and not s._weighted
  assert [tuple(u.shape) for u in s.hop_uniforms(4)] == [(4, 3), (12, 2)]
