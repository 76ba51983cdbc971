"""``ops.stitch.stitch_rows`` and the sharded segment means of
``parallel.collectives`` against the JAX package on the same numpy
inputs.

``stitch_rows`` must match bit for bit, ``-1`` pads included. The two
segment means run over two gloo ranks (spawned through
tests/torch_spmd_worker.py's harness), each rank holding its own message
rows, against JAX's under ``jax.vmap(axis_name=)`` (its ``psum`` and
``psum_scatter`` over the mapped axis), within 1e-6: float32 sums in
another order. The JAX package is imported inside the tests, so a spawned
rank, which imports this module, starts without it.
"""
import numpy as np
import pytest
import torch

import torch_spmd_worker
from glt_tpu_torch.ops import stitch_rows
from glt_tpu_torch.parallel import (make_mesh, sharded_segment_mean,
                                    sharded_segment_mean_scattered)

TOL = 1e-6
WORLD, M, D, SEGMENTS = 2, 40, 6, 10
JOIN_S = 120


# -- stitch_rows ----------------------------------------------------------------

@pytest.mark.parametrize('dtype,trailing', [(np.float32, (5,)),
                                            (np.int32, ()),
                                            (np.float32, (2, 3))])
def test_stitch_rows_matches_jax(dtype, trailing):
  import jax.numpy as jnp
  from glt_tpu.ops.stitch import stitch_rows as jax_stitch_rows
  rng = np.random.default_rng(0)
  total = 23
  perm = rng.permutation(total)
  # three partitions of 9, 8 and 6 positions, each padded to 10 with -1,
  # position 0 among the real rows so that a pad would clobber it
  cut = np.split(perm, [9, 17])
  idx = [np.concatenate([c, np.full(10 - c.size, -1)]).astype(np.int32)
         for c in cut]
  idx[1][[0, 4]] = idx[1][[4, 0]]
  assert 0 in perm
  parts = [(rng.standard_normal((10,) + trailing) * 100).astype(dtype)
           for _ in idx]
  want = np.asarray(jax_stitch_rows([jnp.asarray(i) for i in idx],
                                    [jnp.asarray(p) for p in parts], total))
  got = stitch_rows([torch.as_tensor(i) for i in idx],
                    [torch.as_tensor(p) for p in parts], total)
  assert got.dtype == torch.as_tensor(parts[0]).dtype
  assert tuple(got.shape) == want.shape == (total,) + trailing
  np.testing.assert_array_equal(got.numpy(), want)
  # every real row landed at its position; no pad reached a real row
  for i, p in zip(idx, parts):
    ok = i >= 0
    np.testing.assert_array_equal(got.numpy()[i[ok]], p[ok])


def test_stitch_rows_leaves_unwritten_rows_zero():
  got = stitch_rows([torch.tensor([2, -1, -1])],
                    [torch.tensor([[1.5], [7.0], [8.0]])], 4)
  np.testing.assert_array_equal(got.numpy(), [[0.0], [0.0], [1.5], [0.0]])


# -- the sharded segment means ----------------------------------------------------

def _inputs(seed=0):
  """Per rank its message rows, targets (every segment reached, segment 3
  by masked rows only) and mask."""
  rng = np.random.default_rng(seed)
  msgs = rng.standard_normal((WORLD, M, D)).astype(np.float32)
  targets = rng.integers(0, SEGMENTS, (WORLD, M)).astype(np.int32)
  mask = rng.random((WORLD, M)) < 0.8
  mask[targets == 3] = False
  return msgs, targets, mask


def _jax_means(msgs, targets, mask):
  import jax
  import jax.numpy as jnp
  from glt_tpu.parallel import (sharded_segment_mean as jax_mean,
                                sharded_segment_mean_scattered as jax_scat)
  args = tuple(jnp.asarray(a) for a in (msgs, targets, mask))
  full = jax.vmap(lambda m, t, k: jax_mean(m, t, k, SEGMENTS, 'd'),
                  axis_name='d')(*args)
  scat = jax.vmap(lambda m, t, k: jax_scat(m, t, k, SEGMENTS, 'd'),
                  axis_name='d')(*args)
  return np.asarray(full), np.asarray(scat)


def _means_case(mesh, case):
  r = mesh.rank
  args = tuple(torch.as_tensor(case[k][r])
               for k in ('msgs', 'targets', 'mask'))
  out = {'full': sharded_segment_mean(*args, SEGMENTS, mesh).numpy(),
         'default': sharded_segment_mean(*args, SEGMENTS).numpy(),
         'scattered': sharded_segment_mean_scattered(*args, SEGMENTS,
                                                     mesh).numpy()}
  try:
    sharded_segment_mean_scattered(*args, SEGMENTS + 1, mesh)
  except ValueError as e:
    out['error'] = str(e)
  return out


def _run_cases(mesh, cases):
  return {name: _means_case(mesh, case) for name, case in cases.items()}


def rank_main(rank, world, store_path, in_path, out_path):
  """A spawned gloo rank of this module's cases."""
  torch_spmd_worker.run_rank(_run_cases, rank, world, store_path, in_path,
                             out_path)


def test_sharded_segment_means_match_jax_over_two_gloo_ranks(tmp_path):
  msgs, targets, mask = _inputs()
  want_full, want_scat = _jax_means(msgs, targets, mask)
  assert want_scat.shape == (WORLD, SEGMENTS // WORLD, D)
  res = torch_spmd_worker.spawn_ranks(
      rank_main, WORLD, {'means': dict(msgs=msgs, targets=targets,
                                       mask=mask)}, str(tmp_path), JOIN_S)
  for r, out in enumerate(res):
    got = out['means']
    # every rank holds the whole mean, through the mesh or the default group
    np.testing.assert_allclose(got['full'], want_full[r], rtol=0, atol=TOL)
    np.testing.assert_array_equal(got['default'], got['full'])
    # rank r holds segments [r * S / P, (r + 1) * S / P)
    np.testing.assert_allclose(got['scattered'], want_scat[r], rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(
        got['scattered'], got['full'][r * SEGMENTS // WORLD:
                                      (r + 1) * SEGMENTS // WORLD])
    assert 'must divide by the group size (2)' in got['error']
  # the empty segment's mean is 0; a plain mean over all rows agrees
  rows, seg = msgs.reshape(-1, D), targets.reshape(-1)
  ok = mask.reshape(-1)
  ref = np.stack([rows[ok & (seg == s)].mean(0) if (ok & (seg == s)).any()
                  else np.zeros(D, np.float32) for s in range(SEGMENTS)])
  np.testing.assert_allclose(res[0]['means']['full'], ref, rtol=0, atol=TOL)
  assert not res[0]['means']['full'][3].any()


def test_segment_means_on_one_rank_match_jax():
  # without a process group the mesh is one rank: the local mean, and the
  # scattered form is all of it (JAX over a one-device axis)
  msgs, targets, mask = _inputs(1)
  full, scat = _jax_means(msgs[:1], targets[:1], mask[:1])
  mesh = make_mesh(device='cpu')
  args = tuple(torch.as_tensor(a[0]) for a in (msgs, targets, mask))
  np.testing.assert_allclose(sharded_segment_mean(*args, SEGMENTS,
                                                  mesh).numpy(),
                             full[0], rtol=0, atol=TOL)
  np.testing.assert_allclose(sharded_segment_mean_scattered(
      *args, SEGMENTS, None).numpy(), scat[0], rtol=0, atol=TOL)
  # a ragged segment count divides by one rank
  assert tuple(sharded_segment_mean_scattered(
      *args, SEGMENTS + 1).shape) == (SEGMENTS + 1, D)
