"""The compile probe's and the gather microbench's kernels
(glt_tpu_torch/ops/probe_kernels.py, glt_tpu_torch/benchmarks/) against
the JAX package's probe rungs and vmem_take, on the same numpy inputs.

On the CPU every wrapper runs its plain version, so these pin the plain
versions to the TPU rungs' own references (and to a Pallas kernel in
interpret mode for vmem_take); tests/test_torch_cuda.py pins the CUDA
kernels to the plain versions on a card. Every comparison is exact.
"""
import importlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu_torch.benchmarks import probe_compile
from glt_tpu_torch.ops import cuda_kernels as K
from glt_tpu_torch.ops import probe_kernels as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DEFAULT_RNG = np.random.default_rng


def _jax_probe():
  """benchmarks/probe_pallas_compile.py, loaded from its file (the
  benchmarks folder is not a package)."""
  path = os.path.join(ROOT, 'benchmarks', 'probe_pallas_compile.py')
  spec = importlib.util.spec_from_file_location('_jax_probe', path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


class _RecordingRng:
  """numpy's generator, keeping every array it draws in order."""

  def __init__(self, seed):
    self.rng, self.draws = _DEFAULT_RNG(seed), []

  def normal(self, *a, **kw):
    self.draws.append(self.rng.normal(*a, **kw))
    return self.draws[-1]

  def integers(self, *a, **kw):
    self.draws.append(self.rng.integers(*a, **kw))
    return self.draws[-1]


def test_jax_probe_passes_every_rung_on_the_inputs_the_port_draws(
    monkeypatch, capsys):
  # the TPU ladder in interpret mode: every rung prints ok, and the
  # numpy draws it makes are the port's draw_inputs, in order
  rec = []

  def default_rng(seed):
    rec.append(_RecordingRng(seed))
    return rec[-1]
  mod = _jax_probe()
  monkeypatch.setattr(mod.np.random, 'default_rng', default_rng)
  mod.main()
  monkeypatch.undo()
  lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
           if ln.startswith('{')]
  assert lines[-1] == {n: 'ok' for n in probe_compile.KERNEL_OF}, lines
  assert [list(ln)[0] for ln in lines[:-1]] == list(probe_compile.KERNEL_OF)
  d = probe_compile.draw_inputs(0)
  drawn = [d['x'], d['big'], d['tab'], d['rows'], d['arr'], None,
           d['tab2d'], d['idx']]
  assert len(rec) == 1 and len(rec[0].draws) == len(drawn)
  for want, got in zip(drawn, rec[0].draws):
    if want is not None:   # the starts are sorted after the draw
      np.testing.assert_array_equal(want, got.astype(want.dtype))
  np.testing.assert_array_equal(
      d['starts'], np.sort(rec[0].draws[5].astype(np.int32)))


def test_plain_rungs_match_the_jax_rungs_references():
  d = probe_compile.draw_inputs(0)
  j = {k: jnp.asarray(v) for k, v in d.items()}
  want = {
      '1_vmem_id': j['x'],
      '2_smem_scalar': j['x'] * j['s'][0, 0].astype(jnp.float32),
      '3_dma_fixed': j['big'][256:384],
      '4_dma_dynamic': j['big'][512:640],
      '5_prefetch_grid': jnp.take(j['tab'], j['rows'], axis=0),
      '6_gather_windows': jnp.stack([
          jax.lax.dynamic_slice(j['arr'], (int(s),), (128,))
          for s in d['starts']]),
      '7_vmem_take2d': jnp.take(j['tab2d'].reshape(-1), j['idx'],
                                mode='clip'),
  }
  t = {k: torch.as_tensor(v) for k, v in d.items()}
  before = {fn.__name__: fn.launches for fn in P.KERNELS}
  for name, args in probe_compile.rung_args(t).items():
    for plain in (False, True):   # the CPU wrapper is the plain version
      got = probe_compile.call(name, args, plain=plain)
      np.testing.assert_array_equal(np.asarray(want[name]), got.numpy(),
                                    err_msg=name)
  assert {fn.__name__: fn.launches for fn in P.KERNELS} == before
  assert K.gather_windows.launches == 0


def test_probe_ladder_runs_on_the_cpu_when_asked(capsys):
  status = probe_compile.run(torch.device('cpu'))
  assert status == {n: 'ok' for n in probe_compile.KERNEL_OF}
  out = capsys.readouterr().out.splitlines()
  assert json.loads(out[-1]) == {n: 'ok' for n in probe_compile.KERNEL_OF}


@pytest.mark.parametrize('entry', ['probe_compile', 'microbench_gather'])
def test_benchmark_entry_points_raise_without_a_card(entry, monkeypatch):
  mod = importlib.import_module(f'glt_tpu_torch.benchmarks.{entry}')
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    mod.main([])


@pytest.mark.parametrize('start', [512, 513, 4090, 3968, 0, -5, -4096, 9000])
def test_dma_dynamic_plain_clamps_as_dynamic_slice(start):
  # the window's start is taken as lax.dynamic_slice (pl.ds in the TPU
  # rung's interpret mode) takes it: negative from the end, then clamped
  # into [0, n - 128]
  big = probe_compile.draw_inputs(0)['big']
  want = np.asarray(jax.lax.dynamic_slice(jnp.asarray(big), (start,),
                                          (128,)))
  st = torch.tensor([[start]], dtype=torch.int32)
  np.testing.assert_array_equal(
      want, P.dma_dynamic(torch.as_tensor(big), st).numpy())
  np.testing.assert_array_equal(
      want, P.dma_fixed(torch.as_tensor(big), start).numpy())


def test_vmem_take_plain_clips_as_take():
  rng = np.random.default_rng(5)
  tab = rng.integers(0, 1 << 20, (64, 128), dtype=np.int32)
  idx = rng.integers(-300, 8192 + 300, (8, 3840), dtype=np.int32)
  want = np.asarray(jnp.take(jnp.asarray(tab).reshape(-1),
                             jnp.asarray(idx), mode='clip'))
  got = P.vmem_take(torch.as_tensor(tab), torch.as_tensor(idx))
  np.testing.assert_array_equal(want, got.numpy())
  assert got.shape == idx.shape


def test_prefetch_grid_plain_clips_rows():
  rng = np.random.default_rng(6)
  tab = rng.normal(size=(64, 1, 128)).astype(np.float32)
  rows = np.array([0, 63, -1, 64, 7], np.int32)
  got = P.prefetch_grid(torch.as_tensor(tab), torch.as_tensor(rows))
  np.testing.assert_array_equal(
      np.asarray(jnp.take(jnp.asarray(tab), jnp.asarray(rows), axis=0,
                          mode='clip')), got.numpy())


def test_vmem_take_matches_the_microbench_pallas_kernel():
  # microbench_pallas_gather.py's vmem_take (:123-141), built here with
  # the same body and specs (its kernel is nested in main()), in
  # interpret mode at idx [16, 3840]
  from jax.experimental import pallas as pl
  tn, td = 64, 128
  rng = np.random.default_rng(0)
  table2d = rng.integers(0, 1 << 20, (tn, td), dtype=np.int32)
  ib = rng.integers(0, tn * td, 16 * 3840, dtype=np.int32).reshape(16, 3840)

  def vmem_take_kernel(tab_ref, idx_ref, out_ref):
    idx = idx_ref[:]
    tab = tab_ref[:]
    out_ref[:] = tab[idx >> 7, idx & 127]

  want = pl.pallas_call(
      vmem_take_kernel,
      grid=(ib.shape[0] // 8,),
      in_specs=[
          pl.BlockSpec((tn, td), lambda i: (0, 0)),
          pl.BlockSpec((8, 3840), lambda i: (i, 0)),
      ],
      out_specs=pl.BlockSpec((8, 3840), lambda i: (i, 0)),
      out_shape=jax.ShapeDtypeStruct(ib.shape, jnp.int32),
      interpret=True,
  )(jnp.asarray(table2d), jnp.asarray(ib))
  got = P.vmem_take(torch.as_tensor(table2d), torch.as_tensor(ib))
  np.testing.assert_array_equal(np.asarray(want), got.numpy())
  assert P.vmem_take.launches == 0


@pytest.mark.parametrize('n,m', [(1, 1), (1, 30_720), (4_097, 3),
                                 (4_097, 30_720), (8_192, 1),
                                 (8_192, 768_001)])
def test_vmem_take_plain_matches_take_at_the_kernels_edges(n, m):
  # the card kernel's edge shapes: a one-word table, a tail word past the
  # last 16-byte unit (4,097), the largest table; one index, a ragged
  # count (3, 768,001) and the rung's 30,720; indices negative and past
  # the end
  rng = np.random.default_rng(n + m)
  tab = rng.integers(-(1 << 30), 1 << 30, n, dtype=np.int32)
  idx = rng.integers(-n - 5, 2 * n + 5, m, dtype=np.int32)
  want = np.asarray(jnp.take(jnp.asarray(tab), jnp.asarray(idx),
                             mode='clip'))
  got = P.vmem_take(torch.as_tensor(tab), torch.as_tensor(idx))
  np.testing.assert_array_equal(want, got.numpy())
  np.testing.assert_array_equal(want, P.vt(torch.as_tensor(tab),
                                           torch.as_tensor(idx)).numpy())


@pytest.mark.parametrize('row_bytes,b', [(16, 1), (16, 153_600), (512, 1),
                                         (512, 16), (512, 153_600),
                                         (16_384, 16)])
def test_prefetch_grid_plain_matches_take_at_the_kernels_edges(row_bytes, b):
  # rows of one 16-byte unit, of the rung's 512 B and of the largest
  # 16 KB, at one row, the rung's 16 and the microbench's 153,600, rows
  # clipped at both ends
  rng = np.random.default_rng(row_bytes + b)
  n = 64 if row_bytes == 16_384 else 1_000
  tab = rng.normal(size=(n, row_bytes // 4)).astype(np.float32)
  rows = rng.integers(-3, n + 3, b, dtype=np.int32)
  rows[:2] = [-1, n][:b]
  want = np.asarray(jnp.take(jnp.asarray(tab), jnp.asarray(rows), axis=0,
                             mode='clip'))
  got = P.prefetch_grid(torch.as_tensor(tab), torch.as_tensor(rows))
  np.testing.assert_array_equal(want, got.numpy())


#: x values whose products the scale kernel must keep bit for bit: +-inf,
#: NaN, -0.0, subnormals, the smallest normal and a large finite value
_SCALE_SPECIALS = np.array([np.inf, -np.inf, np.nan, -0.0, 1e-40, -3e-45,
                            1.1754942e-38, 3.4e38], np.float32)


@pytest.mark.parametrize('s', [0, 3, -7, 16_777_217, -2 ** 31])
def test_smem_scalar_plain_matches_the_jax_rungs_expression(s):
  # rung 2's own expression, x * s[0, 0].astype(float32), bit patterns
  # compared (NaN is unequal to itself); 16,777,217 rounds to 16,777,216
  # as a float32, the int32 minimum is exact. XLA on the CPU, as the TPU,
  # flushes float32 subnormals to zero; the port keeps them as torch.mul
  # does (and the card kernel with it), so a lane whose x or product is
  # subnormal is held to numpy's IEEE product and JAX gives the zero of
  # the same sign there
  rng = np.random.default_rng(11)
  x = rng.normal(size=(128, 128)).astype(np.float32)
  x.reshape(-1)[:8] = _SCALE_SPECIALS
  x.reshape(-1)[-8:] = _SCALE_SPECIALS[::-1]
  sv = np.array([[s]], np.int32)
  want = np.asarray(jax.jit(lambda x, s: x * s[0, 0].astype(jnp.float32))(
      jnp.asarray(x), jnp.asarray(sv)))
  got = P.smem_scalar(torch.as_tensor(x), torch.as_tensor(sv)).numpy()
  with np.errstate(all='ignore'):
    ieee = x * np.float32(s)
  np.testing.assert_array_equal(ieee.view(np.int32), got.view(np.int32))
  tiny = np.finfo(np.float32).tiny
  sub = lambda a: (a != 0) & (np.abs(a) < tiny)
  flushed = sub(x) | sub(ieee)
  assert flushed.sum() == 6   # the subnormal x values, twice each
  np.testing.assert_array_equal(want[~flushed].view(np.int32),
                                got[~flushed].view(np.int32))
  assert np.all(want[flushed] == 0)
  np.testing.assert_array_equal(np.signbit(want[flushed]),
                                np.signbit(got[flushed]))


def test_count_launch_counts_by_the_capture_state_it_is_given():
  # the state comes from the entry point (csrc/entry.cuh): 0 launched,
  # RECORDED recorded into a CUDA graph; any other value is a CUresult
  # that raises, never a launch taken as not captured
  P.reset_launch_counts()
  assert K._check(0, 'smem_scalar') is False
  assert K._check(K.RECORDED, 'smem_scalar') is True
  for err in (1, 906, 901):   # invalid value, capture implicit, invalidated
    with pytest.raises(RuntimeError, match=f'CUresult {err}$'):
      K._check(err, 'smem_scalar')
  K.count_launch(P.smem_scalar, K._check(0, 'smem_scalar'))
  K.count_launch(P.smem_scalar, K._check(K.RECORDED, 'smem_scalar'))
  K.count_launch(P.smem_scalar, False, 3)
  K.count_launch(P.vt, True, 2)
  assert (P.smem_scalar.launches, P.smem_scalar.recorded) == (4, 1)
  assert (P.vt.launches, P.vt.recorded) == (0, 2)
  assert all(fn.launches == fn.recorded == 0 for fn in P.KERNELS
             if fn not in (P.smem_scalar, P.vt))
  P.reset_launch_counts()
  assert all(fn.launches == fn.recorded == 0 for fn in P.KERNELS)
