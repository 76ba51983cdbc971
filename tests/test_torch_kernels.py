"""The port's kernels (glt_tpu_torch/ops/cuda_kernels.py) against the JAX
package's Pallas kernels, run in interpret mode, on the same numpy
inputs.

On the CPU every wrapper runs its plain PyTorch version (the tensors lie
on the CPU), so these cases pin the plain versions to the TPU kernels;
tests/test_torch_cuda.py pins the CUDA kernels to the plain versions on
a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.data import Topology as JaxTopology
from glt_tpu.ops import pallas_kernels as jpk
from glt_tpu.ops.pipeline import sample_budget
from glt_tpu.ops.sample import hop_valid_mask as jax_hop_valid_mask
from glt_tpu.ops.sample import walk_hop_uniforms as jax_walk_hop_uniforms
from glt_tpu.ops.unique import sorted_hop_dedup as jax_sorted_hop_dedup
from glt_tpu_torch.ops import cuda_kernels as K
from glt_tpu_torch.ops.sample import walk_geometry
from glt_tpu_torch.ops.unique import sorted_hop_dedup
from glt_tpu_torch.utils import resolve_device
from glt_tpu_torch.utils.offload import PinnedHost

W = 8  # JAX window width: small enough that hub rows (deg > W) exist


def _graph(n=64, e=600, seed=0):
  rng = np.random.default_rng(seed)
  src = rng.integers(0, n, e)
  dst = rng.integers(0, n, e)
  t = JaxTopology(edge_index=np.stack([src, dst]), num_nodes=n)
  indptr = t.indptr.astype(np.int32)
  indices = t.indices.astype(np.int32)
  return dict(n=n, e=e, indptr=indptr, indices=indices,
              indptr_pad=np.concatenate([indptr, [e]]).astype(np.int32))


def _seed_hop_np(seeds, nv):
  """The JAX exact seed hop, as numpy."""
  zero = jnp.zeros((0,), jnp.int32)
  mask = jnp.arange(seeds.shape[0]) < nv
  d = jax_sorted_hop_dedup(zero, zero, jnp.zeros((), jnp.int32),
                           jnp.asarray(seeds), mask)
  return {k: np.asarray(v) for k, v in d.items()}


# -- gather_rows --------------------------------------------------------------

def test_gather_rows_matches_pallas_kernel_with_clipping():
  rng = np.random.default_rng(0)
  table = rng.standard_normal((50, 100)).astype(np.float32)
  # padded node lanes are -1 and must read row 0 (clip), not the last
  # row (torch's wrap); ids past N clip to N-1
  rows = np.concatenate([rng.integers(0, 50, 30), [-1, -7, 50, 99, 0, 49]])
  rows = rows.astype(np.int32)
  want = np.asarray(jpk.gather_rows(jnp.asarray(table), jnp.asarray(rows),
                                    interpret=True))
  got = K.gather_rows(torch.as_tensor(table), torch.as_tensor(rows))
  np.testing.assert_array_equal(want, got.numpy())
  assert K.gather_rows.launches == 0  # the CPU runs the plain version


@pytest.mark.parametrize('dtype,width', [('bfloat16', 101), ('uint8', 7),
                                         ('bfloat16', 100),
                                         ('float32', 1024)])
def test_narrow_rows_match_pallas_kernel(dtype, width):
  # rows that are not whole 16-byte vectors (K3 realigns them on the card:
  # bf16 x 101 and x 100, uint8 x 7) and a wide row (float32 x 1024,
  # several passes): the Feature gather and the plain version equal
  # the TPU kernel, bit for bit (exact)
  from glt_tpu_torch.data.feature import Feature
  rng = np.random.default_rng(3)
  n = 40 if width < 1000 else 12
  rows = np.concatenate([rng.integers(0, n, 30), [-1, n, 0, n - 1]])
  rows = rows.astype(np.int32)
  if dtype == 'uint8':
    table = rng.integers(0, 256, (n, width)).astype(np.uint8)
    jt, pt = jnp.asarray(table), torch.as_tensor(table)
  elif dtype == 'float32':
    table = rng.standard_normal((n, width)).astype(np.float32)
    jt, pt = jnp.asarray(table), torch.as_tensor(table)
  else:   # both sides round the same float32 draw to bf16
    table = rng.standard_normal((n, width)).astype(np.float32)
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    pt = torch.as_tensor(table).to(torch.bfloat16)
  want = jpk.gather_rows(jt, jnp.asarray(rows), interpret=True)
  if dtype == 'bfloat16':
    want = jax.lax.bitcast_convert_type(want, jnp.uint16).astype(jnp.int32)
  want = np.asarray(want)
  feat = Feature(pt, device='cpu')
  for got in (feat.device_gather(torch.as_tensor(rows)),
              K.gather_rows_plain(pt, torch.as_tensor(rows))):
    assert got.dtype == pt.dtype and tuple(got.shape) == (rows.size, width)
    if dtype == 'bfloat16':
      got = got.view(torch.int16).to(torch.int32) & 0xFFFF
    np.testing.assert_array_equal(want, got.numpy())


def _k3_lane_plan(mem, blocks, rb, rows, lay):
  """csrc/gather_rows.cu's lane plan in numpy, over the bytes ``mem``
  whose index 0 stands for a 16-byte-aligned address, in the layout
  ``lay``. ``blocks`` is the table's ``[(base, n)]`` (rows of ``rb`` bytes
  from byte ``base``), or a split store's ``[(hot base, H), (cold base,
  C)]``, whose row r >= H lives at cold row r - H. Every vector load is
  checked to lie in its row's cover and inside the row's own block, every
  row to fit its lanes and passes; returns the output bytes and 16 bytes
  of slack past them, which nothing may write."""
  lanes, realign, passes = lay
  per = lanes - realign
  n_rows = sum(n for _, n in blocks)
  out = np.full(rows.size * rb + 16, 0xA5, np.uint8)

  def put(o, lo, data):   # bytes at [lo, lo + len) of output vector o
    out[16 * o + lo:16 * o + lo + len(data)] = data

  for i, r in enumerate(rows):
    r = min(max(int(r), 0), n_rows - 1)
    base, n = blocks[0]
    if r >= n:
      r -= n
      base, n = blocks[1]
    end = base + n * rb
    src = base + r * rb
    ob = i * rb
    oh = ob % 16 if realign else 0
    c0, c1 = src // 16, (src + rb - 1) // 16
    q0, d = divmod(src - oh, 16)
    if not realign:
      assert d == 0 and rb % 16 == 0, 'copy mode on a shifted row'
    nv = (oh + rb - 1) // 16 + 1
    tail = (oh + rb - 1) % 16 + 1
    assert nv <= passes * per, 'the row does not fit its lanes'
    if not (16 * c0 >= base and 16 * (c1 + 1) <= end):   # byte path
      out[ob:ob + rb] = mem[src:src + rb]
      continue
    for p in range(passes):
      js = p * per + np.arange(lanes)
      v = np.zeros((lanes, 16), np.uint8)
      for t, j in enumerate(js):
        if c0 <= q0 + j <= c1:
          q = q0 + j
          assert 16 * q >= base and 16 * (q + 1) <= end
          v[t] = mem[16 * q:16 * q + 16]
      hi = np.concatenate([v[1:], v[-1:]])    # the shuffle from lane t + 1
      x = np.concatenate([v, hi], axis=1)[:, d:d + 16]
      for t, j in enumerate(js):
        if t < per and j < nv:
          lo_b = oh if j == 0 else 0
          hi_b = tail if j == nv - 1 else 16
          put(ob // 16 + j, lo_b, x[t, lo_b:hi_b])
  return out


@pytest.mark.parametrize('offset', [0, 1, 2, 3])
def test_gather_rows_layout_reads_only_each_rows_cover(offset):
  # K3's layout at a table base `offset` bytes past a 16-byte boundary,
  # and over a split store whose hot block starts there and whose cold
  # block starts at another offset, past a gap: every row fits its T lanes
  # and passes, no lane loads a vector outside its row's cover or its own
  # block, nothing is written past the output, and the kernel's plan
  # (realign, byte-exact pieces, the byte path of each block's edge rows)
  # gathers exactly the clamped rows
  rng = np.random.default_rng(offset)
  n, b, h = 24, 70, 9
  rows = np.concatenate([rng.integers(-2, n + 2, b - 6),
                         [0, n - 1, -1, n, h - 1, h]])
  base = 32 + offset
  for rb in [*range(1, 65), 200, 202, 400, 4096]:
    lay = K.gather_rows_layout(rb, base)
    assert lay.lanes in (1, 2, 4, 8, 16, 32)
    assert lay.passes == 1 or lay.lanes == 32   # what the kernel launches
    assert lay.realign == bool(rb % 16 or offset)
    assert lay.lanes > 1 or not lay.realign   # a neighbour to shuffle
    mem = rng.integers(0, 256, base + n * rb + 48, dtype=np.uint8)
    got = _k3_lane_plan(mem, [(base, n)], rb, rows, lay)
    want = mem[base:base + n * rb].reshape(n, rb)[np.clip(rows, 0, n - 1)]
    np.testing.assert_array_equal(got[:b * rb], want.reshape(-1),
                                  err_msg=f'row_bytes {rb}')
    assert (got[b * rb:] == 0xA5).all(), rb
    # two blocks: hot rows [0, h) at `base`, cold rows [h, n) at a base
    # 16 * 3 + (offset + 2) % 4 bytes past the hot block's end
    cold = base + h * rb + 48 + (offset + 2) % 4
    lay = K.gather_rows_layout(rb, base | cold)
    assert lay.realign == bool(rb % 16 or offset or cold % 16)
    mem = rng.integers(0, 256, cold + (n - h) * rb + 48, dtype=np.uint8)
    got = _k3_lane_plan(mem, [(base, h), (cold, n - h)], rb, rows, lay)
    table = np.concatenate([mem[base:base + h * rb],
                            mem[cold:cold + (n - h) * rb]]).reshape(n, rb)
    np.testing.assert_array_equal(got[:b * rb],
                                  table[np.clip(rows, 0, n - 1)].reshape(-1),
                                  err_msg=f'two blocks, row_bytes {rb}')
    assert (got[b * rb:] == 0xA5).all(), rb


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('split', [0.0, 0.3, 1.0])
def test_gather_rows_mixed_matches_jax_mixed_gather(dtype, split):
  # the split store's gather (on the CPU its plain version) against the
  # JAX store's gather_mixed over a pinned-host cold block, on every lane
  # but -1, which the port clamps to row 0 and jnp.take wraps; rows past
  # the end read row N - 1 on both
  from glt_tpu.data import Feature as JaxFeature
  rng = np.random.default_rng(12)
  n, d = 30, 11
  table = rng.standard_normal((n, d)).astype(np.float32)
  rows = np.concatenate([rng.integers(0, n, 40), [0, n - 1, n, n + 7, -1]])
  rows = rows.astype(np.int32)
  jdt, pdt = ((jnp.bfloat16, torch.bfloat16) if dtype == 'bfloat16'
              else (jnp.float32, torch.float32))
  jf = JaxFeature(table, split_ratio=split, dtype=jdt)
  h = jf.hot_count
  pt = torch.as_tensor(table).to(pdt)
  got = K.gather_rows_mixed(pt[:h], pt[h:], torch.as_tensor(rows))
  assert K.gather_rows_mixed.launches == 0  # the CPU runs the plain version
  np.testing.assert_array_equal(
      got.view(torch.int16).numpy() if pdt == torch.bfloat16 else got.numpy(),
      K.gather_rows_plain(pt, torch.as_tensor(rows)).view(
          torch.int16 if pdt == torch.bfloat16 else pdt).numpy())
  if split == 1.0:
    return       # nothing spilled: the JAX store has no gather_mixed
  want = np.asarray(jf.gather_mixed(jnp.asarray(rows))).astype(np.float32)
  np.testing.assert_array_equal(got.float().numpy()[:-1], want[:-1])


def test_gather_rows_mixed_plain_takes_the_pinned_owner():
  # the plain twin takes the wrapper's arguments, so a path swapped to
  # plain versions may hand it a split store's PinnedHost
  rng = np.random.default_rng(4)
  table = torch.as_tensor(rng.standard_normal((20, 6)).astype(np.float32))
  rows = torch.as_tensor(rng.integers(-2, 23, 50))
  owner = PinnedHost(table[8:], 0, torch.device('cuda', 0))
  got = K.gather_rows_mixed_plain(table[:8], owner, rows)
  assert torch.equal(got, K.gather_rows_mixed_plain(table[:8], table[8:],
                                                    rows))
  assert torch.equal(got, K.gather_rows_plain(table, rows))


# -- dedup_table_insert -------------------------------------------------------

def _jax_table_dict(tab_ids, tab_labs):
  ids, labs = np.asarray(tab_ids).ravel(), np.asarray(tab_labs).ravel()
  return {int(i): int(l) for i, l in zip(ids, labs) if i >= 0}


def _port_table_dict(keys, vals):
  k, v = keys.numpy(), vals.numpy()
  return {int(i): int(l) for i, l in zip(k, v) if i >= 0}


def test_dedup_table_insert_lookup_matches_pallas_kernel():
  rng = np.random.default_rng(1)
  first_ids = rng.choice(5000, 300, replace=False).astype(np.int32)
  first_ids[::17] = -1                     # skipped: negative ids
  first_labs = rng.integers(0, 1 << 20, 300).astype(np.int32)
  first_ok = (rng.random(300) < 0.9).astype(np.int32)   # invalid slots
  # the second insert overlaps the first: present ids keep their labels
  again = np.concatenate([first_ids[:100],
                          rng.choice(np.arange(5000, 6000), 50,
                                     replace=False)]).astype(np.int32)
  again_labs = rng.integers(0, 1 << 20, again.size).astype(np.int32)
  again_ok = np.ones(again.size, np.int32)

  jt = jpk.make_dedup_table(1024)
  jt = jpk.dedup_table_insert(*jt, jnp.asarray(first_ids),
                              jnp.asarray(first_labs),
                              jnp.asarray(first_ok), interpret=True)
  jt = jpk.dedup_table_insert(*jt, jnp.asarray(again),
                              jnp.asarray(again_labs),
                              jnp.asarray(again_ok), interpret=True)
  keys, vals, _ = K.make_dedup_table(1024, 'cpu')
  for ids, labs, ok in ((first_ids, first_labs, first_ok),
                        (again, again_labs, again_ok)):
    K.dedup_table_insert(keys, vals, torch.as_tensor(ids),
                         torch.as_tensor(labs), torch.as_tensor(ok))
  want = _jax_table_dict(*jt)
  assert _port_table_dict(keys, vals) == want
  probe = np.concatenate([first_ids, again, [7777, -1]])
  got = K.dedup_table_lookup(keys, vals, torch.as_tensor(probe)).numpy()
  np.testing.assert_array_equal(
      got, [want.get(int(i), -1) for i in probe])


def test_dedup_table_init_matches_pallas_init_table():
  # the hetero walk's seed phase: JAX's init_table (make_dedup_table, then
  # dedup_table_insert of the type-tagged seed uniques, interpret mode)
  # against the port's one-call init and its plain twin; the layouts
  # differ, so lookups of every seed and of 64 absent ids are compared
  seeds = np.array([9, 3, 9, 40, 3, 17, 0, 255, 71, 9, 6, 6], np.int32)
  d = _seed_hop_np(seeds, 10)     # the last two lanes are padding
  base, slots = 1000, 1024
  tagged = np.where(d['new_head3'], d['ids3'] + base, -1).astype(np.int32)
  jt = jpk.dedup_table_insert(
      *jpk.make_dedup_table(slots), jnp.asarray(tagged),
      jnp.asarray(d['labels3']),
      jnp.asarray(d['new_head3'].astype(np.int32)), interpret=True)
  want = _jax_table_dict(*jt)
  assert len(want) == len(set(seeds[:10].tolist()))
  probe = np.concatenate([seeds + base,
                          np.arange(5000, 5064)]).astype(np.int32)
  args = (slots, torch.as_tensor(d['ids3']), torch.as_tensor(d['labels3']),
          torch.as_tensor(d['new_head3']), base, 'cpu')
  for keys, vals, first in (K.dedup_table_init(*args),
                            K.dedup_table_init_plain(*args)):
    assert keys.numel() == vals.numel() == first.numel() == slots
    assert bool((first == K.BIG).all())
    got = K.dedup_table_lookup(keys, vals, torch.as_tensor(probe)).numpy()
    np.testing.assert_array_equal(
        got, [want.get(int(i), -1) for i in probe])
  assert K.dedup_table_insert.launches == 0   # the CPU runs the plain twin


# -- sample_walk_dedup ----------------------------------------------------------

def _walk_inputs(g, seeds, nv, fanouts, key, replace=False):
  d = _seed_hop_np(seeds, nv)
  stab_ids = np.where(d['new_head3'], d['ids3'], -1).astype(np.int32)
  u = [np.asarray(x) for x in jax_walk_hop_uniforms(
      key, seeds.shape[0], fanouts, replace)]
  return d, stab_ids, u


def test_walk_picks_and_heads_match_pallas_kernel():
  g = _graph(seed=2)
  seeds = np.array([5, 0, 5, 17, 63, 2, 2, 9], np.int32)
  nv, fanouts, key = 7, (3, 2), jax.random.key(9)
  b = seeds.shape[0]
  d, stab_ids, u = _walk_inputs(g, seeds, nv, fanouts, key)
  jhops, _ = jpk.walk_geometry(b, fanouts)
  iw = np.concatenate([g['indices'], np.full(W, -1, np.int32)])
  picks, _, _, newh = jpk.sample_walk_dedup(
      jnp.asarray(iw), None, jnp.asarray(g['indptr_pad']),
      jnp.asarray(d['ids3']), jnp.asarray(d['new_head3'].astype(np.int32)),
      jnp.asarray(stab_ids), jnp.asarray(d['labels3']),
      jnp.asarray(d['count2']), tuple(jnp.asarray(x) for x in u),
      fanouts=fanouts, width=W, num_nodes=g['n'], num_edges=g['e'],
      table_slots=jpk.fused_table_slots(sample_budget(b, list(fanouts))),
      batch_size=b, replace=False, interpret=True)

  hops = K.sample_walk_dedup(
      torch.as_tensor(g['indptr_pad']), torch.as_tensor(g['indices']),
      torch.as_tensor(d['ids3']), torch.as_tensor(d['new_head3']),
      torch.as_tensor(stab_ids), torch.as_tensor(d['labels3']),
      torch.as_tensor(d['count2']),
      [torch.as_tensor(x[:s]) for x, (s, _) in
       zip(u, walk_geometry(b, fanouts))],
      fanouts=fanouts, table_slots=K.walk_table_slots(
          sample_budget(b, list(fanouts))))

  frontier, fmask = d['ids3'], d['new_head3']
  n_heads = 0
  for h, (jh, hop) in enumerate(zip(jhops, hops)):
    s, k = jh['s'], jh['k']
    mask = np.asarray(jax_hop_valid_mask(
        jnp.asarray(g['indptr']), jnp.asarray(frontier), k,
        jnp.asarray(fmask), False))
    np.testing.assert_array_equal(mask, hop['mask'].numpy(), err_msg=h)
    jp = np.asarray(picks[h])[:s]
    np.testing.assert_array_equal(jp[mask], hop['picks'].numpy()[mask],
                                  err_msg=h)
    jn = np.asarray(newh[h])[:s].reshape(-1) != 0
    np.testing.assert_array_equal(jn, hop['new_head'].numpy(), err_msg=h)
    assert int(hop['new_count']) == int(jn.sum()), h
    n_heads += int(jn.sum())
    frontier = np.where(jn, jp.reshape(-1), np.iinfo(np.int32).max)
    fmask = jn
  assert n_heads > 0
  assert K.sample_walk_dedup.launches == 0


@pytest.mark.parametrize('hops,with_slots', [
    (((256, 15), (3840, 10), (38400, 5)), True),
    (((7, 3), (21, 2)), False),
    (((1, 100),), True)])
def test_walk_layout_planes_are_the_views_the_kernel_writes(hops,
                                                            with_slots):
  # a walk's two allocations: the byte offsets handed to the kernel are
  # where the split views the wrapper returns begin, and no two planes of
  # one allocation overlap
  slots, words, blocks = 1 << 12, 77, 9
  lay = K._walk_layout(hops, slots, words, blocks, with_slots)
  buf = torch.empty(lay.size, dtype=torch.int32)
  base = buf.data_ptr()
  ints = buf.split_with_sizes(lay.int_sizes)
  flags = ints[-1].view(torch.bool).split_with_sizes(lay.flag_sizes)
  assert ints[0].numel() == len(hops)
  table = 4 * (3 * slots + 2 * words + blocks)
  out_spans, scratch_spans = [], [(0, table)]
  for h, (s, k) in enumerate(hops):
    m = s * k
    at = 1 + h * lay.per_hop
    picks, slots_off, mask, tslot, labels, new_head, new_count = \
        lay.hop_bytes[h]
    assert ints[at].data_ptr() - base == picks and ints[at].numel() == m
    assert ints[at + 1].data_ptr() - base == labels
    assert ints[0][h].data_ptr() - base == new_count
    if with_slots:
      assert ints[at + 2].data_ptr() - base == slots_off
      out_spans.append((slots_off, slots_off + 4 * m))
    else:
      assert slots_off == -1
    assert flags[2 * h].data_ptr() - base == mask
    assert flags[2 * h + 1].data_ptr() - base == new_head
    assert flags[2 * h].numel() == flags[2 * h + 1].numel() == m
    out_spans += [(picks, picks + 4 * m), (labels, labels + 4 * m),
                  (new_count, new_count + 4), (mask, mask + m),
                  (new_head, new_head + m)]
    scratch_spans.append((tslot, tslot + 4 * m))
  for spans, size in ((out_spans, lay.size), (scratch_spans, lay.scratch)):
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= 4 * size


def test_seed_dedup_matches_jax_with_seen_set():
  # the exact sorted dedup, seed hop (empty seen-set) and a hop against
  # a seen-set: same appearance-grouped order, labels and heads
  rng = np.random.default_rng(4)
  seeds = np.array([5, 0, 5, 17, 63, 2, 2, 9], np.int32)
  for nv in (8, 5, 0):
    want = _seed_hop_np(seeds, nv)
    got = sorted_hop_dedup(torch.zeros(0, dtype=torch.int32),
                           torch.zeros(0, dtype=torch.int32), 0,
                           torch.as_tensor(seeds),
                           torch.arange(8) < nv)
    for k in ('ids3', 'labels3', 'new_head3', 'pos3', 'u_ids2', 'u_labs2',
              'count2', 'new_count'):
      np.testing.assert_array_equal(want[k], np.asarray(got[k]),
                                    err_msg=f'{k} nv={nv}')
  ids = rng.integers(0, 20, 40).astype(np.int32)
  valid = rng.random(40) < 0.8
  u_ids = np.array([3, 7, 11, np.iinfo(np.int32).max], np.int32)
  u_labs = np.array([0, 1, 2, np.iinfo(np.int32).max], np.int32)
  want = jax_sorted_hop_dedup(jnp.asarray(u_ids), jnp.asarray(u_labs),
                              jnp.asarray(3, jnp.int32), jnp.asarray(ids),
                              jnp.asarray(valid))
  got = sorted_hop_dedup(torch.as_tensor(u_ids), torch.as_tensor(u_labs),
                         torch.tensor(3, dtype=torch.int32),
                         torch.as_tensor(ids), torch.as_tensor(valid))
  for k in ('ids3', 'labels3', 'new_head3', 'pos3', 'count2', 'new_count'):
    np.testing.assert_array_equal(np.asarray(want[k]), np.asarray(got[k]),
                                  err_msg=k)


def test_entry_points_need_a_card_or_an_explicit_device(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    resolve_device(None)
  assert resolve_device('cpu') == torch.device('cpu')
