"""On a card: each CUDA kernel of glt_tpu_torch against its plain PyTorch
version, exactly, and the serving path through the kernels.

Skips without a CUDA device (decided inside each test, never at import,
so every worker collects the same tests). Imports nothing of JAX, so on
the machine with the card it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import gc

import numpy as np
import pytest
import torch

from glt_tpu_torch.data import Dataset, Feature, Topology, gather_features
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.models import RGNN, GraphSAGE
from glt_tpu_torch.benchmarks import probe_compile
from glt_tpu_torch.ops import cuda_kernels as K
from glt_tpu_torch.ops import probe_kernels as P
from glt_tpu_torch.ops.pipeline import _fused_seed_hop, sample_budget
from glt_tpu_torch.ops.sample import (sample_full_neighbors,
                                      sample_neighbors_weighted,
                                      walk_hop_uniforms,
                                      weighted_hop_uniforms)
from glt_tpu_torch.parallel import SageTrainStep
from glt_tpu_torch.serving import InferenceEngine
from glt_tpu_torch.stream import (CompactionPolicy, SnapshotManager,
                                  StreamIngestor, StreamSampler)
from glt_tpu_torch.typing import reverse_edge_type
from glt_tpu_torch.utils import offload
from glt_tpu_torch.utils.offload import pin_host

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (runs on the card)')
  return torch.device('cuda')


def _graph(dev, n=5000, e=80_000, seed=3):
  g = torch.Generator(device=dev).manual_seed(seed)
  ei = torch.stack([torch.randint(0, n, (e,), generator=g, device=dev),
                    torch.randint(0, n, (e,), generator=g, device=dev)])
  topo = Topology(ei, num_nodes=n)
  indptr_pad = torch.cat([topo.indptr, torch.tensor([e], device=dev)])
  return indptr_pad.to(torch.int32), topo.indices


def _signed_or_bytes(shape, dtype, g, dev):
  """Signed normal values for floating tables (so a lost sign bit shows),
  every byte value for uint8 ones."""
  if dtype == torch.uint8:
    return torch.randint(0, 256, shape, generator=g, device=dev, dtype=dtype)
  return torch.randn(shape, generator=g, device=dev).to(dtype)


def test_gather_rows_matches_plain(dev):
  # every width and dtype: the copy mode (float32 width 100, bf16 64),
  # realigned rows of one pass (float32 37, bf16 38 and 101, and rows
  # under 16 bytes: fp16 3, uint8 7)
  g = torch.Generator(device=dev).manual_seed(0)
  for d, dtype in ((100, torch.float32), (37, torch.float32),
                   (64, torch.bfloat16), (38, torch.bfloat16),
                   (101, torch.bfloat16), (3, torch.float16),
                   (7, torch.uint8)):
    table = _signed_or_bytes((1000, d), dtype, g, dev)
    rows = torch.randint(-5, 1010, (4097,), generator=g, device=dev)
    before = K.gather_rows.launches
    got = K.gather_rows(table, rows)
    assert K.gather_rows.launches == before + 1
    assert torch.equal(got, K.gather_rows_plain(table, rows))


@pytest.mark.parametrize('dtype,width', [(torch.bfloat16, 101),
                                         (torch.float16, 3),
                                         (torch.uint8, 7)])
def test_gather_rows_reads_narrow_rows_at_an_offset_base(dev, dtype, width):
  # a table one element into its allocation: the layout is chosen by the
  # table's address too, so its first row takes the byte path; equal to
  # index_select over the clipped rows
  g = torch.Generator(device=dev).manual_seed(width)
  n = 5000
  flat = _signed_or_bytes((n * width + 1,), dtype, g, dev)
  table = flat[1:].view(n, width)
  assert table.data_ptr() % 4
  rows = torch.randint(-3, n + 3, (20_000,), generator=g, device=dev)
  got = K.gather_rows(table, rows)
  assert torch.equal(got, torch.index_select(table, 0,
                                             rows.clamp(0, n - 1)))


@pytest.mark.parametrize('dtype,offset', [
    (torch.uint8, 0), (torch.uint8, 1), (torch.uint8, 3),
    (torch.bfloat16, 0), (torch.bfloat16, 1), (torch.float32, 0),
    (torch.float32, 1), (torch.float64, 0), (torch.float64, 1)])
def test_gather_rows_sweep_matches_plain_and_index_select(dev, dtype, offset):
  # every layout of K3 (gather_rows_layout: copy or realigned, one pass
  # or several) over element sizes 1, 2, 4 and 8, widths 1-33, 100, 101 and
  # 1024, the table `offset` elements into its allocation; rows clip at
  # both ends, so the table's edge rows take the byte path
  g = torch.Generator(device=dev).manual_seed(17 + offset)
  n = 3000
  for width in [*range(1, 34), 100, 101, 1024]:
    flat = _signed_or_bytes((n * width + offset,), dtype, g, dev)
    table = flat[offset:].view(n, width)
    rows = torch.randint(-3, n + 3, (5000,), generator=g, device=dev)
    before = K.gather_rows.launches
    got = K.gather_rows(table, rows)
    assert K.gather_rows.launches == before + 1
    lay = K.gather_rows_layout(width * table.element_size(),
                               table.data_ptr())
    assert torch.equal(got, K.gather_rows_plain(table, rows)), (width, lay)
    assert torch.equal(got, torch.index_select(
        table, 0, rows.clamp(0, n - 1))), (width, lay)


@pytest.mark.parametrize('split', [0.0, 0.2, 1.0])
@pytest.mark.parametrize('dtype,width', [(torch.float32, 100),
                                         (torch.bfloat16, 101),
                                         (torch.uint8, 7),
                                         (torch.float32, 1024)])
@pytest.mark.parametrize('hot_offset,cold_offset', [(0, 0), (1, 0), (0, 1)])
def test_gather_rows_mixed_matches_plain(dev, split, dtype, width,
                                         hot_offset, cold_offset):
  # K3 over a split store: hot rows from the card, cold rows from pinned
  # host memory, in one launch; the hot block, or the cold block, an
  # element into its allocation; rows clamped at both ends, -1 lanes read
  # row 0; equal to the plain twin and to the table's own K3 gather
  g = torch.Generator(device=dev).manual_seed(width + hot_offset)
  n = 3000
  h = round(n * split)
  table = _signed_or_bytes((n, width), dtype, g, dev)
  hot_buf = _signed_or_bytes((h * width + hot_offset,), dtype, g, dev)
  hot = hot_buf[hot_offset:].view(h, width)
  hot.copy_(table[:h])
  flat = table[h:].reshape(-1).cpu()
  cold = pin_host(torch.cat([flat[:cold_offset], flat])[cold_offset:].view(
      n - h, width), dev)
  rows = torch.cat([torch.randint(-3, n + 3, (6000,), generator=g,
                                  device=dev),
                    torch.tensor([-1, 0, h - 1, h, n - 1, n], device=dev)])
  before = K.gather_rows_mixed.launches
  got = K.gather_rows_mixed(hot, cold, rows)
  torch.cuda.synchronize()
  assert K.gather_rows_mixed.launches == before + 1
  assert got.device == hot.device
  assert torch.equal(got, K.gather_rows_mixed_plain(hot, cold, rows))
  assert torch.equal(got, K.gather_rows_plain(table, rows))


def test_split_store_dropped_after_a_mixed_launch(dev):
  # the store, and with it the pinned block's owner, goes straight after
  # the launch: the card finishes reading the block before it is unmapped
  g = torch.Generator(device=dev).manual_seed(23)
  n = 400_000
  x = torch.randn((n, 100), generator=g, device=dev)
  rows = torch.randint(0, n, (2_000_000,), generator=g, device=dev)
  want = K.gather_rows_plain(x, rows)
  for _ in range(3):
    store = Feature(x, split_ratio=0.2, device=dev)
    got = gather_features(store, rows)
    del store
    gc.collect()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_split_feature_reads_both_blocks_in_one_launch(dev):
  # a degree-sorted split store's gather: one mixed K3 launch, no copy of
  # the cold block to the card, equal to the resident store and to the
  # host phase
  g = torch.Generator(device=dev).manual_seed(5)
  n = 20_000
  x = torch.randn((n, 100), generator=g, device=dev)
  perm = torch.randperm(n, generator=g, device=dev).cpu().numpy()
  split = Feature(x, split_ratio=0.2, id2index=perm, device=dev)
  assert split.cold_array.device.type == 'cpu'
  assert split.cold_pinned.tensor is split.cold_array
  assert split.device_part.shape == (4000, 100)
  node = torch.cat([torch.randint(0, n, (50_000,), generator=g, device=dev),
                    torch.full((100,), -1, device=dev)])
  K.reset_launch_counts()
  got = gather_features(split, node)
  assert (K.gather_rows_mixed.launches, K.gather_rows.launches) == (1, 0)
  for other in (Feature(x, id2index=perm, device=dev),
                Feature(x, split_ratio=0.2, id2index=perm, device=dev,
                        host_offload=False)):
    assert torch.equal(got, gather_features(other, node))
  np.testing.assert_array_equal(split[np.arange(10)],
                                x[torch.as_tensor(perm[:10])].cpu().numpy())


def test_split_feature_raises_when_pinning_is_refused(dev, monkeypatch):
  # no fallback: a refused pin or map raises, and an unmapped CPU block
  # is never read (or copied to the card) by the kernel
  x = np.ones((100, 8), np.float32)
  monkeypatch.setattr(offload, 'glt_host_register', lambda *a: 1)
  with pytest.raises(RuntimeError, match='pinning and mapping'):
    Feature(x, split_ratio=0.2, device=dev)
  Feature(x, split_ratio=1.0, device=dev)    # nothing spilled: no pin
  Feature(x, split_ratio=0.2, device=dev, host_offload=False)
  hot = torch.ones((20, 8), device=dev)
  with pytest.raises(TypeError, match='pinned and mapped'):
    K.gather_rows_mixed(hot, torch.ones((80, 8)), torch.arange(30,
                                                               device=dev))


def test_dedup_table_insert_matches_plain(dev):
  g = torch.Generator(device=dev).manual_seed(1)
  ids = torch.randperm(100_000, generator=g, device=dev)[:5000]
  ids[::13] = -1
  labs = torch.arange(5000, device=dev, dtype=torch.int32)
  valid = torch.rand(5000, generator=g, device=dev) < 0.9
  a = K.make_dedup_table(16384, dev)
  b = K.make_dedup_table(16384, dev)
  K.dedup_table_insert(a[0], a[1], ids, labs, valid)
  K.dedup_table_insert_plain(b[0], b[1], ids, labs, valid)
  probe = torch.cat([ids, torch.arange(100_000, 100_100, device=dev)])
  assert torch.equal(K.dedup_table_lookup(a[0], a[1], probe),
                     K.dedup_table_lookup(b[0], b[1], probe))


@pytest.mark.parametrize('slots', [1 << 14, 1 << 21])
def test_dedup_table_init_matches_plain(dev, slots):
  # the hetero walk's seed phase in one launch: a fresh table (a 2^21-slot
  # one takes several grid-stride rounds of the fill) with the seed
  # uniques inserted at a type base, equal to the plain twin by lookups
  g = torch.Generator(device=dev).manual_seed(5)
  seeds = torch.randint(0, 50_000, (1024,), generator=g, device=dev,
                        dtype=torch.int32)
  d, _ = _fused_seed_hop(seeds, 1000)
  base = 70_000
  args = (slots, d['ids3'], d['labels3'], d['new_head3'], base, dev)
  before = K.dedup_table_insert.launches
  got = K.dedup_table_init(*args)
  assert K.dedup_table_insert.launches == before + 1
  want = K.dedup_table_init_plain(*args)
  for a, b in zip(got, want):
    assert a.dtype == b.dtype and a.shape == b.shape
  assert torch.equal(got[2], want[2])          # first: untouched
  assert got[1].data_ptr() == got[0].data_ptr() + 4 * slots   # one buffer
  probe = torch.cat([seeds + base, torch.arange(
      200_000, 200_064, device=dev, dtype=torch.int32)])
  lab = K.dedup_table_lookup(*got[:2], probe)
  assert torch.equal(lab, K.dedup_table_lookup(*want[:2], probe))
  assert int((lab[:1000] >= 0).sum()) == 1000 and bool((lab[1024:] < 0).all())


def test_dedup_table_init_replays_in_a_cuda_graph(dev):
  # the init captured once and replayed on other seeds: each replay is a
  # fresh table, with nothing left from the last one
  g = torch.Generator(device=dev).manual_seed(6)
  slots, base = 1 << 12, 3
  cases = [_fused_seed_hop(torch.randint(0, 900, (256,), generator=g,
                                         device=dev, dtype=torch.int32),
                           nv)[0] for nv in (256, 100)]
  keys = ('ids3', 'labels3', 'new_head3')
  ids, labs, heads = (cases[0][k].clone() for k in keys)
  run = lambda: K.dedup_table_init(slots, ids, labs, heads, base, dev)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    run()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = run()
  probe = torch.arange(base + 900 + 64, device=dev)
  for which in (1, 0, 1):
    for dst, k in zip((ids, labs, heads), keys):
      dst.copy_(cases[which][k])
    graph.replay()
    torch.cuda.synchronize()
    want = K.dedup_table_init_plain(slots, *(cases[which][k] for k in keys),
                                    base, dev)
    assert torch.equal(K.dedup_table_lookup(*out[:2], probe),
                       K.dedup_table_lookup(*want[:2], probe)), which
    assert torch.equal(out[2], want[2]), which


def _two_type_seeds(dev, seed, n=(1024, 1536), nv=(1000, 1536)):
  """Two seed types' uniques as the seed hop leaves them, at tag bases 0
  and 70,000: ``[(ids, labels, heads, base)]``."""
  g = torch.Generator(device=dev).manual_seed(seed)
  segs = []
  for m, v, base in zip(n, nv, (0, 70_000)):
    d, _ = _fused_seed_hop(torch.randint(0, 60_000, (m,), generator=g,
                                         device=dev, dtype=torch.int32), v)
    segs.append((d['ids3'], d['labels3'], d['new_head3'], base))
  return segs


@pytest.mark.parametrize('slots', [1 << 14, 1 << 21])
def test_dedup_table_init_types_matches_plain(dev, slots):
  # a two-type link batch's seed phase in one launch: the fill and both
  # types' inserts, equal to the plain twin and to the chain it replaces
  # (the one-type init, then an in-place insert of the second type)
  segs = _two_type_seeds(dev, 7)
  before = K.dedup_table_insert.launches
  got = K.dedup_table_init_types(slots, segs, dev)
  assert K.dedup_table_insert.launches == before + 1
  want = K.dedup_table_init_types_plain(slots, segs, dev)
  keys, vals, first = K.dedup_table_init(slots, *segs[0], dev)
  ids, labs, heads, base = segs[1]
  x = torch.where(heads, ids + base, torch.full_like(ids, -1))
  K.dedup_table_insert(keys, vals, x, labs, x >= 0)
  assert torch.equal(got[2], want[2]) and torch.equal(got[2], first)
  assert got[1].data_ptr() == got[0].data_ptr() + 4 * slots   # one buffer
  probe = torch.cat([torch.where(h, i + b, -1) for i, _, h, b in segs]
                    + [torch.arange(300_000, 300_064, device=dev,
                                    dtype=torch.int32)])
  lab = K.dedup_table_lookup(*got[:2], probe)
  assert torch.equal(lab, K.dedup_table_lookup(*want[:2], probe))
  assert torch.equal(lab, K.dedup_table_lookup(keys, vals, probe))
  live = torch.cat([h for _, _, h, _ in segs])
  seen = torch.cat([torch.where(h, l, -1) for _, l, h, _ in segs]).long()
  assert torch.equal(lab[:live.numel()], seen) and int(live.sum()) > 0
  assert bool((lab[live.numel():] < 0).all())


def test_dedup_table_init_types_replays_in_a_cuda_graph(dev):
  # captured once, replayed on other seeds of both types: each replay a
  # fresh table
  slots = 1 << 14
  cases = [_two_type_seeds(dev, s, nv=nv)
           for s, nv in ((8, (1024, 1536)), (9, (100, 7)))]
  live = [[t.clone() for t in seg[:3]] + [seg[3]] for seg in cases[0]]
  run = lambda: K.dedup_table_init_types(slots, live, dev)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    run()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = run()
  probe = torch.arange(140_000, device=dev, dtype=torch.int32)
  for which in (1, 0, 1):
    for dst, src in zip(live, cases[which]):
      for a, b in zip(dst[:3], src[:3]):
        a.copy_(b)
    graph.replay()
    torch.cuda.synchronize()
    want = K.dedup_table_init_types_plain(slots, cases[which], dev)
    assert torch.equal(K.dedup_table_lookup(*out[:2], probe),
                       K.dedup_table_lookup(*want[:2], probe)), which


def test_hetero_link_batch_matches_plain(dev, monkeypatch):
  # a two-type link batch (users and items seeded in one walk) and a
  # same-type one: one K2 launch and one B1 launch a hop, every field and
  # label equal to the plain twins' on the same draws
  from glt_tpu_torch.loader import LinkNeighborLoader
  from glt_tpu_torch.ops.negative import negative_proposals
  g = torch.Generator(device=dev).manual_seed(23)
  nu, ni = 3000, 5000
  u2i = ('user', 'to', 'item')
  i2u, i2i = ('item', 'rev_to', 'user'), ('item', 'sim', 'item')
  ui = torch.stack([torch.randint(0, nu, (40_000,), generator=g, device=dev),
                    torch.randint(0, ni, (40_000,), generator=g, device=dev)])
  ii = torch.randint(0, ni, (2, 20_000), generator=g, device=dev)
  ds = Dataset().init_graph({u2i: ui, i2u: ui.flip(0), i2i: ii},
                            num_nodes={'user': nu, 'item': ni})
  ds.init_node_features({'user': torch.randn((nu, 32), generator=g,
                                             device=dev),
                         'item': torch.randn((ni, 32), generator=g,
                                             device=dev)})
  for etype, sizes in ((u2i, {'user': 256, 'item': 256}),
                       (i2i, {'item': 512})):
    loader = LinkNeighborLoader(ds, [8, 4], edge_label_index=(etype, None),
                                batch_size=128, neg_sampling=('binary', 1),
                                device=dev, seed=0)
    gn = ds.get_graph(etype).topo
    props = negative_proposals(g, 128, 5, gn.num_rows, gn.num_cols, dev)
    u = loader.sampler.hop_uniforms(sizes)
    real = loader.sampler.sample_from_edges
    monkeypatch.setattr(loader.sampler, 'sample_from_edges',
                        lambda inputs: real(inputs, proposals=props,
                                            uniforms=u))
    seeds = np.arange(128) * 3
    K.reset_launch_counts()
    got = loader._make_batch(seeds, 128)
    counted = (K.dedup_table_insert, K.sample_hop_dedup)
    assert tuple(fn.launches for fn in counted) == (1, 2)
    with monkeypatch.context() as m:
      for name in ('dedup_table_init', 'dedup_table_init_types',
                   'sample_hop_dedup', 'gather_rows'):
        m.setattr(K, name, getattr(K, name + '_plain'))
      want = loader._make_batch(seeds, 128)
    assert tuple(fn.launches for fn in counted) == (1, 2)   # none plain
    for f in ('node_dict', 'node_count_dict', 'row_dict', 'col_dict',
              'edge_mask_dict', 'x_dict'):
      a, b = getattr(got, f), getattr(want, f)
      assert set(a) == set(b) and all(torch.equal(a[t], b[t]) for t in a), f
    for key in ('edge_label_index', 'edge_label'):
      assert torch.equal(got.metadata[key], want.metadata[key]), key


@pytest.mark.parametrize('replace', [False, True])
def test_walk_matches_plain(dev, replace):
  indptr_pad, indices = _graph(dev)
  seeds = torch.randint(0, 5000, (64,), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
  seeds[:4] = seeds[4]  # duplicate seeds
  fanouts = (15, 10, 5)
  d, _ = _fused_seed_hop(seeds.to(torch.int32), 60)
  u = walk_hop_uniforms(torch.Generator(device=dev).manual_seed(7), 64,
                        fanouts, replace, dev)
  args = (indptr_pad, indices, d['ids3'], d['new_head3'],
          torch.where(d['new_head3'], d['ids3'],
                      torch.full_like(d['ids3'], -1)),
          d['labels3'], d['count2'], u)
  kw = dict(fanouts=fanouts, replace=replace, with_slots=True,
            table_slots=K.walk_table_slots(sample_budget(64, fanouts)))
  got = K.sample_walk_dedup(*args, **kw)
  want = K.sample_walk_dedup_plain(*args, **kw)
  for h, (a, b) in enumerate(zip(got, want)):
    for k in ('picks', 'mask', 'labels', 'new_head', 'slots'):
      assert torch.equal(a[k], b[k]), f'hop {h} {k}'


def _hub_graph(dev, n=20_000, seed=11):
  """Rows of degree 0-40, and 200 hubs of degree 200-2000 that receive
  half of all edges, so that every hop meets rows above the fanout."""
  g = torch.Generator(device=dev).manual_seed(seed)
  deg = torch.randint(0, 41, (n,), generator=g, device=dev)
  hubs = torch.randperm(n, generator=g, device=dev)[:200]
  deg[hubs] = torch.randint(200, 2001, (200,), generator=g, device=dev)
  src = torch.repeat_interleave(torch.arange(n, device=dev), deg)
  e = src.numel()
  dst = torch.where(torch.rand(e, generator=g, device=dev) < 0.5,
                    hubs[torch.randint(0, 200, (e,), generator=g,
                                       device=dev)],
                    torch.randint(0, n, (e,), generator=g, device=dev))
  topo = Topology(torch.stack([src, dst]), num_nodes=n)
  indptr_pad = torch.cat([topo.indptr, torch.tensor([e], device=dev)])
  return indptr_pad.to(torch.int32), topo.indices, hubs


@pytest.mark.parametrize('fanouts', [(100,), (3, 80)])
def test_walk_matches_plain_at_fanouts_above_64(dev, fanouts):
  # fanouts past the walk's 64-entry local offsets: the wide instantiation
  # keeps a row's offsets in its tslot span; half the seeds are hubs, so
  # Floyd draws (deg > k) on every hop
  indptr_pad, indices, hubs = _hub_graph(dev)
  b = 256
  seeds = torch.cat([hubs[:b // 2], torch.randint(
      0, 20_000, (b // 2,), device=dev,
      generator=torch.Generator(device=dev).manual_seed(3))])
  d, _ = _fused_seed_hop(seeds.to(torch.int32), b)
  u = walk_hop_uniforms(torch.Generator(device=dev).manual_seed(9), b,
                        fanouts, False, dev)
  args = (indptr_pad, indices, d['ids3'], d['new_head3'],
          torch.where(d['new_head3'], d['ids3'],
                      torch.full_like(d['ids3'], -1)),
          d['labels3'], d['count2'], u)
  kw = dict(fanouts=fanouts, with_slots=True,
            table_slots=K.walk_table_slots(sample_budget(b, fanouts)))
  got = K.sample_walk_dedup(*args, **kw)
  want = K.sample_walk_dedup_plain(*args, **kw)
  for h, (a, b_) in enumerate(zip(got, want)):
    for k in ('picks', 'mask', 'labels', 'new_head', 'slots'):
      assert torch.equal(a[k], b_[k]), f'hop {h} {k}'
  deg = (indptr_pad[1:-1] - indptr_pad[:-2])[seeds.long()]
  assert int((deg > fanouts[0]).sum()) >= b // 2


def _ragged_graph(dev, n=20_003, seed=13):
  """:func:`_hub_graph`'s shape over N = 20,003 nodes (not a multiple of
  32), with one edge in 50 pointing at the last node, so that the walk
  picks it and ranks ids in the bitmap's last, partial word."""
  g = torch.Generator(device=dev).manual_seed(seed)
  deg = torch.randint(0, 41, (n,), generator=g, device=dev)
  hubs = torch.randperm(n, generator=g, device=dev)[:200]
  deg[hubs] = torch.randint(200, 2001, (200,), generator=g, device=dev)
  src = torch.repeat_interleave(torch.arange(n, device=dev), deg)
  e = src.numel()
  dst = torch.where(torch.rand(e, generator=g, device=dev) < 0.5,
                    hubs[torch.randint(0, 200, (e,), generator=g,
                                       device=dev)],
                    torch.randint(0, n, (e,), generator=g, device=dev))
  dst[::50] = n - 1
  topo = Topology(torch.stack([src, dst]), num_nodes=n)
  indptr_pad = torch.cat([topo.indptr, torch.tensor([e], device=dev)])
  return indptr_pad.to(torch.int32), topo.indices, hubs


def _walk_args(dev, hubs, n, b, fanouts, replace, seed, valid=True):
  """One walk's inputs from ``b`` seeds (up to half of them hubs, four
  duplicates), as the sampler hands them over."""
  g = torch.Generator(device=dev).manual_seed(seed)
  seeds = torch.randint(0, n, (b,), generator=g, device=dev)
  n_hubs = min(b // 2, hubs.numel())
  seeds[:n_hubs] = hubs[:n_hubs]
  seeds[1:5] = seeds[0]
  d, _ = _fused_seed_hop(seeds.to(torch.int32), b)
  ok = d['new_head3'] if valid else torch.zeros_like(d['new_head3'])
  u = walk_hop_uniforms(g, b, fanouts, replace, dev)
  return (d['ids3'], ok, torch.where(ok, d['ids3'],
                                     torch.full_like(d['ids3'], -1)),
          d['labels3'], d['count2'], u)


_WALK_KEYS = ('picks', 'mask', 'labels', 'new_head', 'new_count')


@pytest.mark.parametrize('b', [1, 7, 256, 1024])
@pytest.mark.parametrize('fanouts', [(15, 10, 5), (100,), (3, 80)])
@pytest.mark.parametrize('replace,with_slots', [(False, True),
                                                (True, False)])
def test_walk_is_one_launch_equal_to_plain(dev, b, fanouts, replace,
                                           with_slots):
  # one cooperative launch a walk, every surface bit-equal to the plain
  # walk, over a graph of N % 32 != 0 whose last node is picked (a new
  # id in the bitmap's last, partial word)
  indptr_pad, indices, hubs = _ragged_graph(dev)
  n = indptr_pad.numel() - 2
  args = (indptr_pad, indices) + _walk_args(dev, hubs, n, b, fanouts,
                                            replace, seed=b)
  kw = dict(fanouts=fanouts, replace=replace, with_slots=with_slots,
            table_slots=K.walk_table_slots(sample_budget(b, fanouts)))
  before = K.sample_walk_dedup.launches, K.dedup_table_insert.launches
  got = K.sample_walk_dedup(*args, **kw)
  assert (K.sample_walk_dedup.launches,
          K.dedup_table_insert.launches) == (before[0] + 1, before[1])
  want = K.sample_walk_dedup_plain(*args, **kw)
  keys = _WALK_KEYS + (('slots',) if with_slots else ())
  for h, (a, c) in enumerate(zip(got, want)):
    assert set(a) == set(keys)
    for k in keys:
      assert a[k].dtype == c[k].dtype and torch.equal(a[k], c[k]), \
          f'hop {h} {k}'
  if b >= 256:
    assert any(bool((hop['picks'].reshape(-1)[hop['new_head']]
                     == n - 1).any()) for hop in got)


def test_walk_with_no_valid_seed_is_equal_to_plain(dev):
  # every frontier row invalid: no pick, no new id, new_count 0 a hop
  indptr_pad, indices, hubs = _ragged_graph(dev)
  n = indptr_pad.numel() - 2
  fanouts = (15, 10, 5)
  args = (indptr_pad, indices) + _walk_args(dev, hubs, n, 64, fanouts,
                                            False, seed=3, valid=False)
  kw = dict(fanouts=fanouts, with_slots=True,
            table_slots=K.walk_table_slots(sample_budget(64, fanouts)))
  got = K.sample_walk_dedup(*args, **kw)
  want = K.sample_walk_dedup_plain(*args, **kw)
  for a, c in zip(got, want):
    for k in _WALK_KEYS + ('slots',):
      assert torch.equal(a[k], c[k]), k
    assert int(a['new_count']) == 0 and not bool(a['mask'].any())


def test_walk_replays_in_a_cuda_graph(dev):
  # one walk captured, then replayed on other seeds and uniforms copied
  # into its inputs: no table, bitmap or count leaks from one call into
  # the next, and the replay equals the plain walk on each input
  indptr_pad, indices, hubs = _ragged_graph(dev)
  n = indptr_pad.numel() - 2
  b, fanouts = 256, (15, 10, 5)
  kw = dict(fanouts=fanouts, with_slots=True,
            table_slots=K.walk_table_slots(sample_budget(b, fanouts)))
  inputs = [_walk_args(dev, hubs, n, b, fanouts, False, seed=s)
            for s in (21, 22)]
  static = [t.clone() for t in inputs[0][:5]] + [
      [u.clone() for u in inputs[0][5]]]
  args = lambda: (indptr_pad, indices, *static)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    K.sample_walk_dedup(*args(), **kw)      # builds and warms up
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = K.sample_walk_dedup(*args(), **kw)
  for which in (1, 0, 1):
    src = inputs[which]
    for dst, t in zip(static[:5], src[:5]):
      dst.copy_(t)
    for dst, t in zip(static[5], src[5]):
      dst.copy_(t)
    graph.replay()
    torch.cuda.synchronize()
    want = K.sample_walk_dedup_plain(indptr_pad, indices, *src, **kw)
    for h, (a, c) in enumerate(zip(out, want)):
      for k in _WALK_KEYS + ('slots',):
        assert torch.equal(a[k], c[k]), f'input {which} hop {h} {k}'


def _tagged_hop(dev, bounds, seed, s=4096, k=5, n_flat=60_000):
  """One hop's inputs over tagged ids in ``[0, bounds[-1])``, a fifth of
  them at or next to a type bound, shorter segments behind invalid
  lanes."""
  g = torch.Generator(device=dev).manual_seed(seed)
  tb = torch.tensor(bounds, dtype=torch.int32, device=dev)
  indices = torch.randint(0, bounds[-1], (n_flat,), generator=g, device=dev,
                          dtype=torch.int32)
  near = tb[torch.randint(1, len(bounds), (n_flat // 5,), generator=g,
                          device=dev)] + torch.randint(
      -2, 2, (n_flat // 5,), generator=g, device=dev, dtype=torch.int32)
  indices[::5] = near.clamp(0, bounds[-1] - 1)
  eids = torch.randperm(n_flat, generator=g, device=dev).to(torch.int32)
  starts = torch.randint(0, n_flat - 64, (s,), generator=g, device=dev,
                         dtype=torch.int32)
  deg = torch.randint(0, 64, (s,), generator=g, device=dev)
  offsets = (torch.rand((s, k), generator=g, device=dev)
             * deg[:, None]).to(torch.int32)
  valid = (torch.arange(k, device=dev)[None, :] < deg.clamp(max=k)[:, None])
  valid[s // 2:, 3:] = False
  return indices, eids, starts, offsets, valid, tb


_HOP_KEYS = ('picks', 'eid_picks', 'labels', 'new_head', 'counts')


def test_hop_chain_is_one_launch_a_hop_equal_to_plain(dev):
  # three hops against one table, tag bounds inside bitmap words (3001,
  # 7013) and an empty type: each hop one launch, its outputs and the
  # table after it equal to the plain hop's
  bounds = [0, 3001, 7013, 7013, 7500]
  nid = bounds[-1]
  pre = torch.arange(0, nid, 11, device=dev, dtype=torch.int32)
  slots = K.walk_table_slots(3 * 4096 * 5 + pre.numel())
  tables = [K.make_dedup_table(slots, dev) for _ in range(2)]
  for keys, vals, _ in tables:
    K.dedup_table_insert(keys, vals, pre, torch.arange(pre.numel(),
                                                       device=dev),
                         torch.ones_like(pre, dtype=torch.bool))
  counts = [torch.tensor([5, 9, 0, 2], dtype=torch.int32, device=dev)] * 2
  for h in range(3):
    indices, eids, starts, offsets, valid, tb = _tagged_hop(dev, bounds, h)
    before = K.sample_hop_dedup.launches
    got = K.sample_hop_dedup(indices, eids, starts, offsets, valid,
                             *tables[0], tb, counts[0], num_ids=nid)
    assert K.sample_hop_dedup.launches == before + 1
    want = K.sample_hop_dedup_plain(indices, eids, starts, offsets, valid,
                                    *tables[1], tb, counts[1])
    for key in _HOP_KEYS:
      assert got[key].dtype == want[key].dtype
      assert torch.equal(got[key], want[key]), f'hop {h} {key}'
    assert int(got['new_head'].sum()) > 0
    probe = torch.arange(nid, device=dev)
    assert torch.equal(K.dedup_table_lookup(*tables[0][:2], probe),
                       K.dedup_table_lookup(*tables[1][:2], probe)), h
    counts = [got['counts'], want['counts']]
  # without num_ids the wrapper reads the range from type_bounds
  indices, eids, starts, offsets, valid, tb = _tagged_hop(dev, bounds, 7)
  fresh = [K.make_dedup_table(slots, dev) for _ in range(2)]
  got = K.sample_hop_dedup(indices, None, starts, offsets, valid,
                           *fresh[0], tb, counts[0])
  want = K.sample_hop_dedup_plain(indices, None, starts, offsets, valid,
                                  *fresh[1], tb, counts[1])
  assert got['eid_picks'] is None
  for key in ('picks', 'labels', 'new_head', 'counts'):
    assert torch.equal(got[key], want[key]), key


def test_hop_replays_in_a_cuda_graph(dev):
  # one hop captured, replayed on other offsets and a fresh copy of the
  # table each time: no bitmap or count leaks from one call into the next
  bounds = [0, 3001, 7013, 7500]
  nid = bounds[-1]
  pre = torch.arange(0, nid, 13, device=dev, dtype=torch.int32)
  slots = K.walk_table_slots(4096 * 5 + pre.numel())
  table0 = K.make_dedup_table(slots, dev)
  K.dedup_table_insert(table0[0], table0[1], pre,
                       torch.arange(pre.numel(), device=dev),
                       torch.ones_like(pre, dtype=torch.bool))
  counts = torch.tensor([3, 1, 4], dtype=torch.int32, device=dev)
  cases = [_tagged_hop(dev, bounds, s) for s in (31, 32)]
  indices, eids, _, _, _, tb = cases[0]
  starts, offsets, valid = (t.clone() for t in cases[0][2:5])
  table = [t.clone() for t in table0]
  run = lambda: K.sample_hop_dedup(indices, eids, starts, offsets, valid,
                                   *table, tb, counts, num_ids=nid)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    run()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = run()
  for which in (1, 0, 1):
    case = cases[which]
    for dst, t in zip((starts, offsets, valid), case[2:5]):
      dst.copy_(t)
    for dst, t in zip(table, table0):
      dst.copy_(t)
    graph.replay()
    torch.cuda.synchronize()
    ptab = [t.clone() for t in table0]
    want = K.sample_hop_dedup_plain(indices, eids, *case[2:5], *ptab, tb,
                                    counts)
    for key in _HOP_KEYS:
      assert torch.equal(out[key], want[key]), f'case {which} {key}'
    probe = torch.arange(nid, device=dev)
    assert torch.equal(K.dedup_table_lookup(*table[:2], probe),
                       K.dedup_table_lookup(*ptab[:2], probe)), which


def test_engine_serves_through_the_kernels(dev):
  rng = np.random.default_rng(0)
  ei = np.stack([rng.integers(0, 3000, 40_000), rng.integers(0, 3000, 40_000)])
  ds = Dataset().init_graph(ei, num_nodes=3000)
  ds.init_node_features(rng.standard_normal((3000, 100)).astype(np.float32))
  eng = InferenceEngine(ds, GraphSAGE(100, 64, 7), None, [5, 3],
                        buckets=(16,))
  eng.init_params(0)
  K.reset_launch_counts()
  out = eng.infer(np.arange(20))
  assert out.shape == (20, 7) and np.isfinite(out).all()
  assert all(fn.launches > 0 for fn in (K.sample_walk_dedup,
                                        K.gather_rows))
  # the walk inserts its seeds itself; K2 and B1 are the hetero path's
  assert K.dedup_table_insert.launches == 0
  assert K.sample_hop_dedup.launches == 0


def test_serving_server_runs_each_bucket_through_the_kernels(dev):
  """The rpc front end on the card: concurrent clients' requests merge in
  the MicroBatcher, and each bucket run of the engine launches the walk
  (K1) and the feature gather (K3) once; the rows are the engine's own
  (a repeat is a cache hit, equal to what was served)."""
  import threading
  from glt_tpu_torch.serving import ServingClient, ServingServer
  rng = np.random.default_rng(1)
  ei = np.stack([rng.integers(0, 3000, 40_000), rng.integers(0, 3000, 40_000)])
  ds = Dataset().init_graph(ei, num_nodes=3000)
  ds.init_node_features(rng.standard_normal((3000, 100)).astype(np.float32))
  eng = InferenceEngine(ds, GraphSAGE(100, 64, 7), None, [5, 3],
                        buckets=(8, 64))
  eng.init_params(0)
  with ServingServer(eng, max_wait_ms=2.0) as srv:
    K.reset_launch_counts()
    answers = {}

    def client(c):
      cli = ServingClient(*srv.address)
      r = np.random.default_rng(c)
      answers[c] = [(ids, cli.infer(ids)) for ids in
                    (r.integers(0, 3000, int(n)) for n in (1, 7, 30, 64))]
      cli.close()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=120)
    runs = sum(eng.run_stats()['bucket_runs'].values())
    assert runs > 0
    assert K.sample_walk_dedup.launches == runs
    assert K.gather_rows.launches == runs
    for c, got in answers.items():
      for ids, rows in got:
        assert rows.shape == (ids.size, 7) and np.isfinite(rows).all()
        np.testing.assert_array_equal(rows, eng.infer(ids))
    assert srv.metrics.batches <= 16


def test_serve_example_runs_on_the_card(dev):
  from glt_tpu_torch.examples import serve_sage_products
  out = serve_sage_products.main(['--nodes', '3000', '--max-steps', '3',
                                  '--batch-size', '128', '--queries', '16'])
  assert out['step'] == 0 and out['requests'] == 17
  assert sum(out['bucket_runs'].values()) >= 1


def test_sample_hop_dedup_matches_plain(dev):
  # one hop over a flat plane of three types' tagged ids, K_max = 5 with
  # shorter segments padded behind invalid lanes, against a seeded table
  g = torch.Generator(device=dev).manual_seed(11)
  bounds = torch.tensor([0, 3000, 7000, 7500], dtype=torch.int32, device=dev)
  indices = torch.randint(0, 7500, (60_000,), generator=g, device=dev,
                          dtype=torch.int32)
  eids = torch.randperm(60_000, generator=g, device=dev).to(torch.int32)
  s, k = 4096, 5
  starts = torch.randint(0, 60_000 - 64, (s,), generator=g, device=dev,
                         dtype=torch.int32)
  deg = torch.randint(0, 64, (s,), generator=g, device=dev)
  offsets = (torch.rand((s, k), generator=g, device=dev)
             * deg[:, None]).to(torch.int32)
  valid = (torch.arange(k, device=dev)[None, :] < deg.clamp(max=k)[:, None])
  valid[s // 2:, 3:] = False            # a segment of fanout 3
  pre = torch.unique(indices[::7])
  slots = K.walk_table_slots(s * k + pre.numel())
  tables = [K.make_dedup_table(slots, dev) for _ in range(2)]
  for keys, vals, _ in tables:
    K.dedup_table_insert(keys, vals, pre, torch.arange(pre.numel(),
                                                       device=dev),
                         torch.ones_like(pre, dtype=torch.bool))
  counts = torch.tensor([0, pre.numel(), 0], dtype=torch.int32, device=dev)
  before = K.sample_hop_dedup.launches
  got = K.sample_hop_dedup(indices, eids, starts, offsets, valid,
                           *tables[0], bounds, counts)
  assert K.sample_hop_dedup.launches > before
  want = K.sample_hop_dedup_plain(indices, eids, starts, offsets, valid,
                                  *tables[1], bounds, counts)
  for key in ('picks', 'eid_picks', 'labels', 'new_head', 'counts'):
    assert torch.equal(got[key], want[key]), key
  assert int(got['new_head'].sum()) > 0
  probe = torch.arange(7500, device=dev)
  assert torch.equal(K.dedup_table_lookup(*tables[0][:2], probe),
                     K.dedup_table_lookup(*tables[1][:2], probe))


def _hetero_engine(rng):
  counts = {'paper': 4000, 'author': 2000, 'institute': 100}
  rel = {('paper', 'cites', 'paper'): ('paper', 'paper', 40_000),
         ('author', 'writes', 'paper'): ('author', 'paper', 12_000),
         ('author', 'affiliated', 'institute'): ('author', 'institute', 2000)}
  ei = {}
  for e, (s_t, d_t, n) in rel.items():
    ei[e] = np.stack([rng.integers(0, counts[s_t], n),
                      rng.integers(0, counts[d_t], n)])
    if s_t != d_t:
      ei[reverse_edge_type(e)] = ei[e][::-1].copy()
  ds = Dataset().init_graph(ei, num_nodes=counts)
  ds.init_node_features({t: rng.standard_normal((n, 64)).astype(np.float32)
                         for t, n in counts.items()})
  eng = InferenceEngine(ds, RGNN(list(ei), 64, 32, 7, num_layers=3,
                                 conv='rgat', heads=2), None, [5, 3, 2],
                        buckets=(16,), input_type='paper')
  eng.init_params(0)
  return eng


def test_hetero_engine_serves_through_the_kernels(dev):
  eng = _hetero_engine(np.random.default_rng(1))
  K.reset_launch_counts()
  out = eng.infer(np.arange(20))
  assert out.shape == (20, 7) and np.isfinite(out).all()
  assert K.sample_hop_dedup.launches > 0
  assert K.dedup_table_insert.launches > 0 and K.gather_rows.launches > 0


def test_hetero_walk_is_one_init_and_one_hop_launch_a_hop(dev, monkeypatch):
  # a hetero request's sample: one K2 launch (the seed phase) and one B1
  # launch a hop, its batch bit-equal to the plain twins' on the same
  # seeds and uniforms
  eng = _hetero_engine(np.random.default_rng(2))
  seeds = np.arange(0, 4000, 250)
  u = eng.sampler.hop_uniforms(16, 'paper')
  K.reset_launch_counts()
  with torch.no_grad():
    got = eng.make_batch(seeds, 12, 16, uniforms=u)
  counted = (K.dedup_table_insert, K.sample_hop_dedup)
  assert tuple(fn.launches for fn in counted) == (1, 3)
  for name in ('dedup_table_init', 'sample_hop_dedup', 'gather_rows'):
    monkeypatch.setattr(K, name, getattr(K, name + '_plain'))
  with torch.no_grad():
    want = eng.make_batch(seeds, 12, 16, uniforms=u)
  assert tuple(fn.launches for fn in counted) == (1, 3)   # none plain
  for f in ('node_dict', 'node_count_dict', 'row_dict', 'col_dict',
            'edge_mask_dict', 'x_dict'):
    a, b = getattr(got, f), getattr(want, f)
    assert set(a) == set(b) and all(torch.equal(a[t], b[t]) for t in a), f


@pytest.mark.parametrize('k', range(1, 16))
def test_sample_hop_matches_plain(dev, k):
  # a capacity-padded edge array (-1 past the live edges), hub rows of any
  # degree, lanes whose slot clips at either end (to 0 and to E - 1); the
  # stream's and the weighted step's hop shapes, 530K lanes at k = 5
  g = torch.Generator(device=dev).manual_seed(13 + k)
  live, cap = 70_000, 80_000
  indices = torch.full((cap,), -1, dtype=torch.int32, device=dev)
  indices[:live] = torch.randint(0, 9000, (live,), generator=g, device=dev,
                                 dtype=torch.int32)
  eids = torch.randperm(cap, generator=g, device=dev).to(torch.int32)
  shapes = [(256, k), (5888, k), (3, 0)] + [(105_984, 5)] * (k == 5)
  for s, k_ in shapes:
    starts = torch.randint(0, live, (s,), generator=g, device=dev,
                           dtype=torch.int32)
    offsets = torch.randint(-50, 20_000, (s, k_), generator=g, device=dev,
                            dtype=torch.int32)
    if s * k_:
      starts[:2] = torch.tensor([0, cap - 1], device=dev)
      offsets[0] = -torch.arange(1, k_ + 1, device=dev)   # below slot 0
      offsets[1] = torch.arange(k_, device=dev) * 7       # past E - 1
    before = K.sample_hop.launches
    got = K.sample_hop(indices, eids, starts, offsets)
    assert K.sample_hop.launches == before + (s * k_ > 0)
    want = K.sample_hop_plain(indices, eids, starts, offsets)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    picks, none = K.sample_hop(indices, None, starts, offsets)
    assert none is None and torch.equal(picks, want[0])
    if s * k_:
      assert int(got[0][0, 0]) == int(indices[0])
      assert int(got[1][1, -1]) == int(eids[-1])


def test_sample_hop_rejects_what_it_does_not_take(dev):
  # the wrapper checks and converts nothing: int32 and contiguous, or
  # ValueError
  indices = torch.zeros(100, dtype=torch.int32, device=dev)
  starts = torch.zeros(8, dtype=torch.int32, device=dev)
  offsets = torch.zeros((8, 4), dtype=torch.int32, device=dev)
  for args in ((indices.long(), None, starts, offsets),
               (indices, indices.float(), starts, offsets),
               (indices, None, starts.long(), offsets),
               (indices, None, starts, offsets.long()),
               (indices, None, starts, torch.zeros(
                   (4, 8), dtype=torch.int32, device=dev).t()),
               (indices[::2], None, starts, offsets),
               (indices, None, starts[:4], offsets)):
    with pytest.raises(ValueError):
      K.sample_hop(*args)


def test_stream_engine_serves_through_the_kernels(dev):
  rng = np.random.default_rng(2)
  ei = np.stack([rng.integers(0, 3000, 40_000), rng.integers(0, 3000, 40_000)])
  ds = Dataset().init_graph(ei, num_nodes=3000, device=dev)
  ds.init_node_features(rng.standard_normal((3000, 100)).astype(np.float32),
                        device=dev)
  mgr = SnapshotManager(ds.get_graph().topo, ds.get_node_feature(),
                        delta_capacity=256, device=dev)
  sampler = StreamSampler(mgr, [5, 3], seed=0)
  eng = InferenceEngine(ds, GraphSAGE(100, 64, 7), None, [5, 3],
                        buckets=(16,), device=dev, sampler=sampler)
  eng.init_params(0)
  ing = StreamIngestor(mgr, sampler=sampler, engine=eng,
                       policy=CompactionPolicy(max_staleness_s=0))
  K.reset_launch_counts()
  out = eng.infer(np.arange(20))       # two computed requests (16 + 4)
  assert out.shape == (20, 7) and np.isfinite(out).all()
  assert K.sample_hop.launches == 2 * 2 and K.gather_rows.launches == 2
  assert K.sample_walk_dedup.launches == 0
  ing.insert_edges([1, 2], [2999, 2998])
  ing.update_features([1], np.zeros((1, 100), np.float32))
  info = ing.flush()
  assert info['version'] == 1 and info['invalidated'] >= 2
  assert eng.snapshot_version == 1
  assert not np.allclose(eng.infer([1])[0], out[1])


def test_csc_stream_hop_matches_plain(dev):
  """A CSC base sampled along in-edges: each hop's B2 and its two B3
  overlay reads against their plain versions on the same uniforms, before
  and after a compaction that keeps the layout."""
  rng = np.random.default_rng(5)
  n, e = 4000, 60_000
  ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
  ds = Dataset(edge_dir='in').init_graph(ei, num_nodes=n, device=dev)
  mgr = SnapshotManager(ds.get_graph().topo, None, delta_capacity=512,
                        device=dev)
  sampler = StreamSampler(mgr, [6, 4], edge_dir='in', seed=1)
  ing = StreamIngestor(mgr, sampler=sampler, policy=CompactionPolicy(
      occupancy_threshold=2.0, max_staleness_s=0))
  seeds = torch.as_tensor(rng.integers(0, n, 64), device=dev)
  ing.insert_edges(rng.integers(0, n, 200), seeds[:50].cpu().numpy()
                   .repeat(4))
  src, dst = ei[0, :100], ei[1, :100]
  ing.delete_edges(src, dst)
  fields = ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch')
  for state in ('overlay', 'compacted'):
    u = sampler.hop_uniforms(64)
    before = (K.sample_hop.launches, K.gather_windows.launches)
    got = sampler.sample_from_nodes(seeds, uniforms=u)
    assert (K.sample_hop.launches - before[0],
            K.gather_windows.launches - before[1]) == (2, 4), state
    real = K.sample_hop, K.gather_windows
    K.sample_hop, K.gather_windows = K.sample_hop_plain, \
        K.gather_windows_plain
    try:
      want = sampler.sample_from_nodes(seeds, uniforms=u)
    finally:
      K.sample_hop, K.gather_windows = real
    for f in fields:
      assert torch.equal(getattr(got, f), getattr(want, f)), (state, f)
    if state == 'overlay':
      info = ing.flush()
      assert info['version'] == 1 and mgr.layout == 'CSC'
      # touched: the inserts' and deletes' destinations (the CSC rows)
      want_touched = np.unique(np.concatenate([
          dst, seeds[:50].cpu().numpy()]))
      np.testing.assert_array_equal(info['touched'], want_touched)


def test_dist_server_apply_delta_on_the_card(dev):
  from glt_tpu_torch.channel import pack_message, unpack_message
  from glt_tpu_torch.distributed import DistServer
  rng = np.random.default_rng(6)
  n, e = 3000, 40_000
  ds = Dataset().init_graph(np.stack([rng.integers(0, n, e),
                                      rng.integers(0, n, e)]),
                            num_nodes=n, device=dev)
  ds.init_node_features(rng.standard_normal((n, 100)).astype(np.float32),
                        device=dev)
  srv = DistServer(ds)
  rows = np.full((8, 100), 3.25, np.float32)
  ids = np.arange(100, 108, dtype=np.int64)
  out = srv.apply_delta(pack_message({
      'ins': np.array([[0, 1, 2], [7, 8, 9]], np.int64),
      'dels': np.stack([ds.get_graph().topo.to_coo()[0][:2].cpu().numpy(),
                        ds.get_graph().topo.to_coo()[1][:2].cpu().numpy()]),
      'feat_ids': ids, 'feat_rows': rows, 'compact': np.ones(1, np.int8)}))
  assert out['compacted'] and out['version'] == 1 and out['pending'] == 0
  assert srv._stream_ingestor().manager.device.type == 'cuda'
  assert ds.get_node_feature().device.type == 'cuda'
  before = K.gather_rows.launches
  feats = unpack_message(srv.get_node_feature(pack_message({'ids': ids})))
  assert K.gather_rows.launches == before + 1
  np.testing.assert_array_equal(feats['feats'].numpy(), rows)


@pytest.mark.parametrize('dtype', [torch.float32, torch.int32])
@pytest.mark.parametrize('base', [0, 1])
def test_gather_windows_matches_plain(dev, dtype, base):
  # base 1: arr is a view one element into its allocation, so no cover is
  # 16-byte aligned with the allocation. Widths 56 and 8 (the products
  # graph's window and the stream's overlay window), 128 and 1000 (a
  # hub's -1 window: several passes) take the vector path; 57, 55, 7 and
  # 1 the element kernel. Rows at start 0 and len - 1 and rows whose
  # window runs past len take the element path inside the vector kernel.
  g = torch.Generator(device=dev).manual_seed(17 + base)
  e = 90_000
  arr = torch.randint(-1000, 1000, (e + base,), generator=g,
                      device=dev).to(dtype)[base:]
  for s, width in ((4096, 56), (4096, 8), (4096, 57), (4096, 7),
                   (4096, 55), (1000, 1), (333, 128), (64, 1000), (0, 8)):
    starts = torch.randint(0, e, (s,), generator=g, device=dev,
                           dtype=torch.int32)
    if s:
      starts[-4:] = torch.tensor([0, 1, e - 1, e - width // 2 - 1],
                                 device=dev)
    before = K.gather_windows.launches
    got = K.gather_windows(arr, starts, width)
    assert K.gather_windows.launches == before + (s > 0)
    assert got.dtype == dtype and got.shape == (s, width)
    assert torch.equal(got, K.gather_windows_plain(arr, starts, width)), \
        (s, width)
  with pytest.raises(ValueError, match='4-byte'):
    K.gather_windows(arr.double(), starts, 4)


class _Interface:
  """A CUDA array at any byte address (``__cuda_array_interface__``)."""

  def __init__(self, ptr, n):
    self.__cuda_array_interface__ = dict(
        shape=(n,), typestr='<f4', data=(ptr, False), strides=None,
        version=2)


def test_gather_windows_reads_an_unaligned_base(dev):
  # an arr two bytes into its allocation: not 4-byte aligned, so every
  # width takes the element kernel, reading bytes (all below 128: no
  # float32 NaN, whatever the alignment)
  g = torch.Generator(device=dev).manual_seed(31)
  raw = torch.randint(0, 128, (4 * 5000 + 8,), generator=g, device=dev,
                      dtype=torch.uint8)
  arr = torch.as_tensor(_Interface(raw.data_ptr() + 2, 5000), device=dev)
  assert arr.data_ptr() % 4 == 2
  want_arr = raw[2:2 + 4 * 5000].clone().view(torch.float32)
  for width in (56, 7):
    starts = torch.randint(0, 5000, (300,), generator=g, device=dev,
                           dtype=torch.int32)
    got = K.gather_windows(arr, starts, width)
    want = K.gather_windows_plain(want_arr, starts, width)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_gather_windows_rejects_what_it_does_not_take(dev):
  arr = torch.zeros(100, device=dev)
  starts = torch.zeros(8, dtype=torch.int32, device=dev)
  for args in ((arr, starts.long(), 8), (arr[::2], starts, 8),
               (arr, torch.zeros((8, 2), dtype=torch.int32,
                                 device=dev)[:, 0], 8),
               (arr, starts.view(2, 4), 8), (arr.view(10, 10), starts, 8),
               (arr.double(), starts, 8), (arr, starts, 0)):
    with pytest.raises(ValueError):
      K.gather_windows(*args)


def _weighted_csr(dev, n=6000, e=120_000, seed=19):
  g = torch.Generator(device=dev).manual_seed(seed)
  ei = torch.stack([torch.randint(0, n, (e,), generator=g, device=dev),
                    torch.randint(0, n, (e,), generator=g, device=dev)])
  w = 1.0 - torch.rand(e, generator=g, device=dev)
  w[::13] = 0.0
  ds = Dataset().init_graph(ei, edge_weights=w, num_nodes=n, device=dev)
  return ds.get_graph(), g


def _plain_route(monkeypatch):
  for name in ('gather_windows', 'sample_hop'):
    monkeypatch.setattr(K, name, getattr(K, name + '_plain'))


def test_weighted_hop_matches_plain(dev, monkeypatch):
  graph, g = _weighted_csr(dev)
  d = graph.topo.max_degree
  seeds = torch.randint(0, 6000, (5000,), generator=g, device=dev,
                        dtype=torch.int32)
  mask = torch.rand(5000, generator=g, device=dev) < 0.9
  u = weighted_hop_uniforms(g, 5000, d, dev)
  args = (graph.indptr, graph.indices, graph.edge_weights, seeds, 10, u, d)
  before = K.gather_windows.launches
  got = sample_neighbors_weighted(*args, seed_mask=mask)
  assert K.gather_windows.launches == before + 1
  _plain_route(monkeypatch)
  want = sample_neighbors_weighted(*args, seed_mask=mask)
  assert torch.equal(got.mask, want.mask)
  assert torch.equal(got.nbrs, want.nbrs)
  assert int(got.mask.sum()) > 0


def test_full_hop_matches_plain(dev, monkeypatch):
  graph, g = _weighted_csr(dev, seed=23)
  seeds = torch.randint(0, 6000, (3000,), generator=g, device=dev,
                        dtype=torch.int32)
  seeds[0] = torch.iinfo(torch.int32).max     # an invalid frontier lane
  args = (graph.indptr, graph.indices, seeds, graph.topo.max_degree)
  got = sample_full_neighbors(*args)
  _plain_route(monkeypatch)
  want = sample_full_neighbors(*args)
  assert torch.equal(got.mask, want.mask) and torch.equal(got.nbrs, want.nbrs)
  assert not bool(got.mask[0].any())


@pytest.mark.parametrize('sync_stages', [False, True])
def test_weighted_loader_trains_through_the_kernels(dev, sync_stages):
  graph, g = _weighted_csr(dev, seed=29)
  n = graph.num_nodes
  x = torch.randn((n, 32), generator=g, device=dev)
  y = torch.argmax(x @ torch.randn((32, 5), generator=g, device=dev), 1)
  ds = Dataset(graph=graph)
  ds.init_node_features(x, device=dev)
  ds.init_node_labels(y.cpu())
  ds.random_node_split(0.1, 0.1)
  loader = NeighborLoader(ds, [10, 5], ds.get_split('train'), batch_size=256,
                          shuffle=True, with_weight=True, device=dev, seed=0)
  step = SageTrainStep(GraphSAGE(32, 64, 5, num_layers=2).to(dev),
                       sync_stages=sync_stages)
  K.reset_launch_counts()
  losses = [float(step(b)) for _, b in zip(range(4), loader)]
  assert all(np.isfinite(losses))
  assert K.gather_windows.launches == 4 * 2
  assert K.sample_hop.launches == 4 * 2 and K.gather_rows.launches == 4
  assert K.sample_walk_dedup.launches == 0


def test_gat_graphsage_loss_matches_plain(dev):
  # one uniform batch of a 'gat' GraphSAGE through K1 and K3, then through
  # their plain versions with the same seeds and draws: the same batch,
  # the same loss within 1e-4 (index_add_ atomics sum in any order)
  from glt_tpu_torch.parallel import sage_loss
  graph, g = _weighted_csr(dev, seed=37)
  n = graph.num_nodes
  x = torch.randn((n, 32), generator=g, device=dev)
  y = torch.argmax(x @ torch.randn((32, 5), generator=g, device=dev), 1)
  ds = Dataset(graph=graph)
  ds.init_node_features(x, device=dev)
  ds.init_node_labels(y.cpu())
  ds.random_node_split(0.1, 0.1)
  loader = NeighborLoader(ds, [10, 5], ds.get_split('train'), batch_size=256,
                          device=dev, seed=0)
  seeds = ds.get_split('train')[:256]
  u = loader.sampler.hop_uniforms(256)
  torch.manual_seed(0)
  model = GraphSAGE(32, 64, 5, num_layers=2, conv='gat').to(dev).eval()

  def loss():
    b = loader._collate(loader.sampler.sample_from_nodes(seeds, 256,
                                                         uniforms=u),
                        seeds, 256)
    with torch.no_grad():
      return b, float(sage_loss(model, b))
  k1, k3 = K.sample_walk_dedup.launches, K.gather_rows.launches
  bk, lk = loss()
  assert (K.sample_walk_dedup.launches, K.gather_rows.launches) == (k1 + 1,
                                                                     k3 + 1)
  with _swapped(('sample_walk_dedup', 'gather_rows')):
    bp, lp = loss()
  for f in ('node', 'row', 'col', 'edge_mask', 'x', 'y'):
    assert torch.equal(getattr(bk, f), getattr(bp, f)), f
  assert np.isfinite(lk) and abs(lk - lp) <= 1e-4 * max(1.0, abs(lp))


def test_probe_ladder_passes_on_the_card(dev):
  # every rung's kernel equal to its plain version and the TPU rung's
  # reference, each launched once; the microbench's vmem_take not at all
  P.reset_launch_counts()
  before = K.gather_windows.launches
  assert probe_compile.main([]) == 0
  assert {fn.__name__: fn.launches for fn in P.KERNELS} == {
      fn.__name__: int(fn is not P.vmem_take) for fn in P.KERNELS}
  assert K.gather_windows.launches == before + 1


def test_probe_kernels_match_plain(dev):
  g = torch.Generator(device=dev).manual_seed(31)
  x = torch.randn((128, 128), generator=g, device=dev)
  assert torch.equal(P.vmem_id(x), x)
  big = torch.randn((1 << 20,), generator=g, device=dev)
  assert torch.equal(P.vmem_id(big), big)           # 256 blocks
  # the copy at 1, 4,095 and 4,097 16-byte units (a ragged last block)
  # and at 64 MiB (16,384 blocks)
  for units in (1, 4_095, 4_097, 1 << 22):
    y = torch.randn((units, 4), generator=g, device=dev)
    assert torch.equal(P.vmem_id(y), P.vmem_id_plain(y))
    assert torch.equal(P.vmem_id(y), y)
  for s in (3, -7, 1 << 20):
    st = torch.tensor([[s]], dtype=torch.int32, device=dev)
    assert torch.equal(P.smem_scalar(x, st), P.smem_scalar_plain(x, st))
  tab = torch.randn((64, 1, 128), generator=g, device=dev)
  rows = torch.randint(-3, 67, (40,), generator=g, device=dev,
                       dtype=torch.int32)
  assert torch.equal(P.prefetch_grid(tab, rows),
                     P.prefetch_grid_plain(tab, rows))
  wide = torch.randn((300, 1024), generator=g, device=dev)   # 4 KB rows
  assert torch.equal(P.prefetch_grid(wide, rows),
                     P.prefetch_grid_plain(wide, rows))
  with pytest.raises(ValueError):
    P.prefetch_grid(torch.zeros((8, 3), device=dev), rows)
  with pytest.raises(ValueError):
    P.vmem_id(x[:, 1:])


@pytest.mark.parametrize('n', [4, 16_384, 1 << 20])
def test_smem_scalar_matches_plain_at_its_edges(dev, n):
  # one 16-byte unit, the rung's 16,384 elements, 1 << 20; scalars that
  # zero, flip the sign, round (16,777,217 -> 16,777,216 as float32) and
  # the int32 minimum; x holding +-inf, NaN, -0.0 and subnormals. Bit
  # patterns are compared: torch.equal counts NaN unequal to itself
  g = torch.Generator(device=dev).manual_seed(n)
  x = torch.randn(n, generator=g, device=dev)
  special = torch.tensor([float('inf'), float('-inf'), float('nan'), -0.0,
                          1e-40, -3e-45, 1.1754942e-38, 3.4e38],
                         device=dev)
  x[:min(n, 8)] = special[:min(n, 8)]
  if n > 8:
    x[-8:] = special.flip(0)
  for sv in (0, 3, -7, 16_777_217, -2 ** 31):
    s = torch.tensor([[sv]], dtype=torch.int32, device=dev)
    got, want = P.smem_scalar(x, s), P.smem_scalar_plain(x, s)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), sv
    assert torch.equal(got.view(torch.int32),
                       torch.mul(x, s).reshape(n).view(torch.int32)), sv


@pytest.mark.parametrize('start', [512, 513, 4090, 256, 0, 3, -5, 9000])
def test_dma_windows_match_plain(dev, start):
  # aligned (512, 256) and unaligned (513, 3) starts, one near the end
  # (4090, clamped to 3968), negative and past the end; widths that are
  # and are not a multiple of 4
  g = torch.Generator(device=dev).manual_seed(37)
  big = torch.randint(-99, 99, (4096,), generator=g, device=dev,
                      dtype=torch.int32)
  st = torch.tensor([[start]], dtype=torch.int32, device=dev)
  for width in (128, 1, 7, 1024):
    got = P.dma_dynamic(big, st, width)
    assert torch.equal(got, P.dma_dynamic_plain(big, st, width)), width
    assert torch.equal(P.dma_fixed(big, start, width),
                       P.dma_fixed_plain(big, start, width)), width
    assert torch.equal(got, P.dma_fixed_plain(big, start, width))
  # a 4-word array at every width, and a window as wide as its array
  small = torch.tensor([5, -6, 7, -8], dtype=torch.int32, device=dev)
  for width in (1, 2, 3, 4):
    assert torch.equal(P.dma_dynamic(small, st, width),
                       P.dma_dynamic_plain(small, st, width)), width
    assert torch.equal(P.dma_fixed(small, start, width),
                       P.dma_fixed_plain(small, start, width)), width
  whole = big[:1024]
  assert torch.equal(P.dma_dynamic(whole, st, 1024), whole)
  assert torch.equal(P.dma_fixed(whole, start, 1024), whole)
  odd = big[1:]                       # past a 16-byte boundary
  assert torch.equal(P.dma_dynamic(odd, st, 7),
                     P.dma_dynamic_plain(odd, st, 7))
  with pytest.raises(ValueError):
    P.dma_dynamic(big.long(), st)       # not int32
  with pytest.raises(ValueError):
    P.dma_fixed(big, 0, 2048)           # wider than a window holds


@pytest.mark.parametrize('shape', [(8, 3840), (200, 3840), (5, 7), (1,)])
def test_vmem_take_matches_plain(dev, shape):
  # the probe's and the microbench's shapes and two ragged ones, indices
  # out of range at both ends and negative
  g = torch.Generator(device=dev).manual_seed(41)
  tab = torch.randint(0, 1 << 20, (64, 128), generator=g, device=dev,
                      dtype=torch.int32)
  idx = torch.randint(-500, 8192 + 500, shape, generator=g, device=dev,
                      dtype=torch.int32)
  before = P.vmem_take.launches
  got = P.vmem_take(tab, idx)
  assert P.vmem_take.launches == before + 1
  assert got.shape == idx.shape
  assert torch.equal(got, P.vmem_take_plain(tab, idx))
  assert torch.equal(got, torch.take(tab, idx.long().clamp(0, 8191)))
  # rung 7's wrapper: the same kernel, counted apart from vmem_take's
  vt_before = P.vt.launches
  assert torch.equal(P.vt(tab, idx), got)
  assert P.vt.launches == vt_before + 1
  assert P.vmem_take.launches == before + 1
  flat = torch.zeros(8200, dtype=torch.int32, device=dev)
  view = flat[1:8193].view(64, 128)           # not 16-byte aligned
  with pytest.raises(ValueError):
    P.vmem_take(view, idx)
  odd = torch.arange(101, dtype=torch.int32, device=dev)   # a ragged table
  assert torch.equal(P.vmem_take(odd, idx), P.vmem_take_plain(odd, idx))
  unaligned = torch.zeros(idx.numel() + 1, dtype=torch.int32,
                          device=dev)[1:].view(shape)
  unaligned.copy_(idx)
  assert torch.equal(P.vmem_take(tab, unaligned), got)


def _take2d_raw(tab, idx, out):
  """glt_take2d straight, for an ``out`` the wrapper would not allocate
  (a view past a 16-byte boundary); counted nowhere."""
  K._check(P.glt_take2d(tab.data_ptr(), tab.numel(), idx.data_ptr(),
                        idx.numel(), out.data_ptr(), *K._where(tab.device)),
           'glt_take2d')


@pytest.mark.parametrize('n', [1, 4_097, 8_192])
@pytest.mark.parametrize('m', [1, 3, 30_720, 768_001])
def test_take2d_matches_plain_at_its_edges(dev, n, m):
  # a one-word table, a tail word past the table's last 16-byte unit
  # (plain loads beside the 16-byte table fill), the largest table; one
  # index, a ragged count, the rung's 30,720 (8 blocks), a ragged 768,001
  # (one wave, grid-stride); indices negative and past the end; idx and
  # out one element past a 16-byte boundary (the element loop)
  g = torch.Generator(device=dev).manual_seed(n + m)
  tab = torch.randint(-(1 << 30), 1 << 30, (n,), generator=g, device=dev,
                      dtype=torch.int32)
  idx = torch.randint(-n - 5, 2 * n + 5, (m + 1,), generator=g, device=dev,
                      dtype=torch.int32)
  want = P.vmem_take_plain(tab, idx)
  assert torch.equal(want, torch.take(tab, idx.long().clamp(0, n - 1)))
  for fn in (P.vmem_take, P.vt):
    before = fn.launches
    assert torch.equal(fn(tab, idx[:m]), want[:m])
    assert torch.equal(fn(tab, idx[1:]), want[1:])         # element loop
    assert fn.launches == before + 2
  out = torch.full((m + 1,), 7, dtype=torch.int32, device=dev)
  _take2d_raw(tab, idx[:m], out[1:])                      # out unaligned
  assert torch.equal(out[1:], want[:m]) and int(out[0]) == 7


def test_launches_inside_a_cuda_graph_count_as_recorded(dev):
  # each entry point reads its stream's capture state (csrc/entry.cuh): a
  # call outside a capture counts in .launches, one inside
  # torch.cuda.graph in .recorded (it launched nothing), and a replay
  # computes what the eager call did without counting
  g = torch.Generator(device=dev).manual_seed(47)
  table = torch.randn((1000, 100), generator=g, device=dev)
  rows = torch.randint(-3, 1003, (256,), generator=g, device=dev,
                       dtype=torch.int32)
  x = torch.randn((128, 128), generator=g, device=dev)
  s = torch.tensor([[3]], dtype=torch.int32, device=dev)
  tab = torch.randint(0, 1 << 20, (64, 128), generator=g, device=dev,
                      dtype=torch.int32)
  idx = torch.randint(-9, 8200, (8, 3840), generator=g, device=dev,
                      dtype=torch.int32)
  calls = {K.gather_rows: (table, rows), P.smem_scalar: (x, s),
           P.vt: (tab, idx)}
  K.reset_launch_counts()
  P.reset_launch_counts()
  eager = {fn: fn(*a) for fn, a in calls.items()}
  assert {fn.__name__: (fn.launches, fn.recorded) for fn in calls} == {
      fn.__name__: (1, 0) for fn in calls}
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    outs = {fn: fn(*a) for fn, a in calls.items()}
  assert {fn.__name__: (fn.launches, fn.recorded) for fn in calls} == {
      fn.__name__: (1, 1) for fn in calls}
  for out in outs.values():
    out.zero_()
  graph.replay()
  torch.cuda.synchronize()
  for fn in calls:
    assert torch.equal(outs[fn], eager[fn]), fn.__name__
  assert {fn.__name__: (fn.launches, fn.recorded) for fn in calls} == {
      fn.__name__: (1, 1) for fn in calls}


@pytest.mark.parametrize('row_bytes', [16, 512, 16_384])
@pytest.mark.parametrize('b', [1, 16, 153_600])
def test_prefetch_grid_matches_plain_at_its_edges(dev, row_bytes, b):
  # rows of one 16-byte unit, the rung's 512 B and the largest 16 KB; one
  # row, the rung's 16 (a row a warp), the microbench's 153,600 (groups
  # of 32 rows a warp); rows clipped at both ends
  g = torch.Generator(device=dev).manual_seed(row_bytes + b)
  n = 300
  tab = torch.randn((n, row_bytes // 4), generator=g, device=dev)
  rows = torch.randint(-3, n + 3, (b,), generator=g, device=dev,
                       dtype=torch.int32)
  rows[0] = -1
  if b > 1:
    rows[-1] = n
  before = P.prefetch_grid.launches
  got = P.prefetch_grid(tab, rows)
  assert P.prefetch_grid.launches == before + 1
  assert torch.equal(got, P.prefetch_grid_plain(tab, rows))
  assert torch.equal(got, torch.index_select(tab, 0,
                                             rows.long().clamp(0, n - 1)))


def test_probe_gathers_reject_what_they_do_not_take(dev):
  # a table past a 16-byte boundary, a wrong type, a second tensor on
  # another device: ValueError, with the message they always gave
  tab = torch.zeros(8200, dtype=torch.int32, device=dev)
  idx = torch.zeros(16, dtype=torch.int32, device=dev)
  for fn in (P.vmem_take, P.vt):
    name = fn.__name__
    with pytest.raises(ValueError, match=f'^{name} reads an aligned int32'):
      fn(tab[1:8193], idx)
    with pytest.raises(ValueError, match=f'^{name} reads'):
      fn(tab[:64].float(), idx)
    with pytest.raises(ValueError, match=f'^{name} reads'):
      fn(tab[:64], idx.long())
    with pytest.raises(ValueError, match=f'^{name} reads'):
      fn(tab[:64], idx.cpu())
  rows = torch.zeros(4, dtype=torch.int32, device=dev)
  wide = torch.zeros((9, 128), device=dev)
  with pytest.raises(ValueError, match='^prefetch_grid copies aligned rows'):
    P.prefetch_grid(torch.zeros((8, 3), device=dev), rows)   # 12-byte rows
  with pytest.raises(ValueError, match='^prefetch_grid copies'):
    P.prefetch_grid(wide.view(-1)[1:1025].view(8, 128), rows)
  with pytest.raises(ValueError, match='^prefetch_grid copies'):
    P.prefetch_grid(wide, rows.long())
  with pytest.raises(ValueError, match='^prefetch_grid copies'):
    P.prefetch_grid(wide, rows.cpu())


def test_probe_gathers_reject_a_table_on_another_card(dev):
  if torch.cuda.device_count() < 2:
    pytest.skip('needs two cards')
  other = torch.device('cuda', 1)
  idx = torch.zeros(16, dtype=torch.int32, device=dev)
  for fn in (P.vmem_take, P.vt):
    with pytest.raises(ValueError, match=f'^{fn.__name__} reads'):
      fn(torch.zeros(64, dtype=torch.int32, device=other), idx)
  with pytest.raises(ValueError, match='^prefetch_grid copies'):
    P.prefetch_grid(torch.zeros((8, 128), device=other), idx)


def test_kernels_launch_on_the_device_of_their_tensors(dev):
  # the launch switches to the tensors' card when it is not the current
  # one (csrc/entry.cuh), and back
  if torch.cuda.device_count() < 2:
    pytest.skip('needs two cards')
  other = torch.device('cuda', 1)
  torch.cuda.set_device(0)
  g = torch.Generator(device=other).manual_seed(43)
  table = torch.randn((1000, 100), generator=g, device=other)
  rows = torch.randint(0, 1000, (4096,), generator=g, device=other)
  got = K.gather_rows(table, rows)
  assert got.device == other and torch.cuda.current_device() == 0
  assert torch.equal(got, K.gather_rows_plain(table, rows))
  indices = torch.randint(0, 900, (5000,), generator=g, device=other,
                          dtype=torch.int32)
  starts = torch.randint(0, 4000, (256,), generator=g, device=other,
                         dtype=torch.int32)
  offsets = torch.randint(0, 20, (256, 5), generator=g, device=other,
                          dtype=torch.int32)
  assert torch.equal(K.sample_hop(indices, None, starts, offsets)[0],
                     K.sample_hop_plain(indices, None, starts, offsets)[0])
  assert torch.equal(K.gather_windows(indices, starts, 56),
                     K.gather_windows_plain(indices, starts, 56))
  tab = torch.randint(0, 99, (64, 128), generator=g, device=other,
                      dtype=torch.int32)
  assert torch.equal(P.vmem_take(tab, starts), P.vmem_take_plain(tab, starts))
  assert torch.cuda.current_device() == 0


# -- link prediction and subgraphs ----------------------------------------------

def _link_data(dev, seed=31, n=6000, e=90_000):
  g = torch.Generator(device=dev).manual_seed(seed)
  ei = torch.stack([torch.randint(0, n, (e,), generator=g, device=dev),
                    torch.randint(0, n, (e,), generator=g, device=dev)])
  ds = Dataset().init_graph(ei, num_nodes=n, device=dev)
  ds.init_node_features(torch.randn((n, 100), generator=g, device=dev),
                        device=dev)
  return ds, ei, g


def _link_batch(sampler, ds, inputs, props, u):
  out = sampler.sample_from_edges(inputs, proposals=props, uniforms=u)
  return out, ds.get_node_feature().device_gather(out.node)


@pytest.mark.parametrize('mode,amount', [('binary', 1), ('triplet', 2)])
def test_link_batch_matches_plain(dev, monkeypatch, mode, amount):
  # 2,048 seeds with repeats (the products link batch's shape), strict
  # negatives: the walk and the gather equal to their plain versions
  from glt_tpu_torch.ops.negative import edge_in_csr, negative_proposals
  from glt_tpu_torch.sampler import (EdgeSamplerInput, NegativeSampling,
                                     NeighborSampler)
  ds, ei, g = _link_data(dev)
  graph = ds.get_graph()
  sampler = NeighborSampler(graph, [15, 10, 5], device=dev, seed=0)
  pos = torch.randint(0, ei.shape[1], (512,), generator=g, device=dev)
  pos[256:] = pos[:256]                      # repeated edges
  neg = NegativeSampling(mode, amount, strict=True)
  inputs = EdgeSamplerInput(ei[0, pos].cpu().numpy(), ei[1, pos].cpu().numpy(),
                            neg_sampling=neg)
  num_neg = neg.sample_size(512)
  props = negative_proposals(sampler.generator, num_neg, 5, graph.num_nodes,
                             graph.num_nodes, dev)
  n_seeds = 2 * (512 + num_neg) if mode == 'binary' else 1024 + num_neg
  assert n_seeds == 2048
  u = sampler.hop_uniforms(n_seeds)
  K.reset_launch_counts()
  out, x = _link_batch(sampler, ds, inputs, props, u)
  assert K.sample_walk_dedup.launches == 1 and K.gather_rows.launches == 1
  for name in ('sample_walk_dedup', 'gather_rows'):
    monkeypatch.setattr(K, name, getattr(K, name + '_plain'))
  want, want_x = _link_batch(sampler, ds, inputs, props, u)
  for f in ('node', 'node_count', 'row', 'col', 'edge_mask',
            'num_sampled_nodes', 'num_sampled_edges'):
    assert torch.equal(getattr(out, f), getattr(want, f)), f
  assert torch.equal(x, want_x)
  for f, v in want.metadata.items():
    if isinstance(v, torch.Tensor):
      assert torch.equal(out.metadata[f], v), f
  node = out.node.long()
  if mode == 'binary':
    eli = out.metadata['edge_label_index'].long()
    assert torch.equal(node[eli[0, :512]], ei[0, pos].to(node.dtype))
    src, dst = node[eli[0, 512:]], node[eli[1, 512:]]
    assert not bool(edge_in_csr(graph.indptr, graph.indices, src, dst).any())
  else:
    assert tuple(out.metadata['dst_neg_index'].shape) == (512, 2)


def test_link_loader_trains_through_the_kernels(dev):
  from glt_tpu_torch.loader import LinkNeighborLoader
  from glt_tpu_torch.parallel import link_bce_loss
  ds, _, _ = _link_data(dev, seed=37)
  loader = LinkNeighborLoader(ds, [10, 5], batch_size=256, shuffle=True,
                              neg_sampling=('binary', 1), device=dev, seed=0)
  step = SageTrainStep(GraphSAGE(100, 64, 32, num_layers=2).to(dev), lr=3e-3,
                       loss=link_bce_loss)
  K.reset_launch_counts()
  losses = [float(step(b)) for _, b in zip(range(4), loader)]
  assert all(np.isfinite(losses))
  assert K.sample_walk_dedup.launches == 4 and K.gather_rows.launches == 4


def test_subgraph_loader_batch_matches_plain(dev, monkeypatch):
  from glt_tpu_torch.loader import SubGraphLoader
  ds, ei, _ = _link_data(dev, seed=41)
  loader = SubGraphLoader(ds, [10, 5], np.arange(6000), batch_size=64,
                          device=dev, seed=0)
  sampler = loader.sampler
  u = sampler.hop_uniforms(64)
  real = sampler.subgraph
  sampler.subgraph = lambda s: real(s, uniforms=u)
  seeds = np.arange(64)
  K.reset_launch_counts()
  got = loader._make_batch(seeds, 64)
  assert K.sample_walk_dedup.launches == 1 and K.gather_rows.launches == 1
  for name in ('sample_walk_dedup', 'gather_rows'):
    monkeypatch.setattr(K, name, getattr(K, name + '_plain'))
  want = loader._make_batch(seeds, 64)
  for f in ('x', 'row', 'col', 'edge_mask', 'node', 'node_count', 'edge'):
    assert torch.equal(getattr(got, f), getattr(want, f)), f
  # every induced edge (col -> row) is an edge of the graph
  from glt_tpu_torch.ops.negative import edge_in_csr
  graph = ds.get_graph()
  m = got.edge_mask
  node = got.node.long()
  src, dst = node[got.col.long()[m]], node[got.row.long()[m]]
  assert int(m.sum()) > 0
  assert bool(edge_in_csr(graph.indptr, graph.indices, src, dst).all())


def test_seal_extraction_reads_windows_through_the_kernel(dev, monkeypatch):
  from glt_tpu_torch.examples import seal_link_pred as seal
  rng = np.random.default_rng(0)
  und = seal.ring_chord_graph(n=300, chords=200, seed=0)
  split = seal.link_split(und, rng, n=300)
  ds = seal.build_train_dataset(split[0], 300, device=dev)
  from glt_tpu_torch.sampler import NeighborSampler
  sampler = NeighborSampler(ds.get_graph(), [-1, -1], device=dev, seed=0)
  n_cap = sample_budget(2, sampler.num_neighbors)
  links = split[0][:16] + split[1][:16]
  K.reset_launch_counts()
  got = seal.collate(seal.extract_enclosing(
      sampler, links, 1.0, seal.make_drnl_fn(n_cap), n_cap))
  assert K.gather_windows.launches == 2 * len(links)
  assert K.sample_walk_dedup.launches == 0
  monkeypatch.setattr(K, 'gather_windows', K.gather_windows_plain)
  want = seal.collate(seal.extract_enclosing(
      sampler, links, 1.0, seal.make_drnl_fn(n_cap), n_cap))
  for a, b in zip(got, want):
    assert torch.equal(a, b)


# -- the superstep trainer -------------------------------------------------------

CARD_LOSS_TOL = 1e-4   # the same batches; index_add_'s atomics sum in
                       # another order from run to run


def _check_windows(res):
  np.testing.assert_allclose(res['got'], res['want'], rtol=0,
                             atol=CARD_LOSS_TOL)
  assert res['param_diff'] <= CARD_LOSS_TOL
  assert np.isfinite(res['got']).all()


@pytest.mark.parametrize('store', ['resident', 'capped', 'pinned_split',
                                   'cold_streaming'])
def test_superstep_graph_equals_per_batch_calls(dev, store):
  import torch_spmd_worker as worker
  from glt_tpu_torch.parallel import make_mesh
  kw = {'resident': {}, 'capped': dict(bucket_cap=100),
        'pinned_split': dict(split_ratio=0.3),
        'cold_streaming': dict(split_ratio=0.3, host_offload=False,
                               cold_streaming=True)}[store]
  K.reset_launch_counts()
  res = worker.card_windows(make_mesh(device=dev), **kw)
  _check_windows(res)
  # one capture (window length 4), replayed for the second window
  assert (res['captures'], res['replays']) == (1, 1)
  # the walk ran eagerly for the first window and again in the replay of
  # its capture (streaming: both windows sample eagerly, outside the
  # graph); the twin's per-batch calls launch it a batch. The wrappers
  # count what ran eagerly, the trainer what its replays launched.
  replayed = res['replayed']
  streaming = store == 'cold_streaming'
  assert K.sample_walk_dedup.launches == (8 if streaming else 4) + 8
  assert K.sample_walk_dedup.launches + replayed['sample_walk_dedup'] == 16
  if store == 'pinned_split':
    assert K.gather_rows_mixed.launches == 4
    assert replayed['gather_rows_mixed'] == 4
  else:
    assert K.gather_rows.launches > 0 and replayed['gather_rows'] > 0


def test_streaming_epoch_on_the_card_equals_resident(dev):
  from glt_tpu_torch.parallel import (ShardedFeature, SPMDSageTrainStep,
                                      make_mesh)
  mesh = make_mesh(device=dev)
  rng = np.random.default_rng(2)
  n = 3000
  ei = np.stack([rng.integers(0, n, 40_000), rng.integers(0, n, 40_000)])
  feats = rng.normal(size=(n, 24)).astype(np.float32)
  labels = rng.integers(0, 6, n).astype(np.int32)
  g = Dataset().init_graph(ei, num_nodes=n, device=dev).get_graph()
  out = []
  for kw in ({}, dict(split_ratio=0.25, host_offload=False)):
    torch.manual_seed(0)
    step = SPMDSageTrainStep(
        mesh, GraphSAGE(24, 32, 6, num_layers=3).to(dev), g,
        ShardedFeature(feats, mesh, **kw), labels, [4, 3, 2], 64,
        cold_streaming=bool(kw), seed=1)
    loader = step.make_epoch_loader(np.arange(n - 100), superstep_len=4,
                                    rng=np.random.default_rng(0))
    losses = [step.run_epoch(loader) for _ in range(2)]
    assert step.superstep_captures == 2       # K and the tail
    out.append(torch.cat(losses).cpu())
  assert out[0].shape == (2 * 46,)
  torch.testing.assert_close(out[1], out[0], rtol=0, atol=CARD_LOSS_TOL)


def test_two_ranks_over_nccl_train_as_per_batch(dev, tmp_path):
  if torch.cuda.device_count() < 2:
    pytest.skip('needs two cards')
  import pickle
  import torch_spmd_worker as worker
  ctx = torch.multiprocessing.get_context('spawn')
  out = str(tmp_path / 'rank%d.pkl')
  procs = [ctx.Process(target=worker.nccl_main,
                       args=(r, 2, str(tmp_path / 'store'), out))
           for r in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(300)
  hung = [p for p in procs if p.is_alive()]
  for p in hung:
    p.kill()
  assert not hung and all(p.exitcode == 0 for p in procs)
  res = []
  for r in range(2):
    with open(out % r, 'rb') as f:
      res.append(pickle.load(f))
  for name in ('resident', 'capped'):
    for r in res:
      _check_windows(r[name])
      assert (r[name]['captures'], r[name]['replays']) == (1, 1)
    # the mesh mean: every rank reports the same losses
    np.testing.assert_array_equal(res[0][name]['got'], res[1][name]['got'])


# -- partitioned hetero training ----------------------------------------------

def _check_dist(res, world):
  """A batch bit-identical through the kernels and the plain versions,
  one B2 launch a segment and one K3 a node type, and windows (one
  capture, one replay) equal to per-batch calls."""
  assert res['differ'] == []
  assert res['batch_launches']['sample_hop'] == res['segments']
  assert res['batch_launches']['gather_rows'] == 3
  if world > 1:
    assert res['remote'] > 0        # requests another rank served
  _check_windows(res)
  assert (res['captures'], res['replays']) == (1, 1)
  assert res['replayed']['sample_hop'] == 3 * res['segments']
  assert res['replayed']['gather_rows'] == 3 * 3


def test_dist_hetero_one_rank_kernels_and_superstep(dev, tmp_path):
  import torch_dist_worker as worker
  from glt_tpu_torch.parallel import make_mesh
  labels = worker.card_layout(str(tmp_path), 1)
  _check_dist(worker.card_dist_windows(make_mesh(device=dev), str(tmp_path),
                                       labels), 1)


def test_static_dedup_replays_in_a_cuda_graph(dev):
  from glt_tpu_torch.ops.unique import BIG, sorted_hop_dedup_fused
  g = torch.Generator(device=dev).manual_seed(8)

  def case():
    seen = torch.randperm(5000, generator=g, device=dev)[:700].to(
        torch.int32)
    u_ids = torch.cat([seen, torch.full((50,), BIG, dtype=torch.int32,
                                        device=dev)])
    u_labs = torch.cat([torch.randperm(700, generator=g, device=dev).to(
        torch.int32), torch.full((50,), BIG, dtype=torch.int32, device=dev)])
    ids = torch.randint(0, 5000, (20_000,), generator=g, device=dev,
                        dtype=torch.int32)
    valid = torch.rand(20_000, generator=g, device=dev) > 0.2
    return [u_ids, u_labs, torch.tensor(700, dtype=torch.int32, device=dev),
            ids, valid]
  static = case()
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    sorted_hop_dedup_fused(*static)
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = sorted_hop_dedup_fused(*static)
  for _ in range(3):
    fresh = case()
    for s, f in zip(static, fresh):
      s.copy_(f)
    graph.replay()
    want = sorted_hop_dedup_fused(*fresh)
    for k, v in want.items():
      assert torch.equal(out[k], v), k
    assert int(want['new_count']) > 0


def test_two_ranks_over_nccl_train_dist_hetero(dev, tmp_path):
  if torch.cuda.device_count() < 2:
    pytest.skip('needs two cards')
  import pickle
  import torch_dist_worker as worker
  root = str(tmp_path / 'parts')
  np.save(tmp_path / 'labels.npy', worker.card_layout(root, 2))
  ctx = torch.multiprocessing.get_context('spawn')
  out = str(tmp_path / 'rank%d.pkl')
  procs = [ctx.Process(target=worker.dist_nccl_main,
                       args=(r, 2, str(tmp_path / 'store'), root,
                             str(tmp_path / 'labels.npy'), out))
           for r in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(300)
  hung = [p for p in procs if p.is_alive()]
  for p in hung:
    p.kill()
  assert not hung and all(p.exitcode == 0 for p in procs)
  res = []
  for r in range(2):
    with open(out % r, 'rb') as f:
      res.append(pickle.load(f))
  for r in res:
    _check_dist(r, 2)
  # the mesh mean: every rank reports the same losses
  np.testing.assert_array_equal(res[0]['got'], res[1]['got'])


def test_dist_homo_spilled_store_pins_and_matches_resident(dev, tmp_path):
  """On a card a spilled DistFeature pins its cold block, serves a lookup
  through one K3 mixed launch equal to the resident store's K3, and with
  host_offload=False serves the same rows through the host phase (one K3
  launch over the hot rows, nothing pinned); DistTrainStep trains from
  the pinned store as from the resident store."""
  import torch_dist_worker as worker
  from glt_tpu_torch.distributed import DistDataset, DistFeature
  from glt_tpu_torch.parallel import make_mesh
  root = str(tmp_path)
  labels = worker.det_layout(root, 1)
  mesh = make_mesh(device=dev)
  ds = {0: DistDataset.load(root, 0, device='cpu')}
  resident = DistFeature.from_dist_datasets(mesh, ds)
  spilled = DistFeature.from_dist_datasets(mesh, ds, split_ratio=0.3)
  assert spilled.cold_pinned is not None
  assert spilled.cold_pinned.tensor.device.type == 'cpu'
  # the card holds the hot rows only
  assert spilled.array.device.type == 'cuda'
  assert spilled.array.untyped_storage().nbytes() == (
      spilled.hot_count * spilled.feature_dim * spilled.array.element_size())
  host = DistFeature.from_dist_datasets(mesh, ds, split_ratio=0.3,
                                        host_offload=False)
  assert host.host_spilled and host.cold_pinned is None
  ids = np.random.default_rng(0).integers(-1, worker.DET_NODES, 3000)
  K.reset_launch_counts()
  got = spilled.lookup(ids)
  assert (K.gather_rows_mixed.launches, K.gather_rows.launches) == (1, 0)
  assert torch.equal(got, resident.lookup(ids))
  K.reset_launch_counts()
  assert torch.equal(host.lookup(ids), got)
  assert (K.gather_rows_mixed.launches, K.gather_rows.launches) == (0, 1)
  seeds = worker.det_seeds(1)
  a = worker.det_train(mesh, root, labels, seeds)
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(DistFeature, 'from_dist_datasets', classmethod(
        lambda cls, mesh, dss, **kw: spilled))
    b = worker.det_train(mesh, root, labels, seeds)
  np.testing.assert_allclose(a['losses'], b['losses'], rtol=1e-5)


def test_two_ranks_over_nccl_train_dist_homo(dev, tmp_path):
  """Two NCCL ranks over a two-part layout train as one rank over one
  part on both seed blocks (every row a hop takes whole, so the sample
  does not depend on the draws): the same losses and weights to float
  noise."""
  if torch.cuda.device_count() < 2:
    pytest.skip('needs two cards')
  import pickle
  import torch_dist_worker as worker
  from glt_tpu_torch.parallel import make_mesh
  roots = [str(tmp_path / f'parts{w}') for w in (1, 2)]
  labels = [worker.det_layout(r, w) for r, w in zip(roots, (1, 2))]
  seeds = worker.det_seeds(2)
  np.save(tmp_path / 'labels.npy', labels[1])
  np.save(tmp_path / 'seeds.npy', seeds)
  ctx = torch.multiprocessing.get_context('spawn')
  out = str(tmp_path / 'rank%d.pkl')
  procs = [ctx.Process(target=worker.dist_homo_nccl_main,
                       args=(r, 2, str(tmp_path / 'store'), roots[1],
                             str(tmp_path / 'labels.npy'),
                             str(tmp_path / 'seeds.npy'), out))
           for r in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(300)
  hung = [p for p in procs if p.is_alive()]
  for p in hung:
    p.kill()
  assert not hung and all(p.exitcode == 0 for p in procs)
  want = worker.det_train(make_mesh(device=dev), roots[0], labels[0],
                          seeds.reshape(seeds.shape[0], 1, -1))
  for r in range(2):
    with open(out % r, 'rb') as f:
      res = pickle.load(f)
    np.testing.assert_allclose(res['losses'], want['losses'], rtol=1e-5)
    for k, v in want['params'].items():
      np.testing.assert_allclose(res['params'][k], v, rtol=0, atol=1e-5,
                                 err_msg=k)


def test_two_ranks_over_nccl_train_over_a_cached_layout(dev, tmp_path):
  """Two NCCL ranks over a two-part FrequencyPartitioner layout whose
  parts cache a tenth of the nodes each train as one rank over one plain
  part on both seed blocks (every row a hop takes whole, and a cached row
  is its owner's row); each rank's exchanges send exactly the ids its
  rewritten book routes away, none of them cached, fewer than the graph's
  book would have sent."""
  if torch.cuda.device_count() < 2:
    pytest.skip('needs two cards')
  import pickle
  import torch_dist_worker as worker
  from glt_tpu_torch.parallel import make_mesh
  roots = [str(tmp_path / f'parts{w}') for w in (1, 2)]
  labels = [worker.det_layout(roots[0], 1),
            worker.det_layout(roots[1], 2, cache_ratio=0.1)]
  np.testing.assert_array_equal(labels[0], labels[1])
  seeds = worker.det_seeds(2)
  np.save(tmp_path / 'labels.npy', labels[1])
  np.save(tmp_path / 'seeds.npy', seeds)
  ctx = torch.multiprocessing.get_context('spawn')
  out = str(tmp_path / 'rank%d.pkl')
  procs = [ctx.Process(target=worker.dist_homo_nccl_main,
                       args=(r, 2, str(tmp_path / 'store'), roots[1],
                             str(tmp_path / 'labels.npy'),
                             str(tmp_path / 'seeds.npy'), out, True))
           for r in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(300)
  hung = [p for p in procs if p.is_alive()]
  for p in hung:
    p.kill()
  assert not hung and all(p.exitcode == 0 for p in procs)
  want = worker.det_train(make_mesh(device=dev), roots[0], labels[0],
                          seeds.reshape(seeds.shape[0], 1, -1))
  for r in range(2):
    with open(out % r, 'rb') as f:
      res = pickle.load(f)
    np.testing.assert_allclose(res['losses'], want['losses'], rtol=1e-5)
    for k, v in want['params'].items():
      np.testing.assert_allclose(res['params'][k], v, rtol=0, atol=1e-5,
                                 err_msg=k)
    asked, sent, cached = res['asked'], res['sent'], res['cached']
    assert cached.size == int(worker.DET_NODES * 0.1)
    np.testing.assert_array_equal(
        np.sort(sent), np.sort(asked[res['book'][asked] != r]))
    assert not np.isin(sent, cached).any()
    would = int((res['graph_book'][asked] != r).sum())
    assert np.isin(asked, cached).any() and sent.size < would
    print(f'rank {r}: {asked.size} ids asked, {sent.size} sent to the other '
          f'rank ({would} without the cache)')


def test_two_ranks_over_nccl_train_over_an_online_partition(dev, tmp_path):
  """Two NCCL ranks over a two-rank online partition (two
  DistTableRandomPartitioner ranks on threads over loopback rpc) train as
  one rank over the one-rank online partition of the same tables on both
  seed blocks: every row a hop takes whole, so the neighbour order inside
  a row (the chunks' arrival order) does not change the sample."""
  if torch.cuda.device_count() < 2:
    pytest.skip('needs two cards')
  import pickle
  import torch_dist_worker as worker
  from glt_tpu_torch.parallel import make_mesh
  roots = [str(tmp_path / f'parts{w}') for w in (1, 2)]
  labels = [worker.det_layout(roots[0], 1, online=True),
            worker.det_layout(roots[1], 2, online=True)]
  np.testing.assert_array_equal(labels[0], labels[1])
  seeds = worker.det_seeds(2)
  np.save(tmp_path / 'labels.npy', labels[1])
  np.save(tmp_path / 'seeds.npy', seeds)
  ctx = torch.multiprocessing.get_context('spawn')
  out = str(tmp_path / 'rank%d.pkl')
  procs = [ctx.Process(target=worker.dist_homo_nccl_main,
                       args=(r, 2, str(tmp_path / 'store'), roots[1],
                             str(tmp_path / 'labels.npy'),
                             str(tmp_path / 'seeds.npy'), out))
           for r in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(300)
  hung = [p for p in procs if p.is_alive()]
  for p in hung:
    p.kill()
  assert not hung and all(p.exitcode == 0 for p in procs)
  want = worker.det_train(make_mesh(device=dev), roots[0], labels[0],
                          seeds.reshape(seeds.shape[0], 1, -1))
  for r in range(2):
    with open(out % r, 'rb') as f:
      res = pickle.load(f)
    np.testing.assert_allclose(res['losses'], want['losses'], rtol=1e-5)
    for k, v in want['params'].items():
      np.testing.assert_allclose(res['params'][k], v, rtol=0, atol=1e-5,
                                 err_msg=k)
  print(f'two ranks over the online partition: losses {res["losses"]}')


# -- the single-device sampler's last options and the IGBH trainer beyond
# the resident store ------------------------------------------------------------

def _hetero_weighted_dataset(dev, seed=5):
  """A small IGBH-shaped hetero dataset on the card with float32 weights
  on every edge type and bf16 x 1024 features."""
  g = torch.Generator(device=dev).manual_seed(seed)
  counts = {'paper': 4000, 'author': 2000, 'institute': 80}
  draw = lambda n, hi: torch.randint(0, hi, (n,), generator=g, device=dev)
  ei = {('paper', 'cites', 'paper'): torch.stack([draw(40_000, 4000),
                                                   draw(40_000, 4000)]),
        ('author', 'writes', 'paper'): torch.stack([draw(12_000, 2000),
                                                    draw(12_000, 4000)]),
        ('author', 'affiliated', 'institute'): torch.stack(
            [torch.arange(2000, device=dev), draw(2000, 80)])}
  for (s, r, d), e in list(ei.items()):
    if s != d:
      ei[(d, f'rev_{r}', s)] = e.flip(0)
  w = {e: 1.0 - torch.rand(x.shape[1], generator=g, device=dev)
       for e, x in ei.items()}
  ds = Dataset().init_graph(ei, edge_weights=w, num_nodes=counts)
  ds.init_node_features({t: torch.randn((n, 1024), generator=g, device=dev)
                         for t, n in counts.items()}, dtype=torch.bfloat16)
  return ds


def _swapped(names):
  import contextlib

  @contextlib.contextmanager
  def swap():
    real = {n: getattr(K, n) for n in names}
    try:
      for n in names:
        setattr(K, n, getattr(K, n + '_plain'))
      yield
    finally:
      for n, fn in real.items():
        setattr(K, n, fn)
  return swap()


def _same_sample(a, b):
  for f in ('node', 'node_count', 'row', 'col', 'edge_mask', 'edge',
            'num_sampled_nodes', 'num_sampled_edges'):
    x, y = getattr(a, f), getattr(b, f)
    if x is None:
      assert y is None, f
      continue
    assert set(x) == set(y), f
    for k in x:
      assert torch.equal(x[k], y[k]), (f, k)


@pytest.mark.parametrize('fanouts,kw,names', [
    ([4, 3, 2], dict(with_weight=True, with_edge=True),
     ('sample_hop', 'gather_windows')),
    ([-1, -1], dict(full_neighbor_cap=6, with_edge=True),
     ('gather_windows',)),
    ([3, 2], dict(replace=True, with_weight=True, max_weighted_degree=12),
     ('sample_hop', 'gather_windows')),
])
def test_hetero_per_hop_sampler_matches_plain(dev, fanouts, kw, names):
  """The single-device hetero per-hop loop on the card (B3's windows, the
  Gumbel top-k, B2's picks; B3 over neighbour and edge ids for -1 hops)
  bit-identical to the plain versions, its rows too, and launching each
  kernel once a segment."""
  from glt_tpu_torch.sampler import NeighborSampler
  from glt_tpu_torch.sampler.base import NodeSamplerInput
  ds = _hetero_weighted_dataset(dev)
  s = NeighborSampler(ds.graph, fanouts, device=dev, seed=1, **kw)
  assert s._per_hop
  seeds = NodeSamplerInput(np.arange(0, 4000, 125), 'paper')
  u = s.hop_uniforms(32, 'paper')
  K.reset_launch_counts()
  got = s.sample_from_nodes(seeds, uniforms=u)
  xk = {t: gather_features(ds.get_node_feature(t), n)
        for t, n in got.node.items()}
  torch.cuda.synchronize()
  for n in names:
    assert getattr(K, n).launches > 0, n
  assert K.sample_hop_dedup.launches == K.sample_walk_dedup.launches == 0
  with _swapped(names + ('gather_rows',)):
    want = s.sample_from_nodes(seeds, uniforms=u)
    xp = {t: gather_features(ds.get_node_feature(t), n)
          for t, n in want.node.items()}
  _same_sample(got, want)
  for t in xk:
    assert torch.equal(xk[t], xp[t]), t
  assert sum(int(m.sum()) for m in got.edge_mask.values()) > 0


def test_hetero_several_seed_types_match_plain(dev):
  """A public sample_from_nodes seeded with papers and authors: the walk
  (K2's init for both types in one launch, B1 a hop) against the plain
  versions."""
  from glt_tpu_torch.sampler import NeighborSampler
  ds = _hetero_weighted_dataset(dev)
  s = NeighborSampler(ds.graph, [5, 3], device=dev, seed=2)
  inputs = {'paper': np.arange(0, 4000, 100), 'author': np.arange(0, 2000, 90)}
  u = s.hop_uniforms({'paper': 40, 'author': 23})
  K.reset_launch_counts()
  got = s.sample_from_nodes(inputs, uniforms=u, seed_type='author')
  torch.cuda.synchronize()
  assert (K.dedup_table_insert.launches, K.sample_hop_dedup.launches) == (1, 2)
  with _swapped(('sample_hop_dedup', 'dedup_table_init',
                 'dedup_table_init_types')):
    want = s.sample_from_nodes(inputs, uniforms=u, seed_type='author')
  _same_sample(got, want)
  assert got.input_type == 'author'


def test_gather_rows_mixed_bf16_1024_matches_plain_and_in_a_graph(dev):
  """K3 mixed over a split bf16 x 1024 store (2,048-byte rows, the pinned
  cold block): equal to the plain twin and to K3 over the resident table,
  back to back and replayed in a CUDA graph."""
  g = torch.Generator(device=dev).manual_seed(9)
  table = torch.randn((5000, 1024), generator=g, device=dev).to(
      torch.bfloat16)
  hot = table[:1000].clone()
  cold = pin_host(table[1000:].cpu().contiguous(), dev)
  rows = torch.randint(0, 5000, (7000,), generator=g, device=dev,
                       dtype=torch.int32)
  got = K.gather_rows_mixed(hot, cold, rows)
  assert torch.equal(got, K.gather_rows_mixed_plain(hot, cold, rows))
  assert torch.equal(got, K.gather_rows(table, rows))
  static = torch.empty_like(got)
  side = torch.cuda.Stream(dev)
  side.wait_stream(torch.cuda.current_stream(dev))
  with torch.cuda.stream(side):
    static.copy_(K.gather_rows_mixed(hot, cold, rows))
  torch.cuda.current_stream(dev).wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    static.copy_(K.gather_rows_mixed(hot, cold, rows))
  static.zero_()
  graph.replay()
  torch.cuda.synchronize()
  assert torch.equal(static, got)
  del graph


def test_spilled_hetero_trainer_window_replays_in_a_cuda_graph(dev, tmp_path):
  """DistHeteroTrainStep over split 0.2 bf16 stores on the card: the
  stores hold a fifth of the rows, one batch equals the resident stores',
  and two windows of 3 (the second a CUDA-graph replay with K3 mixed
  inside) land within 1e-4 of the same batches a batch a step."""
  import torch_dist_worker as worker
  from glt_tpu_torch.distributed import (DistDataset, DistFeature,
                                         DistHeteroGraph,
                                         DistHeteroNeighborSampler,
                                         DistHeteroTrainStep)
  from glt_tpu_torch.examples.igbh.dist_train_rgnn import step_uniforms
  from glt_tpu_torch.parallel import make_mesh
  root = str(tmp_path / 'layout')
  labels = worker.card_layout(root, 1)
  mesh = make_mesh(device=dev)
  dg = DistHeteroGraph.from_dataset_partitions(mesh, root)
  host = {0: DistDataset.load(root, 0, device='cpu')}
  stores = {s: {t: DistFeature.from_dist_datasets(
      mesh, host, ntype=t, dtype=torch.bfloat16, split_ratio=s)
      for t in dg.node_counts} for s in (None, 0.2)}
  split = stores[0.2]
  assert all(f.cold_pinned is not None for f in split.values())
  assert sum(f.array.numel() for f in split.values()) < sum(
      f.array.numel() for f in stores[None].values()) / 4
  fanouts = [4, 3, 2]
  keys = DistHeteroNeighborSampler(dg, fanouts).message_passing_types(
      16, 'paper')

  def trainer(feats):
    torch.manual_seed(0)
    model = RGNN(keys, worker.CARD_DIM, 32, worker.CARD_CLASSES,
                 num_layers=3, conv='rgat', heads=2,
                 node_types=list(dg.node_counts)).to(dev)
    return DistHeteroTrainStep(dg, feats, model, {'paper': labels}, fanouts,
                               16, 'paper', lr=1e-3)
  a, b, r = trainer(split), trainer(split), trainer(stores[None])
  rng = np.random.default_rng(0)
  seeds = rng.integers(0, 4000, (6, 16))
  one = np.full(1, 16)
  u0 = [[x[0] for x in hop] for hop in step_uniforms(a, 0, 99)]
  s0 = torch.as_tensor(seeds[0], device=dev, dtype=torch.int32)
  n0 = torch.tensor(16, device=dev, dtype=torch.int32)
  with torch.no_grad():
    x_split = a.make_batch(s0, n0, u0).x_dict
    x_res = r.make_batch(s0, n0, u0).x_dict
  assert all(torch.equal(x_split[t], x_res[t]) for t in x_res)
  want = [float(b(seeds[i][None], one, step_uniforms(b, 0, i)))
          for i in range(6)]
  got = []
  for w in range(2):
    idx = range(3 * w, 3 * w + 3)
    us = [step_uniforms(a, 0, i) for i in idx]
    u = [[torch.stack([x[h][j] for x in us]) for j in range(len(us[0][h]))]
         for h in range(len(us[0]))]
    got.extend(a.superstep(seeds[3 * w:3 * w + 3], np.full((3, 1), 16),
                           u).tolist())
  assert (a.superstep_captures, a.graph_replays) == (1, 1)
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_per_hop_loader_options_match_plain(dev):
  """NeighborLoader on the card: a weighted per-hop batch with edge ids
  and a [-1, 4, 3] per-hop batch with replacement, each bit-identical to
  the plain versions; a prefetching loader's batches equal the plain
  loader's."""
  g = torch.Generator(device=dev).manual_seed(4)
  n, e = 20_000, 300_000
  ei = torch.stack([torch.randint(0, n, (e,), generator=g, device=dev),
                    torch.randint(0, n, (e,), generator=g, device=dev)])
  ds = Dataset().init_graph(ei, edge_weights=1.0 - torch.rand(
      e, generator=g, device=dev), num_nodes=n)
  ds.init_node_features(torch.randn((n, 100), generator=g, device=dev))
  seeds = np.arange(0, n, 7)

  def loader(fanouts, **kw):
    return NeighborLoader(ds, fanouts, seeds, batch_size=512, shuffle=True,
                          seed=3, rng=np.random.default_rng(3), **kw)
  names = ('sample_hop', 'gather_windows', 'gather_rows')
  for fanouts, kw in (([6, 4, 3], dict(with_weight=True, with_edge=True)),
                      ([-1, 4, 3], dict(replace=True, with_edge=True))):
    got = next(iter(loader(fanouts, **kw)))
    with _swapped(names):
      want = next(iter(loader(fanouts, **kw)))
    for f in ('node', 'node_count', 'row', 'col', 'edge_mask', 'edge', 'x'):
      assert torch.equal(getattr(got, f), getattr(want, f)), (fanouts, f)
  plain = list(loader([6, 4, 3]))
  pre = loader([6, 4, 3], prefetch_depth=2)
  for x, y in zip(list(pre), plain):
    for f in ('node', 'row', 'col', 'x'):
      assert torch.equal(getattr(x, f), getattr(y, f)), f
  assert not pre._prefetcher.worker_thread.is_alive()


def test_igbh_example_multihost_two_ranks_on_two_cards(dev, tmp_path):
  """The IGBH example's multihost mode as two NCCL ranks, one a card,
  over a two-part layout (split 0.2 stores): each rank opens only its own
  partition's blocks and no feature table or edge payload of the data
  tree, and both see the mesh's mean loss."""
  if torch.cuda.device_count() < 2:
    pytest.skip('needs two cards')
  import torch_dist_worker as worker
  data, part = worker.igbh_tree(tmp_path, papers=2000, parts=2, device=dev)
  res = worker.run_multihost(data, part, tmp_path, ['--split-ratio', '0.2'],
                             timeout=600)
  worker.check_own_blocks(res, data, part)
  assert res[0]['losses'] == res[1]['losses']


# -- the link loader's options and the sharded segment means -------------------

def test_weighted_link_batch_matches_plain(dev, monkeypatch):
  """LinkNeighborLoader(with_weight=True, with_edge=True): one batch of
  256 positives and 256 binary negatives through B3, B2 and K3 equal to
  their plain versions on the same proposals and uniforms, edge ids
  included (-1 on masked lanes)."""
  from glt_tpu_torch.loader import LinkNeighborLoader
  from glt_tpu_torch.ops.negative import negative_proposals
  n, e = 6000, 90_000
  g = torch.Generator(device=dev).manual_seed(43)
  ei = torch.stack([torch.randint(0, n, (e,), generator=g, device=dev),
                    torch.randint(0, n, (e,), generator=g, device=dev)])
  w = 1.0 - torch.rand(e, generator=g, device=dev)
  ds = Dataset().init_graph(ei, edge_weights=w, num_nodes=n, device=dev)
  ds.init_node_features(torch.randn((n, 100), generator=g, device=dev),
                        device=dev)
  loader = LinkNeighborLoader(ds, [6, 4, 3], batch_size=256, shuffle=True,
                              neg_sampling=('binary', 1), with_weight=True,
                              with_edge=True, device=dev, seed=0)
  sampler = loader.sampler
  assert sampler._per_hop and sampler._weighted
  props = negative_proposals(sampler.generator, 256, 5, n, n, dev)
  u = sampler.hop_uniforms(1024)
  real = sampler.sample_from_edges
  sampler.sample_from_edges = lambda inputs: real(inputs, proposals=props,
                                                  uniforms=u)
  pos = np.arange(0, 256 * 7, 7)
  K.reset_launch_counts()
  got = loader._make_batch(pos, 256)
  assert (K.gather_windows.launches, K.sample_hop.launches,
          K.gather_rows.launches, K.sample_walk_dedup.launches) == (3, 3, 1,
                                                                    0)
  for name in ('sample_hop', 'gather_windows', 'gather_rows'):
    monkeypatch.setattr(K, name, getattr(K, name + '_plain'))
  want = loader._make_batch(pos, 256)
  for f in ('node', 'node_count', 'row', 'col', 'edge_mask', 'edge', 'x'):
    assert torch.equal(getattr(got, f), getattr(want, f)), f
  for f in ('edge_label_index', 'edge_label', 'seed_labels'):
    assert torch.equal(got.metadata[f], want.metadata[f]), f
  m = got.edge_mask.bool()
  assert bool(m.any()) and bool((got.edge[~m] == -1).all())
  # a valid lane's edge id is an edge between the lane's endpoints
  node = got.node.long()
  eids = got.edge[m].long()
  assert torch.equal(ei[0, eids], node[got.col[m].long()])
  assert torch.equal(ei[1, eids], node[got.row[m].long()])


def _segment_inputs(rank, dev, rows=50_000, dim=32, segments=1000):
  g = torch.Generator(device=dev).manual_seed(100 + rank)
  msgs = torch.randn((rows, dim), generator=g, device=dev)
  targets = torch.randint(0, segments, (rows,), generator=g, device=dev,
                          dtype=torch.int32)
  mask = torch.rand(rows, generator=g, device=dev) < 0.9
  return msgs, targets, mask


def segment_mean_rank(rank, world, store, out):
  """A spawned NCCL rank on card ``rank``: both sharded means of its own
  rows, pickled to ``out % rank``."""
  import pickle
  import torch.distributed as dist
  from glt_tpu_torch.parallel import (make_mesh, sharded_segment_mean,
                                      sharded_segment_mean_scattered)
  torch.cuda.set_device(rank)
  dev = torch.device('cuda', rank)
  dist.init_process_group('nccl', init_method=f'file://{store}', rank=rank,
                          world_size=world)
  try:
    args = _segment_inputs(rank, dev)
    mesh = make_mesh(device=dev)
    res = {'full': sharded_segment_mean(*args, 1000, mesh).cpu(),
           'scattered': sharded_segment_mean_scattered(*args, 1000,
                                                       mesh).cpu()}
    try:
      sharded_segment_mean_scattered(*args, 1001, mesh)
    except ValueError as e:
      res['error'] = str(e)
    with open(out % rank, 'wb') as f:
      pickle.dump(res, f)
  finally:
    dist.destroy_process_group()


def test_two_ranks_over_nccl_segment_means(dev, tmp_path):
  """sharded_segment_mean and sharded_segment_mean_scattered over two
  NCCL ranks, each holding its own message rows: every rank's mean and
  each rank's block of the scattered one within 1e-6 of one index_add_
  mean over both ranks' rows."""
  if torch.cuda.device_count() < 2:
    pytest.skip('needs two cards')
  import pickle
  ctx = torch.multiprocessing.get_context('spawn')
  out = str(tmp_path / 'rank%d.pkl')
  procs = [ctx.Process(target=segment_mean_rank,
                       args=(r, 2, str(tmp_path / 'store'), out))
           for r in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(300)
  hung = [p for p in procs if p.is_alive()]
  for p in hung:
    p.kill()
  assert not hung and all(p.exitcode == 0 for p in procs)
  res = []
  for r in range(2):
    with open(out % r, 'rb') as f:
      res.append(pickle.load(f))
  msgs, targets, mask = (torch.cat(x) for x in zip(
      *(_segment_inputs(r, dev) for r in range(2))))
  seg = targets.long()[mask]
  ref = torch.zeros((1000, 32), device=dev).index_add_(0, seg, msgs[mask])
  cnt = torch.zeros(1000, device=dev).index_add_(
      0, seg, torch.ones_like(seg, dtype=torch.float32))
  ref = (ref / cnt.clamp(min=1.0)[:, None]).cpu()
  for r, got in enumerate(res):
    torch.testing.assert_close(got['full'], ref, rtol=0, atol=1e-6)
    torch.testing.assert_close(got['scattered'],
                               ref[r * 500:(r + 1) * 500], rtol=0, atol=1e-6)
    assert 'must divide by the group size (2)' in got['error']
