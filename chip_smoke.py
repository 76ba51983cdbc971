#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (glt_tpu_torch) on one NVIDIA GPU.

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version at the shapes the main paths give it, then drives the
three serving paths through InferenceEngine.infer, the two training
paths through NeighborLoader and SageTrainStep, link prediction through
LinkNeighborLoader and SageTrainStep, a SubGraphLoader batch, SEAL
through its example's run, training from a hot/cold split feature store,
the feature bench, superstep training through SPMDSageTrainStep and the
training bench, partitioned hetero training through DistHeteroTrainStep,
hetero link prediction through the hetero LinkNeighborLoader, HGT
training through the hetero NeighborLoader, and the two benchmark entry
points through their main functions, and checks what comes out:

- homogeneous: a seeded 3-layer GraphSAGE (hidden 256, 47 classes, 100
  features, fanouts [15, 10, 5]) over a products-shaped graph (2.45M
  nodes, 62M edges);
- heterogeneous (igbh-rgat): a seeded 3-layer RGAT (1024 -> 512 x 4
  heads -> 19, fanouts [15, 10, 5] on every edge type) over an
  IGBH-small-shaped graph (1M papers, 500K authors, 20K institutes, five
  edge types, 1024 float32 features on every type), seeded on papers;
- live-update (stream): the homogeneous model and graph served through a
  StreamSampler (delta window 8, delta capacity 4096): requests, then
  1,000 edge inserts, 500 deletes and 256 feature rows staged (the
  overlay shows them), requests, a flush that compacts into snapshot
  version 1 and drops the cache entries of the touched ids and their
  in-neighbours (expand_invalidation, as examples/stream_updates.py
  sets it), requests again;
- training (examples/train_sage_products.py, the reference's headline
  workload): NeighborLoader over the homogeneous graph with float32 edge
  weights in (0, 1], learnable labels argmax(x @ w) and a 0.1/0.1 node
  split, batch 1024, fanouts [15, 10, 5], with_weight=True (every hop a
  Gumbel top-k over a gather_windows weight window) -> GraphSAGE 100 ->
  256 -> 256 -> 47 -> masked cross-entropy -> Adam(1e-3), 30 steps; then
  10 uniform steps through the walk, and a [10, -1] full-neighbourhood
  sampler held against its plain route;
- hetero training (examples/hetero/train_rgnn.py at
  examples/igbh/dist_train_rgnn.py's settings): the hetero NeighborLoader
  over the igbh-rgat graph with its features cast to bf16 (the trainer's
  default store), learnable labels argmax(x_paper @ w) and a seeded 60%
  of the papers, batch 64, [15, 10, 5] on every edge type -> the same
  RGAT over the reversed relations -> masked cross-entropy on
  y_dict['paper'] -> Adam(1e-3), 3 warm-up and 10 timed steps; then the
  CSC layout: both graphs flipped on the card, a walk batch and a hetero
  training batch sampled along in-edges (edge_dir='in') and one step;
- link prediction (examples/graph_sage_unsup.py at products-sage's depth
  and width): LinkNeighborLoader over every edge of the homogeneous
  graph, batch 512 with one binary negative each (1,024 labelled pairs,
  2,048 seeds with repeats), [15, 10, 5] -> GraphSAGE 100 -> 256 -> 256
  -> 64 embeddings of every sampled node -> dot-product sigmoid BCE ->
  Adam(3e-3), 3 warm-up and 10 timed steps; a binary and a triplet batch
  of strict negatives held against the plain route; then one
  SubGraphLoader batch (64 seeds, [10, 5]) whose induced edges are
  checked against the CSR;
- SEAL (examples/seal_link_pred.py) on a Cora-sized ring-and-chords graph
  (2,708 nodes, 5,278 undirected edges): 256 + 256 training links and 64
  + 64 of each held-out split, enclosing subgraphs through [-1, -1]
  (gather_windows a hop), DRNL, one epoch of DGCNN at batch 32, its
  validation and test ROC-AUC;
- the hot/cold feature tier (examples/train_sage_products.py
  --split-ratio 0.2): the products table sorted by in-degree through
  Dataset.init_node_features(sort_func=sort_by_in_degree,
  split_ratio=0.2), its hottest 20% of rows on the card and the rest
  pinned in host memory and mapped; the feature gather over both blocks
  (gather_rows_mixed, one launch a batch) held against its plain twin at
  a training batch's rows, at split 0.0 and 1.0 and on bf16 x 101 and
  uint8 x 7 rows, timed in turns beside K3 over the resident table and
  the host phase (host_offload=False), against a bound over the measured
  host link; the uniform training step (batch 1024, [15, 10, 5], Adam
  1e-3), 3 warm-up and 10 timed steps, beside the same steps over the
  resident sorted table; a bucket-256 request against the resident
  store's logits; then glt_tpu_torch.benchmarks.bench_feature at its
  defaults (2M x 128 float32, batch 200K, split 0.2) in a subprocess;
- superstep training (the JAX package's SPMDSageTrainStep as
  benchmarks/bench_train.py drives it): a one-rank mesh, a ShardedFeature
  of the products table (the exchange lookup, K3 serving the rows), batch
  1024, [15, 10, 5], the same GraphSAGE and Adam, windows of K = 8
  batches, each window length one CUDA graph; the sampling window held
  against 8 walks and the exchange against the plain gather; two
  windows against their 16 per-batch calls; run_epoch twice over an
  epoch of 19 batches staged on the card (two captures, then none); the
  body against its plain versions; the same epoch over a split-0.2
  shard (K3 mixed inside the graph) and with cold streaming; then the
  per-batch against superstep bench at the JAX defaults (in a
  subprocess) and at this width;
- partitioned hetero training (examples/igbh/dist_train_rgnn.py at
  igbh-rgat's width, one rank): the igbh-rgat graph and float32 features
  synthesised on the card, partitioned on disk by the port's
  RandomPartitioner (one part) in a temporary directory, loaded back
  through DistHeteroGraph, DistDataset and a bf16 DistFeature a node type
  (the directory then removed); B2 at a batch's one-hop request shapes,
  K3 at its per-type node lists and the static-shape dedup in a CUDA
  graph against their plain versions; DistHeteroTrainStep (RGAT 1024 ->
  512 x 4 -> 19, [15, 10, 5] on every edge type, batch 64, Adam 1e-3) 2
  warm-up and 10 timed steps on seeds of split_indices, 3 eval batches,
  one batch against the plain versions, then two windows of 8 through
  the per-batch engine and through the superstep (eager and captured,
  then a replay) on the same seeds and uniforms;
- hetero link prediction (examples/hetero/bipartite_sage_unsup.py at
  Taobao's counts): 987,994 users, 4,161,138 items in 9,439 categories,
  101 user-item links a user inside one category (99.8M) and their
  reverse, 4 same-category item neighbours an item (16.6M), float32 x 32
  features, drawn on the card; the 80/20 link split; the hetero
  LinkNeighborLoader over ('user', 'to', 'item'), batch 2,048 with one
  binary negative each (4,096 user and 4,096 item seeds through one
  walk: K2's seed phase for both types in one launch), [8, 4] -> RGNN
  rsage 32 -> 64 -> 32 embeddings of both types -> dot-product sigmoid
  BCE -> Adam(3e-3), 2 warm-up and 10 timed steps; K2's two-type init
  timed in turns against the init-then-insert chain, B1 and K3 at the
  batch's shapes; one batch against the plain versions; a test AUC over
  4 batches (printed, not gated);
- HGT (examples/hetero/train_hgt_mag.py at ogbn-mag's counts: 736,389
  papers, 1,134,649 authors, 5,416,271 cites, 7,145,660 writes, 128
  features, 349 classes): the hetero NeighborLoader seeded on papers,
  {cites: [5, 5], writes: [5, 5]}, batch 128 -> HGT (hidden 64, 2 heads,
  2 layers) -> masked cross-entropy -> Adam(2e-3), 2 warm-up and 10 timed
  steps; B1, K2 and K3 (512-byte paper rows) at a batch's shapes and one
  batch against the plain versions;
- repairs: the walk at fanouts [100] and [3, 80] over a graph whose hub
  rows (degree 200-2000) exceed them, and the feature gather on bf16 rows
  of width 101 and uint8 rows of width 7, each against its plain version;
  the device guard's host cost a launch (guard_cost);
- the compile probe's ladder (glt_tpu_torch.benchmarks.probe_compile:
  seven rungs, five kernels of csrc/probes.cu, gather_windows and the
  shared-memory gather of csrc/take2d.cu), its kernels first held against
  their plain versions and timed beside their library calls;
- the gather microbench (glt_tpu_torch.benchmarks.microbench_gather) at
  its published sizes: torch.take, index_select and gather_rows,
  gather_windows, and the shared-memory gather.

Usage, from the repository root, on a machine with a card:

    python3 chip_smoke.py [--seed N]

The hop kernels sample_hop (at the stream request's and the weighted
training step's hops) and gather_windows (at the weighted batch's
windows) are timed in turns against torch.take over the same clipped
slots (kernel, take, kernel, ... over ROUNDS rounds, medians), beside
their byte bounds and host enqueue times; a "claim:" line compares each
sum with torch.take's and gives the spread of their ratio over the
rounds. The feature gather (gather_rows) is timed the same way against
index_select at six row shapes: float32 x 100 and bf16 x 100 (the
products table and its bf16 cast at bucket 256's node list), float32 x
1024 (the igbh-rgat paper table at one request's paper nodes), bf16 x
1024 (its bf16 store at one training batch's paper nodes), bf16 x 101
and uint8 x 7. The walk (sample_walk_dedup, one cooperative launch a
walk), the hetero hop (sample_hop_dedup, one a hop) and the hetero seed
phase (dedup_table_init, one launch a request, beside the chain of ops it
replaced; dedup_table_init_types, both seed types of a link batch in one
launch, beside the init-then-insert chain) are timed back to back,
inside a CUDA graph and by their host enqueue, and every main path
checks that they launch once a walk, once a hop and once a request.

Prints one line per phase with its seconds, the card's name and power
limit, one JSON line of per-kernel numbers ({"kernels": [...]}) and, as
the last line, {"ok": true, "device": {...}}. Exits non-zero, with no
result line, when there is no card, when the package is missing, or when
any check fails. Imports nothing of JAX.
"""
import argparse
import contextlib
import json
import subprocess
import sys
import time

NUM_NODES, NUM_EDGES, FEAT_DIM = 2_450_000, 62_000_000, 100
HIDDEN, CLASSES, FANOUTS, BUCKETS = 256, 47, (15, 10, 5), (8, 64, 256)
REQUESTS = (1, 7, 64, 200, 256)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
LINK_BYTES_PER_S = 64e9       # the host link's peak one way: PCIe Gen5 x16
LOGIT_TOL = 1e-4  # same batch bit for bit; index_add_ float atomics
                  # sum in another order from run to run
# igbh-rgat: IGBH-small's node counts and widths, MLPerf GNN's RGAT
IGBH_NODES = {'paper': 1_000_000, 'author': 500_000, 'institute': 20_000}
IGBH_FEAT, IGBH_HIDDEN, IGBH_HEADS, IGBH_CLASSES = 1024, 512, 4, 19
# stream: the JAX package's defaults (StreamSampler, SnapshotManager) and
# examples/stream_updates.py's compaction policy and cache invalidation
DELTA_WINDOW, DELTA_CAPACITY, OCCUPANCY = 8, 4096, 0.5
N_INSERTS, N_DELETES, N_FEATURE_ROWS = 1000, 500, 256
# training: examples/train_sage_products.py (batch 1024, Adam 1e-3)
TRAIN_BATCH, TRAIN_STEPS, UNIFORM_STEPS, LR = 1024, 30, 10, 1e-3
LOSS_TOL = 1e-4   # same batch bit for bit; index_add_ atomics again
# hetero training: examples/igbh/dist_train_rgnn.py (batch 64, Adam 1e-3,
# a bf16 feature store) over the igbh-rgat graph, a seeded 60% of the
# papers to train on (examples/igbh/split_seeds.py)
HTRAIN_BATCH, HTRAIN_WARMUP, HTRAIN_STEPS, HTRAIN_FRAC = 64, 3, 10, 0.6
# B2 and B3 against torch.take: timed in turns (kernel, take, kernel, ...)
# over ROUNDS rounds, medians reported; host enqueue over HOST_CALLS calls
ROUNDS, HOST_CALLS = 11, 200
# repair checks: the walk at fanouts above 64 over a graph whose hub rows
# (degree 200-2000) exceed them, K3 on rows that are not 4-byte words
HUB_NODES, HUB_COUNT, HUB_DEGREE = 200_000, 2_000, (200, 2000)
WIDE_FANOUTS = ((100,), (3, 80))
NARROW_ROWS = (('bfloat16', 101), ('uint8', 7))


class Phase:
  def __init__(self, name):
    self.name = name

  def __enter__(self):
    self.t0 = time.perf_counter()
    return self

  def __exit__(self, *exc):
    if exc[0] is None:
      print(f'[phase] {self.name}: {time.perf_counter() - self.t0:.3f} s',
            flush=True)


def cuda_ms(torch, fn, iters, warmup=2):
  """Mean milliseconds per call over ``iters`` calls, CUDA events."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for i in range(iters):
    fn(i)
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def graph_ms(torch, fn, calls=50, replays=5):
  """Device milliseconds a call of ``fn``: ``calls`` calls captured in one
  CUDA graph, replayed ``replays`` times between CUDA events, so that the
  host's enqueue time, which bounds back-to-back launches of a small
  kernel, drops out."""
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(calls):
      fn()
  graph.replay()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(replays):
    graph.replay()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / (calls * replays)


def in_turns_ms(torch, np, fns, iters=50, abba=False):
  """cuda_ms of each callable of ``fns`` (name -> fn) in each of ROUNDS
  rounds, timed in turns within a round so that host noise hits them
  alike (``abba``: every other round in reverse order): name -> array of
  the rounds' times."""
  times = {n: [] for n in fns}
  for r in range(ROUNDS):
    order = list(fns.items())
    for n, fn in (order[::-1] if abba and r % 2 else order):
      times[n].append(cuda_ms(torch, lambda i=0, fn=fn: fn(), iters))
  return {n: np.array(v) for n, v in times.items()}


def in_turns_host_us(torch, np, fns, calls=HOST_CALLS):
  """Host microseconds per call to enqueue each callable of ``fns``: a
  host clock over ``calls`` calls with no sync among them, the callables
  in turns over ROUNDS rounds, medians."""
  times = {n: [] for n in fns}
  for _ in range(ROUNDS):
    for n, fn in fns.items():
      fn()
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      for _ in range(calls):
        fn()
      times[n].append((time.perf_counter() - t0) / calls * 1e6)
      torch.cuda.synchronize()
  return {n: float(np.median(v)) for n, v in times.items()}


def verdict(what, ms, yardstick_ms, label='torch.take', ratios=None):
  """One "claim:" line: ``ms`` against ``yardstick_ms`` (sums of medians)
  and, given the per-round ratios of the two, their median and range,
  which says whether the verdict is inside the host's round-to-round
  noise."""
  spread = ''
  if ratios is not None:
    lo, mid, hi = min(ratios), sorted(ratios)[len(ratios) // 2], max(ratios)
    spread = (f'; kernel/{label} per round median {mid:.3f}, range '
              f'[{lo:.3f}, {hi:.3f}]'
              + (', level within the rounds\' noise' if lo <= 1 <= hi
                 else ''))
  print(f'claim: {what}: {ms:.4f} ms vs {label} {yardstick_ms:.4f} ms: '
        f'{"no slower" if ms <= yardstick_ms else "SLOWER"}{spread}')


def time_picks(torch, np, K, label, hops):
  """B2 at each recorded hop ``(indices, eids, starts, offsets)``: equal
  to plain, its time against torch.take over the same clipped slots (in
  turns, and in a CUDA graph, where the host's enqueue drops out), its
  plain time, bound and host enqueue; returns the row of sums."""
  row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0,
             graph_ms=0.0, library_graph_ms=0.0)
  rounds = {'kernel': 0.0, 'take': 0.0}
  for h, (indices, eids, starts, offsets) in enumerate(hops):
    got = K.sample_hop(indices, eids, starts, offsets)[0]
    want = K.sample_hop_plain(indices, eids, starts, offsets)[0]
    if not torch.equal(got, want):
      raise AssertionError(f'sample_hop {label} hop {h + 1} differs from '
                           'plain')
    row['err'] = max(row['err'], int((got.long() - want.long()).abs().max()))
    slots = (starts.long()[:, None] + offsets.long()).clamp(
        0, indices.numel() - 1)
    fns = {'kernel': lambda: K.sample_hop(indices, eids, starts, offsets),
           'take': lambda: torch.take(indices, slots)}
    per_round = in_turns_ms(torch, np, fns)
    t = {n: float(np.median(v)) for n, v in per_round.items()}
    for n in rounds:
      rounds[n] = rounds[n] + per_round[n]
    host = in_turns_host_us(torch, np, fns)
    graph = {n: graph_ms(torch, fn, calls=20) for n, fn in fns.items()}
    plain = cuda_ms(torch, lambda i=0: K.sample_hop_plain(
        indices, eids, starts, offsets), 20)
    # bytes the read must move: a start per row; per lane an offset and
    # a neighbour id in, a pick out
    s, k = offsets.shape
    bound = bytes_ms(4 * s + 12 * s * k)
    for key, v in (('ms', t['kernel']), ('plain_ms', plain),
                   ('library_ms', t['take']), ('bound_ms', bound),
                   ('graph_ms', graph['kernel']),
                   ('library_graph_ms', graph['take'])):
      row[key] += v
    print(f'sample_hop {label} hop {h + 1} [{s}, {k}] over '
          f'{indices.numel()} slots: equal to plain; {t["kernel"]:.4f} ms '
          f'(torch.take {t["take"]:.4f} ms, in turns, medians of {ROUNDS}; '
          f'plain {plain:.4f} ms; bound {bound:.6f} ms, '
          f'{bound / t["kernel"] * 100:.1f}% of it); in a CUDA graph '
          f'{graph["kernel"]:.4f} ms (torch.take {graph["take"]:.4f} ms); '
          f'host enqueue {host["kernel"]:.2f} us a call (torch.take '
          f'{host["take"]:.2f} us)')
  print(f'sample_hop per {label} ({len(hops)} hops): {row["ms"]:.4f} ms '
        f'(plain {row["plain_ms"]:.4f} ms, torch.take '
        f'{row["library_ms"]:.4f} ms, bound {row["bound_ms"]:.6f} ms); in a '
        f'CUDA graph {row["graph_ms"]:.4f} ms (torch.take '
        f'{row["library_graph_ms"]:.4f} ms)')
  verdict(f'sample_hop summed over a {label}\'s {len(hops)} hops',
          row['ms'], row['library_ms'],
          ratios=list(rounds['kernel'] / rounds['take']))
  verdict(f'sample_hop summed over a {label}\'s {len(hops)} hops in a CUDA '
          'graph', row['graph_ms'], row['library_graph_ms'])
  return row


def unique_dedup(torch, big, u_ids, u_labs, count, ids, valid):
  """The data-sized version of ``sorted_hop_dedup_fused`` that the
  static-shape one replaced, kept here to time the two in turns: new ids
  ranked by ``torch.unique`` (its size read on the host), each one's head
  by a scatter-min."""
  dev = ids.device
  m = ids.numel()
  x = torch.where(valid, ids.to(torch.int32),
                  torch.full_like(ids, big, dtype=torch.int32))
  seen_ids, order = torch.sort(u_ids.to(torch.int32))
  seen_labs = u_labs.to(torch.int32)[order]
  if seen_ids.numel():
    pos = torch.searchsorted(seen_ids, x).clamp(max=seen_ids.numel() - 1)
    found = valid & (seen_ids[pos] == x)
    seen_lab = seen_labs[pos]
  else:
    found = torch.zeros_like(valid)
    seen_lab = torch.full_like(x, -1)
  new_el = valid & ~found
  uniq = torch.unique(x[new_el])
  n_new = uniq.numel()
  rank = torch.searchsorted(uniq, x).clamp(max=max(n_new - 1, 0))
  iota = torch.arange(m, device=dev)
  first = torch.full((n_new + 1,), m, dtype=torch.long, device=dev)
  first.scatter_reduce_(0, torch.where(new_el, rank, n_new), iota, 'amin')
  new_head3 = new_el & (first[rank] == iota)
  labels3 = torch.where(found, seen_lab, torch.where(
      new_el, (count + rank).to(torch.int32),
      torch.full_like(x, -1))).to(torch.int32)
  new_count = torch.tensor(n_new, dtype=torch.int32, device=dev)
  pad = torch.full_like(x, big)
  return dict(
      labels3=labels3, new_head3=new_head3,
      u_ids2=torch.cat([u_ids.to(torch.int32),
                        torch.where(new_head3, x, pad)]),
      u_labs2=torch.cat([u_labs.to(torch.int32),
                         torch.where(new_head3, labels3, pad)]),
      count2=(count + new_count).to(torch.int32), new_count=new_count)


@contextlib.contextmanager
def recorded_dedups(torch, calls):
  """While open, every ``sorted_hop_dedup_fused`` call of the per-hop loops
  (ops/pipeline.py) appends a copy of its arguments to ``calls``."""
  from glt_tpu_torch.ops import pipeline
  real = pipeline.sorted_hop_dedup_fused

  def record(*a):
    calls.append(tuple(x.clone() if isinstance(x, torch.Tensor) else x
                       for x in a))
    return real(*a)
  pipeline.sorted_hop_dedup_fused = record
  try:
    yield
  finally:
    pipeline.sorted_hop_dedup_fused = real


def time_dedup(torch, np, label, calls):
  """The static-shape ``sorted_hop_dedup_fused`` against the data-sized
  version it replaced (``unique_dedup``) at each recorded hop's arguments:
  equal on every output, timed in turns (medians of ROUNDS rounds), summed
  over the hops; prints both and a "claim:" line, returns the sums."""
  from glt_tpu_torch.ops.unique import BIG, sorted_hop_dedup_fused
  sums = {'static': 0.0, 'unique': 0.0}
  rounds = {'static': 0.0, 'unique': 0.0}
  per_hop = []
  for h, a in enumerate(calls):
    new, old = sorted_hop_dedup_fused(*a), unique_dedup(torch, BIG, *a)
    for key, v in new.items():
      if not torch.equal(v, old[key]):
        raise AssertionError(f'sorted_hop_dedup_fused {label} hop {h + 1}: '
                             f'{key} differs from the torch.unique version')
    fns = {'static': lambda a=a: sorted_hop_dedup_fused(*a),
           'unique': lambda a=a: unique_dedup(torch, BIG, *a)}
    per_round = in_turns_ms(torch, np, fns, iters=20)
    for n in sums:
      sums[n] += float(np.median(per_round[n]))
      rounds[n] = rounds[n] + per_round[n]
    per_hop.append((a[3].numel(), a[0].numel(),
                    round(float(np.median(per_round['static'])), 4),
                    round(float(np.median(per_round['unique'])), 4)))
  print(f'sorted_hop_dedup_fused per {label} ({len(calls)} hops; lanes, '
        f'seen-set, static ms, torch.unique version ms: {per_hop}): equal on '
        f'every output; static {sums["static"]:.4f} ms, the torch.unique '
        f'version {sums["unique"]:.4f} ms (in turns, medians of {ROUNDS})')
  verdict(f'sorted_hop_dedup_fused summed over a {label}\'s {len(calls)} '
          'hops', sums['static'], sums['unique'],
          label='the torch.unique version',
          ratios=list(rounds['static'] / rounds['unique']))
  return sums


def bytes_ms(nbytes):
  return nbytes / HBM_BYTES_PER_S * 1e3


def time_gather(torch, np, K, label, table, rows):
  """K3 on ``table`` at ``rows``: bit-equal to its plain version and to
  index_select over the clamped rows, timed in turns with index_select
  (medians of ROUNDS rounds), its plain time, host enqueue and byte bound
  (each distinct table row read once, an output row written and a 4-byte
  index read per row: a node list's -1 pad lanes all read row 0); prints
  its line and a "claim:" line and returns its row."""
  n = table.shape[0]
  clamped = rows.long().clamp(0, n - 1)
  got = K.gather_rows(table, rows)
  if not (torch.equal(got, K.gather_rows_plain(table, rows))
          and torch.equal(got, torch.index_select(table, 0, clamped))):
    raise AssertionError(f'gather_rows {label} differs')
  del got
  fns = {'kernel': lambda: K.gather_rows(table, rows),
         'index_select': lambda: torch.index_select(table, 0, clamped)}
  per_round = in_turns_ms(torch, np, fns)
  t = {k: float(np.median(v)) for k, v in per_round.items()}
  host = in_turns_host_us(torch, np, fns)
  plain = cuda_ms(torch, lambda i=0: K.gather_rows_plain(table, rows), 20)
  b, distinct = rows.numel(), int(torch.unique(clamped).numel())
  row_bytes = table.shape[1] * table.element_size()
  # device time in a CUDA graph where 20 outputs fit in 1.3 GB: back to
  # back, a small gather's time is its host enqueue
  graph = {}
  if b * row_bytes <= 2 ** 26:
    graph = {k: graph_ms(torch, fn, calls=20) for k, fn in fns.items()}
  bound = bytes_ms((distinct + b) * row_bytes + 4 * b)
  lay = K.gather_rows_layout(row_bytes, table.data_ptr())
  mode = (f'T={lay.lanes}, {lay.passes} pass(es), '
          + ('realigned' if lay.realign else 'copy'))
  print(f'gather_rows {label}: {b} rows ({distinct} distinct) of '
        f'{row_bytes} B ({mode}), equal to plain and index_select; '
        f'{t["kernel"]:.4f} ms (index_select {t["index_select"]:.4f} ms, '
        f'in turns, medians of {ROUNDS}; plain {plain:.4f} ms; bound '
        f'{bound:.6f} ms, {bound / t["kernel"] * 100:.1f}% of it); '
        + (f'in a CUDA graph {graph["kernel"]:.4f} ms (index_select '
           f'{graph["index_select"]:.4f} ms); ' if graph else '')
        + f'host enqueue {host["kernel"]:.2f} us a call (index_select '
        f'{host["index_select"]:.2f} us)')
  verdict(f'gather_rows {label}', t['kernel'], t['index_select'],
          label='index_select',
          ratios=list(per_round['kernel'] / per_round['index_select']))
  return dict(ms=t['kernel'], plain_ms=plain, library_ms=t['index_select'],
              bound_ms=bound, err=0, host_us=host['kernel'],
              graph_ms=graph.get('kernel'),
              library_graph_ms=graph.get('index_select'), rows=b,
              distinct=distinct, layout=lay._asdict())


def time_table_init(torch, K, args, host_us):
  """K2's init (``dedup_table_init(*args)``, the hetero walk's seed phase)
  against its plain twin by lookups of every seed and 64 absent ids; the
  init timed back to back, in a CUDA graph and by host enqueue, beside
  the chain of ops it replaced (make_dedup_table, the masked ids, the
  in-place insert) timed the same ways; returns its kernel row."""
  slots, ids, labs, heads, base, dev = args
  before = K.dedup_table_insert.launches
  got = K.dedup_table_init(*args)
  if K.dedup_table_insert.launches != before + 1:
    raise AssertionError('the table init is not one launch')
  want = K.dedup_table_init_plain(*args)
  live = heads & (ids < K.BIG)
  probe = torch.cat([torch.where(live, ids.long() + base, -1),
                     torch.arange(2 ** 31 - 65, 2 ** 31 - 1, device=dev)])
  a = K.dedup_table_lookup(*got[:2], probe)
  b = K.dedup_table_lookup(*want[:2], probe)
  if not (torch.equal(a, b) and torch.equal(got[2], want[2])):
    raise AssertionError('dedup_table_init differs from plain')
  seen = torch.where(live, labs.long(), -1)
  if not torch.equal(a[:ids.numel()], seen) or bool((a[ids.numel():]
                                                      >= 0).any()):
    raise AssertionError('dedup_table_init lookups miss seed labels')

  def chain():   # the seed phase before this kernel took it over
    keys, vals, _ = K.make_dedup_table(slots, dev)
    x = torch.where(heads, ids + base, torch.full_like(ids, -1))
    K.dedup_table_insert(keys, vals, x, labs, x >= 0)

  init = lambda: K.dedup_table_init(*args)
  ms = cuda_ms(torch, lambda i=0: init(), 20)
  chain_ms = cuda_ms(torch, lambda i=0: chain(), 20)
  plain = cuda_ms(torch, lambda i=0: K.dedup_table_init_plain(*args), 3,
                  warmup=1)
  dev_ms = graph_ms(torch, init, calls=20)
  chain_dev = graph_ms(torch, chain, calls=20)
  host = host_us({'kernel': init, 'chain': chain})
  # bytes the init must move: the fill's three planes, a 1-byte flag a
  # lane, an id where the flag is set, and for each insert its label read
  # and its key and label written
  n_ins = int(live.sum())
  bound = bytes_ms(12 * slots + ids.numel() + 4 * int(heads.sum())
                   + 12 * n_ins)
  print(f'dedup_table_init: {slots} slots, {ids.numel()} seed lanes, '
        f'{n_ins} inserted at base {base}; one launch, lookups equal to '
        f'plain; {ms:.4f} ms back to back, in a CUDA graph {dev_ms:.4f} '
        f'ms ({bound / dev_ms * 100:.1f}% of the bound), host enqueue '
        f'{host["kernel"]:.2f} us a call; the chain it replaced '
        f'{chain_ms:.4f} ms, in a CUDA graph {chain_dev:.4f} ms, host '
        f'{host["chain"]:.2f} us (plain {plain:.4f} ms, bound {bound:.6f} '
        'ms)')
  return dict(ms=ms, plain_ms=plain, err=int((a - b).abs().max()),
              bound_ms=bound, graph_ms=dev_ms, host_us=host['kernel'],
              chain_ms=chain_ms, chain_graph_ms=chain_dev,
              chain_host_us=host['chain'], slots=slots)


def recorded_hetero_sample(K, sample):
  """Runs ``sample()`` with the hetero walk's kernels (B1, K2's init of one
  or several seed types) replaced by their plain versions, which leave
  every input of the next hop as the kernels would, and records their
  inputs as the pipeline hands them over (the tables copied before each
  hop). Returns (hops, inits, the sample's output): a hop is ``(args,
  table planes, kwargs)``, an init ``(wrapper name, args)``."""
  hops, inits = [], []
  real = {n: getattr(K, n) for n in ('sample_hop_dedup', 'dedup_table_init',
                                     'dedup_table_init_types')}

  def record(*a, **kw):
    hops.append((a, [t.clone() for t in a[5:8]], kw))
    return K.sample_hop_dedup_plain(*a, **kw)

  def init(name):
    def rec(*a):
      inits.append((name, a))
      return getattr(K, name + '_plain')(*a)
    return rec
  K.sample_hop_dedup = record
  K.dedup_table_init = init('dedup_table_init')
  K.dedup_table_init_types = init('dedup_table_init_types')
  try:
    out = sample()
  finally:
    for n, fn in real.items():
      setattr(K, n, fn)
  return hops, inits, out


def time_hops(torch, K, hops, host_us, label):
  """B1 at each recorded hop (``recorded_hetero_sample``): one launch,
  equal to its plain version on every output and on the table it leaves,
  timed back to back, in a CUDA graph (each call on a fresh copy of the
  table, less the copy's own time) and by host enqueue, beside its plain
  time and byte bound; prints a line a hop and the sums, returns the row
  of sums."""
  hop_row = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0, graph_ms=0.0,
                 host_us=0.0)
  hop = K.sample_hop_dedup
  for h, (a, table, kw) in enumerate(hops):
    fresh = lambda: [t.clone() for t in table]
    kt, pt = fresh(), fresh()
    before = hop.launches
    got = hop(*a[:5], *kt, *a[8:], **kw)
    if hop.launches != before + 1:
      raise AssertionError('a hop is not one launch')
    want = K.sample_hop_dedup_plain(*a[:5], *pt, *a[8:], **kw)
    for key in ('picks', 'labels', 'new_head', 'counts'):
      if not torch.equal(got[key], want[key]):
        raise AssertionError(f'sample_hop_dedup {label} hop {h} {key} '
                             'differs')
      hop_row['err'] = max(hop_row['err'], int(
          (got[key].long() - want[key].long()).abs().max()))
    ok = a[4].reshape(-1)
    probe = torch.unique(got['picks'].reshape(-1)[ok])
    if not torch.equal(K.dedup_table_lookup(*kt[:2], probe),
                       K.dedup_table_lookup(*pt[:2], probe)):
      raise AssertionError(f'sample_hop_dedup {label} hop {h} tables differ')
    s, k = a[3].shape
    tables = [fresh() for _ in range(10)]
    ms = cuda_ms(torch, lambda i=0: hop(*a[:5], *tables[i], *a[8:], **kw),
                 10, warmup=0)
    ptables = [fresh() for _ in range(2)]
    plain = cuda_ms(torch, lambda i=0: K.sample_hop_dedup_plain(
        *a[:5], *ptables[i], *a[8:], **kw), 2, warmup=0)
    live = fresh()
    reset = lambda: [t.copy_(u) for t, u in zip(live, table)]
    copy_ms = graph_ms(torch, reset)
    dev_ms = graph_ms(torch, lambda: (reset(), hop(*a[:5], *live, *a[8:],
                                                   **kw))) - copy_ms
    host = host_us({'kernel': lambda: hop(*a[:5], *live, *a[8:],
                                          **kw)})['kernel']
    hop_row['graph_ms'] += dev_ms
    hop_row['host_us'] += host
    # bytes the hop must move: starts, offsets and validity in, one
    # neighbour id and one table key per valid lane, and per lane the
    # outputs (pick, label: 4 B; head: 1 B), a key and a label written
    # per new id
    n_ok, n_new = int(ok.sum()), int(got['new_head'].sum())
    nbytes = 4 * s + 5 * s * k + 8 * n_ok + 9 * s * k + 8 * n_new
    for key, v in (('ms', ms), ('plain_ms', plain),
                   ('bound_ms', bytes_ms(nbytes))):
      hop_row[key] += v
    print(f'sample_hop_dedup {label} hop {h + 1} [{s}, {k}]: {n_ok} valid '
          f'lanes, {n_new} new ids, one launch, equal to plain on every '
          f'surface; {ms:.4f} ms back to back, in a CUDA graph {dev_ms:.4f} '
          f'ms (table copy {copy_ms:.4f} ms taken off), host enqueue '
          f'{host:.2f} us a call (plain {plain:.4f} ms, bound '
          f'{bytes_ms(nbytes):.6f} ms)')
    del tables, ptables, live
  print(f'sample_hop_dedup per {label} ({len(hops)} hops): '
        f'{hop_row["ms"]:.4f} ms back to back, in a CUDA graph '
        f'{hop_row["graph_ms"]:.4f} ms, host enqueue '
        f'{hop_row["host_us"]:.2f} us (plain {hop_row["plain_ms"]:.4f} '
        f'ms, bound {hop_row["bound_ms"]:.6f} ms)')
  return hop_row


def time_table_init_types(torch, np, K, args, host_us):
  """K2's init of several seed types (``dedup_table_init_types(*args)``,
  a two-type link batch's seed phase): one launch, equal to its plain
  twin (the ``first`` plane and the occupied slots bit for bit, every
  seed's label and 64 absent ids by lookup; which key holds which
  occupied slot depends on the order of the atomic inserts); timed in
  turns against the two-launch chain it replaces (the one-type init, then
  an in-place insert a further type), back to back and in a CUDA graph,
  and by host enqueue; returns its row."""
  slots, segs, dev = args
  before = K.dedup_table_insert.launches
  got = K.dedup_table_init_types(*args)
  if K.dedup_table_insert.launches != before + 1:
    raise AssertionError('the multi-type table init is not one launch')
  want = K.dedup_table_init_types_plain(*args)
  live = [h & (i < K.BIG) for i, _, h, _ in segs]
  probe = torch.cat([torch.where(m, i.long() + b, -1)
                     for m, (i, _, _, b) in zip(live, segs)]
                    + [torch.arange(2 ** 31 - 65, 2 ** 31 - 1, device=dev)])
  a = K.dedup_table_lookup(*got[:2], probe)
  b = K.dedup_table_lookup(*want[:2], probe)
  if not (torch.equal(a, b) and torch.equal(got[2], want[2])
          and torch.equal(got[0] >= 0, want[0] >= 0)):
    raise AssertionError('dedup_table_init_types differs from plain')
  seen = torch.cat([torch.where(m, l.long(), -1)
                    for m, (_, l, _, _) in zip(live, segs)])
  if not torch.equal(a[:seen.numel()], seen) or bool(
      (a[seen.numel():] >= 0).any()):
    raise AssertionError('dedup_table_init_types lookups miss seed labels')

  def chain():   # the one-type init, then an in-place insert a type
    keys, vals, _ = K.dedup_table_init(slots, *segs[0], dev)
    for ids, labs, heads, base in segs[1:]:
      x = torch.where(heads, ids + base, torch.full_like(ids, -1))
      K.dedup_table_insert(keys, vals, x, labs, x >= 0)

  init = lambda: K.dedup_table_init_types(*args)
  per_round = in_turns_ms(torch, np, {'kernel': init, 'chain': chain},
                          iters=20)
  t = {n: float(np.median(v)) for n, v in per_round.items()}
  plain = cuda_ms(torch, lambda i=0: K.dedup_table_init_types_plain(*args),
                  3, warmup=1)
  graph = {n: graph_ms(torch, fn, calls=20)
           for n, fn in (('kernel', init), ('chain', chain))}
  host = host_us({'kernel': init, 'chain': chain})
  lanes = sum(i.numel() for i, _, _, _ in segs)
  n_ins = sum(int(m.sum()) for m in live)
  bound = bytes_ms(12 * slots + lanes + 4 * sum(int(h.sum()) for _, _, h, _
                                                in segs) + 12 * n_ins)
  print(f'dedup_table_init_types: {slots} slots, {len(segs)} seed types, '
        f'{lanes} seed lanes, {n_ins} inserted at bases '
        f'{[b for _, _, _, b in segs]}; one launch, equal to plain; '
        f'{t["kernel"]:.4f} ms back to back (the two-launch chain '
        f'{t["chain"]:.4f} ms, in turns, medians of {ROUNDS}), in a CUDA '
        f'graph {graph["kernel"]:.4f} ms (chain {graph["chain"]:.4f} ms; '
        f'{bound / graph["kernel"] * 100:.1f}% of the bound), host enqueue '
        f'{host["kernel"]:.2f} us a call (chain {host["chain"]:.2f} us); '
        f'plain {plain:.4f} ms, bound {bound:.6f} ms')
  verdict('dedup_table_init_types', t['kernel'], t['chain'],
          label='the init-then-insert chain',
          ratios=list(per_round['kernel'] / per_round['chain']))
  return dict(ms=t['kernel'], plain_ms=plain, err=int((a - b).abs().max()),
              bound_ms=bound, graph_ms=graph['kernel'], host_us=host['kernel'],
              chain_ms=t['chain'], chain_graph_ms=graph['chain'],
              chain_host_us=host['chain'], slots=slots, types=len(segs))


def time_walk(torch, K, g, seeds, fanouts, gen, host_us):
  """K1 over the graph ``g`` from ``seeds`` at ``fanouts``: one launch,
  equal to its plain version on every surface, its time back to back and
  in a CUDA graph, its host enqueue, plain time and byte bound; returns
  them as a kernel row."""
  from glt_tpu_torch.ops.pipeline import _fused_seed_hop, sample_budget
  from glt_tpu_torch.ops.sample import walk_geometry, walk_hop_uniforms
  b = seeds.numel()
  d, _ = _fused_seed_hop(seeds.to(torch.int32), b)
  u = walk_hop_uniforms(gen, b, fanouts, False, seeds.device)
  args = (g.indptr_pad, g.indices, d['ids3'], d['new_head3'],
          torch.where(d['new_head3'], d['ids3'],
                      torch.full_like(d['ids3'], -1)),
          d['labels3'], d['count2'], u)
  kw = dict(fanouts=fanouts, replace=False,
            table_slots=K.walk_table_slots(sample_budget(b, fanouts)))
  before = K.sample_walk_dedup.launches, K.dedup_table_insert.launches
  got = K.sample_walk_dedup(*args, **kw)
  if (K.sample_walk_dedup.launches - before[0],
      K.dedup_table_insert.launches - before[1]) != (1, 0):
    raise AssertionError('the walk is not one launch of its own')
  want = K.sample_walk_dedup_plain(*args, **kw)
  err = 0
  for h, (x, y) in enumerate(zip(got, want)):
    for key in ('picks', 'mask', 'labels', 'new_head', 'new_count'):
      if not torch.equal(x[key], y[key]):
        raise AssertionError(f'walk B={b} {list(fanouts)} hop {h} {key} '
                             'differs')
      err = max(err, int((x[key].long() - y[key].long()).abs().max()))
  ms = cuda_ms(torch, lambda i=0: K.sample_walk_dedup(*args, **kw), 10)
  plain = cuda_ms(torch, lambda i=0: K.sample_walk_dedup_plain(
      *args, **kw), 3, warmup=1)
  walk = lambda: K.sample_walk_dedup(*args, **kw)
  dev_ms = graph_ms(torch, walk, calls=20)
  host = host_us({'kernel': walk})['kernel']
  # bytes the walk must move: uniforms and frontier in, two indptr
  # entries per live row, one index per valid pick, and per slot the
  # outputs (pick, label: 4 B; mask, head: 1 B)
  nbytes = 12 * b
  frontier_ok = d['new_head3']
  for (s, k), uh, hop in zip(walk_geometry(b, fanouts), u, got):
    nbytes += uh.numel() * 4 + s * 4 + int(frontier_ok.sum()) * 8
    nbytes += int(hop['mask'].sum()) * 4 + s * k * 10
    frontier_ok = hop['new_head']
  row = dict(ms=ms, plain_ms=plain, err=err, bound_ms=bytes_ms(nbytes),
             graph_ms=dev_ms, host_us=host,
             nodes=int(sum(int(h['new_count']) for h in got)
                       + int(d['count2'])))
  print(f'sample_walk_dedup B={b} {list(fanouts)}: one launch, equal to '
        f'plain on every surface; {ms:.4f} ms back to back, in a CUDA '
        f'graph {dev_ms:.4f} ms, host enqueue {host:.2f} us a call (plain '
        f'{plain:.4f} ms, bound {row["bound_ms"]:.6f} ms, {row["nodes"]} '
        'distinct nodes)')
  return row


def hub_graph(torch, dev, seed):
  """HUB_NODES nodes of out-degree 0-50 and HUB_COUNT hubs of degree
  HUB_DEGREE that receive half of all edges, drawn on the card; returns
  the graph and the hub ids."""
  from glt_tpu_torch.data import Dataset
  gen = torch.Generator(device=dev).manual_seed(seed)
  deg = torch.randint(0, 51, (HUB_NODES,), generator=gen, device=dev)
  hubs = torch.randperm(HUB_NODES, generator=gen, device=dev)[:HUB_COUNT]
  deg[hubs] = torch.randint(HUB_DEGREE[0], HUB_DEGREE[1] + 1, (HUB_COUNT,),
                            generator=gen, device=dev)
  src = torch.repeat_interleave(torch.arange(HUB_NODES, device=dev), deg)
  e = src.numel()
  to_hub = hubs[torch.randint(0, HUB_COUNT, (e,), generator=gen, device=dev)]
  dst = torch.where(torch.rand(e, generator=gen, device=dev) < 0.5, to_hub,
                    torch.randint(0, HUB_NODES, (e,), generator=gen,
                                  device=dev))
  ds = Dataset().init_graph(torch.stack([src, dst]), num_nodes=HUB_NODES)
  return ds.get_graph(), hubs


def repair_checks(torch, np, K, ds, dev, seed, host_us):
  """The walk at fanouts above 64 and K3 on narrow rows, each equal to
  its plain version (K3 to index_select too) and timed; the float32
  products table takes K3's copy mode. Returns the printed rows for the
  summary."""
  g, hubs = hub_graph(torch, dev, seed + 8)
  gen = torch.Generator(device=dev).manual_seed(seed + 9)
  print(f'hub graph: {g.num_nodes} nodes, {g.num_edges} edges, max degree '
        f'{g.topo.max_degree}, {HUB_COUNT} hubs of degree {HUB_DEGREE}')
  seeds = torch.cat([hubs[:128], torch.randint(0, HUB_NODES, (128,),
                                               generator=gen, device=dev)])
  out = {}
  for fanouts in WIDE_FANOUTS:
    out[f'walk {list(fanouts)}'] = time_walk(torch, K, g, seeds, fanouts,
                                             gen, host_us)
  table = ds.get_node_feature().table
  lay = K.gather_rows_layout(FEAT_DIM * 4, table.data_ptr())
  if lay.realign:
    raise AssertionError(f'the float32 width-{FEAT_DIM} table does not '
                         'take the copy mode')
  n_rows = 234_496     # bucket 256's node count (kernel checks)
  rows = torch.randint(-2, NUM_NODES + 2, (n_rows,), generator=gen,
                       device=dev, dtype=torch.int32)
  for dtype, width in NARROW_ROWS:
    dt = getattr(torch, dtype)
    narrow = torch.randint(0, 256, (NUM_NODES, width), generator=gen,
                           device=dev, dtype=torch.uint8)
    if dt != torch.uint8:
      narrow = torch.randn((NUM_NODES, width), generator=gen, device=dev
                           ).to(dt)
    out[f'gather_rows {dtype} x {width}'] = time_gather(
        torch, np, K, f'{dtype} x {width}', narrow, rows)
    del narrow
  return out


def guard_cost(torch, np, K):
  """The device guard's host cost (csrc/entry.cuh), in turns over ROUNDS
  rounds of HOST_CALLS calls, medians: K3's entry point (a 256-row
  gather) enqueued with its tensors on card 0, the current card (the
  guard reads the current card and compares), and, with a second card,
  on card 1 while card 0 stays current (the guard switches there and
  back); and the wrappers' per-call lookup of card and stream
  (``_where``) against the stream lookup alone, which it replaced.
  Returns the medians in us a call."""
  torch.cuda.set_device(0)
  cards = [torch.device('cuda', i)
           for i in range(min(2, torch.cuda.device_count()))]
  calls, keep = {}, []
  for d in cards:
    gen = torch.Generator(device=d).manual_seed(5)
    table = torch.randn((1000, 100), generator=gen, device=d)
    rows = torch.randint(0, 1000, (256,), generator=gen, device=d,
                         dtype=torch.int32)
    out = torch.empty((256, 100), device=d)
    keep.append((table, rows, out))
    lay = K.gather_rows_layout(400, table.data_ptr())
    args = (table.data_ptr(), rows.data_ptr(), out.data_ptr(), 1000, 400,
            256, lay.lanes, int(lay.realign), lay.passes, *K._where(d))
    calls[f'entry on card {d.index}'] = (
        lambda a=args: K._check(K.glt_gather_rows(*a), 'gather_rows'))
  d0 = cards[0]
  calls['_where'] = lambda: K._where(d0)
  calls['stream lookup'] = lambda: K._raw_stream(d0.index)
  times = {n: [] for n in calls}
  for _ in range(ROUNDS):
    for n, fn in calls.items():
      fn()
      for d in cards:
        torch.cuda.synchronize(d)
      t0 = time.perf_counter()
      for _ in range(HOST_CALLS):
        fn()
      times[n].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
      for d in cards:
        torch.cuda.synchronize(d)
  for (table, rows, out) in keep:
    if not torch.equal(out, table[rows.long()]):
      raise AssertionError(f'gather_rows on {table.device} differs')
  if torch.cuda.current_device() != 0:
    raise AssertionError('the guard left card '
                         f'{torch.cuda.current_device()} current')
  med = {n: float(np.median(v)) for n, v in times.items()}
  above = lambda a, b: float(np.median(np.subtract(times[a], times[b])))
  switch = 'not measured: one card'
  if len(cards) > 1:
    switch = (f'{med["entry on card 1"]:.3f} us (switch and back; per round '
              f'median {above("entry on card 1", "entry on card 0"):.3f} us '
              'above card 0)')
  print(f'device guard: K3 entry on the current card '
        f'{med["entry on card 0"]:.3f} us a call; on card 1 from card 0 '
        f'{switch}; _where {med["_where"]:.3f} us vs stream lookup '
        f'{med["stream lookup"]:.3f} us (per round median '
        f'{above("_where", "stream lookup"):.3f} us more)')
  return med


def probe_checks(torch, np, P, dev, seed, rows, host_us):
  """Each kernel of the probe ladder and the microbench held bit-equal to
  its plain version at the TPU rungs' shapes (vmem_take also at the
  microbench's [200, 3840]) and timed beside its library call, where one
  PyTorch call computes the same function, its byte bound and its host
  enqueue time."""
  from glt_tpu_torch.benchmarks import probe_compile
  t = {k: torch.as_tensor(v, device=dev)
       for k, v in probe_compile.draw_inputs(seed).items()}
  gen = torch.Generator(device=dev).manual_seed(seed + 10)
  big_idx = torch.randint(0, 8192, (200, 3840), generator=gen, device=dev,
                          dtype=torch.int32)
  x, s, big, st = t['x'], t['s'], t['big'], t['st']
  idx_long = (t['idx'].long(), big_idx.long())   # torch.take's index type
  # name: (wrapper, arguments, library call or None, bytes moved)
  cases = {
      'vmem_id': ('vmem_id', (x,), lambda: x.clone(), 2 * x.numel() * 4),
      'smem_scalar': ('smem_scalar', (x, s), lambda: torch.mul(x, s),
                      2 * x.numel() * 4 + 4),
      'dma_fixed': ('dma_fixed', (big, 256, 128),
                    lambda: big[256:384].clone(), 2 * 128 * 4),
      'dma_dynamic': ('dma_dynamic', (big, st, 128), None, 2 * 128 * 4 + 4),
      'prefetch_grid': ('prefetch_grid', (t['tab'], t['rows']),
                        lambda: torch.index_select(t['tab'], 0, t['rows']),
                        2 * t['rows'].numel() * 512 + 4 * 16),
      'vt': ('vt', (t['tab2d'], t['idx']),
             lambda: torch.take(t['tab2d'], idx_long[0]),
             8 * t['idx'].numel() + 4 * t['tab2d'].numel()),
      'vmem_take': ('vmem_take', (t['tab2d'], big_idx),
                    lambda: torch.take(t['tab2d'], idx_long[1]),
                    8 * big_idx.numel() + 4 * t['tab2d'].numel()),
  }
  for name, (fn, args, lib, nbytes) in cases.items():
    kernel, plain = getattr(P, fn), getattr(P, fn + '_plain')
    got, want = kernel(*args), plain(*args)
    if not torch.equal(got, want):
      raise AssertionError(f'{name} differs from its plain version')
    if lib is not None and not torch.equal(got, lib()):
      raise AssertionError(f'{name} differs from its library call')
    ms = cuda_ms(torch, lambda i=0: kernel(*args), 200)
    plain_ms = cuda_ms(torch, lambda i=0: plain(*args), 200)
    lib_ms = cuda_ms(torch, lambda i=0: lib(), 200) if lib else None
    fns = {'kernel': lambda: kernel(*args)}
    if lib:
      fns['library'] = lib
    host = host_us(fns)
    dev_ms = {n: graph_ms(torch, f) for n, f in fns.items()}
    bound = bytes_ms(nbytes)
    rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                      bound_ms=bound, err=float(
                          (got.double() - want.double()).abs().max()),
                      host_us=host['kernel'], graph_ms=dev_ms['kernel'],
                      library_graph_ms=dev_ms.get('library'))
    shapes = [tuple(a.shape) if hasattr(a, 'shape') else a for a in args]
    print(f'{name} {shapes}: equal to plain'
          f'{" and its library call" if lib else ""}; {ms:.4f} ms a launch '
          f'back to back (plain {plain_ms:.4f}, library '
          f'{"none" if lib is None else f"{lib_ms:.4f}"}, bound {bound:.3e} '
          f'ms); in a CUDA graph {dev_ms["kernel"]:.4f} ms'
          + (f' (library {dev_ms["library"]:.4f})' if lib else '')
          + f'; host enqueue {host["kernel"]:.2f} us a call'
          + (f' (library {host["library"]:.2f} us)' if lib else ''))


def igbh_edges(torch, counts, gen, dev):
  """IGBH-shaped relations (the synthetic recipe of
  examples/igbh/compress_graph.py, drawn on the card): paper-cites-paper
  (10 per paper), author-writes-paper (3 per paper),
  author-affiliated-institute (1 per author), each endpoint uniform; then
  a rev_ relation for each whose two types differ, as
  examples/igbh/dist_train_rgnn.py adds them."""
  p, a, i = counts['paper'], counts['author'], counts['institute']
  draw = lambda n, hi: torch.randint(0, hi, (n,), generator=gen, device=dev)
  edges = {('paper', 'cites', 'paper'): (draw(10 * p, p), draw(10 * p, p)),
           ('author', 'writes', 'paper'): (draw(3 * p, a), draw(3 * p, p)),
           ('author', 'affiliated', 'institute'): (draw(a, a), draw(a, i))}
  edges = {e: torch.stack(v) for e, v in edges.items()}
  for (s, r, d), ei in list(edges.items()):
    if s != d:
      edges[(d, f'rev_{r}', s)] = ei.flip(0)
  return edges


def profile_stages(torch, run, n, stages, unit, host_stages=()):
  """Device time by stage and by kernel over ``run()``, which does ``n``
  units of work, from torch.profiler's CUDA trace; prints one line per
  stage and the top kernels, and returns (wall ms, device busy ms) per
  unit. ``host_stages``: stages whose ranges start and end in a device
  sync, so their kernels are those that ran inside the host range,
  whichever thread launched them (autograd's backward runs on its
  own)."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
  # kernels are the CUDA events other than the stages' own GPU-side
  # range markers; a stage's kernel time is that of the kernels inside
  # its marker's extent on the device timeline (the kernels of csrc/ carry
  # no aten op to attribute them to), or, for a host stage, inside its host
  # range
  cuda = torch.autograd.DeviceType.CUDA
  events = prof.events()
  kern = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in events
                if e.device_type == cuda and e.name not in stages)
  busy, end = 0.0, float('-inf')
  for t0_, t1_, _ in kern:   # union of kernel intervals, us
    busy += max(0.0, t1_ - max(t0_, end))
    end = max(end, t1_)
  print(f'profile: {wall:.3f} ms wall per {unit}, device busy '
        f'{busy / 1e3 / n:.3f} ms ({busy / 1e3 / n / wall * 100:.1f}%)')
  for st in stages:
    cpu = [e for e in events if e.name == st and e.device_type != cuda]
    gpu = [e.time_range for e in events
           if e.name == st and e.device_type == cuda]
    synced = st in host_stages
    extent = [e.time_range for e in cpu] if synced else gpu
    dev_us = sum(t1_ - t0_ for t0_, t1_, _ in kern
                 if any(r.start <= t0_ and t1_ <= r.end for r in extent))
    span_us = sum(r.elapsed_us() for r in gpu)
    host_us = sum(e.time_range.elapsed_us() for e in cpu)
    span = '' if synced else f'device span {span_us / 1e3 / n:.4f} ms, '
    print(f'  stage {st}: kernels {dev_us / 1e3 / n:.4f} ms, {span}host '
          f'{host_us / 1e3 / n:.4f} ms per {unit}')
  by_name = {}
  for t0_, t1_, name in kern:
    tot, cnt = by_name.get(name, (0.0, 0))
    by_name[name] = (tot + t1_ - t0_, cnt + 1)
  for name, (tot, cnt) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][0])[:12]:
    print(f'  kernel {name[:80]}: {tot / 1e3 / n:.4f} ms, '
          f'{cnt / n:g} per {unit}')
  return wall, busy / 1e3 / n


def profile_requests(torch, engine, reqs):
  """profile_stages over serving requests."""
  def run():
    for ids in reqs:
      engine.infer(ids)
  profile_stages(torch, run, len(reqs),
                 ('sample.multihop', 'gather.features', 'serve.forward'),
                 'request')


@contextlib.contextmanager
def swapped_to_plain(K, names):
  """The kernel wrappers ``names`` of ``K`` replaced by their plain
  versions inside the block, restored on exit."""
  kernels = {n: getattr(K, n) for n in names}
  try:
    for n in kernels:
      setattr(K, n, getattr(K, n + '_plain'))
    yield
  finally:
    for n, fn in kernels.items():
      setattr(K, n, fn)


def plain_swapped(K, engine, names, seeds, n_valid, u):
  """One bucket-256 batch and its logits with the wrappers ``names`` of
  the kernel module ``K`` swapped for their plain versions (same seeds
  and uniforms)."""
  with swapped_to_plain(K, names):
    batch = engine.make_batch(seeds, n_valid, 256, uniforms=u)
    return batch, engine.model(batch)


def serve_requests(torch, engine, num_nodes, classes, rng, check=None,
                   passes=2, label='pass'):
  """``passes`` passes of fresh requests of REQUESTS ids, each pass ending
  with a repeat of its 64-id request that the cache must serve; host
  clock around infer, which ends in a device sync. ``check(n_fresh)`` runs
  after every request. Returns the last pass's requests."""
  for rep in range(passes):
    requests = [torch.randint(0, num_nodes, (n,), generator=rng).numpy()
                for n in REQUESTS]
    hits0, lat = engine.cache.hits, []
    for ids in requests + [requests[2]]:
      calls0 = engine.forward_calls
      t0 = time.perf_counter()
      logits = engine.infer(ids)
      lat.append((time.perf_counter() - t0) * 1e3)
      if logits.shape != (ids.size, classes):
        raise AssertionError(f'logits shape {logits.shape}')
      if not torch.isfinite(torch.as_tensor(logits)).all():
        raise AssertionError('non-finite logits')
      if check is not None:
        check(engine.forward_calls - calls0)
    if engine.cache.hits - hits0 < REQUESTS[2]:
      raise AssertionError('the repeated request missed the cache')
    print(f'{label} {rep} request ms ' + ', '.join(
        f'{n}: {ms:.3f}' for n, ms in zip(REQUESTS + ('repeat 64',), lat)))
  return requests


def per_request_launches(K, per_request):
  """A ``check`` for serve_requests: every computed bucket launched each
  kernel ``name`` of ``per_request`` (name -> launches) that many times."""
  last = {n: getattr(K, n).launches for n in per_request}

  def check(n_computed):
    for name, want in per_request.items():
      n = getattr(K, name).launches
      if n - last[name] != want * n_computed:
        raise AssertionError(f'{n - last[name]} {name} launches for '
                             f'{n_computed} computed buckets')
      last[name] = n
  return check


def stream_phases(torch, np, K, ds, dev, seed, rows):
  """The live-update serving path over the homogeneous path's graph and
  features; returns its launches by kernel."""
  from glt_tpu_torch.data import Dataset
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.ops.pipeline import sample_budget
  from glt_tpu_torch.serving import InferenceEngine
  from glt_tpu_torch.stream import (CompactionPolicy, SnapshotManager,
                                    StreamIngestor, StreamSampler)

  with Phase('stream data'):
    g, feat = ds.get_graph(), ds.get_node_feature()
    mgr = SnapshotManager(g.topo, feat, delta_capacity=DELTA_CAPACITY,
                          device=dev)
    sampler = StreamSampler(mgr, list(FANOUTS), delta_window=DELTA_WINDOW,
                            seed=seed)
    # its own Dataset object: update_snapshot installs new feature tables
    # there, the homogeneous engine's stays as it was
    engine = InferenceEngine(
        Dataset(graph=g, node_features=feat),
        GraphSAGE(FEAT_DIM, HIDDEN, CLASSES, num_layers=3), None,
        list(FANOUTS), buckets=BUCKETS, device=dev, sampler=sampler)
    engine.init_params(seed)
    ingestor = StreamIngestor(mgr, sampler=sampler, engine=engine,
                              policy=CompactionPolicy(
                                  occupancy_threshold=OCCUPANCY),
                              expand_invalidation=True)
    torch.cuda.synchronize()
    print(f'stream: snapshot v{mgr.current().version}, {g.num_edges} edges '
          f'in {mgr.edge_capacity} slots; effective widths '
          f'{sampler.num_neighbors}; bucket-256 node budget '
          f'{sample_budget(256, sampler.num_neighbors)}')

  with Phase('stream kernel checks'):
    # the three base hops of one bucket-256 request and its overlay window
    # reads (tombstones and inserts, gather_windows), their inputs
    # recorded as delta_one_hop hands them over (the recording run reads
    # through the plain versions)
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    seeds = torch.randint(0, NUM_NODES, (256,), generator=gen, device=dev)
    hops, windows = [], []
    real, real_windows = K.sample_hop, K.gather_windows

    def record(*a):
      hops.append(a)
      return K.sample_hop_plain(*a)

    def record_windows(*a):
      windows.append(a)
      return K.gather_windows_plain(*a)
    dedups = []
    K.sample_hop, K.gather_windows = record, record_windows
    try:
      with recorded_dedups(torch, dedups):
        sampler.sample_from_nodes(seeds)
    finally:
      K.sample_hop, K.gather_windows = real, real_windows
    for arr, starts, width in windows:
      if not torch.equal(real_windows(arr, starts, width),
                         K.gather_windows_plain(arr, starts, width)):
        raise AssertionError(f'gather_windows [{starts.numel()}, {width}] '
                             'over the overlay differs from plain')
    print(f'gather_windows over the overlay: {len(windows)} reads '
          f'{[(int(a[1].numel()), a[2]) for a in windows]} equal to plain')
    want_shapes, s = [], 256
    for f, width in zip(FANOUTS, sampler.num_neighbors):
      want_shapes.append((s, f))
      s *= width
    if [tuple(a[3].shape) for a in hops] != want_shapes:
      raise AssertionError(f'hop shapes {[tuple(a[3].shape) for a in hops]}'
                           f', expected {want_shapes}')
    dev_index = dev.index or 0
    q = in_turns_host_us(torch, np, {
        'current_stream': lambda: torch.cuda.current_stream(dev).cuda_stream,
        'raw': lambda: torch._C._cuda_getCurrentRawStream(dev_index)},
        calls=10_000)
    print(f'current stream handle, host us a call: '
          f'torch.cuda.current_stream(dev).cuda_stream '
          f'{q["current_stream"]:.3f}, torch._C._cuda_getCurrentRawStream '
          f'{q["raw"]:.3f}')
    rows['sample_hop'] = time_picks(torch, np, K, 'bucket-256 request',
                                    hops)
    time_dedup(torch, np, 'bucket-256 request', dedups)
    # the recorded hops hold v0's padded array: let the swap free it
    del hops, windows, dedups

  with Phase('stream main path'):
    # per computed bucket: a base hop (sample_hop) and a tombstone and an
    # insert window read (gather_windows) per hop
    per_request = {'sample_hop': len(FANOUTS),
                   'gather_windows': 2 * len(FANOUTS)}
    engine.warmup()
    rng = torch.Generator().manual_seed(seed + 5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    served = serve_requests(torch, engine, NUM_NODES, CLASSES, rng,
                            check=per_request_launches(K, per_request),
                            label='stream v0 pass')
    # stage: inserts (the first from served seeds), deletes of base edges,
    # new feature rows of served (cached) nodes
    topo = mgr.current().topo
    ins_src = np.concatenate([served[4][:64], torch.randint(
        0, NUM_NODES, (N_INSERTS - 64,), generator=rng).numpy()])
    ins_dst = torch.randint(0, NUM_NODES, (N_INSERTS,), generator=rng).numpy()
    slots = torch.randint(0, topo.num_edges, (N_DELETES,), generator=rng)
    slots = slots.to(dev)
    del_src = torch.searchsorted(topo.indptr, slots, right=True) - 1
    del_dst = topo.indices[slots].long()
    upd = np.unique(np.concatenate(served))[:N_FEATURE_ROWS]
    before = engine.infer(upd)
    t0 = time.perf_counter()
    ingestor.insert_edges(ins_src, ins_dst)
    ingestor.delete_edges(del_src, del_dst)
    ingestor.update_features(upd, torch.randn((upd.size, FEAT_DIM),
                                              generator=rng).numpy())
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    if mgr.current().version != 0:
      raise AssertionError('staging below the occupancy threshold compacted')
    print(f'staged {N_INSERTS} inserts, {N_DELETES} deletes, {upd.size} '
          f'feature rows in {stage_ms:.3f} ms (two overlay refreshes); '
          f'edge delta {ingestor.edges.size}/{DELTA_CAPACITY}, feature '
          f'delta {ingestor.features.size}/{DELTA_CAPACITY}')
    # the overlay is live before compaction: a batch seeded on the
    # inserts' sources holds every pending insert of its seed rows (the
    # insert window is exhaustive below 8 per row) and no tombstoned edge
    pend = ingestor.edges.view()
    key = lambda a, b: torch.as_tensor(a, device=dev).long() * NUM_NODES \
        + torch.as_tensor(b, device=dev).long()
    out = sampler.sample_from_nodes(ins_src[:256])
    node = out.node.long()
    m = out.edge_mask
    pairs = node[out.col.long()[m]] * NUM_NODES + node[out.row.long()[m]]
    ins_keys = key(pend.ins_src, pend.ins_dst)
    src_t = torch.as_tensor(pend.ins_src, device=dev)
    per_row = torch.bincount(src_t, minlength=NUM_NODES)
    mine = torch.isin(src_t, torch.as_tensor(ins_src[:256], device=dev)) \
        & (per_row[src_t] <= DELTA_WINDOW)
    if not bool(torch.isin(ins_keys[mine], pairs).all()):
      raise AssertionError('an inserted edge of a seed row is missing')
    del_keys = key(pend.del_src, pend.del_dst)
    dead = del_keys[~torch.isin(del_keys, ins_keys)]
    if bool(torch.isin(dead, pairs).any()):
      raise AssertionError('a tombstoned edge was sampled')
    print(f'overlay: {int(mine.sum())} inserted edges of the batch\'s seed '
          f'rows all sampled, none of {dead.numel()} tombstoned edges')
    serve_requests(torch, engine, NUM_NODES, CLASSES, rng,
                   check=per_request_launches(K, per_request), passes=1,
                   label='stream overlay pass')
    src, dst, _ = topo.to_coo()
    e0 = topo.num_edges
    kept = e0 - int(torch.isin(src * NUM_NODES + dst, del_keys).sum())
    # v0's Topology views v0's padded array: hold neither past the swap
    del src, dst, topo
    torch.cuda.synchronize()
    swap0 = torch.cuda.max_memory_allocated()
    resident0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    info = ingestor.flush()
    torch.cuda.synchronize()
    flush_ms = (time.perf_counter() - t0) * 1e3
    swap_peak = torch.cuda.max_memory_allocated()
    resident1 = torch.cuda.memory_allocated()
    if info is None or info['version'] != 1 or engine.snapshot_version != 1:
      raise AssertionError(f'flush did not swap to version 1: {info}')
    if info['invalidated'] <= 0:
      raise AssertionError('flush dropped no cache entry')
    if info['num_edges'] != kept + pend.ins_src.size:
      raise AssertionError(f'compacted {info["num_edges"]} edges, expected '
                           f'{kept + pend.ins_src.size}')
    affected = mgr.current().expand_affected(info['touched'])
    if affected.size <= info['touched'].size:
      raise AssertionError('the in-neighbour expansion added no node')
    after = engine.infer(upd)
    same = np.isclose(before, after).all(axis=1)
    if same.any():
      raise AssertionError(f'{int(same.sum())} updated nodes kept their '
                           'answers')
    print(f'flush: snapshot v{info["version"]}, {info["num_edges"]} edges '
          f'({e0} - {e0 - kept} deleted + '
          f'{pend.ins_src.size} inserted), {info["touched"].size} touched '
          f'ids, {affected.size} with their in-neighbours, '
          f'{info["invalidated"]} cache entries dropped, capacity grown '
          f'{info["capacity_grown"]}; compaction {info["compaction_s"] * 1e3:.3f}'
          f' ms, flush {flush_ms:.3f} ms (overlay refresh, in-edge CSR build '
          f'and cache sweep {flush_ms - info["compaction_s"] * 1e3:.3f} ms); '
          f'memory resident '
          f'{resident0 / 2**30:.3f} GiB before, peak {swap_peak / 2**30:.3f} '
          f'GiB during the swap (+{(swap_peak - resident0) / 2**30:.3f}), '
          f'resident {resident1 / 2**30:.3f} GiB after; serving peak '
          f'{swap0 / 2**30:.3f} GiB before it; all {upd.size} updated nodes '
          'answer anew')
    served = serve_requests(torch, engine, NUM_NODES, CLASSES, rng,
                            check=per_request_launches(K, per_request),
                            passes=1, label='stream v1 pass')
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    peak = max(torch.cuda.max_memory_allocated(), swap0, swap_peak)
    for name in ('sample_hop', 'gather_windows', 'gather_rows'):
      if launches[name] == 0:
        raise AssertionError(f'{name} never launched on the stream path')
    print(f'launches {launches}; cache hits {engine.cache.hits}; peak '
          f'memory {peak / 2**30:.3f} GiB')

  with Phase('stream main path vs plain'):
    ids = served[3]
    seeds = np.concatenate([ids, np.full(256 - ids.size, ids[0])])
    u = sampler.hop_uniforms(256)
    with torch.no_grad():
      bk = engine.make_batch(seeds, ids.size, 256, uniforms=u)
      yk = engine.model(bk)
      bp, yp = plain_swapped(K, engine, ('sample_hop', 'gather_windows',
                                         'gather_rows'), seeds, ids.size, u)
    for f in ('node', 'node_count', 'row', 'col', 'edge_mask', 'x'):
      if not torch.equal(getattr(bk, f), getattr(bp, f)):
        raise AssertionError(f'stream batch.{f} differs between kernels and '
                             'plain')
    diff = float((yk - yp).abs().max())
    if not torch.allclose(yk, yp, rtol=LOGIT_TOL, atol=LOGIT_TOL):
      raise AssertionError(f'stream logits differ from plain by {diff}')
    print(f'stream bucket 256 (snapshot v{mgr.current().version}): batch '
          f'bit-identical ({int(bk.node_count)} nodes, '
          f'{int(bk.edge_mask.sum())} edges), logits max |diff| {diff:.3e} '
          f'(tolerance {LOGIT_TOL})')
    del bk, bp, yk, yp

  with Phase('stream profile'):
    profile_requests(torch, engine, [
        torch.randint(0, NUM_NODES, (256,), generator=rng).numpy()
        for _ in range(3)])
  return launches


def train_phases(torch, np, K, ds, dev, seed, rows, smi):
  """The training path over the homogeneous graph and features (with the
  edge weights drawn in the data phase); returns its launches by kernel,
  weighted and uniform. ``smi`` names the card and its power limit."""
  from glt_tpu_torch.loader import NeighborLoader
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.parallel import SageTrainStep, sage_loss
  from glt_tpu_torch.sampler import NeighborSampler
  from glt_tpu_torch.typing import Split
  from glt_tpu_torch.utils.profile import ThroughputMeter

  g = ds.get_graph()
  with Phase('train data'):
    # learnable labels as examples/common.py builds them, its 0.1/0.1 split
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    w = torch.randn((FEAT_DIM, CLASSES), generator=gen, device=dev)
    ds.init_node_labels(torch.argmax(ds.get_node_feature().table @ w, 1)
                        .to(torch.int32))
    ds.random_node_split(num_val=0.1, num_test=0.1, seed=seed)
    train_idx = ds.get_split(Split.train)

    def loader(with_weight):
      return NeighborLoader(ds, list(FANOUTS), train_idx,
                            batch_size=TRAIN_BATCH, shuffle=True,
                            with_weight=with_weight, device=dev, seed=seed,
                            rng=np.random.default_rng(seed))

    def model():
      torch.manual_seed(seed)
      return GraphSAGE(FEAT_DIM, HIDDEN, CLASSES, num_layers=3).to(dev)
    wl = loader(True)
    sampler = wl.sampler
    windows = [sampler._weight_window(f) for f in FANOUTS]
    print(f'train: {train_idx.size} training seeds, {CLASSES} classes; edge '
          f'weights {tuple(g.edge_weights.shape)} float32 in '
          f'[{float(g.edge_weights.min()):.3g}, '
          f'{float(g.edge_weights.max()):.3g}]; weight windows {windows}')

  with Phase('train kernel checks'):
    # the three weighted hops of one batch, their inputs recorded as the
    # sampler hands them over (the recording run reads through the plain
    # version); each window read once over the weights and once over the
    # neighbour ids at the same starts
    seeds = train_idx[:TRAIN_BATCH]
    calls, picks, real, real_picks = [], [], K.gather_windows, K.sample_hop

    def record(*a):
      calls.append(a)
      return K.gather_windows_plain(*a)

    def record_picks(*a):
      picks.append(a)
      return K.sample_hop_plain(*a)
    dedups = []
    K.gather_windows, K.sample_hop = record, record_picks
    try:
      with recorded_dedups(torch, dedups):
        sampler.sample_from_nodes(seeds)
    finally:
      K.gather_windows, K.sample_hop = real, real_picks
    shapes = [(int(a[1].numel()), a[2]) for a in calls]
    want_shapes, s_ = [], TRAIN_BATCH
    for f, d in zip(FANOUTS, windows):
      want_shapes.append((s_, d))
      s_ *= f
    if shapes != want_shapes:
      raise AssertionError(f'window shapes {shapes}, expected {want_shapes}')
    row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    hop_ms, bound_hop = [], []
    rounds = {'kernel': 0.0, 'take': 0.0}
    for h, (arr, starts, width) in enumerate(calls):
      for name, src in (('weights', arr), ('indices', g.indices)):
        got = real(src, starts, width)
        want = K.gather_windows_plain(src, starts, width)
        if not torch.equal(got, want):
          raise AssertionError(f'gather_windows hop {h + 1} {name} differs '
                               'from plain')
        err = float((got.double() - want.double()).abs().max())
        slots = (starts.long()[:, None] + torch.arange(width, device=dev)
                 ).clamp(0, src.numel() - 1)
        fns = {'kernel': lambda: real(src, starts, width),
               'take': lambda: torch.take(src, slots)}
        per_round = in_turns_ms(torch, np, fns)
        t = {n: float(np.median(v)) for n, v in per_round.items()}
        host = in_turns_host_us(torch, np, fns)
        plain = cuda_ms(torch, lambda i=0: K.gather_windows_plain(
            src, starts, width), 20)
        # bytes the read must move: a start per row, per lane one element
        # in and one out
        s_ = starts.numel()
        bound = bytes_ms(4 * s_ + 8 * s_ * width)
        if name == 'weights':
          hop_ms.append(t['kernel'])
          bound_hop.append(bound)
          for n in rounds:
            rounds[n] = rounds[n] + per_round[n]
          for key, v in (('ms', t['kernel']), ('plain_ms', plain),
                         ('library_ms', t['take']), ('bound_ms', bound)):
            row[key] += v
          row['err'] = max(row['err'], err)
        print(f'gather_windows hop {h + 1} [{s_}, {width}] {name} '
              f'{str(src.dtype)[6:]}: equal to plain; {t["kernel"]:.4f} ms '
              f'(torch.take {t["take"]:.4f} ms, in turns, medians of '
              f'{ROUNDS}; plain {plain:.4f} ms; bound {bound:.6f} ms, '
              f'{bound / t["kernel"] * 100:.1f}% of it); host enqueue '
              f'{host["kernel"]:.2f} us a call (torch.take '
              f'{host["take"]:.2f} us)')
    rows['gather_windows'] = row
    print(f'gather_windows per weighted batch ({len(calls)} hops, the weight '
          f'windows): {row["ms"]:.4f} ms (plain {row["plain_ms"]:.4f} ms, '
          f'torch.take {row["library_ms"]:.4f} ms, bound '
          f'{row["bound_ms"]:.6f} ms)')
    verdict('gather_windows summed over a weighted batch\'s weight windows',
            row['ms'], row['library_ms'],
            ratios=list(rounds['kernel'] / rounds['take']))
    verdict('gather_windows hop 3 (weights) against half its byte bound',
            hop_ms[-1], 2 * bound_hop[-1], label='twice the bound')
    # B2 at the weighted step's three hops, as the sampler hands them over
    time_picks(torch, np, K, 'weighted training step', picks)
    time_dedup(torch, np, 'weighted training step', dedups)
    del calls, picks, dedups, arr, starts, got, want, slots, fns, per_round

  with Phase('train main path vs plain'):
    # one batch through the kernels and through the plain versions, same
    # seeds and uniforms, and its loss on the initial weights
    net = model()
    u = sampler.hop_uniforms(TRAIN_BATCH)
    n_valid = TRAIN_BATCH - 1
    seeds = np.concatenate([train_idx[:n_valid], train_idx[:1]])

    def batch():
      return wl._collate(sampler.sample_from_nodes(seeds, n_valid,
                                                   uniforms=u),
                         seeds, n_valid)
    with torch.no_grad():
      bk = batch()
      lk = float(sage_loss(net, bk))
      with swapped_to_plain(K, ('gather_windows', 'sample_hop',
                                'gather_rows')):
        bp = batch()
        lp = float(sage_loss(net, bp))
    for f in ('node', 'node_count', 'row', 'col', 'edge_mask', 'x', 'y',
              'num_sampled_edges'):
      if not torch.equal(getattr(bk, f), getattr(bp, f)):
        raise AssertionError(f'train batch.{f} differs between kernels and '
                             'plain')
    if not abs(lk - lp) <= LOSS_TOL * max(1.0, abs(lp)):
      raise AssertionError(f'first-step loss {lk} vs plain {lp}')
    print(f'train batch {TRAIN_BATCH} ({n_valid} real seeds): bit-identical '
          f'({int(bk.node_count)} nodes, {int(bk.edge_mask.sum())} edges), '
          f'loss {lk:.6f} vs plain {lp:.6f} (|diff| {abs(lk - lp):.3e}, '
          f'tolerance {LOSS_TOL})')
    del bk, bp, net

  medians = []

  def train(label, data, steps, net):
    """``steps`` training steps; returns the losses, the seconds of the
    steps after the first two and their sampled edges."""
    step = SageTrainStep(net, lr=LR)
    losses, secs, edges = [], [], []
    it = iter(data)
    for i in range(steps):
      t0 = time.perf_counter()
      b = next(it)
      losses.append(step(b))
      n_edges = b.num_sampled_edges.sum()
      torch.cuda.synchronize()
      secs.append(time.perf_counter() - t0)
      edges.append(n_edges)
    losses = [float(v) for v in losses]
    medians.append(float(np.median(secs[2:])) * 1e3)
    if not all(np.isfinite(losses)):
      raise AssertionError(f'{label}: non-finite loss {losses}')
    tail = float(np.mean(losses[-5:]))
    if not tail < losses[0]:
      raise AssertionError(f'{label}: loss did not fall ({losses[0]} -> '
                           f'mean of the last 5 {tail})')
    meter = ThroughputMeter('edges')
    meter.update(int(sum(int(e) for e in edges[2:])), sum(secs[2:]))
    print(f'{label}: {steps} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}'
          f' (mean of the last 5 {tail:.4f}); steps 3-{steps}: '
          f'{(steps - 2) / sum(secs[2:]):.3f} steps/s, median '
          f'{np.median(secs[2:]) * 1e3:.3f} ms, {meter.report()} '
          f'({meter.rate:.1f} sampled edges/s); first two steps '
          f'{secs[0] * 1e3:.3f}, {secs[1] * 1e3:.3f} ms; on {smi}')
    return losses

  with Phase('train main path'):
    net = model()
    torch.cuda.synchronize()
    print(f'resident before training {torch.cuda.memory_allocated() / 2**30:.3f}'
          ' GiB')
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    train('weighted training', wl, TRAIN_STEPS, net)
    median_ms = medians[-1]
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    want = dict(gather_windows=3 * TRAIN_STEPS, sample_hop=3 * TRAIN_STEPS,
                gather_rows=TRAIN_STEPS, sample_walk_dedup=0)
    for name, n in want.items():
      if launches[name] != n:
        raise AssertionError(f'{name}: {launches[name]} launches on the '
                             f'weighted training path, expected {n}')
    print(f'launches {launches}; peak memory {peak / 2**30:.3f} GiB '
          f'({peak} bytes)')

  with Phase('train uniform path'):
    net = model()
    K.reset_launch_counts()
    train('uniform training', loader(False), UNIFORM_STEPS, net)
    uniform_launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    want = dict(sample_walk_dedup=UNIFORM_STEPS, dedup_table_insert=0,
                gather_rows=UNIFORM_STEPS)
    for name, n in want.items():
      if uniform_launches[name] != n:
        raise AssertionError(f'{name}: {uniform_launches[name]} launches '
                             f'on the uniform training path, expected {n}')
    if uniform_launches['gather_windows']:
      raise AssertionError('the uniform training path read windows')
    print(f'launches {uniform_launches}')

  with Phase('full-neighbour check'):
    full = NeighborSampler(g, [10, -1], device=dev, seed=seed)
    seeds = train_idx[:256]
    u = full.hop_uniforms(256)
    before = K.gather_windows.launches
    ok = full.sample_from_nodes(seeds, uniforms=u)
    if K.gather_windows.launches != before + 1:
      raise AssertionError('the -1 hop did not read through gather_windows')
    with swapped_to_plain(K, ('gather_windows', 'sample_hop')):
      op = full.sample_from_nodes(seeds, uniforms=u)
    for f in ('node', 'node_count', 'row', 'col', 'edge_mask',
              'num_sampled_nodes', 'num_sampled_edges'):
      if not torch.equal(getattr(ok, f), getattr(op, f)):
        raise AssertionError(f'[10, -1] {f} differs between kernels and '
                             'plain')
    print(f'[10, -1] at batch 256 (window {-full.num_neighbors[1]}): '
          f'bit-identical to plain, {int(ok.node_count)} nodes, '
          f'{int(ok.num_sampled_edges.sum())} edges')
    del full, ok, op

  with Phase('train profile'):
    # 3 weighted steps of the loader and SageTrainStep, the step's stages
    # synced (sync_stages) so that its kernels (the backward's, launched
    # by autograd's thread, too) are told apart by their host ranges; the
    # loader's stages by their device-side extents
    net = model()
    step = SageTrainStep(net, lr=LR, sync_stages=True)
    it = iter(wl)
    step(next(it))      # warm

    def run():
      for _ in range(3):
        step(next(it))
    step_stages = ('train.forward', 'train.backward', 'train.optimizer')
    wall, busy = profile_stages(
        torch, run, 3, ('sample.multihop', 'gather.features') + step_stages,
        'step', host_stages=step_stages)
    print(f'train profile: device busy {busy:.3f} ms a step is '
          f'{busy / median_ms * 100:.1f}% of the unsynchronised median step '
          f'({median_ms:.3f} ms, train main path)')
  return launches, uniform_launches


HETERO_BATCH_FIELDS = ('node_dict', 'node_count_dict', 'row_dict',
                       'col_dict', 'edge_mask_dict', 'x_dict', 'y_dict',
                       'num_sampled_edges')


def differing_field(torch, a, b, fields):
  """The first of ``fields`` (a tensor or a dict of them) that is not
  bit-identical between batches ``a`` and ``b``, else None."""
  for f in fields:
    x, y = getattr(a, f), getattr(b, f)
    if not isinstance(x, dict):
      x, y = {None: x}, {None: y}
    if set(x) != set(y) or any(not torch.equal(x[k], y[k]) for k in x):
      return f
  return None


def hetero_train_phases(torch, np, K, graphs, feats, ds, dev, seed, k3,
                        smi):
  """Training on the igbh-rgat graph (``graphs``, its float32 feature
  tables ``feats``, emptied here once cast to the bf16 store), then the
  CSC checks over it and over the products graph of ``ds``; returns the
  launches of the training path and of the CSC checks by kernel."""
  from glt_tpu_torch.data import Dataset, Graph
  from glt_tpu_torch.loader import NeighborLoader
  from glt_tpu_torch.models import RGNN
  from glt_tpu_torch.parallel import SageTrainStep, sage_loss
  from glt_tpu_torch.sampler.base import NodeSamplerInput
  from glt_tpu_torch.typing import reverse_edge_type
  from glt_tpu_torch.utils.profile import ThroughputMeter

  etypes = list(graphs)
  fanouts = {e: list(FANOUTS) for e in etypes}
  swapped = ('sample_hop_dedup', 'dedup_table_init', 'gather_rows')
  with Phase('hetero train data'):
    # the trainer's bf16 store; learnable labels argmax(x @ w) over the
    # papers' features as the model reads them
    tds = Dataset(graph=graphs).init_node_features(
        {t: f.table.to(torch.bfloat16) for t, f in feats.items()})
    feats.clear()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    w = torch.randn((IGBH_FEAT, IGBH_CLASSES), generator=gen, device=dev)
    paper = tds.get_node_feature('paper').table
    tds.init_node_labels({'paper': torch.argmax(paper.float() @ w, 1).to(
        torch.int32)})
    n_papers = IGBH_NODES['paper']
    train_idx = torch.randperm(n_papers, generator=gen, device=dev)[
        :int(HTRAIN_FRAC * n_papers)].cpu().numpy()
    loader = NeighborLoader(tds, fanouts, ('paper', train_idx),
                            batch_size=HTRAIN_BATCH, shuffle=True,
                            device=dev, seed=seed,
                            rng=np.random.default_rng(seed))
    mp_etypes = [reverse_edge_type(e) for e in etypes]

    def model():
      torch.manual_seed(seed)
      return RGNN(mp_etypes, IGBH_FEAT, IGBH_HIDDEN, IGBH_CLASSES,
                  num_layers=len(FANOUTS), conv='rgat',
                  heads=IGBH_HEADS).to(dev)
    classes = np.bincount(tds.get_node_label('paper')[train_idx],
                          minlength=IGBH_CLASSES)
    store = sum(f.table.numel() * 2 for f in tds.node_features.values())
    torch.cuda.synchronize()
    print(f'hetero train: {train_idx.size} training papers, '
          f'{int((classes > 0).sum())} of {IGBH_CLASSES} classes present; '
          f'features bf16 x {IGBH_FEAT}, {store / 2**30:.3f} GiB; '
          f'message-passing keys {[e[1] for e in mp_etypes]}')

  def one_batch(ld, n_valid, u):
    """One batch of the first training seeds (``n_valid`` real, the rest
    padding), sampled from the uniforms ``u``."""
    seeds = np.concatenate([train_idx[:n_valid],
                            np.full(HTRAIN_BATCH - n_valid, train_idx[0])])
    out = ld.sampler.sample_from_nodes(NodeSamplerInput(seeds, 'paper'),
                                       n_valid, uniforms=u)
    return ld._collate(out, seeds, n_valid)

  def kernels_vs_plain(label, ld, net):
    """One training batch through the kernels and through their plain
    versions, same seeds and uniforms: bit-identical, and its loss on
    ``net``'s weights within LOSS_TOL. Returns the kernels' batch."""
    n_valid = HTRAIN_BATCH - 1
    u = ld.sampler.hop_uniforms(HTRAIN_BATCH, 'paper')
    with torch.no_grad():
      bk = one_batch(ld, n_valid, u)
      lk = float(sage_loss(net, bk))
      with swapped_to_plain(K, swapped):
        bp = one_batch(ld, n_valid, u)
        lp = float(sage_loss(net, bp))
    f = differing_field(torch, bk, bp, HETERO_BATCH_FIELDS)
    if f is not None:
      raise AssertionError(f'{label} batch.{f} differs between kernels and '
                           'plain')
    if not abs(lk - lp) <= LOSS_TOL * max(1.0, abs(lp)):
      raise AssertionError(f'{label} loss {lk} vs plain {lp}')
    print(f'{label} batch {HTRAIN_BATCH} ({n_valid} real seeds): '
          f'bit-identical ('
          f'{sum(int(c) for c in bk.node_count_dict.values())} nodes, '
          f'{sum(int(m.sum()) for m in bk.edge_mask_dict.values())} edges, '
          f'keys {sorted(e[1] for e in bk.row_dict)}), loss {lk:.6f} vs '
          f'plain {lp:.6f} (|diff| {abs(lk - lp):.3e}, tolerance {LOSS_TOL})')
    return bk

  with Phase('hetero train kernel checks'):
    net = model()
    bk = kernels_vs_plain('hetero train', loader, net)
    # K3 on the bf16 paper table (2048-byte rows) at this batch's papers
    k3['bfloat16 x 1024'] = time_gather(
        torch, np, K, 'bfloat16 x 1024', tds.get_node_feature('paper').table,
        bk.node_dict['paper'])
    del bk, net

  with Phase('hetero train main path'):
    net = model()
    step = SageTrainStep(net, lr=LR)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    # a step: B1 once a hop, K2's init once, K3 once a featured type; no K1
    per_step = dict(sample_hop_dedup=len(FANOUTS), dedup_table_insert=1,
                    gather_rows=len(IGBH_NODES), sample_walk_dedup=0)
    losses, secs, edges = [], [], []
    it = iter(loader)
    for i in range(HTRAIN_WARMUP + HTRAIN_STEPS):
      before = {n: getattr(K, n).launches for n in per_step}
      t0 = time.perf_counter()
      b = next(it)
      losses.append(step(b))
      n_edges = sum(v.sum() for v in b.num_sampled_edges.values())
      torch.cuda.synchronize()
      secs.append(time.perf_counter() - t0)
      edges.append(n_edges)
      for n, want in per_step.items():
        if getattr(K, n).launches - before[n] != want:
          raise AssertionError(
              f'step {i}: {getattr(K, n).launches - before[n]} {n} '
              f'launches, expected {want}')
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
      raise AssertionError(f'hetero training: non-finite loss {losses}')
    timed = np.array(secs[HTRAIN_WARMUP:]) * 1e3
    n_timed = sum(int(e) for e in edges[HTRAIN_WARMUP:])
    meter = ThroughputMeter('edges')
    meter.update(n_timed, timed.sum() / 1e3)
    median_ms = float(np.median(timed))
    print(f'hetero training: {len(losses)} steps, losses '
          + ', '.join(f'{v:.4f}' for v in losses))
    print(f'hetero training steps {HTRAIN_WARMUP + 1}-{len(losses)}: median '
          f'{median_ms:.3f} ms a step (min {timed.min():.3f}, quartiles '
          f'{np.percentile(timed, 25):.3f}-{np.percentile(timed, 75):.3f}, '
          f'max {timed.max():.3f}); '
          f'{HTRAIN_BATCH * HTRAIN_STEPS / timed.sum() * 1e3:.1f} seeds/s, '
          f'{meter.rate:.1f} sampled edges/s ({meter.report()}, '
          f'{n_timed / HTRAIN_STEPS:.0f} a step); warmup steps '
          + ', '.join(f'{v * 1e3:.3f}' for v in secs[:HTRAIN_WARMUP])
          + f' ms; on {smi}')
    print(f'launches {launches}; resident before training '
          f'{resident / 2**30:.3f} GiB, peak memory {peak / 2**30:.3f} GiB '
          f'({peak} bytes)')

  with Phase('hetero train profile'):
    pstep = SageTrainStep(net, lr=LR, sync_stages=True)
    pstep(next(it))      # warm

    def run():
      for _ in range(2):
        pstep(next(it))
    step_stages = ('train.forward', 'train.backward', 'train.optimizer')
    wall, busy = profile_stages(
        torch, run, 2, ('sample.multihop', 'gather.features') + step_stages,
        'step', host_stages=step_stages)
    print(f'hetero train profile: device busy {busy:.3f} ms a step is '
          f'{busy / median_ms * 100:.1f}% of the unsynchronised median step '
          f'({median_ms:.3f} ms, hetero train main path)')
    del pstep, it, b

  with Phase('csc checks'):
    # both graphs flipped to CSC on the card, then sampled along in-edges
    g = ds.get_graph()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hcsc = {e: Graph(graphs[e].topo.flip_layout()) for e in etypes}
    torch.cuda.synchronize()
    hflip_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    csc = Graph(g.topo.flip_layout())
    torch.cuda.synchronize()
    flip_ms = (time.perf_counter() - t0) * 1e3
    h_edges = sum(x.num_edges for x in hcsc.values())
    print(f'flip to CSC on the card: products {g.num_edges} edges '
          f'{flip_ms:.3f} ms; igbh-rgat {h_edges} edges over {len(hcsc)} '
          f'types {hflip_ms:.3f} ms')
    hds_in = Dataset(graph=hcsc, node_features=tds.node_features,
                     node_labels=tds.node_labels, edge_dir='in')
    hl_in = NeighborLoader(hds_in, fanouts, ('paper', train_idx),
                           batch_size=HTRAIN_BATCH, device=dev, seed=seed)
    ds_in = Dataset(graph=csc, node_features=ds.node_features, edge_dir='in')
    wl_in = NeighborLoader(ds_in, list(FANOUTS), np.arange(TRAIN_BATCH),
                           batch_size=TRAIN_BATCH, device=dev, seed=seed)
    K.reset_launch_counts()
    u = wl_in.sampler.hop_uniforms(TRAIN_BATCH)
    seeds = torch.randint(0, NUM_NODES, (TRAIN_BATCH,), generator=gen,
                          device=dev).cpu().numpy()

    def walk_batch():
      return wl_in._collate(wl_in.sampler.sample_from_nodes(
          seeds, TRAIN_BATCH, uniforms=u), seeds, TRAIN_BATCH)
    wk = walk_batch()
    with swapped_to_plain(K, ('sample_walk_dedup', 'gather_rows')):
      wp = walk_batch()
    f = differing_field(torch, wk, wp, ('node', 'node_count', 'row', 'col',
                                        'edge_mask', 'x',
                                        'num_sampled_edges'))
    if f is not None:
      raise AssertionError(f'in-edge walk batch.{f} differs between kernels '
                           'and plain')
    print(f'in-edge walk batch {TRAIN_BATCH}: bit-identical '
          f'({int(wk.node_count)} nodes, {int(wk.edge_mask.sum())} edges)')
    del wk, wp
    hk = kernels_vs_plain('in-edge hetero train', hl_in, net)
    loss = float(step(hk))
    csc_launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    if not np.isfinite(loss):
      raise AssertionError(f'in-edge train step: non-finite loss {loss}')
    print(f'in-edge train step: loss {loss:.6f}; launches {csc_launches}')
    want = dict(sample_walk_dedup=1, sample_hop_dedup=len(FANOUTS),
                dedup_table_insert=1, gather_rows=1 + len(IGBH_NODES))
    for n, v in want.items():
      if csc_launches[n] != v:
        raise AssertionError(f'{n}: {csc_launches[n]} launches in the CSC '
                             f'checks, expected {v}')
  return launches, csc_launches


LINK_BATCH, LINK_EMBED, LINK_WARMUP, LINK_STEPS = 512, 64, 3, 10
LINK_FIELDS = ('node', 'node_count', 'row', 'col', 'edge_mask', 'x',
               'num_sampled_nodes', 'num_sampled_edges')
# SEAL on a Cora-sized graph (2,708 nodes, 5,278 undirected edges): the
# training links and each held-out split cut to these positives (and as
# many negatives), one epoch of batch 32
SEAL_NODES, SEAL_CHORDS, SEAL_TRAIN, SEAL_EVAL = 2708, 2570, 256, 64
SEAL_CHECK = 32   # positive (and as many negative) links re-extracted
SUBGRAPH_FANOUTS, SUBGRAPH_BATCH = (10, 5), 64


def link_batch_vs_plain(torch, K, loader, label, props, u, seeds_idx,
                        names=('sample_walk_dedup', 'gather_rows'),
                        fields=LINK_FIELDS):
  """One link batch (``loader._make_batch`` at edge positions
  ``seeds_idx``, the draws injected) through the kernels and through
  their plain versions (the wrappers ``names``): bit-identical on every
  field of ``fields`` and every tensor of its metadata (a dict's too), or
  raises. Returns both batches."""
  sampler = loader.sampler
  real = sampler.sample_from_edges
  sampler.sample_from_edges = lambda inputs: real(inputs, proposals=props,
                                                  uniforms=u)
  try:
    bk = loader._make_batch(seeds_idx, seeds_idx.size)
    with swapped_to_plain(K, names):
      bp = loader._make_batch(seeds_idx, seeds_idx.size)
  finally:
    del sampler.sample_from_edges
  f = differing_field(torch, bk, bp, fields)
  if f is None:
    for key, v in bp.metadata.items():
      a = bk.metadata[key]
      if not isinstance(v, dict):
        a, v = {None: a}, {None: v}
      if any(isinstance(x, torch.Tensor) and not torch.equal(a[k], x)
             for k, x in v.items()):
        f = f'metadata[{key!r}]'
  if f is not None:
    raise AssertionError(f'{label} link batch.{f} differs between kernels '
                         'and plain')
  return bk, bp


def link_phases(torch, np, K, ds, dev, seed, k3, walks, host_us, smi):
  """Link prediction over the products graph (examples/graph_sage_unsup.py
  at products-sage's depth and width), the SubGraphLoader batch, and SEAL
  (examples/seal_link_pred.py) on a Cora-sized graph; returns the
  launches of the link main path, the subgraph batch and the SEAL run."""
  from glt_tpu_torch.examples import graph_sage_unsup as unsup
  from glt_tpu_torch.examples import seal_link_pred as seal
  from glt_tpu_torch.loader import (LinkNeighborLoader, SubGraphLoader,
                                    get_edge_label_index)
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.ops.negative import edge_in_csr, negative_proposals
  from glt_tpu_torch.ops.pipeline import sample_budget
  from glt_tpu_torch.parallel import SageTrainStep, link_bce_loss
  from glt_tpu_torch.sampler import NegativeSampling
  from glt_tpu_torch.utils.profile import ThroughputMeter

  g = ds.get_graph()
  table = ds.get_node_feature().table

  def loader(mode='binary', amount=1, strict=False, eli=None):
    # every edge of the graph is a seed (edge_label_index=None), as in the
    # example; the checks pass that array in, resolved once
    return LinkNeighborLoader(
        ds, list(FANOUTS), edge_label_index=eli, batch_size=LINK_BATCH,
        shuffle=True, neg_sampling=NegativeSampling(mode, amount, strict),
        device=dev, seed=seed, rng=np.random.default_rng(seed))

  with Phase('link kernel checks'):
    every_edge = get_edge_label_index(ds)[1]
    binary = loader(strict=True, eli=every_edge)
    gen = torch.Generator().manual_seed(seed + 11)
    pos = torch.randint(0, g.num_edges, (LINK_BATCH,), generator=gen).numpy()
    pos[LINK_BATCH // 2:] = pos[:LINK_BATCH // 2]     # repeated edges
    for mode, amount in (('binary', 1), ('triplet', 2)):
      ld = binary if mode == 'binary' else loader(mode, amount, True,
                                                  every_edge)
      sampler = ld.sampler
      num_neg = ld.neg_sampling.sample_size(LINK_BATCH)
      n_seeds = (2 * (LINK_BATCH + num_neg) if mode == 'binary'
                 else 2 * LINK_BATCH + num_neg)
      props = negative_proposals(sampler.generator, num_neg, 5, NUM_NODES,
                                 NUM_NODES, dev)
      u = sampler.hop_uniforms(n_seeds)
      bk = link_batch_vs_plain(torch, K, ld, mode, props, u, pos)[0]
      node, meta = bk.node.long(), bk.metadata
      if mode == 'binary':
        # a strict negative is no edge (a triplet keeps only the checked
        # pair's dst, beside the positive's src)
        eli = meta['edge_label_index'].long()
        want = torch.as_tensor(ld.edge_rows[pos], device=dev)
        if not torch.equal(node[eli[0, :LINK_BATCH]], want):
          raise AssertionError('edge_label_index does not resolve to the '
                               'positives\' src')
        hits = int(edge_in_csr(g.indptr, g.indices, node[eli[0, LINK_BATCH:]],
                               node[eli[1, LINK_BATCH:]]).sum())
        if hits:
          raise AssertionError(f'{hits} strict negatives are edges')
      elif tuple(meta['dst_neg_index'].shape) != (LINK_BATCH, amount):
        raise AssertionError('dst_neg_index is not [batch, amount]')
      print(f'link {mode} batch ({LINK_BATCH} positives, half of them '
            f'repeats, {num_neg} strict negatives, {n_seeds} seeds, '
            f'{int(bk.node_count)} nodes, {int(bk.edge_mask.sum())} edges): '
            'bit-identical to plain on every field and label'
            + ('; no negative is an edge' if mode == 'binary' else ''))
      if mode == 'binary':
        # K1 at the link batch's 2,048 seeds (each slot's id, repeats
        # included); K3 at its node list
        walk_seeds = bk.node[meta['seed_labels'].long()]
        slots = K.walk_table_slots(sample_budget(n_seeds, FANOUTS))
        print(f'walk at the link batch: B={n_seeds} seeds '
              f'({int(torch.unique(walk_seeds).numel())} distinct), budget '
              f'{sample_budget(n_seeds, FANOUTS)} nodes, table {slots} '
              'slots, cooperative grid '
              f'{K._coop_blocks("glt_walk_dedup_blocks", dev.index)} blocks')
        walks['B=2048 link'] = time_walk(torch, K, g, walk_seeds, FANOUTS,
                                         torch.Generator(device=dev)
                                         .manual_seed(seed), host_us)
        k3['float32 x 100 link'] = time_gather(
            torch, np, K, 'float32 x 100 link', table, bk.node)
      del bk, ld, sampler
    del binary, every_edge

  with Phase('link main path'):
    torch.manual_seed(seed)
    net = GraphSAGE(FEAT_DIM, HIDDEN, LINK_EMBED, num_layers=3).to(dev)
    step = SageTrainStep(net, lr=unsup.LR, loss=link_bce_loss)
    data = loader()
    it = iter(data)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, secs, edges = [], [], []
    for i in range(LINK_WARMUP + LINK_STEPS):
      t0 = time.perf_counter()
      b = next(it)
      losses.append(step(b))
      n_edges = b.num_sampled_edges.sum()
      torch.cuda.synchronize()
      secs.append(time.perf_counter() - t0)
      edges.append(n_edges)
    link_launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    n_steps = LINK_WARMUP + LINK_STEPS
    want = dict(sample_walk_dedup=n_steps, gather_rows=n_steps,
                dedup_table_insert=0, gather_windows=0, sample_hop=0,
                sample_hop_dedup=0)
    for name, n in want.items():
      if link_launches[name] != n:
        raise AssertionError(f'{name}: {link_launches[name]} launches on the '
                             f'link path, expected {n}')
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
      raise AssertionError(f'link training: non-finite loss {losses}')
    pairs = int(b.metadata['edge_label_index'].shape[1])
    timed = np.array(secs[LINK_WARMUP:]) * 1e3
    n_timed = sum(int(e) for e in edges[LINK_WARMUP:])
    meter = ThroughputMeter('edges')
    meter.update(n_timed, timed.sum() / 1e3)
    link_median = float(np.median(timed))
    print(f'link training ({len(data)} batches an epoch over '
          f'{g.num_edges} seed edges; {pairs} labelled pairs and '
          f'{2 * pairs} seeds a batch): loss {losses[0]:.4f} at step 1, '
          f'{losses[-1]:.4f} at step {n_steps}; steps {LINK_WARMUP + 1}-'
          f'{n_steps}: median {link_median:.3f} ms (quartiles '
          f'{np.percentile(timed, 25):.3f}-{np.percentile(timed, 75):.3f}, '
          f'min {timed.min():.3f}, max {timed.max():.3f}); '
          f'{pairs * LINK_STEPS / timed.sum() * 1e3:.1f} labelled pairs/s, '
          f'{meter.rate:.1f} valid sampled edges/s ({meter.report()}, '
          f'{n_timed / LINK_STEPS:.0f} a step); warm-up steps '
          + ', '.join(f'{v * 1e3:.3f}' for v in secs[:LINK_WARMUP])
          + f' ms; on {smi}')
    print(f'launches {link_launches}; resident before {resident / 2**30:.3f}'
          f' GiB, peak memory {peak / 2**30:.3f} GiB ({peak} bytes)')

  with Phase('link profile'):
    pstep = SageTrainStep(net, lr=unsup.LR, loss=link_bce_loss,
                          sync_stages=True)
    pstep(next(it))      # warm

    def run():
      for _ in range(3):
        pstep(next(it))
    step_stages = ('train.forward', 'train.backward', 'train.optimizer')
    wall, busy = profile_stages(
        torch, run, 3, ('sample.multihop', 'gather.features') + step_stages,
        'step', host_stages=step_stages)
    print(f'link profile: device busy {busy:.3f} ms a step is '
          f'{busy / link_median * 100:.1f}% of the unsynchronised median '
          f'step ({link_median:.3f} ms, link main path)')
    del pstep, step, it, b, data, net

  with Phase('subgraph checks'):
    sub_loader = SubGraphLoader(ds, list(SUBGRAPH_FANOUTS),
                                np.arange(NUM_NODES),
                                batch_size=SUBGRAPH_BATCH, shuffle=True,
                                device=dev, seed=seed,
                                rng=np.random.default_rng(seed))
    sampler = sub_loader.sampler
    u = sampler.hop_uniforms(SUBGRAPH_BATCH)
    real = sampler.subgraph
    sampler.subgraph = lambda s: real(s, uniforms=u)
    seeds = np.random.default_rng(seed + 12).choice(
        NUM_NODES, SUBGRAPH_BATCH, replace=False)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    sk = sub_loader._make_batch(seeds, SUBGRAPH_BATCH)
    torch.cuda.synchronize()
    sub_ms = (time.perf_counter() - t0) * 1e3
    sub_launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    with swapped_to_plain(K, ('sample_walk_dedup', 'gather_rows')):
      sp = sub_loader._make_batch(seeds, SUBGRAPH_BATCH)
    f = differing_field(torch, sk, sp, ('x', 'row', 'col', 'edge_mask',
                                        'node', 'node_count', 'edge'))
    if f is not None:
      raise AssertionError(f'subgraph batch.{f} differs between kernels and '
                           'plain')
    m = sk.edge_mask
    node = sk.node.long()
    src, dst = node[sk.col.long()[m]], node[sk.row.long()[m]]
    found = edge_in_csr(g.indptr, g.indices, src, dst)
    if not bool(found.all()) or not int(m.sum()):
      raise AssertionError(f'{int((~found).sum())} induced edges are not in '
                           'the CSR')
    for name in ('sample_walk_dedup', 'gather_rows'):
      if sub_launches[name] != 1:
        raise AssertionError(f'{name}: {sub_launches[name]} launches for a '
                             'subgraph batch, expected 1')
    print(f'SubGraphLoader batch {SUBGRAPH_BATCH} seeds, fanouts '
          f'{list(SUBGRAPH_FANOUTS)}: {int(sk.node_count)} nodes, '
          f'{int(m.sum())} induced edges of {m.numel()} slots (max degree '
          f'{sampler._max_degree}), every one in the CSR; bit-identical to '
          f'plain; {sub_ms:.3f} ms a batch; launches {sub_launches}')
    del sk, sp, sub_loader, sampler, real

  with Phase('seal main path'):
    K.reset_launch_counts()
    res = seal.run(nodes=SEAL_NODES, chords=SEAL_CHORDS, hops=2, epochs=1,
                   batch_size=32, device=dev, max_train=SEAL_TRAIN,
                   max_eval=SEAL_EVAL)
    seal_launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    if seal_launches['gather_windows'] != 2 * res['links']:
      raise AssertionError(f'{seal_launches["gather_windows"]} window reads '
                           f'for {res["links"]} links, expected two a link')
    if not (np.isfinite(res['losses']).all()
            and 0 <= res['test_auc'] <= 1 and 0 <= res['val_auc'][-1] <= 1):
      raise AssertionError(f'SEAL: {res}')
    # B3 at SEAL's shapes: the run's own sampler and n_cap re-extract its
    # first training links through the window kernel and its plain
    # version; every enclosing subgraph and its DRNL labels must agree
    n_cap, drnl_fn = res['n_cap'], seal.make_drnl_fn(res['n_cap'])
    pos, neg = res['train_pos'][:SEAL_CHECK], res['train_neg'][:SEAL_CHECK]

    def enclosing():
      return (seal.extract_enclosing(res['sampler'], pos, 1.0, drnl_fn, n_cap)
              + seal.extract_enclosing(res['sampler'], neg, 0.0, drnl_fn,
                                       n_cap))
    K.reset_launch_counts()
    got = enclosing()
    check_windows = K.gather_windows.launches
    with swapped_to_plain(K, ('gather_windows',)):
      want = enclosing()
    if check_windows != 2 * len(want) or len(got) != len(want):
      raise AssertionError(f'{check_windows} window reads for {len(want)} '
                           're-extracted links, expected two a link')
    names = ('z', 'rows', 'cols', 'keep', 'node_mask')
    for i, (a, b) in enumerate(zip(got, want)):
      for name, x, y in zip(names, a, b):
        if not torch.equal(x, y):
          raise AssertionError(f'SEAL link {i}: {name} differs between the '
                               'window kernel and plain')
    print(f'seal extraction check: {len(got)} links (the first {SEAL_CHECK} '
          f'positive and {SEAL_CHECK} negative training links), n_cap '
          f'{n_cap}, window {res["sampler"]._max_degree}: z, rows, cols, '
          f'keep and node mask bit-identical between gather_windows and '
          f'its plain version')
    st = np.array(res['step_ms'])
    print(f'seal: {res["links"]} links ({res["train_links"]} training), '
          f'n_cap {res["n_cap"]}, k {res["k"]}; extraction '
          f'{res["extract_ms_per_link"]:.3f} ms a link, DRNL '
          f'{res["drnl_ms_per_link"]:.4f} ms a link ({res["bfs_rounds"]} BFS '
          f'rounds over the three splits\' batches); {len(st)} steps, median '
          f'{np.median(st):.3f} ms (quartiles {np.percentile(st, 25):.3f}-'
          f'{np.percentile(st, 75):.3f}); loss {res["losses"][-1]:.4f}; '
          f'validation AUC {res["val_auc"][-1]:.4f}, test AUC '
          f'{res["test_auc"]:.4f}; launches {seal_launches}; on {smi}')
  return link_launches, sub_launches, seal_launches


# the hot/cold feature tier: examples/train_sage_products.py --split-ratio
# 0.2 (the reference protocol's split, benchmarks/bench_feature.py): the
# products table sorted by in-degree, its hottest 20% on the card and the
# rest pinned in host memory, then the uniform training step
SPLIT_RATIO, SPLIT_WARMUP, SPLIT_STEPS = 0.2, 3, 10
LINK_COPY_BYTES = 256 * 2 ** 20   # a pinned block's host-to-device copy


def link_rate(torch, block, dev):
  """Bytes a second of a copy from the pinned CPU tensor ``block`` (its
  first LINK_COPY_BYTES) to the card, CUDA events over 5 copies after
  one: the rate the host link gives a bulk copy, printed beside the cold
  rows' bound (which takes the link's peak, LINK_BYTES_PER_S)."""
  flat = block.reshape(-1).view(torch.uint8)[:LINK_COPY_BYTES]
  dst = torch.empty(flat.shape, dtype=torch.uint8, device=dev)
  ms = cuda_ms(torch, lambda i=0: dst.copy_(flat, non_blocking=True), 5,
               warmup=1)
  return flat.numel() / ms * 1e3


def mixed_bound_ms(torch, rows, h, row_bytes):
  """The least time of a split store's gather of ``rows`` (clamped, as the
  kernel reads them): device memory moves each distinct hot row once, a
  4-byte index and a written row per lane, while the host link moves each
  distinct cold row once at its peak; the two channels run at once, so
  the bound is the larger time. Returns it with the distinct hot and cold
  row counts."""
  distinct = torch.unique(rows.long())
  n_cold = int((distinct >= h).sum())
  n_hot = distinct.numel() - n_cold
  b = rows.numel()
  ms = max(bytes_ms(n_hot * row_bytes + b * (row_bytes + 4)),
           n_cold * row_bytes / LINK_BYTES_PER_S * 1e3)
  return ms, n_hot, n_cold


def time_mixed(torch, np, K, label, hot, cold, rows, rate, resident=None,
               host_phase=None):
  """K3 over a split store (``gather_rows_mixed(hot, cold, rows)``, ``cold``
  the pinned block's ``PinnedHost``): one
  launch, torch.equal to its plain twin and, given the fully resident
  table ``resident``, to today's K3 over it; timed in turns (ABBA, medians
  of ROUNDS) with that K3 and, given one, the host phase
  (``host_phase()``); its plain time and bound. Prints its line and
  returns its row."""
  n = hot.shape[0] + cold.shape[0]
  before = K.gather_rows_mixed.launches
  got = K.gather_rows_mixed(hot, cold, rows)
  if K.gather_rows_mixed.launches != before + 1:
    raise AssertionError(f'gather_rows_mixed {label} is not one launch')
  want = K.gather_rows_mixed_plain(hot, cold, rows)
  if not torch.equal(got, want):
    raise AssertionError(f'gather_rows_mixed {label} differs from plain')
  if resident is not None and not torch.equal(got, K.gather_rows(resident,
                                                                  rows)):
    raise AssertionError(f'gather_rows_mixed {label} differs from K3 over '
                         'the resident table')
  del got, want
  fns = {'mixed': lambda: K.gather_rows_mixed(hot, cold, rows)}
  if resident is not None:
    fns['resident'] = lambda: K.gather_rows(resident, rows)
  if host_phase is not None:
    fns['host_phase'] = host_phase
  per_round = in_turns_ms(torch, np, fns, iters=5, abba=True)
  t = {k: float(np.median(v)) for k, v in per_round.items()}
  plain = cuda_ms(torch, lambda i=0: K.gather_rows_mixed_plain(hot, cold,
                                                               rows), 3,
                  warmup=1)
  row_bytes = hot.shape[1] * hot.element_size()
  clamped = rows.long().clamp(0, n - 1)
  bound, n_hot, n_cold = mixed_bound_ms(torch, clamped, hot.shape[0],
                                        row_bytes)
  lay = K.gather_rows_layout(row_bytes, hot.data_ptr() | cold.address)
  mode = (f'T={lay.lanes}, {lay.passes} pass(es), '
          + ('realigned' if lay.realign else 'copy'))
  others = ''.join(f', {k} {v:.4f} ms' for k, v in t.items() if k != 'mixed')
  print(f'gather_rows_mixed {label}: {rows.numel()} rows ({n_hot} distinct '
        f'hot of {hot.shape[0]}, {n_cold} distinct cold of {cold.shape[0]}) '
        f'of {row_bytes} B ({mode}); one launch, equal to plain'
        + (' and to K3 over the resident table' if resident is not None
           else '') + f'; {t["mixed"]:.4f} ms (in turns, ABBA, medians of '
        f'{ROUNDS}{others}; plain {plain:.4f} ms; bound {bound:.6f} ms, the '
        f'larger of device memory and the link at its '
        f'{LINK_BYTES_PER_S / 1e9:.0f} GB/s peak, {bound / t["mixed"] * 100:.1f}'
        f'% of it; a bulk copy over the link {rate / 1e9:.2f} GB/s)')
  return dict(ms=t['mixed'], plain_ms=plain, bound_ms=bound, err=0,
              library_ms=None, resident_ms=t.get('resident'),
              host_phase_ms=t.get('host_phase'), rows=rows.numel(),
              hot_distinct=n_hot, cold_distinct=n_cold,
              hot_rows=hot.shape[0], cold_rows=cold.shape[0],
              link_gb_s=rate / 1e9, layout=lay._asdict())


def split_phases(torch, np, K, ds, dev, seed, smi):
  """The hot/cold feature tier over the products graph: the table sorted
  by in-degree and split 0.2 (hot rows on the card, cold rows pinned and
  mapped), K3 over both blocks against its plain twin, the resident K3
  and the host phase, uniform training through NeighborLoader and
  SageTrainStep beside the same steps over the resident sorted table, a
  serving request, and the feature bench; returns the launches of the
  split main path and the K3 rows of the split kernel checks."""
  from glt_tpu_torch.data import Dataset, Feature, sort_by_in_degree
  from glt_tpu_torch.data.feature import gather_features
  from glt_tpu_torch.loader import NeighborLoader
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.parallel import SageTrainStep, sage_loss
  from glt_tpu_torch.serving import InferenceEngine
  from glt_tpu_torch.typing import Split
  from glt_tpu_torch.utils.offload import pin_host
  from glt_tpu_torch.utils.profile import ThroughputMeter

  g = ds.get_graph()
  train_idx = ds.get_split(Split.train)
  with Phase('split data'):
    host = ds.get_node_feature().table.cpu().numpy()
    sorted_ = {}

    def timed_sort(feats, ratio, topo):
      t0 = time.perf_counter()
      sorted_['feats'], sorted_['old2new'] = sort_by_in_degree(feats, ratio,
                                                               topo)
      sorted_['s'] = time.perf_counter() - t0
      return sorted_['feats'], sorted_['old2new']

    def dataset():
      d = Dataset(graph=ds.graph, node_labels=ds.node_labels)
      d.node_split = ds.node_split
      return d
    sds = dataset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sds.init_node_features(host, sort_func=timed_sort,
                           split_ratio=SPLIT_RATIO, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    del host
    sf = sds.get_node_feature()
    hot, cold = sf.device_part, sf.cold_pinned
    if cold is None or cold.tensor.is_cuda or hot.shape[0] != round(
        NUM_NODES * SPLIT_RATIO):
      raise AssertionError('the split store did not pin its cold block')
    # the same sorted rows whole on the card, and in a host-phase store
    rds = dataset()
    rds.node_features = Feature(sorted_['feats'], id2index=sorted_['old2new'],
                                device=dev)
    hp = Feature(sorted_['feats'], split_ratio=SPLIT_RATIO,
                 id2index=sorted_['old2new'], device=dev, host_offload=False)
    resident = rds.get_node_feature().table
    rate = link_rate(torch, cold.tensor, dev)
    dev_bytes = hot.numel() * 4 + sf.id2index.numel() * 4
    print(f'split store: {hot.shape[0]} hot rows on the card, '
          f'{cold.shape[0]} cold rows pinned and mapped ({dev_bytes} device '
          f'bytes with the id map, {cold.tensor.numel() * 4} pinned bytes); '
          f'sort by in-degree {sorted_["s"]:.3f} s, init_node_features {init_s:.3f} '
          f's (row 0 holds node {int(np.argmin(sorted_["old2new"]))}, the '
          'hottest); host-to-device copy of '
          f'the pinned block {rate / 1e9:.3f} GB/s ({LINK_COPY_BYTES} bytes)'
          f' on {smi}')

  with Phase('split kernel checks'):
    loader = lambda d: NeighborLoader(d, list(FANOUTS), train_idx,
                                      batch_size=TRAIN_BATCH, shuffle=True,
                                      device=dev, seed=seed,
                                      rng=np.random.default_rng(seed))
    sl = loader(sds)
    node = sl.sampler.sample_from_nodes(train_idx[:TRAIN_BATCH]).node
    rows = sf.map_ids(node).to(torch.int32)
    mixed = {'float32 x 100 split 0.2': time_mixed(
        torch, np, K, 'float32 x 100 split 0.2 (a training batch)', hot,
        cold, rows, rate, resident=resident,
        host_phase=lambda: gather_features(hp, node))}
    if not torch.equal(gather_features(hp, node), gather_features(sf, node)):
      raise AssertionError('the host phase differs from the split gather')
    # padded, out-of-range and -1 rows at split 0.0 (the whole table
    # pinned) and 1.0 (nothing spilled: today's K3, counted as mixed)
    raw = torch.cat([rows, torch.tensor([-1, -7, NUM_NODES, NUM_NODES + 5],
                                        dtype=torch.int32, device=dev)])
    whole = Feature(sorted_['feats'], split_ratio=0.0, device=dev)
    mixed['float32 x 100 split 0.0'] = time_mixed(
        torch, np, K, 'float32 x 100 split 0.0', whole.device_part,
        whole.cold_pinned, raw, rate, resident=resident)
    del whole
    sorted_.clear()
    nothing = pin_host(torch.empty((0, FEAT_DIM), dtype=torch.float32), dev)
    mixed['float32 x 100 split 1.0'] = time_mixed(
        torch, np, K, 'float32 x 100 split 1.0', resident, nothing, raw,
        rate, resident=resident)
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    for dtype, width in NARROW_ROWS:
      dt = getattr(torch, dtype)
      t = (torch.randint(0, 256, (NUM_NODES, width), generator=gen,
                         device=dev, dtype=dt) if dt == torch.uint8 else
           torch.randn((NUM_NODES, width), generator=gen, device=dev).to(dt))
      f = Feature(t, split_ratio=SPLIT_RATIO, device=dev)
      mixed[f'{dtype} x {width} split 0.2'] = time_mixed(
          torch, np, K, f'{dtype} x {width} split 0.2', f.device_part,
          f.cold_pinned, raw, rate, resident=t)
      del t, f
    del node, rows, raw, hp

  with Phase('split main path vs plain'):
    # one batch through the kernels and through the plain versions, and
    # the same batch over the resident sorted table
    torch.manual_seed(seed)
    net = GraphSAGE(FEAT_DIM, HIDDEN, CLASSES, num_layers=3).to(dev)
    rl = loader(rds)
    u = sl.sampler.hop_uniforms(TRAIN_BATCH)
    n_valid = TRAIN_BATCH - 1
    seeds = np.concatenate([train_idx[:n_valid], train_idx[:1]])

    def batch(ld):
      return ld._collate(ld.sampler.sample_from_nodes(seeds, n_valid,
                                                      uniforms=u),
                         seeds, n_valid)
    fields = ('node', 'node_count', 'row', 'col', 'edge_mask', 'x', 'y',
              'num_sampled_edges')
    with torch.no_grad():
      K.reset_launch_counts()
      bk = batch(sl)
      if (K.gather_rows_mixed.launches, K.gather_rows.launches) != (1, 0):
        raise AssertionError('the split batch is not one mixed K3 launch')
      lk = float(sage_loss(net, bk))
      with swapped_to_plain(K, ('sample_walk_dedup', 'gather_rows_mixed')):
        bp = batch(sl)
        lp = float(sage_loss(net, bp))
      br = batch(rl)
    for other, what in ((bp, 'plain'), (br, 'the resident sorted table')):
      f = differing_field(torch, bk, other, fields)
      if f is not None:
        raise AssertionError(f'split batch.{f} differs from {what}')
    if not abs(lk - lp) <= LOSS_TOL * max(1.0, abs(lp)):
      raise AssertionError(f'split first-step loss {lk} vs plain {lp}')
    valid = bk.node[:int(bk.node_count)]
    n_cold = int((sf.map_ids(valid) >= sf.hot_count).sum())
    print(f'split batch {TRAIN_BATCH} ({n_valid} real seeds, '
          f'{int(bk.node_count)} nodes, {n_cold} of them cold): bit-identical'
          f' to plain and to the batch over the resident sorted table; loss '
          f'{lk:.6f} vs plain {lp:.6f} (|diff| {abs(lk - lp):.3e}, tolerance '
          f'{LOSS_TOL})')
    del bk, bp, br, valid, net

  def train(label, ld):
    """SPLIT_WARMUP + SPLIT_STEPS uniform steps; returns the timed steps'
    ms, their sampled edges, each batch's cold share of its valid rows,
    the launches and the peak memory above the resident bytes."""
    torch.manual_seed(seed)
    step = SageTrainStep(GraphSAGE(FEAT_DIM, HIDDEN, CLASSES,
                                   num_layers=3).to(dev), lr=LR)
    feat = ld.data.get_node_feature()
    it = iter(ld)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    secs, edges, shares, losses = [], [], [], []
    for i in range(SPLIT_WARMUP + SPLIT_STEPS):
      t0 = time.perf_counter()
      b = next(it)
      losses.append(step(b))
      n_edges = b.num_sampled_edges.sum()
      torch.cuda.synchronize()
      secs.append(time.perf_counter() - t0)
      edges.append(int(n_edges))
      valid = b.node[:int(b.node_count)]
      shares.append((int((feat.map_ids(valid) >= feat.hot_count).sum()),
                     valid.numel()))
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    peak = torch.cuda.max_memory_allocated() - before
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not np.mean(losses[-5:]) < losses[0]:
      raise AssertionError(f'{label}: losses {losses}')
    timed = np.array(secs[SPLIT_WARMUP:]) * 1e3
    n_timed = sum(edges[SPLIT_WARMUP:])
    meter = ThroughputMeter('edges')
    meter.update(n_timed, timed.sum() / 1e3)
    cold_rows = sum(c for c, _ in shares[SPLIT_WARMUP:]) / SPLIT_STEPS
    print(f'{label}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; steps '
          f'{SPLIT_WARMUP + 1}-{SPLIT_WARMUP + SPLIT_STEPS}: median '
          f'{np.median(timed):.3f} ms (quartiles {np.percentile(timed, 25):.3f}'
          f'-{np.percentile(timed, 75):.3f}), '
          f'{TRAIN_BATCH * SPLIT_STEPS / timed.sum() * 1e3:.1f} seeds/s, '
          f'{meter.rate:.1f} sampled edges/s ({meter.report()}); cold share '
          'of each batch\'s valid rows ' + ', '.join(
              f'{c / n:.4f}' for c, n in shares)
          + f'; {cold_rows:.0f} cold rows, {cold_rows * FEAT_DIM * 4:.0f} '
          f'bytes over the link a timed step; peak {peak / 2**30:.3f} GiB '
          f'({peak} bytes) above the {before / 2**30:.3f} GiB resident; '
          f'launches {launches}; on {smi}')
    return dict(median_ms=float(np.median(timed)), peak=peak,
                launches=launches)

  with Phase('split main path'):
    split = train('split 0.2 training', loader(sds))
    n = SPLIT_WARMUP + SPLIT_STEPS
    want = dict(sample_walk_dedup=n, gather_rows_mixed=n, gather_rows=0,
                dedup_table_insert=0)
    for name, v in want.items():
      if split['launches'][name] != v:
        raise AssertionError(f'{name}: {split["launches"][name]} launches '
                             f'on the split path, expected {v}')
    res = train('resident sorted training (the same batches)', loader(rds))
    if (res['launches']['gather_rows'],
        res['launches']['gather_rows_mixed']) != (n, 0):
      raise AssertionError('the resident run did not gather through K3')
    print(f'split against resident: median step {split["median_ms"]:.3f} '
          f'vs {res["median_ms"]:.3f} ms; peak above resident '
          f'{split["peak"]} vs {res["peak"]} bytes')

  with Phase('split profile'):
    step = SageTrainStep(GraphSAGE(FEAT_DIM, HIDDEN, CLASSES,
                                   num_layers=3).to(dev), lr=LR,
                         sync_stages=True)
    it = iter(sl)
    step(next(it))      # warm

    def run():
      for _ in range(3):
        step(next(it))
    step_stages = ('train.forward', 'train.backward', 'train.optimizer')
    profile_stages(torch, run, 3,
                   ('sample.multihop', 'gather.features') + step_stages,
                   'step', host_stages=step_stages)
    del step, it

  with Phase('split serving check'):
    rng = torch.Generator().manual_seed(seed + 14)
    ids = torch.randint(0, NUM_NODES, (200,), generator=rng).numpy()
    out = {}
    for name, d in (('split', sds), ('resident', rds)):
      eng = InferenceEngine(d, GraphSAGE(FEAT_DIM, HIDDEN, CLASSES,
                                         num_layers=3), None, list(FANOUTS),
                            buckets=BUCKETS, seed=seed, device=dev)
      eng.init_params(seed)
      K.reset_launch_counts()
      out[name] = eng.infer(ids)
      if name == 'split' and K.gather_rows_mixed.launches != 1:
        raise AssertionError('the split request is not one mixed K3 launch')
      del eng
    diff = float(np.abs(out['split'] - out['resident']).max())
    if not np.allclose(out['split'], out['resident'], rtol=LOGIT_TOL,
                       atol=LOGIT_TOL):
      raise AssertionError(f'split serving logits differ by {diff}')
    print(f'bucket-256 request of {ids.size} ids over the split store: '
          f'logits within {diff:.3e} of the resident store\'s (tolerance '
          f'{LOGIT_TOL})')
    del sds, rds, sl, resident, hot, cold, sf
    torch.cuda.empty_cache()

  with Phase('feature bench'):
    out = subprocess.run(
        [sys.executable, '-m', 'glt_tpu_torch.benchmarks.bench_feature'],
        capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
      raise AssertionError(f'bench_feature failed: {out.stderr[-2000:]}')
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith('{')]
    metrics = [json.loads(ln)['metric'] for ln in lines]
    if metrics != ['feature_gather_rows_per_sec_device',
                   'feature_gather_rows_per_sec_split']:
      raise AssertionError(f'bench_feature printed {out.stdout[-2000:]}')
    for ln in lines:
      print(f'bench_feature: {ln}')
  return split['launches'], mixed


# superstep training (SPMDSageTrainStep at products-sage's width): windows of
# K = 8 batches of 1024 seeds; an epoch of 19 batches (two full windows and
# a tail of 3, its last batch ragged)
SS_K, SS_BATCHES, SS_RAGGED = 8, 19, 300
SS_SPLIT = 0.2
# a split or streaming epoch against the resident one: the same weights,
# batches and uniforms, so the first step's loss differs only by the
# forward's float atomics; each later step also carries the other run's
# atomics through the Adam updates before it (19 steps)
FIRST_LOSS_TOL, EPOCH_LOSS_TOL = 1e-5, 1e-3


def superstep_phases(torch, np, K, ds, dev, seed, smi):
  """The data-parallel trainer at products-sage's width on a one-rank
  mesh: the epoch staged on the card and trained window by window, each
  window length captured once in a CUDA graph and replayed; then over a
  split ShardedFeature (K3 mixed inside the graph) and with cold
  streaming; then the per-batch against superstep bench at the JAX
  defaults and at this width. Returns, for each path (``superstep``,
  ``superstep_split``, ``superstep_streaming``), its kernel launches
  (eager plus graph replays) and those its graph replays made, by
  wrapper name."""
  from glt_tpu_torch.benchmarks import bench_train
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.ops.pipeline import multihop_sample, multihop_sample_many
  from glt_tpu_torch.ops.sample import walk_hop_uniforms
  from glt_tpu_torch.parallel import (ShardedFeature, SPMDSageTrainStep,
                                      make_mesh, sage_loss)
  from glt_tpu_torch.typing import Split

  g = ds.get_graph()
  table = ds.get_node_feature().table
  labels = ds.node_labels
  train_idx = ds.get_split(Split.train)
  n_seeds = SS_BATCHES * TRAIN_BATCH - SS_RAGGED
  with Phase('superstep data'):
    mesh = make_mesh(device=dev)
    sf = ShardedFeature(table, mesh)
    torch.cuda.synchronize()

    def trainer(store=sf, **kw):
      torch.manual_seed(seed)
      return SPMDSageTrainStep(
          mesh, GraphSAGE(FEAT_DIM, HIDDEN, CLASSES, num_layers=3).to(dev),
          g, store, labels, list(FANOUTS), TRAIN_BATCH, lr=LR, seed=seed,
          **kw)

    def loader(step):
      return step.make_epoch_loader(train_idx[:n_seeds], superstep_len=SS_K,
                                    rng=np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 15)
    ugen = torch.Generator(device=dev).manual_seed(seed + 16)

    def window(t=SS_K):
      """Seeds [t, 1024] from the training split, the last batch ragged,
      and their uniforms per hop [t, 1, S, K]."""
      seeds = rng.choice(train_idx, (t, TRAIN_BATCH))
      nv = np.full((t, 1), TRAIN_BATCH)
      nv[-1] = TRAIN_BATCH - SS_RAGGED
      draws = [walk_hop_uniforms(ugen, TRAIN_BATCH, FANOUTS, False, dev)
               for _ in range(t)]
      return seeds, nv, [torch.stack(h)[:, None] for h in zip(*draws)]
    print(f'superstep: one rank on {dev}, ShardedFeature of '
          f'{tuple(table.shape)} float32 ({sf.rows_per_shard} rows a '
          f'shard), {train_idx.size} training seeds; an epoch of '
          f'{n_seeds} seeds: {SS_BATCHES} batches of {TRAIN_BATCH}, windows '
          f'of {SS_K} and a tail of {SS_BATCHES % SS_K}')

  with Phase('superstep kernel checks'):
    # the sampling window (multihop_sample_many, one K1 launch a batch)
    # against K single walks on the same uniforms, and the exchange's
    # served rows (K3) against the plain gather of the same nodes
    step = trainer()
    seeds, nv, u = window()
    s_dev = torch.as_tensor(seeds, device=dev, dtype=torch.int32)
    nv_dev = torch.as_tensor(nv[:, 0], device=dev, dtype=torch.int32)
    uu = [x[:, 0].contiguous() for x in u]
    K.reset_launch_counts()
    many = multihop_sample_many(step._plan, s_dev, nv_dev, FANOUTS,
                                u_stack=uu)
    if K.sample_walk_dedup.launches != SS_K:
      raise AssertionError('the sampling window is not one walk a batch')
    for t in range(SS_K):
      one = multihop_sample(step._plan, s_dev[t], nv_dev[t], FANOUTS,
                            u_hops=[x[t] for x in uu])
      for key, v in one.items():
        if not torch.equal(v, many[key][t]):
          raise AssertionError(f'multihop_sample_many {key} differs from '
                               f'walk {t}')
    node = many['node'][0]
    valid = torch.arange(node.numel(), device=dev) < many['node_count'][0]
    before = K.gather_rows.launches
    x = sf.lookup_local(node.clamp(min=0), valid)
    if K.gather_rows.launches != before + 1:
      raise AssertionError('the exchange did not serve through one K3 launch')
    want = torch.where(valid[:, None], K.gather_rows_plain(
        table, node.clamp(min=0)), torch.zeros((), device=dev))
    if not torch.equal(x, want):
      raise AssertionError('the exchange rows differ from the plain gather')
    print(f'sampling window of {SS_K}: bit-identical to {SS_K} walks on every '
          f'output ({int(many["node_count"].sum())} nodes, '
          f'{int(many["edge_mask"].sum())} edges); exchange of '
          f'{node.numel()} lanes ({int(valid.sum())} valid): bit-identical '
          'to the plain gather')
    # a capped exchange (a quarter of the lanes a bucket): the per-batch
    # drain reads its round count back, a captured body runs the worst
    # case; both against the uncapped exchange
    cap = node.numel() // 4
    capped = ShardedFeature(table, mesh, bucket_cap=cap)
    ids = node.clamp(min=0)
    times = {}
    for name, static in (('drain', False), ('static', True)):
      if not torch.equal(capped.lookup_local(ids, valid, static), x):
        raise AssertionError(f'the capped exchange ({name}) differs')
      times[name] = cuda_ms(torch, lambda i=0, st=static: capped.lookup_local(
          ids, valid, st), 10)
    uncapped = cuda_ms(torch, lambda i=0: sf.lookup_local(ids, valid), 10)
    rounds = -(-int(valid.sum()) // cap)
    print(f'capped exchange (cap {cap}): bit-identical; the drain '
          f'({rounds} rounds read back) {times["drain"]:.4f} ms, the static '
          f'worst case ({-(-node.numel() // cap)} rounds) '
          f'{times["static"]:.4f} ms, uncapped {uncapped:.4f} ms')
    del many, one, node, x, want, step, capped

  with Phase('superstep main path'):
    # (1) a captured window against its batches a call at a time
    a, b = trainer(), trainer()
    got, want = [], []
    for w in range(2):
      seeds, nv, u = window()
      got.append(a.superstep(seeds, nv, u))
      want.append(torch.stack([b(seeds[t], nv[t], [x[t] for x in u])
                               for t in range(SS_K)]))
    got, want = torch.cat(got).cpu(), torch.cat(want).cpu()
    diff = float((got - want).abs().max())
    if (a.superstep_captures, a.graph_replays) != (1, 1) or \
        not diff <= LOSS_TOL:
      raise AssertionError(f'window vs per-batch: captures '
                           f'{a.superstep_captures}, replays '
                           f'{a.graph_replays}, losses differ by {diff}')
    print(f'two windows of {SS_K} (eager + capture, then a replay) against '
          f'{2 * SS_K} per-batch calls: losses within {diff:.3e} (tolerance '
          f'{LOSS_TOL}); capture {a.capture_seconds[0] * 1e3:.1f} ms')
    del a, b
    torch.cuda.empty_cache()
    # (2) run_epoch: two epochs, every launch counted from here
    step = trainer()
    ld = loader(step)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    epochs, secs, caps = [], [], []
    for _ in range(2):
      t0 = time.perf_counter()
      epochs.append(step.run_epoch(ld))
      torch.cuda.synchronize()
      secs.append(time.perf_counter() - t0)
      caps.append(step.superstep_captures)
    eager, replayed, launches = path_launches(K, step)
    peak = torch.cuda.max_memory_allocated() - base
    resident_losses = epochs[0].cpu()
    losses = torch.cat(epochs).cpu().numpy()
    if caps != [2, 2] or not np.isfinite(losses).all() or \
        losses.shape != (2 * SS_BATCHES,):
      raise AssertionError(f'run_epoch: captures {caps}, losses {losses}')
    bodies = SS_K + SS_BATCHES % SS_K      # the bodies run eagerly
    for name in ('sample_walk_dedup', 'gather_rows'):
      if (eager[name], launches[name]) != (bodies, 2 * SS_BATCHES):
        raise AssertionError(
            f'{name}: {eager[name]} eager launches and {replayed.get(name)} '
            f'by replays, expected {bodies} and {2 * SS_BATCHES - bodies}')
    print_windows(step)
    ms = secs[1] * 1e3 / SS_BATCHES
    print(f'run_epoch x 2 ({SS_BATCHES} batches each): captures after each '
          f'epoch {caps}, capture ms {[round(s * 1e3, 1) for s in step.capture_seconds]}, '
          f'graph replays {step.graph_replays}; loss {losses[0]:.4f} -> '
          f'{losses[-1]:.4f}; epoch 1 {secs[0]:.3f} s (two eager windows and '
          f'their captures), epoch 2 {secs[1]:.3f} s ({ms:.3f} ms a step, '
          f'{1e3 / ms:.2f} steps/s, all replays); launches {launches}: '
          f'eager {eager}, by graph replays {replayed}; peak '
          f'{peak / 2**30:.3f} GiB above {base / 2**30:.3f} GiB resident; '
          f'on {smi}')
    ss_paths = {'superstep': (launches, replayed)}

  with Phase('superstep main path vs plain'):
    seeds, nv, u = window(1)
    s0 = torch.as_tensor(seeds[0], device=dev, dtype=torch.int32)
    n0 = torch.tensor(int(nv[0, 0]), device=dev, dtype=torch.int32)
    uh = [x[0, 0] for x in u]
    fields = ('node', 'node_count', 'row', 'col', 'edge_mask', 'x', 'y')
    with torch.no_grad():
      bk = step.make_batch(s0, n0, uh)
      lk = float(sage_loss(step.model, bk))
      with swapped_to_plain(K, ('sample_walk_dedup', 'gather_rows')):
        bp = step.make_batch(s0, n0, uh)
        lp = float(sage_loss(step.model, bp))
    f = differing_field(torch, bk, bp, fields)
    if f is not None:
      raise AssertionError(f'superstep batch.{f} differs from plain')
    if not abs(lk - lp) <= LOSS_TOL * max(1.0, abs(lp)):
      raise AssertionError(f'superstep body loss {lk} vs plain {lp}')
    print(f'the batch body ({int(bk.node_count)} nodes, ragged at '
          f'{int(n0)} seeds): bit-identical to plain; loss {lk:.6f} vs '
          f'plain {lp:.6f} (|diff| {abs(lk - lp):.3e}, tolerance {LOSS_TOL})')
    del bk, bp, step
    torch.cuda.empty_cache()

  def epoch_beside(label, store, epochs, **kw):
    """``epochs`` epochs of a fresh trainer over ``store``: its first
    epoch's losses against the resident run's (same weights, batches and
    uniforms), each epoch's ms a step and its launches (eager, by graph
    replays, both). Returns the trainer, the launches and those of its
    replays."""
    step = trainer(store, **kw)
    ld = loader(step)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    runs, ms = [], []
    for _ in range(epochs):
      t0 = time.perf_counter()
      runs.append(step.run_epoch(ld).cpu())
      torch.cuda.synchronize()
      ms.append((time.perf_counter() - t0) * 1e3 / SS_BATCHES)
    losses = runs[0]
    eager, replayed, launches = path_launches(K, step)
    diffs = (losses - resident_losses).abs()
    first, diff = float(diffs[0]), float(diffs.max())
    if not (first <= FIRST_LOSS_TOL and diff <= EPOCH_LOSS_TOL) or \
        step.superstep_captures != 2:
      raise AssertionError(f'{label}: losses differ from resident by '
                           f'{first} at the first step, {diff} at most; '
                           f'captures {step.superstep_captures}')
    print_windows(step)
    print(f'{label}: ms a step by epoch {[round(m, 3) for m in ms]} (the '
          f'resident epochs {[round(t * 1e3 / SS_BATCHES, 3) for t in secs]});'
          f' losses against resident: first step {first:.3e} (tolerance '
          f'{FIRST_LOSS_TOL}), at most {diff:.3e} (tolerance '
          f'{EPOCH_LOSS_TOL}); launches {launches}: eager {eager}, by graph '
          f'replays {replayed}; on {smi}')
    return step, launches, replayed

  with Phase('superstep split'):
    # the exchange over each spilled shard against the plain gather of
    # the kernel checks' batch: the pinned one reads hot and cold rows in
    # one K3 mixed launch; the host-spilled one's lookup adds its cold
    # rows on the host
    want = torch.where(valid[:, None], K.gather_rows_plain(table, ids),
                       torch.zeros((), device=dev))
    split = ShardedFeature(table, mesh, split_ratio=SS_SPLIT)
    if split.cold_pinned is None:
      raise AssertionError('the split shard did not pin its cold block')
    before = K.gather_rows_mixed.launches
    got = split.lookup_local(ids, valid)
    if K.gather_rows_mixed.launches != before + 1:
      raise AssertionError('the split exchange is not one K3 mixed launch')
    if not torch.equal(got, want):
      raise AssertionError('the split exchange rows differ from the plain '
                           'gather')
    stream = ShardedFeature(table, mesh, split_ratio=SS_SPLIT,
                            host_offload=False)
    if not torch.equal(stream.lookup(ids, valid), want):
      raise AssertionError('the host-spilled lookup differs from the plain '
                           'gather')
    cold = int((valid & (ids >= split.hot_count)).sum())
    print(f'split {SS_SPLIT} exchange of {ids.numel()} lanes '
          f'({int(valid.sum())} valid, {cold} cold): pinned (one K3 mixed '
          'launch) and host-spilled (lookup + host rows) both bit-identical '
          'to the plain gather')
    del got, want
    step, launches, replayed = epoch_beside(
        f'split {SS_SPLIT} (pinned cold block, K3 mixed in the graph)', split,
        2)
    if (launches['gather_rows_mixed'], launches['sample_walk_dedup'],
        launches['gather_rows']) != (2 * SS_BATCHES, 2 * SS_BATCHES, 0):
      raise AssertionError('the split path did not gather through K3 mixed '
                           'once a batch')
    ss_paths['superstep_split'] = (launches, replayed)
    del split, step
    torch.cuda.empty_cache()
    step, launches, replayed = epoch_beside(
        f'split {SS_SPLIT} cold streaming (host staging, prefetch thread)',
        stream, 2, cold_streaming=True)
    if (launches['gather_rows'], launches['sample_walk_dedup']) != (
        2 * SS_BATCHES, 2 * SS_BATCHES) or replayed.get('sample_walk_dedup'):
      raise AssertionError('the streaming path did not sample eagerly and '
                           'gather through K3 once a batch')
    ss_paths['superstep_streaming'] = (launches, replayed)
    stream_parts(torch, np, K, step, stream, window(), dev)
    del stream, step
    torch.cuda.empty_cache()

  with Phase('train bench'):
    out = subprocess.run(
        [sys.executable, '-m', 'glt_tpu_torch.benchmarks.bench_train',
         '--superstep-ab'], capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
      raise AssertionError(f'bench_train failed: {out.stderr[-2000:]}')
    small = json.loads(out.stdout.strip().splitlines()[-1])
    print(f'bench_train (JAX defaults): {json.dumps(small)}')
    big = bench_train.measure_engines(
        data=(ds, table, labels), feat_dim=FEAT_DIM, batch_size=TRAIN_BATCH,
        fanout=FANOUTS, hidden=HIDDEN, num_classes=CLASSES, k=SS_K,
        supersteps=6, warmup=2, seed=seed, device=dev)
    print(f'bench_train (products-sage width): {json.dumps(big)}')
    print(f'bench on {smi}')
    torch.cuda.empty_cache()
  return ss_paths


# partitioned hetero training (examples/igbh/dist_train_rgnn.py) at
# igbh-rgat's width on a one-rank mesh: warm-up and timed per-batch steps,
# eval batches, a window of DIST_K batches as one CUDA graph
DIST_WARMUP, DIST_STEPS, DIST_EVAL, DIST_K = 2, 10, 3, 8
DIST_FIELDS = ('node_dict', 'node_count_dict', 'row_dict', 'col_dict',
               'edge_mask_dict', 'x_dict', 'y_dict')


def dist_phases(torch, np, K, dev, seed, k3, rows, smi):
  """The partitioned hetero trainer: the igbh-rgat graph synthesised on the
  card, partitioned on disk by the port's RandomPartitioner (one part: one
  rank), loaded back through DistHeteroGraph, DistDataset and a bf16
  DistFeature a node type, then trained by DistHeteroTrainStep a batch a
  step and a window at a time. Returns the launches of the per-batch path
  and, for the superstep path, its launches (eager plus graph replays) and
  those its replays made, by wrapper name."""
  import os
  import shutil
  import tempfile
  from glt_tpu_torch.distributed import (DistDataset, DistFeature,
                                         DistHeteroGraph,
                                         DistHeteroNeighborSampler,
                                         DistHeteroTrainStep)
  from glt_tpu_torch.examples.igbh.data import split_indices
  from glt_tpu_torch.models import RGNN
  from glt_tpu_torch.ops.unique import sorted_hop_dedup_fused
  from glt_tpu_torch.parallel import make_mesh, sage_loss
  from glt_tpu_torch.partition import RandomPartitioner

  fanouts = list(FANOUTS)
  with Phase('dist data'):
    t = [time.perf_counter()]
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    edges = {e: ei.cpu().numpy() for e, ei in
             igbh_edges(torch, IGBH_NODES, gen, dev).items()}
    feats, w = {}, torch.randn((IGBH_FEAT, IGBH_CLASSES), generator=gen,
                               device=dev)
    for tp, n in IGBH_NODES.items():
      x = torch.randn((n, IGBH_FEAT), generator=gen, device=dev)
      if tp == 'paper':   # learnable labels over the features as trained
        labels = torch.argmax(x.to(torch.bfloat16).float() @ w, 1).to(
            torch.int32).cpu().numpy()
      feats[tp] = x.cpu().numpy()
      del x
    train_idx, val_idx = split_indices(IGBH_NODES['paper'],
                                       random_seed=42 + seed)
    t.append(time.perf_counter())
    root = tempfile.mkdtemp(prefix='glt_dist_parts_')
    try:
      RandomPartitioner(root, num_parts=1, num_nodes=dict(IGBH_NODES),
                        edge_index=edges, node_feat=feats,
                        seed=seed).partition()
      t.append(time.perf_counter())
      disk = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(root) for f in fs)
      feat_bytes = sum(f.nbytes for f in feats.values())
      n_edges = sum(e.shape[1] for e in edges.values())
      del feats, edges
      mesh = make_mesh(device=dev)
      dg = DistHeteroGraph.from_dataset_partitions(mesh, root)
      torch.cuda.synchronize()
      t.append(time.perf_counter())
      dss = {0: DistDataset.load(root, 0, feature_dtype=torch.bfloat16,
                                   device=dev)}
      torch.cuda.synchronize()
      t.append(time.perf_counter())
      dfeats = {tp: DistFeature.from_dist_datasets(mesh, dss, ntype=tp,
                                                   dtype=torch.bfloat16)
                for tp in IGBH_NODES}
      del dss
      torch.cuda.synchronize()
      t.append(time.perf_counter())
    finally:
      shutil.rmtree(root, ignore_errors=True)
    secs = np.diff(t)
    store = sum(f.array.numel() * f.array.element_size()
                for f in dfeats.values())
    graph_bytes = sum(sum(getattr(st, f).numel() * getattr(st, f).element_size()
                          for f in ('indptr', 'indices', 'edge_ids',
                                    'local_row', 'node_pb'))
                      for st in dg.graphs.values())
    print(f'dist data: {n_edges} edges over {len(dg.graphs)} types, '
          f'{IGBH_NODES}; synthesised on the card and copied to the host '
          f'{secs[0]:.3f} s ({feat_bytes} B of float32 features); partitioned '
          f'(RandomPartitioner, one part) {secs[1]:.3f} s, {disk} B on disk; '
          f'DistHeteroGraph {secs[2]:.3f} s ({graph_bytes} B on the card); '
          f'DistDataset.load (bf16 Feature) {secs[3]:.3f} s; '
          f'DistFeature.from_dist_datasets {secs[4]:.3f} s ({store} B of '
          f'bf16 rows on the card); {train_idx.size} training and '
          f'{val_idx.size} validation papers (split_indices)')

    sampler = DistHeteroNeighborSampler(dg, fanouts, seed=seed)
    keys = sampler.message_passing_types(HTRAIN_BATCH, 'paper')
    shapes = sampler.uniform_shapes(HTRAIN_BATCH, 'paper')
    b2_per_step = sum(len(h) for h in shapes)

    def trainer():
      torch.manual_seed(seed)
      model = RGNN(keys, IGBH_FEAT, IGBH_HIDDEN, IGBH_CLASSES,
                   num_layers=len(fanouts), conv='rgat', heads=IGBH_HEADS,
                   node_types=list(IGBH_NODES)).to(dev)
      return DistHeteroTrainStep(dg, dfeats, model, {'paper': labels},
                                 fanouts, HTRAIN_BATCH, 'paper', lr=LR,
                                 seed=seed)
    rng = np.random.default_rng(seed + 21)
    ugen = torch.Generator(device=dev).manual_seed(seed + 22)

    def window(t_=DIST_K):
      """Seeds [t, 64] from the training split, the last batch ragged,
      and their uniforms per hop and segment [t, 1, S, K]."""
      seeds = rng.choice(train_idx, (t_, HTRAIN_BATCH))
      nv = np.full((t_, 1), HTRAIN_BATCH)
      nv[-1] = HTRAIN_BATCH - 5
      u = [[torch.rand((t_, 1) + s, generator=ugen, device=dev)
            for s in hop] for hop in shapes]
      return seeds, nv, u
    print(f'dist: message-passing keys {[e[1] for e in keys]}; segments a '
          f'step (hop: [world * F, fanout]) {shapes}')

  with Phase('dist kernel checks'):
    # one batch's B2 hops, K3 serves and dedups, recorded through the plain
    # versions (which leave each input as the kernels would)
    hops, gathers, dedups = [], [], []

    def record_hop(*a):
      hops.append(a)
      return K.sample_hop_plain(*a)

    def record_gather(table, r):
      gathers.append((table, r))
      return K.gather_rows_plain(table, r)
    step = trainer()
    seeds, nv, u = window(1)
    s0 = torch.as_tensor(seeds[0], device=dev, dtype=torch.int32)
    n0 = torch.tensor(int(nv[0, 0]), device=dev, dtype=torch.int32)
    u0 = [[x[0, 0] for x in hop] for hop in u]
    real_hop, real_gather = K.sample_hop, K.gather_rows
    K.sample_hop, K.gather_rows = record_hop, record_gather
    try:
      with torch.no_grad(), recorded_dedups(torch, dedups):
        batch = step.make_batch(s0, n0, u0)
    finally:
      K.sample_hop, K.gather_rows = real_hop, real_gather
    if (len(hops), len(gathers)) != (b2_per_step, len(IGBH_NODES)):
      raise AssertionError(f'{len(hops)} B2 hops and {len(gathers)} K3 '
                           f'serves in a batch, expected {b2_per_step} and '
                           f'{len(IGBH_NODES)}')
    row = time_picks(torch, np, K, 'dist batch', hops)
    rows['sample_hop']['shapes'] = {
        f'dist batch ({b2_per_step} hops)': row}
    names = list(batch.node_dict)
    for tp, (table, r) in zip(names, gathers):
      k3[f'dist bfloat16 x 1024 {tp}'] = time_gather(
          torch, np, K, f'dist bfloat16 x 1024 {tp}', table, r)
    time_dedup(torch, np, 'dist batch', dedups)
    # the static-shape dedup of the largest hop inside a CUDA graph
    big = max(dedups, key=lambda a: a[3].numel())
    real_dedup = sorted_hop_dedup_fused
    eager = real_dedup(*big)
    static = [x.clone() if isinstance(x, torch.Tensor) else x for x in big]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
      real_dedup(*static)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
      captured = real_dedup(*static)
    graph.replay()
    torch.cuda.synchronize()
    for key, v in eager.items():
      if not torch.equal(captured[key], v):
        raise AssertionError(f'the captured dedup differs from eager: {key}')
    d_eager = cuda_ms(torch, lambda i=0: real_dedup(*big), 20)
    d_graph = graph_ms(torch, lambda: real_dedup(*static), calls=10)
    print(f'sorted_hop_dedup_fused over {big[3].numel()} lanes against a '
          f'seen-set of {big[0].numel()}: captured in a CUDA graph and '
          f'replayed, equal to eager on every output ({int(eager["new_count"])}'
          f' new ids); {d_eager:.4f} ms back to back, {d_graph:.4f} ms in a '
          'CUDA graph')
    del hops, gathers, dedups, batch, step, big, eager, static, captured, graph

  with Phase('dist main path'):
    step = trainer()
    order = rng.permutation(train_idx)

    def batch_seeds(i):
      return order[i * HTRAIN_BATCH:(i + 1) * HTRAIN_BATCH][None]
    one = np.ones(1, np.int64) * HTRAIN_BATCH
    for i in range(DIST_WARMUP):
      step(batch_seeds(i), one)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for i in range(DIST_WARMUP, DIST_WARMUP + DIST_STEPS):
      losses.append(step(batch_seeds(i), one))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / DIST_STEPS
    dist_launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    peak = torch.cuda.max_memory_allocated() - base
    losses = [float(v) for v in losses]
    want = dict(sample_hop=b2_per_step * DIST_STEPS,
                gather_rows=len(IGBH_NODES) * DIST_STEPS)
    for n, v in want.items():
      if dist_launches[n] != v:
        raise AssertionError(f'{n}: {dist_launches[n]} launches over '
                             f'{DIST_STEPS} steps, expected {v}')
    if not np.isfinite(losses).all():
      raise AssertionError(f'dist training: non-finite loss {losses}')
    wall, busy = profile_stages(
        torch, lambda: [step(batch_seeds(i), one) for i in range(2)], 2,
        (), 'step')
    correct = total = want_total = 0
    for b in range(DIST_EVAL):
      # the validation split in batches, the last padded (examples/igbh)
      chunk = val_idx[b * HTRAIN_BATCH:(b + 1) * HTRAIN_BATCH]
      want_total += chunk.size
      c, n = step.eval_step(
          np.resize(chunk, HTRAIN_BATCH)[None], np.array([chunk.size]))
      correct, total = correct + c, total + n
    if total != want_total:
      raise AssertionError(f'eval counted {total} seeds of {want_total}')
    print(f'dist training (one rank, batch {HTRAIN_BATCH}, {fanouts}): '
          f'{DIST_STEPS} steps after {DIST_WARMUP} warm-up, {ms:.3f} ms a '
          f'step, {HTRAIN_BATCH / ms * 1e3:.1f} seeds/s; device busy '
          f'{busy / wall * 100:.1f}% over 2 profiled steps ({wall:.3f} ms '
          f'wall, {busy:.3f} busy); peak {peak / 2**30:.3f} GiB above '
          f'{base / 2**30:.3f} GiB resident; losses '
          + ', '.join(f'{v:.4f}' for v in losses)
          + f'; eval {correct}/{total}; launches {dist_launches} ('
          f'{b2_per_step} B2 and {len(IGBH_NODES)} K3 a step); on {smi}')

  with Phase('dist main path vs plain'):
    seeds, nv, u = window(1)
    s0 = torch.as_tensor(seeds[0], device=dev, dtype=torch.int32)
    n0 = torch.tensor(int(nv[0, 0]), device=dev, dtype=torch.int32)
    u0 = [[x[0, 0] for x in hop] for hop in u]
    with torch.no_grad():
      bk = step.make_batch(s0, n0, u0)
      lk = float(sage_loss(step.model, bk))
      with swapped_to_plain(K, ('sample_hop', 'gather_rows')):
        bp = step.make_batch(s0, n0, u0)
        lp = float(sage_loss(step.model, bp))
    f = differing_field(torch, bk, bp, DIST_FIELDS)
    if f is not None:
      raise AssertionError(f'dist batch.{f} differs between kernels and plain')
    if not abs(lk - lp) <= LOSS_TOL * max(1.0, abs(lp)):
      raise AssertionError(f'dist loss {lk} vs plain {lp}')
    print(f'dist batch {HTRAIN_BATCH} ({int(n0)} real seeds): samples and '
          f'rows bit-identical ('
          f'{sum(int(c) for c in bk.node_count_dict.values())} nodes, '
          f'{sum(int(m.sum()) for m in bk.edge_mask_dict.values())} edges), '
          f'loss {lk:.6f} vs plain {lp:.6f} (|diff| {abs(lk - lp):.3e}, '
          f'tolerance {LOSS_TOL})')
    del bk, bp, step
    torch.cuda.empty_cache()

  with Phase('dist superstep'):
    wins = [window() for _ in range(2)]
    # the per-batch engine first: its cached blocks and a captured window's
    # pool (each about one body's peak) may not fit the card together
    b = trainer()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    per_batch, ms_b = [], []
    for seeds, nv, u in wins:
      t0 = time.perf_counter()
      per_batch.append(torch.stack([
          b(seeds[t_], nv[t_], [[x[t_] for x in hop] for hop in u])
          for t_ in range(DIST_K)]))
      torch.cuda.synchronize()
      ms_b.append((time.perf_counter() - t0) * 1e3 / DIST_K)
    peak_b = torch.cuda.max_memory_allocated() - base
    seeds, nv, u = wins[1]
    wall_b, busy_b = profile_stages(torch, lambda: [
        b(seeds[t_], nv[t_], [[x[t_] for x in hop] for hop in u])
        for t_ in range(2)], 2, (), 'step')
    del b
    torch.cuda.empty_cache()
    a = trainer()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    fused, ms_a = [], []
    for seeds, nv, u in wins:
      t0 = time.perf_counter()
      fused.append(a.superstep(seeds, nv, u))
      torch.cuda.synchronize()
      ms_a.append((time.perf_counter() - t0) * 1e3 / DIST_K)
    peak_a = torch.cuda.max_memory_allocated() - base
    eager, replayed, launches = path_launches(K, a)
    got, want = torch.cat(fused).cpu(), torch.cat(per_batch).cpu()
    diffs = (got - want).abs()
    first = float(diffs[0])
    diff = float(diffs.max())
    if (a.superstep_captures, a.graph_replays) != (1, 1) or not (
        first <= FIRST_LOSS_TOL and diff <= EPOCH_LOSS_TOL):
      raise AssertionError(f'dist superstep: captures {a.superstep_captures},'
                           f' replays {a.graph_replays}, losses differ from '
                           f'per-batch by {first} first, {diff} at most')
    for n, per in (('sample_hop', b2_per_step),
                   ('gather_rows', len(IGBH_NODES))):
      if (eager[n], replayed.get(n, 0)) != (per * DIST_K, per * DIST_K):
        raise AssertionError(f'{n}: {eager[n]} eager and '
                             f'{replayed.get(n, 0)} replayed launches')
    seeds, nv, u = wins[1]
    wall_a, busy_a = profile_stages(torch, lambda: a.superstep(seeds, nv, u),
                                    DIST_K, (), 'step')
    free, total_mem = torch.cuda.mem_get_info(dev)
    print_windows(a)
    print(f'dist superstep, windows of {DIST_K}: the first eager and '
          f'captured ({a.capture_seconds[0] * 1e3:.1f} ms to capture), the '
          f'second a replay; captures {a.superstep_captures}, replays '
          f'{a.graph_replays} (the last one profiled); ms a step: superstep '
          f'{ms_a[1]:.3f} '
          f'(the first window {ms_a[0]:.3f}), per-batch {ms_b[1]:.3f} '
          f'({ms_b[0]:.3f}), {ms_b[1] / ms_a[1]:.3f}x; busy superstep '
          f'{busy_a / wall_a * 100:.1f}%, per-batch '
          f'{busy_b / wall_b * 100:.1f}%; peak superstep '
          f'{peak_a / 2**30:.3f} GiB, per-batch {peak_b / 2**30:.3f} GiB; '
          f'{free / 2**30:.3f} of {total_mem / 2**30:.3f} GiB free with the '
          f'graph held, so the engines ran one after the other on the same '
          f'seeds and uniforms; losses against per-batch: first step '
          f'{first:.3e} (tolerance {FIRST_LOSS_TOL}), at most {diff:.3e} '
          f'(tolerance {EPOCH_LOSS_TOL}); launches {launches}: eager {eager},'
          f' by graph replays {replayed}; on {smi}')
    ss_launches = (launches, replayed)
    del a, dfeats, dg
    torch.cuda.empty_cache()
  return dist_launches, ss_launches


def path_launches(K, step):
  """A superstep path's launches by wrapper name since the last reset:
  those run eagerly (the wrappers' counts), those the trainer's graph
  replays made, and their sum."""
  eager = {fn.__name__: fn.launches for fn in K.KERNELS}
  replayed = step.graph_launches()
  return eager, replayed, {n: v + replayed.get(n, 0)
                           for n, v in eager.items()}


def print_windows(step):
  """Each captured window of ``step``: the launches recorded in its graph
  and its replays."""
  for (kind, t), w in step.windows.items():
    rec = {n: v for n, v in w.recorded.items() if v}
    print(f'  {kind} window of {t}: recorded {rec}, replayed {w.replays} '
          'times')


def stream_parts(torch, np, K, step, store, win, dev):
  """One cold-streaming window of ``step`` timed whole (sample, stage,
  consume, unpipelined) and its host-side parts timed apart: the walks
  and the read-back of their nodes, the host gather of the cold rows,
  their pageable copy to the card, and a device copy of the same bytes
  (what filling the graph's static buffer costs)."""
  from glt_tpu_torch.ops.pipeline import multihop_sample_many
  seeds, nv, u = win
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  step.superstep(seeds, nv, u)
  torch.cuda.synchronize()
  whole = time.perf_counter() - t0
  s_dev = torch.as_tensor(seeds, device=dev, dtype=torch.int32)
  nv_dev = torch.as_tensor(nv[:, 0], device=dev, dtype=torch.int32)
  t = [time.perf_counter()]
  outs = multihop_sample_many(step._plan, s_dev, nv_dev, list(FANOUTS),
                              u_stack=[x[:, 0].contiguous() for x in u])
  nodes, counts = outs['node'].cpu(), outs['node_count'].cpu()
  t.append(time.perf_counter())
  cold = store.stage_cold_rows(nodes, counts[:, None])
  t.append(time.perf_counter())
  cold_dev = torch.as_tensor(cold).to(dev)
  torch.cuda.synchronize()
  t.append(time.perf_counter())
  buf = torch.empty_like(cold_dev)
  torch.cuda.synchronize()
  t.append(time.perf_counter())
  buf.copy_(cold_dev)
  torch.cuda.synchronize()
  t.append(time.perf_counter())
  parts = dict(zip(('sample_and_read_back', 'host_gather', 'to_card',
                    'static_copy'), np.diff(t)[[0, 1, 2, 4]] * 1e3))
  print(f'cold streaming, one window of {seeds.shape[0]} unpipelined: '
        f'{whole * 1e3:.1f} ms ({whole * 1e3 / seeds.shape[0]:.1f} ms a '
        f'step); its parts timed apart (ms): '
        + ', '.join(f'{k} {v:.1f}' for k, v in parts.items())
        + f'; the staged block {tuple(cold.shape)} {cold.dtype} '
        f'({cold.nbytes / 2**30:.2f} GiB)')
  del outs, cold, cold_dev, buf


# hetero link prediction: examples/hetero/bipartite_sage_unsup.py at
# Taobao's counts (its TAOBAO) and the upstream Taobao example's batch
# (2,048 links with one binary negative each: 4,096 seeds of either
# type), [8, 4], RGNN rsage 32 -> 64 -> 32, Adam 3e-3; AUC over a few
# test batches
HLINK_BATCH, HLINK_WARMUP, HLINK_STEPS, HLINK_EVAL = 2048, 2, 10, 4
HLINK_SWAPPED = ('dedup_table_init', 'dedup_table_init_types',
                 'sample_hop_dedup', 'gather_rows')
HLINK_FIELDS = ('node_dict', 'node_count_dict', 'row_dict', 'col_dict',
                'edge_mask_dict', 'x_dict', 'num_sampled_nodes',
                'num_sampled_edges')
# HGT: examples/hetero/train_hgt_mag.py at ogbn-mag's counts
# (examples/common.py MAG_COUNTS), hidden 64, 2 heads, 2 layers, batch 128
HGT_WARMUP, HGT_STEPS = 2, 10


def device_bytes(tensors):
  """Bytes of the distinct storages among ``tensors``."""
  seen = {}
  for t in tensors:
    if t is not None:
      seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
  return sum(seen.values())


def graph_bytes(ds):
  return device_bytes([x for g in ds.graph.values() for x in (
      g.indptr, g.indptr_pad, g.indices, g.edge_ids, g.topo.indptr)])


def timed_steps(torch, np, K, label, it, step, n_steps, warmup, per_step,
                pairs, smi):
  """``n_steps`` training steps over ``it`` (each ending in a device sync;
  host clock), every kernel's launches a step held to ``per_step``; prints
  the losses, the timed steps' ms, ``pairs`` a step per second (labelled
  pairs or seeds), sampled edges/s and the peak; returns (launches by
  kernel, median ms, the last batch)."""
  from glt_tpu_torch.utils.profile import ThroughputMeter
  torch.cuda.synchronize()
  resident = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  K.reset_launch_counts()
  losses, secs, edges = [], [], []
  for i in range(n_steps):
    before = {n: getattr(K, n).launches for n in per_step}
    t0 = time.perf_counter()
    b = next(it)
    losses.append(step(b))
    n_edges = sum(v.sum() for v in b.num_sampled_edges.values())
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
    edges.append(n_edges)
    for n, want in per_step.items():
      if getattr(K, n).launches - before[n] != want:
        raise AssertionError(
            f'{label} step {i}: {getattr(K, n).launches - before[n]} {n} '
            f'launches, expected {want}')
  launches = {fn.__name__: fn.launches for fn in K.KERNELS}
  peak = torch.cuda.max_memory_allocated()
  losses = [float(v) for v in losses]
  if not all(np.isfinite(losses)):
    raise AssertionError(f'{label}: non-finite loss {losses}')
  timed = np.array(secs[warmup:]) * 1e3
  n_timed = sum(int(e) for e in edges[warmup:])
  meter = ThroughputMeter('edges')
  meter.update(n_timed, timed.sum() / 1e3)
  median = float(np.median(timed))
  rate = pairs * (n_steps - warmup) / timed.sum() * 1e3
  print(f'{label}: {len(losses)} steps, losses '
        + ', '.join(f'{v:.4f}' for v in losses))
  print(f'{label} steps {warmup + 1}-{n_steps}: median {median:.3f} ms a '
        f'step (quartiles {np.percentile(timed, 25):.3f}-'
        f'{np.percentile(timed, 75):.3f}, min {timed.min():.3f}, max '
        f'{timed.max():.3f}); {rate:.1f} '
        f'{"labelled pairs" if "link" in label else "seeds"}/s, '
        f'{meter.rate:.1f} valid sampled edges/s ({meter.report()}, '
        f'{n_timed / (n_steps - warmup):.0f} a step); warm-up steps '
        + ', '.join(f'{v * 1e3:.3f}' for v in secs[:warmup])
        + f' ms; on {smi}')
  print(f'{label} launches {launches}; resident before '
        f'{resident / 2**30:.3f} GiB, peak memory {peak / 2**30:.3f} GiB '
        f'({peak} bytes)')
  return launches, median, b


def profile_steps(torch, step_fn, it, label, median):
  """profile_stages over 2 synced steps of ``step_fn`` (a SageTrainStep
  with ``sync_stages``) after one warm step."""
  step_fn(next(it))

  def run():
    for _ in range(2):
      step_fn(next(it))
  step_stages = ('train.forward', 'train.backward', 'train.optimizer')
  wall, busy = profile_stages(
      torch, run, 2, ('sample.multihop', 'gather.features') + step_stages,
      'step', host_stages=step_stages)
  print(f'{label} profile: device busy {busy:.3f} ms a step is '
        f'{busy / median * 100:.1f}% of the unsynchronised median step '
        f'({median:.3f} ms)')


def hetero_link_phases(torch, np, K, dev, seed, rows, k3, host_us, smi):
  """Hetero link prediction (examples/hetero/bipartite_sage_unsup.py) over
  a Taobao-shaped graph drawn on the card; returns its launches."""
  from glt_tpu_torch.examples.hetero import bipartite_sage_unsup as bp
  from glt_tpu_torch.ops.negative import negative_proposals
  from glt_tpu_torch.parallel import SageTrainStep, link_bce_loss
  from glt_tpu_torch.sampler import EdgeSamplerInput

  with Phase('hetero link data'):
    secs = {}

    def stage(name, fn):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      out = fn()
      torch.cuda.synchronize()
      secs[name] = time.perf_counter() - t0
      return out
    ui, ii, nu, ni = stage('draw', lambda: bp.taobao_graph(
        seed=seed, device=dev, **bp.TAOBAO))
    drawn = device_bytes([ui, ii])
    train, test = stage('split', lambda: bp.link_split(ui, seed + 1))
    del ui
    gen = torch.Generator(device=dev).manual_seed(seed + 22)
    feats = stage('features', lambda: {
        t: torch.randn((n, bp.FEAT), generator=gen, device=dev)
        for t, n in (('user', nu), ('item', ni))})
    ds = stage('dataset', lambda: bp.build_dataset(train, ii, nu, ni, feats,
                                                   device=dev))
    n_ii = ii.shape[1]
    del ii, feats
    loader = stage('loaders', lambda: bp.link_loader(
        ds, train, HLINK_BATCH, seed, device=dev, shuffle=True))
    eval_loader = bp.link_loader(ds, test, HLINK_BATCH, seed + 3, device=dev)
    n_train, n_test = train.shape[1], test.shape[1]
    del train, test
    torch.cuda.empty_cache()
    fbytes = sum(ds.get_node_feature(t).table.numel() * 4
                 for t in ('user', 'item'))
    print(f'taobao graph: {nu} users, {ni} items in '
          f'{bp.TAOBAO["num_groups"]} categories; {n_train + n_test} '
          f'user-item links ({n_train} train, {n_test} test) and their '
          f'reverse, {n_ii} item-item; ' + ', '.join(
              f'{e[1]} {ds.get_graph(e).num_edges}' for e in ds.graph)
          + f'; features float32 x {bp.FEAT}')
    print('taobao data seconds: ' + ', '.join(
        f'{k} {v:.3f}' for k, v in secs.items())
          + f'; bytes: drawn edges {drawn}, graph on the card '
          f'{graph_bytes(ds)}, features {fbytes}, the flat edge plane '
          f'{device_bytes([loader.sampler._hetero_plan.indices_flat])}, '
          f'host seed edges {loader.edge_rows.nbytes * 2} + '
          f'{eval_loader.edge_rows.nbytes * 2}')

  with Phase('hetero link kernel checks'):
    sampler = loader.sampler
    rng = np.random.default_rng(seed + 23)
    pos = rng.integers(0, loader.edge_rows.shape[0], HLINK_BATCH)
    g_u2i = ds.get_graph(bp.U2I).topo
    props = negative_proposals(sampler.generator, HLINK_BATCH, 5,
                               g_u2i.num_rows, g_u2i.num_cols, dev)
    sizes = {'user': 2 * HLINK_BATCH, 'item': 2 * HLINK_BATCH}
    u = sampler.hop_uniforms(sizes)
    inputs = EdgeSamplerInput(loader.edge_rows[pos], loader.edge_cols[pos],
                              input_type=bp.U2I,
                              neg_sampling=loader.neg_sampling)
    hops, inits, out = recorded_hetero_sample(
        K, lambda: sampler.sample_from_edges(inputs, proposals=props,
                                             uniforms=u))
    if [n for n, _ in inits] != ['dedup_table_init_types']:
      raise AssertionError(f'a two-type link batch seeded by {inits}')
    slots, caps, budgets, _ = sampler._hetero_geometry(sizes)
    print(f'taobao link batch: {HLINK_BATCH} positives, {HLINK_BATCH} '
          f'binary negatives, seeds {sizes}, budgets {budgets}, table '
          f'{slots} slots; {sum(int(c) for c in out.node_count.values())} '
          f'nodes, ' + ', '.join(f'{e[1]} {int(m.sum())}'
                                 for e, m in out.edge_mask.items())
          + ' sampled edges')
    k2 = rows['dedup_table_insert'].setdefault('shapes', {})
    k2['init_types taobao link batch'] = time_table_init_types(
        torch, np, K, inits[0][1], host_us)
    rows['sample_hop_dedup'].setdefault('shapes', {})[
        'taobao link batch'] = time_hops(torch, K, hops, host_us,
                                         'taobao link batch')
    for t in ('user', 'item'):
      k3[f'float32 x 32 {t} (taobao link)'] = time_gather(
          torch, np, K, f'float32 x 32 {t} (taobao link)',
          ds.get_node_feature(t).table, out.node[t])
    del hops, inits, out

  with Phase('hetero link main path'):
    torch.manual_seed(seed)
    net = bp.make_model(dev)
    bk, bpl = link_batch_vs_plain(torch, K, loader, 'taobao', props, u, pos,
                                  names=HLINK_SWAPPED, fields=HLINK_FIELDS)
    with torch.no_grad():
      lk, lp = (float(link_bce_loss(net, b)) for b in (bk, bpl))
    if not abs(lk - lp) <= LOSS_TOL:
      raise AssertionError(f'taobao link loss {lk} against plain {lp}')
    print(f'taobao link batch: bit-identical between the kernels and the '
          f'plain versions on every field and label; loss {lk:.6f}, plain '
          f'{lp:.6f} (|diff| {abs(lk - lp):.3e}, tolerance {LOSS_TOL})')
    del bk, bpl
    step = SageTrainStep(net, lr=bp.LR, loss=link_bce_loss)
    it = iter(loader)
    launches, median, b = timed_steps(
        torch, np, K, 'taobao link training', it, step,
        HLINK_WARMUP + HLINK_STEPS, HLINK_WARMUP,
        dict(dedup_table_insert=1, sample_hop_dedup=2, gather_rows=2,
             sample_walk_dedup=0, sample_hop=0, gather_windows=0),
        2 * HLINK_BATCH, smi)
    if tuple(b.metadata['edge_label_index'].shape) != (2, 2 * HLINK_BATCH):
      raise AssertionError('a taobao batch is not 4,096 labelled pairs')
    del b

  with Phase('hetero link profile'):
    profile_steps(torch, SageTrainStep(net, lr=bp.LR, loss=link_bce_loss,
                                       sync_stages=True), it, 'taobao link',
                  median)
    auc = bp.evaluate(net, eval_loader, HLINK_EVAL)
    if not 0 <= auc <= 1:
      raise AssertionError(f'taobao AUC {auc}')
    print(f'taobao link: test AUC {auc:.4f} over {HLINK_EVAL} batches of '
          f'{HLINK_BATCH} held-out links and as many negatives, after '
          f'{HLINK_WARMUP + HLINK_STEPS + 3} steps (not gated)')
  return launches


def hgt_phases(torch, np, K, dev, seed, rows, k3, host_us, smi):
  """HGT training (examples/hetero/train_hgt_mag.py) over an
  ogbn-mag-shaped graph; returns its launches."""
  from glt_tpu_torch.examples.common import MAG_COUNTS, synthetic_hetero_mag
  from glt_tpu_torch.examples.hetero import train_hgt_mag as hgt
  from glt_tpu_torch.loader import NeighborLoader
  from glt_tpu_torch.parallel import SageTrainStep, sage_loss
  from glt_tpu_torch.sampler.base import NodeSamplerInput

  n_papers = MAG_COUNTS['num_papers']
  with Phase('hgt data'):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds, classes, cites, writes = synthetic_hetero_mag(seed=seed, device=dev,
                                                      **MAG_COUNTS)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    loader = NeighborLoader(ds, {cites: hgt.FANOUTS, writes: hgt.FANOUTS},
                            ('paper', np.arange(n_papers)),
                            batch_size=hgt.BATCH, shuffle=True, seed=seed,
                            device=dev, rng=np.random.default_rng(seed))
    fbytes = sum(ds.get_node_feature(t).table.numel() * 4
                 for t in ('paper', 'author'))
    print(f'mag graph: {n_papers} papers, {MAG_COUNTS["num_authors"]} '
          f'authors, ' + ', '.join(f'{e[1]} {ds.get_graph(e).num_edges}'
                                   for e in ds.graph)
          + f'; features float32 x {MAG_COUNTS["feat_dim"]}, {classes} '
          f'classes; {data_s:.3f} s (numpy draws, the CSRs on the card); '
          f'graph {graph_bytes(ds)} B, features {fbytes} B on the card')

  with Phase('hgt kernel checks'):
    sampler = loader.sampler
    seeds = np.random.default_rng(seed + 24).choice(n_papers, hgt.BATCH,
                                                    replace=False)
    u = sampler.hop_uniforms(hgt.BATCH, 'paper')
    inp = NodeSamplerInput(seeds, 'paper')
    hops, inits, out = recorded_hetero_sample(
        K, lambda: sampler.sample_from_nodes(inp, uniforms=u))
    if [n for n, _ in inits] != ['dedup_table_init']:
      raise AssertionError(f'a paper batch seeded by {inits}')
    print(f'mag batch: {hgt.BATCH} papers, nodes '
          f'{ {t: int(c) for t, c in out.node_count.items()} }, edges '
          f'{ {e[1]: int(m.sum()) for e, m in out.edge_mask.items()} }, '
          f'author budget {out.node["author"].numel()}')
    rows['dedup_table_insert'].setdefault('shapes', {})[
        'init mag batch'] = time_table_init(torch, K, inits[0][1], host_us)
    rows['sample_hop_dedup'].setdefault('shapes', {})['mag batch'] = \
        time_hops(torch, K, hops, host_us, 'mag batch')
    # 512-byte rows: the two-pass width of PERF.md's open question
    k3['float32 x 128 paper (mag)'] = time_gather(
        torch, np, K, 'float32 x 128 paper (mag)',
        ds.get_node_feature('paper').table, out.node['paper'])
    del hops, inits, out

  with Phase('hgt main path'):
    torch.manual_seed(seed)
    net = hgt.make_model(ds, classes, cites, writes, device=dev)

    def batch():
      return loader._collate(sampler.sample_from_nodes(inp, uniforms=u),
                             seeds, hgt.BATCH)
    bk = batch()
    with swapped_to_plain(K, HLINK_SWAPPED):
      bpl = batch()
    f = differing_field(torch, bk, bpl, HETERO_BATCH_FIELDS)
    if f is not None:
      raise AssertionError(f'mag batch.{f} differs between kernels and '
                           'plain')
    if set(bk.row_dict) != {cites} or bk.x_dict['author'].shape[0] != 1:
      raise AssertionError('a paper-seeded mag batch reached an author')
    with torch.no_grad():
      lk, lp = (float(sage_loss(net, b)) for b in (bk, bpl))
    if not (np.isfinite(lk) and abs(lk - lp) <= LOSS_TOL):
      raise AssertionError(f'mag HGT loss {lk} against plain {lp}')
    print(f'mag batch: bit-identical between the kernels and the plain '
          f'versions on every field; HGT loss {lk:.6f}, plain {lp:.6f} '
          f'(|diff| {abs(lk - lp):.3e}, tolerance {LOSS_TOL}); one padded '
          f'author row, no rev_writes edge')
    del bk, bpl
    step = SageTrainStep(net, lr=hgt.LR)
    it = iter(loader)
    launches, median, _ = timed_steps(
        torch, np, K, 'mag hgt training', it, step, HGT_WARMUP + HGT_STEPS,
        HGT_WARMUP,
        dict(dedup_table_insert=1, sample_hop_dedup=2, gather_rows=2,
             sample_walk_dedup=0, sample_hop=0, gather_windows=0),
        hgt.BATCH, smi)

  with Phase('hgt profile'):
    profile_steps(torch, SageTrainStep(net, lr=hgt.LR, sync_stages=True), it,
                  'mag hgt', median)
  return launches


def main() -> int:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--seed', type=int, default=0,
                  help='seed of the graphs, features, weights and requests')
  opts = ap.parse_args()
  import numpy as np
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 1
  from glt_tpu_torch.benchmarks import microbench_gather, probe_compile
  from glt_tpu_torch.data import Dataset
  from glt_tpu_torch.models import RGNN, GraphSAGE
  from glt_tpu_torch.ops import build
  from glt_tpu_torch.ops import cuda_kernels as K
  from glt_tpu_torch.ops import probe_kernels as P
  from glt_tpu_torch.sampler.base import NodeSamplerInput
  from glt_tpu_torch.serving import InferenceEngine

  dev = torch.device('cuda', 0)
  torch.cuda.set_device(dev)
  torch.backends.cuda.matmul.allow_tf32 = False   # float32 throughout
  torch.backends.cudnn.allow_tf32 = False

  with Phase('device'):
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')

  with Phase('build'):
    for name, path in build.build_all().items():
      with open(path + '.log') as f:
        log = f.read().splitlines()
      regs = [ln.split('Used ')[1].split(',')[0] for ln in log
              if 'registers' in ln]
      spills = [ln.strip() for ln in log if 'spill' in ln
                and ' 0 bytes spill stores, 0 bytes spill loads' not in ln]
      stacks = sorted({ln.split(':')[-1].strip().split(',')[0] for ln in log
                       if 'stack frame' in ln})
      print(f'built {name}: kernels of {", ".join(regs)}; stack frames '
            f'{", ".join(stacks)}; '
            + ('; '.join(spills) if spills else 'no spills'))
    for name in build.SOURCES:
      build.kernel_library(name)

  with Phase('data'):
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    # out-degrees ~Poisson(25) (products' mean); in-degrees skewed by a
    # squared-uniform draw, as bench.py builds its graph
    src = torch.randint(0, NUM_NODES, (NUM_EDGES,), generator=gen,
                        device=dev)
    dst = (torch.rand(NUM_EDGES, generator=gen, device=dev) ** 2
           * NUM_NODES).long() % NUM_NODES
    # edge weights in (0, 1] for weighted training, from their own stream
    wgen = torch.Generator(device=dev).manual_seed(opts.seed + 6)
    weights = 1.0 - torch.rand(NUM_EDGES, generator=wgen, device=dev)
    ds = Dataset().init_graph(torch.stack([src, dst]), edge_weights=weights,
                              num_nodes=NUM_NODES)
    del src, dst, weights
    ds.init_node_features(torch.randn((NUM_NODES, FEAT_DIM), generator=gen,
                                      device=dev))
    engine = InferenceEngine(
        ds, GraphSAGE(FEAT_DIM, HIDDEN, CLASSES, num_layers=3), None,
        list(FANOUTS), buckets=BUCKETS, seed=0)
    engine.init_params(opts.seed)
    g = ds.get_graph()
    torch.cuda.synchronize()
    print(f'graph: {g.num_nodes} nodes, {g.num_edges} edges, max degree '
          f'{g.topo.max_degree}; features {tuple(ds.get_node_feature().shape)}')

  rows = {}
  with Phase('kernel checks'):
    seeds_np = torch.randint(0, NUM_NODES, (1024,), generator=gen,
                             device=dev)
    host_us = lambda fns: in_turns_host_us(torch, np, fns)
    walk = {b: time_walk(torch, K, g, seeds_np[:b], FANOUTS, gen, host_us)
            for b in (256, 1024)}
    rows['sample_walk_dedup'] = walk[256]

    # gather_rows: bucket 256's node list (234,496 rows) on the products
    # table, float32 and under Feature's bf16 cast (a 490 MB copy)
    seeds = seeds_np[:256].to(torch.int32)
    node = engine.sampler.sample_from_nodes(seeds).node
    table = ds.get_node_feature().table
    k3 = {'float32 x 100': time_gather(torch, np, K, 'float32 x 100',
                                       table, node)}
    rows['gather_rows'] = dict(k3['float32 x 100'], shapes=k3)
    half = table.to(torch.bfloat16)
    k3['bfloat16 x 100'] = time_gather(torch, np, K, 'bfloat16 x 100', half,
                                       node)
    del half

    # launches of one sample + gather at each batch size (the serving
    # bucket 256 and the training batch 1024), counted by the wrappers
    for b in (256, 1024):
      K.reset_launch_counts()
      out = engine.sampler.sample_from_nodes(seeds_np[:b])
      ds.get_node_feature().device_gather(out.node)
      torch.cuda.synchronize()
      per = {fn.__name__: fn.launches for fn in K.KERNELS}
      print(f'launches per sample + gather, batch {b}: {per}')
      if (per['sample_walk_dedup'], per['dedup_table_insert']) != (1, 0):
        raise AssertionError('a sample is not one walk launch')

  with Phase('main path'):
    engine.warmup()
    rng = torch.Generator().manual_seed(opts.seed + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    requests = serve_requests(torch, engine, NUM_NODES, CLASSES, rng,
                              check=per_request_launches(
                                  K, {'sample_walk_dedup': 1,
                                      'dedup_table_insert': 0}))
    homo_launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    for name in ('sample_walk_dedup', 'gather_rows'):
      if homo_launches[name] == 0:
        raise AssertionError(f'{name} never launched on the main path')
    print(f'launches {homo_launches}; cache hits {engine.cache.hits}; peak '
          f'memory {peak / 2**30:.3f} GiB')

  with Phase('main path vs plain'):
    # one bucket through the kernels and through the plain versions on
    # the card, same seeds and uniforms
    ids = requests[3]
    seeds = np.concatenate([ids, np.full(256 - ids.size, ids[0])])
    u = engine.sampler.hop_uniforms(256)
    with torch.no_grad():
      bk = engine.make_batch(seeds, ids.size, 256, uniforms=u)
      yk = engine.model(bk)
      bp, yp = plain_swapped(K, engine, ('sample_walk_dedup',
                                         'dedup_table_insert',
                                         'gather_rows'), seeds, ids.size, u)
    for f in ('node', 'node_count', 'row', 'col', 'edge_mask', 'x'):
      if not torch.equal(getattr(bk, f), getattr(bp, f)):
        raise AssertionError(f'batch.{f} differs between kernels and plain')
    diff = float((yk - yp).abs().max())
    if not torch.allclose(yk, yp, rtol=LOGIT_TOL, atol=LOGIT_TOL):
      raise AssertionError(f'logits differ from plain by {diff}')
    print(f'bucket 256: batch bit-identical, logits max |diff| {diff:.3e} '
          f'(tolerance {LOGIT_TOL})')

  with Phase('profile'):
    # 3 fresh requests of 256 ids (bucket 256)
    profile_requests(torch, engine, [
        torch.randint(0, NUM_NODES, (256,), generator=rng).numpy()
        for _ in range(3)])

  with Phase('hetero data'):
    hgen = torch.Generator(device=dev).manual_seed(opts.seed + 2)
    hds = Dataset().init_graph(igbh_edges(torch, IGBH_NODES, hgen, dev),
                               num_nodes=IGBH_NODES)
    hds.init_node_features({
        t: torch.randn((n, IGBH_FEAT), generator=hgen, device=dev)
        for t, n in IGBH_NODES.items()})
    etypes = hds.get_edge_types()
    hengine = InferenceEngine(
        hds, RGNN(etypes, IGBH_FEAT, IGBH_HIDDEN, IGBH_CLASSES, num_layers=3,
                  conv='rgat', heads=IGBH_HEADS),
        None, list(FANOUTS), buckets=BUCKETS, seed=opts.seed,
        input_type='paper')
    hengine.init_params(opts.seed)
    torch.cuda.synchronize()
    print('igbh-rgat graph: ' + ', '.join(
        f'{e[1]} {hds.get_graph(e).num_edges}' for e in etypes)
          + f'; nodes {IGBH_NODES}; features {IGBH_FEAT} float32, '
          f'{sum(IGBH_NODES.values()) * IGBH_FEAT * 4 / 2**30:.3f} GiB')

  with Phase('hetero kernel checks'):
    # the three hops of one bucket-256 request, their inputs recorded as
    # the pipeline hands them over
    hops, inits, hout = recorded_hetero_sample(
        K, lambda: hengine.sampler.sample_from_nodes(NodeSamplerInput(
            torch.randint(0, IGBH_NODES['paper'], (256,), generator=hgen,
                          device=dev).cpu().numpy(), 'paper')))
    if len(inits) != 1 or inits[0][0] != 'dedup_table_init':
      raise AssertionError(f'{len(inits)} table inits in one request')
    # K2: the seed phase of this request (igbh-rgat's table at bucket 256)
    rows['dedup_table_insert'] = time_table_init(torch, K, inits[0][1],
                                                 host_us)
    # K3 on the paper table (1024 float32) at this request's paper nodes
    k3['float32 x 1024'] = time_gather(
        torch, np, K, 'float32 x 1024',
        hds.get_node_feature('paper').table, hout.node['paper'])
    del hout
    rows['sample_hop_dedup'] = time_hops(torch, K, hops, host_us,
                                         'bucket-256 request')

  with Phase('hetero main path'):
    hengine.warmup()
    hrng = torch.Generator().manual_seed(opts.seed + 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    # one B1 launch a hop of a computed bucket, one K2 (its seeds)
    hrequests = serve_requests(
        torch, hengine, IGBH_NODES['paper'], IGBH_CLASSES, hrng,
        check=per_request_launches(K, {'sample_hop_dedup': len(FANOUTS),
                                       'dedup_table_insert': 1}))
    hetero_launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    for name in ('sample_hop_dedup', 'dedup_table_insert', 'gather_rows'):
      if hetero_launches[name] == 0:
        raise AssertionError(f'{name} never launched on the hetero path')
    print(f'launches {hetero_launches}; cache hits {hengine.cache.hits}; '
          f'peak memory {peak / 2**30:.3f} GiB')

  with Phase('hetero main path vs plain'):
    ids = hrequests[3]
    seeds = np.concatenate([ids, np.full(256 - ids.size, ids[0])])
    u = hengine.sampler.hop_uniforms(256, 'paper')
    with torch.no_grad():
      bk = hengine.make_batch(seeds, ids.size, 256, uniforms=u)
      yk = hengine.model(bk)
      bp, yp = plain_swapped(K, hengine, ('sample_hop_dedup',
                                          'dedup_table_init',
                                          'gather_rows'), seeds, ids.size, u)
    for f in ('node_dict', 'node_count_dict', 'row_dict', 'col_dict',
              'edge_mask_dict', 'x_dict'):
      a, b = getattr(bk, f), getattr(bp, f)
      if set(a) != set(b) or any(not torch.equal(a[t], b[t]) for t in a):
        raise AssertionError(f'batch.{f} differs between kernels and plain')
    diff = float((yk - yp).abs().max())
    if not torch.allclose(yk, yp, rtol=LOGIT_TOL, atol=LOGIT_TOL):
      raise AssertionError(f'hetero logits differ from plain by {diff}')
    print(f'igbh-rgat bucket 256: batch bit-identical ('
          f'{sum(int(c) for c in bk.node_count_dict.values())} nodes, '
          f'{sum(int(m.sum()) for m in bk.edge_mask_dict.values())} edges), '
          f'logits max |diff| {diff:.3e} (tolerance {LOGIT_TOL})')
    # a is a closure cell of main (the hetero check's timing lambda reads
    # it): it would keep the batch's feature dict alive to the end
    del bk, bp, yk, yp, a, b

  with Phase('hetero profile'):
    profile_requests(torch, hengine, [
        torch.randint(0, IGBH_NODES['paper'], (256,),
                      generator=hrng).numpy() for _ in range(3)])
  graphs, feats = hds.graph, hds.node_features
  del hengine, hds
  torch.cuda.empty_cache()
  htrain_launches, csc_launches = hetero_train_phases(
      torch, np, K, graphs, feats, ds, dev, opts.seed, k3, smi)
  del graphs, feats
  torch.cuda.empty_cache()

  stream_launches = stream_phases(torch, np, K, ds, dev, opts.seed, rows)
  torch.cuda.empty_cache()
  train_launches, uniform_launches = train_phases(torch, np, K, ds, dev,
                                                  opts.seed, rows, smi)
  torch.cuda.empty_cache()
  link_launches, sub_launches, seal_launches = link_phases(
      torch, np, K, ds, dev, opts.seed, k3, walk, host_us, smi)
  torch.cuda.empty_cache()
  split_launches, mixed = split_phases(torch, np, K, ds, dev, opts.seed, smi)
  torch.cuda.empty_cache()
  ss_paths = superstep_phases(torch, np, K, ds, dev, opts.seed, smi)
  torch.cuda.empty_cache()
  dist_launches, ss_paths['dist_hetero_superstep'] = dist_phases(
      torch, np, K, dev, opts.seed, k3, rows, smi)
  torch.cuda.empty_cache()
  hlink_launches = hetero_link_phases(torch, np, K, dev, opts.seed, rows, k3,
                                      host_us, smi)
  torch.cuda.empty_cache()
  hgt_launches = hgt_phases(torch, np, K, dev, opts.seed, rows, k3, host_us,
                            smi)
  torch.cuda.empty_cache()
  rows['sample_walk_dedup'] = dict(
      walk[256], shapes={f'B={b}' if isinstance(b, int) else b: row
                         for b, row in walk.items()})
  with Phase('repair checks'):
    repair = repair_checks(torch, np, K, ds, dev, opts.seed, host_us)
    guard_cost(torch, np, K)

  with Phase('probe kernel checks'):
    probe_checks(torch, np, P, dev, opts.seed, rows, host_us)

  def launches():
    return {fn.__name__: fn.launches for fn in K.KERNELS + P.KERNELS}

  with Phase('probe ladder'):
    K.reset_launch_counts()
    P.reset_launch_counts()
    rc = probe_compile.main(['--seed', str(opts.seed)])
    probe_launches = launches()
    if rc != 0:
      raise AssertionError('a rung of the probe ladder failed')
    for name in ('vmem_id', 'smem_scalar', 'dma_fixed', 'dma_dynamic',
                 'prefetch_grid', 'gather_windows', 'vt'):
      if probe_launches[name] == 0:
        raise AssertionError(f'{name} never launched on the probe ladder')
    print(f'launches {probe_launches}')

  with Phase('gather microbench'):
    K.reset_launch_counts()
    P.reset_launch_counts()
    microbench_gather.main(['--seed', str(opts.seed)])
    micro_launches = launches()
    for name in ('gather_rows', 'gather_windows', 'vmem_take'):
      if micro_launches[name] == 0:
        raise AssertionError(f'{name} never launched in the microbench')
    print(f'launches {micro_launches}')

  by_path = {'homogeneous': homo_launches, 'hetero': hetero_launches,
             'hetero_train': htrain_launches, 'csc': csc_launches,
             'stream': stream_launches, 'train': train_launches,
             'train_uniform': uniform_launches, 'link': link_launches,
             'subgraph': sub_launches, 'seal': seal_launches,
             'split': split_launches, 'dist_hetero': dist_launches,
             'hetero_link': hlink_launches, 'hgt': hgt_launches,
             **{p: v[0] for p, v in ss_paths.items()},
             'probe': probe_launches,
             'microbench': micro_launches}
  # row: (its wrapper, source, the TPU kernel it replaces)
  replaces = {
      'sample_walk_dedup': ('sample_walk_dedup',
                            'glt_tpu_torch/csrc/sample_walk_dedup.cu',
                            'glt_tpu/ops/pallas_kernels.py:998'),
      'dedup_table_insert': ('dedup_table_insert',
                             'glt_tpu_torch/csrc/dedup_table_insert.cu',
                             'glt_tpu/ops/pallas_kernels.py:588'),
      'gather_rows': (('gather_rows', 'gather_rows_mixed'),
                      'glt_tpu_torch/csrc/gather_rows.cu',
                      'glt_tpu/ops/pallas_kernels.py:236'),
      'sample_hop_dedup': ('sample_hop_dedup',
                           'glt_tpu_torch/csrc/sample_hop_dedup.cu',
                           'glt_tpu/ops/pallas_kernels.py:653'),
      'sample_hop': ('sample_hop', 'glt_tpu_torch/csrc/sample_hop.cu',
                     'glt_tpu/ops/pallas_kernels.py:367'),
      'gather_windows': ('gather_windows',
                         'glt_tpu_torch/csrc/gather_windows.cu',
                         'glt_tpu/ops/pallas_kernels.py:165'),
      'vmem_id': ('vmem_id', 'glt_tpu_torch/csrc/probes.cu',
                  'benchmarks/probe_pallas_compile.py:55'),
      'smem_scalar': ('smem_scalar', 'glt_tpu_torch/csrc/probes.cu',
                      'benchmarks/probe_pallas_compile.py:65'),
      'dma_fixed': ('dma_fixed', 'glt_tpu_torch/csrc/probes.cu',
                    'benchmarks/probe_pallas_compile.py:83'),
      'dma_dynamic': ('dma_dynamic', 'glt_tpu_torch/csrc/probes.cu',
                      'benchmarks/probe_pallas_compile.py:102'),
      'prefetch_grid': ('prefetch_grid', 'glt_tpu_torch/csrc/probes.cu',
                        'benchmarks/probe_pallas_compile.py:125'),
      'vt': ('vt', 'glt_tpu_torch/csrc/take2d.cu',
             'benchmarks/probe_pallas_compile.py:163'),
      'vmem_take': ('vmem_take', 'glt_tpu_torch/csrc/take2d.cu',
                    'benchmarks/microbench_pallas_gather.py:129'),
  }
  print(f'walk B=1024: {walk[1024]["ms"]:.4f} ms, in a CUDA graph '
        f'{walk[1024]["graph_ms"]:.4f} ms, host enqueue '
        f'{walk[1024]["host_us"]:.2f} us, plain {walk[1024]["plain_ms"]:.4f} '
        f'ms, bound {walk[1024]["bound_ms"]:.6f} ms')
  lw = walk['B=2048 link']
  print(f'walk B=2048 (link batch, seeds with repeats): {lw["ms"]:.4f} ms, '
        f'in a CUDA graph {lw["graph_ms"]:.4f} ms, host enqueue '
        f'{lw["host_us"]:.2f} us, plain {lw["plain_ms"]:.4f} ms, bound '
        f'{lw["bound_ms"]:.6f} ms')
  print('main-path launches: ' + '; '.join(
      f'{p} {v}' for p, v in by_path.items()))
  for name, row in repair.items():
    if name.startswith('gather_rows '):
      k3[name[len('gather_rows '):]] = row
      continue
    print(f'repair {name}: {row["ms"]:.4f} ms (plain {row["plain_ms"]:.4f}'
          f', bound {row["bound_ms"]:.6f} ms)')
  for shape, row in k3.items():
    print(f'gather_rows {shape}: {row["ms"]:.4f} ms, index_select '
          f'{row["library_ms"]:.4f} ms ({row["ms"] / row["library_ms"]:.3f}'
          f'x), plain {row["plain_ms"]:.4f} ms, bound {row["bound_ms"]:.6f} '
          f'ms ({row["bound_ms"] / row["ms"] * 100:.1f}% of it)'
          + (f'; in a CUDA graph {row["graph_ms"]:.4f} ms, index_select '
             f'{row["library_graph_ms"]:.4f} ms' if row['graph_ms'] else ''))
  for shape, row in mixed.items():
    print(f'gather_rows_mixed {shape}: {row["ms"]:.4f} ms, '
          + ''.join(f'{k} {row[k + "_ms"]:.4f} ms, ' for k in
                    ('resident', 'host_phase') if row[k + '_ms'] is not None)
          + f'plain {row["plain_ms"]:.4f} ms, bound {row["bound_ms"]:.6f} ms '
          f'({row["bound_ms"] / row["ms"] * 100:.1f}% of it, the link at '
          f'{LINK_BYTES_PER_S / 1e9:.0f} GB/s; a bulk copy '
          f'{row["link_gb_s"]:.3f} GB/s)')
    k3[f'mixed {shape}'] = row
  for k2 in [rows['dedup_table_insert']] + list(
      rows['dedup_table_insert'].get('shapes', {}).values()):
    name = 'dedup_table_init' + ('_types' if 'types' in k2 else '')
    print(f'{name} ({k2["slots"]} slots): {k2["ms"]:.4f} ms back '
          f'to back, in a CUDA graph {k2["graph_ms"]:.4f} ms, host enqueue '
          f'{k2["host_us"]:.2f} us; the chain it replaced '
          f'{k2["chain_ms"]:.4f} ms, graph {k2["chain_graph_ms"]:.4f} ms, '
          f'host {k2["chain_host_us"]:.2f} us; bound {k2["bound_ms"]:.6f} ms')
  for label, row in rows['sample_hop_dedup'].get('shapes', {}).items():
    print(f'sample_hop_dedup per {label}: {row["ms"]:.4f} ms, in a CUDA '
          f'graph {row["graph_ms"]:.4f} ms, host enqueue '
          f'{row["host_us"]:.2f} us, plain {row["plain_ms"]:.4f} ms, bound '
          f'{row["bound_ms"]:.6f} ms')
  print(smi)
  def count(launched, wrappers):
    return sum(launched.get(w, 0) for w in
               ((wrappers,) if isinstance(wrappers, str) else wrappers))

  # launches: the main paths together; launches_by_path: each path's own
  # (K3's row: gather_rows and gather_rows_mixed, one kernel source), on a
  # superstep path the eager launches plus those of its graphs' replays;
  # replayed_by_path: those replays' launches (recorded in a capture times
  # the graph's replays; a call recorded in a capture launches nothing);
  # graph_ms: device time a call inside a CUDA graph (the probe rows, K1
  # at B=256, B1 per request, K2's table init); host_us: host enqueue a
  # call; shapes: K3 at each timed row shape (ms and library_ms in turns;
  # 'mixed ...': over a split store, in turns with K3 over the resident
  # table and the host phase, bounded over the host link too);
  # vt and vmem_take launch one kernel through wrappers of their own, so
  # each row counts only its own shape's launches
  print(json.dumps({'kernels': [
      dict(name=n, route='cuda', source=src, replaces=rep, wrapper=w,
           launches=sum(count(v, w) for v in by_path.values()),
           launches_by_path={p: count(v, w) for p, v in by_path.items()},
           replayed_by_path={p: count(v[1], w) for p, v in ss_paths.items()},
           max_abs_err=rows[n]['err'],
           ms=rows[n]['ms'], plain_ms=rows[n]['plain_ms'],
           bound_ms=rows[n]['bound_ms'], bound_by='bytes',
           library_ms=rows[n].get('library_ms'),
           graph_ms=rows[n].get('graph_ms'),
           library_graph_ms=rows[n].get('library_graph_ms'),
           host_us=rows[n].get('host_us'),
           **({'shapes': rows[n]['shapes']} if 'shapes' in rows[n] else {}))
      for n, (w, src, rep) in replaces.items()]}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
