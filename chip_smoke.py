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
partitioned homogeneous training through DistTrainStep and
DistLinkNeighborLoader, table-sourced, fragment-sourced and
online-partitioned datasets through TableDataset, load_vineyard_dataset,
DistTableDataset and DistTableRandomPartitioner, the server-client mode
through spawned sampling servers and RemoteNeighborLoader, the mp mode
through MpNeighborLoader, feature lookups across processes through the
feature_mp example, hetero link prediction through the hetero
LinkNeighborLoader, HGT
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
  one batch against the plain versions, then two windows of 4 through
  the per-batch engine and through the superstep (eager and captured,
  then a replay) on the same seeds and uniforms;
- partitioned homogeneous training (examples/distributed/
  dist_train_sage.py at products-sage's width, one rank): the products
  graph and table partitioned on disk by RandomPartitioner (one part),
  loaded back through DistGraph, DistDataset (to the host) and a
  DistFeature, resident and split 0.2 (the first 20% of ids copied to the
  card, the rest pinned and read at the owner by K3 mixed); B2 at a batch's three hops, K3 and K3
  mixed at its node list against their plain versions; DistTrainStep
  (GraphSAGE 100 -> 256 -> 256 -> 47, [15, 10, 5], batch 1024, Adam
  1e-3) 2 warm-up and 10 timed steps from each store, one batch of each
  against the plain versions; the link path of dist_sage_unsup.py over
  the same stores (DistLinkNeighborLoader, 512 positive edges and 512
  strict binary negatives, 100 -> 256 -> 256 -> 64, Adam 3e-3), 2 + 10
  steps and one batch against plain; K3 on float32 x 7 edge rows and B2
  with edge ids through DistNeighborLoader(edge_feature=) on a
  100,000-node graph, and a DistSubGraphLoader batch (B2 at max_degree
  windows) on a Cora-sized graph, each bit-equal to plain;
- the host phase of the split 0.2 partitioned store (host_offload=False:
  K3 at the owner over its hot rows, the cold lanes flagged, read from
  host memory and written on the card) at one batch's node slots,
  bit-identical to K3 mixed and timed beside it;
- server-client training (examples/distributed/server_client_mode.py at
  products-sage's width): the graph, features and labels written to a
  temporary directory, two sampling servers spawned (each its own copy on
  the host for the data plane), each with one sampling worker that
  builds the graph on the card and samples there (K1) and gathers the
  batch's rows (K3), batches through a shared-memory ring of two messages
  (the phase fails unless both servers streamed through a ShmChannel) and
  TCP to this process's RemoteNeighborLoader; each server serves half
  the seeds of 12 batches of 1,024, [15, 10, 5], an epoch, and
  SageTrainStep (GraphSAGE 100 -> 256 -> 256 -> 47, Adam 1e-3) takes 2
  warm-up and 10 timed steps of epoch 0 (batches/s over that window, no
  profiler) and the same of epoch 1 under the profiler (the device's busy
  share); server 0's first batch is held bit for bit against the
  in-process sampler on the card (the same generator seed and seed
  order) and its loss against the local batch's; then 3 batches of
  MpNeighborLoader (one worker on the card) held the same way, and the
  feature_mp example's 5 lookups (K3 mixed in its worker) against the
  table's rows, with K3 mixed at that shape held against its plain
  version here. The workers' launch counts and stage times come back
  through files their dataset builder (``sc_build``) has written at exit;
- live updates, the rest (examples/stream_updates.py at products-sage's
  width): a StreamIngestor's background applier (poll 0.05 s, staleness
  1 s, occupancy 0.5, min interval 0.5 s, overlays refreshed by the
  tick) compacting while 4 threads call the stream engine, 1,000
  inserts, 500 deletes and 256 feature rows compacted by the staleness
  check, 2,048 more by the occupancy policy; the graph as CSC through
  StreamSampler(edge_dir='in'), every bucket run replayed through the
  plain versions; a DistServer over the products graph and table on the
  card (init_server, init_client) taking apply_delta over rpc, one
  through a ChaosTcpProxy that drops its first reply; each compacted
  graph held against numpy's merge of the base and the delta;
- the partitioned sampler's weighted and full hops: the
  igbh-rgat partition above carries float32 edge weights in (0, 1] on
  every edge type, and DistHeteroTrainStep(with_weight=True) at the
  same width trains 2 + 5 steps through each owner's weighted hop (B3
  reads the weight window, a Gumbel top-k picks, B2 reads the picks),
  one batch against the plain versions and B3 and B2 timed at its
  shapes; over the partitioned products graph with its weights, a
  DistNeighborSampler(with_weight=True, with_edge=True) batch of 1,024 at
  [15, 10, 5] and a [-1, -1] one in a window of the store's max_degree
  (B3 over the neighbour ids and over the edge ids), each against its
  plain twin, their B3 and B2 reads timed in turns with torch.take;
- the partition hot cache: NeighborSampler.sample_prob on the card over
  the products graph from each half of the training split, against a
  float64 numpy push; FrequencyPartitioner (two parts, cache_ratio 0.05)
  writing the layout; DistDataset.load of part 0 on the card (its cached
  rows, then its owned ones, the rewritten book) and a one-rank
  DistFeature lookup of cached ids through K3;
- where a dataset comes from, over products-sage's graph, rows and
  labels streamed as odps_table_reader yields them (chunks of 1,048,576
  records, the node records in a shuffled id order): TableDataset.load
  on the card, bit-equal to the directly built dataset, then
  NeighborLoader and SageTrainStep over it (batch 1024, [15, 10, 5], 2
  warm-up and 10 timed steps; K1, K3 once a step), one batch against the
  direct dataset's and the plain versions', and pai_table_train's main
  at its defaults through CSV files; an InMemoryFragmentStore of four id
  windows loaded by load_vineyard_dataset on the card, a walk and a
  gather of 1,024 seeds against the direct dataset's and the plain
  versions'; DistTableDataset.load_tables on one rank (the partition in
  a temporary directory, removed after the load) and DistTrainStep over
  it (B2, K3), 2 + 10 steps and one batch against plain; two
  DistTableRandomPartitioner ranks on threads over loopback rpc, each
  with half the tables, every edge and row checked at its owner and each
  part loaded on the card; IGBH's layout synthesized at 1,000,000 papers,
  compressed (CSC, bf16) on the card and read back by load_igbh_root,
  against Topology's CSC and torch.bfloat16's cast;
- the IGBH trainer beyond the resident store (examples/igbh/
  dist_train_rgnn.py --split-ratio, --ckpt-dir/--resume, --coordinator):
  the igbh-rgat partition above loaded to the host and served from split
  0.2 bf16 stores (a fifth of each type's rows on the card, the rest
  pinned; each owner reads both blocks in one K3 mixed launch), their
  card bytes against the resident stores', one batch against the
  resident stores' and the plain versions', 2 + 10 steps beside the
  resident step, K3 mixed a type timed against its bound and the
  resident K3, the first 8 of those steps again as two windows of 4, the
  second a CUDA-graph replay (K3 mixed inside); a checkpoint after 2 steps restored into
  a fresh trainer, its state and the state 2 steps later against the
  uninterrupted trainer's (those steps under
  torch.use_deterministic_algorithms); the example itself at 10,000
  papers with --split-ratio 0.2 --ckpt-steps 1, then --resume, then in
  its multihost mode (--coordinator, one rank) over the
  same trees, counting the files it opens against the trees' bytes; then
  the single-device weighted hetero NeighborLoader over the same graph
  with its float32 weights (each edge type's weighted hop: B3's weight
  window, a Gumbel top-k, B2's picks), RGAT at igbh-rgat's width, 2 + 5
  steps, one batch against the plain versions with B3 and B2 timed at
  its shapes, a [-1, -1] batch in windows of 8 and a batch seeded with
  papers and authors (K2's two-type init, B1) against their plain
  versions;
- NeighborLoader's options over products-sage: a weighted per-hop batch
  with edge ids and a [-1, 10, 5] per-hop batch with replacement against
  the plain versions, as_pyg_v1 and prefetch_depth=2 loaders over three
  batches against the loader without them;
- the link loader's options over products-sage, after the link main
  path: LinkNeighborLoader(with_weight=True, with_edge=True) at the link
  batch's shapes (batch 512, one binary negative each, [15, 10, 5]; each
  hop's weight window read by B3, a Gumbel top-k, the picks and their
  edge ids read by B2, then K3), one batch against the plain versions,
  every valid lane's edge id checked against its endpoints in the CSR,
  and 3 + 10 steps of GraphSAGE.embed 100 -> 256 -> 256 -> 64 ->
  link_bce_loss -> Adam(3e-3) beside the uniform link step; a uniform
  replace=True link batch (K1 with replacement) against the plain
  versions and one step; a SubGraphLoader(with_edge=True) batch against
  the plain versions, its induced edges' ids checked;
- the trim example's two trajectories (glt_tpu_torch.examples.
  train_sage_with_trim at GraphSAGE 100 -> 256 -> 256 -> 47, batch 1024,
  [15, 10, 5], 10 steps each, identically seeded), their step medians,
  accuracies over 1,024 test nodes and edge slots a layer; the GPT on
  graphs example at 2,000 papers, its 3 prompts against the plain
  versions'; the measured ceilings (obs.device_ceilings: the device
  memory's stream rate and the float32 GEMM rate) beside the data
  sheet's; sharded_segment_mean and its scattered form over a one-rank
  NCCL group against one index_add_ mean;
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
  their plain versions and timed beside their library calls and the
  card's launch floor (a one-element zero_); the redesigned kernels in
  turns with their library calls, their bound shares against the data
  sheet and the stream rate measured in the same call; take2d and the
  row copy also at their edge shapes (probe_edge_checks), the row copy
  also at 153,600 rows of 512 B beside index_select and K3;
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
FP32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
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
# GraphSAGE's options at that width: (label, conv, SAGE aggregation,
# dropout), each trained VARIANT_STEPS steps; the engine serves the first
VARIANTS = (('gat', 'gat', None, 0.0), ('gcn', 'gcn', None, 0.0),
            ('sage max, dropout 0.5', 'sage', 'max', 0.5))
VARIANT_STEPS, VARIANT_REQUESTS = 5, 8
LOSS_TOL = 1e-4   # same batch bit for bit; index_add_ atomics again
# hetero training: examples/igbh/dist_train_rgnn.py (batch 64, Adam 1e-3,
# a bf16 feature store) over the igbh-rgat graph, a seeded 60% of the
# papers to train on (examples/igbh/split_seeds.py)
HTRAIN_BATCH, HTRAIN_WARMUP, HTRAIN_STEPS, HTRAIN_FRAC = 64, 3, 10, 0.6
#: the hetero train main path's median step (ms), which the weighted
#: single-device hetero path prints beside its own
HTRAIN_MEDIAN = {}
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
    got = K.sample_hop(indices, eids, starts, offsets)
    want = K.sample_hop_plain(indices, eids, starts, offsets)
    if not (torch.equal(got[0], want[0]) and (eids is None or torch.equal(
        got[1], want[1]))):
      raise AssertionError(f'sample_hop {label} hop {h + 1} differs from '
                           'plain')
    row['err'] = max(row['err'], int((got[0].long() - want[0].long()).abs()
                                     .max()))
    slots = (starts.long()[:, None] + offsets.long()).clamp(
        0, indices.numel() - 1)
    fns = {'kernel': lambda: K.sample_hop(indices, eids, starts, offsets),
           'take': (lambda: torch.take(indices, slots)) if eids is None else
           (lambda: (torch.take(indices, slots), torch.take(eids, slots)))}
    per_round = in_turns_ms(torch, np, fns)
    t = {n: float(np.median(v)) for n, v in per_round.items()}
    for n in rounds:
      rounds[n] = rounds[n] + per_round[n]
    host = in_turns_host_us(torch, np, fns)
    graph = {n: graph_ms(torch, fn, calls=20) for n, fn in fns.items()}
    plain = cuda_ms(torch, lambda i=0: K.sample_hop_plain(
        indices, eids, starts, offsets), 20)
    # bytes the read must move: a start per row; per lane an offset and
    # a neighbour id in, a pick out (and an edge id in and out)
    s, k = offsets.shape
    bound = bytes_ms(4 * s + (12 if eids is None else 20) * s * k)
    for key, v in (('ms', t['kernel']), ('plain_ms', plain),
                   ('library_ms', t['take']), ('bound_ms', bound),
                   ('graph_ms', graph['kernel']),
                   ('library_graph_ms', graph['take'])):
      row[key] += v
    print(f'sample_hop {label} hop {h + 1} [{s}, {k}] over '
          f'{indices.numel()} slots{"" if eids is None else " with eids"}: '
          f'equal to plain; {t["kernel"]:.4f} ms '
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


def time_windows(torch, np, K, label, calls):
  """B3 at each recorded read ``(arr, starts, width)``: equal to plain,
  its time against torch.take over the same clipped slots (in turns), its
  plain time, bound and host enqueue; returns the row of sums."""
  row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
  rounds = {'kernel': 0.0, 'take': 0.0}
  for h, (arr, starts, width) in enumerate(calls):
    got = K.gather_windows(arr, starts, width)
    want = K.gather_windows_plain(arr, starts, width)
    if not torch.equal(got, want):
      raise AssertionError(f'gather_windows {label} read {h + 1} differs '
                           'from plain')
    row['err'] = max(row['err'], float((got.double() - want.double()).abs()
                                       .max()))
    slots = (starts.long()[:, None] + torch.arange(
        width, device=starts.device)).clamp(0, arr.numel() - 1)
    fns = {'kernel': lambda: K.gather_windows(arr, starts, width),
           'take': lambda: torch.take(arr, slots)}
    per_round = in_turns_ms(torch, np, fns)
    t = {n: float(np.median(v)) for n, v in per_round.items()}
    for n in rounds:
      rounds[n] = rounds[n] + per_round[n]
    host = in_turns_host_us(torch, np, fns)
    plain = cuda_ms(torch, lambda i=0: K.gather_windows_plain(
        arr, starts, width), 20)
    # bytes the read must move: a start per row, per lane one element in
    # and one out
    s = starts.numel()
    bound = bytes_ms(4 * s + 8 * s * width)
    for key, v in (('ms', t['kernel']), ('plain_ms', plain),
                   ('library_ms', t['take']), ('bound_ms', bound)):
      row[key] += v
    print(f'gather_windows {label} read {h + 1} [{s}, {width}] '
          f'{str(arr.dtype)[6:]} over {arr.numel()} slots: equal to plain; '
          f'{t["kernel"]:.4f} ms (torch.take {t["take"]:.4f} ms, in turns, '
          f'medians of {ROUNDS}; plain {plain:.4f} ms; bound {bound:.6f} ms, '
          f'{bound / t["kernel"] * 100:.1f}% of it); host enqueue '
          f'{host["kernel"]:.2f} us a call (torch.take {host["take"]:.2f} '
          'us)')
  print(f'gather_windows per {label} ({len(calls)} reads): {row["ms"]:.4f} '
        f'ms (plain {row["plain_ms"]:.4f} ms, torch.take '
        f'{row["library_ms"]:.4f} ms, bound {row["bound_ms"]:.6f} ms)')
  verdict(f'gather_windows summed over a {label}\'s {len(calls)} reads',
          row['ms'], row['library_ms'],
          ratios=list(rounds['kernel'] / rounds['take']))
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


@contextlib.contextmanager
def recorded_calls(K, names):
  """The wrappers ``names`` of ``K`` replaced by their plain versions that
  also record their arguments, by name, inside the block."""
  calls = {n: [] for n in names}

  def recorder(n):
    plain = getattr(K, n + '_plain')

    def call(*a):
      calls[n].append(a)
      return plain(*a)
    return call
  real = {n: getattr(K, n) for n in names}
  try:
    for n in names:
      setattr(K, n, recorder(n))
    yield calls
  finally:
    for n, fn in real.items():
      setattr(K, n, fn)


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


#: the redesigned probe gathers' edge shapes: take2d's table words and
#: index counts, the row copy's row bytes and row counts
TAKE_EDGES = ((1, 4_097, 8_192), (1, 3, 30_720, 768_001))
ROW_EDGES = ((16, 512, 16_384), (1, 16, 153_600))
#: the row copy at the microbench's row shape: 153,600 rows of a
#: [1,000,000, 128] float32 table
WIDE_ROWS, WIDE_TABLE = 153_600, (1_000_000, 128)
#: the copy (vmem_id) where bytes set its pace: 256 MiB of float32
COPY_SHAPE = (524_288, 128)


def probe_edge_checks(torch, P, dev, gen):
  """take2d (vt and vmem_take) and the row copy (prefetch_grid) bit-equal
  to their plain versions and library calls at their edge shapes: a
  one-word table, a tail word, the largest table; one index, a ragged
  count, the rung's 30,720 and a ragged 768,001, idx and out one element
  past a 16-byte boundary (the element loop); rows of 16 B, 512 B and
  16 KB at 1, 16 and 153,600 rows, clipped at both ends."""
  checked = 0
  for n in TAKE_EDGES[0]:
    tab = torch.randint(-(1 << 30), 1 << 30, (n,), generator=gen,
                        device=dev, dtype=torch.int32)
    for m in TAKE_EDGES[1]:
      idx = torch.randint(-n - 5, 2 * n + 5, (m + 1,), generator=gen,
                          device=dev, dtype=torch.int32)
      want = P.vmem_take_plain(tab, idx)
      if not torch.equal(want, torch.take(tab, idx.long().clamp(0, n - 1))):
        raise AssertionError(f'take2d n={n} m={m}: plain differs from take')
      out = torch.full((m + 1,), 7, dtype=torch.int32, device=dev)
      P._check(P.glt_take2d(tab.data_ptr(), n, idx.data_ptr(), m,
                            out[1:].data_ptr(), *P._where(dev)), 'take2d')
      for fn in (P.vmem_take, P.vt):
        if not (torch.equal(fn(tab, idx[:m]), want[:m])
                and torch.equal(fn(tab, idx[1:]), want[1:])
                and torch.equal(out[1:], want[:m])):
          raise AssertionError(f'{fn.__name__} n={n} m={m} differs')
      checked += 1
  for row_bytes in ROW_EDGES[0]:
    tab = torch.randn((300, row_bytes // 4), generator=gen, device=dev)
    for b in ROW_EDGES[1]:
      rows = torch.randint(-3, 303, (b,), generator=gen, device=dev,
                           dtype=torch.int32)
      rows[0], rows[-1] = -1, 300
      got = P.prefetch_grid(tab, rows)
      if not (torch.equal(got, P.prefetch_grid_plain(tab, rows))
              and torch.equal(got, torch.index_select(
                  tab, 0, rows.long().clamp(0, 299)))):
        raise AssertionError(f'prefetch_grid {row_bytes} B x {b} differs')
      checked += 1
  print(f'probe edge shapes: take2d at tables of {TAKE_EDGES[0]} words x '
        f'{TAKE_EDGES[1]} indices (aligned and one element off), the row '
        f'copy at rows of {ROW_EDGES[0]} B x {ROW_EDGES[1]}: {checked} '
        'shapes equal to plain and to torch.take or index_select')


def launch_floor(torch, dev, host_us):
  """The card's launch floor, the yardstick of the probe kernels, whose
  work is far below a launch: a one-element ``zero_`` back to back, in a
  CUDA graph and by host enqueue, printed once."""
  one = torch.empty(1, device=dev)
  ms = cuda_ms(torch, lambda i=0: one.zero_(), 200)
  graph = graph_ms(torch, one.zero_)
  host = host_us({'zero_': one.zero_})['zero_']
  print(f'launch floor (a one-element zero_): {ms:.4f} ms a launch back to '
        f'back, in a CUDA graph {graph:.4f} ms, host enqueue {host:.2f} us')
  return dict(ms=ms, graph_ms=graph, host_us=host)


def probe_checks(torch, np, K, P, dev, seed, rows, host_us):
  """Each kernel of the probe ladder and the microbench held bit-equal to
  its plain version at the TPU rungs' shapes (vmem_take also at the
  microbench's [200, 3840]) and timed beside its library call, where one
  PyTorch call computes the same function, its byte bound and its host
  enqueue time, beside the card's launch floor. The redesigned kernels
  (smem_scalar, dma_fixed, dma_dynamic, the row copy prefetch_grid and
  take2d's vt and vmem_take) are timed in turns with their library calls
  (medians of ROUNDS rounds) and their bound shares taken against the
  data sheet's 3.35 TB/s and against the stream rate measured in this
  call; take2d and the row copy are also held at their edge shapes, the
  row copy also at 153,600 rows of 512 B, in turns with index_select and
  K3 gather_rows, and vmem_id's copy at 256 MiB, where bytes set its
  pace, in turns with clone."""
  from glt_tpu_torch.benchmarks import probe_compile
  from glt_tpu_torch.obs.perf import measure_hbm_bandwidth
  t = {k: torch.as_tensor(v, device=dev)
       for k, v in probe_compile.draw_inputs(seed).items()}
  gen = torch.Generator(device=dev).manual_seed(seed + 10)
  big_idx = torch.randint(0, 8192, (200, 3840), generator=gen, device=dev,
                          dtype=torch.int32)
  probe_edge_checks(torch, P, dev, gen)
  rate = measure_hbm_bandwidth(dev)
  print(f'measured stream rate {rate / 1e12:.4f} TB/s '
        f'({rate / HBM_BYTES_PER_S * 100:.1f}% of the data sheet\'s)')
  x, s, big, st = t['x'], t['s'], t['big'], t['st']
  idx_long = (t['idx'].long(), big_idx.long())   # torch.take's index type
  wide = torch.randn(WIDE_TABLE, generator=gen, device=dev)
  wide_rows = torch.randint(0, WIDE_TABLE[0], (WIDE_ROWS,), generator=gen,
                            device=dev, dtype=torch.int32)
  wide_distinct = int(torch.unique(wide_rows).numel())
  copy_x = torch.randn(COPY_SHAPE, generator=gen, device=dev)
  # name: (wrapper, arguments, library call or None, bytes moved); a name
  # other than its wrapper's is a shape of that wrapper's row
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
      # the row copy where its design matters; its bound reads each
      # distinct row once, as K3's does
      f'prefetch_grid {WIDE_ROWS:,} x 512 B': (
          'prefetch_grid', (wide, wide_rows),
          lambda: torch.index_select(wide, 0, wide_rows),
          (wide_distinct + WIDE_ROWS) * 512 + 4 * WIDE_ROWS),
      # the copy where bytes, not the launch, set its pace
      f'vmem_id {copy_x.numel() * 4 >> 20} MiB': (
          'vmem_id', (copy_x,), lambda: copy_x.clone(),
          2 * copy_x.numel() * 4),
  }
  redesigned = ('vmem_id', 'smem_scalar', 'dma_fixed', 'dma_dynamic',
                'prefetch_grid', 'vt', 'vmem_take')
  labels = {'vmem_id': 'clone', 'smem_scalar': 'torch.mul',
            'dma_fixed': 'clone', 'prefetch_grid': 'index_select'}
  launch_floor(torch, dev, host_us)
  for name, (fn, args, lib, nbytes) in cases.items():
    kernel, plain = getattr(P, fn), getattr(P, fn + '_plain')
    got, want = kernel(*args), plain(*args)
    if not torch.equal(got, want):
      raise AssertionError(f'{name} differs from its plain version')
    if lib is not None and not torch.equal(got, lib()):
      raise AssertionError(f'{name} differs from its library call')
    fns = {'kernel': lambda: kernel(*args)}
    if lib:
      fns['library'] = lib
    wide_case = name != fn
    if fn == 'prefetch_grid' and wide_case:
      fns['gather_rows'] = lambda: K.gather_rows(wide, wide_rows)
    if fn in redesigned:
      per_round = in_turns_ms(torch, np, fns, iters=200, abba=True)
      ms = float(np.median(per_round['kernel']))
      lib_ms = float(np.median(per_round['library'])) if lib else None
    else:
      ms = cuda_ms(torch, lambda i=0: kernel(*args), 200)
      lib_ms = cuda_ms(torch, lambda i=0: lib(), 200) if lib else None
    plain_ms = cuda_ms(torch, lambda i=0: plain(*args),
                       20 if wide_case else 200)
    host = host_us(fns)
    dev_ms = {n: graph_ms(torch, f, calls=20 if wide_case else 50)
              for n, f in fns.items()}
    bound = bytes_ms(nbytes)
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
               err=float((got.double() - want.double()).abs().max()),
               host_us=host['kernel'], graph_ms=dev_ms['kernel'],
               library_graph_ms=dev_ms.get('library'),
               library_host_us=host.get('library'))
    shapes = [tuple(a.shape) if hasattr(a, 'shape') else a for a in args]
    line = (f'{name} {shapes}: equal to plain'
            f'{" and its library call" if lib else ""}; {ms:.4f} ms a launch '
            f'back to back (plain {plain_ms:.4f}, library '
            f'{"none" if lib is None else f"{lib_ms:.4f}"}, bound {bound:.3e} '
            f'ms); in a CUDA graph {dev_ms["kernel"]:.4f} ms'
            + (f' (library {dev_ms["library"]:.4f})' if lib else '')
            + f'; host enqueue {host["kernel"]:.2f} us a call'
            + (f' (library {host["library"]:.2f} us)' if lib else ''))
    if fn in redesigned:
      row.update(bound_share=bound / dev_ms['kernel'],
                 ceiling_share=nbytes / rate * 1e3 / dev_ms['kernel'],
                 ratios=(list(per_round['kernel'] / per_round['library'])
                         if lib else None))
      line += (f'; in turns, medians of {ROUNDS}; in a graph '
               f'{row["bound_share"] * 100:.1f}% of its bound at 3.35 TB/s, '
               f'{row["ceiling_share"] * 100:.1f}% at the measured '
               f'{rate / 1e12:.4f} TB/s')
    if 'gather_rows' in fns:
      k3_ms = float(np.median(per_round['gather_rows']))
      row.update(rows=WIDE_ROWS, distinct=wide_distinct, k3_ms=k3_ms,
                 k3_graph_ms=dev_ms['gather_rows'],
                 k3_host_us=host['gather_rows'])
      line += (f'; K3 gather_rows {k3_ms:.4f} ms, graph '
               f'{dev_ms["gather_rows"]:.4f} ms, host '
               f'{host["gather_rows"]:.2f} us ({ms / k3_ms:.3f}x K3 back to '
               f'back, {dev_ms["kernel"] / dev_ms["gather_rows"]:.3f}x in a '
               f'graph); {wide_distinct} distinct rows')
    if wide_case:
      rows[fn].setdefault('shapes', {})[name] = row
    else:
      rows[name] = row
    print(line)
    if fn in redesigned and lib:
      verdict(name, ms, lib_ms, label=labels.get(fn, 'torch.take'),
              ratios=row['ratios'])
    del got, want


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


def sage_variants_phase(torch, np, K, ds, dev, seed, loader, smi):
  """GraphSAGE's other convolutions and options (VARIANTS) at full width,
  each trained VARIANT_STEPS steps from ``loader(False)`` (the walk: K1
  and K3 once a step), then the engine serving the GAT model (K1, K3 once
  a computed bucket), its last request's logits held against the model's
  own eval() forward on that batch; returns the launches by kernel."""
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.parallel import SageTrainStep
  from glt_tpu_torch.serving import InferenceEngine

  with Phase('sage variants path'):
    K.reset_launch_counts()
    nets = {}
    for label, conv, aggr, dropout in VARIANTS:
      torch.manual_seed(seed)
      net = GraphSAGE(FEAT_DIM, HIDDEN, CLASSES, num_layers=3, conv=conv,
                      dropout=dropout).to(dev).train()
      if aggr is not None:
        for c in net.convs:
          c.aggr = aggr
      step = SageTrainStep(net, lr=LR)
      k1, k3 = K.sample_walk_dedup.launches, K.gather_rows.launches
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      losses, secs, it = [], [], iter(loader(False))
      for _ in range(VARIANT_STEPS):
        t0 = time.perf_counter()
        losses.append(step(next(it)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
      losses = [float(v) for v in losses]
      peak = torch.cuda.max_memory_allocated()
      if not all(np.isfinite(losses)):
        raise AssertionError(f'{label}: non-finite loss {losses}')
      for name, before in (('sample_walk_dedup', k1), ('gather_rows', k3)):
        n = getattr(K, name).launches - before
        if n != VARIANT_STEPS:
          raise AssertionError(f'{label}: {n} {name} launches in '
                               f'{VARIANT_STEPS} steps')
      print(f'GraphSAGE {label}: {VARIANT_STEPS} steps, loss '
            f'{losses[0]:.4f} -> {losses[-1]:.4f}; median step '
            f'{np.median(secs[1:]) * 1e3:.3f} ms (first '
            f'{secs[0] * 1e3:.3f}); peak memory {peak / 2**30:.3f} GiB '
            f'({peak} bytes); on {smi}')
      nets[label] = net
    gat = nets[VARIANTS[0][0]]
    engine = InferenceEngine(ds, gat, None, FANOUTS, device=dev, seed=seed)
    made = []   # the batches the engine makes, the last request's last

    def record(*a, **kw):
      made.append(InferenceEngine.make_batch(engine, *a, **kw))
      return made[-1]
    engine.make_batch = record
    # distinct ids across requests: every request computes all of its ids
    requests = torch.randperm(NUM_NODES, generator=torch.Generator(
        ).manual_seed(seed + 25))[:200 * VARIANT_REQUESTS].view(
            VARIANT_REQUESTS, 200).numpy()
    check = per_request_launches(K, {'sample_walk_dedup': 1,
                                     'gather_rows': 1})
    for ids in requests:
      calls0 = engine.forward_calls
      logits = engine.infer(ids)
      check(engine.forward_calls - calls0)
    with torch.no_grad():
      own = gat.eval()(made[-1])[:ids.size].cpu()
    order = np.argsort(np.argsort(ids))   # infer computes sorted ids
    diff = float((own[order] - torch.as_tensor(logits)).abs().max())
    if not torch.allclose(own[order], torch.as_tensor(logits),
                          rtol=LOGIT_TOL, atol=LOGIT_TOL):
      raise AssertionError(f'GAT engine logits differ from the model\'s '
                           f'eval() forward by {diff}')
    variant_launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    if variant_launches['gather_windows'] or variant_launches['sample_hop']:
      raise AssertionError('the variants path read windows or picks')
    print(f'GAT engine: {VARIANT_REQUESTS} requests of 200 ids; the last '
          f'request\'s logits equal the model\'s eval() forward on its batch '
          f'(max |diff| {diff:.3e}, tolerance {LOGIT_TOL}); launches '
          f'{variant_launches}')
    del nets, gat, engine, made, net, step
  return variant_launches


def train_phases(torch, np, K, ds, dev, seed, rows, smi):
  """The training path over the homogeneous graph and features (with the
  edge weights drawn in the data phase); returns its launches by kernel,
  weighted, uniform and of GraphSAGE's variants. ``smi`` names the card
  and its power limit."""
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
    # the front end phases serve these weights
    TRAINED['products_sage'] = {k: v.detach().clone()
                                for k, v in net.state_dict().items()}
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

  variant_launches = sage_variants_phase(torch, np, K, ds, dev, seed,
                                         loader, smi)

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
  return launches, uniform_launches, variant_launches


HETERO_BATCH_FIELDS = ('node_dict', 'node_count_dict', 'row_dict',
                       'col_dict', 'edge_mask_dict', 'x_dict', 'y_dict',
                       'num_sampled_edges')


def differing_field(torch, a, b, fields):
  """The first of ``fields`` (a tensor, a dict of them, or None) that is
  not bit-identical between batches ``a`` and ``b`` (objects, or the
  loaders' dicts), else None."""
  get = (lambda o, f: o.get(f)) if isinstance(a, dict) else getattr
  for f in fields:
    x, y = get(a, f), get(b, f)
    if x is None or y is None:
      if x is not y:
        return f
      continue
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
    HTRAIN_MEDIAN['ms'] = median_ms
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
#: the link main path's median step (ms), which the weighted link path
#: prints beside its own
LINK_MEDIAN = {}


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
    link_median = LINK_MEDIAN['uniform'] = float(np.median(timed))
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


def edge_ids_name_lanes(torch, g, node, row, col, mask, eids):
  """Whether every valid lane's edge id names an edge of ``g`` from the
  lane's parent (``node[col]``) to its child (``node[row]``): the id's CSR
  slot (the inverse of ``g.edge_ids``) lies in the parent's row and holds
  the child. Returns (ok, the number of valid lanes)."""
  m = mask.bool()
  e = eids[m].long()
  inv = torch.empty(g.edge_ids.numel(), dtype=torch.long,
                    device=g.edge_ids.device)
  inv[g.edge_ids.long()] = torch.arange(g.edge_ids.numel(),
                                        device=inv.device)
  slot = inv[e]
  del inv
  parent, child = node[col[m].long()].long(), node[row[m].long()].long()
  ptr = g.indptr.long()
  ok = ((slot >= ptr[parent]) & (slot < ptr[parent + 1])
        & (g.indices[slot].long() == child))
  return bool(ok.all()), int(m.sum())


# the link loader's options (LinkNeighborLoader(with_weight=, with_edge=,
# replace=), SubGraphLoader(with_edge=)) at the link main path's shapes:
# batch 512, one binary negative each, [15, 10, 5]
LINK_OPTION_FIELDS = LINK_FIELDS + ('edge',)


def link_option_phases(torch, np, K, ds, dev, seed, smi):
  """The link loader's options over products-sage (its weights from
  ``data``): a weighted link batch with edge ids through B3, B2 and K3
  held against the plain versions, then 3 + 10 weighted link steps; a
  uniform link batch with replacement through K1 and K3 held against
  them, and one step; a SubGraphLoader batch with edge ids. Returns the
  launches by path."""
  from glt_tpu_torch.examples import graph_sage_unsup as unsup
  from glt_tpu_torch.loader import (LinkNeighborLoader, SubGraphLoader,
                                    get_edge_label_index)
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.ops.negative import negative_proposals
  from glt_tpu_torch.parallel import SageTrainStep, link_bce_loss
  from glt_tpu_torch.sampler import NegativeSampling

  paths = {}
  g = ds.get_graph()
  every_edge = get_edge_label_index(ds)[1]

  def loader(**kw):
    return LinkNeighborLoader(
        ds, list(FANOUTS), edge_label_index=every_edge,
        batch_size=LINK_BATCH, shuffle=True,
        neg_sampling=NegativeSampling('binary', 1), device=dev, seed=seed,
        rng=np.random.default_rng(seed), **kw)

  def vs_plain(ld, label, names):
    # one batch at fixed edge positions, through the kernels and through
    # their plain versions on the same proposals and uniforms
    sampler = ld.sampler
    num_neg = ld.neg_sampling.sample_size(LINK_BATCH)
    props = negative_proposals(sampler.generator, num_neg, 5, NUM_NODES,
                               NUM_NODES, dev)
    u = sampler.hop_uniforms(2 * (LINK_BATCH + num_neg))
    pos = torch.randint(0, g.num_edges, (LINK_BATCH,),
                        generator=torch.Generator().manual_seed(seed + 13))
    return link_batch_vs_plain(torch, K, ld, label, props, u, pos.numpy(),
                               names=names, fields=LINK_OPTION_FIELDS)[0]

  def steps(ld, n_steps, warmup):
    torch.manual_seed(seed)
    net = GraphSAGE(FEAT_DIM, HIDDEN, LINK_EMBED, num_layers=3).to(dev)
    step = SageTrainStep(net, lr=unsup.LR, loss=link_bce_loss)
    it = iter(ld)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    losses, secs = [], []
    for _ in range(n_steps):
      t0 = time.perf_counter()
      losses.append(step(next(it)))
      torch.cuda.synchronize()
      secs.append(time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
      raise AssertionError(f'non-finite link loss {losses}')
    return launches, losses, np.array(secs[warmup:]) * 1e3

  with Phase('link weighted path'):
    weighted = loader(with_weight=True, with_edge=True)
    if not (weighted.sampler._per_hop and weighted.sampler._weighted):
      raise AssertionError('the weighted link loader does not run the '
                           'weighted per-hop loop')
    bk = vs_plain(weighted, 'weighted', ('sample_hop', 'gather_windows',
                                         'gather_rows'))
    ok, lanes = edge_ids_name_lanes(torch, g, bk.node, bk.row, bk.col,
                                    bk.edge_mask, bk.edge)
    if not ok or not lanes:
      raise AssertionError('a weighted link batch\'s edge id names no edge '
                           'between its lane\'s endpoints')
    if bool((bk.edge[~bk.edge_mask.bool()] != -1).any()):
      raise AssertionError('a masked lane of a window hop holds an edge id')
    print(f'weighted link batch ({LINK_BATCH} positives, {LINK_BATCH} '
          f'binary negatives, {4 * LINK_BATCH} seeds, window '
          f'{weighted.sampler._weight_window(FANOUTS[0])}): '
          f'{int(bk.node_count)} nodes, {lanes} edges; bit-identical to '
          'plain on every field, edge id and label; every valid lane\'s '
          'edge id names an edge between its endpoints, every masked '
          'lane\'s is -1')
    del bk
    n_steps = LINK_WARMUP + LINK_STEPS
    paths['link_weighted'], losses, timed = steps(weighted, n_steps,
                                                  LINK_WARMUP)
    per = paths['link_weighted']
    want = dict(sample_hop=3 * n_steps, gather_windows=3 * n_steps,
                gather_rows=n_steps, sample_walk_dedup=0,
                dedup_table_insert=0)
    for name, n in want.items():
      if per[name] != n:
        raise AssertionError(f'{name}: {per[name]} launches on the '
                             f'weighted link path, expected {n}')
    median = float(np.median(timed))
    uniform = LINK_MEDIAN['uniform']
    print(f'weighted link training: loss {losses[0]:.4f} at step 1, '
          f'{losses[-1]:.4f} at step {n_steps}; steps {LINK_WARMUP + 1}-'
          f'{n_steps}: median {median:.3f} ms (quartiles '
          f'{np.percentile(timed, 25):.3f}-{np.percentile(timed, 75):.3f}, '
          f'min {timed.min():.3f}, max {timed.max():.3f}) beside the uniform '
          f'link step\'s {uniform:.3f} ms ({median / uniform:.4f}x; link '
          f'main path, this call); launches '
          f'{ {k: v for k, v in per.items() if v} }; on {smi}')
    del weighted

  with Phase('link replace path'):
    rep = loader(replace=True)
    if rep.sampler._per_hop or not rep.sampler.replace:
      raise AssertionError('the replace link loader does not run the walk '
                           'with replacement')
    bk = vs_plain(rep, 'replace', ('sample_walk_dedup', 'gather_rows'))
    print(f'uniform link batch with replacement: {int(bk.node_count)} '
          f'nodes, {int(bk.edge_mask.sum())} edges; bit-identical to plain '
          'on every field and label')
    del bk
    paths['link_replace'], losses, _ = steps(rep, 1, 0)
    per = paths['link_replace']
    if (per['sample_walk_dedup'], per['gather_rows'],
        per['sample_hop']) != (1, 1, 0):
      raise AssertionError(f'the replace link step launched {per}')
    print(f'one replace link step: loss {losses[0]:.4f}; launches '
          f'{ {k: v for k, v in per.items() if v} }')
    del rep

  with Phase('subgraph edge check'):
    sub_loader = SubGraphLoader(ds, list(SUBGRAPH_FANOUTS),
                                np.arange(NUM_NODES),
                                batch_size=SUBGRAPH_BATCH, shuffle=True,
                                with_edge=True, device=dev, seed=seed,
                                rng=np.random.default_rng(seed))
    sampler = sub_loader.sampler
    u = sampler.hop_uniforms(SUBGRAPH_BATCH)
    real = sampler.subgraph
    sampler.subgraph = lambda s: real(s, uniforms=u)
    seeds = np.random.default_rng(seed + 14).choice(
        NUM_NODES, SUBGRAPH_BATCH, replace=False)
    K.reset_launch_counts()
    sk = sub_loader._make_batch(seeds, SUBGRAPH_BATCH)
    torch.cuda.synchronize()
    paths['subgraph_edge'] = {fn.__name__: fn.launches for fn in K.KERNELS}
    with swapped_to_plain(K, ('sample_walk_dedup', 'gather_rows')):
      sp = sub_loader._make_batch(seeds, SUBGRAPH_BATCH)
    f = differing_field(torch, sk, sp, ('x', 'row', 'col', 'edge_mask',
                                        'node', 'node_count', 'edge'))
    if f is not None:
      raise AssertionError(f'subgraph batch.{f} differs between kernels and '
                           'plain')
    # the subgraph's rows are the message sources: an edge runs col -> row
    ok, lanes = edge_ids_name_lanes(torch, g, sk.node, sk.row, sk.col,
                                    sk.edge_mask, sk.edge)
    if not ok or not lanes or bool((sk.edge[~sk.edge_mask] != -1).any()):
      raise AssertionError('a subgraph edge id names no induced edge')
    print(f'SubGraphLoader(with_edge=True) batch of {SUBGRAPH_BATCH} seeds: '
          f'{lanes} induced edges, each id naming its CSR edge, -1 on the '
          f'masked slots; bit-identical to plain, ids included; launches '
          f'{ {k: v for k, v in paths["subgraph_edge"].items() if v} }')
    del sk, sp, sub_loader, sampler, real
  del every_edge
  return paths


# the trim example (examples/train_sage_with_trim.py) at products-sage's
# width: TRIM_STEPS steps a trajectory, accuracy over the first TRIM_EVAL
# test nodes; GPT on graphs at its default 2,000 papers
TRIM_STEPS, TRIM_EVAL = 10, 1024
GPT_PAPERS = 2_000
# the sharded segment means on the card: SEG_ROWS message rows of SEG_DIM
# into SEG_SEGMENTS segments, held to SEG_TOL of one index_add_ mean
SEG_ROWS, SEG_DIM, SEG_SEGMENTS, SEG_TOL = 1_000_000, 64, 100_000, 1e-6


def example_phases(torch, np, K, ds, dev, seed, smi):
  """The trim A/B and the GPT prompts on the card (their launches by
  path), the measured ceilings, and the two sharded segment means over a
  one-rank NCCL group against a single-device ``index_add_`` mean."""
  import io
  import socket
  import tempfile
  import torch.distributed as dist
  from glt_tpu_torch.examples import gpt_on_graphs as gpt
  from glt_tpu_torch.examples import train_sage_with_trim as trim_example
  from glt_tpu_torch.obs import device_ceilings, get_registry
  from glt_tpu_torch.parallel import (sharded_segment_mean,
                                      sharded_segment_mean_scattered)

  paths = {}
  with Phase('trim path'):
    K.reset_launch_counts()
    res = trim_example.trim_ab(ds, CLASSES, list(FANOUTS), TRAIN_BATCH, dev,
                               hidden=HIDDEN, max_steps=TRIM_STEPS,
                               eval_nodes=TRIM_EVAL, seed=seed)
    torch.cuda.synchronize()
    paths['trim'] = {fn.__name__: fn.launches for fn in K.KERNELS}
    t, f = res[True], res[False]
    for run in (t, f):
      if len(run['step_ms']) != TRIM_STEPS or not np.isfinite(run['loss']):
        raise AssertionError(f'trim run: {run}')
    if not abs(t['acc'] - f['acc']) < 0.15:
      raise AssertionError(f'trim accuracies {t["acc"]}, {f["acc"]}')
    if not (paths['trim']['sample_walk_dedup']
            and paths['trim']['gather_rows']):
      raise AssertionError(f'trim path launched {paths["trim"]}')
    mt, mf = (float(np.median(r['step_ms'])) for r in (t, f))
    print(f'trim A/B (GraphSAGE {FEAT_DIM} -> {HIDDEN} -> {HIDDEN} -> '
          f'{CLASSES}, batch {TRAIN_BATCH}, {list(FANOUTS)}, {TRIM_STEPS} '
          f'steps each): edge buffer {res["slots"]} slots, hop offsets '
          f'{res["offsets"]}; edge slots a layer trim=True '
          f'{t["layer_slots"]} ({sum(t["layer_slots"])}), trim=False '
          f'{f["layer_slots"]} ({sum(f["layer_slots"])}); step median '
          f'trim=True {mt:.3f} ms, trim=False {mf:.3f} ms ({mt / mf:.4f}x); '
          f'loss {t["loss"]:.4f} / {f["loss"]:.4f}; accuracy over '
          f'{TRIM_EVAL} test nodes {t["acc"]:.4f} / {f["acc"]:.4f}; '
          f'launches {paths["trim"]}; on {smi}')

  with Phase('gpt prompt path'):
    argv = ['--device', str(dev), '--papers', str(GPT_PAPERS)]
    out = io.StringIO()
    K.reset_launch_counts()
    with contextlib.redirect_stdout(out):
      prompts = gpt.main(argv)
    torch.cuda.synchronize()
    paths['gpt_prompt'] = {fn.__name__: fn.launches for fn in K.KERNELS}
    # the loader's sampler and shuffle are seeded: a second run draws the
    # same proposals, uniforms and order
    with swapped_to_plain(K, ('sample_walk_dedup', 'gather_rows')), \
        contextlib.redirect_stdout(io.StringIO()):
      plain = gpt.main(argv)
    if len(prompts) != 3 or prompts != plain:
      raise AssertionError('the GPT prompts differ between kernels and '
                           'plain')
    if (paths['gpt_prompt']['sample_walk_dedup'],
        paths['gpt_prompt']['gather_rows']) != (3, 0):
      raise AssertionError(f'gpt prompt path launched {paths["gpt_prompt"]}')
    sizes = [(p.count('"'), p.count('->')) for p in prompts]
    print(f'gpt on graphs ({GPT_PAPERS} papers, [12, 6], batch 2 with '
          f'binary negatives): 3 prompts equal to the plain versions\' '
          f'(title quotes and citations each: {sizes}; '
          f'{len(out.getvalue())} characters printed); launches '
          f'{paths["gpt_prompt"]}')

  with Phase('rooflines'):
    K.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
      c = device_ceilings(dev, refresh=True,
                          cache_path=f'{tmp}/roofline.json')
    paths['rooflines'] = {fn.__name__: fn.launches for fn in K.KERNELS}
    gauges = {k: v for k, v in get_registry().snapshot()['gauges'].items()
              if k.startswith('roofline_')}
    if len(gauges) != 2 or c['platform'] != 'cuda':
      raise AssertionError(f'ceilings {c}, gauges {gauges}')
    bw, fl = c['hbm_bytes_per_sec'], c['flops_per_sec']
    print(f'measured ceilings of {c["device_kind"]}: device memory stream '
          f'(2 * x + y over 256 MiB float32 arrays, 12 B an element, best '
          f'of 5) {bw / 1e12:.4f} TB/s, {bw / HBM_BYTES_PER_S * 100:.1f}% of '
          f'the data sheet\'s {HBM_BYTES_PER_S / 1e12:.2f} TB/s that the '
          f'kernel table\'s bounds use; float32 GEMM (2048 x 2048, TF32 off, '
          f'best of 5) {fl / 1e12:.3f} TFLOP/s, {fl / FP32_FLOPS * 100:.1f}% '
          f'of the data sheet\'s {FP32_FLOPS / 1e12:.0f} TFLOP/s; gauges '
          f'{sorted(gauges)}; on {smi}')

  with Phase('segment mean'):
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    msgs = torch.randn((SEG_ROWS, SEG_DIM), generator=gen, device=dev)
    targets = torch.randint(0, SEG_SEGMENTS, (SEG_ROWS,), generator=gen,
                            device=dev, dtype=torch.int32)
    mask = torch.rand(SEG_ROWS, generator=gen, device=dev) < 0.9
    with socket.socket() as sock:
      sock.bind(('127.0.0.1', 0))
      port = sock.getsockname()[1]
    dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:{port}',
                            world_size=1, rank=0)
    K.reset_launch_counts()
    try:
      full = sharded_segment_mean(msgs, targets, mask, SEG_SEGMENTS)
      scat = sharded_segment_mean_scattered(msgs, targets, mask,
                                            SEG_SEGMENTS)
      torch.cuda.synchronize()
    finally:
      dist.destroy_process_group()
    # no kernel of the port: index_add_ sums, NCCL reduces
    paths['segment_mean'] = {fn.__name__: fn.launches for fn in K.KERNELS}
    seg = targets.long()[mask]
    ref = torch.zeros((SEG_SEGMENTS, SEG_DIM), device=dev).index_add_(
        0, seg, msgs[mask])
    cnt = torch.zeros(SEG_SEGMENTS, device=dev).index_add_(
        0, seg, torch.ones_like(seg, dtype=torch.float32))
    ref = ref / cnt.clamp(min=1.0)[:, None]
    errs = [float((x - ref).abs().max()) for x in (full, scat)]
    if max(errs) > SEG_TOL:
      raise AssertionError(f'sharded segment means off by {errs}')
    print(f'sharded_segment_mean and sharded_segment_mean_scattered over a '
          f'one-rank NCCL group ({SEG_ROWS} rows x {SEG_DIM}, '
          f'{SEG_SEGMENTS} segments, {int(mask.sum())} valid rows): max '
          f'|diff| {errs[0]:.3e} and {errs[1]:.3e} against one index_add_ '
          f'mean (tolerance {SEG_TOL})')
    del msgs, targets, mask, full, scat, ref, cnt, seg
  return paths


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
    # (1) a captured window against its batches a call at a time, with
    # deterministic algorithms: index_add_'s float atomics sum in another
    # order from run to run, and 16 Adam steps carried that noise to
    # 0.24-1.08 of the tolerance (PERF.md §6)
    with deterministic(torch) as ops:
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
          f'{2 * SS_K} per-batch calls, deterministic algorithms on (ops '
          f'without a deterministic version: {sorted(ops) or "none"}): '
          f'losses within {diff:.3e} (tolerance {LOSS_TOL}); capture '
          f'{a.capture_seconds[0] * 1e3:.1f} ms')
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
# eval batches, a window of DIST_K batches as one CUDA graph (four, cut
# from eight for the script's time limit)
DIST_WARMUP, DIST_STEPS, DIST_EVAL, DIST_K = 2, 10, 3, 4
DIST_FIELDS = ('node_dict', 'node_count_dict', 'row_dict', 'col_dict',
               'edge_mask_dict', 'x_dict', 'y_dict')


def dist_phases(torch, np, K, dev, seed, k3, rows, mixed, smi):
  """The partitioned hetero trainer: the igbh-rgat graph synthesised on the
  card, partitioned on disk by the port's RandomPartitioner (one part: one
  rank), loaded back through DistHeteroGraph, DistDataset and a bf16
  DistFeature a node type, then trained by DistHeteroTrainStep a batch a
  step and a window at a time; then over spilled stores of the same
  partition, through a checkpoint and a resume, and the single-device
  weighted hetero loader over the same graph (igbh_split_phases,
  hetero_weighted_phases). Returns the launches of the per-batch path,
  for the superstep paths their launches (eager plus graph replays) and
  those their replays made, by wrapper name, the weighted path's, and
  the launches of the new paths by path name."""
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
    # float32 edge weights in (0, 1] on every edge type, from their own
    # stream: the weighted path's (the uniform trainers ignore them)
    wgen = torch.Generator(device=dev).manual_seed(seed + 24)
    weights = {e: (1.0 - torch.rand(ei.shape[1], generator=wgen,
                                    device=dev)).cpu().numpy()
               for e, ei in edges.items()}
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
                        edge_weights=weights, seed=seed).partition()
      t.append(time.perf_counter())
      disk = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(root) for f in fs)
      feat_bytes = sum(f.nbytes for f in feats.values())
      n_edges = sum(e.shape[1] for e in edges.values())
      # the graph, its weights and float32 features stay on the host for
      # the single-device weighted loader (hetero weighted path)
      igbh_host = dict(edges=edges, weights=weights, feats=feats)
      del feats, edges, weights
      mesh = make_mesh(device=dev)
      dg = DistHeteroGraph.from_dataset_partitions(mesh, root)
      torch.cuda.synchronize()
      t.append(time.perf_counter())
      # the partition loaded to the host once: the resident stores copy
      # it to the card, igbh split path's spilled stores split it
      dss_host = {0: DistDataset.load(root, 0, feature_dtype=torch.bfloat16,
                                      device='cpu')}
      t.append(time.perf_counter())
      dfeats = {tp: DistFeature.from_dist_datasets(mesh, dss_host, ntype=tp,
                                                   dtype=torch.bfloat16)
                for tp in IGBH_NODES}
      torch.cuda.synchronize()
      t.append(time.perf_counter())
    finally:
      shutil.rmtree(root, ignore_errors=True)
    secs = np.diff(t)
    store = sum(f.array.numel() * f.array.element_size()
                for f in dfeats.values())
    graph_bytes = sum(sum(getattr(st, f).numel() * getattr(st, f).element_size()
                          for f in ('indptr', 'indices', 'edge_ids',
                                    'edge_weights', 'local_row', 'node_pb'))
                      for st in dg.graphs.values())
    print(f'dist data: {n_edges} edges over {len(dg.graphs)} types '
          '(float32 weights in (0, 1] on each), '
          f'{IGBH_NODES}; synthesised on the card and copied to the host '
          f'{secs[0]:.3f} s ({feat_bytes} B of float32 features); partitioned '
          f'(RandomPartitioner, one part) {secs[1]:.3f} s, {disk} B on disk; '
          f'DistHeteroGraph {secs[2]:.3f} s ({graph_bytes} B on the card); '
          f'DistDataset.load to the host (bf16 Feature) {secs[3]:.3f} s; '
          f'DistFeature.from_dist_datasets, copied to the card, '
          f'{secs[4]:.3f} s ({store} B of bf16 rows on the card); '
          f'{train_idx.size} training and '
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
    dist_ms = ms
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
    del a
    torch.cuda.empty_cache()

  paths, split_ss = igbh_split_phases(
      torch, np, K, dev, seed, smi, mesh, dg, dfeats, dss_host, labels,
      keys, order, store, dist_ms, mixed)
  del dss_host
  torch.cuda.empty_cache()
  weighted_launches = dist_weighted_phases(
      torch, np, K, dev, seed, rows, smi, dg, dfeats, labels, keys, order)
  del dfeats, dg
  torch.cuda.empty_cache()
  paths.update(hetero_weighted_phases(torch, np, K, dev, seed, rows, k3, smi,
                                      igbh_host, labels, train_idx))
  return dist_launches, (ss_launches, split_ss), weighted_launches, paths


# the IGBH trainer beyond the resident store (examples/igbh/
# dist_train_rgnn.py --split-ratio, --ckpt-dir/--resume, --coordinator):
# the partition of dist_phases loaded to the host and served from split
# 0.2 stores, a checkpoint after DIST_WARMUP steps restored into a fresh
# trainer, the example itself at IGBH_EXAMPLE_PAPERS papers with those
# flags and in its multihost mode
IGBH_SPLIT = 0.2
IGBH_EXAMPLE_PAPERS = 10_000
WINDOW_LOSS_TOL = 1e-4   # a captured window's losses against per-batch
RESUME_TOL = 1e-5        # a resumed trainer's parameters, if not bit-equal
# the single-device weighted hetero loader over the igbh-rgat graph: 2 + 5
# steps; a [-1, -1] batch in windows of HW_FULL_CAP; a batch seeded with
# HW_AUTHORS authors beside the papers
HW_WARMUP, HW_STEPS, HW_FULL_CAP, HW_AUTHORS = 2, 5, 8, 32
# the loader options over products-sage: the prefetch and as_pyg_v1
# loaders' epoch of LOADER_BATCHES batches
LOADER_BATCHES = 3


def cpu_tree(torch, x):
  """``x`` (tensors in dicts, lists and tuples) with every tensor copied
  to the host."""
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().clone()
  if isinstance(x, dict):
    return {k: cpu_tree(torch, v) for k, v in x.items()}
  if isinstance(x, (list, tuple)):
    return type(x)(cpu_tree(torch, v) for v in x)
  return x


def differing_leaf(torch, a, b, path=''):
  """The path of the first leaf that differs between trees ``a`` and
  ``b`` (tensors compared bit for bit on the host), else None."""
  if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
    same = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and torch.equal(a.cpu(), b.cpu()))
    return None if same else path
  if isinstance(a, dict) and isinstance(b, dict):
    if set(map(str, a)) != set(map(str, b)):
      return path + '/<keys>'
    for k in a:
      d = differing_leaf(torch, a[k], b[k], f'{path}/{k}')
      if d is not None:
        return d
    return None
  if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
    if len(a) != len(b):
      return path + '/<len>'
    for i, (x, y) in enumerate(zip(a, b)):
      d = differing_leaf(torch, x, y, f'{path}/{i}')
      if d is not None:
        return d
    return None
  return None if a == b else path


@contextlib.contextmanager
def deterministic(torch):
  """While open, ``torch.use_deterministic_algorithms`` (warn only: the
  names of the ops that have no deterministic version collect in the
  yielded set) without filling new memory, and the cuBLAS workspace
  setting it asks for."""
  import os
  import warnings
  env = os.environ.get('CUBLAS_WORKSPACE_CONFIG')
  os.environ['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'
  det = getattr(torch.utils, 'deterministic', None)
  fill = getattr(det, 'fill_uninitialized_memory', None)
  if fill is not None:
    det.fill_uninitialized_memory = False
  ops = set()
  torch.use_deterministic_algorithms(True, warn_only=True)
  try:
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter('always')
      yield ops
    ops.update(str(w.message).split(' does not have a deterministic')[0]
               for w in caught if 'deterministic' in str(w.message))
  finally:
    torch.use_deterministic_algorithms(False)
    if fill is not None:
      det.fill_uninitialized_memory = fill
    if env is None:
      os.environ.pop('CUBLAS_WORKSPACE_CONFIG', None)
    else:
      os.environ['CUBLAS_WORKSPACE_CONFIG'] = env


def igbh_split_phases(torch, np, K, dev, seed, smi, mesh, dg, dfeats,
                      dss_host, labels, keys, order, store, dist_ms, mixed):
  """DistHeteroTrainStep at igbh-rgat's width over spilled stores of the
  dist_phases partition (``dss_host``, on the host): each type's owner
  serves its hot and cold rows in one K3 mixed launch. Card bytes against
  the resident stores' (``store``), one batch against the resident
  stores', 2 + 10 steps beside ``dist main path``'s (``dist_ms``), mixed
  K3 a type against its bound (rows into ``mixed``), two windows of
  DIST_K as one CUDA graph against the per-batch steps; a checkpoint after
  DIST_WARMUP steps restored into a fresh trainer, then the example with
  --split-ratio, --ckpt-dir, --resume and in its multihost mode. Every
  step's uniforms are ``step_uniforms(seed, global step)``. Returns the
  paths' launches by path and the superstep path's (eager plus graph
  replays, replays)."""
  import builtins
  import io
  import os
  import shutil
  import socket
  import tempfile
  import torch.distributed as dist
  from glt_tpu_torch.distributed import DistFeature, DistHeteroTrainStep
  from glt_tpu_torch.examples.igbh import dist_train_rgnn as example
  from glt_tpu_torch.models import RGNN
  from glt_tpu_torch.parallel import sage_loss
  from glt_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                              save_checkpoint)

  fanouts = list(FANOUTS)
  paths = {}
  one = np.ones(1, np.int64) * HTRAIN_BATCH

  def trainer(stores):
    torch.manual_seed(seed)
    model = RGNN(keys, IGBH_FEAT, IGBH_HIDDEN, IGBH_CLASSES,
                 num_layers=len(fanouts), conv='rgat', heads=IGBH_HEADS,
                 node_types=list(IGBH_NODES)).to(dev)
    return DistHeteroTrainStep(dg, stores, model, {'paper': labels},
                               fanouts, HTRAIN_BATCH, 'paper', lr=LR,
                               seed=seed)

  def seeds_of(i):
    return order[i * HTRAIN_BATCH:(i + 1) * HTRAIN_BATCH][None]

  def state(step):
    return cpu_tree(torch, dict(params=step.model.state_dict(),
                                opt_state=step.optimizer.state_dict()))

  with Phase('igbh split path'):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dfs = {tp: DistFeature.from_dist_datasets(
        mesh, dss_host, ntype=tp, dtype=torch.bfloat16,
        split_ratio=IGBH_SPLIT) for tp in IGBH_NODES}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    card = {tp: f.array.numel() * f.array.element_size()
            for tp, f in dfs.items()}
    pinned = {tp: f.cold_array.numel() * f.cold_array.element_size()
              for tp, f in dfs.items()}
    if any(f.cold_pinned is None for f in dfs.values()):
      raise AssertionError('a spilled store has no pinned cold block')
    if not sum(card.values()) < store:
      raise AssertionError(f'split stores hold {sum(card.values())} B on '
                           f'the card, the resident ones {store} B')
    print(f'igbh split {IGBH_SPLIT}: DistFeature.from_dist_datasets over the '
          f'host partition {build_s:.3f} s; on the card {card} B, '
          f'{sum(card.values())} B in all against the resident stores\' '
          f'{store} B ({sum(card.values()) / store * 100:.1f}%); pinned '
          f'cold blocks {pinned} B')

    # one batch from the resident and the split stores, same weights,
    # seeds and uniforms; then its mixed K3 serves recorded (through the
    # plain twin, as the kernel's inputs) and timed a type
    res, a = trainer(dfeats), trainer(dfs)
    s0 = torch.as_tensor(order[-HTRAIN_BATCH:], device=dev,
                         dtype=torch.int32)
    n0 = torch.tensor(HTRAIN_BATCH - 5, device=dev, dtype=torch.int32)
    u0 = [[None if x is None else x[mesh.rank] for x in hop]
          for hop in example.step_uniforms(a, seed, 10 ** 6)]
    served = []

    def record_mixed(hot, cold, rows):
      served.append((hot, cold, rows))
      return K.gather_rows_mixed_plain(hot, cold, rows)
    with torch.no_grad():
      br = res.make_batch(s0, n0, u0)
      yr = res.model(br)
      lr_ = float(sage_loss(res.model, br))
      bs_ = a.make_batch(s0, n0, u0)
      ys = a.model(bs_)
      ls = float(sage_loss(a.model, bs_))
      real = K.gather_rows_mixed
      K.gather_rows_mixed = record_mixed
      try:
        bp = a.make_batch(s0, n0, u0)
      finally:
        K.gather_rows_mixed = real
    for label, other in (('resident', br), ('plain', bp)):
      f = differing_field(torch, bs_, other, DIST_FIELDS)
      if f is not None:
        raise AssertionError(f'igbh split batch.{f} differs from the '
                             f'{label} one')
    diff = float((ys - yr).abs().max())
    if not (torch.allclose(ys, yr, rtol=LOGIT_TOL, atol=LOGIT_TOL)
            and abs(ls - lr_) <= LOSS_TOL * max(1.0, abs(lr_))):
      raise AssertionError(f'igbh split logits differ from the resident '
                           f'ones by {diff}, loss {ls} vs {lr_}')
    if len(served) != len(IGBH_NODES):
      raise AssertionError(f'{len(served)} mixed K3 serves in a batch, '
                           f'expected {len(IGBH_NODES)}')
    print(f'igbh split batch {HTRAIN_BATCH} ({int(n0)} real seeds): every '
          'field bit-identical to the resident stores\' and the plain '
          f'versions\' ({sum(int(c) for c in bs_.node_count_dict.values())} '
          f'nodes); logits {"bit-equal" if torch.equal(ys, yr) else "differ"}'
          f' (max |diff| {diff:.3e}, tolerance {LOGIT_TOL}), loss '
          f'{ls:.6f} vs {lr_:.6f}')
    rate = link_rate(torch, dfs['paper'].cold_array, dev)
    by_block = {f.array.data_ptr(): tp for tp, f in dfs.items()}
    for hot, cold, rows in served:
      tp = by_block[hot.data_ptr()]
      label = f'igbh bfloat16 x 1024 {tp} split {IGBH_SPLIT}'
      mixed[label] = time_mixed(torch, np, K, label, hot, cold, rows, rate,
                                resident=dfeats[tp].array)
    del res, br, yr, bs_, ys, bp, served
    torch.cuda.empty_cache()

    # 2 + 10 steps a batch a step, each synced and timed
    b = trainer(dfs)
    shapes = b.sampler.uniform_shapes(HTRAIN_BATCH, 'paper')
    b2_per_step = sum(len(h) for h in shapes)
    losses, secs = [], []
    for i in range(DIST_WARMUP + DIST_STEPS):
      if i == DIST_WARMUP:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
      t0 = time.perf_counter()
      losses.append(b(seeds_of(i), one, example.step_uniforms(b, seed, i)))
      torch.cuda.synchronize()
      secs.append(time.perf_counter() - t0)
    paths['igbh_split'] = {fn.__name__: fn.launches for fn in K.KERNELS}
    peak = torch.cuda.max_memory_allocated() - base
    losses = [float(v) for v in losses]
    want = dict(sample_hop=b2_per_step * DIST_STEPS,
                gather_rows_mixed=len(IGBH_NODES) * DIST_STEPS,
                gather_rows=0)
    for n, v in want.items():
      if paths['igbh_split'][n] != v:
        raise AssertionError(f'igbh split: {paths["igbh_split"][n]} {n} '
                             f'launches over {DIST_STEPS} steps, expected {v}')
    if not np.isfinite(losses).all():
      raise AssertionError(f'igbh split training: non-finite loss {losses}')
    timed = np.array(secs[DIST_WARMUP:]) * 1e3
    med = float(np.median(timed))
    print(f'igbh split training (one rank, batch {HTRAIN_BATCH}, {fanouts}, '
          f'split {IGBH_SPLIT}): {DIST_STEPS} steps after {DIST_WARMUP} '
          f'warm-up, median {med:.3f} ms a step (mean {timed.mean():.3f}, '
          f'quartiles {np.percentile(timed, 25):.3f}-'
          f'{np.percentile(timed, 75):.3f}, min {timed.min():.3f}, max '
          f'{timed.max():.3f}), {HTRAIN_BATCH / med * 1e3:.1f} seeds/s; the '
          f'resident dist main path {dist_ms:.3f} ms a step (mean), split/'
          f'resident {med / dist_ms:.4f} (median), '
          f'{timed.mean() / dist_ms:.4f} (mean); peak {peak / 2**30:.3f} GiB '
          f'above {base / 2**30:.3f} GiB resident; losses '
          + ', '.join(f'{v:.4f}' for v in losses)
          + f'; launches {paths["igbh_split"]}; on {smi}')
    del b
    torch.cuda.empty_cache()

    # the first 2 * DIST_K of those steps through trainer a as two windows
    # of DIST_K: the first eager and captured, the second a replay of the
    # CUDA graph
    K.reset_launch_counts()
    window_losses = []
    start = 0
    for w in range(2):
      idx = range(start + w * DIST_K, start + (w + 1) * DIST_K)
      us = [example.step_uniforms(a, seed, i) for i in idx]
      u = [[None if us[0][h][j] is None else
            torch.stack([x[h][j] for x in us])
            for j in range(len(us[0][h]))] for h in range(len(us[0]))]
      window_losses.append(a.superstep(
          np.concatenate([seeds_of(i) for i in idx]),
          np.full((DIST_K, 1), HTRAIN_BATCH), u))
    eager, replayed, launches = path_launches(K, a)
    got = torch.cat(window_losses).cpu().numpy()
    per_batch = np.array(losses[start:start + 2 * DIST_K])
    diffs = np.abs(got - per_batch)
    if (a.superstep_captures, a.graph_replays) != (1, 1) or not (
        diffs.max() <= WINDOW_LOSS_TOL):
      raise AssertionError(f'igbh split superstep: captures '
                           f'{a.superstep_captures}, replays '
                           f'{a.graph_replays}, losses differ from the '
                           f'per-batch steps by up to {diffs.max()}')
    per = len(IGBH_NODES) * DIST_K
    if (eager['gather_rows_mixed'], replayed.get('gather_rows_mixed', 0)
        ) != (per, per):
      raise AssertionError(f'igbh split superstep: mixed K3 {eager} eager, '
                           f'{replayed} by replays')
    print_windows(a)
    print(f'igbh split superstep, two windows of {DIST_K} (steps '
          f'{start + 1}-{start + 2 * DIST_K}): the first eager '
          f'and captured ({a.capture_seconds[0] * 1e3:.1f} ms to capture), '
          'the second a replay of the CUDA graph, K3 mixed inside it; '
          f'losses against the per-batch steps: the eager window max |diff| '
          f'{diffs[:DIST_K].max():.3e}, the replayed one '
          f'{diffs[DIST_K:].max():.3e} (tolerance {WINDOW_LOSS_TOL}); '
          f'launches {launches}: eager {eager}, by graph replays {replayed};'
          f' on {smi}')
    split_ss = (launches, replayed)
    del a, window_losses
    torch.cuda.empty_cache()

  with Phase('igbh resume path'):
    # uninterrupted: DIST_WARMUP steps, a checkpoint, 2 more steps; then a
    # fresh trainer restored from the checkpoint takes the same 2 steps.
    # Both under torch.use_deterministic_algorithms: the step's index_add_
    # otherwise sums in another order from run to run, and Adam turns
    # float noise in a near-zero gradient into a move of up to lr
    d = trainer(dfs)
    with deterministic(torch) as nondet:
      for i in range(DIST_WARMUP):
        d(seeds_of(i), one, example.step_uniforms(d, seed, i))
      saved = state(d)
      ckpt = tempfile.mkdtemp(prefix='glt_igbh_ckpt_')
      t0 = time.perf_counter()
      save_checkpoint(ckpt, DIST_WARMUP, d.model.state_dict(),
                      opt_state=d.optimizer.state_dict())
      save_s = time.perf_counter() - t0
      for i in range(DIST_WARMUP, DIST_WARMUP + 2):
        d(seeds_of(i), one, example.step_uniforms(d, seed, i))
    uninterrupted = state(d)
    del d
    torch.cuda.empty_cache()
    c = trainer(dfs)
    t0 = time.perf_counter()
    got_step, payload = restore_checkpoint(
        ckpt, template={'params': c.model.state_dict()})
    c.model.load_state_dict(payload['params'])
    c.optimizer.load_state_dict(payload['opt_state'])
    restore_s = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    leaf = differing_leaf(torch, state(c), saved)
    if got_step != DIST_WARMUP or leaf is not None:
      raise AssertionError(f'restored step {got_step}, state differs from '
                           f'the saved one at {leaf}')
    with deterministic(torch) as nondet_c:
      for i in range(DIST_WARMUP, DIST_WARMUP + 2):
        c(seeds_of(i), one, example.step_uniforms(c, seed, i))
    after = state(c)
    leaf = differing_leaf(torch, after, uninterrupted)
    pdiff = max(float((after['params'][k] - v).abs().max())
                for k, v in uninterrupted['params'].items())
    if pdiff > RESUME_TOL:
      raise AssertionError(f'resumed parameters differ from the '
                           f'uninterrupted run by {pdiff}')
    print(f'igbh resume: checkpoint at step {DIST_WARMUP} saved in '
          f'{save_s:.3f} s, restored into a fresh trainer in '
          f'{restore_s:.3f} s, its model and Adam state bit-equal to the '
          f'saved ones; 2 more steps: model and Adam state '
          + ('bit-equal to' if leaf is None else
             f'first differ at {leaf}, parameters by up to {pdiff:.3e} '
             f'(tolerance {RESUME_TOL}) from')
          + f' the uninterrupted run\'s after {DIST_WARMUP + 2} steps '
          '(torch.use_deterministic_algorithms on for these steps; ops '
          f'without a deterministic version: {sorted(nondet | nondet_c)})')
    del c, dfs, saved, uninterrupted, after
    torch.cuda.empty_cache()

    # the example itself on the card: spilled stores, checkpoints every 2
    # steps, then resumed from the last one
    work = tempfile.mkdtemp(prefix='glt_igbh_example_')
    data, part = os.path.join(work, 'data'), os.path.join(work, 'parts')
    ck = os.path.join(work, 'ckpt')
    args = ['--papers', str(IGBH_EXAMPLE_PAPERS), '--data-root', data,
            '--part-root', part, '--split-ratio', str(IGBH_SPLIT),
            '--ckpt-dir', ck, '--ckpt-steps', '1', '--steps-per-epoch', '2',
            '--batch-size', str(HTRAIN_BATCH), '--fanout',
            ','.join(map(str, fanouts)), '--val-batches', '1', '--seed',
            str(seed)]
    runs = []
    for extra in ([], ['--resume']):
      K.reset_launch_counts()
      log = io.StringIO()
      t0 = time.perf_counter()
      with contextlib.redirect_stdout(log):
        out = example.main(args + extra)
      runs.append((out, time.perf_counter() - t0,
                   {fn.__name__: fn.launches for fn in K.KERNELS},
                   sorted(os.listdir(ck)), log.getvalue()))
    (first, s1, l1, ck1, log1), (second, s2, l2, ck2, log2) = runs
    last = restore_checkpoint(ck)[1]['params']
    if not ((first['start_step'], first['steps'], ck1)
            == (0, 2, ['1', '2'])
            and (second['start_step'], second['steps'], ck2)
            == (2, 4, ['2', '3', '4'])
            and all(first['spilled'].values())
            and 'resumed from checkpoint step 2' in log2
            and all(torch.equal(last[k], v.cpu())
                    for k, v in second['params'].items())
            and np.isfinite(first['losses'] + second['losses']).all()):
      raise AssertionError(f'igbh example: {first["start_step"]}-'
                           f'{first["steps"]} {ck1}, {second["start_step"]}-'
                           f'{second["steps"]} {ck2}; {log2[-2000:]}')
    paths['igbh_example'] = {n: l1[n] + l2[n] for n in l1}
    print(f'igbh example at {IGBH_EXAMPLE_PAPERS} papers (--split-ratio '
          f'{IGBH_SPLIT} --ckpt-steps 1, 2 steps): {s1:.3f} s with the '
          f'synthesis and partition, checkpoints {ck1}, cold blocks '
          f'{first["spilled"]}; --resume: from step {second["start_step"]} '
          f'to {second["steps"]} in {s2:.3f} s, checkpoints {ck2}, the last '
          f'one bit-equal to the run\'s parameters; launches '
          f'{paths["igbh_example"]}')

  with Phase('igbh multihost path'):
    # the example's multihost mode over the same trees, one rank, in this
    # process; the files it opens recorded as it opens them
    with socket.socket() as sock:
      sock.bind(('127.0.0.1', 0))
      port = sock.getsockname()[1]
    argv = ['--data-root', data, '--part-root', part, '--split-ratio',
            str(IGBH_SPLIT), '--steps-per-epoch', '1', '--batch-size',
            str(HTRAIN_BATCH), '--fanout', ','.join(map(str, fanouts)),
            '--val-batches', '1', '--seed', str(seed), '--coordinator',
            f'127.0.0.1:{port}', '--nprocs', '1', '--rank', '0']
    opened = set()
    real_open = builtins.open

    def recording(file, *a, **k):
      if isinstance(file, (str, os.PathLike)):
        opened.add(os.path.abspath(os.fspath(file)))
      return real_open(file, *a, **k)
    K.reset_launch_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    builtins.open = recording
    try:
      with contextlib.redirect_stdout(log):
        got = example.main(argv)
    finally:
      builtins.open = real_open
      if dist.is_initialized():      # the example ends its group itself
        dist.destroy_process_group()
    secs = time.perf_counter() - t0
    paths['igbh_multihost'] = {fn.__name__: fn.launches for fn in K.KERNELS}
    roots = (os.path.abspath(data), os.path.abspath(part))
    opened = sorted(p for p in opened if p.startswith(roots))
    read = sum(os.path.getsize(p) for p in opened if os.path.isfile(p))
    tree = disk_bytes(data) + disk_bytes(part)
    loaded_feats = [p for p in opened if p.startswith(roots[0]) and
                    ('node_feat' in p or 'edge_index' in p)]
    if (loaded_feats or got['steps'] != 1 or not all(got['spilled'].values())
        or not np.isfinite(got['losses']).all()):
      raise AssertionError(f'multihost rank: {got["steps"]} steps, spilled '
                           f'{got["spilled"]}, read {loaded_feats}; '
                           f'{log.getvalue()[-2000:]}')
    print(f'igbh multihost (--coordinator 127.0.0.1:{port} --nprocs 1 '
          f'--rank 0, split {IGBH_SPLIT}): {secs:.3f} s; it opened '
          f'{len(opened)} files of the two trees, {read} B, against the '
          f'trees\' {tree} B ({read / tree * 100:.1f}%), no feature table or '
          f'edge payload of the data tree; losses {got["losses"]}; launches '
          f'{paths["igbh_multihost"]}')
    shutil.rmtree(work, ignore_errors=True)
  return paths, split_ss


def hetero_weighted_phases(torch, np, K, dev, seed, rows, k3, smi, host,
                           labels, train_idx):
  """The single-device hetero NeighborLoader(with_weight=True) over the
  igbh-rgat graph of dist_phases with its float32 weights (``host``:
  edges, weights and float32 features on the host, emptied here), RGAT
  at igbh-rgat's width on a bf16 store and Adam: each edge type's weighted
  hop reads its weight window through B3, picks by Gumbel top-k and reads
  the picks through B2 (the per-hop loop). 2 + 5 steps, one batch against
  the plain versions with B3 and B2 timed at its shapes; a [-1, -1] batch
  in windows of HW_FULL_CAP and a batch seeded with papers and authors
  (the uniform walk: K2's init for both types, B1 a hop), each against
  its plain versions. Returns the launches by path."""
  from glt_tpu_torch.data import Dataset
  from glt_tpu_torch.data.feature import gather_features
  from glt_tpu_torch.loader import NeighborLoader
  from glt_tpu_torch.models import RGNN
  from glt_tpu_torch.parallel import SageTrainStep, sage_loss
  from glt_tpu_torch.sampler import NeighborSampler
  from glt_tpu_torch.sampler.base import NodeSamplerInput
  from glt_tpu_torch.typing import reverse_edge_type

  paths = {}
  sample_fields = ('node', 'node_count', 'row', 'col', 'edge_mask',
                   'num_sampled_nodes', 'num_sampled_edges')
  with Phase('hetero weighted path'):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hds = Dataset().init_graph(host['edges'], edge_weights=host['weights'],
                               num_nodes=IGBH_NODES, device=dev)
    hds.init_node_features(host['feats'], dtype=torch.bfloat16, device=dev)
    hds.init_node_labels({'paper': labels})
    host.clear()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    etypes = hds.get_edge_types()
    mp_etypes = [reverse_edge_type(e) for e in etypes]
    loader = NeighborLoader(hds, list(FANOUTS), ('paper', train_idx),
                            batch_size=HTRAIN_BATCH, shuffle=True,
                            with_weight=True, device=dev, seed=seed,
                            rng=np.random.default_rng(seed))
    sampler = loader.sampler
    if sampler._weighted_types != set(etypes):
      raise AssertionError(f'weighted edge types {sampler._weighted_types}')
    caps = sampler._hetero_caps({'paper': HTRAIN_BATCH})[0]
    segs = sum(1 for h in range(len(FANOUTS))
               for e, (row_t, _) in sampler._traversal_types().items()
               if caps[h][row_t])
    print(f'hetero weighted: the igbh-rgat graph and bf16 store on the card '
          f'in {build_s:.3f} s; weight windows (max degree by relation) '
          f'{ {e[1]: sampler._max_degrees[e] for e in etypes} }; {segs} '
          'weighted segments a batch')

    def model():
      torch.manual_seed(seed)
      return RGNN(mp_etypes, IGBH_FEAT, IGBH_HIDDEN, IGBH_CLASSES,
                  num_layers=len(FANOUTS), conv='rgat',
                  heads=IGBH_HEADS).to(dev)
    net = model()
    step = SageTrainStep(net, lr=LR)
    per_step = dict(sample_hop=segs, gather_windows=segs,
                    gather_rows=len(IGBH_NODES), sample_hop_dedup=0,
                    sample_walk_dedup=0)
    it = iter(loader)
    losses, secs = [], []
    for i in range(HW_WARMUP + HW_STEPS):
      if i == HW_WARMUP:
        torch.cuda.synchronize()
        K.reset_launch_counts()
      before = {n: getattr(K, n).launches for n in per_step}
      t0 = time.perf_counter()
      losses.append(step(next(it)))
      torch.cuda.synchronize()
      secs.append(time.perf_counter() - t0)
      for n, want in per_step.items():
        if getattr(K, n).launches - before[n] != want:
          raise AssertionError(
              f'hetero weighted step {i}: {getattr(K, n).launches - before[n]}'
              f' {n} launches, expected {want}')
    paths['hetero_weighted'] = {fn.__name__: fn.launches for fn in K.KERNELS}
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
      raise AssertionError(f'hetero weighted: non-finite loss {losses}')
    timed = np.array(secs[HW_WARMUP:]) * 1e3
    med = float(np.median(timed))
    base = HTRAIN_MEDIAN.get('ms')
    print(f'hetero weighted training (one card, batch {HTRAIN_BATCH}, '
          f'{list(FANOUTS)}, RGAT {IGBH_FEAT} -> {IGBH_HIDDEN} x {IGBH_HEADS} '
          f'-> {IGBH_CLASSES}, bf16 store): {HW_STEPS} steps after '
          f'{HW_WARMUP} warm-up, median {med:.3f} ms a step (min '
          f'{timed.min():.3f}, max {timed.max():.3f}), '
          f'{HTRAIN_BATCH / med * 1e3:.1f} seeds/s; hetero train main path '
          f'(uniform, B1) median {base if base is None else f"{base:.3f}"} '
          'ms; losses ' + ', '.join(f'{v:.4f}' for v in losses)
          + f'; launches {paths["hetero_weighted"]}; on {smi}')

    n_valid = HTRAIN_BATCH - 1
    seeds = np.concatenate([train_idx[:n_valid],
                            np.full(HTRAIN_BATCH - n_valid, train_idx[0])])
    u = sampler.hop_uniforms(HTRAIN_BATCH, 'paper')

    def one_batch():
      out = sampler.sample_from_nodes(NodeSamplerInput(seeds, 'paper'),
                                      n_valid, uniforms=u)
      return loader._collate(out, seeds, n_valid)
    with torch.no_grad():
      bk = one_batch()
      lk = float(sage_loss(net, bk))
      with recorded_calls(K, ('sample_hop', 'gather_windows',
                              'gather_rows')) as calls:
        bp = one_batch()
        lp = float(sage_loss(net, bp))
    f = differing_field(torch, bk, bp, HETERO_BATCH_FIELDS)
    if f is not None:
      raise AssertionError(f'hetero weighted batch.{f} differs between '
                           'kernels and plain')
    if not abs(lk - lp) <= LOSS_TOL * max(1.0, abs(lp)):
      raise AssertionError(f'hetero weighted loss {lk} vs plain {lp}')
    print(f'hetero weighted batch {HTRAIN_BATCH} ({n_valid} real seeds): '
          'bit-identical ('
          f'{sum(int(c) for c in bk.node_count_dict.values())} nodes, '
          f'{sum(int(m.sum()) for m in bk.edge_mask_dict.values())} edges), '
          f'loss {lk:.6f} vs plain {lp:.6f} (|diff| {abs(lk - lp):.3e}, '
          f'tolerance {LOSS_TOL})')
    label = f'hetero weighted batch ({segs} hops)'
    rows['gather_windows'].setdefault('shapes', {})[label] = time_windows(
        torch, np, K, 'hetero weighted batch', calls['gather_windows'])
    rows['sample_hop'].setdefault('shapes', {})[label] = time_picks(
        torch, np, K, 'hetero weighted batch', calls['sample_hop'])
    del bk, bp, calls, it, step, net
    torch.cuda.empty_cache()

    # a [-1, -1] batch in windows of HW_FULL_CAP, and one seeded with
    # papers and authors through the uniform walk, each against plain
    full = NeighborSampler(hds.graph, [-1, -1], device=dev,
                           full_neighbor_cap=HW_FULL_CAP, seed=seed)
    types = NeighborSampler(hds.graph, list(FANOUTS), device=dev, seed=seed)
    authors = np.arange(HW_AUTHORS) * (IGBH_NODES['author'] // HW_AUTHORS)
    cases = (
        ('full', full, NodeSamplerInput(seeds, 'paper'), None,
         full.hop_uniforms(HTRAIN_BATCH, 'paper'),
         ('gather_windows', 'gather_rows')),
        ('types', types, {'paper': seeds, 'author': authors}, 'author',
         types.hop_uniforms({'paper': HTRAIN_BATCH, 'author': HW_AUTHORS}),
         ('sample_hop_dedup', 'dedup_table_init', 'dedup_table_init_types',
          'gather_rows')))
    for name, smp, inputs, seed_type, uu, swapped in cases:
      def sample():
        out = smp.sample_from_nodes(inputs, uniforms=uu, seed_type=seed_type)
        x = {t: gather_features(hds.get_node_feature(t), n)
             for t, n in out.node.items()}
        return out, x
      K.reset_launch_counts()
      ok, xk = sample()
      torch.cuda.synchronize()
      paths[f'hetero_{name}'] = {fn.__name__: fn.launches
                                 for fn in K.KERNELS}
      with swapped_to_plain(K, swapped):
        op, xp = sample()
      f = differing_field(torch, ok, op, sample_fields)
      if f is not None or any(not torch.equal(xk[t], xp[t]) for t in xk):
        raise AssertionError(f'hetero {name} sample.{f} (or its rows) '
                             'differs between kernels and plain')
      print(f'hetero {name} sample (seeds {dict((t, int(v.numel())) for t, v in ok.batch.items())}): '
            f'bit-identical to plain with its rows ('
            f'{sum(int(c) for c in ok.node_count.values())} nodes, '
            f'{sum(int(m.sum()) for m in ok.edge_mask.values())} edges, '
            f'input type {ok.input_type}); launches '
            f'{ {k: v for k, v in paths[f"hetero_{name}"].items() if v} }')
    del hds, loader, sampler, full, types
    torch.cuda.empty_cache()
  return paths


def loader_option_checks(torch, np, K, ds, dev, seed, smi):
  """NeighborLoader's options over products-sage (its weights, labels and
  split from train_phases): a weighted per-hop batch with edge ids and a
  [-1, 10, 5] per-hop batch with replacement, each against the plain
  versions; as_pyg_v1 and prefetch_depth=2 loaders over an epoch of
  LOADER_BATCHES batches through the walk, against the loader without
  them. Returns the launches by path."""
  from glt_tpu_torch.loader import NeighborLoader, to_pyg_v1
  from glt_tpu_torch.typing import Split

  paths = {}
  train_idx = ds.get_split(Split.train)
  fields = ('node', 'node_count', 'row', 'col', 'edge_mask', 'edge', 'x',
            'y', 'num_sampled_nodes', 'num_sampled_edges')

  def loader(fanouts, n=None, **kw):
    return NeighborLoader(ds, fanouts, train_idx[:n], batch_size=TRAIN_BATCH,
                          shuffle=True, device=dev, seed=seed,
                          rng=np.random.default_rng(seed), **kw)
  with Phase('loader options checks'):
    for path, label, fanouts, kw in (
        ('loader_weighted_edges', 'weighted, with edge ids', list(FANOUTS),
         dict(with_weight=True, with_edge=True)),
        ('loader_replace', 'with replacement, with edge ids',
         [-1] + list(FANOUTS[1:]), dict(replace=True, with_edge=True))):
      K.reset_launch_counts()
      bk = next(iter(loader(fanouts, **kw)))
      torch.cuda.synchronize()
      paths[path] = {fn.__name__: fn.launches for fn in K.KERNELS}
      with swapped_to_plain(K, ('sample_hop', 'gather_windows',
                                'gather_rows')):
        bp = next(iter(loader(fanouts, **kw)))
      f = differing_field(torch, bk, bp, fields)
      if f is not None:
        raise AssertionError(f'loader ({label}) batch.{f} differs between '
                             'kernels and plain')
      if not (paths[path]['sample_hop'] and paths[path]['gather_windows']):
        raise AssertionError(f'loader ({label}) launched {paths[path]}')
      print(f'per-hop loader {fanouts} ({label}): batch of {TRAIN_BATCH} '
            f'bit-identical to plain ({int(bk.node_count)} nodes, '
            f'{int(bk.edge_mask.sum())} edges); launches '
            f'{ {k: v for k, v in paths[path].items() if v} }')
    n = LOADER_BATCHES * TRAIN_BATCH
    want = list(loader(list(FANOUTS), n, with_edge=True))
    K.reset_launch_counts()
    pyg = list(loader(list(FANOUTS), n, with_edge=True, as_pyg_v1=True))
    torch.cuda.synchronize()
    paths['loader_pyg_v1'] = {fn.__name__: fn.launches for fn in K.KERNELS}
    for b, (bs, n_id, adjs) in zip(want, pyg):
      ws, wn, wa = to_pyg_v1(b)
      if not (bs == ws and torch.equal(n_id, wn) and len(adjs) == len(wa)
              and all(x.size == y.size
                      and torch.equal(x.edge_index, y.edge_index)
                      and torch.equal(x.e_id, y.e_id)
                      for x, y in zip(adjs, wa))):
        raise AssertionError('an as_pyg_v1 batch differs from the plain '
                             'loader\'s')
    K.reset_launch_counts()
    pre = NeighborLoader(ds, list(FANOUTS), train_idx[:n],
                         batch_size=TRAIN_BATCH, shuffle=True, device=dev,
                         seed=seed, rng=np.random.default_rng(seed),
                         with_edge=True, prefetch_depth=2)
    got = list(pre)
    torch.cuda.synchronize()
    paths['loader_prefetch'] = {fn.__name__: fn.launches for fn in K.KERNELS}
    worker = pre._prefetcher.worker_thread
    if len(got) != len(want) or worker is None or worker.is_alive():
      raise AssertionError(f'the prefetching loader gave {len(got)} batches')
    for i, (x, y) in enumerate(zip(got, want)):
      f = differing_field(torch, x, y, fields)
      if f is not None:
        raise AssertionError(f'prefetched batch {i}.{f} differs from the '
                             'plain loader\'s')
    for path in ('loader_pyg_v1', 'loader_prefetch'):
      if paths[path]['sample_walk_dedup'] != LOADER_BATCHES:
        raise AssertionError(f'{path}: launches {paths[path]}')
    print(f'as_pyg_v1 and prefetch_depth=2 loaders over {LOADER_BATCHES} '
          f'batches of {TRAIN_BATCH} ({list(FANOUTS)}, with edge ids): equal '
          'to the plain loader\'s batches (as_pyg_v1: n_id, each hop\'s '
          'edge_index, e_id and size); the prefetch worker joined; launches '
          f'pyg {paths["loader_pyg_v1"]}, prefetch '
          f'{paths["loader_prefetch"]}; on {smi}')
    del want, pyg, got, pre
  return paths


# the partitioned hetero trainer's weighted hops (DistHeteroTrainStep(
# with_weight=True) at igbh-rgat's width): a weight window a hop larger
# than WINDOW_BYTES_MAX bytes is capped through max_weighted_degree
WINDOW_BYTES_MAX = 4 * 2 ** 30


def dist_weighted_phases(torch, np, K, dev, seed, rows, smi, dg, dfeats,
                         labels, keys, order):
  """The slice's main path: DistHeteroTrainStep(with_weight=True) over
  the igbh-rgat partition of dist_phases (its float32 weights, its bf16
  stores), RGAT at igbh-rgat's width, [15, 10, 5], batch 64: each owner's
  weighted hop reads its weight window through B3, picks by Gumbel top-k
  and reads the picks through B2. Returns the launches of its timed
  steps."""
  from glt_tpu_torch.distributed import (DistHeteroNeighborSampler,
                                         DistHeteroTrainStep)
  from glt_tpu_torch.models import RGNN
  from glt_tpu_torch.parallel import sage_loss

  fanouts = list(FANOUTS)
  with Phase('dist weighted path'):
    windows = {e[1]: st.max_degree for e, st in dg.graphs.items()}
    probe = DistHeteroNeighborSampler(dg, fanouts, with_weight=True,
                                      seed=seed)
    shapes = probe.uniform_shapes(HTRAIN_BATCH, 'paper')
    big = max((sh for hop in shapes for sh in hop), key=lambda x: x[0] * x[1])
    mwd = None
    if 4 * big[0] * big[1] > WINDOW_BYTES_MAX:
      mwd = max(max(fanouts), WINDOW_BYTES_MAX // (4 * big[0]))
      probe = DistHeteroNeighborSampler(dg, fanouts, with_weight=True,
                                        max_weighted_degree=mwd, seed=seed)
      shapes = probe.uniform_shapes(HTRAIN_BATCH, 'paper')
    segs = sum(len(h) for h in shapes)
    print(f'dist weighted: windows (max_degree by relation) {windows}; the '
          f'largest hop\'s window [{big[0]}, {big[1]}] float32 '
          f'{4 * big[0] * big[1]} B, so max_weighted_degree {mwd} (None: '
          f'each relation\'s max_degree); {segs} weighted segments a step '
          f'(hop: [world * F, W]) {shapes}')

    def trainer():
      torch.manual_seed(seed)
      model = RGNN(keys, IGBH_FEAT, IGBH_HIDDEN, IGBH_CLASSES,
                   num_layers=len(fanouts), conv='rgat', heads=IGBH_HEADS,
                   node_types=list(IGBH_NODES)).to(dev)
      return DistHeteroTrainStep(dg, dfeats, model, {'paper': labels},
                                 fanouts, HTRAIN_BATCH, 'paper', lr=LR,
                                 seed=seed, with_weight=True,
                                 max_weighted_degree=mwd)
    step = trainer()
    if not step.sampler.with_weight:
      raise AssertionError('the weighted trainer samples uniformly')
    one = np.ones(1, np.int64) * HTRAIN_BATCH

    def batch_seeds(i):
      return order[i * HTRAIN_BATCH:(i + 1) * HTRAIN_BATCH][None]
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
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    peak = torch.cuda.max_memory_allocated() - base
    losses = [float(v) for v in losses]
    want = dict(sample_hop=segs * DIST_STEPS, gather_windows=segs * DIST_STEPS,
                gather_rows=len(IGBH_NODES) * DIST_STEPS)
    for n, v in want.items():
      if launches[n] != v:
        raise AssertionError(f'{n}: {launches[n]} launches over '
                             f'{DIST_STEPS} weighted steps, expected {v}')
    if not np.isfinite(losses).all():
      raise AssertionError(f'weighted dist training: non-finite loss {losses}')
    wall, busy = profile_stages(
        torch, lambda: [step(batch_seeds(i), one) for i in range(2)], 2,
        (), 'step')
    print(f'dist weighted training (one rank, batch {HTRAIN_BATCH}, '
          f'{fanouts}, RGAT {IGBH_FEAT} -> {IGBH_HIDDEN} x {IGBH_HEADS} -> '
          f'{IGBH_CLASSES}): {DIST_STEPS} steps after {DIST_WARMUP} '
          f'warm-up, {ms:.3f} ms a step, {HTRAIN_BATCH / ms * 1e3:.1f} '
          f'seeds/s; device busy {busy / wall * 100:.1f}% over 2 profiled '
          f'steps ({wall:.3f} ms wall, {busy:.3f} busy); peak '
          f'{peak / 2**30:.3f} GiB above {base / 2**30:.3f} GiB resident; '
          'losses ' + ', '.join(f'{v:.4f}' for v in losses)
          + f'; launches {launches} ({segs} B2, {segs} B3 and '
          f'{len(IGBH_NODES)} K3 a step); on {smi}')

  with Phase('dist weighted path vs plain'):
    s0 = torch.as_tensor(order[-HTRAIN_BATCH:], device=dev, dtype=torch.int32)
    n0 = torch.tensor(HTRAIN_BATCH - 5, device=dev, dtype=torch.int32)
    u0 = step.sampler.draw_uniforms(HTRAIN_BATCH, 'paper')
    with torch.no_grad():
      bk = step.make_batch(s0, n0, u0)
      lk = float(sage_loss(step.model, bk))
      with recorded_calls(K, ('sample_hop', 'gather_windows',
                              'gather_rows')) as calls:
        bp = step.make_batch(s0, n0, u0)
        lp = float(sage_loss(step.model, bp))
    f = differing_field(torch, bk, bp, DIST_FIELDS)
    if f is not None:
      raise AssertionError(f'weighted dist batch.{f} differs between kernels '
                           'and plain')
    if not abs(lk - lp) <= LOSS_TOL * max(1.0, abs(lp)):
      raise AssertionError(f'weighted dist loss {lk} vs plain {lp}')
    if (len(calls['sample_hop']), len(calls['gather_windows'])) != (segs,
                                                                   segs):
      raise AssertionError(f'{len(calls["sample_hop"])} B2 and '
                           f'{len(calls["gather_windows"])} B3 reads in a '
                           f'weighted batch, expected {segs} each')
    print(f'weighted dist batch {HTRAIN_BATCH} ({int(n0)} real seeds): '
          'samples and rows bit-identical ('
          f'{sum(int(c) for c in bk.node_count_dict.values())} nodes, '
          f'{sum(int(m.sum()) for m in bk.edge_mask_dict.values())} edges), '
          f'loss {lk:.6f} vs plain {lp:.6f} (|diff| {abs(lk - lp):.3e}, '
          f'tolerance {LOSS_TOL})')
    label = f'weighted dist batch ({segs} hops)'
    rows['gather_windows'].setdefault('shapes', {})[label] = time_windows(
        torch, np, K, 'weighted dist batch', calls['gather_windows'])
    rows['sample_hop']['shapes'][label] = time_picks(
        torch, np, K, 'weighted dist batch', calls['sample_hop'])
    del bk, bp, step, calls
    torch.cuda.empty_cache()
  return launches


# partitioned homogeneous training (examples/distributed/dist_train_sage.py
# at products-sage's width, one rank): the products graph partitioned to
# disk in one part, 2 + 10 steps from the resident store and from a split
# 0.2 store; the link path of examples/distributed/dist_sage_unsup.py over
# the same stores (the link phases' batch: 512 positive edges and 512 strict
# binary negatives, 100 -> 256 -> 256 -> 64, Adam 3e-3); K3 on float32 x 7
# edge rows (28 B, no multiple of 16) of a small partitioned graph, and a
# DistSubGraphLoader batch on a Cora-sized graph
HDIST_WARMUP, HDIST_STEPS, HDIST_SPLIT = 2, 10, 0.2
HDIST_LINK_BATCH, HDIST_LINK_LR = 512, 3e-3
EDGE_DIM, EDGE_NODES, EDGE_DEGREE = 7, 100_000, 25
HDIST_FIELDS = ('node', 'node_count', 'row', 'col', 'edge_mask', 'x', 'y',
                'edge', 'edge_attr')
HDIST_SWAPPED = ('sample_hop', 'gather_rows', 'gather_rows_mixed')


def homo_dist_phases(torch, np, K, ds, dev, seed, rows, k3, mixed, smi):
  """Partitioned homogeneous training over the products graph (``ds``, its
  labels and split from the training phases): partition and load, the
  kernels at the batch's shapes, DistTrainStep from the resident and the
  split 0.2 store, the link path, then the edge-feature and subgraph
  checks on small graphs. Returns the launches by path."""
  import os
  import shutil
  import tempfile
  from glt_tpu_torch.distributed import (DistDataset, DistFeature,
                                         DistGraph, DistLinkNeighborLoader,
                                         DistNeighborLoader,
                                         DistSubGraphLoader, DistTrainStep)
  from glt_tpu_torch.examples.distributed import dist_sage_unsup as unsup
  from glt_tpu_torch.examples.seal_link_pred import ring_chord_graph
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.parallel import link_bce_loss, make_mesh, sage_loss
  from glt_tpu_torch.partition import RandomPartitioner
  from glt_tpu_torch.sampler import NegativeSampling
  from glt_tpu_torch.typing import Split

  fanouts = list(FANOUTS)
  mesh = make_mesh(device=dev)
  paths = {}

  def load(root):
    return (DistGraph.from_dataset_partitions(mesh, root),
            {0: DistDataset.load(root, 0, device=dev)})

  with Phase('homo dist data'):
    t = [time.perf_counter()]
    src, dst, _ = ds.get_graph().topo.to_coo()
    edge_index = torch.stack([src, dst]).cpu().numpy()
    del src, dst
    # the training phases' float32 weights, in the same CSR slot order
    weights = ds.get_graph().edge_weights.cpu().numpy()
    feats = ds.get_node_feature().table.cpu().numpy()
    labels = np.asarray(ds.node_labels)
    train_idx = ds.get_split(Split.train)
    t.append(time.perf_counter())
    root = tempfile.mkdtemp(prefix='glt_homo_parts_')
    try:
      RandomPartitioner(root, num_parts=1, num_nodes=NUM_NODES,
                        edge_index=edge_index, node_feat=feats,
                        edge_weights=weights, seed=seed).partition()
      t.append(time.perf_counter())
      disk = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(root) for f in fs)
      del feats, weights
      dg = DistGraph.from_dataset_partitions(mesh, root)
      torch.cuda.synchronize()
      t.append(time.perf_counter())
      # to the host: the split store then copies only its hot rows to
      # the card, the resident one the whole table
      dss = {0: DistDataset.load(root, 0, device='cpu')}
      t.append(time.perf_counter())
      df = DistFeature.from_dist_datasets(mesh, dss)
      torch.cuda.synchronize()
      t.append(time.perf_counter())
      dfs = DistFeature.from_dist_datasets(mesh, dss, split_ratio=HDIST_SPLIT)
      torch.cuda.synchronize()
      t.append(time.perf_counter())
      # the same split without its pinned block: the host phase
      dfh = DistFeature.from_dist_datasets(mesh, dss, split_ratio=HDIST_SPLIT,
                                           host_offload=False)
      torch.cuda.synchronize()
      t.append(time.perf_counter())
      del dss
    finally:
      shutil.rmtree(root, ignore_errors=True)
    secs = np.diff(t)
    if dfs.cold_pinned is None or dfs.hot_count != round(
        NUM_NODES * HDIST_SPLIT):
      raise AssertionError('the split DistFeature did not pin its cold block')
    row_b = FEAT_DIM * df.array.element_size()
    card_b = [f.array.untyped_storage().nbytes() for f in (df, dfs)]
    if card_b != [NUM_NODES * row_b, dfs.hot_count * row_b]:
      raise AssertionError(f'the stores hold {card_b} B on the card, not '
                           'their rows\' bytes')
    graph_b = sum(getattr(dg, f).numel() * getattr(dg, f).element_size()
                  for f in ('indptr', 'indices', 'edge_ids', 'edge_weights',
                            'local_row', 'node_pb'))
    print(f'homo dist data: {edge_index.shape[1]} edges, {NUM_NODES} nodes; '
          f'the graph and features copied to the host {secs[0]:.3f} s; '
          f'partitioned (RandomPartitioner, one part) {secs[1]:.3f} s, '
          f'{disk} B on disk; DistGraph {secs[2]:.3f} s ({graph_b} B on the '
          f'card, max degree {dg.max_degree}); DistDataset.load {secs[3]:.3f}'
          f' s (to the host); DistFeature resident {secs[4]:.3f} s '
          f'({card_b[0]} B on the card), split {HDIST_SPLIT} '
          f'{secs[5]:.3f} s ({dfs.hot_count} rows, {card_b[1]} B, on the '
          f'card, {dfs.cold_array.shape[0]} pinned and mapped), host phase '
          f'{secs[6]:.3f} s ({dfh.cold_array.shape[0]} cold rows in host '
          'memory, not pinned)')
    if not dfh.host_spilled or dfh.cold_pinned is not None:
      raise AssertionError('the host-phase store pinned its cold block')

    def trainer(store):
      torch.manual_seed(seed)
      model = GraphSAGE(FEAT_DIM, HIDDEN, CLASSES, num_layers=3).to(dev)
      return DistTrainStep(dg, store, model, labels, fanouts, TRAIN_BATCH,
                           lr=LR, seed=seed)
    rng = np.random.default_rng(seed + 30)
    order = rng.permutation(train_idx)

  with Phase('homo dist kernel checks'):
    step = trainer(dfs)
    inputs = step.own_inputs(order[:TRAIN_BATCH][None],
                             np.array([TRAIN_BATCH - 7]))
    with torch.no_grad(), recorded_calls(
        K, ('sample_hop', 'gather_rows_mixed')) as calls:
      step.make_batch(*inputs)
    hops, (mx,) = calls['sample_hop'], calls['gather_rows_mixed']
    if len(hops) != len(fanouts):
      raise AssertionError(f'{len(hops)} B2 hops in a batch')
    b2 = rows['sample_hop'].setdefault('shapes', {})
    b2['homo dist batch (3 hops)'] = time_picks(
        torch, np, K, 'homo dist batch', hops)
    served = mx[2]
    k3['dist float32 x 100 (homo batch)'] = time_gather(
        torch, np, K, 'dist float32 x 100 (homo batch)', df.array, served)
    mixed['dist owner split 0.2 (homo batch)'] = time_mixed(
        torch, np, K, 'dist owner split 0.2 (homo batch)', dfs.array,
        dfs.cold_pinned, served, link_rate(torch, dfs.cold_array, dev),
        resident=df.array)
    del step, calls, hops, mx, served

  with Phase('homo dist host phase'):
    paths['dist_homo_host'] = host_phase_check(torch, np, K, trainer, dfs,
                                               dfh, order, mixed, smi)
    del dfh

  def edges_a_step(step):
    """Wrap the step's sampler so that each batch's valid sampled edges
    are kept (summed after the step's sync)."""
    got = []
    real = step.sampler.sample_local

    def sample(*a):
      out = real(*a)
      got.append(out['num_sampled_edges'].sum())
      return out
    step.sampler.sample_local = sample
    return got

  def train_path(label, store, per_step):
    step = trainer(store)
    edges = edges_a_step(step)

    def one(i):
      return step(order[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH][None],
                  np.array([TRAIN_BATCH]))
    for i in range(HDIST_WARMUP):
      one(i)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, secs, host = [], [], []
    for i in range(HDIST_WARMUP, HDIST_WARMUP + HDIST_STEPS):
      t0 = time.perf_counter()
      losses.append(one(i))
      host.append(time.perf_counter() - t0)    # the call's return
      torch.cuda.synchronize()
      secs.append(time.perf_counter() - t0)
    launched = {fn.__name__: fn.launches for fn in K.KERNELS}
    peak = torch.cuda.max_memory_allocated() - base
    losses = [float(v) for v in losses]
    n_edges = sum(int(e) for e in edges[HDIST_WARMUP:])
    for n, per in per_step.items():
      if launched[n] != per * HDIST_STEPS:
        raise AssertionError(f'{label}: {launched[n]} {n} launches over '
                             f'{HDIST_STEPS} steps, expected {per} a step')
    if not np.isfinite(losses).all():
      raise AssertionError(f'{label}: non-finite loss {losses}')
    ms = np.array(secs) * 1e3
    med = float(np.median(ms))
    wall, busy = profile_stages(torch, lambda: [one(i) for i in range(2)],
                                2, (), 'step')
    print(f'{label} (one rank, batch {TRAIN_BATCH}, {fanouts}): '
          f'{HDIST_STEPS} steps after {HDIST_WARMUP}, median {med:.3f} ms a '
          f'step (quartiles {np.percentile(ms, 25):.3f}-'
          f'{np.percentile(ms, 75):.3f}, min {ms.min():.3f}, max '
          f'{ms.max():.3f}), {TRAIN_BATCH / med * 1e3:.1f} seeds/s, '
          f'{n_edges / ms.sum() * 1e3:.1f} valid sampled edges/s '
          f'({n_edges / HDIST_STEPS:.0f} a step); the step call returns '
          f'to the host after a median {np.median(host) * 1e3:.3f} ms; '
          f'device busy '
          f'{busy / wall * 100:.1f}% over 2 profiled steps ({wall:.3f} ms '
          f'wall, {busy:.3f} busy); peak {peak / 2**30:.3f} GiB above '
          f'{base / 2**30:.3f} GiB resident; losses '
          + ', '.join(f'{v:.4f}' for v in losses)
          + f'; launches {launched}; on {smi}')
    return step, launched

  with Phase('homo dist main path'):
    step, paths['dist_homo'] = train_path(
        'homo dist training', df, {'sample_hop': 3, 'gather_rows': 1,
                                   'gather_rows_mixed': 0})
    del step
  with Phase('homo dist split path'):
    step, paths['dist_homo_split'] = train_path(
        f'homo dist training, split {HDIST_SPLIT}', dfs,
        {'sample_hop': 3, 'gather_rows': 0, 'gather_rows_mixed': 1})
    del step

  with Phase('homo dist main path vs plain'):
    for name, store in (('resident', df), (f'split {HDIST_SPLIT}', dfs)):
      step = trainer(store)
      inputs = step.own_inputs(order[-TRAIN_BATCH:][None],
                               np.array([TRAIN_BATCH - 3]))
      with torch.no_grad():
        bk = step.make_batch(*inputs)
        lk = float(sage_loss(step.model, bk))
        with swapped_to_plain(K, HDIST_SWAPPED):
          bp = step.make_batch(*inputs)
          lp = float(sage_loss(step.model, bp))
      f = differing_field(torch, bk, bp, HDIST_FIELDS)
      if f is not None:
        raise AssertionError(f'homo dist ({name}) batch.{f} differs between '
                             'kernels and plain')
      if not abs(lk - lp) <= LOSS_TOL * max(1.0, abs(lp)):
        raise AssertionError(f'homo dist ({name}) loss {lk} vs plain {lp}')
      print(f'homo dist batch ({name}, {int(inputs[1])} real seeds): '
            f'samples and rows bit-identical ({int(bk.node_count)} nodes, '
            f'{int(bk.edge_mask.sum())} edges), loss {lk:.6f} vs plain '
            f'{lp:.6f} (|diff| {abs(lk - lp):.3e}, tolerance {LOSS_TOL})')
      del step, bk, bp

  with Phase('homo dist weighted checks'):
    paths.update(homo_weighted_checks(torch, np, K, dg, order, dev, seed,
                                      rows))

  with Phase('homo dist link path'):
    pools = unsup.positive_pools(edge_index, dg.node_pb, 1)
    del edge_index

    def link_loader():
      return DistLinkNeighborLoader(
          dg, fanouts, pools, dist_feature=df,
          neg_sampling=NegativeSampling('binary', amount=1, strict=True),
          batch_size=HDIST_LINK_BATCH, shuffle=True, seed=seed)

    def link_model():
      torch.manual_seed(seed)
      return GraphSAGE(FEAT_DIM, HIDDEN, LINK_EMBED, num_layers=3).to(dev)
    loader = link_loader()
    lstep = unsup.LinkStep(mesh, link_model(), fanouts, lr=HDIST_LINK_LR)
    it = iter(loader)
    for _ in range(HDIST_WARMUP):
      lstep(next(it))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, secs, host = [], [], []
    for _ in range(HDIST_STEPS):
      t0 = time.perf_counter()
      losses.append(lstep(next(it)))
      host.append(time.perf_counter() - t0)    # the calls' return
      torch.cuda.synchronize()
      secs.append(time.perf_counter() - t0)
    paths['dist_link'] = {fn.__name__: fn.launches for fn in K.KERNELS}
    peak = torch.cuda.max_memory_allocated() - base
    losses = [float(v) for v in losses]
    for n, per in (('sample_hop', 3), ('gather_rows', 1)):
      if paths['dist_link'][n] != per * HDIST_STEPS:
        raise AssertionError(f'homo dist link: {paths["dist_link"][n]} {n} '
                             f'launches, expected {per} a step')
    if not np.isfinite(losses).all():
      raise AssertionError(f'homo dist link: non-finite loss {losses}')
    ms = np.array(secs) * 1e3
    med = float(np.median(ms))
    pairs = 2 * HDIST_LINK_BATCH
    wall, busy = profile_stages(
        torch, lambda: [lstep(next(it)) for _ in range(2)], 2, (), 'step')
    print(f'homo dist link (one rank, {HDIST_LINK_BATCH} positive edges and '
          f'{HDIST_LINK_BATCH} strict binary negatives, {fanouts}, '
          f'{loader.seeds_per_device} seeds): median {med:.3f} ms a step '
          f'(quartiles {np.percentile(ms, 25):.3f}-{np.percentile(ms, 75):.3f}'
          f', min {ms.min():.3f}, max {ms.max():.3f}), '
          f'{pairs / med * 1e3:.1f} labelled pairs/s; the batch and step '
          f'calls return to the host after a median '
          f'{np.median(host) * 1e3:.3f} ms; device busy '
          f'{busy / wall * 100:.1f}% over 2 profiled steps ({wall:.3f} ms '
          f'wall, {busy:.3f} busy); peak {peak / 2**30:.3f} GiB above '
          f'{base / 2**30:.3f} GiB resident; losses '
          + ', '.join(f'{v:.4f}' for v in losses)
          + f'; launches {paths["dist_link"]}; on {smi}')
    # one batch through the kernels and through the plain versions: two
    # loaders of one seed draw the same orders, negatives and uniforms
    bk = next(iter(link_loader()))
    with swapped_to_plain(K, HDIST_SWAPPED):
      bp = next(iter(link_loader()))
    f = differing_field(torch, bk, bp, ('node', 'node_count', 'row', 'col',
                                        'edge_mask', 'x', 'edge_label_index',
                                        'edge_label'))
    if f is not None:
      raise AssertionError(f'homo dist link batch {f} differs between '
                           'kernels and plain')
    model = lstep.model
    with torch.no_grad():
      lk = float(link_bce_loss(model, unsup.link_batch(bk, fanouts)))
      lp = float(link_bce_loss(model, unsup.link_batch(bp, fanouts)))
    if not abs(lk - lp) <= LOSS_TOL * max(1.0, abs(lp)):
      raise AssertionError(f'homo dist link loss {lk} vs plain {lp}')
    print(f'homo dist link batch: bit-identical ({int(bk["node_count"])} '
          f'nodes, {int(bk["edge_mask"].sum())} edges), loss {lk:.6f} vs '
          f'plain {lp:.6f} (|diff| {abs(lk - lp):.3e})')
    del loader, lstep, it, bk, bp, model, pools, df, dfs, dg
    torch.cuda.empty_cache()

  with Phase('homo dist edge checks'):
    # a small products-shaped graph with float32 x 7 edge features
    egen = torch.Generator(device=dev).manual_seed(seed + 31)
    ne = EDGE_NODES * EDGE_DEGREE
    esrc = torch.randint(0, EDGE_NODES, (ne,), generator=egen, device=dev)
    edst = (torch.rand(ne, generator=egen, device=dev) ** 2
            * EDGE_NODES).long() % EDGE_NODES
    ex = torch.randn((EDGE_NODES, FEAT_DIM), generator=egen, device=dev)
    eattr = torch.randn((ne, EDGE_DIM), generator=egen, device=dev)
    root = tempfile.mkdtemp(prefix='glt_edge_parts_')
    try:
      RandomPartitioner(root, num_parts=1, num_nodes=EDGE_NODES,
                        edge_index=torch.stack([esrc, edst]).cpu().numpy(),
                        node_feat=ex.cpu().numpy(),
                        edge_feat=eattr.cpu().numpy(), seed=seed).partition()
      edg, edss = load(root)
      enf = DistFeature.from_dist_datasets(mesh, edss)
      eef = DistFeature.from_dist_datasets(mesh, edss, kind='edge')
      del edss
    finally:
      shutil.rmtree(root, ignore_errors=True)
    elabels = torch.randint(0, CLASSES, (EDGE_NODES,), generator=egen,
                            device=dev)

    def edge_loader():
      return DistNeighborLoader(
          edg, fanouts, [np.arange(EDGE_NODES)], dist_feature=enf,
          labels=elabels, batch_size=TRAIN_BATCH, shuffle=True,
          seed=seed, rng=np.random.default_rng(seed), edge_feature=eef)
    K.reset_launch_counts()
    bk = next(iter(edge_loader()))
    paths['dist_edge'] = {fn.__name__: fn.launches for fn in K.KERNELS}
    if (paths['dist_edge']['sample_hop'], paths['dist_edge']['gather_rows']) \
        != (3, 2):
      raise AssertionError(f'an edge-feature batch launched '
                           f'{paths["dist_edge"]}, expected 3 B2 and 2 K3')
    with recorded_calls(K, ('sample_hop', 'gather_rows')) as calls:
      bp = next(iter(edge_loader()))
    f = differing_field(torch, bk, bp, HDIST_FIELDS)
    if f is not None:
      raise AssertionError(f'edge-feature batch {f} differs between kernels '
                           'and plain')
    m = bk['edge_mask']
    want_attr = eattr.index_select(0, bk['edge'].clamp(min=0).long())
    if not (torch.equal(bk['edge_attr'][m], want_attr[m])
            and not bk['edge_attr'][~m].any()):
      raise AssertionError('edge_attr is not the sampled edges\' rows')
    rows['sample_hop']['shapes']['edge batch (3 hops, eids)'] = time_picks(
        torch, np, K, 'edge batch (eids)', calls['sample_hop'])
    table, erows = calls['gather_rows'][1]
    k3[f'edge float32 x {EDGE_DIM}'] = time_gather(
        torch, np, K, f'edge float32 x {EDGE_DIM}', table, erows)
    print(f'edge-feature batch ({TRAIN_BATCH} seeds, {int(m.sum())} sampled '
          f'edges of {m.numel()} slots): bit-identical between kernels and '
          f'plain, edge_attr the rows of the sampled edge ids; launches '
          f'{paths["dist_edge"]}')
    del edg, enf, eef, bk, bp, calls, table, erows, eattr, ex

  with Phase('homo dist subgraph checks'):
    und = np.asarray(ring_chord_graph(SEAL_NODES, SEAL_CHORDS, seed=seed))
    both = np.concatenate([und, und[:, ::-1]]).T.copy()
    crng = np.random.default_rng(seed + 32)
    root = tempfile.mkdtemp(prefix='glt_sub_parts_')
    try:
      RandomPartitioner(
          root, num_parts=1, num_nodes=SEAL_NODES, edge_index=both,
          node_feat=crng.normal(size=(SEAL_NODES, FEAT_DIM)).astype(
              np.float32),
          edge_feat=crng.normal(size=(both.shape[1], EDGE_DIM)).astype(
              np.float32), seed=seed).partition()
      sdg, sdss = load(root)
      snf = DistFeature.from_dist_datasets(mesh, sdss)
      sef = DistFeature.from_dist_datasets(mesh, sdss, kind='edge')
      del sdss
    finally:
      shutil.rmtree(root, ignore_errors=True)

    def sub_loader():
      return DistSubGraphLoader(
          sdg, 2, [np.arange(SEAL_NODES)], dist_feature=snf, batch_size=16,
          shuffle=True, seed=seed, rng=np.random.default_rng(seed),
          edge_feature=sef)
    K.reset_launch_counts()
    bk = next(iter(sub_loader()))
    paths['dist_subgraph'] = {fn.__name__: fn.launches for fn in K.KERNELS}
    if paths['dist_subgraph']['sample_hop'] != 3:
      raise AssertionError(f'a subgraph batch launched '
                           f'{paths["dist_subgraph"]}, expected 3 B2')
    with recorded_calls(K, ('sample_hop',)) as calls:
      bp = next(iter(sub_loader()))
    f = differing_field(torch, bk, bp, ('node', 'node_count', 'row', 'col',
                                        'edge_mask', 'x', 'edge'))
    ib, ip = bk['induced'], bp['induced']
    if f is None and any(not torch.equal(torch.as_tensor(ib[k]),
                                         torch.as_tensor(ip[k])) for k in ib):
      f = 'induced'
    if f is not None:
      raise AssertionError(f'subgraph batch {f} differs between kernels and '
                           'plain')
    # every induced edge is a graph edge between two nodes of the set
    node = bk['node'].cpu().numpy()
    edges = {tuple(e) for e in both.T}
    got = {(int(node[c]), int(node[r])) for r, c in zip(ib['rows'],
                                                          ib['cols'])}
    if not got or not got <= edges:
      raise AssertionError('an induced edge is not a graph edge')
    shape = f'subgraph windows (max_degree {sdg.max_degree}, eids)'
    rows['sample_hop']['shapes'][shape] = time_picks(
        torch, np, K, shape, calls['sample_hop'])
    print(f'subgraph batch (16 seeds, 2 hops of max_degree {sdg.max_degree} '
          f'on a {SEAL_NODES}-node graph of {both.shape[1]} directed edges): '
          f'{int(bk["node_count"])} nodes, {ib["eids"].size} induced edges, '
          f'bit-identical between kernels and plain; launches '
          f'{paths["dist_subgraph"]}')
    del sdg, snf, sef, bk, bp, calls
    torch.cuda.empty_cache()
  return paths


def homo_weighted_checks(torch, np, K, dg, order, dev, seed, rows):
  """The owner's weighted and full hops over the partitioned products
  graph (its float32 weights), batch 1024 with edge ids:
  DistNeighborSampler(with_weight=True) at [15, 10, 5] (B3 reads each
  served row's weight window, B2 the Gumbel top-k's picks and their edge
  ids) and DistNeighborSampler([-1, -1]) in a window of the store's
  max_degree (B3 over the neighbour ids and over the edge ids), each batch
  bit-equal to its plain twin on the same draws, B3 and B2 timed at these
  shapes in turns with torch.take. Returns the launches of each kernel
  run."""
  from glt_tpu_torch.distributed import DistNeighborSampler
  seeds = torch.as_tensor(order[:TRAIN_BATCH].astype(np.int32), device=dev)
  n_valid = TRAIN_BATCH - 3
  cap = dg.max_degree
  paths = {}
  for path, fanouts, kw, want in (
      ('dist_homo_weighted', list(FANOUTS), dict(with_weight=True),
       dict(gather_windows=len(FANOUTS), sample_hop=len(FANOUTS))),
      ('dist_homo_full', [-1, -1], dict(full_neighbor_cap=cap),
       dict(gather_windows=4, sample_hop=0))):
    s = DistNeighborSampler(dg, fanouts, with_edge=True, seed=seed, **kw)
    u = s.own_uniforms(None, TRAIN_BATCH)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = s.sample_local(seeds, n_valid, u)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    paths[path] = {fn.__name__: fn.launches for fn in K.KERNELS}
    for n, v in want.items():
      if paths[path][n] != v:
        raise AssertionError(f'{path}: {paths[path][n]} {n} launches, '
                             f'expected {v}')
    with recorded_calls(K, ('gather_windows', 'sample_hop')) as calls:
      plain = s.sample_local(seeds, n_valid, u)
    f = differing_field(torch, out, plain, sorted(out))
    if f is not None:
      raise AssertionError(f'{path} batch {f} differs between kernels and '
                           'plain')
    em, eids = out['edge_mask'], out['edge']
    if not (bool((eids[em] >= 0).all()) and bool((eids[~em] == -1).all())):
      raise AssertionError(f'{path}: edge ids not set exactly on the valid '
                           'lanes')
    print(f'{path} ({TRAIN_BATCH} seeds, {int(n_valid)} real, fanouts '
          f'{s.num_neighbors}' + (f', the -1 cap {cap} = the store\'s '
                                  'max_degree' if path.endswith('full')
                                  else f', weight window '
                                  f'{s.max_weighted_degree}')
          + f'): {ms:.3f} ms (host clock, one sample); '
          f'{int(out["node_count"])} nodes, {int(em.sum())} valid edges of '
          f'{em.numel()} slots, bit-identical to plain with edge ids; '
          f'launches {paths[path]}')
    label = f'{path[5:]} batch ({len(calls["gather_windows"])} reads)'
    rows['gather_windows'].setdefault('shapes', {})[label] = time_windows(
        torch, np, K, path[5:] + ' batch', calls['gather_windows'])
    if calls['sample_hop']:
      rows['sample_hop']['shapes'][
          f'{path[5:]} batch ({len(calls["sample_hop"])} hops, eids)'] = \
          time_picks(torch, np, K, path[5:] + ' batch', calls['sample_hop'])
    del out, plain, calls, u, s
    torch.cuda.empty_cache()
  return paths


# the partition hot cache (FrequencyPartitioner's): two parts, each caching
# its hottest 5% of the nodes it does not own
CACHE_PARTS, CACHE_RATIO, PROB_TOL = 2, 0.05, 1e-5


def numpy_probs(np, indptr, indices, seeds, fanouts, n):
  """NeighborSampler.sample_prob's push in float64 numpy: the seeds at 1,
  each hop adding p(u) * min(fanout / deg(u), 1) to every out-neighbour
  of u (1 for a -1 hop), the sums clipped to 1, then kept in a running
  sum clipped to 1."""
  deg = np.diff(indptr)
  probs = np.zeros(n)
  probs[seeds] = 1.0
  acc = probs
  for k in fanouts:
    rate = (np.where(deg > 0, 1.0, 0.0) if k < 0 else
            np.where(deg > 0, np.minimum(k / np.maximum(deg, 1), 1.0), 0.0))
    acc = np.minimum(np.bincount(indices, weights=np.repeat(acc * rate, deg),
                                 minlength=n), 1.0)
    probs = np.minimum(probs + acc, 1.0)
  return probs


def hot_cache_phases(torch, np, K, ds, dev, seed, smi):
  """The partition hot cache over the products graph (``ds``, its training
  split): NeighborSampler.sample_prob on the card from each half of the
  training seeds, against numpy's float64 push; FrequencyPartitioner
  (two parts, cache_ratio 0.05) writing the layout; DistDataset.load of
  part 0 on the card (its cached rows first, then its owned rows) and a
  one-rank DistFeature over it whose lookups of cached ids are answered by
  this rank's K3. Returns the lookup's launches."""
  import os
  import shutil
  import tempfile
  from glt_tpu_torch.distributed import DistDataset, DistFeature
  from glt_tpu_torch.parallel import make_mesh
  from glt_tpu_torch.partition import FrequencyPartitioner
  from glt_tpu_torch.sampler import NeighborSampler
  from glt_tpu_torch.typing import Split

  with Phase('hot cache path'):
    g = ds.get_graph()
    train_idx = ds.get_split(Split.train)
    halves = np.array_split(train_idx, CACHE_PARTS)
    sampler = NeighborSampler(g, list(FANOUTS), device=dev)
    indptr, indices = g.indptr.cpu().numpy(), g.indices.cpu().numpy()
    probs, ms = [], []
    for h in halves:
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      p = sampler.sample_prob(h, NUM_NODES)
      torch.cuda.synchronize()
      ms.append((time.perf_counter() - t0) * 1e3)
      p = p.cpu().numpy()
      want = numpy_probs(np, indptr, indices, h, FANOUTS, NUM_NODES)
      err = float(np.abs(p - want).max())
      if not err <= PROB_TOL:
        raise AssertionError(f'sample_prob differs from numpy float64 by '
                             f'{err}')
      probs.append(p)
      print(f'sample_prob ({h.size} seeds, {list(FANOUTS)}): '
            f'{ms[-1]:.3f} ms on the card (host clock around it, synced); '
            f'{int((p > 0).sum())} nodes reached, mean {p.mean():.6f}; '
            f'max |diff| to float64 numpy {err:.3e} (tolerance {PROB_TOL})')
    del indptr, indices
    src, dst, _ = g.topo.to_coo()
    edge_index = torch.stack([src, dst]).cpu().numpy()
    del src, dst
    feats = ds.get_node_feature().table.cpu().numpy()
    root = tempfile.mkdtemp(prefix='glt_cache_parts_')
    try:
      t0 = time.perf_counter()
      FrequencyPartitioner(root, num_parts=CACHE_PARTS, num_nodes=NUM_NODES,
                           edge_index=edge_index, node_feat=feats,
                           probs=np.stack(probs),
                           cache_ratio=CACHE_RATIO).partition()
      part_s = time.perf_counter() - t0
      del edge_index
      with np.load(os.path.join(root, 'part0', 'node_feat',
                                'data.npz')) as z:
        cache_ids, own_ids = z['cache_ids'], z['ids']
      t0 = time.perf_counter()
      ds0 = DistDataset.load(root, 0, device=dev)
      torch.cuda.synchronize()
      load_s = time.perf_counter() - t0
    finally:
      shutil.rmtree(root, ignore_errors=True)
    f = ds0.get_node_feature()
    held = np.concatenate([cache_ids, own_ids])
    table = torch.as_tensor(feats[held], device=dev)
    book = ds0.get_node_feat_pb().table
    graph_book = ds0.get_node_pb().table
    if not (torch.equal(f.table, table)
            and (f._id2index[held] == np.arange(held.size)).all()
            and (book[cache_ids] == 0).all()
            and (graph_book[cache_ids] != 0).all()
            and (book[own_ids] == 0).all()):
      raise AssertionError('part 0 does not hold its cached rows, then its '
                           'owned rows, with the rewritten book')
    if cache_ids.size != int(NUM_NODES * CACHE_RATIO):
      raise AssertionError(f'{cache_ids.size} cached rows, expected '
                           f'{int(NUM_NODES * CACHE_RATIO)}')
    print(f'FrequencyPartitioner ({CACHE_PARTS} parts, cache_ratio '
          f'{CACHE_RATIO}): {part_s:.3f} s; part 0 owns {own_ids.size} nodes '
          f'and caches {cache_ids.size} of part 1\'s; DistDataset.load(part '
          f'0) on the card {load_s:.3f} s: {f.table.shape[0]} rows (cached '
          f'first, then owned), id2index over both, the feature book routes '
          f'the cached ids to part 0 (the graph book to part 1)')
    # one rank over part 0: its owned and cached ids answered by its K3,
    # part 1's other ids ask nothing (rank 1 is not in this mesh)
    mesh = make_mesh(device=dev)
    store = DistFeature.from_dist_datasets(mesh, {0: ds0})
    rng = np.random.default_rng(seed + 40)
    remote = np.nonzero(book != 0)[0]
    ids = np.concatenate([rng.choice(cache_ids, 4096),
                          rng.choice(own_ids, 4096),
                          rng.choice(remote, 1024)])
    K.reset_launch_counts()
    got = store.lookup(ids)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    want = torch.as_tensor(feats[ids], device=dev)
    local = torch.as_tensor(book[ids] == 0, device=dev)
    if not (torch.equal(got[local], want[local])
            and not got[~local].any() and launches['gather_rows'] == 1):
      raise AssertionError(f'the cached lookup read wrong rows or launched '
                           f'{launches}')
    n_local = int(local.sum())
    print(f'hot cache lookup, one rank over part 0: {ids.size} ids '
          f'({n_local} answered here, 4096 of them cached rows of part 1, '
          f'by one K3 launch; {ids.size - n_local} owned by rank 1 ask '
          f'nothing); rows equal to the table\'s; launches {launches}; on '
          f'{smi}')
    del store, ds0, f, table, got, want, feats, probs, sampler
    torch.cuda.empty_cache()
  return {'hot_cache': launches}


# data sources: the readers stream products-sage's COO, rows and labels
# in chunks of odps_table_reader's size; the vineyard store holds them as
# contiguous id windows; IGBH's layout is compressed at igbh-rgat's papers
READ_CHUNK, FRAGMENTS, TABLE_RANKS = 1_048_576, 4, 2
TABLE_FIELDS = ('node', 'node_count', 'row', 'col', 'edge_mask', 'x', 'y',
                'num_sampled_edges')
WALK_FIELDS = ('node', 'node_count', 'row', 'col', 'edge_mask',
               'num_sampled_nodes', 'num_sampled_edges')
WALK_SWAPPED = ('sample_walk_dedup', 'dedup_table_insert', 'gather_rows')


def disk_bytes(root):
  import os
  return sum(os.path.getsize(os.path.join(d, f))
             for d, _, fs in os.walk(root) for f in fs)


def table_phases(torch, np, K, ds, dev, seed, smi):
  """Where a dataset comes from, over the products graph (``ds``, its
  labels and split from the training phases): TableDataset from edge and
  node readers, trained through NeighborLoader and SageTrainStep (K1, K3),
  and pai_table_train's main over real CSV files; a vineyard fragment
  store of four id windows loaded through load_vineyard_dataset, a walk
  and a gather on it (K1, K3); DistTableDataset partitioning the tables
  online on one rank and DistTrainStep over its partition (B2, K3); two
  DistTableRandomPartitioner ranks on threads over loopback rpc; IGBH's
  layout synthesized, compressed (CSC, bf16) and read back. Every store
  built from a source is held bit for bit against the directly built one.
  Returns the launches by path."""
  import os
  import shutil
  import tempfile
  import threading
  from glt_tpu_torch.data import TableDataset
  from glt_tpu_torch.data.vineyard_utils import (InMemoryFragmentStore,
                                                 load_vineyard_dataset)
  from glt_tpu_torch.distributed import (DistDataset, DistFeature, DistGraph,
                                         DistTableDataset,
                                         DistTableRandomPartitioner,
                                         DistTrainStep, free_port_base)
  from glt_tpu_torch.examples import pai_table_train
  from glt_tpu_torch.examples.igbh import compress_graph, data as igbh
  from glt_tpu_torch.data import Topology
  from glt_tpu_torch.loader import NeighborLoader
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.parallel import SageTrainStep, make_mesh, sage_loss
  from glt_tpu_torch.sampler import NeighborSampler
  from glt_tpu_torch.typing import Split

  paths = {}
  g = ds.get_graph()
  train_idx = ds.get_split(Split.train)

  def counts():
    return {fn.__name__: fn.launches for fn in K.KERNELS}

  def model():
    torch.manual_seed(seed)
    return GraphSAGE(FEAT_DIM, HIDDEN, CLASSES, num_layers=3).to(dev)

  with Phase('table data'):
    t = [time.perf_counter()]
    # the COO in its input order (the direct graph's edge ids are input
    # positions), the weights beside it; the node table shuffled by id
    ptr, other, eid = g.topo.to_coo()
    order = torch.argsort(eid)
    src, dst = ptr[order].cpu().numpy(), other[order].cpu().numpy()
    w = g.topo.edge_weights[order].cpu().numpy()
    del ptr, other, eid, order
    feats = ds.get_node_feature().table.cpu().numpy()
    labels = np.asarray(ds.node_labels)
    perm = np.random.default_rng(seed + 50).permutation(NUM_NODES)
    t.append(time.perf_counter())

    def edge_reader(lo=0, hi=NUM_EDGES):
      for a in range(lo, hi, READ_CHUNK):
        b = min(a + READ_CHUNK, hi)
        yield src[a:b], dst[a:b], w[a:b]

    def node_reader(ids=perm):
      for a in range(0, ids.size, READ_CHUNK):
        sel = ids[a:a + READ_CHUNK]
        yield sel, feats[sel], labels[sel]
    tds = TableDataset(edge_dir='out').load(edge_reader=edge_reader(),
                                            node_reader=node_reader(),
                                            num_nodes=NUM_NODES)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    tg = tds.get_graph()
    for f in ('indptr', 'indices', 'edge_ids', 'edge_weights'):
      if not torch.equal(getattr(tg.topo, f), getattr(g.topo, f)):
        raise AssertionError(f'the table-built graph\'s {f} differs from the '
                             'directly built one')
    if not (torch.equal(tds.get_node_feature().table,
                        ds.get_node_feature().table)
            and tds.node_labels.dtype == labels.dtype
            and np.array_equal(tds.node_labels, labels)):
      raise AssertionError('the table-built features or labels differ')
    card = device_bytes([tg.indptr, tg.indptr_pad, tg.indices, tg.edge_ids,
                         tg.edge_weights, tg.topo.indptr, tg.topo.indices,
                         tg.topo.edge_ids, tg.topo.edge_weights,
                         tds.get_node_feature().table])
    print(f'table data: {NUM_EDGES} edge records (src, dst, weight) and '
          f'{NUM_NODES} node records (id, {FEAT_DIM} float32, label) in '
          f'chunks of {READ_CHUNK}, the node records in a shuffled id order; '
          f'tables to the host {t[1] - t[0]:.3f} s; TableDataset.load on the '
          f'card {t[2] - t[1]:.3f} s, {card} B on the card; indptr, indices, '
          f'edge ids, weights, features and labels bit-equal to the directly '
          f'built dataset')
    tds.node_split = ds.node_split

  def loader(data):
    return NeighborLoader(data, list(FANOUTS), train_idx,
                          batch_size=TRAIN_BATCH, shuffle=True, device=dev,
                          seed=seed, rng=np.random.default_rng(seed))

  with Phase('table main path'):
    step = SageTrainStep(model(), lr=LR)
    it = iter(loader(tds))
    losses, secs, edges = [], [], []
    K.reset_launch_counts()
    for i in range(HDIST_WARMUP + HDIST_STEPS):
      before = counts()
      t0 = time.perf_counter()
      b = next(it)
      losses.append(step(b))
      n_edges = b.num_sampled_edges.sum()
      torch.cuda.synchronize()
      secs.append(time.perf_counter() - t0)
      edges.append(int(n_edges))
      now = counts()
      for n in ('sample_walk_dedup', 'gather_rows'):
        if now[n] - before[n] != 1:
          raise AssertionError(f'table step {i}: {now[n] - before[n]} {n} '
                               'launches, expected 1')
    paths['table'] = counts()
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
      raise AssertionError(f'table training: non-finite loss {losses}')
    ms = np.array(secs[HDIST_WARMUP:]) * 1e3
    med = float(np.median(ms))
    print(f'table training (NeighborLoader over the TableDataset, batch '
          f'{TRAIN_BATCH}, {list(FANOUTS)}, SageTrainStep): {HDIST_STEPS} '
          f'steps after {HDIST_WARMUP}, median {med:.3f} ms a step '
          f'(quartiles {np.percentile(ms, 25):.3f}-'
          f'{np.percentile(ms, 75):.3f}, min {ms.min():.3f}, max '
          f'{ms.max():.3f}), {TRAIN_BATCH / med * 1e3:.1f} seeds/s, '
          f'{sum(edges[HDIST_WARMUP:]) / ms.sum() * 1e3:.1f} sampled edges/s;'
          f' losses ' + ', '.join(f'{v:.4f}' for v in losses)
          + f'; launches {paths["table"]}; on {smi}')
    del step, it, b
    # one batch: the table loader, the direct loader and the plain
    # versions on the same seeds and uniforms
    tl, dl = loader(tds), loader(ds)
    u = tl.sampler.hop_uniforms(TRAIN_BATCH)
    n_valid = TRAIN_BATCH - 1
    seeds = np.concatenate([train_idx[:n_valid], train_idx[:1]])
    net = model()

    def batch(lo):
      return lo._collate(lo.sampler.sample_from_nodes(seeds, n_valid,
                                                      uniforms=u),
                         seeds, n_valid)
    with torch.no_grad():
      bt, bd = batch(tl), batch(dl)
      lt, ld = float(sage_loss(net, bt)), float(sage_loss(net, bd))
      with swapped_to_plain(K, WALK_SWAPPED):
        bp = batch(tl)
        lp = float(sage_loss(net, bp))
    for other, what in ((bd, 'the directly built dataset'),
                        (bp, 'the plain versions')):
      for f in TABLE_FIELDS:
        if not torch.equal(getattr(bt, f), getattr(other, f)):
          raise AssertionError(f'table batch.{f} differs from {what}\'s')
    for other in (ld, lp):
      if not abs(lt - other) <= LOSS_TOL * max(1.0, abs(other)):
        raise AssertionError(f'table batch loss {lt} vs {other}')
    print(f'table batch ({n_valid} real seeds): bit-identical to the directly '
          f'built dataset\'s and to the plain versions\' '
          f'({int(bt.node_count)} nodes, {int(bt.edge_mask.sum())} edges), '
          f'loss {lt:.6f} (direct {ld:.6f}, plain {lp:.6f}, tolerance '
          f'{LOSS_TOL})')
    del tl, dl, bt, bd, bp, net, tds, tg
    torch.cuda.empty_cache()
    # the example at its defaults: CSV files, TableDataset on the card
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = pai_table_train.main([])
    torch.cuda.synchronize()
    paths['pai_example'] = counts()
    if not (len(out['losses']) == 2 and np.isfinite(out['losses']).all()
            and paths['pai_example']['sample_walk_dedup'] > 0
            and paths['pai_example']['gather_rows']
            == paths['pai_example']['sample_walk_dedup']):
      raise AssertionError(f'pai_table_train: {out}, launches '
                           f'{paths["pai_example"]}')
    print(f'pai_table_train.main() (2,000 nodes through CSV files, batch 256,'
          f' [10, 5], GraphSAGE 32 -> 128 -> 8, 2 epochs): '
          f'{time.perf_counter() - t0:.3f} s, epoch losses '
          + ', '.join(f'{v:.4f}' for v in out['losses'])
          + f'; launches {paths["pai_example"]}')

  with Phase('vineyard path'):
    t0 = time.perf_counter()
    store = InMemoryFragmentStore()
    bounds = np.linspace(0, NUM_NODES, FRAGMENTS + 1).astype(np.int64)
    cols = [f'f{j}' for j in range(FEAT_DIM)]
    for fid in range(FRAGMENTS):
      lo, hi = int(bounds[fid]), int(bounds[fid + 1])
      m = (src >= lo) & (src < hi)
      store.add_fragment(fid, 'product', 'also_bought', offset=lo,
                         num_vertices=hi - lo,
                         edge_index=np.stack([src[m], dst[m]]),
                         edge_ids=np.nonzero(m)[0],
                         vertex_feats={c: feats[lo:hi, j]
                                       for j, c in enumerate(cols)})
    t1 = time.perf_counter()
    vds = load_vineyard_dataset(store, list(range(FRAGMENTS)), 'product',
                                'also_bought', vcols=cols)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del store
    vg = vds.get_graph()
    for f in ('indptr', 'indices', 'edge_ids'):
      if not torch.equal(getattr(vg.topo, f), getattr(g.topo, f)):
        raise AssertionError(f'the vineyard graph\'s {f} differs from the '
                             'directly built one')
    if not torch.equal(vds.get_node_feature().table,
                       ds.get_node_feature().table):
      raise AssertionError('the vineyard features differ')
    vs = NeighborSampler(vg, list(FANOUTS), device=dev, seed=seed)
    ds_s = NeighborSampler(g, list(FANOUTS), device=dev, seed=seed)
    u = vs.hop_uniforms(TRAIN_BATCH)
    seeds = train_idx[:TRAIN_BATCH]
    K.reset_launch_counts()
    ov = vs.sample_from_nodes(seeds, uniforms=u)
    xv = vds.get_node_feature().device_gather(ov.node)
    torch.cuda.synchronize()
    paths['vineyard'] = counts()
    od = ds_s.sample_from_nodes(seeds, uniforms=u)
    xd = ds.get_node_feature().device_gather(od.node)
    with swapped_to_plain(K, WALK_SWAPPED):
      op = vs.sample_from_nodes(seeds, uniforms=u)
      xp = vds.get_node_feature().device_gather(op.node)
    for other, x, what in ((od, xd, 'the directly built dataset'),
                           (op, xp, 'the plain versions')):
      for f in WALK_FIELDS:
        if not torch.equal(getattr(ov, f), getattr(other, f)):
          raise AssertionError(f'vineyard walk {f} differs from {what}\'s')
      if not torch.equal(xv, x):
        raise AssertionError(f'vineyard gather differs from {what}\'s')
    if (paths['vineyard']['sample_walk_dedup'],
        paths['vineyard']['gather_rows']) != (1, 1):
      raise AssertionError(f'vineyard walk and gather: {paths["vineyard"]}')
    print(f'vineyard: {FRAGMENTS} fragments (contiguous id windows, the edges '
          f'whose source lies in each with their ids, {FEAT_DIM} feature '
          f'columns) stored {t1 - t0:.3f} s; load_vineyard_dataset on the '
          f'card {t2 - t1:.3f} s (a CSR a fragment, then the whole graph); '
          f'indptr, indices, edge ids and features bit-equal to the directly '
          f'built dataset; a walk of {TRAIN_BATCH} seeds ({int(ov.node_count)}'
          f' nodes) and its gather bit-identical to the direct dataset\'s and '
          f'the plain versions\'; launches {paths["vineyard"]}')
    del vds, vg, vs, ds_s, ov, od, op, xv, xd, xp
    torch.cuda.empty_cache()

  mesh = make_mesh(device=dev)
  rng = np.random.default_rng(seed + 51)
  order = rng.permutation(train_idx)
  with Phase('table dist path'):
    root = tempfile.mkdtemp(prefix='glt_table_parts_')
    try:
      dtd, stamps = DistTableDataset(), []
      real_load = dtd.load

      def load(*a, **k):
        stamps.append(time.perf_counter())
        return real_load(*a, **k)
      dtd.load = load
      t0 = time.perf_counter()
      dds = dtd.load_tables(edge_reader=edge_reader(),
                            node_reader=node_reader(), rank=0, world_size=1,
                            num_nodes=NUM_NODES, output_dir=root,
                            master_port=free_port_base(1), device=dev)
      torch.cuda.synchronize()
      t1 = time.perf_counter()
      written = disk_bytes(root)
      dg = DistGraph.from_dataset_partitions(mesh, root)
      df = DistFeature.from_dist_datasets(mesh, {0: dds})
      torch.cuda.synchronize()
      t2 = time.perf_counter()
    finally:
      shutil.rmtree(root, ignore_errors=True)
    for f in ('indptr', 'indices', 'edge_ids'):
      if not torch.equal(getattr(dds.get_graph().topo, f),
                         getattr(g.topo, f)):
        raise AssertionError(f'the online partition\'s {f} differs from the '
                             'directly built graph\'s')
    if not torch.equal(dds.get_node_feature().table,
                       ds.get_node_feature().table):
      raise AssertionError('the online partition\'s rows differ')
    print(f'table dist data: DistTableDataset.load_tables (one rank, '
          f'DistTableRandomPartitioner pushing to itself) {stamps[0] - t0:.3f}'
          f' s to partition, {written} B written; DistDataset.load on the '
          f'card {t1 - stamps[0]:.3f} s; DistGraph and DistFeature '
          f'{t2 - t1:.3f} s; its graph and rows bit-equal to the directly '
          f'built dataset\'s (the weights and labels not partitioned)')

    def trainer():
      return DistTrainStep(dg, df, model(), labels, list(FANOUTS),
                           TRAIN_BATCH, lr=LR, seed=seed)
    step = trainer()

    def one(i):
      return step(order[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH][None],
                  np.array([TRAIN_BATCH]))
    K.reset_launch_counts()
    losses, secs = [], []
    for i in range(HDIST_WARMUP + HDIST_STEPS):
      t0 = time.perf_counter()
      losses.append(one(i))
      torch.cuda.synchronize()
      secs.append(time.perf_counter() - t0)
    paths['table_dist'] = counts()
    n = HDIST_WARMUP + HDIST_STEPS
    for name, per in (('sample_hop', len(FANOUTS)), ('gather_rows', 1),
                      ('gather_rows_mixed', 0)):
      if paths['table_dist'][name] != per * n:
        raise AssertionError(f'table dist: {paths["table_dist"][name]} '
                             f'{name} launches over {n} steps')
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
      raise AssertionError(f'table dist: non-finite loss {losses}')
    ms = np.array(secs[HDIST_WARMUP:]) * 1e3
    med = float(np.median(ms))
    print(f'table dist training (DistTrainStep over the online partition, '
          f'one rank, batch {TRAIN_BATCH}, {list(FANOUTS)}): {HDIST_STEPS} '
          f'steps after {HDIST_WARMUP}, median {med:.3f} ms a step '
          f'(quartiles {np.percentile(ms, 25):.3f}-'
          f'{np.percentile(ms, 75):.3f}, min {ms.min():.3f}, max '
          f'{ms.max():.3f}), {TRAIN_BATCH / med * 1e3:.1f} seeds/s; losses '
          + ', '.join(f'{v:.4f}' for v in losses)
          + f'; launches {paths["table_dist"]}; on {smi}')
    step = trainer()
    inputs = step.own_inputs(order[-TRAIN_BATCH:][None],
                             np.array([TRAIN_BATCH - 3]))
    with torch.no_grad():
      bk = step.make_batch(*inputs)
      lk = float(sage_loss(step.model, bk))
      with swapped_to_plain(K, HDIST_SWAPPED):
        bp = step.make_batch(*inputs)
        lp = float(sage_loss(step.model, bp))
    f = differing_field(torch, bk, bp, HDIST_FIELDS)
    if f is not None:
      raise AssertionError(f'table dist batch.{f} differs between kernels '
                           'and plain')
    if not abs(lk - lp) <= LOSS_TOL * max(1.0, abs(lp)):
      raise AssertionError(f'table dist loss {lk} vs plain {lp}')
    print(f'table dist batch ({int(inputs[1])} real seeds): bit-identical to '
          f'the plain versions ({int(bk.node_count)} nodes, '
          f'{int(bk.edge_mask.sum())} edges), loss {lk:.6f} vs plain '
          f'{lp:.6f} (tolerance {LOSS_TOL})')
    del step, bk, bp, dg, df, dds
    torch.cuda.empty_cache()

  with Phase('table dist two ranks'):
    root = tempfile.mkdtemp(prefix='glt_table_two_')
    try:
      half_e = NUM_EDGES // TABLE_RANKS
      e_lo = [r * half_e for r in range(TABLE_RANKS)]
      e_hi = e_lo[1:] + [NUM_EDGES]
      n_ids = np.array_split(perm, TABLE_RANKS)
      base = free_port_base(TABLE_RANKS)
      parts, errs = [None] * TABLE_RANKS, []
      marks = [dict() for _ in range(TABLE_RANKS)]
      sent = [0] * TABLE_RANKS    # packed push payloads to the other rank

      def run(r):
        try:
          p = DistTableRandomPartitioner(
              root, rank=r, world_size=TABLE_RANKS, num_nodes=NUM_NODES,
              edge_reader=edge_reader(e_lo[r], e_hi[r]),
              node_reader=node_reader(n_ids[r]), edge_id_offset=e_lo[r],
              master_port=base, seed=seed)
          parts[r] = p
          real = p._barrier

          def barrier(key):
            real(key)
            marks[r][key] = time.perf_counter()
          p._barrier = barrier
          real_client = p._client

          def client(peer):
            c = real_client(peer)
            if peer != r and 'request' not in vars(c):
              real_req = c.request

              def request(method, *a, **kw):
                if method in ('push_edges', 'push_node_feat'):
                  sent[r] += len(a[0])
                return real_req(method, *a, **kw)
              c.request = request
            return c
          p._client = client
          marks[r]['start'] = time.perf_counter()
          marks[r]['book'] = p.partition()
        except Exception as e:  # noqa: BLE001 -- raised below
          errs.append(e)
      threads = [threading.Thread(target=run, args=(r,), daemon=True)
                 for r in range(TABLE_RANKS)]
      t0 = time.perf_counter()
      for th in threads:
        th.start()
      for th in threads:
        th.join(timeout=600)
      wall = time.perf_counter() - t0
      for p in parts:
        if p is not None:
          p.shutdown()
      if errs or any(th.is_alive() for th in threads):
        raise AssertionError(f'the two partitioner ranks failed: {errs}')
      node_pb = marks[0]['book']
      written = disk_bytes(root)
      seen_e, seen_n = [], []
      for r in range(TABLE_RANKS):
        with np.load(os.path.join(root, f'part{r}', 'graph',
                                  'data.npz')) as z:
          rows, cls, eids = z['rows'], z['cols'], z['eids']
        with np.load(os.path.join(root, f'part{r}', 'node_feat',
                                  'data.npz')) as z:
          ids, rws = z['ids'], z['feats']
        if not ((node_pb[rows] == r).all() and np.array_equal(rows, src[eids])
                and np.array_equal(cls, dst[eids])
                and (node_pb[ids] == r).all()
                and np.array_equal(rws, feats[ids])):
          raise AssertionError(f'part {r} holds an edge or a row of another '
                               'owner, or not its input')
        seen_e.append(eids)
        seen_n.append(ids)
      if not (np.array_equal(np.sort(np.concatenate(seen_e)),
                             np.arange(NUM_EDGES))
              and np.array_equal(np.sort(np.concatenate(seen_n)),
                                 np.arange(NUM_NODES))):
        raise AssertionError('an edge or a row is missing or twice')
      crossed = sum(sent)
      push = max(m['feats_done'] for m in marks) - min(m['start']
                                                       for m in marks)
      for r in range(TABLE_RANKS):
        t1 = time.perf_counter()
        d = DistDataset.load(root, r, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        owned = np.nonzero(node_pb == r)[0]
        f = d.get_node_feature()
        idx = torch.as_tensor(np.asarray(f._id2index)[owned], device=dev)
        if not (f.table.shape[0] == owned.size
                and torch.equal(f.table[idx],
                                torch.as_tensor(feats[owned], device=dev))
                and d.get_graph().num_edges == seen_e[r].size):
          raise AssertionError(f'part {r} loaded rows other than its own')
        print(f'part {r}: {seen_e[r].size} edges, {owned.size} owned rows '
              f'loaded on the card by DistDataset.load in {secs:.3f} s, '
              'exactly its own')
        del d, f, idx
    finally:
      shutil.rmtree(root, ignore_errors=True)
    print(f'table dist, two ranks (threads over loopback rpc, each half of '
          f'the edge table and of the shuffled node table, chunks of '
          f'{READ_CHUNK}): push phases {push:.3f} s ({crossed} B of packed '
          f'payloads sent between the ranks, rpc framing aside), {wall:.3f} s with the readers and the saves, '
          f'{written} B written; every edge once at its source\'s owner, '
          f'every row at its id\'s owner, equal to its input')
    del src, dst, w, feats, perm
    torch.cuda.empty_cache()

  with Phase('compress path'):
    root = tempfile.mkdtemp(prefix='glt_igbh_tree_')
    try:
      papers = IGBH_NODES['paper']
      t = [time.perf_counter()]
      igbh.synthesize(root, papers, seed=seed)
      igbh.split_seeds(root)
      t.append(time.perf_counter())
      compress_graph.compress(root, layout='CSC', bf16=True)
      torch.cuda.synchronize()
      t.append(time.perf_counter())
      counts_, edges, bfeats, *_ = igbh.load_igbh_root(root)
      t.append(time.perf_counter())
      written = disk_bytes(os.path.join(root, 'csc'))
      for (s, r, d), ei in edges.items():
        topo = Topology(torch.as_tensor(ei, device=dev), layout='CSC',
                        num_rows=counts_[d], num_cols=counts_[s])
        with np.load(os.path.join(root, 'csc', f'{s}__{r}__{d}',
                                  'compressed.npz')) as z:
          for k in ('indptr', 'indices', 'edge_ids'):
            if not torch.equal(torch.as_tensor(z[k], device=dev),
                               getattr(topo, k)):
              raise AssertionError(f'compressed {s}__{r}__{d} {k} differs '
                                   'from the CSC Topology builds')
      for nt in counts_:
        want = torch.as_tensor(np.load(os.path.join(
            root, 'processed', nt, 'node_feat.npy')), device=dev).to(
                torch.bfloat16)
        got = bfeats[nt]
        if not (got.dtype == torch.bfloat16
                and torch.equal(got.to(dev).view(torch.int16),
                                want.view(torch.int16))):
          raise AssertionError(f'the bf16 store of {nt} is not the '
                               'torch.bfloat16 cast')
    finally:
      shutil.rmtree(root, ignore_errors=True)
    print(f'compress: IGBH layout at {papers} papers synthesized and split '
          f'{t[1] - t[0]:.3f} s; compress(CSC, bf16) on the card '
          f'{t[2] - t[1]:.3f} s, {written} B written; load_igbh_root '
          f'{t[3] - t[2]:.3f} s; {len(edges)} compressed.npz equal to the '
          f'CSC Topology builds, bf16 tables equal to torch.bfloat16\'s cast')
  return paths


def host_phase_check(torch, np, K, trainer, dfs, dfh, order, mixed, smi):
  """One partitioned products batch's node lookup through the split
  store's host phase (``host_offload=False``: K3 at the owner over the hot
  rows, the cold lanes flagged, read from host memory and written on the
  card) and through K3 mixed (the pinned block): bit-identical, timed in
  turns (host clock around a synced call, medians of ROUNDS). Returns the
  host phase's launches."""
  step = trainer(dfs)
  inputs = step.own_inputs(order[:TRAIN_BATCH][None],
                           np.array([TRAIN_BATCH - 7]))
  with torch.no_grad():
    node = step.make_batch(*inputs).node.reshape(-1)
  del step
  valid = node >= 0
  node = node.clamp(min=0).to(torch.int32)
  K.reset_launch_counts()
  got = dfh.lookup_local(node, valid)
  torch.cuda.synchronize()
  launched = {fn.__name__: fn.launches for fn in K.KERNELS}
  want = dfs.lookup_local(node, valid)
  if not torch.equal(got, want):
    raise AssertionError('the host phase differs from K3 mixed')
  if (launched['gather_rows'], launched['gather_rows_mixed']) != (1, 0):
    raise AssertionError(f'a host-phase lookup launched {launched}, '
                         'expected one K3 and no K3 mixed')
  rows = dfs.id2index.index_select(0, node.long().clamp(min=0))
  cold = int(((rows >= dfs.hot_count) & valid).sum())
  times = {'host phase': [], 'K3 mixed': []}
  fns = {'host phase': lambda: dfh.lookup_local(node, valid),
         'K3 mixed': lambda: dfs.lookup_local(node, valid)}
  for _ in range(ROUNDS):
    for name, fn in fns.items():
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      fn()
      torch.cuda.synchronize()
      times[name].append((time.perf_counter() - t0) * 1e3)
  med = {k: float(np.median(v)) for k, v in times.items()}
  print(f'homo dist host phase (split {HDIST_SPLIT}, a batch\'s '
        f'{node.numel()} node slots, {int(valid.sum())} valid, {cold} of '
        f'them cold lanes): bit-identical to K3 mixed; a lookup '
        f'{med["host phase"]:.3f} ms (quartiles '
        f'{np.percentile(times["host phase"], 25):.3f}-'
        f'{np.percentile(times["host phase"], 75):.3f}) against K3 mixed\'s '
        f'lookup {med["K3 mixed"]:.3f} ms, synced host clock in turns, '
        f'medians of {ROUNDS}; launches {launched}; on {smi}')
  mixed['dist owner split 0.2 (homo batch)']['host_phase_lookup_ms'] = \
      med['host phase']
  mixed['dist owner split 0.2 (homo batch)']['mixed_lookup_ms'] = \
      med['K3 mixed']
  return launched


# server-client: two servers with one sampling worker each and one
# training client, all on one card (examples/distributed/
# server_client_mode.py at products-sage's width); each server serves half
# of the seeds of SC_BATCHES batches an epoch; the client runs SC_WARMUP +
# SC_STEPS of each of two epochs, the second under the profiler
SC_SERVERS, SC_BATCHES, SC_WARMUP, SC_STEPS, SC_PREFETCH = 2, 12, 2, 10, 2
MP_BATCHES = 3        # the mp loader's batches, each held against in process
SC_FIELDS = ('node', 'node_count', 'row', 'col', 'edge_mask', 'x', 'y',
             'num_sampled_nodes', 'num_sampled_edges')


def _dump_counts(path, extra):
  """Writes this process's wrapper counts and ``extra`` to ``path``."""
  from glt_tpu_torch.ops import cuda_kernels as K
  with open(path, 'w') as f:
    json.dump(dict(extra, launches={fn.__name__: fn.launches
                                    for fn in K.KERNELS}), f)


def _sc_dataset(root, device):
  """The products graph, features and labels that ``server client data``
  wrote to ``root``, as a Dataset on ``device``."""
  import os
  import numpy as np
  from glt_tpu_torch.data import Dataset
  load = lambda name: np.load(os.path.join(root, name + '.npy'))
  ds = Dataset().init_graph(load('edge_index'),
                            num_nodes=int(load('num_nodes')), device=device)
  ds.init_node_features(load('feats'), device=device)
  ds.init_node_labels(load('labels'))
  return ds


def sc_reference(torch, ds, labels, ref, seeds):
  """The SC_FIELDS of the batch that the in-process sampler ``ref`` draws
  next over ``seeds`` (the features by ``gather_features`` over its
  nodes clipped at 0, as a sampling worker collects them)."""
  from glt_tpu_torch.data.feature import gather_features
  out = ref.sample_from_nodes(seeds, n_valid=len(seeds))
  return dict(node=out.node, node_count=out.node_count, row=out.row,
              col=out.col, edge_mask=out.edge_mask,
              x=gather_features(ds.get_node_feature(),
                                out.node.clamp(min=0)),
              y=torch.as_tensor(labels[seeds], device=out.node.device),
              num_sampled_nodes=out.num_sampled_nodes,
              num_sampled_edges=out.num_sampled_edges)


def sc_differing(batch, want):
  """The first of SC_FIELDS in which ``batch`` differs from ``want``, or
  None."""
  import torch
  for f in SC_FIELDS:
    a = getattr(batch, f)
    if not torch.equal(a, want[f].to(a.dtype)):
      return f
  return None


def sc_build(root, device, counts):
  """A sampling worker's dataset builder: the products graph, features
  and labels that ``server client data`` wrote to ``root``, built on
  ``device``. Also starts the worker's launch counts at 0, times its
  stages (CUDA events around the sample and the feature gather; the host
  clock around the copy to the host and the send into the ring) and has
  both written to ``counts % pid`` when the worker exits."""
  import functools
  import os
  from multiprocessing import util
  import torch
  import glt_tpu_torch.distributed.dist_sampling_producer as P
  from glt_tpu_torch.channel import ShmChannel
  from glt_tpu_torch.ops import cuda_kernels as K
  from glt_tpu_torch.sampler import NeighborSampler
  t0 = time.perf_counter()
  ds = _sc_dataset(root, device)
  torch.cuda.synchronize()
  stages = {'build_s': time.perf_counter() - t0, 'sample': [], 'gather': [],
            'to_host': [], 'send': []}

  def on_card(fn, key):
    @functools.wraps(fn)
    def run(*a, **k):
      e0 = torch.cuda.Event(enable_timing=True)
      e1 = torch.cuda.Event(enable_timing=True)
      e0.record()
      out = fn(*a, **k)
      e1.record()
      e1.synchronize()
      stages[key].append(e0.elapsed_time(e1))
      return out
    return run

  def on_host(fn, key):
    @functools.wraps(fn)
    def run(*a, **k):
      t = time.perf_counter()
      out = fn(*a, **k)
      stages[key].append((time.perf_counter() - t) * 1e3)
      return out
    return run
  NeighborSampler.sample_from_nodes = on_card(
      NeighborSampler.sample_from_nodes, 'sample')
  P.gather_features = on_card(P.gather_features, 'gather')
  P.flatten_sampler_output = on_host(P.flatten_sampler_output, 'to_host')
  ShmChannel.send = on_host(ShmChannel.send, 'send')
  K.reset_launch_counts()
  util.Finalize(None, lambda: _dump_counts(counts % os.getpid(), stages),
                exitpriority=100)
  return ds


def sc_server(rank, num_servers, port, root, builder, device, ready,
              out_path):
  """A sampling server of ``server client path``: its own copy of the
  graph and features on the host (the data plane's), its workers built by
  ``builder`` on ``device`` (the card); serves until the client's exit,
  then writes the channel each producer streamed through to
  ``out_path``."""
  from glt_tpu_torch.distributed import init_server, shutdown_server
  t0 = time.perf_counter()
  ds = _sc_dataset(root, 'cpu')
  built = time.perf_counter() - t0
  srv = init_server(num_servers, 1, rank, ds, master_port=port,
                    dataset_builder=builder, device=device)
  ready.set()
  while not srv.should_exit:
    time.sleep(0.05)
  channels = {k: type(c).__name__ for k, c in srv._channels.items()}
  shutdown_server()
  with open(out_path, 'w') as f:
    json.dump(dict(channels=channels, build_s=built), f)


def fmp_worker(chan_req, chan_resp, device, counts):
  """examples/feature_mp.py's worker, its launch counts written to
  ``counts`` when it ends."""
  from glt_tpu_torch.examples import feature_mp
  from glt_tpu_torch.ops import cuda_kernels as K
  K.reset_launch_counts()
  feature_mp.feature_worker(chan_req, chan_resp, device)
  _dump_counts(counts, {})


def _worker_counts(pattern):
  """The counts files of the workers ``pattern`` names, and their
  launches summed by wrapper."""
  import glob
  got = []
  for path in sorted(glob.glob(pattern.replace('%d', '*'))):
    with open(path) as f:
      got.append(json.load(f))
  total = {}
  for g in got:
    for n, v in g['launches'].items():
      total[n] = total.get(n, 0) + v
  return got, total


def _stage_line(workers):
  import numpy as np
  parts = []
  for key in ('sample', 'gather', 'to_host', 'send'):
    v = [x for w in workers for x in w[key]]
    if v:
      parts.append(f'{key} {np.median(v):.3f} ms (max {max(v):.3f})')
  return ', '.join(parts)


def server_client_phases(torch, np, K, ds, dev, seed, k3, mixed, walk,
                         smi):
  """The server-client slice over the products graph (``ds``, its labels
  and split from the training phases): servers spawned with
  ``server_client_mode``'s roles, the remote loader's batches held
  against the in-process sampler and trained on by SageTrainStep over two
  epochs; then MpNeighborLoader and the feature_mp example, whose K3 mixed
  shape joins ``mixed``. Launch counts of K1 and K3 come from the workers'
  own counts files. Returns the launches by path."""
  import functools
  import multiprocessing as mp
  import os
  import shutil
  import tempfile
  from glt_tpu_torch.channel import ShmChannel, pack_message
  from glt_tpu_torch.data import Feature
  from glt_tpu_torch.data.feature import gather_features
  from glt_tpu_torch.distributed import (MpDistSamplingWorkerOptions,
                                         MpNeighborLoader,
                                         RemoteDistSamplingWorkerOptions,
                                         RemoteNeighborLoader,
                                         flatten_sampler_output,
                                         free_port_base, init_client,
                                         shutdown_client)
  from glt_tpu_torch.examples import feature_mp
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.parallel import SageTrainStep, sage_loss
  from glt_tpu_torch.sampler import NeighborSampler
  from glt_tpu_torch.typing import Split

  paths = {}
  fanouts = list(FANOUTS)
  root = tempfile.mkdtemp(prefix='glt_sc_')
  ctx = mp.get_context('spawn')
  servers = []
  try:
    with Phase('server client data'):
      t0 = time.perf_counter()
      src, dst, _ = ds.get_graph().topo.to_coo()
      np.save(os.path.join(root, 'edge_index.npy'),
              torch.stack([src, dst]).to(torch.int32).cpu().numpy())
      del src, dst
      np.save(os.path.join(root, 'feats.npy'),
              ds.get_node_feature().table.cpu().numpy())
      labels = np.asarray(ds.node_labels)
      np.save(os.path.join(root, 'labels.npy'), labels)
      np.save(os.path.join(root, 'num_nodes.npy'), np.array(NUM_NODES))
      disk = sum(os.path.getsize(os.path.join(root, f))
                 for f in os.listdir(root))
      order = np.random.default_rng(seed + 40).permutation(
          ds.get_split(Split.train))[:SC_BATCHES * TRAIN_BATCH]
      per_server = np.split(order, SC_SERVERS)
      # one message of this batch shape, packed as a worker packs it: the
      # rings hold two
      ref = NeighborSampler(ds.get_graph(), fanouts, device=dev, seed=seed)
      out = ref.sample_from_nodes(per_server[0][:TRAIN_BATCH])
      x = gather_features(ds.get_node_feature(), out.node.clamp(min=0))
      msg = flatten_sampler_output(out, y=torch.as_tensor(
          labels[per_server[0][:TRAIN_BATCH]]), x=x)
      msg.update({'n_valid': torch.ones(1, dtype=torch.int32),
                  '#hop_offsets': torch.zeros(len(fanouts) + 1,
                                              dtype=torch.int32),
                  '#epoch': torch.zeros(1, dtype=torch.int32)})
      msg_bytes = len(pack_message(msg))
      ring = 2 * msg_bytes + (1 << 20)
      del ref, out, x, msg
      print(f'server client data: the graph ({ds.get_graph().num_edges} '
            f'edges), features and labels written for the workers, {disk} B '
            f'in {time.perf_counter() - t0:.3f} s; a batch\'s message '
            f'{msg_bytes} B (batch {TRAIN_BATCH}, {fanouts}); rings of '
            f'{ring} B')

    with Phase('server client path'):
      counts = os.path.join(root, 'sc_counts.%d.json')
      builder = functools.partial(sc_build, root, str(dev), counts)
      port = free_port_base(SC_SERVERS)
      readies = [ctx.Event() for _ in range(SC_SERVERS)]
      outs = [os.path.join(root, f'server{r}.json')
              for r in range(SC_SERVERS)]
      t0 = time.perf_counter()
      servers = [ctx.Process(target=sc_server, args=(
          r, SC_SERVERS, port, root, builder, str(dev), readies[r],
          outs[r]))
          for r in range(SC_SERVERS)]
      for p in servers:
        p.start()
      for r, e in enumerate(readies):
        if not e.wait(timeout=300):
          raise AssertionError(f'server {r} did not come up')
      up = time.perf_counter() - t0
      init_client(SC_SERVERS, 1, 0, master_port=port, rpc_timeout=600.0)
      try:
        loader = RemoteNeighborLoader(
            fanouts, per_server, batch_size=TRAIN_BATCH, shuffle=True,
            collect_features=True, seed=seed, device=dev,
            worker_options=RemoteDistSamplingWorkerOptions(
                server_rank=list(range(SC_SERVERS)),
                prefetch_size=SC_PREFETCH, buffer_capacity_bytes=ring,
                rpc_timeout=600.0))
        torch.manual_seed(seed)
        model = GraphSAGE(FEAT_DIM, HIDDEN, CLASSES, num_layers=3).to(dev)
        step = SageTrainStep(model, lr=LR)
        it = iter(loader)
        t1 = time.perf_counter()
        first = None
        waits, secs, losses = [], [], []

        def one():
          nonlocal first
          t = time.perf_counter()
          b = next(it)
          waits.append(time.perf_counter() - t)
          if first is None and int(b.batch[0]) in set(
              per_server[0].tolist()):
            first = b
          losses.append(float(step(b)))
          torch.cuda.synchronize()
          secs.append(time.perf_counter() - t)

        def drain():
          rest = sum(1 for _ in it)    # the epoch's end: every server's
          if rest:                      # END came after the last batch
            raise AssertionError(f'{rest} batches past {SC_BATCHES}')
        # epoch 0: the rate over a window without the profiler
        for _ in range(SC_WARMUP):
          one()
        first_s = time.perf_counter() - t1
        waits.clear()
        secs.clear()
        t1 = time.perf_counter()
        for _ in range(SC_STEPS):
          one()
        window = time.perf_counter() - t1
        drain()
        win_waits, win_secs = list(waits), list(secs)
        # epoch 1: the same steps under the profiler, for the busy share
        it = iter(loader)
        for _ in range(SC_WARMUP):
          one()
        wall, busy = profile_stages(
            torch, lambda: [one() for _ in range(SC_STEPS)], SC_STEPS, (),
            'step')
        drain()
      finally:
        shutdown_client()
        for p in servers:
          p.join(timeout=120)
      if any(p.exitcode != 0 for p in servers):
        raise AssertionError(f'servers exited {[p.exitcode for p in servers]}')
      chans, built = [], []
      for o in outs:
        with open(o) as f:
          got = json.load(f)
        chans.append(got['channels'])
        built.append(got['build_s'])
      if any(set(c.values()) != {'ShmChannel'} or not c for c in chans):
        raise AssertionError(f'a server streamed through {chans}, not a '
                             'ShmChannel')
      workers, paths['server_client'] = _worker_counts(counts)
      launched = paths['server_client']
      if len(workers) != SC_SERVERS or (
          launched['sample_walk_dedup'], launched['gather_rows']) != (
              2 * SC_BATCHES, 2 * SC_BATCHES):
        raise AssertionError(f'{len(workers)} workers launched {launched}, '
                             f'expected {2 * SC_BATCHES} K1 and K3 in all '
                             'over two epochs')
      # the first batch of server 0 against the in-process sampler on the
      # card: the same generator seed, the same first order of epoch 0
      if first is None:
        raise AssertionError('no batch of server 0 arrived')
      seeds0 = per_server[0][np.random.default_rng(0).permutation(
          per_server[0].shape[0])[:TRAIN_BATCH]]
      if not np.array_equal(first.batch.cpu().numpy(), seeds0):
        raise AssertionError('server 0\'s first batch is not its first seeds')
      ref = NeighborSampler(ds.get_graph(), fanouts, device=dev, seed=seed)
      want = sc_reference(torch, ds, labels, ref, seeds0)
      bad = sc_differing(first, want)
      if bad:
        raise AssertionError(f'remote batch.{bad} differs from the '
                             'in-process sampler\'s')
      local = type(first)(**{**first.__dict__, **{
          f: want[f] for f in SC_FIELDS}})
      with torch.no_grad():
        lr_, ll_ = float(sage_loss(model, first)), float(sage_loss(model,
                                                                    local))
      if not abs(lr_ - ll_) <= LOSS_TOL * max(1.0, abs(ll_)):
        raise AssertionError(f'remote loss {lr_} vs local {ll_}')
      # the workers' 'sample' stage in this process, on a card nobody
      # shares: CUDA events around the same call at the same batch
      in_proc = []
      for _ in range(SC_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ref.sample_from_nodes(seeds0, n_valid=TRAIN_BATCH)
        e1.record()
        e1.synchronize()
        in_proc.append(e0.elapsed_time(e1))
      call_wall, call_busy = profile_stages(
          torch, lambda: [ref.sample_from_nodes(seeds0, n_valid=TRAIN_BATCH)
                          for _ in range(SC_STEPS)], SC_STEPS, (),
          'sample_from_nodes call')
      k3['float32 x 100 (server-client batch)'] = time_gather(
          torch, np, K, 'float32 x 100 (server-client batch)',
          ds.get_node_feature().table, first.node)
      ms = np.array(win_secs) * 1e3
      stage_line = _stage_line(workers)
      print(f'server client path ({SC_SERVERS} servers, one sampling worker '
            f'each on the card, one client; batch {TRAIN_BATCH}, {fanouts}, '
            f'GraphSAGE {FEAT_DIM} -> {HIDDEN} -> {HIDDEN} -> {CLASSES}, '
            f'Adam {LR}): servers up in {up:.3f} s (their host copies '
            + ', '.join(f'{b:.3f}' for b in built) + ' s), the first '
            f'{SC_WARMUP} batches {first_s:.3f} s after the loader started; '
            f'epoch 0, {SC_STEPS} steps after {SC_WARMUP} warm-up, no '
            f'profiler: {window:.3f} s, {SC_STEPS / window:.3f} batches/s; a '
            f'step (recv and step, synced) median {np.median(ms):.3f} ms '
            f'(quartiles {np.percentile(ms, 25):.3f}-'
            f'{np.percentile(ms, 75):.3f}, min {ms.min():.3f}, max '
            f'{ms.max():.3f}), the recv wait a batch median '
            f'{np.median(win_waits) * 1e3:.3f} ms (max '
            f'{max(win_waits) * 1e3:.3f}, {sum(win_waits) / window * 100:.1f}'
            f'% of the window); epoch 1, {SC_STEPS} steps under the '
            f'profiler: {wall:.3f} ms wall a step, device busy {busy:.3f} ms '
            f'({busy / wall * 100:.1f}%); a message {msg_bytes} B; the '
            f'workers\' stages: {stage_line}; in this process on the idle '
            f'card, the same sample_from_nodes call median '
            f'{np.median(in_proc):.3f} ms (CUDA events, as the workers\' '
            f'sample stage; min {min(in_proc):.3f}; profiled, '
            f'{call_wall:.3f} ms wall a call, {call_busy:.3f} ms of it busy) '
            f'and K1 alone at '
            f'B={TRAIN_BATCH} {walk[1024]["ms"]:.4f} ms; channels {chans}; '
            f'launches {launched}; server 0\'s first batch bit-identical to '
            f'the in-process sampler\'s, loss {lr_:.6f} vs {ll_:.6f}; losses '
            + ', '.join(f'{v:.4f}' for v in losses) + f'; on {smi}')
      if not np.isfinite(losses).all():
        raise AssertionError(f'server client: non-finite loss {losses}')
      del loader, it, first, local, model, step, want, ref

    with Phase('mp loader path'):
      counts = os.path.join(root, 'mp_counts.%d.json')
      seeds = order[:MP_BATCHES * TRAIN_BATCH]
      loader = MpNeighborLoader(
          functools.partial(sc_build, root, str(dev), counts), fanouts,
          input_nodes=seeds, batch_size=TRAIN_BATCH, collect_features=True,
          seed=seed + 1, device=dev,
          worker_options=MpDistSamplingWorkerOptions(
              num_workers=1, channel_capacity_bytes=ring,
              rpc_timeout=600.0))
      try:
        if not isinstance(loader.channel, ShmChannel):
          raise AssertionError(f'the mp loader streams through '
                               f'{type(loader.channel).__name__}')
        t0 = time.perf_counter()
        got = list(loader)
        secs = time.perf_counter() - t0
      finally:
        loader.shutdown()
      ref = NeighborSampler(ds.get_graph(), fanouts, device=dev,
                            seed=seed + 1)
      for i, b in enumerate(got):
        bad = sc_differing(b, sc_reference(
            torch, ds, labels, ref,
            seeds[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]))
        if bad:
          raise AssertionError(f'mp batch {i}.{bad} differs from the '
                               'in-process sampler\'s')
      workers, paths['mp_loader'] = _worker_counts(counts)
      launched = paths['mp_loader']
      if len(got) != MP_BATCHES or (launched['sample_walk_dedup'],
                                    launched['gather_rows']) != (
                                        MP_BATCHES, MP_BATCHES):
        raise AssertionError(f'{len(got)} mp batches, launches {launched}')
      print(f'mp loader path (one worker on the card, a ShmChannel of '
            f'{ring} B): {MP_BATCHES} batches in {secs:.3f} s from the '
            f'first request (the worker\'s start and build '
            f'{workers[0]["build_s"]:.3f} s of it), each bit-identical to the '
            f'in-process sampler\'s; the worker\'s stages: '
            f'{_stage_line(workers)}; launches {launched}')
      del got, loader, ref

    with Phase('feature mp'):
      counts = os.path.join(root, 'fmp_counts.%d.json') % 0
      got = feature_mp.run(num_batches=5, device=dev, worker=fmp_worker,
                           worker_args=(counts,))
      table = torch.from_numpy(feature_mp.table())
      for i, (ids, rows_) in enumerate(got):
        if not torch.equal(rows_, table[ids]):
          raise AssertionError(f'feature_mp lookup {i} differs from the '
                               'table\'s rows')
      with open(counts) as fh:
        paths['feature_mp'] = json.load(fh)['launches']
      if paths['feature_mp']['gather_rows_mixed'] != len(got):
        raise AssertionError(f'feature_mp launched {paths["feature_mp"]}')
      # K3 mixed at the worker's shape against its plain version here
      f = Feature(table, split_ratio=0.5, device=dev)
      label = (f'float32 x {feature_mp.DIM} split 0.5 (feature_mp, '
               f'{got[0][0].numel()} ids)')
      link = torch.empty(LINK_COPY_BYTES, dtype=torch.uint8,
                         pin_memory=True)
      mixed[label] = time_mixed(
          torch, np, K, label, f.device_part, f.cold_pinned,
          f.map_ids(got[0][0].to(dev)).to(torch.int32),
          link_rate(torch, link, dev), resident=table.to(dev))
      print(f'feature mp: {len(got)} lookups of {got[0][0].numel()} ids '
            f'over two ShmChannels to a worker whose Feature(split_ratio='
            f'0.5) holds {f.hot_count} rows on the card and '
            f'{f.num_rows - f.hot_count} pinned, each equal to the table\'s '
            f'rows; launches {paths["feature_mp"]}')
      del f, link
  finally:
    for p in servers:
      if p.is_alive():
        p.kill()
        p.join(10)
    shutil.rmtree(root, ignore_errors=True)
  return paths


FE_CLIENTS, FE_REQUESTS = 8, 40   # client threads, requests a client
FE_STALL_MS = 200.0               # the forced stall's watchdog budget
FLEET_REQUESTS, FLEET_KILL_REQUESTS = 200, 120   # (a) and (b), 8 threads
BATCH_FIELDS = ('node', 'node_count', 'row', 'col', 'edge_mask')
#: the trained products-sage weights ('train main path'), for serving
TRAINED = {}


def squared_ids(rng, n):
  """``n`` ids squared-uniform over the products nodes, as
  examples/serve_sage_products.py draws them (low ids hot)."""
  return ((rng.random(n) ** 2) * NUM_NODES).astype('int64')


def recording(fn, log, secs):
  """``fn`` with each call's first argument appended to ``log`` (a copy)
  and its wall seconds to ``secs``."""
  def call(ids, *a, **kw):
    log.append(ids.copy())
    t0 = time.perf_counter()
    try:
      return fn(ids, *a, **kw)
    finally:
      secs.append(time.perf_counter() - t0)
  return call


def recorded_batches(engine, log):
  """Route the engine's make_batch through a recorder: each bucket run's
  sample (BATCH_FIELDS) is appended to ``log`` in run order."""
  real = engine.make_batch

  def make_batch(*a, **kw):
    b = real(*a, **kw)
    log.append(tuple(getattr(b, f) for f in BATCH_FIELDS))
    return b
  engine.make_batch = make_batch


def client_load(np, address, clients, requests, seed):
  """``clients`` threads, each with its own ServingClient, each sending
  ``requests`` requests of REQUESTS sizes (drawn) over squared-uniform
  ids. Returns [(ids, rows, ms)] of every request and the wall seconds;
  raises the first client error."""
  import threading
  from glt_tpu_torch.serving import ServingClient
  out, errs, lock = [], [], threading.Lock()

  def run(c):
    rng = np.random.default_rng(seed + c)
    cli = ServingClient(*address)
    try:
      for _ in range(requests):
        ids = squared_ids(rng, int(rng.choice(REQUESTS)))
        t0 = time.perf_counter()
        rows = cli.infer(ids)
        ms = (time.perf_counter() - t0) * 1e3
        with lock:
          out.append((ids, rows, ms))
    except Exception as e:   # surfaced below
      errs.append(e)
    finally:
      cli.close()
  threads = [threading.Thread(target=run, args=(c,)) for c in range(clients)]
  t0 = time.perf_counter()
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  wall = time.perf_counter() - t0
  if errs:
    raise errs[0]
  return out, wall


def load_line(np, label, srv, engine, out, wall, secs):
  """One line of a load's numbers, as ServingMetrics and the host clock
  report them; ``secs``: the load's dispatches' handler seconds (the
  engine's infer), whose sum over the wall is the dispatcher's busy
  share."""
  snap = srv.metrics.snapshot(cache=engine.cache)
  ms = np.array([m for _, _, m in out])
  ids = sum(i.size for i, _, _ in out)
  print(f'{label}: {len(out)} requests, {ids} ids in {wall:.3f} s: '
        f'{len(out) / wall:.1f} requests/s, {ids / wall:.1f} ids/s (host '
        f'clock); ServingMetrics p50 {snap["latency_p50_ms"]:.3f} ms, p99 '
        f'{snap["latency_p99_ms"]:.3f} ms, {snap["qps"]:.1f} requests/s, '
        f'{snap["batches"]} batches, fill {snap["batch_fill_ratio"]:.3f}, '
        f'cache hit rate {snap["cache_hit_rate"]:.4f}; host clock p50 '
        f'{np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f} '
        f'ms; bucket runs {engine.run_stats()["bucket_runs"]}; '
        f'{len(secs)} dispatches, {np.mean(secs) * 1e3:.3f} ms each '
        f'(median {np.median(secs) * 1e3:.3f}), the dispatcher busy '
        f'{sum(secs) / wall * 100:.1f}% of the wall')
  return snap


def answered_by(np, engines, ids, rows):
  """The index of the engine whose cache holds exactly ``rows`` for
  ``ids`` (each at its newest version), or None."""
  for k, e in enumerate(engines):
    found = e.cache.lookup_stale(ids)
    if all(int(i) in found for i in ids) and np.array_equal(
        np.stack([found[int(i)] for i in ids]), rows):
      return k
  return None


def frontend_phases(torch, np, K, ds, dev, seed, smi):
  """The serving front ends over the products graph at products-sage's
  width: a ServingServer answering concurrent ServingClients over the rpc
  fabric, held against a plain twin's replay of its dispatches; then a
  FleetRouter over two shards of two replicas. Returns the launches by
  path."""
  import tempfile
  from glt_tpu_torch.data import Dataset
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.obs import get_tracer
  from glt_tpu_torch.partition.partition_book import RangePartitionBook
  from glt_tpu_torch.serving import (FleetRouter, FleetShard,
                                     FleetUnavailable, InferenceEngine,
                                     ServingClient, ServingServer)
  from glt_tpu_torch.stream import (SnapshotManager, StreamIngestor,
                                    StreamSampler)
  from glt_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                              save_checkpoint)

  paths = {}
  g, feat = ds.get_graph(), ds.get_node_feature()
  walk_names = ('sample_walk_dedup', 'dedup_table_insert', 'gather_rows')

  def sage():
    return GraphSAGE(FEAT_DIM, HIDDEN, CLASSES, num_layers=3)

  with Phase('serving front end path'):
    params = TRAINED.get('products_sage')
    origin = 'trained (train main path)'
    if params is None:
      params = InferenceEngine(ds, sage(), None, list(FANOUTS),
                               buckets=BUCKETS, device=dev).init_params(seed)
      origin = f'seeded ({seed})'
    with tempfile.TemporaryDirectory(prefix='glt_fe_') as d:
      t0 = time.perf_counter()
      save_checkpoint(d, 0, params)
      step, payload = restore_checkpoint(d)
      ckpt_ms = (time.perf_counter() - t0) * 1e3
    restored = payload['params']
    if step != 0 or any(not torch.equal(params[k].cpu(), restored[k])
                        for k in params):
      raise AssertionError('the checkpoint did not restore the weights')
    engine = InferenceEngine(ds, sage(), restored, list(FANOUTS),
                             buckets=BUCKETS, device=dev, seed=seed + 8)
    runs, dispatched, secs1, secs8 = [], [], [], []
    recorded_batches(engine, runs)
    srv1 = ServingServer(engine, max_wait_ms=2.0,
                         request_timeout_ms=60_000)
    srv1.batcher.handler = recording(srv1.batcher.handler, dispatched,
                                     secs1)
    K.reset_launch_counts()
    print(f'front end: {origin} weights through save_checkpoint / '
          f'restore_checkpoint ({ckpt_ms:.1f} ms); engine warmed, buckets '
          f'{engine.buckets}')
    engine.cache.reset_stats()
    one, wall1 = client_load(np, srv1.address, 1, FE_REQUESTS, seed + 20)
    snap1 = load_line(np, '1 client', srv1, engine, one, wall1, secs1)
    srv1.close()
    srv8 = ServingServer(engine, max_wait_ms=2.0, request_timeout_ms=60_000,
                         warmup=False)
    srv8.batcher.handler = recording(srv8.batcher.handler, dispatched,
                                     secs8)
    engine.cache.reset_stats()
    eight, wall8 = client_load(np, srv8.address, FE_CLIENTS, FE_REQUESTS,
                               seed + 30)
    snap8 = load_line(np, f'{FE_CLIENTS} clients', srv8, engine, eight,
                      wall8, secs8)
    # a repeat of one served 64-id request: the cache answers it whole
    rep = next(ids for ids, _, _ in eight if ids.size == 64)
    hits0 = engine.cache.hits
    runs1 = sum(engine.run_stats()['bucket_runs'].values())
    cli = ServingClient(*srv8.address)
    again = cli.infer(rep)
    if engine.cache.hits - hits0 != 64 or \
        sum(engine.run_stats()['bucket_runs'].values()) != runs1:
      raise AssertionError('the repeated 64-id request missed the cache')
    if not np.array_equal(again, [r for i, r, _ in eight if i is rep][0]):
      raise AssertionError('the cache answered other rows')
    fe_launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    total_runs = len(runs) - len(BUCKETS)     # less the warm-up's
    if total_runs != sum(engine.run_stats()['bucket_runs'].values()):
      raise AssertionError(f'{total_runs} sampled buckets, the engine '
                           f'counts {engine.run_stats()}')
    for name, want in (('sample_walk_dedup', total_runs),
                       ('gather_rows', total_runs),
                       ('dedup_table_insert', 0)):
      if fe_launches[name] != want:
        raise AssertionError(f'{name}: {fe_launches[name]} launches for '
                             f'{total_runs} bucket runs')
    print(f'launches {fe_launches}: K1 and K3 once a bucket run '
          f'({total_runs} runs over {len(dispatched)} dispatches of '
          f'{len(one) + len(eight) + 1} requests)')

    # the plain twin: same seed, buckets and cache, the kernels swapped
    # for their plain versions, replays every dispatch in order (the
    # warm-up first: the same draws in the same order)
    twin = InferenceEngine(ds, sage(), restored, list(FANOUTS),
                           buckets=BUCKETS, device=dev, seed=seed + 8)
    twin_runs = []
    recorded_batches(twin, twin_runs)
    with swapped_to_plain(K, walk_names):
      twin.warmup()
      for ids in dispatched:
        twin.infer(ids)
    if len(twin_runs) != len(runs):
      raise AssertionError(f'the twin ran {len(twin_runs)} buckets, the '
                           f'server {len(runs)}')
    for k, (a, b) in enumerate(zip(runs, twin_runs)):
      for f, x, y in zip(BATCH_FIELDS, a, b):
        if not torch.equal(x, y):
          raise AssertionError(f'bucket run {k}: batch.{f} differs from '
                               'the plain twin')
    diff, n_rows = 0.0, 0
    for ids, rows, _ in one + eight:
      want = twin.cache.lookup_stale(ids)
      ref = np.stack([want[int(i)] for i in ids])
      diff = max(diff, float(np.abs(rows - ref).max()))
      n_rows += ids.size
      if not np.allclose(rows, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL):
        raise AssertionError(f'served rows differ from the plain twin by '
                             f'{diff}')
    print(f'plain twin: {len(runs)} bucket runs bit-identical samples; '
          f'{n_rows} served rows within {diff:.3e} of the twin\'s '
          f'(tolerance {LOGIT_TOL})')
    del runs, twin_runs, twin

    # validation before batching, with the JAX package's message
    n_disp = len(dispatched)
    try:
      cli.infer(np.array([5, NUM_NODES]))
      raise AssertionError('an out-of-range id was served')
    except ValueError as e:
      want = f'node ids out of range [0, {NUM_NODES}): [{NUM_NODES}]'
      if str(e) != want or len(dispatched) != n_disp:
        raise AssertionError(f'validation: {e!r}, '
                             f'{len(dispatched) - n_disp} dispatches')
    cli.close()
    srv8.close()

    # the stale tier: a handler that sleeps past the stall watchdog
    stall = ServingServer(engine, max_wait_ms=2.0, warmup=False,
                          request_timeout_ms=60_000,
                          stall_timeout_ms=FE_STALL_MS, stale_serve=True)
    real = stall.batcher.handler

    def wedged(ids):
      time.sleep(3 * FE_STALL_MS / 1e3)
      return real(ids)
    stall.batcher.handler = wedged
    cli = ServingClient(*stall.address)
    cached = np.unique(np.concatenate([i for i, _, _ in one]))[:4]
    fresh = np.setdiff1d(np.arange(NUM_NODES - 64, NUM_NODES),
                         list(engine.cache.lookup_stale(
                             np.arange(NUM_NODES - 64, NUM_NODES))))[:3]
    ids = np.concatenate([cached, fresh])
    have = engine.cache.lookup_stale(cached)
    t0 = time.perf_counter()
    rows = cli.infer(ids)
    stale_ms = (time.perf_counter() - t0) * 1e3
    st = cli.stats()
    want = np.concatenate([np.stack([have[int(i)] for i in cached]),
                           np.zeros((fresh.size, CLASSES), np.float32)])
    if not np.array_equal(rows, want):
      raise AssertionError('the stale tier answered other rows')
    if st['stale_serves'] != cached.size or \
        st['gauges'].get('stale_zero_fills') != fresh.size:
      raise AssertionError(f'stale tier counted {st["stale_serves"]} stale '
                           f'rows, {st["gauges"]} gauges')
    cli.close()
    stall.close()
    print(f'stale tier: a {3 * FE_STALL_MS:.0f} ms wedged dispatch past the '
          f'{FE_STALL_MS:.0f} ms watchdog answered in {stale_ms:.1f} ms, '
          f'{cached.size} rows from the cache (stale_serves '
          f'{st["stale_serves"]}), {fresh.size} zero-filled '
          f'(stale_zero_fills {st["gauges"]["stale_zero_fills"]:.0f}); '
          f'breaker opens {st["breaker_opens"]}')
    paths['serving_frontend'] = fe_launches
    print(f'serving front end: 1 client p50 {snap1["latency_p50_ms"]:.3f} / '
          f'p99 {snap1["latency_p99_ms"]:.3f} ms, {FE_CLIENTS} clients p50 '
          f'{snap8["latency_p50_ms"]:.3f} / p99 {snap8["latency_p99_ms"]:.3f}'
          f' ms; ids/s {sum(i.size for i, _, _ in one) / wall1:.1f} -> '
          f'{sum(i.size for i, _, _ in eight) / wall8:.1f}; fill '
          f'{snap1["batch_fill_ratio"]:.3f} -> {snap8["batch_fill_ratio"]:.3f}'
          f'; on {smi}')
    del engine, one, eight, dispatched
    torch.cuda.empty_cache()

  tracer = get_tracer()
  closers = []
  try:
    with Phase('fleet path'):
      # shard 0: two local engines on StreamSamplers over one
      # SnapshotManager; shard 1: two ServingServers on loopback ports.
      # The book splits the id range in half (squared-uniform ids: ~71%
      # of them fall in shard 0)
      mgr = SnapshotManager(g.topo, feat, delta_capacity=DELTA_CAPACITY,
                            device=dev)
      local_ds = Dataset(graph=g, node_features=feat)
      local = [InferenceEngine(
          local_ds, sage(), params, list(FANOUTS), buckets=BUCKETS,
          device=dev, sampler=StreamSampler(
              mgr, list(FANOUTS), delta_window=DELTA_WINDOW,
              seed=seed + 50 + i)) for i in range(2)]
      for e in local:
        e.warmup()
      remote = [InferenceEngine(ds, sage(), params, list(FANOUTS),
                                buckets=BUCKETS, device=dev,
                                seed=seed + 60 + i) for i in range(2)]
      servers = [ServingServer(e, max_wait_ms=2.0,
                               request_timeout_ms=60_000) for e in remote]
      closers += servers
      addrs = [s.address for s in servers]
      book = RangePartitionBook([NUM_NODES // 2, NUM_NODES])

      def shards():
        return [FleetShard.local('s0', local, manager=mgr),
                FleetShard.remote('s1', addrs, breaker_reset_s=0.5)]
      router = FleetRouter(shards(), book)
      closers.append(router)
      strict = FleetRouter(shards(), book, stale_serve=False)
      closers.append(strict)
      K.reset_launch_counts()
      runs0 = {id(e): dict(e.run_stats()['bucket_runs'])
               for e in local + remote}

      def fleet_load(n, seed_, on_done=None):
        import threading
        out, errs, lock = [], [], threading.Lock()

        def run(c):
          rng = np.random.default_rng(seed_ + c)
          try:
            for _ in range(n // FE_CLIENTS):
              ids = squared_ids(rng, int(rng.choice(REQUESTS)))
              t0 = time.perf_counter()
              rows = router.infer(ids, timeout_ms=60_000)
              ms = (time.perf_counter() - t0) * 1e3
              with lock:
                out.append((ids, rows, ms))
                k = len(out)
              if on_done is not None:
                on_done(k)
          except Exception as e:   # surfaced below
            errs.append(e)
        threads = [threading.Thread(target=run, args=(c,))
                   for c in range(FE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
          t.start()
        for t in threads:
          t.join()
        if errs:
          raise errs[0]
        return out, time.perf_counter() - t0

      def check_answers(out, label):
        """Each answer's rows of a shard are the rows one replica of that
        shard holds in its cache, in the input order."""
        who = {}
        for ids, rows, _ in out:
          part = book[ids]
          for s, engines in ((0, local), (1, remote)):
            sel = part == s
            if not sel.any():
              continue
            k = answered_by(np, engines, ids[sel], rows[sel])
            if k is None:
              raise AssertionError(f'{label}: an answer of shard s{s} is '
                                   'not any replica\'s cached rows')
            who[(s, k)] = who.get((s, k), 0) + 1
        return who

      # (a) mixed requests from 8 threads
      out_a, wall_a = fleet_load(FLEET_REQUESTS, seed + 70)
      who_a = check_answers(out_a, '(a)')
      ms_a = np.array([m for _, _, m in out_a])
      print(f'(a) {len(out_a)} requests from {FE_CLIENTS} threads in '
            f'{wall_a:.3f} s ({len(out_a) / wall_a:.1f} requests/s), every '
            f'answer equal to its replica\'s cached rows (answers by '
            f'(shard, replica): {who_a}); host clock p50 '
            f'{np.percentile(ms_a, 50):.3f} ms, p99 '
            f'{np.percentile(ms_a, 99):.3f} ms')

      # (b) shard 1's primary dies under load: its endpoint first, as a
      # process death drops its connections, then the rest of it
      killed = []

      def kill(k):
        if k == FLEET_KILL_REQUESTS // 4 and not killed:
          killed.append(time.perf_counter())
          servers[0].rpc.stop()
          servers[0].close()
      s1 = router.shards[1]
      out_b, wall_b = fleet_load(FLEET_KILL_REQUESTS, seed + 80, kill)
      who_b = check_answers(out_b, '(b)')
      m1 = s1.metrics.snapshot()
      if not killed or m1['failovers'] < 1:
        raise AssertionError(f'(b): failovers {m1["failovers"]}')
      print(f'(b) {len(out_b)} requests, shard s1\'s r0 killed after '
            f'{FLEET_KILL_REQUESTS // 4}: all answered ({who_b}); s1 '
            f'failovers {m1["failovers"]}, health '
            f'{s1.health.snapshot()}, breakers '
            f'{[r.breaker.state for r in s1.replicas]}')

      # (c) the second dies: shard 1 answers from the fleet's stale cache
      servers[1].rpc.stop()
      servers[1].close()
      seen = next(ids for ids, _, _ in out_a if (book[ids] == 1).sum() >= 2)
      seen = np.unique(seen[book[seen] == 1])[:4]
      prior = router._stale.lookup_stale(seen)
      never = np.setdiff1d(np.arange(NUM_NODES - 50, NUM_NODES),
                           list(router._stale.lookup_stale(
                               np.arange(NUM_NODES - 50, NUM_NODES))))[:3]
      ids = np.concatenate([seen, never, [1]])
      stale0 = s1.metrics.stale_serves
      zero0 = s1.metrics.get_gauge('stale_zero_fills')
      t0 = time.perf_counter()
      rows = router.infer(ids, timeout_ms=60_000)
      stale_ms = (time.perf_counter() - t0) * 1e3
      want = np.concatenate([np.stack([prior[int(i)] for i in seen]),
                             np.zeros((never.size, CLASSES), np.float32)])
      if not np.array_equal(rows[:-1], want):
        raise AssertionError('(c): the stale tier answered other rows')
      if (s1.metrics.stale_serves - stale0 != seen.size
          or s1.metrics.get_gauge('stale_zero_fills') - zero0
          != never.size):
        raise AssertionError('(c): stale rows or zero-fills uncounted')
      try:
        strict.infer(ids, timeout_ms=60_000)
        raise AssertionError('(c): stale_serve=False answered a dead shard')
      except FleetUnavailable as e:
        refused = str(e)
      unavailable = router.registry.get('fleet_unavailable_total',
                                        shard='s1')
      print(f'(c) both s1 replicas dead: {seen.size} rows from the fleet\'s '
            f'stale cache, {never.size} zero-filled, counted (stale_serves '
            f'{s1.metrics.stale_serves}, stale_zero_fills '
            f'{s1.metrics.get_gauge("stale_zero_fills"):.0f}, '
            f'fleet_unavailable_total {unavailable:.0f}) in {stale_ms:.1f} '
            f'ms; stale_serve=False: FleetUnavailable ({refused[:60]}...)')

      # (d) shard 1 comes back on its ports as stream replicas (a restart
      # resyncs from the base graph), then one delta fans out fleet-wide
      restarted = []
      for i, (host, port) in enumerate(addrs):
        m = SnapshotManager(g.topo, feat, delta_capacity=DELTA_CAPACITY,
                            device=dev)
        e = InferenceEngine(
            Dataset(graph=g, node_features=feat), sage(), params,
            list(FANOUTS), buckets=BUCKETS, device=dev,
            sampler=StreamSampler(m, list(FANOUTS),
                                  delta_window=DELTA_WINDOW,
                                  seed=seed + 90 + i))
        srv = ServingServer(e, host=host, port=port, max_wait_ms=2.0,
                            request_timeout_ms=60_000, warmup=False,
                            stream=StreamIngestor(m, sampler=e.sampler,
                                                  engine=e))
        closers.append(srv)
        restarted.append(e)
        runs0[id(e)] = dict(e.run_stats()['bucket_runs'])
      time.sleep(0.6)    # past shard 1's breaker reset: probes admitted
      rng = torch.Generator().manual_seed(seed + 95)
      served0 = np.unique(np.concatenate(
          [i[book[i] == 0] for i, _, _ in out_a]))
      topo = mgr.current().topo
      slots = torch.randint(0, topo.num_edges, (N_DELETES,),
                            generator=rng).to(dev)
      del_src = (torch.searchsorted(topo.indptr, slots, right=True)
                 - 1).cpu().numpy()
      del_dst = topo.indices[slots].long().cpu().numpy()
      del topo
      ins_src = np.concatenate([served0[:64], torch.randint(
          0, NUM_NODES, (N_INSERTS - 64,), generator=rng).numpy()])
      ins_dst = torch.randint(0, NUM_NODES, (N_INSERTS,),
                              generator=rng).numpy()
      upd = served0[-N_FEATURE_ROWS:]
      touched = np.unique(np.concatenate([ins_src, del_src, upd]))
      before = sum(len(e.cache.lookup_stale(touched)) for e in local)
      if before == 0:
        raise AssertionError('(d): no touched id was cached before')
      token0 = router.consistency_token()
      t0 = time.perf_counter()
      res = router.apply_delta(
          ins=np.stack([ins_src, ins_dst]), dels=np.stack([del_src,
                                                           del_dst]),
          feat_ids=upd, feat_rows=torch.randn(
              (upd.size, FEAT_DIM), generator=rng).numpy())
      delta_ms = (time.perf_counter() - t0) * 1e3
      versions = [e.snapshot_version for e in local + restarted]
      left = sum(len(e.cache.lookup_stale(touched)) for e in local)
      if (router.consistency_token() != token0 + 1
          or res['fleet_version'] != token0 + 1 or versions != [1] * 4
          or left):
        raise AssertionError(f'(d): token {token0} -> '
                             f'{router.consistency_token()}, versions '
                             f'{versions}, {left} touched rows cached')
      print(f'(d) apply_delta ({N_INSERTS} inserts, {N_DELETES} deletes, '
            f'{upd.size} feature rows) in {delta_ms:.1f} ms: token {token0} '
            f'-> {res["fleet_version"]}, snapshot versions {versions}, '
            f'{before} cached rows of {touched.size} touched ids dropped '
            f'(shards: {res["shards"]})')

      # (e) one traced request across both shards
      rng_e = np.random.default_rng(seed + 99)
      ids = np.concatenate([rng_e.integers(0, NUM_NODES // 2, 5),
                            rng_e.integers(NUM_NODES // 2, NUM_NODES, 5)])
      tracer.clear()
      tracer.enable()
      try:
        router.infer(ids, timeout_ms=60_000)
      finally:
        tracer.disable()
      evs = tracer.events()
      tracer.clear()
      tid = [e for e in evs if e['name'] == 'fleet.infer'][0]['args'][
          'trace_id']
      mine = [e for e in evs if e['args'].get('trace_id') == tid]
      shard_spans = sorted(e['args']['shard'] for e in mine
                           if e['name'] == 'fleet.shard')
      buckets = [e for e in mine if e['name'] == 'serve.bucket']
      tids = {e['args']['trace_id'] for e in evs
              if e['name'] in ('fleet.shard', 'serve.bucket')}
      if shard_spans != ['s0', 's1'] or len(buckets) < 2 or tids != {tid}:
        raise AssertionError(f'(e): shard spans {shard_spans}, '
                             f'{len(buckets)} bucket spans, trace ids '
                             f'{tids}')
      print(f'(e) one trace id over {len(mine)} spans: '
            + ', '.join(sorted({e['name'] for e in mine})))

      launches = {fn.__name__: fn.launches for fn in K.KERNELS}
      runs = {}
      for kind, engines in (('walk', remote), ('stream', local + restarted)):
        runs[kind] = sum(n - runs0[id(e)].get(b, 0) for e in engines
                         for b, n in e.run_stats()['bucket_runs'].items())
      want = dict(sample_walk_dedup=runs['walk'],
                  gather_rows=runs['walk'] + runs['stream'],
                  sample_hop=len(FANOUTS) * runs['stream'],
                  gather_windows=2 * len(FANOUTS) * runs['stream'],
                  dedup_table_insert=0)
      for name, n in want.items():
        if launches[name] != n or (name != 'dedup_table_insert' and not n):
          raise AssertionError(f'{name}: {launches[name]} launches on the '
                               f'fleet path, expected {n}')
      fm = router.metrics.snapshot(cache=router._stale)
      print(f'launches {launches} for {runs} bucket runs')
      print(f'fleet: p50 {fm["latency_p50_ms"]:.3f} ms, p99 '
            f'{fm["latency_p99_ms"]:.3f} ms over {fm["requests"]} requests '
            f'(fleet ServingMetrics); failovers {m1["failovers"]}, stale '
            f'rows {s1.metrics.stale_serves}, zero-fills '
            f'{s1.metrics.get_gauge("stale_zero_fills"):.0f}; apply_delta '
            f'{delta_ms:.1f} ms; on {smi}')
      paths['fleet'] = launches
  finally:
    tracer.disable()
    for c in reversed(closers):
      try:
        c.close()
      except Exception:
        pass
  return paths


# the rest of the stream slice: the background applier under concurrent
# clients, a CSC stream, a partition server taking deltas over rpc
STREAM_CLIENTS = 4                 # engine.infer threads during the churn
APPLIER_POLL_S = 0.05
APPLIER_STALENESS_S, APPLIER_MIN_INTERVAL_S = 1.0, 0.5
STAGE_CALL = 64                    # edges a staging call
ROUND2_INSERTS = 2048              # crosses the occupancy threshold
SERVER_FEATURE_ROWS, CHAOS_INSERTS = 64, 16


def base_keys(np, topo):
  """The (pointer, other) keys of a topology's edges in its slot order,
  on the host (sorted: slots go by pointer id, then other id)."""
  ptr, other, _ = topo.to_coo()
  return ptr.cpu().numpy() * NUM_NODES + other.cpu().numpy()


def reference_keys(np, base, dels, ins):
  """numpy's own merge, independent of the port: the sorted ``base`` keys
  less every copy of a deleted key, plus the inserted keys, sorted."""
  dels = np.unique(dels)
  pos = np.minimum(np.searchsorted(dels, base), max(dels.size - 1, 0))
  kept = base[dels[pos] != base] if dels.size else base
  ins = np.sort(ins)
  return np.insert(kept, np.searchsorted(kept, ins, side='right'), ins)


def fresh_edges(torch, np, topo, gen, n_ins, n_del, csc=False, avoid=()):
  """``n_del`` distinct existing edges (slots drawn from ``gen``) and
  ``n_ins`` random new (src, dst) pairs, none of them a deleted pair or a
  key of ``avoid``, as host int64 arrays (src, dst each); a CSC
  topology's pointer axis is the destination."""
  dev = topo.indices.device
  slots = torch.unique(torch.randint(0, topo.num_edges, (2 * n_del,),
                                     generator=gen))
  slots = slots[torch.randperm(slots.numel(), generator=gen)][:n_del]
  ptr = torch.searchsorted(topo.indptr, slots.to(dev), right=True).cpu() - 1
  other = topo.indices[slots.to(dev)].cpu().long()
  del_src, del_dst = (other, ptr) if csc else (ptr, other)
  dead = set((del_src * NUM_NODES + del_dst).tolist()) | set(avoid)
  src = torch.randint(0, NUM_NODES, (n_ins + 64,), generator=gen)
  dst = torch.randint(0, NUM_NODES, (n_ins + 64,), generator=gen)
  keep = torch.tensor([int(k) not in dead for k in
                       (src * NUM_NODES + dst).tolist()], dtype=torch.bool)
  src, dst = src[keep][:n_ins], dst[keep][:n_ins]
  if src.numel() != n_ins or del_src.numel() != n_del:
    raise AssertionError('could not draw the stream\'s edges')
  return (src.numpy(), dst.numpy()), (del_src.numpy(), del_dst.numpy())


def stream_rest_phases(torch, np, K, ds, dev, seed, smi):
  """The rest of the live-update slice at products-sage's width: the
  background applier compacting while client threads are served, a CSC
  stream sampling along in-edges, and a partition server taking deltas
  over rpc through a link that drops a reply. Each phase has a
  SnapshotManager of its own. Returns the launches by path."""
  import threading
  from glt_tpu_torch.data import Dataset, Graph
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.serving import InferenceEngine, ServingMetrics
  from glt_tpu_torch.stream import (CompactionPolicy, SnapshotManager,
                                    StreamIngestor, StreamSampler)

  paths = {}
  g, feat = ds.get_graph(), ds.get_node_feature()
  names = ('sample_hop', 'gather_windows', 'gather_rows')
  params = TRAINED.get('products_sage')
  origin = 'trained (train main path)' if params is not None \
      else f'seeded ({seed})'

  def stream_engine(data, sampler):
    engine = InferenceEngine(
        data, GraphSAGE(FEAT_DIM, HIDDEN, CLASSES, num_layers=3), params,
        list(FANOUTS), buckets=BUCKETS, device=dev, sampler=sampler)
    if params is None:
      engine.init_params(seed)
    return engine

  def check_launches(label, engine, runs0):
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    runs = sum(engine.run_stats()['bucket_runs'].values()) - runs0
    want = dict(sample_hop=len(FANOUTS) * runs,
                gather_windows=2 * len(FANOUTS) * runs, gather_rows=runs,
                sample_walk_dedup=0, dedup_table_insert=0)
    for name, n in want.items():
      if launches[name] != n or (n == 0 and name in names):
        raise AssertionError(f'{label}: {name} launched {launches[name]} '
                             f'times for {runs} bucket runs')
    return launches, runs

  def replay_plain(label, engine, batches):
    """Each recorded bucket run (seeds, n_valid, bucket, uniforms, its
    sample and logits) again through the plain versions."""
    worst = 0.0
    with torch.no_grad(), swapped_to_plain(K, names):
      for seeds, n_valid, bucket, u, fields, y in batches:
        b = engine.make_batch(seeds, n_valid, bucket, uniforms=u)
        for f, t in zip(BATCH_FIELDS + ('x',), fields):
          if not torch.equal(getattr(b, f), t):
            raise AssertionError(f'{label}: batch.{f} differs from the '
                                 'plain versions')
        if y is not None:
          yp = engine.model(b)
          worst = max(worst, float((y - yp).abs().max()))
          if not torch.allclose(y, yp, rtol=LOGIT_TOL, atol=LOGIT_TOL):
            raise AssertionError(f'{label}: logits differ from plain by '
                                 f'{worst}')
    return worst

  def stage(call, src, dst):
    for lo in range(0, len(src), STAGE_CALL):
      call(src[lo:lo + STAGE_CALL], dst[lo:lo + STAGE_CALL])

  with Phase('stream applier path'):
    gen = torch.Generator().manual_seed(seed + 40)
    topo = g.topo
    (ins_src, ins_dst), (del_src, del_dst) = fresh_edges(
        torch, np, topo, gen, N_INSERTS, N_DELETES)
    (ins2_src, ins2_dst), _ = fresh_edges(
        torch, np, topo, gen, ROUND2_INSERTS, 0,
        avoid=(del_src * NUM_NODES + del_dst).tolist())
    upd = np.unique(torch.randint(0, NUM_NODES, (2 * N_FEATURE_ROWS,),
                                  generator=gen).numpy())[:N_FEATURE_ROWS]
    rows = torch.randn((upd.size, FEAT_DIM), generator=gen).numpy()
    base = base_keys(np, topo)
    mgr = SnapshotManager(topo, feat, delta_capacity=DELTA_CAPACITY,
                          device=dev)
    sampler = StreamSampler(mgr, list(FANOUTS), delta_window=DELTA_WINDOW,
                            seed=seed + 41)
    engine = stream_engine(Dataset(graph=g, node_features=feat), sampler)
    engine.warmup()
    metrics = ServingMetrics()
    ingestor = StreamIngestor(
        mgr, sampler=sampler, engine=engine, metrics=metrics,
        policy=CompactionPolicy(occupancy_threshold=OCCUPANCY,
                                max_staleness_s=APPLIER_STALENESS_S,
                                min_interval_s=APPLIER_MIN_INTERVAL_S),
        auto_refresh=False, expand_invalidation=True)
    # who installs overlays and who compacts, by thread
    in_flush, refreshes, swaps = threading.local(), [], []
    real_flush, real_set = ingestor.flush, sampler.set_overlay

    def flush():
      in_flush.on = True
      occ = ingestor.edges.occupancy     # before the drain
      try:
        info = real_flush()
      finally:
        in_flush.on = False
      if info is not None:
        swaps.append((threading.current_thread().name, info['version'], occ,
                      info['compaction_s'] * 1e3, info['wall_s'] * 1e3,
                      time.perf_counter()))
      return info

    def set_overlay(overlay):
      refreshes.append((threading.current_thread().name,
                        getattr(in_flush, 'on', False),
                        overlay is not mgr.empty_overlay(),
                        mgr.current().version))
      real_set(overlay)
    ingestor.flush, sampler.set_overlay = flush, set_overlay
    runs0 = sum(engine.run_stats()['bucket_runs'].values())
    torch.cuda.synchronize()
    K.reset_launch_counts()
    done, errs, lat, lock = threading.Event(), [], [], threading.Lock()

    def client(c):
      rng = np.random.default_rng(seed + 50 + c)
      try:
        while not done.is_set():
          ids = squared_ids(rng, int(rng.choice(REQUESTS)))
          t0 = time.perf_counter()
          out = engine.infer(ids)
          ms = (time.perf_counter() - t0) * 1e3
          if out.shape != (ids.size, CLASSES) or not np.isfinite(out).all():
            raise AssertionError(f'client {c}: logits {out.shape}')
          with lock:
            lat.append(ms)
      except Exception as e:   # raised below
        errs.append(e)

    clients = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(STREAM_CLIENTS)]
    ingestor.start(poll_interval_s=APPLIER_POLL_S)
    try:
      for t in clients:
        t.start()
      t0 = time.perf_counter()
      stage(ingestor.insert_edges, ins_src, ins_dst)
      stage(ingestor.delete_edges, del_src, del_dst)
      for lo in range(0, upd.size, STAGE_CALL):
        ingestor.update_features(upd[lo:lo + STAGE_CALL],
                                 rows[lo:lo + STAGE_CALL])
      stage1_s = time.perf_counter() - t0
      if mgr.current().version != 0:
        raise AssertionError('round 1 compacted while staging')
      time.sleep(1.5)
      t1 = time.perf_counter()
      stage(ingestor.insert_edges, ins2_src, ins2_dst)
      stage2_s = time.perf_counter() - t1
      deadline = time.monotonic() + 30
      while mgr.current().version < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
      if mgr.current().version != 2:
        raise AssertionError(f'version {mgr.current().version} after the '
                             'second round')
    finally:
      done.set()
      for t in clients:
        t.join(timeout=60)
      ingestor.stop()       # raises the applier's error, if it died
    if errs:
      raise errs[0]
    if any(t.is_alive() for t in clients):
      raise AssertionError('a client thread did not finish')
    torch.cuda.synchronize()
    launches, runs = check_launches('stream applier path', engine, runs0)
    # (a) overlays: outside a flush only the background thread installed
    # them, and it installed the pending round-1 set before version 1
    outside = [r for r in refreshes if not r[1]]
    if any(r[0] != 'glt-stream-ingest' for r in outside):
      raise AssertionError(f'a staging-time overlay refresh: {outside}')
    if not any(r[2] and r[3] == 0 for r in outside):
      raise AssertionError('the background tick installed no pending '
                           'overlay before version 1')
    # (b) version 1 from the tick's staleness check, then version 2 from
    # the occupancy policy (min_interval_s is read before the compaction
    # lock, as in the JAX package: a policy check made while version 1's
    # flush still waits for the engine lock compacts right after it)
    if [s[1] for s in swaps] != [1, 2]:
      raise AssertionError(f'compactions {swaps}')
    (th1, _, occ1, ms1, wall1, ts1), (th2, _, occ2, ms2, wall2, ts2) = swaps
    if th1 != 'glt-stream-ingest' or occ1 >= OCCUPANCY:
      raise AssertionError(f'version 1 on {th1} at occupancy {occ1}')
    if occ2 < OCCUPANCY:
      raise AssertionError(f'version 2 at occupancy {occ2}')
    if ingestor.tick_errors_total or metrics.get_gauge(
        'ingest_tick_errors'):
      raise AssertionError(f'{ingestor.tick_errors_total} tick errors')
    # (c) the final snapshot against numpy's merge
    snap = mgr.current()
    want = reference_keys(
        np, base, del_src * NUM_NODES + del_dst,
        np.concatenate([ins_src * NUM_NODES + ins_dst,
                        ins2_src * NUM_NODES + ins2_dst]))
    got = base_keys(np, snap.topo)
    if not np.array_equal(got, want):
      raise AssertionError(f'the compacted edges differ from numpy\'s '
                           f'merge ({got.size} against {want.size})')
    upd_rows = snap.feature.table[torch.as_tensor(upd, device=dev)].cpu()
    if not torch.equal(upd_rows, torch.as_tensor(rows)):
      raise AssertionError('the updated feature rows differ')
    # (d) a request a bucket through the plain versions, same draws
    rng = np.random.default_rng(seed + 60)
    batches = []
    with torch.no_grad():
      for b in BUCKETS:
        ids = squared_ids(rng, b)
        u = sampler.hop_uniforms(b)
        bk = engine.make_batch(ids, b, b, uniforms=u)
        batches.append((ids, b, b, u, tuple(getattr(bk, f) for f in
                                            BATCH_FIELDS + ('x',)),
                        engine.model(bk)))
    diff = replay_plain('stream applier path', engine, batches)
    del batches
    # (e) the gauges against stats() and the manager's counters
    gauges, st = metrics.snapshot()['gauges'], ingestor.stats()
    want_g = dict(snapshot_version=snap.version, compactions=mgr.compactions,
                  last_compaction_ms=st['last_compaction_ms'],
                  edge_capacity=mgr.edge_capacity,
                  capacity_growths=mgr.capacity_growths,
                  delta_occupancy=st['edge_delta']['occupancy'],
                  feature_delta_occupancy=st['feature_delta']['occupancy'],
                  ingest_ops_total=st['edge_delta']['total_inserts']
                  + st['edge_delta']['total_deletes']
                  + st['feature_delta']['total_updates'])
    bad = {k: (gauges.get(k), v) for k, v in want_g.items()
           if gauges.get(k) != float(v)}
    if bad or st['snapshot_version'] != 2 or st['compactions'] != 2:
      raise AssertionError(f'gauges against stats(): {bad}, {st}')
    lat = np.array(lat)
    ops = N_INSERTS + N_DELETES + upd.size
    print(f'stream applier: {origin} weights; {STREAM_CLIENTS} client '
          f'threads, {lat.size} requests during the churn, p50 '
          f'{np.percentile(lat, 50):.3f} ms, p99 '
          f'{np.percentile(lat, 99):.3f} ms (host clock); round 1 '
          f'({N_INSERTS} inserts, {N_DELETES} deletes, {upd.size} feature '
          f'rows in calls of {STAGE_CALL}) staged in {stage1_s * 1e3:.3f} '
          f'ms ({ops / stage1_s:.0f} ops/s), round 2 ({ROUND2_INSERTS} '
          f'inserts) in {stage2_s * 1e3:.3f} ms '
          f'({ROUND2_INSERTS / stage2_s:.0f} ops/s); version 1 by the '
          f'background tick\'s staleness check (occupancy {occ1:.3f}), '
          f'compaction {ms1:.3f} ms, flush {wall1:.3f} ms (the engine '
          f'lock\'s wait included); version 2 on {th2} (occupancy '
          f'{occ2:.3f}, {ts2 - ts1:.3f} s later), compaction {ms2:.3f} ms, '
          f'flush {wall2:.3f} ms; '
          f'{sum(1 for r in outside)} background overlay refreshes, none '
          f'at staging; {got.size} edges equal numpy\'s merge, '
          f'{upd.size} rows updated; {len(BUCKETS)} replayed buckets '
          f'bit-identical, logits max |diff| {diff:.3e}; gauges '
          f'{ {k: gauges[k] for k in sorted(want_g)} } equal stats(); '
          f'launches {launches} for {runs} bucket runs; on {smi}')
    paths['stream_applier'] = launches
    del engine, sampler, ingestor, mgr, snap, base, got, want
    torch.cuda.empty_cache()

  with Phase('stream csc path'):
    gen = torch.Generator().manual_seed(seed + 42)
    t0 = time.perf_counter()
    csc = g.topo.flip_layout()
    torch.cuda.synchronize()
    flip_ms = (time.perf_counter() - t0) * 1e3
    (ins_src, ins_dst), (del_src, del_dst) = fresh_edges(
        torch, np, csc, gen, N_INSERTS, N_DELETES, csc=True)
    base = base_keys(np, csc)
    mgr = SnapshotManager(csc, feat, delta_capacity=DELTA_CAPACITY,
                          device=dev)
    sampler = StreamSampler(mgr, list(FANOUTS), delta_window=DELTA_WINDOW,
                            edge_dir='in', seed=seed + 43)
    engine = stream_engine(Dataset(graph=Graph(csc, device=dev),
                                   node_features=feat, edge_dir='in'),
                           sampler)
    ingestor = StreamIngestor(mgr, sampler=sampler, engine=engine,
                              policy=CompactionPolicy(
                                  occupancy_threshold=OCCUPANCY),
                              expand_invalidation=True)
    engine.warmup()
    # each pass's bucket runs (draws and sample) recorded, then replayed
    # through the plain versions before the stream's state moves on
    runs_log, drawn = [], []
    real_draw, real_batch = sampler.hop_uniforms, engine.make_batch

    def hop_uniforms(b):
      drawn.append(real_draw(b))
      return drawn[-1]

    def make_batch(seeds, n_valid, bucket, uniforms=None):
      b = real_batch(seeds, n_valid, bucket, uniforms=uniforms)
      runs_log.append((seeds.copy(), n_valid, bucket, drawn[-1],
                       tuple(getattr(b, f) for f in BATCH_FIELDS + ('x',)),
                       None))
      return b

    replayed = []

    def serve_and_replay(label):
      sampler.hop_uniforms, engine.make_batch = hop_uniforms, make_batch
      try:
        serve_requests(torch, engine, NUM_NODES, CLASSES, rng, passes=1,
                       label=label)
      finally:
        sampler.hop_uniforms, engine.make_batch = real_draw, real_batch
      replay_plain(f'stream csc path ({label})', engine, runs_log)
      replayed.append(len(runs_log))
      runs_log.clear()
      drawn.clear()

    runs0 = sum(engine.run_stats()['bucket_runs'].values())
    torch.cuda.synchronize()
    K.reset_launch_counts()
    rng = torch.Generator().manual_seed(seed + 44)
    serve_and_replay('csc v0 pass')
    ingestor.insert_edges(ins_src, ins_dst)
    ingestor.delete_edges(del_src, del_dst)
    serve_and_replay('csc overlay pass')
    info = ingestor.flush()
    serve_and_replay('csc v1 pass')
    torch.cuda.synchronize()
    launches, runs = check_launches('stream csc path', engine, runs0)
    snap = mgr.current()
    if info['version'] != 1 or snap.topo.layout != 'CSC':
      raise AssertionError(f'csc flush: {info["version"]}, '
                           f'{snap.topo.layout}')
    want = reference_keys(np, base, del_dst * NUM_NODES + del_src,
                          ins_dst * NUM_NODES + ins_src)
    got = base_keys(np, snap.topo)
    if not np.array_equal(got, want):
      raise AssertionError('the compacted CSC edges differ from numpy\'s '
                           'merge')
    touched = np.unique(np.concatenate([ins_dst, del_dst]))
    if not np.array_equal(info['touched'], touched):
      raise AssertionError('touched is not the destinations of the delta')
    print(f'stream csc: products flipped to CSC on the card in '
          f'{flip_ms:.3f} ms; {replayed} bucket runs over v0, the '
          f'overlay ({N_INSERTS} inserts, {N_DELETES} deletes) and v1 '
          f'each bit-identical to the plain versions on its draws; flush '
          f'{info["wall_s"] * 1e3:.3f} ms (compaction '
          f'{info["compaction_s"] * 1e3:.3f} ms), layout '
          f'{snap.topo.layout}, {got.size} edges equal numpy\'s merge, '
          f'{info["touched"].size} touched ids (the delta\'s '
          f'destinations), {info["invalidated"]} cache entries dropped; '
          f'launches {launches} for {runs} bucket runs; on {smi}')
    paths['stream_csc'] = launches
    del engine, sampler, ingestor, mgr, snap, csc, runs_log, drawn, base, \
        got, want
    torch.cuda.empty_cache()

  with Phase('stream server path'):
    from glt_tpu_torch.channel import pack_message, unpack_message
    from glt_tpu_torch.distributed import (dist_client, free_port_base,
                                           init_client, init_server,
                                           shutdown, shutdown_client,
                                           shutdown_server)
    from glt_tpu_torch.distributed.rpc import RpcClient
    from glt_tpu_torch.resilience import (ChaosTcpProxy, CircuitBreaker,
                                          FaultPlan, RetryPolicy)

    class FirstReplyDrop(FaultPlan):
      """Drops the first reply of the proxy's first connection."""

      def fork(self, salt):
        child = super().fork(salt)
        if salt != 1:
          child.rates = {k: 0.0 for k in child.rates}
        return child

    gen = torch.Generator().manual_seed(seed + 45)
    (ins_src, ins_dst), (del_src, del_dst) = fresh_edges(
        torch, np, g.topo, gen, N_INSERTS, N_DELETES)
    upd = np.unique(torch.randint(0, NUM_NODES, (2 * SERVER_FEATURE_ROWS,),
                                  generator=gen).numpy())[
                                      :SERVER_FEATURE_ROWS]
    rows = torch.randn((upd.size, FEAT_DIM), generator=gen).numpy()
    # every copy of a deleted pair goes
    src, dst, _ = g.topo.to_coo()
    dead = torch.as_tensor(del_src * NUM_NODES + del_dst, device=dev)
    n_dead = int(torch.isin(src * NUM_NODES + dst, dead).sum())
    del src, dst, dead
    port = free_port_base(1)
    data = Dataset(graph=g, node_features=feat)
    srv = init_server(num_servers=1, num_clients=1, server_rank=0,
                      dataset=data, master_port=port, device=dev)
    closers = []
    try:
      init_client(num_servers=1, num_clients=1, client_rank=0,
                  master_port=port, rpc_timeout=120.0,
                  health_interval_s=None)
      closers.append(shutdown_client)
      K.reset_launch_counts()
      e0 = dist_client.request_server(0, 'get_edge_size')
      t0 = time.perf_counter()
      r1 = dist_client.apply_delta(0, ins=np.stack([ins_src, ins_dst]),
                                   dels=np.stack([del_src, del_dst]),
                                   feat_ids=upd, feat_rows=rows)
      stage_ms = (time.perf_counter() - t0) * 1e3
      t0 = time.perf_counter()
      r2 = dist_client.apply_delta(0, compact=True)
      compact_ms = (time.perf_counter() - t0) * 1e3
      stream = srv._stream_ingestor()
      first_ms = stream.manager.last_compaction_s * 1e3
      want1 = {'applied': {'inserts': N_INSERTS, 'deletes': N_DELETES,
                           'feature_rows': upd.size}, 'version': 0,
               'pending': N_INSERTS + N_DELETES + upd.size,
               'compacted': False}
      want2 = {'applied': {'inserts': 0, 'deletes': 0, 'feature_rows': 0},
               'version': 1, 'pending': 0, 'compacted': True}
      if r1 != want1 or r2 != want2:
        raise AssertionError(f'apply_delta replies {r1}, {r2}')
      if stream.manager.device != dev:
        raise AssertionError(f'the server\'s stream on '
                             f'{stream.manager.device}')
      e1 = dist_client.request_server(0, 'get_edge_size')
      if e1 != e0 + N_INSERTS - n_dead:
        raise AssertionError(f'{e1} edges after the delta, expected '
                             f'{e0} + {N_INSERTS} - {n_dead}')
      k3 = K.gather_rows.launches
      feats = unpack_message(dist_client.request_server(
          0, 'get_node_feature', pack_message({'ids': upd})))['feats']
      if K.gather_rows.launches != k3 + 1:
        raise AssertionError('get_node_feature did not gather through K3')
      if not torch.equal(feats, torch.as_tensor(rows)):
        raise AssertionError('get_node_feature serves other rows')
      # one delta through a link that drops the first reply
      proxy = ChaosTcpProxy(*dist_client._clients[0]._addr,
                            FirstReplyDrop(seed=seed, drop=1.0,
                                           max_faults=1))
      closers.append(proxy)
      cli = RpcClient(*proxy.address, timeout=120.0,
                      retry=RetryPolicy(max_attempts=4, base_delay_s=0.01,
                                        max_delay_s=0.05, jitter=0),
                      breaker=CircuitBreaker(failure_threshold=1000),
                      idempotent=frozenset({'apply_delta'}))
      closers.append(cli)
      inserts0 = stream.edges.total_inserts
      t0 = time.perf_counter()
      r3 = cli.request('apply_delta', pack_message({
          'ins': np.stack([ins_dst[:CHAOS_INSERTS], ins_src[:CHAOS_INSERTS]]),
          'compact': np.ones(1, np.int8)}), _rpc_timeout=8.0)
      chaos_ms = (time.perf_counter() - t0) * 1e3
      faults = proxy.faults_injected
      if (r3['version'] != 2 or not r3['compacted'] or cli.retries < 1
          or faults['drop'] != 1
          or stream.edges.total_inserts - inserts0 != CHAOS_INSERTS
          or stream.manager.current().version != 2):
        raise AssertionError(f'through the lossy link: {r3}, retries '
                             f'{cli.retries}, faults {faults}, '
                             f'{stream.edges.total_inserts - inserts0} '
                             'inserts staged')
      e2 = dist_client.request_server(0, 'get_edge_size')
      if e2 != e1 + CHAOS_INSERTS:
        raise AssertionError(f'{e2} edges after the retried delta')
      launches = {fn.__name__: fn.launches for fn in K.KERNELS}
      print(f'stream server: init_server over the products graph and '
            f'table on the card, init_client; apply_delta of {N_INSERTS} '
            f'inserts, {N_DELETES} deletes, {upd.size} feature rows '
            f'staged in {stage_ms:.3f} ms, compact=True in '
            f'{compact_ms:.3f} ms (compaction {first_ms:.3f} ms on the '
            f'card); edges {e0} -> {e1}; get_node_feature of the {upd.size} '
            f'updated ids through K3 equals the staged rows; through the '
            f'lossy link: {faults["drop"]} reply dropped, {cli.retries} '
            f'retry, version 1 -> {r3["version"]}, {CHAOS_INSERTS} inserts '
            f'staged once, {chaos_ms:.3f} ms (compaction '
            f'{stream.manager.last_compaction_s * 1e3:.3f} ms); launches '
            f'{launches}; on {smi}')
      paths['stream_server'] = launches
    finally:
      for c in reversed(closers):
        try:
          c() if callable(c) else c.close()
        except Exception:
          pass
      shutdown_server()
      shutdown()
    del srv, data
    torch.cuda.empty_cache()
  return paths


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
  train_launches, uniform_launches, variant_launches = train_phases(
      torch, np, K, ds, dev, opts.seed, rows, smi)
  torch.cuda.empty_cache()
  link_launches, sub_launches, seal_launches = link_phases(
      torch, np, K, ds, dev, opts.seed, k3, walk, host_us, smi)
  torch.cuda.empty_cache()
  slice_paths = link_option_phases(torch, np, K, ds, dev, opts.seed, smi)
  torch.cuda.empty_cache()
  slice_paths.update(example_phases(torch, np, K, ds, dev, opts.seed, smi))
  torch.cuda.empty_cache()
  split_launches, mixed = split_phases(torch, np, K, ds, dev, opts.seed, smi)
  torch.cuda.empty_cache()
  ss_paths = superstep_phases(torch, np, K, ds, dev, opts.seed, smi)
  torch.cuda.empty_cache()
  (dist_launches, (ss_paths['dist_hetero_superstep'],
                   ss_paths['igbh_split_superstep']),
   weighted_launches, igbh_paths) = dist_phases(torch, np, K, dev, opts.seed,
                                                k3, rows, mixed, smi)
  torch.cuda.empty_cache()
  homo_paths = homo_dist_phases(torch, np, K, ds, dev, opts.seed, rows, k3,
                                mixed, smi)
  torch.cuda.empty_cache()
  homo_paths.update(hot_cache_phases(torch, np, K, ds, dev, opts.seed, smi))
  torch.cuda.empty_cache()
  homo_paths.update(table_phases(torch, np, K, ds, dev, opts.seed, smi))
  torch.cuda.empty_cache()
  sc_paths = server_client_phases(torch, np, K, ds, dev, opts.seed, k3,
                                  mixed, walk, smi)
  torch.cuda.empty_cache()
  fe_paths = frontend_phases(torch, np, K, ds, dev, opts.seed, smi)
  torch.cuda.empty_cache()
  stream_paths = stream_rest_phases(torch, np, K, ds, dev, opts.seed, smi)
  torch.cuda.empty_cache()
  hlink_launches = hetero_link_phases(torch, np, K, dev, opts.seed, rows, k3,
                                      host_us, smi)
  torch.cuda.empty_cache()
  hgt_launches = hgt_phases(torch, np, K, dev, opts.seed, rows, k3, host_us,
                            smi)
  torch.cuda.empty_cache()
  igbh_paths.update(loader_option_checks(torch, np, K, ds, dev, opts.seed,
                                         smi))
  torch.cuda.empty_cache()
  rows['sample_walk_dedup'] = dict(
      walk[256], shapes={f'B={b}' if isinstance(b, int) else b: row
                         for b, row in walk.items()})
  with Phase('repair checks'):
    repair = repair_checks(torch, np, K, ds, dev, opts.seed, host_us)
    guard_cost(torch, np, K)

  with Phase('probe kernel checks'):
    probe_checks(torch, np, K, P, dev, opts.seed, rows, host_us)

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
             'train_uniform': uniform_launches,
             'sage_variants': variant_launches, 'link': link_launches,
             'subgraph': sub_launches, 'seal': seal_launches,
             'split': split_launches, 'dist_hetero': dist_launches,
             'dist_weighted': weighted_launches,
             'hetero_link': hlink_launches, 'hgt': hgt_launches,
             **homo_paths, **sc_paths, **fe_paths, **stream_paths,
             **igbh_paths, **slice_paths,
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
