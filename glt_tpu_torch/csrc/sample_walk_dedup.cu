// sample_walk_dedup: the uniform multi-hop walk with exact dedup/relabel,
// the whole walk in one cooperative launch.
//
// Replaces: glt_tpu/ops/pallas_kernels.py sample_walk_dedup (:998), with
// its seed phase dedup_table_insert (:588, the walk's :1119-1131), and the
// relabel epilogue of glt_tpu/ops/pipeline.py _multihop_sample_walk
// (:584-633).
//
// Bound on this card: latency, not bytes. A hop reads two indptr entries
// and K neighbour ids per frontier row and writes a few int32 per pick --
// about 20 MB for the whole walk at batch 1024, fanouts [15, 10, 5], i.e.
// a few microseconds of the 3.35 TB/s (PERF.md's byte bound) -- but every
// pick is a dependent random read (indptr -> indices -> hash table probe)
// and hop h+1 cannot start before hop h's picks are deduplicated. Apart
// from that bound the table's fill moves 3 x table_slots x 4 bytes (24 MB
// at batch 1024, 2^21 slots, ~7 us) and the rank bitmap N / 8 bytes a
// hop to clear and N / 4 to rank (dedup_table.cuh). On an H100 SXM at
// 700 W the walk at batch 1024 takes about 0.19 ms of device time: 16
// barriers of ~1.3 us, the fill ~8 us, and hop 3 (768,000 lanes) ~65 us
// to sample and claim, ~25 us for the heads and ~22 us for the labels,
// all random reads and atomics on the table; 264 blocks of 512 threads
// (64 registers) were as fast as 396 of 40 or 528 of 256.
// Design: one cooperative launch (glt::CoopLaunch, csrc/entry.cuh) of as
// many blocks as the card holds at once; each phase loops grid-stride over
// its slots, rows or lanes and ends at a grid-wide barrier
// (cooperative_groups::this_grid().sync(): since CUDA 11 it needs no
// -rdc: a cooperative launch comes with its barrier word):
//   P0      -- fill the table (keys -1, vals -1, first INT_MAX) and clear
//              the bitmap | insert the seed uniques with their labels
//              (what dedup_table_insert did as a launch of its own).
//   per hop:
//   P1      -- the frontier rows in tiles of kTile lanes, a tile a block:
//              one thread a row takes its degree from indptr_pad (an
//              invalid id INT32_MAX, or a row whose ok byte is 0, clamps to
//              row N, degree 0) and draws its CSR slots -- Floyd or
//              with-replacement offsets from the injected uniforms in the
//              exact float32 arithmetic of the TPU draw -- into shared
//              memory (a fanout above kTile into the row's own span of the
//              tslot plane); then one thread a lane reads its pick from
//              indices (no windows and no hub lists: a thread reads any
//              element) and probes/inserts it lock-free; an id new in this
//              hop records its minimum slot with atomicMin. A row's K
//              dependent reads run side by side (one thread a row read
//              them one after another: 0.22 ms for the walk at batch 256,
//              now 0.09). From hop 2 on P1 also clears the bitmap.
//   P2      -- one thread per lane: seen ids take their stored label; the
//              minimum slot of a new id is its head and sets the id's bit.
//   P3      -- prefix popcount of the bitmap: each block counts its chunk
//              of words | ranks them from the earlier blocks' counts.
//   P4      -- each new lane's label is count + its id's rank among the
//              hop's new ids, read from the bitmap; the head writes it
//              into the table. Every block carries count in a register;
//              block 0 stores the hop's new_count.
// The next hop's frontier is this hop's picks where new_head is set.
// 16 barriers for three hops, one host launch and no host synchronisation:
// the three launches, CUB sort and reductions per hop of the earlier
// design are gone, and with them the order the sort gave, which the
// bitmap's rank gives exactly (dedup_table.cuh). The TPU kernel gets
// first-occurrence order from its sequential grid; blocks here run in no
// order, so the head comes from atomicMin, and the labels follow the
// value-order contract the TPU path restores in its epilogue anyway.
#include <algorithm>

#include <cooperative_groups.h>

#include "entry.cuh"
#include "dedup_table.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
// lanes of a P1 tile (one a thread), whose CSR slots a block keeps in
// shared memory
constexpr int kTile = kThreads;
constexpr int kMaxHops = 16;
// per hop: s, k, u, picks, slots, mask, tslot, labels, new_head, new_count
constexpr int kHopFields = 10;

struct Hop {
  int s, k;
  const float* u;
  int* picks;
  int* slots;               // null without with_slots
  unsigned char* mask;
  int* tslot;
  int* labels;
  unsigned char* new_head;
  int* new_count;
};

struct Walk {
  const int* indptr_pad;
  int num_nodes;
  const int* indices;
  const int* seeds;
  const unsigned char* seed_ok;
  const int* stab_ids;
  const int* stab_labs;
  int n_seeds;
  const int* seed_count;
  int replace;
  int* keys;
  int* vals;
  int* first;
  int table_slots;
  unsigned* bitmap;
  int* word_rank;
  int* block_sums;
  int words;
  int n_hops;
  Hop hops[kMaxHops];
};

// P1's first half for frontier row r of `hop`: the row's k CSR slots
// start + offset into off[0, k) (-1 past the row's valid lanes).
__device__ void row_slots(const Walk& p, const Hop& hop, const int* frontier,
                          const unsigned char* frontier_ok, int r,
                          int* off) {
  const int k = hop.k;
  const int fid = __ldcg(frontier + r);
  const bool ok = __ldcg(frontier_ok + r) != 0 && fid != INT_MAX;
  const int addr = fid < 0 ? 0 : (fid > p.num_nodes ? p.num_nodes : fid);
  const int start = __ldg(p.indptr_pad + addr);
  const int deg = ok ? __ldg(p.indptr_pad + addr + 1) - start : 0;
  const float* ur = hop.u + static_cast<int64_t>(r) * k;
  int n_valid;
  if (p.replace) {
    // offsets = min(int(u * deg), max(deg - 1, 0)); every lane valid iff
    // deg > 0 (ops/sample.py _draw_hop, replace branch)
    for (int j = 0; j < k; ++j) {
      int t = __float2int_rz(__fmul_rn(__ldg(ur + j), __int2float_rn(deg)));
      off[j] = min(t, max(deg - 1, 0));
    }
    n_valid = deg > 0 ? k : 0;
  } else if (deg <= k) {
    for (int j = 0; j < k; ++j) off[j] = j;
    n_valid = deg;
  } else {
    // Floyd: draw t in [0, bound], take bound on a collision with an
    // earlier column (ops/sample.py _floyd_offsets)
    for (int j = 0; j < k; ++j) {
      const int bound = max(deg - k + j, 0);
      int t = __float2int_rz(__fmul_rn(__ldg(ur + j),
                                       __int2float_rn(bound + 1)));
      t = min(t, bound);
      bool dup = false;
      for (int q = 0; q < j; ++q) dup |= off[q] == t;
      off[j] = dup ? bound : t;
    }
    n_valid = k;
  }
  for (int j = 0; j < k; ++j) off[j] = j < n_valid ? start + off[j] : -1;
}

// P1's second half for lane e: read the pick at CSR slot `slot` (-1: an
// invalid lane) and claim it in the table.
__device__ void lane_pick(const Walk& p, const Hop& hop, int e, int slot) {
  if (slot < 0) {
    hop.picks[e] = -1;
    hop.mask[e] = 0;
    hop.tslot[e] = -1;
    if (hop.slots) hop.slots[e] = -1;
    return;
  }
  const int x = __ldg(p.indices + slot);
  hop.picks[e] = x;
  hop.mask[e] = 1;
  if (hop.slots) hop.slots[e] = slot;
  hop.tslot[e] = glt::table_claim(p.keys, p.vals, p.first, p.table_slots - 1,
                                  x, e);
}

// The parameter stays in the launch's parameter space (__grid_constant__):
// the device functions read it by reference, with no per-thread copy.
__global__ void __launch_bounds__(kThreads)
walk_dedup_kernel(const __grid_constant__ Walk p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int smem[kThreads / 32];
  __shared__ int tile[kTile];
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;

  // P0: a fresh table and bitmap, then the seeds
  for (int i = tid; i < p.table_slots; i += stride) {
    p.keys[i] = glt::kEmpty;
    p.vals[i] = -1;
    p.first[i] = INT_MAX;
  }
  for (int i = tid; i < p.words; i += stride) p.bitmap[i] = 0;
  grid.sync();
  for (int i = tid; i < p.n_seeds; i += stride) {
    const int x = __ldg(p.stab_ids + i);
    if (x < 0) continue;
    bool inserted;
    const int ts = glt::table_probe_insert(p.keys, p.table_slots - 1, x,
                                           &inserted);
    if (inserted) p.vals[ts] = __ldg(p.stab_labs + i);
  }

  int count = __ldg(p.seed_count);
  const int* frontier = p.seeds;
  const unsigned char* frontier_ok = p.seed_ok;
  for (int h = 0; h < p.n_hops; ++h) {
    const Hop hop = p.hops[h];
    grid.sync();   // the seeds', or the last hop's, labels are in
    // P1: sample and claim (and reset what the last hop's P3/P4 read)
    if (h > 0) {
      for (int i = tid; i < p.words; i += stride) p.bitmap[i] = 0;
    }
    // rows in tiles of about kTile lanes, a tile a block: one thread a
    // row draws its slots into shared memory (a fanout above kTile into
    // the row's own tslot span), then one thread a lane reads its pick
    // and claims it, so a row's k dependent reads run side by side
    {
      const int k = hop.k;
      const int rows = max(1, kTile / k);
      const int tiles = (hop.s + rows - 1) / rows;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int r0 = t * rows, r1 = min(hop.s, r0 + rows);
        const int e0 = r0 * k, lanes = (r1 - r0) * k;
        int* off = k <= kTile ? tile : hop.tslot + e0;
        for (int r = r0 + threadIdx.x; r < r1; r += kThreads)
          row_slots(p, hop, frontier, frontier_ok, r, off + (r - r0) * k);
        __syncthreads();
        for (int i = threadIdx.x; i < lanes; i += kThreads)
          lane_pick(p, hop, e0 + i, off[i]);
        __syncthreads();   // the tile's slots are read before the next
      }
    }
    grid.sync();
    // P2: heads and their bits
    const int m = hop.s * hop.k;
    for (int e = tid; e < m; e += stride) {
      int lab = -1;
      bool head = false;
      if (__ldcg(hop.mask + e)) {
        lab = glt::table_head(p.vals, p.first, __ldcg(hop.tslot + e), e,
                              __ldcg(hop.picks + e), p.num_nodes, p.bitmap, &head);
      }
      hop.labels[e] = lab;
      hop.new_head[e] = head ? 1 : 0;
    }
    grid.sync();
    // P3: prefix popcount
    glt::count_words<kThreads>(p.bitmap, p.block_sums, p.words, smem);
    grid.sync();
    const int total = glt::rank_words<kThreads>(p.bitmap, p.word_rank,
                                                p.block_sums, p.words, smem);
    if (tid == 0) *hop.new_count = total;
    grid.sync();
    // P4: labels count + rank, written into the table by the heads
    for (int e = tid; e < m; e += stride) {
      if (hop.labels[e] != -2) continue;   // this thread's own P2 write
      const int lab = count + glt::bit_rank(p.bitmap, p.word_rank,
                                            p.num_nodes, total,
                                            __ldcg(hop.picks + e));
      hop.labels[e] = lab;
      if (hop.new_head[e]) p.vals[__ldcg(hop.tslot + e)] = lab;
    }
    count += total;
    frontier = hop.picks;
    frontier_ok = hop.new_head;
  }
}

using WalkLaunch = glt::CoopLaunch<walk_dedup_kernel, kThreads>;

}  // namespace

// The most blocks of the walk that fit on `device` at once (the scratch
// plane of per-block counts needs one int each), or a negative CUresult.
extern "C" int glt_walk_dedup_blocks(int device) {
  return WalkLaunch::blocks(device);
}

// The whole walk in one launch. `scratch` holds, in this order, the
// table's keys, vals and first planes (table_slots each), the bitmap and
// the word ranks (`words` each, words >= ceil(N / 32)) and the per-block
// counts (glt_walk_dedup_blocks ints); `hops` is kHopFields ints per hop
// (s, k, then the pointers of u, picks, slots (0 without), mask, tslot,
// labels, new_head, new_count). Returns the launch's CUresult.
extern "C" int glt_walk_dedup(const void* indptr_pad, int num_nodes,
                              const void* indices, const void* seeds,
                              const void* seed_ok, const void* stab_ids,
                              const void* stab_labs, int n_seeds,
                              const void* seed_count, int replace,
                              void* scratch, int table_slots, int words,
                              glt::Ints<kMaxHops * kHopFields> hops,
                              int device, void* stream) {
  const int blocks = WalkLaunch::blocks(device);
  if (blocks <= 0) return -blocks;
  if (hops.n % kHopFields || table_slots <= 0
      || table_slots & (table_slots - 1) || words <= 0
      || static_cast<int64_t>(words) * 32 < num_nodes)
    return CUDA_ERROR_INVALID_VALUE;
  Walk p;
  p.indptr_pad = static_cast<const int*>(indptr_pad);
  p.num_nodes = num_nodes;
  p.indices = static_cast<const int*>(indices);
  p.seeds = static_cast<const int*>(seeds);
  p.seed_ok = static_cast<const unsigned char*>(seed_ok);
  p.stab_ids = static_cast<const int*>(stab_ids);
  p.stab_labs = static_cast<const int*>(stab_labs);
  p.n_seeds = n_seeds;
  p.seed_count = static_cast<const int*>(seed_count);
  p.replace = replace;
  p.keys = static_cast<int*>(scratch);
  p.vals = p.keys + table_slots;
  p.first = p.vals + table_slots;
  p.bitmap = reinterpret_cast<unsigned*>(p.first + table_slots);
  p.word_rank = reinterpret_cast<int*>(p.bitmap + words);
  p.block_sums = p.word_rank + words;
  p.table_slots = table_slots;
  p.words = words;
  p.n_hops = hops.n / kHopFields;
  // the grid: no more blocks than the largest phase has threads' work for
  int64_t work = std::max<int64_t>(table_slots, std::max(words, n_seeds));
  for (int h = 0; h < p.n_hops; ++h) {
    const int64_t* f = hops.v + h * kHopFields;
    Hop& hop = p.hops[h];
    hop.s = static_cast<int>(f[0]);
    hop.k = static_cast<int>(f[1]);
    hop.u = reinterpret_cast<const float*>(f[2]);
    hop.picks = reinterpret_cast<int*>(f[3]);
    hop.slots = reinterpret_cast<int*>(f[4]);
    hop.mask = reinterpret_cast<unsigned char*>(f[5]);
    hop.tslot = reinterpret_cast<int*>(f[6]);
    hop.labels = reinterpret_cast<int*>(f[7]);
    hop.new_head = reinterpret_cast<unsigned char*>(f[8]);
    hop.new_count = reinterpret_cast<int*>(f[9]);
    work = std::max<int64_t>(work, static_cast<int64_t>(hop.s) * hop.k);
  }
  const int grid = static_cast<int>(
      std::min<int64_t>(blocks, std::max<int64_t>(
          1, (work + kThreads - 1) / kThreads)));
  return WalkLaunch::run(grid, device, stream, p);
}

GLT_MODULE(sample_walk_dedup,
           GLT_ENTRY(glt_walk_dedup_blocks),
           GLT_LAUNCH(glt_walk_dedup))
