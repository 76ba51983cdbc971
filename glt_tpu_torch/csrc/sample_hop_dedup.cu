// sample_hop_dedup: one hop of the hetero walk -- every edge type's picks
// read from the flat edge-type plane and deduplicated against one table of
// type-tagged ids -- in one cooperative launch.
//
// Replaces: glt_tpu/ops/pallas_kernels.py sample_hop_dedup (:653) on its
// hetero path (_multihop_sample_hetero_fused, glt_tpu/ops/pipeline.py
// :1010-1230), and the per-type value-order relabel of that path's XLA
// epilogue (:1162-1203). The offsets are drawn before the launch, in the
// caller (glt_tpu_torch/ops/pipeline.py), as the TPU path draws them in
// its XLA prologue.
//
// Bound on this card: latency, not bytes. A hop reads one start per row,
// one offset and validity per lane and one neighbour id per valid lane,
// and writes a few int32 per lane: at the IGBH-small shapes of bucket 256
// the largest hop (268,800 rows x 5 lanes) moves about 30 MB, some 9 us
// of the 3.35 TB/s (PERF.md's byte bound). But every valid lane is a
// dependent random read (start -> indices_flat -> table probe) and the
// hop's labels need all of its picks first. Apart from that bound the
// rank bitmap costs type_bounds[T] / 8 bytes to clear and / 4 to rank
// (0.19 and 0.38 MB over IGBH-small's 1.52M tagged ids; dedup_table.cuh).
// On an H100 SXM at 700 W the three hops of a bucket-256 request take
// about 0.014, 0.021 and 0.078 ms of device time (4 barriers each).
// Design: one cooperative launch (glt::CoopLaunch, csrc/entry.cuh) of as
// many blocks as the card holds at once; each phase loops grid-stride and
// ends at a grid-wide barrier (cooperative_groups::this_grid().sync(),
// which since CUDA 11 needs no -rdc):
//   P1  -- clear the bitmap over [0, type_bounds[T]); one thread per
//          lane: x = indices_flat[starts[r] + offsets
//          [r, j]] (a thread reads any element, so the TPU's W-padded
//          windows and hub tail pass are gone), the edge id beside it,
//          and a lock-free probe/insert of x; an id new in this hop
//          records its minimum lane with atomicMin (table_claim).
//   P2  -- seen ids take their stored label, each new id's minimum lane
//          is its head and sets the id's bit.
//   P3  -- prefix popcount of the bitmap: each block counts its chunk of
//          words | ranks them from the earlier blocks' counts.
//   P4  -- each new lane of type t (the t whose [type_bounds[t],
//          type_bounds[t+1]) holds the tagged id) gets counts[t] +
//          rank(x) - rank(type_bounds[t]); the head writes it into the
//          table. Block 0 writes the new per-type counts, counts[t] +
//          rank(type_bounds[t+1]) - rank(type_bounds[t]).
// 4 barriers, one host launch. The sort of the heads' ids and the
// searchsorted of the per-type counts of the earlier three-launch design
// are gone: the bitmap's rank gives the same value order, exactly, and a
// bound that falls inside a word is ranked like any id. The TPU kernel
// labels new ids provisionally in the order of its sequential grid and an
// XLA remap rewrites them; blocks here run in no order, so the table
// holds final labels from the start and no remap is needed.
#include <algorithm>

#include <cooperative_groups.h>

#include "entry.cuh"
#include "dedup_table.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

struct HopDedup {
  const int* indices_flat;
  const int* eids_flat;     // null: no edge ids
  const int* starts;
  const int* offsets;
  const unsigned char* valid;
  int m, k;
  int* keys;
  int* vals;
  int* first;
  int table_slots;
  const int* type_bounds;
  int num_types;
  const int* counts;
  int n_ids;
  unsigned* bitmap;
  int* word_rank;
  int* block_sums;
  int words;
  int* picks;
  int* eid_picks;           // null: no edge ids
  int* tslot;
  int* labels;
  unsigned char* new_head;
  int* counts_out;
};

__global__ void __launch_bounds__(kThreads)
hop_dedup_kernel(const __grid_constant__ HopDedup p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int smem[kThreads / 32];
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const int mask = p.table_slots - 1;

  // P1: sample and claim
  for (int i = tid; i < p.words; i += stride) p.bitmap[i] = 0;
  for (int e = tid; e < p.m; e += stride) {
    if (!__ldg(p.valid + e)) {
      p.picks[e] = -1;
      if (p.eid_picks) p.eid_picks[e] = -1;
      p.tslot[e] = -1;
      continue;
    }
    const int slot = __ldg(p.starts + e / p.k) + __ldg(p.offsets + e);
    const int x = __ldg(p.indices_flat + slot);
    p.picks[e] = x;
    if (p.eid_picks) p.eid_picks[e] = __ldg(p.eids_flat + slot);
    p.tslot[e] = glt::table_claim(p.keys, p.vals, p.first, mask, x, e);
  }
  grid.sync();
  // P2: heads and their bits
  for (int e = tid; e < p.m; e += stride) {
    int lab = -1;
    bool head = false;
    if (__ldg(p.valid + e)) {
      lab = glt::table_head(p.vals, p.first, __ldcg(p.tslot + e), e,
                            __ldcg(p.picks + e), p.n_ids, p.bitmap, &head);
    }
    p.labels[e] = lab;
    p.new_head[e] = head ? 1 : 0;
  }
  grid.sync();
  // P3: prefix popcount
  glt::count_words<kThreads>(p.bitmap, p.block_sums, p.words, smem);
  grid.sync();
  const int total = glt::rank_words<kThreads>(p.bitmap, p.word_rank,
                                              p.block_sums, p.words, smem);
  grid.sync();
  // P4: per-type labels, and the counts after the hop
  auto rank = [&](int x) {
    return glt::bit_rank(p.bitmap, p.word_rank, p.n_ids, total, x);
  };
  for (int e = tid; e < p.m; e += stride) {
    if (p.labels[e] != -2) continue;   // this thread's own P2 write
    const int x = __ldcg(p.picks + e);
    int t = p.num_types - 1;
    while (t > 0 && __ldg(p.type_bounds + t) > x) --t;
    const int lab = __ldg(p.counts + t) + rank(x)
                    - rank(__ldg(p.type_bounds + t));
    p.labels[e] = lab;
    if (p.new_head[e]) p.vals[__ldcg(p.tslot + e)] = lab;
  }
  for (int t = tid; t < p.num_types; t += stride)
    p.counts_out[t] = __ldg(p.counts + t) + rank(__ldg(p.type_bounds + t + 1))
                      - rank(__ldg(p.type_bounds + t));
}

using HopLaunch = glt::CoopLaunch<hop_dedup_kernel, kThreads>;

}  // namespace

// The most blocks of the hop that fit on `device` at once (the scratch
// plane of per-block counts needs one int each), or a negative CUresult.
extern "C" int glt_hop_dedup_blocks(int device) {
  return HopLaunch::blocks(device);
}

// One hop in one launch. `scratch` holds the bitmap and the word ranks
// (`words` each, words >= ceil(n_ids / 32), n_ids = type_bounds[T]) and
// the per-block counts (glt_hop_dedup_blocks ints); `tslot` is m ints of
// scratch. Returns the launch's CUresult.
extern "C" int glt_hop_dedup(const void* indices_flat, const void* eids_flat,
                             const void* starts, const void* offsets,
                             const void* valid, int s, int k, void* keys,
                             void* vals, void* first, int table_slots,
                             const void* type_bounds, int num_types,
                             const void* counts, int n_ids, void* scratch,
                             int words, void* picks, void* eid_picks,
                             void* tslot, void* labels, void* new_head,
                             void* counts_out, int device, void* stream) {
  const int blocks = HopLaunch::blocks(device);
  if (blocks <= 0) return -blocks;
  if (table_slots <= 0 || table_slots & (table_slots - 1) || words <= 0
      || static_cast<int64_t>(words) * 32 < n_ids || num_types <= 0)
    return CUDA_ERROR_INVALID_VALUE;
  HopDedup p;
  p.indices_flat = static_cast<const int*>(indices_flat);
  p.eids_flat = static_cast<const int*>(eids_flat);
  p.starts = static_cast<const int*>(starts);
  p.offsets = static_cast<const int*>(offsets);
  p.valid = static_cast<const unsigned char*>(valid);
  p.m = s * k;
  p.k = k;
  p.keys = static_cast<int*>(keys);
  p.vals = static_cast<int*>(vals);
  p.first = static_cast<int*>(first);
  p.table_slots = table_slots;
  p.type_bounds = static_cast<const int*>(type_bounds);
  p.num_types = num_types;
  p.counts = static_cast<const int*>(counts);
  p.n_ids = n_ids;
  p.bitmap = static_cast<unsigned*>(scratch);
  p.word_rank = reinterpret_cast<int*>(p.bitmap + words);
  p.block_sums = p.word_rank + words;
  p.words = words;
  p.picks = static_cast<int*>(picks);
  p.eid_picks = static_cast<int*>(eid_picks);
  p.tslot = static_cast<int*>(tslot);
  p.labels = static_cast<int*>(labels);
  p.new_head = static_cast<unsigned char*>(new_head);
  p.counts_out = static_cast<int*>(counts_out);
  // the grid: no more blocks than the largest phase has threads' work for
  const int64_t work = std::max(p.m, words);
  const int grid = static_cast<int>(
      std::min<int64_t>(blocks, std::max<int64_t>(
          1, (work + kThreads - 1) / kThreads)));
  return HopLaunch::run(grid, device, stream, p);
}

GLT_MODULE(sample_hop_dedup,
           GLT_ENTRY(glt_hop_dedup_blocks),
           GLT_LAUNCH(glt_hop_dedup))
