// Open-addressing id -> label table and the hop's value-rank bitmap,
// shared by the dedup kernels (dedup_table_insert.cu, sample_walk_dedup.cu,
// sample_hop_dedup.cu).
//
// Replaces: the VMEM-resident table of glt_tpu/ops/pallas_kernels.py
// (_probe_insert, make_dedup_table, dedup_table_insert :588) and, with
// the bitmap, the sort of a hop's new ids that restored the label
// contract after it (glt_tpu/ops/pipeline.py :584-633, :1162-1203).
//
// Table layout: three int32 planes of T = 2^p slots in global memory --
// keys (kEmpty = -1 marks a free slot), vals (the slot's label, -1 while
// unlabeled) and first (the minimum flat slot of a pick whose id is new
// in the current hop, INT_MAX while untouched). Linear probing from a
// multiplicative hash; keys only ever go kEmpty -> id, and every probe
// is an atomicCAS, so two inserts of one id meet in one slot. The wrappers
// size T at >= 2x the walk's node budget, so a probe always meets the id
// or a free slot; a full table is a sizing bug and traps.
//
// Labels: a new id gets count + its value rank among the hop's new ids.
// The ids are node ids in [0, n_ids) (type-tagged ids for the hetero hop),
// so that rank is the number of the hop's new ids below it, which one bit
// per id answers: each new id's head sets its bit (P2), a prefix popcount
// over the words gives each word the new ids below it (P3: each block
// counts its chunk of words, then, after a barrier, ranks them from the
// earlier blocks' counts), and a lane's rank is word_rank[x >> 5] +
// popc(word & bits below x) (P4). It does not
// depend on the order in which blocks run, so the labels are exact. The
// bitmap costs n_ids / 8 bytes a hop to clear and n_ids / 4 to scan and
// rank: 0.3 MB and 0.6 MB on the 2.45M-node products graph, 14 MB and 28
// MB at 111M nodes (some 4 and 8 us of the 3.35 TB/s).
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace glt {

constexpr int kEmpty = -1;

// Same multiplier as the TPU table (0x9E3779B9), xor-folded by 16.
__device__ __forceinline__ unsigned table_hash(int x) {
  unsigned h = static_cast<unsigned>(x) * 0x9E3779B9u;
  return h ^ (h >> 16);
}

// Slot of `x`, inserting it when absent; `*inserted` says which. Each
// slot visited is one atomicCAS, whose old value says all a read would
// (free: now x's; x: found; another id: go on), so a new id costs one
// round trip to L2, not a read and then a CAS.
__device__ __forceinline__ int table_probe_insert(int* keys, int mask, int x,
                                                  bool* inserted) {
  unsigned s = table_hash(x) & static_cast<unsigned>(mask);
  for (int n = 0; n <= mask; ++n) {
    const int prev = atomicCAS(keys + s, kEmpty, x);
    if (prev == kEmpty || prev == x) {
      *inserted = prev == kEmpty;
      return static_cast<int>(s);
    }
    s = (s + 1) & static_cast<unsigned>(mask);
  }
  __trap();
  return -1;
}

// The claim of a hop's sample phase (P1): slot of pick `x` at flat
// position `e`, inserting it when absent. Labels are written only in the
// hop's last phase, so an unlabelled slot holds an id first seen in this
// hop (a slot this lane inserted is one without a read), and its minimum
// position becomes the id's head.
__device__ __forceinline__ int table_claim(int* keys, const int* vals,
                                           int* first, int mask, int x,
                                           int e) {
  bool inserted;
  const int ts = table_probe_insert(keys, mask, x, &inserted);
  if (inserted || __ldcg(vals + ts) < 0) atomicMin(first + ts, e);
  return ts;
}

// The heads phase (P2) for lane e of a valid pick `x` at table slot `ts`:
// returns its label if the id was seen before the hop, else -2 and sets
// `*head` when e is the id's minimum lane. A head sets the id's bit. An
// id outside [0, n_ids) has no bit: a caller's bug, and it traps.
__device__ __forceinline__ int table_head(const int* vals, const int* first,
                                          int ts, int e, int x, int n_ids,
                                          unsigned* bitmap, bool* head) {
  const int v = __ldcg(vals + ts);
  const int f = __ldcg(first + ts);   // loaded beside v, not after it
  *head = false;
  if (v >= 0) return v;
  if (f == e) {
    if (static_cast<unsigned>(x) >= static_cast<unsigned>(n_ids)) __trap();
    *head = true;
    atomicOr(bitmap + (x >> 5), 1u << (x & 31));
  }
  return -2;
}

// The words [lo, hi) of the bitmap that this block ranks in P3: a chunk of
// ceil(words / blocks).
__device__ __forceinline__ void rank_chunk(int words, int* lo, int* hi) {
  const int chunk = (words + gridDim.x - 1) / gridDim.x;
  *lo = min(words, static_cast<int>(blockIdx.x) * chunk);
  *hi = min(words, *lo + chunk);
}

template <int Threads>
__device__ __forceinline__ int block_sum(int v, int* smem) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  __syncthreads();   // smem may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
  for (int i = 0; i < Threads / 32; ++i) t += smem[i];
  return t;
}

// Exclusive prefix sum of `v` over the block; `*total` the block's sum.
template <int Threads>
__device__ __forceinline__ int block_exclusive_scan(int v, int* smem,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  __syncthreads();
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  int before = 0, t = 0;
  for (int i = 0; i < Threads / 32; ++i) {
    const int w = smem[i];
    if (i < warp) before += w;
    t += w;
  }
  *total = t;
  return before + x - v;
}

// P3's first half, called by every thread of every block after the heads
// phase: the new ids in the block's chunk of words, into
// block_sums[blockIdx.x]. (Counting them with an atomic per head in P2
// instead cost more than this pass and its barrier: the heads of a skewed
// graph crowd the first chunks' counters.)
template <int Threads>
__device__ void count_words(const unsigned* bitmap, int* block_sums,
                            int words, int* smem) {
  int lo, hi;
  rank_chunk(words, &lo, &hi);
  int c = 0;
  for (int w = lo + threadIdx.x; w < hi; w += Threads)
    c += __popc(__ldcg(bitmap + w));
  c = block_sum<Threads>(c, smem);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = c;
}

// P3's second half, after a barrier: the block's prefix over the earlier
// blocks' counts, then word_rank[w] (the new ids below word w) for the
// words of its chunk. Returns the hop's number of new ids.
template <int Threads>
__device__ int rank_words(const unsigned* bitmap, int* word_rank,
                          const int* block_sums, int words, int* smem) {
  int before = 0, total = 0;
  for (int j = threadIdx.x; j < gridDim.x; j += Threads) {
    const int c = __ldcg(block_sums + j);
    total += c;
    if (j < static_cast<int>(blockIdx.x)) before += c;
  }
  before = block_sum<Threads>(before, smem);
  total = block_sum<Threads>(total, smem);
  int lo, hi;
  rank_chunk(words, &lo, &hi);
  for (int base = lo; base < hi; base += Threads) {
    const int w = base + threadIdx.x;
    const int c = w < hi ? __popc(__ldcg(bitmap + w)) : 0;
    int tile;
    const int excl = block_exclusive_scan<Threads>(c, smem, &tile);
    if (w < hi) word_rank[w] = before + excl;
    before += tile;
  }
  return total;
}

// P4: the number of the hop's new ids below `x` (any int: 0 below the
// range, all of them above it).
__device__ __forceinline__ int bit_rank(const unsigned* bitmap,
                                        const int* word_rank, int n_ids,
                                        int total, int x) {
  if (x <= 0) return 0;
  if (x >= n_ids) return total;
  const int w = x >> 5;
  return __ldcg(word_rank + w)
         + __popc(__ldcg(bitmap + w) & ((1u << (x & 31)) - 1u));
}

inline unsigned blocks_for(int n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace glt
