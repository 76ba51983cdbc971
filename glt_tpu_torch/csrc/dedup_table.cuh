// Open-addressing id -> label table shared by the dedup kernels
// (dedup_table_insert.cu, sample_walk_dedup.cu, sample_hop_dedup.cu).
//
// Layout: three int32 planes of T = 2^p slots in global memory --
// keys (kEmpty = -1 marks a free slot), vals (the slot's label, -1 while
// unlabeled) and first (the minimum flat slot of a pick whose id is new
// in the current hop). Linear probing from a multiplicative hash; keys
// only ever go kEmpty -> id, so a stale read can only miss an insert,
// which the atomicCAS then observes. The wrappers size T at >= 2x the
// walk's node budget, so a probe always meets the id or a free slot; a
// full table is a sizing bug and traps.
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

// Slot of `x`, inserting it when absent; `*inserted` says which.
__device__ __forceinline__ int table_probe_insert(int* keys, int mask, int x,
                                                  bool* inserted) {
  unsigned s = table_hash(x) & static_cast<unsigned>(mask);
  for (int n = 0; n <= mask; ++n) {
    int k = __ldcg(keys + s);
    if (k == x) {
      *inserted = false;
      return static_cast<int>(s);
    }
    if (k == kEmpty) {
      int prev = atomicCAS(keys + s, kEmpty, x);
      if (prev == kEmpty) {
        *inserted = true;
        return static_cast<int>(s);
      }
      if (prev == x) {
        *inserted = false;
        return static_cast<int>(s);
      }
    }
    s = (s + 1) & static_cast<unsigned>(mask);
  }
  __trap();
  return -1;
}

// The dedup step of a hop's sample launch: slot of pick `x` at flat
// position `e`, inserting it when absent. Labels are written only by a
// later launch of the hop, so an unlabelled slot holds an id first seen
// in this hop, and its minimum position becomes the id's head.
__device__ __forceinline__ int table_claim(int* keys, const int* vals,
                                           int* first, int mask, int x,
                                           int e) {
  bool inserted;
  const int ts = table_probe_insert(keys, mask, x, &inserted);
  if (__ldcg(vals + ts) < 0) atomicMin(first + ts, e);
  return ts;
}

// A hop's heads launch, one thread per slot: ids seen before the hop
// take their stored label; the minimum slot of a new id is its head and
// carries its id into `next_key` (INT_MAX elsewhere), which the wrapper
// sorts for the labels launch. New slots get label -2 until then.
__global__ void table_heads_kernel(const int* __restrict__ picks,
                                   const unsigned char* __restrict__ valid,
                                   const int* __restrict__ tslot,
                                   const int* __restrict__ vals,
                                   const int* __restrict__ first, int m,
                                   int* __restrict__ labels,
                                   unsigned char* __restrict__ new_head,
                                   int* __restrict__ next_key) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  int lab = -1;
  bool head = false;
  if (valid[e]) {
    const int ts = tslot[e];
    const int v = vals[ts];
    if (v >= 0) {
      lab = v;
    } else {
      lab = -2;
      head = first[ts] == e;
    }
  }
  labels[e] = lab;
  new_head[e] = head ? 1 : 0;
  next_key[e] = head ? picks[e] : INT_MAX;
}

// Index of the first element >= x in the ascending `a[0, n)`.
__device__ __forceinline__ int lower_bound(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

inline unsigned blocks_for(int n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace glt
