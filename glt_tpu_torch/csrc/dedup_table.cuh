// Open-addressing id -> label table shared by the dedup kernels
// (dedup_table_insert.cu, sample_walk_dedup.cu).
//
// Layout: three int32 planes of T = 2^p slots in global memory --
// keys (kEmpty = -1 marks a free slot), vals (the slot's label, -1 while
// unlabeled) and first (the walk's minimum-slot tracker). Linear probing
// from a multiplicative hash; keys only ever go kEmpty -> id, so a stale
// read can only miss an insert, which the atomicCAS then observes.
// The wrappers size T at >= 2x the walk's node budget, so a probe always
// meets the id or a free slot; a full table is a sizing bug and traps.
#pragma once

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

}  // namespace glt
