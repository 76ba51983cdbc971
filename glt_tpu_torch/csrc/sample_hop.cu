// sample_hop: the neighbour read of one uniform hop --
// picks[i, j] = indices[clip(starts[i] + offsets[i, j], 0, E - 1)], and
// the edge id beside it when an edge-id plane is given.
//
// Replaces: glt_tpu/ops/pallas_kernels.py sample_hop (:367, its
// pallas_call at :474, the body shared with sample_hop_dedup through
// _sampled_window_picks at :282), which the JAX package reaches through
// sample_neighbors(engine='pallas') (glt_tpu/ops/sample.py:267-279): every
// positive base hop of the live-update StreamSampler (ops/delta.py
// delta_one_hop). The offsets are drawn before the launch, by the caller,
// as the TPU path draws them in its XLA prologue.
//
// Bound on this card: bytes, behind the latency of one dependent random
// read per lane. A lane reads one offset and one neighbour id and writes
// one pick (12 B, 16 B with edge ids); a row reads its start (4 B). At the
// stream path's bucket-256 shapes ([256, 15], [5888, 10], [105984, 5])
// that is about 7.6 MB per request, some 2.3 us of the 3.35 TB/s.
// Design: one thread per lane, consecutive lanes of a row in consecutive
// threads. The TPU kernel DMAs each row's W-wide CSR window into VMEM,
// picks the offsets inside it and fixes up hub rows (degree > W) with a
// per-element tail pass, because its copy engine wants contiguous runs. A
// Hopper thread reads any element, so the window, the hub list and its cap
// are gone: every lane reads indices[slot] directly, exact for any degree.
// Slots clip to [0, E - 1] as _slots_i32 (glt_tpu/ops/sample.py:139) clips
// them, E being the array's length: a stream snapshot's capacity, its -1
// padding included.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void sample_hop_kernel(const int* __restrict__ indices,
                                  const int* __restrict__ eids,
                                  int64_t num_slots,
                                  const int* __restrict__ starts,
                                  const int* __restrict__ offsets,
                                  int64_t m, int k, int* __restrict__ picks,
                                  int* __restrict__ eid_picks) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (e >= m) return;
  int64_t slot = static_cast<int64_t>(starts[e / k]) + offsets[e];
  slot = slot < 0 ? 0 : (slot >= num_slots ? num_slots - 1 : slot);
  picks[e] = indices[slot];
  if (eid_picks) eid_picks[e] = eids[slot];
}

}  // namespace

extern "C" int glt_sample_hop(const void* indices, const void* eids,
                              int64_t num_slots, const void* starts,
                              const void* offsets, int s, int k, void* picks,
                              void* eid_picks, void* stream) {
  const int64_t m = static_cast<int64_t>(s) * k;
  if (m > 0) {
    const int threads = 256;
    const int64_t blocks = (m + threads - 1) / threads;
    sample_hop_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indices), static_cast<const int*>(eids),
        num_slots, static_cast<const int*>(starts),
        static_cast<const int*>(offsets), m, k, static_cast<int*>(picks),
        static_cast<int*>(eid_picks));
  }
  return static_cast<int>(cudaGetLastError());
}
