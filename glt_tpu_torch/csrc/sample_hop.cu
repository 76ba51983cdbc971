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
// that is about 7.6 MB per request, some 2.3 us of the 3.35 TB/s, and at
// the weighted training step's ([1024, 15], [15360, 10], [153600, 5])
// about 11.9 MB. So a call costs what the host takes to enqueue it: the
// wrapper's checks, one allocation and the launch, which is why the entry
// point is a Python extension function launching through cuLaunchKernel
// (entry.cuh), not a ctypes call.
// The first design ran one thread per lane and divided its 64-bit lane
// index by k: 0.0353, 0.0319 and 0.0475 ms at the three stream hops on an
// H100 at 700 W, against torch.take's 0.0458 ms for all three (PERF.md).
// Design: a 2-D block, x over the k lanes of a row and y over rows, so a
// lane's row is its thread's y and no thread divides; lane indices are
// 32-bit (the wrapper holds S * k below 2^31). Threads of a row are
// consecutive, so a warp reads and writes contiguous lanes and its rows'
// starts by broadcast. Each thread takes kRows rows and issues their
// random reads together before it stores: at [153600, 5] one read in
// flight per thread left the hop device-bound behind torch.take, which
// keeps four.
// The TPU kernel DMAs each row's W-wide CSR window into VMEM, picks the
// offsets inside it and fixes up hub rows (degree > W) with a per-element
// tail pass, because its copy engine wants contiguous runs. A Hopper thread
// reads any element, so the window, the hub list and its cap are gone:
// every lane reads indices[slot] directly, exact for any degree. Slots clip
// to [0, E - 1] as _slots_i32 (glt_tpu/ops/sample.py:139) clips them, E
// being the array's length: a stream snapshot's capacity, its -1 padding
// included.
#include "entry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;   // rows a thread reads, their loads in flight together

// blockDim (kx, ry): kx = min(k, 256) lanes of a row (each thread takes
// lanes x, x + kx, ... when k > 256), ry = 256 / kx rows; a block holds
// kRows steps of ry rows, and a thread issues the random reads of its
// kRows rows before it stores any of them
__global__ void __launch_bounds__(kThreads)
sample_hop_kernel(const int* __restrict__ indices,
                  const int* __restrict__ eids, int64_t num_slots,
                  const int* __restrict__ starts,
                  const int* __restrict__ offsets, int s, int k,
                  int* __restrict__ picks, int* __restrict__ eid_picks) {
  const unsigned first = blockIdx.x * blockDim.y * kRows + threadIdx.y;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    int e[kRows];
    int64_t slot[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const unsigned row = first + u * blockDim.y;
      e[u] = row < static_cast<unsigned>(s) ? static_cast<int>(row) * k + j
                                            : -1;
      slot[u] = 0;
      if (e[u] >= 0) {
        const int64_t t = static_cast<int64_t>(starts[row]) + offsets[e[u]];
        slot[u] = t < 0 ? 0 : (t >= num_slots ? num_slots - 1 : t);
      }
    }
    int pick[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      if (e[u] >= 0) pick[u] = __ldg(indices + slot[u]);
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      if (e[u] >= 0) picks[e[u]] = pick[u];
    if (eid_picks) {
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (e[u] >= 0) pick[u] = __ldg(eids + slot[u]);
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (e[u] >= 0) eid_picks[e[u]] = pick[u];
    }
  }
}

}  // namespace

// Returns the launch's CUresult, 0 when it was enqueued.
extern "C" int glt_sample_hop(const void* indices, const void* eids,
                              int64_t num_slots, const void* starts,
                              const void* offsets, int s, int k, void* picks,
                              void* eid_picks, int device, void* stream) {
  if (s <= 0 || k <= 0) return 0;
  const int kx = k < kThreads ? k : kThreads;
  const int ry = kThreads / kx;
  return glt::Launch<sample_hop_kernel>::run(
      dim3((s - 1) / (ry * kRows) + 1), dim3(kx, ry), device, stream,
      static_cast<const int*>(indices), static_cast<const int*>(eids),
      num_slots, static_cast<const int*>(starts),
      static_cast<const int*>(offsets), s, k, static_cast<int*>(picks),
      static_cast<int*>(eid_picks));
}

GLT_MODULE(sample_hop,
           GLT_LAUNCH(glt_sample_hop))
