// gather_windows: the contiguous window read of the weighted and the
// full-neighbourhood hops --
// out[i, j] = arr[min(starts[i] + j, len - 1)] for j < width, over 4-byte
// elements (float32 edge weights or int32 neighbour ids).
//
// Replaces: glt_tpu/ops/pallas_kernels.py gather_windows (:165, its
// pallas_call at :226), which the JAX package reaches under
// GLT_USE_PALLAS=1 through NeighborSampler._window_kwargs
// (glt_tpu/sampler/neighbor_sampler.py:210-224): the [S, max_degree]
// weight window of sample_neighbors_weighted (glt_tpu/ops/sample.py:649)
// and the [S, max_degree] neighbour window of sample_full_neighbors (:596).
//
// Bound on this card: bytes. A row reads its start (4 B); a lane reads one
// element and writes one (8 B). At batch 1024, fanouts [15, 10, 5] and a
// window of 56 (the products-shaped graph's max out-degree) that is 76.8 MB
// per weighted batch, 22.9 us at the data sheet's 3.35 TB/s.
// Design: one thread per output lane, consecutive lanes of a row in
// consecutive threads, rows one after another, so a warp writes 128
// contiguous bytes and reads the one or two runs of its rows' windows. The
// TPU kernel issues one DMA descriptor per row and clamps each start to
// [0, len - width], which is exact only over an array padded by width
// sentinels (Graph.window_arrays keeps that padded copy). Here a thread
// reads any element, so the kernel clips each element instead, as the XLA
// slice-gather does: no padded copy. Lanes past a row's degree read the
// following rows' elements (or the last one); every caller masks them.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void gather_windows_kernel(const uint32_t* __restrict__ arr,
                                      int64_t len,
                                      const int* __restrict__ starts,
                                      int64_t m, int width,
                                      uint32_t* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (e >= m) return;
  const int64_t row = e / width;
  int64_t slot = static_cast<int64_t>(starts[row]) + (e - row * width);
  slot = slot < 0 ? 0 : (slot >= len ? len - 1 : slot);
  out[e] = arr[slot];
}

}  // namespace

extern "C" int glt_gather_windows(const void* arr, int64_t len,
                                  const void* starts, int s, int width,
                                  void* out, void* stream) {
  const int64_t m = static_cast<int64_t>(s) * width;
  if (m > 0) {
    const int threads = 256;
    const int64_t blocks = (m + threads - 1) / threads;
    gather_windows_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(arr), len,
        static_cast<const int*>(starts), m, width,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
