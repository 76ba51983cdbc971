// take2d: out[i] = table[clip(idx[i], 0, n - 1)] from a table held in
// shared memory.
//
// Replaces: benchmarks/probe_pallas_compile.py vt (rung 7, :163,
// pallas_call :172; idx [8, 3840]) and benchmarks/microbench_pallas_gather.py
// vmem_take (:129, kernel :123, pallas_call :130; idx [200, 3840] over a
// grid of (8, 3840) blocks). Both gather tab[idx >> 7, idx & 127] from a
// [64, 128] int32 table resident in VMEM, which is take(tab.ravel(), idx,
// mode='clip') for the indices they draw, the rungs' own reference; one
// kernel serves both shapes.
//
// Bound on this card: bytes. Each index is read once and each output
// written once (8 B an element, 6.1 MB at 768,000 elements: 1.8 us of
// the 3.35 TB/s); the table is 32 KB. At these sizes the launch and one
// table load per block are most of the time.
// Design: every block loads the whole table (at most 8192 words, 32 KB of
// static shared memory, so no dynamic shared memory is needed) with
// 16-byte loads, then walks the indices four at a time (16-byte loads and
// stores) over a grid-stride loop, each output a shared-memory read. The
// grid is at most two blocks an SM (1024 threads and 32 KB each), so a
// table load serves as many indices as the card's 132 SMs allow, instead
// of one (8, 3840) block of the TPU's grid per load. Indices or outputs
// that are not 16-byte aligned take the element loop.
#include "entry.cuh"
#include <cstdint>

namespace {

constexpr int kTableWords = 8192;
constexpr int kThreads = 1024;
constexpr int kBlocksPerSm = 2;

template <bool kVector>
__global__ void take2d_kernel(const int* __restrict__ table, int n,
                              const int* __restrict__ idx, int64_t m,
                              int* __restrict__ out) {
  __shared__ __align__(16) int tab[kTableWords];
  const int n4 = n / 4;
  for (int t = threadIdx.x; t < n4; t += kThreads)
    reinterpret_cast<int4*>(tab)[t] =
        __ldg(reinterpret_cast<const int4*>(table) + t);
  for (int t = 4 * n4 + threadIdx.x; t < n; t += kThreads)
    tab[t] = __ldg(table + t);
  __syncthreads();
  const int hi = n - 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads
                        + threadIdx.x;
  int64_t done = 0;
  if (kVector) {
    const int64_t m4 = m / 4;
    for (int64_t q = first; q < m4; q += stride) {
      const int4 i = __ldg(reinterpret_cast<const int4*>(idx) + q);
      int4 o;
      o.x = tab[min(max(i.x, 0), hi)];
      o.y = tab[min(max(i.y, 0), hi)];
      o.z = tab[min(max(i.z, 0), hi)];
      o.w = tab[min(max(i.w, 0), hi)];
      reinterpret_cast<int4*>(out)[q] = o;
    }
    done = 4 * m4;
  }
  for (int64_t e = done + first; e < m; e += stride)
    out[e] = tab[min(max(__ldg(idx + e), 0), hi)];
}

int sm_count(int device) {
  static int counts[glt::kMaxDevices];
  if (!counts[device])
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount,
                           device);
  return counts[device] > 0 ? counts[device] : 1;
}

}  // namespace

// Returns the launch's CUresult (entry.cuh), or CUDA_ERROR_INVALID_VALUE
// for a table of more than 8192 words; table 16-byte aligned.
extern "C" int glt_take2d(const void* table, int n, const void* idx,
                          int64_t m, void* out, int device, void* stream) {
  if (m <= 0) return 0;
  if (n <= 0 || n > kTableWords || device < 0 || device >= glt::kMaxDevices)
    return CUDA_ERROR_INVALID_VALUE;
  const bool vector = reinterpret_cast<uintptr_t>(idx) % 16 == 0
                      && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t units = vector ? (m + 3) / 4 : m;
  const int64_t want = (units - 1) / kThreads + 1;
  const int64_t cap = static_cast<int64_t>(kBlocksPerSm) * sm_count(device);
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap));
  const auto* t = static_cast<const int*>(table);
  const auto* i = static_cast<const int*>(idx);
  auto* o = static_cast<int*>(out);
  return vector ? glt::Launch<take2d_kernel<true>>::run(
                      grid, dim3(kThreads), device, stream, t, n, i, m, o)
                : glt::Launch<take2d_kernel<false>>::run(
                      grid, dim3(kThreads), device, stream, t, n, i, m, o);
}

GLT_MODULE(take2d,
           GLT_ENTRY(glt_take2d))
