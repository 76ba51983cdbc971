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
// the 3.35 TB/s); the table is 32 KB. At these sizes the launch, the
// table's arrival in every block and the first index read are most of
// the time, and they are latencies.
// Design:
// - Each thread first issues the loads of up to kHeld of its index units
//   (16 bytes each, or one element where idx or out is not 16-byte
//   aligned), so the index reads are in flight while the table comes.
// - Each block's table arrives by one TMA bulk copy on the block's own
//   mbarrier, armed for all its 16-byte units (expect_tx); the last n % 4
//   words come by plain loads. The card timed it faster than a fill by
//   16-byte loads through registers (PERF.md §6). The launch is a plain
//   one: on the H100 any thread-block cluster costs about 0.7 us more
//   device time a launch, more than sharing one read of a 32 KB table
//   among a cluster's blocks saves.
// - The grid is at most one wave: one block an SM (1024 threads). A
//   thread walks its units grid-stride, so every table fill serves all
//   the indices its block can take.
#include "entry.cuh"
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTableWords = 8192;
constexpr int kThreads = 1024;
constexpr int kHeld = 4;      // index units a thread loads before the table

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_phase0(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem(bar)), "r"(0u) : "memory");
  }
}

__device__ __forceinline__ int pick(const int* tab, int i, int hi) {
  return tab[min(max(i, 0), hi)];
}

__device__ __forceinline__ int4 pick(const int* tab, int4 i, int hi) {
  return make_int4(pick(tab, i.x, hi), pick(tab, i.y, hi),
                   pick(tab, i.z, hi), pick(tab, i.w, hi));
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads, 1)
take2d_kernel(const int* __restrict__ table, int n,
              const int* __restrict__ idx, int64_t m, int* __restrict__ out) {
  using Unit = typename std::conditional<kVector, int4, int>::type;
  __shared__ __align__(128) int tab[kTableWords];
  __shared__ __align__(8) uint64_t bar;
  const int n4 = n / 4;
  const int64_t units = kVector ? m / 4 : m;
  const Unit* in = reinterpret_cast<const Unit*>(idx);
  Unit* dst = reinterpret_cast<Unit*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads
                        + threadIdx.x;

  // the first index units in flight while the table comes
  Unit held[kHeld];
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int64_t q = first + k * stride;
    if (q < units) held[k] = __ldg(in + q);
  }

  // the table's 16-byte units by one bulk copy on this block's barrier,
  // its last n % 4 words by plain loads; the __syncthreads publishes
  // those words and the barrier's init before anyone waits on it
  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(16 * n4);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 ::"r"(smem(&bar)), "r"(1u) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem(&bar)), "r"(bytes) : "memory");
    if (bytes)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
          "bytes [%0], [%1], %2, [%3];"
          ::"r"(smem(tab)), "l"(table), "r"(bytes), "r"(smem(&bar))
          : "memory");
  }
  for (int t = 4 * n4 + threadIdx.x; t < n; t += kThreads)
    tab[t] = __ldg(table + t);
  __syncthreads();
  wait_phase0(&bar);

  const int last = n - 1;
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int64_t q = first + k * stride;
    if (q < units) dst[q] = pick(tab, held[k], last);
  }
  for (int64_t q = first + kHeld * stride; q < units; q += stride)
    dst[q] = pick(tab, __ldg(in + q), last);
  if (kVector) {   // the last m % 4 elements
    const int64_t e = 4 * units + first;
    if (e < m) out[e] = pick(tab, __ldg(idx + e), last);
  }
}

template <bool kVector>
int launch(const int* t, int n, const int* i, int64_t m, int* o, int device,
           void* stream) {
  const int64_t units = kVector ? (m + 3) / 4 : m;
  const int64_t want = (units - 1) / kThreads + 1;   // a unit a thread
  const int64_t wave = glt::sm_count(device);        // one block an SM
  return glt::Launch<take2d_kernel<kVector>>::run(
      dim3(static_cast<unsigned>(want < wave ? want : wave)), dim3(kThreads),
      device, stream, t, n, i, m, o);
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
  const auto* t = static_cast<const int*>(table);
  const auto* i = static_cast<const int*>(idx);
  auto* o = static_cast<int*>(out);
  return vector ? launch<true>(t, n, i, m, o, device, stream)
                : launch<false>(t, n, i, m, o, device, stream);
}

GLT_MODULE(take2d,
           GLT_LAUNCH(glt_take2d))
