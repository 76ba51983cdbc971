// probes: the rungs of the compile probe, one kernel each, every one
// built on the Hopper construct that stands where its TPU rung's does.
//
// Replaces: benchmarks/probe_pallas_compile.py's rungs 1-5 (rung 6 is
// gather_windows.cu, rung 7 take2d.cu):
//   vmem_id       (:55, pallas_call :58)  copy a [128, 128] float32 block
//                 through VMEM          -> stage_copy_kernel: cp.async
//                 16-byte copies into shared memory, then stored out;
//   smem_scalar   (:65, :71)  the block times a [1, 1] int32 read from
//                 SMEM                  -> scale_kernel: the scalar read
//                 once per block into shared memory, then x * (float)s;
//   dma_fixed     (:83, :93)  big[256:384] by make_async_copy and a DMA
//                 semaphore             -> window_kernel<false>: one 1-D
//                 bulk async copy (cp.async.bulk ... complete_tx) into
//                 shared memory, completed on an mbarrier (arrive.expect_tx,
//                 try_wait.parity), then stored out;
//   dma_dynamic   (:102, :115)  the same from a start read on the device
//                                       -> window_kernel<true>: the start
//                 read from device memory, the same bulk copy;
//   prefetch_grid (:125, :138)  a row gather steered by scalar-prefetched
//                 indices               -> row_copy_kernel: one block per
//                 output row reads its index and bulk-copies that row
//                 through shared memory.
//
// Bound on this card: every rung moves at most 64 KB, a few hundredths
// of a microsecond of the 3.35 TB/s, so each is bound by the launch and
// the latency of one dependent read chain, not by bytes or arithmetic.
// Design notes:
// - A bulk copy moves whole 16-byte units between 16-byte-aligned
//   addresses. The window kernel copies the 16-byte-aligned cover of
//   [st, st + w) (at most 3 words more on each side; the wrapper asks for
//   a 16-byte-aligned array whose length is a multiple of 4 words, so the
//   cover stays inside it) and selects the w words from shared memory,
//   as gather_windows.cu realigns its windows. A negative start counts
//   from the end and the start is then clamped to [0, n - w], as
//   lax.dynamic_slice treats pl.ds in the TPU rung's interpret mode (a
//   TPU DMA never leaves its array either).
// - One thread arms the mbarrier and issues the copy; a __syncthreads
//   publishes the barrier's init, and every thread waits on phase 0.
#include "entry.cuh"
#include <cstdint>

namespace {

constexpr int kStageThreads = 256;   // one 16-byte unit a thread
constexpr int kMaxWindow = 1024;     // words a window copy holds
constexpr int kMaxRowBytes = 16384;  // bytes a row copy holds

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier expecting one arrival (the arming thread's expect_tx),
// then `bytes` of the bulk copy issued against it.
__device__ __forceinline__ void bulk_copy_armed(void* dst, const void* src,
                                                uint32_t bytes,
                                                uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               ::"r"(smem(bar)), "r"(1u) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar)) : "memory");
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

__global__ void stage_copy_kernel(const uint4* __restrict__ src,
                                  uint4* __restrict__ dst, int64_t units) {
  __shared__ uint4 tile[kStageThreads];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kStageThreads
                    + threadIdx.x;
  if (i >= units) return;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"(smem(tile + threadIdx.x)), "l"(src + i) : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_all;" ::: "memory");
  dst[i] = tile[threadIdx.x];   // each thread stores the unit it staged
}

__global__ void scale_kernel(const float4* __restrict__ x,
                             const int* __restrict__ s,
                             float4* __restrict__ out, int64_t units) {
  __shared__ float scale;
  if (threadIdx.x == 0) scale = __int2float_rn(*s);
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= units) return;
  float4 v = x[i];
  v.x = __fmul_rn(v.x, scale);
  v.y = __fmul_rn(v.y, scale);
  v.z = __fmul_rn(v.z, scale);
  v.w = __fmul_rn(v.w, scale);
  out[i] = v;
}

template <bool kDynamic>
__global__ void window_kernel(const int* __restrict__ big, int n, int start,
                              const int* __restrict__ start_on_device,
                              int w, int* __restrict__ out) {
  __shared__ __align__(16) int buf[kMaxWindow + 8];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int shift;
  if (threadIdx.x == 0) {
    int st = kDynamic ? *start_on_device : start;
    st = st < 0 ? st + n : st;   // lax.dynamic_slice counts these from the end
    st = st < 0 ? 0 : (st > n - w ? n - w : st);
    const int lo = st & ~3;
    const int hi = min((st + w + 3) & ~3, n);
    shift = st - lo;
    bulk_copy_armed(buf, big + lo, static_cast<uint32_t>(hi - lo) * 4, &bar);
  }
  __syncthreads();
  wait_phase0(&bar);
  for (int j = threadIdx.x; j < w; j += blockDim.x) out[j] = buf[shift + j];
}

__global__ void row_copy_kernel(const unsigned char* __restrict__ table,
                                int64_t n, int row_bytes,
                                const int* __restrict__ rows,
                                unsigned char* __restrict__ out) {
  __shared__ __align__(16) unsigned char buf[kMaxRowBytes];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) {
    int64_t r = rows[blockIdx.x];
    r = r < 0 ? 0 : (r >= n ? n - 1 : r);
    bulk_copy_armed(buf, table + r * row_bytes,
                    static_cast<uint32_t>(row_bytes), &bar);
  }
  __syncthreads();
  wait_phase0(&bar);
  uint4* dst = reinterpret_cast<uint4*>(
      out + static_cast<int64_t>(blockIdx.x) * row_bytes);
  for (int u = threadIdx.x; u < row_bytes / 16; u += blockDim.x)
    dst[u] = reinterpret_cast<const uint4*>(buf)[u];
}

}  // namespace

// Each entry returns the launch's CUresult (entry.cuh), or
// CUDA_ERROR_INVALID_VALUE for a shape its kernel does not hold; the
// wrappers (ops/probe_kernels.py) check alignment and sizes first.

// dst = src, `bytes` a multiple of 16, both 16-byte aligned.
extern "C" int glt_probe_stage_copy(const void* src, void* dst, int64_t bytes,
                                    int device, void* stream) {
  const int64_t units = bytes / 16;
  if (units <= 0) return 0;
  return glt::Launch<stage_copy_kernel>::run(
      dim3(static_cast<unsigned>((units - 1) / kStageThreads + 1)),
      dim3(kStageThreads), device, stream, static_cast<const uint4*>(src),
      static_cast<uint4*>(dst), units);
}

// out = x * (float)s[0], x of n float32 (n a multiple of 4).
extern "C" int glt_probe_scale(const void* x, const void* s, void* out,
                               int64_t n, int device, void* stream) {
  const int64_t units = n / 4;
  if (units <= 0) return 0;
  const int threads = 256;
  return glt::Launch<scale_kernel>::run(
      dim3(static_cast<unsigned>((units - 1) / threads + 1)), dim3(threads),
      device, stream, static_cast<const float4*>(x),
      static_cast<const int*>(s), static_cast<float4*>(out), units);
}

// out[j] = big[st + j], j < w, st the start (*start_on_device, else start)
// as lax.dynamic_slice takes it: + n when negative, then clamped to
// [0, n - w]; big 16-byte aligned, n a multiple of 4, w <= 1024.
extern "C" int glt_probe_window(const void* big, int n, int start,
                                const void* start_on_device, int w, void* out,
                                int device, void* stream) {
  if (w <= 0) return 0;
  if (w > kMaxWindow || w > n || n % 4) return CUDA_ERROR_INVALID_VALUE;
  const auto* a = static_cast<const int*>(big);
  const auto* d = static_cast<const int*>(start_on_device);
  auto* o = static_cast<int*>(out);
  return d ? glt::Launch<window_kernel<true>>::run(
                 dim3(1), dim3(128), device, stream, a, n, 0, d, w, o)
           : glt::Launch<window_kernel<false>>::run(
                 dim3(1), dim3(128), device, stream, a, n, start, d, w, o);
}

// out[b] = table[clamp(rows[b], 0, n - 1)], rows of row_bytes (a multiple
// of 16, at most 16384), table 16-byte aligned.
extern "C" int glt_probe_row_copy(const void* table, int64_t n, int row_bytes,
                                  const void* rows, int b, void* out,
                                  int device, void* stream) {
  if (b <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 16 || row_bytes > kMaxRowBytes || n <= 0)
    return CUDA_ERROR_INVALID_VALUE;
  return glt::Launch<row_copy_kernel>::run(
      dim3(b), dim3(32), device, stream,
      static_cast<const unsigned char*>(table), n, row_bytes,
      static_cast<const int*>(rows), static_cast<unsigned char*>(out));
}

GLT_MODULE(probes,
           GLT_ENTRY(glt_probe_stage_copy),
           GLT_ENTRY(glt_probe_scale),
           GLT_ENTRY(glt_probe_window),
           GLT_ENTRY(glt_probe_row_copy))
