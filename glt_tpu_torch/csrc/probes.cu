// probes: the rungs of the compile probe, one kernel each. Each TPU rung
// probed a construct of the TPU (VMEM, SMEM, a DMA under a semaphore, a
// scalar-prefetched grid); each kernel here computes the rung's function
// with what is fastest on this card, which is not always the construct
// that stands where the TPU's does.
//
// Replaces: benchmarks/probe_pallas_compile.py's rungs 1-5 (rung 6 is
// gather_windows.cu, rung 7 take2d.cu):
//   vmem_id       (:55, pallas_call :58)  copy a [128, 128] float32 block
//                 through VMEM          -> copy_kernel: a 16-byte unit a
//                 thread, loaded into a register and stored straight out,
//                 no staging;
//   smem_scalar   (:65, :71)  the block times a [1, 1] int32 read from
//                 SMEM                  -> scale_kernel: every thread loads
//                 its data and the scalar together, x * (float)s;
//   dma_fixed     (:83, :93)  big[256:384] by make_async_copy and a DMA
//                 semaphore             -> window_kernel<false>: every
//                 thread computes the clamped start and copies its word
//                 straight from device memory to the output;
//   dma_dynamic   (:102, :115)  the same from a start read on the device
//                                       -> window_kernel<true>: every
//                 thread reads the start (one address for the warp), then
//                 its word;
//   prefetch_grid (:125, :138)  a row gather steered by scalar-prefetched
//                 indices               -> row_copy_kernel: a warp per
//                 group of rows, the rows moved as 16-byte vectors.
//
// Bound on this card: every rung moves at most 64 KB, a few hundredths
// of a microsecond of the 3.35 TB/s, so each is bound by the launch and
// the latency of its chain of dependent reads, not by bytes or
// arithmetic: the designs keep that chain as short as the function
// allows. The row copy is also a row gather of any size, bound by bytes
// there: 153,600 random rows of 512 B from a 512 MB table read about
// 142,000 distinct rows (73 MB), write 79 MB and read 0.6 MB of indices,
// about 152 MB: 45.4 us of the 3.35 TB/s. The copy is a device copy of
// any size, bound by bytes there: 256 MiB read and 256 MiB written take
// 160.3 us.
// Design notes:
// - The copy: rung 1 probed a round trip through VMEM, the TPU's
//   software-managed memory, which every TPU kernel's data passes
//   through. Here nothing has to: staging a unit in shared memory (a
//   cp.async, its wait, a shared-memory read) puts a second latency
//   between the load and the store and reuses nothing. So each thread
//   loads its 16-byte unit into a register and stores it, and the grid
//   follows the unit count: the rung's 4,096 units are 16 blocks, the
//   scale's shape, and 256 MiB is 65,536 blocks, whose resident warps
//   keep enough loads in flight to stream at clone's rate. A grid-stride
//   loop over one wave of blocks with 4 or 8 units in flight a thread
//   (streaming hints or not) was timed 6% slower at 256 MiB and up to
//   12% slower at the rung (PERF.md §6).
// - The scale: the TPU rung puts the scalar in SMEM for the scalar unit.
//   Here a scalar read into shared memory by one thread, then a
//   __syncthreads, then the data reads, puts two memory latencies in
//   series. Every thread instead issues its 16-byte data load and an
//   __ldg of s together (one address: one transaction serves the warp),
//   so the block waits one latency. __int2float_rn and __fmul_rn keep the
//   result bit-equal to x * float32(s).
// - The window: the TPU rung is a DMA into VMEM awaited on a semaphore;
//   its counterpart here, a bulk async copy into shared memory on an
//   mbarrier, put a start, an arming, the copy's issue-to-complete
//   latency and a shared-memory pass in series, which costs more than it
//   saves for a window of at most 4 KB. Every thread instead computes
//   the start itself -- negative counts from the end, then clamped to
//   [0, n - w], as lax.dynamic_slice treats pl.ds in the TPU rung's
//   interpret mode (a TPU DMA never leaves its array either) -- and
//   copies word j of the window through a register: one read (two for
//   dma_dynamic, whose start lives on the card), coalesced, then a store.
// - The row copy: a warp takes groups of up to 32 rows; lane j reads
//   row j's index and clamps it, and the warp's lanes take the group's
//   16-byte units in turn, each lane reading its row's index from lane j
//   (__shfl_sync). A lane loads kUnitsInFlight units before it stores
//   any, so several rows' reads are in flight at once, and the rows go
//   straight from registers to the output. Up to one wave of warps share
//   the rows evenly: a row a warp for the rung's 16 rows, 36-37 for
//   153,600 rows. Rows go through registers, not by bulk copies into
//   shared memory and bulk stores out: at 512-byte rows the card timed
//   the vector copy faster (PERF.md §6).
#include "entry.cuh"
#include <cstdint>

namespace {

constexpr int kCopyThreads = 256;    // one 16-byte unit a thread
constexpr int kScaleThreads = 256;   // one 16-byte unit a thread
constexpr int kMaxWindow = 1024;     // words a window copy holds
constexpr int kMaxRowBytes = 16384;  // bytes a row copy holds
constexpr int kRowWarps = 8;         // warps a row-copy block
constexpr int kRowBlocksPerSm = 4;   // row-copy blocks an SM holds
constexpr int kUnitsInFlight = 8;    // 16-byte units a lane loads at once

__global__ void copy_kernel(const uint4* __restrict__ src,
                            uint4* __restrict__ dst, int64_t units) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kCopyThreads
                    + threadIdx.x;
  if (i < units) dst[i] = __ldg(src + i);
}

__global__ void scale_kernel(const float4* __restrict__ x,
                             const int* __restrict__ s,
                             float4* __restrict__ out, int64_t units) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kScaleThreads
                    + threadIdx.x;
  if (i >= units) return;
  const int si = __ldg(s);    // issued beside the data load, not before it
  float4 v = __ldg(x + i);
  const float scale = __int2float_rn(si);
  v.x = __fmul_rn(v.x, scale);
  v.y = __fmul_rn(v.y, scale);
  v.z = __fmul_rn(v.z, scale);
  v.w = __fmul_rn(v.w, scale);
  out[i] = v;
}

// out[j] = big[st + j] for j < w, one word a thread of one block
template <bool kDynamic>
__global__ void window_kernel(const int* __restrict__ big, int n, int start,
                              const int* __restrict__ start_on_device,
                              int w, int* __restrict__ out) {
  const int j = threadIdx.x;
  if (j >= w) return;
  int st = kDynamic ? __ldg(start_on_device) : start;
  st = st < 0 ? st + n : st;   // lax.dynamic_slice counts these from the end
  st = st < 0 ? 0 : (st > n - w ? n - w : st);
  out[j] = __ldg(big + st + j);
}

__global__ void __launch_bounds__(32 * kRowWarps, kRowBlocksPerSm)
row_copy_kernel(const uint4* __restrict__ table, int64_t n, int row_units,
                const int* __restrict__ rows, int share, int extra,
                uint4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  // this warp's rows, in groups of up to 32: share of them, one more for
  // the first `extra` warps (no 64-bit division on the card)
  const int64_t begin = static_cast<int64_t>(warp) * share
                        + (warp < extra ? warp : extra);
  const int64_t end = begin + share + (warp < extra);
  for (int64_t g0 = begin; g0 < end; g0 += 32) {
    const int here = end - g0 < 32 ? static_cast<int>(end - g0) : 32;
    int64_t r = 0;   // lane j: row j of the group, clamped
    if (lane < here) {
      r = __ldg(rows + g0 + lane);
      r = r < 0 ? 0 : (r >= n ? n - 1 : r);
    }
    // the group's units f = j * row_units + u, also their places in out
    const int total = here * row_units;
    uint4* dst = out + g0 * row_units;
    for (int f0 = 0; f0 < total; f0 += 32 * kUnitsInFlight) {
      uint4 v[kUnitsInFlight];
#pragma unroll
      for (int k = 0; k < kUnitsInFlight; ++k) {
        if (f0 + 32 * k >= total) break;   // the same for the whole warp
        const int f = f0 + 32 * k + lane;
        const int j = min(f / row_units, here - 1);
        const int64_t rj = __shfl_sync(0xffffffffu, r, j);
        if (f < total) v[k] = __ldg(table + rj * row_units + f - j * row_units);
      }
#pragma unroll
      for (int k = 0; k < kUnitsInFlight; ++k) {
        const int f = f0 + 32 * k + lane;
        if (f0 + 32 * k >= total) break;
        if (f < total) dst[f] = v[k];
      }
    }
  }
}

}  // namespace

// Each entry returns the launch's CUresult (entry.cuh), or
// CUDA_ERROR_INVALID_VALUE for a shape its kernel does not hold; the
// wrappers (ops/probe_kernels.py) check alignment and sizes first.

// dst = src, `bytes` a multiple of 16, both 16-byte aligned: a unit a
// thread.
extern "C" int glt_probe_copy(const void* src, void* dst, int64_t bytes,
                              int device, void* stream) {
  const int64_t units = bytes / 16;
  if (units <= 0) return 0;
  const int64_t blocks = (units - 1) / kCopyThreads + 1;
  if (blocks > INT32_MAX) return CUDA_ERROR_INVALID_VALUE;
  return glt::Launch<copy_kernel>::run(
      dim3(static_cast<unsigned>(blocks)), dim3(kCopyThreads), device,
      stream, static_cast<const uint4*>(src), static_cast<uint4*>(dst),
      units);
}

// out = x * (float)s[0], x of n float32 (n a multiple of 4).
extern "C" int glt_probe_scale(const void* x, const void* s, void* out,
                               int64_t n, int device, void* stream) {
  const int64_t units = n / 4;
  if (units <= 0) return 0;
  return glt::Launch<scale_kernel>::run(
      dim3(static_cast<unsigned>((units - 1) / kScaleThreads + 1)),
      dim3(kScaleThreads), device, stream, static_cast<const float4*>(x),
      static_cast<const int*>(s), static_cast<float4*>(out), units);
}

// out[j] = big[st + j], j < w, st the start (*start_on_device, else start)
// as lax.dynamic_slice takes it: + n when negative, then clamped to
// [0, n - w]; w <= 1024 words, one block of w threads rounded up to a warp.
extern "C" int glt_probe_window(const void* big, int n, int start,
                                const void* start_on_device, int w, void* out,
                                int device, void* stream) {
  if (w <= 0) return 0;
  if (w > kMaxWindow || w > n) return CUDA_ERROR_INVALID_VALUE;
  const auto* a = static_cast<const int*>(big);
  const auto* d = static_cast<const int*>(start_on_device);
  auto* o = static_cast<int*>(out);
  const dim3 threads((w + 31) / 32 * 32);
  return d ? glt::Launch<window_kernel<true>>::run(
                 dim3(1), threads, device, stream, a, n, 0, d, w, o)
           : glt::Launch<window_kernel<false>>::run(
                 dim3(1), threads, device, stream, a, n, start, d, w, o);
}

// out[b] = table[clamp(rows[b], 0, n - 1)], rows of row_bytes (a multiple
// of 16, at most 16384), table and out 16-byte aligned, b < 2^31.
extern "C" int glt_probe_row_copy(const void* table, int64_t n, int row_bytes,
                                  const void* rows, int64_t b, void* out,
                                  int device, void* stream) {
  if (b <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 16 || row_bytes > kMaxRowBytes || n <= 0
      || b > INT32_MAX || device < 0 || device >= glt::kMaxDevices)
    return CUDA_ERROR_INVALID_VALUE;
  // a warp a row, up to one wave of warps, each an even share of the rows
  const int64_t wave = static_cast<int64_t>(glt::sm_count(device))
                       * kRowBlocksPerSm * kRowWarps;
  const int64_t blocks = ((b < wave ? b : wave) - 1) / kRowWarps + 1;
  const int64_t warps = blocks * kRowWarps;
  return glt::Launch<row_copy_kernel>::run(
      dim3(static_cast<unsigned>(blocks)), dim3(32 * kRowWarps), device,
      stream, static_cast<const uint4*>(table), n, row_bytes / 16,
      static_cast<const int*>(rows), static_cast<int>(b / warps),
      static_cast<int>(b % warps), static_cast<uint4*>(out));
}

GLT_MODULE(probes,
           GLT_LAUNCH(glt_probe_copy),
           GLT_LAUNCH(glt_probe_scale),
           GLT_LAUNCH(glt_probe_window),
           GLT_LAUNCH(glt_probe_row_copy))
