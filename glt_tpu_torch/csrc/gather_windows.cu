// gather_windows: the contiguous window read of the weighted and the
// full-neighbourhood hops --
// out[i, j] = arr[clip(starts[i] + j, 0, len - 1)] for j < width, over
// 4-byte elements (float32 edge weights or int32 neighbour ids).
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
// per weighted batch, 22.9 us at the data sheet's 3.35 TB/s; hop 3,
// [153600, 56], is 68.8 MB of it (20.7 us). Hops 1 and 2 are 0.5 and 6.9
// MB: their device work is a few microseconds, below the host's enqueue.
// Random windows of 224 B at 4-byte alignment touch about 1.25x their
// bytes in 64-byte DRAM segments, so the bound is not reachable.
//
// The first design ran one thread per output element, found its row by a
// 64-bit division by the width and moved 4 bytes each way: a warp's load
// split over two or three windows at random 4-byte alignments. 0.0503 ms
// at hop 3 on an H100 at 700 W, 41% of its bound (PERF.md). This one takes
// about 0.030 ms there, two thirds of the bound.
//
// Design: 16-byte vectors both ways, 32-bit lane math, no division.
// - A row's window [start, start + width) lies inside the 16-byte-aligned
//   cover of its absolute address (arr's base need not be 16-byte aligned:
//   the stream snapshot's arrays are views, the overlays other
//   allocations). A segment of T threads (the power of two above width / 4,
//   at most 32) loads the cover, one vector a thread; each thread takes
//   the next vector from its neighbour by warp shuffle and selects the
//   four words at the row's shift (start's element offset in its vector),
//   then stores one 16-byte vector of the output row, which is 16-byte
//   aligned when width % 4 == 0 (56 on the products graph, 8 for the
//   stream's overlay windows). Wider windows (a hub's -1 window) take
//   several passes of T - 1 vectors.
// - A warp holds 32 / T rows a step and takes kSteps steps, all its loads
//   issued before its stores, so each thread keeps kSteps loads in flight.
// - Rows whose cover would reach before arr[0] or past arr[len - 1] (the
//   only rows that need the clip, and the rows at the array's two ends)
//   take the element path inside the same kernel. Widths that are not a
//   multiple of 4, and an arr whose base is not 4-byte aligned, take the
//   element kernel: one thread per element of a 2-D block (x over the
//   row's lanes, y over rows), as sample_hop maps its lanes.
// - Hops 1-2 of a weighted batch move 0.5 and 6.9 MB: their time is the
//   host's enqueue, as for sample_hop (entry.cuh).
// - Staging a tile of rows in shared memory (cp.async 16-byte .cg, or one
//   TMA 1-D bulk copy a row with an mbarrier; a ring of four tiles a
//   block) took 0.0325-0.0332 ms at hop 3 against this kernel's 0.0307-
//   0.0309: no data is reused, so staging adds a pass and buys nothing.
//   One step a warp instead of kSteps was level (0.0310-0.0311 ms), so
//   neither was kept (PERF.md, on an H100 at 700 W).
//
// The TPU kernel issues one DMA descriptor per row and clamps each start
// to [0, len - width], which is exact only over an array padded by width
// sentinels (Graph.window_arrays keeps that padded copy). Here a row reads
// its own window, clipped per element where it must be, as the XLA
// slice-gather does: no padded copy. Lanes past a row's degree read the
// following rows' elements (or the last one); every caller masks them.
#include "entry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 4;    // row steps a warp loads before it stores

__device__ __forceinline__ int64_t clip_slot(int64_t slot, int64_t len) {
  return slot < 0 ? 0 : (slot >= len ? len - 1 : slot);
}

template <bool kAligned>
__device__ __forceinline__ uint32_t load_elem(const unsigned char* arr,
                                              int64_t slot) {
  const unsigned char* p = arr + 4 * slot;
  if (kAligned) return __ldg(reinterpret_cast<const uint32_t*>(p));
  return static_cast<uint32_t>(__ldg(p))
         | static_cast<uint32_t>(__ldg(p + 1)) << 8
         | static_cast<uint32_t>(__ldg(p + 2)) << 16
         | static_cast<uint32_t>(__ldg(p + 3)) << 24;
}

// A row's 16-byte-aligned cover and whether the vector path may read it.
struct Cover {
  const uint4* first;   // the cover's first vector
  int shift;            // start's element offset inside it (0-3)
  int vecs;             // vectors in the cover: width / 4, +1 if shift
  bool ok;              // inside [arr[0], arr[len - 1]], no clip needed
};

__device__ __forceinline__ Cover cover_of(const unsigned char* arr,
                                          int64_t len, int64_t start,
                                          int width) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(arr);
  const uintptr_t a = base + 4 * static_cast<uintptr_t>(start);
  const uintptr_t lo = a & ~static_cast<uintptr_t>(15);
  const uintptr_t hi = (a + 4 * static_cast<uintptr_t>(width) + 15)
                       & ~static_cast<uintptr_t>(15);
  Cover c;
  c.first = reinterpret_cast<const uint4*>(lo);
  c.shift = static_cast<int>((a >> 2) & 3);
  c.vecs = static_cast<int>((hi - lo) >> 4);
  c.ok = start >= 0 && lo >= base
         && hi <= base + 4 * static_cast<uintptr_t>(len);
  return c;
}

// Words [shift, shift + 4) of the eight words lo, hi.
__device__ __forceinline__ uint4 realign(uint4 lo, uint4 hi, int shift) {
  const bool two = shift & 2;
  const uint32_t a = two ? lo.z : lo.x, b = two ? lo.w : lo.y;
  const uint32_t c = two ? hi.x : lo.z, d = two ? hi.y : lo.w;
  const uint32_t e = two ? hi.z : hi.x;
  return (shift & 1) ? make_uint4(b, c, d, e) : make_uint4(a, b, c, d);
}

__device__ __forceinline__ void copy_elems(const unsigned char* arr,
                                           int64_t len, int64_t start,
                                           int width, int first, int step,
                                           uint32_t* dst) {
  for (int j = first; j < width; j += step)
    dst[j] = load_elem<true>(arr, clip_slot(start + j, len));
}

// -- element kernel: widths % 4 != 0, or arr not 4-byte aligned ------------
// blockDim (wx, ry): wx = min(width, 256) lanes of a row, ry = 256 / wx rows
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
windows_elem(const unsigned char* __restrict__ arr, int64_t len,
             const int* __restrict__ starts, int s, int width,
             uint32_t* __restrict__ out) {
  const unsigned row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= static_cast<unsigned>(s)) return;
  const int64_t start = starts[row];
  uint32_t* dst = out + static_cast<int>(row) * width;
  for (int j = threadIdx.x; j < width; j += blockDim.x)
    dst[j] = load_elem<kAligned>(arr, clip_slot(start + j, len));
}

// -- vector kernel: warp shuffles --------------------------------------------
// T threads a row (a power of two, width / 4 + 1 <= T or T = 32); a warp
// takes rows [warp * 32 / T * kSteps, +32 / T * kSteps), kSteps steps of
// 32 / T
template <int T>
__global__ void __launch_bounds__(kThreads)
windows_shuffle(const unsigned char* __restrict__ arr, int64_t len,
                const int* __restrict__ starts, int s, int width,
                uint32_t* __restrict__ out) {
  constexpr int kSegs = 32 / T;
  const int lane = threadIdx.x & 31;
  const int t = lane & (T - 1);
  const unsigned warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int nvec = width >> 2;
  const int passes = (nvec + T - 2) / (T - 1);   // T - 1 vectors a pass
  unsigned row[kSteps];
  Cover cov[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    row[u] = (warp * kSteps + u) * kSegs + lane / T;
    const bool live = row[u] < static_cast<unsigned>(s);
    cov[u] = cover_of(arr, len, live ? starts[row[u]] : 0, width);
    cov[u].ok &= live;
  }
  // every lane runs every pass and shuffle: rows past s and rows of the
  // element path load nothing and store nothing
  for (int p = 0; p < passes; ++p) {
    const int v = p * (T - 1) + t;
    uint4 lo[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      lo[u] = make_uint4(0, 0, 0, 0);
      if (cov[u].ok && v < cov[u].vecs) lo[u] = __ldg(cov[u].first + v);
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      uint4 hi;
      hi.x = __shfl_down_sync(0xffffffffu, lo[u].x, 1, T);
      hi.y = __shfl_down_sync(0xffffffffu, lo[u].y, 1, T);
      hi.z = __shfl_down_sync(0xffffffffu, lo[u].z, 1, T);
      hi.w = __shfl_down_sync(0xffffffffu, lo[u].w, 1, T);
      if (cov[u].ok && t < T - 1 && v < nvec)
        reinterpret_cast<uint4*>(out + static_cast<int>(row[u]) * width)[v] =
            realign(lo[u], hi, cov[u].shift);
    }
  }
#pragma unroll
  for (int u = 0; u < kSteps; ++u)
    if (row[u] < static_cast<unsigned>(s) && !cov[u].ok)
      copy_elems(arr, len, starts[row[u]], width, t, T,
                 out + static_cast<int>(row[u]) * width);
}

using Args = std::tuple<const unsigned char*, int64_t, const int*, int, int,
                        uint32_t*>;

template <auto Kernel>
int launch(dim3 grid, dim3 block, int device, void* stream,
           const Args& a) {
  return std::apply([&](auto... v) {
    return glt::Launch<Kernel>::run(grid, block, device, stream, v...);
  }, a);
}

template <int T>
int launch_vector(int device, void* stream, const Args& a) {
  const int s = std::get<3>(a);
  const int rows_per_block = (kThreads / T) * kSteps;
  return launch<windows_shuffle<T>>(
      dim3((s - 1) / rows_per_block + 1), dim3(kThreads), device, stream,
      a);
}

}  // namespace

// Widths that are not a multiple of 4, or an arr or out not aligned for
// vectors, take the element kernel. Returns the launch's CUresult
// (entry.cuh), 0 when it was enqueued.
extern "C" int glt_gather_windows(const void* arr, int64_t len,
                                  const void* starts, int s, int width,
                                  void* out, int device, void* stream) {
  if (s <= 0 || width <= 0) return 0;
  const Args a{static_cast<const unsigned char*>(arr), len,
               static_cast<const int*>(starts), s, width,
               static_cast<uint32_t*>(out)};
  const uintptr_t base = reinterpret_cast<uintptr_t>(arr);
  if (width % 4 || base % 4 || reinterpret_cast<uintptr_t>(out) % 16) {
    const int wx = width < kThreads ? width : kThreads;
    const int ry = kThreads / wx;
    const dim3 blocks((s - 1) / ry + 1), block(wx, ry);
    return base % 4
               ? launch<windows_elem<false>>(blocks, block, device, stream, a)
               : launch<windows_elem<true>>(blocks, block, device, stream, a);
  }
  const int need = width / 4 + 1;
  if (need <= 2) return launch_vector<2>(device, stream, a);
  if (need <= 4) return launch_vector<4>(device, stream, a);
  if (need <= 8) return launch_vector<8>(device, stream, a);
  if (need <= 16) return launch_vector<16>(device, stream, a);
  return launch_vector<32>(device, stream, a);
}

GLT_MODULE(gather_windows,
           GLT_LAUNCH(glt_gather_windows))
