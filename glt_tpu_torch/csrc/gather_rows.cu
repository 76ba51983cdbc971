// gather_rows: out[i] = table[clamp(rows[i], 0, N-1)]; and over a split
// store, out[i] = r < H ? hot[r] : cold[r - H], r = clamp(rows[i], 0,
// H + C - 1), hot the [H, D] device block, cold the [C, D] block in
// pinned host memory, read through its mapped device address.
//
// Replaces: glt_tpu/ops/pallas_kernels.py gather_rows (:236), the
// row_gather seam of Feature.device_gather. The TPU kernel pays one grid
// step per row; this is a design for the card, not a step-by-step copy.
// The split store's read replaces _mixed_gather (glt_tpu/data/
// feature.py:36), which has no Pallas source: XLA stages its cold rows
// through compute_on('device_host') and merges them with a second
// device gather. Here both blocks are read in the same launch.
//
// Bound on this card: bytes. Each distinct table row is read once, each
// output row written once, each 4-byte index read once, over the 3.35
// TB/s of device memory: bucket 256's node list on the products table is
// 234,496 rows, 206,655 distinct (its -1 pad lanes all read row 0), 0.0530
// ms at 100 float32 and 0.0266 ms at 100 bf16; an igbh-rgat request's
// 656,896 paper rows, 172,355 distinct, 1.0147 ms at 1024 float32.
//
// The first design gave a warp to each row and its 32 lanes one unit each
// of the widest size, 16, 4, 2 or 1 bytes, that divided the row and the
// table's address, with one row in flight. On an H100 80GB HBM3 at 700 W
// (PERF.md) it took 0.0922 ms at float32 x 100 (ahead of index_select's
// 0.1446; 57% of the bound), but 0.0848 ms at bf16 x 101 and 0.0246 ms at
// uint8 x 7, behind index_select (0.0784, 0.0146): a 7-byte row tied up a
// warp in which 7 lanes moved a byte each, and a 200-byte bf16 row copied
// in 4-byte words.
//
// Design: a row is a byte window [r * row_bytes, (r + 1) * row_bytes) of
// the table, copied as 16-byte vectors, as gather_windows.cu copies its
// windows, at every row width and base address. The layout is picked on
// the host by ops/cuda_kernels.py's gather_rows_layout from the row size
// and the table's address; one launch, no host sync.
// - Segments. A segment of T threads (a power of two, at most 32) takes a
//   row, each thread one aligned vector of the row's 16-byte cover
//   (vectors that hold none of its bytes load nothing). A warp takes 32 /
//   T rows at a time. Rows of one pass: a segment takes two rows, their
//   loads issued before their stores; wider rows: a segment to a row and
//   the loads of kWideUnroll passes before their stores. So each lane
//   keeps two to eight random loads in flight (the first design one at
//   100-float rows).
// - Realignment. Output row i starts at i * row_bytes of a fresh, 16-byte
//   aligned allocation, so a row's source bytes are shifted by
//   d = (address - i * row_bytes) mod 16 against the output's vectors.
//   Output vector j of the row is bytes [d, d + 16) of the thread's vector
//   and its neighbour's (a warp shuffle), selected by word and funnel-
//   shifted by byte (realign). When the row size and the table's address
//   are both multiples of 16, d is 0 for every row and the copy mode loads
//   and stores with no shuffle.
// - Writes. A vector inside the row is one 16-byte store; the row's first
//   and last vectors, which it may share with its neighbours, take byte-
//   exact stores of naturally aligned pieces of 8, 4, 2 and 1 bytes.
// - Edges. A row whose cover would reach before the table's first byte or
//   past its last (the first and last rows of a table at an unaligned
//   address or size) is copied byte by byte, in the same kernel.
// - Two blocks (glt_gather_rows_mixed). A row's block follows from its
//   clamped index, and with it its base address, its realignment shift
//   d and the edges test: a row whose cover would leave its own block is
//   copied byte by byte. The layout realigns unless the row size and both
//   blocks' addresses are multiples of 16. A cold row crosses the host
//   link as its cover's 16-byte loads, a warp's neighbouring lanes on
//   neighbouring addresses of one row. H = 0 (all cold) and C = 0 (all
//   hot) launch the one-block kernel over the other block, so a store
//   with nothing spilled runs K3 as before. Bound of a split read: the
//   larger of two times, since one launch drives both channels at once:
//   device memory's (the hot distinct rows, the indices and the output
//   over 3.35 TB/s) and the host link's (the cold distinct rows over
//   PCIe Gen5 x16's 64 GB/s one way). chip_smoke.py prints the rate of a
//   bulk copy from the pinned block beside it.
// - Pinning. glt_host_register page-locks a CPU buffer in place at its
//   exact size (cudaHostRegister with cudaHostRegisterMapped, which is
//   cuMemHostRegister with DEVICEMAP) and returns its mapped device
//   address (cudaHostGetDevicePointer), or the error. It is not
//   torch.empty(pin_memory=True): PyTorch's caching host allocator
//   rounds a block up to a power of two, so a 784 MB cold block would pin
//   1 GiB, and its pointer would still need mapping.
// Tried on an H100 80GB HBM3 at 700 W and not kept (PERF.md): staging a
// warp's rows in shared memory to store their span as whole vectors
// (the byte-exact stores beat it at every size it served), four rows a
// segment (registers, and so resident warps) and streaming stores (no
// change). A second kernel for 3-15-byte rows, a thread an output
// vector built from the rows that overlap it, beat index_select inside
// a CUDA graph (uint8 x 7 0.0059 against 0.0068 ms) where the segments
// lose (0.0108 against 0.0068), and was level back to back; no served
// configuration has such rows, so they take the segments.
#include "entry.cuh"
#include <cstdint>
#include <tuple>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// passes of a wide row whose loads a lane issues before their stores
constexpr int kWideUnroll = 8;

// Bytes [d, d + 16) of the 32 bytes lo, hi (little-endian).
__device__ __forceinline__ uint4 realign(uint4 lo, uint4 hi, int d) {
  const bool two = d & 8, one = d & 4;
  const uint32_t w0 = two ? lo.z : lo.x, w1 = two ? lo.w : lo.y;
  const uint32_t w2 = two ? hi.x : lo.z, w3 = two ? hi.y : lo.w;
  const uint32_t w4 = two ? hi.z : hi.x, w5 = two ? hi.w : hi.y;
  const uint32_t a = one ? w1 : w0, b = one ? w2 : w1, c = one ? w3 : w2;
  const uint32_t e = one ? w4 : w3, f = one ? w5 : w4;
  const unsigned s = (d & 3) * 8;
  return make_uint4(__funnelshift_r(a, b, s), __funnelshift_r(b, c, s),
                    __funnelshift_r(c, e, s), __funnelshift_r(e, f, s));
}

// Bytes [lo, hi) of `v` into the 16-byte-aligned vector at `p`, as
// naturally aligned pieces of 8, 4, 2 and 1 bytes.
__device__ __forceinline__ void store_bytes(unsigned char* p, uint4 v,
                                            int lo, int hi) {
  const uint64_t h0 = v.x | static_cast<uint64_t>(v.y) << 32;
  const uint64_t h1 = v.z | static_cast<uint64_t>(v.w) << 32;
  for (int q = lo; q < hi;) {
    const uint64_t x = (q < 8 ? h0 : h1) >> (8 * (q & 7));
    if (!(q & 7) && q + 8 <= hi) {
      *reinterpret_cast<uint64_t*>(p + q) = x;
      q += 8;
    } else if (!(q & 3) && q + 4 <= hi) {
      *reinterpret_cast<uint32_t*>(p + q) = static_cast<uint32_t>(x);
      q += 4;
    } else if (!(q & 1) && q + 2 <= hi) {
      *reinterpret_cast<uint16_t*>(p + q) = static_cast<uint16_t>(x);
      q += 2;
    } else {
      p[q] = static_cast<unsigned char>(x);
      q += 1;
    }
  }
}

// One row of a step: where its bytes come from and go.
struct Row {
  uintptr_t q0;     // the source vector (absolute index) of output vector 0
  int64_t ob;       // the row's first byte in the output
  int jlo, jhi;     // output vectors j whose source vector q0 + j lies in
                    // the row's cover (jlo 0 or 1)
  int n;            // output vectors the row touches
  int oh;           // its offset in its first output vector
  int tail;         // bytes of its last output vector (1-16)
  int d;            // source shift against the output's vectors
  bool live;        // a row of the launch
  bool ok;          // its cover lies inside the table: the vector path
};

// The rows' bytes: [hot, hot_end) holds rows [0, h); with kTwo,
// [cold, cold_end) holds rows [h, n_rows), else h == n_rows.
struct Blocks {
  uintptr_t hot, hot_end, cold, cold_end;
  int64_t h;
};

template <bool kRealign, bool kTwo>
__device__ __forceinline__ Row plan_row(const Blocks& bk, int64_t n_rows,
                                        int64_t rb,
                                        const int* __restrict__ rows,
                                        unsigned i, unsigned b) {
  Row w;
  w.live = i < b;
  int64_t r = w.live ? __ldg(rows + i) : 0;
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  uintptr_t base = bk.hot, end = bk.hot_end;
  if (kTwo && r >= bk.h) {
    base = bk.cold;
    end = bk.cold_end;
    r -= bk.h;
  }
  const uintptr_t src = base + static_cast<uintptr_t>(r * rb);
  w.ob = static_cast<int64_t>(i) * rb;
  w.oh = kRealign ? static_cast<int>(w.ob & 15) : 0;
  const uintptr_t c0 = src >> 4, c1 = (src + rb - 1) >> 4;
  w.q0 = (src - w.oh) >> 4;
  w.jlo = static_cast<int>(c0 - w.q0);
  w.jhi = static_cast<int>(c1 - w.q0);
  w.d = kRealign ? static_cast<int>((src - w.oh) & 15) : 0;
  w.n = static_cast<int>((w.oh + rb - 1) >> 4) + 1;
  w.tail = kRealign ? static_cast<int>((w.oh + rb - 1) & 15) + 1 : 16;
  w.ok = w.live && (c0 << 4) >= base && ((c1 + 1) << 4) <= end;
  return w;
}

// T threads a row (a power of two); a segment takes kRows rows and issues
// the loads of kUnroll passes of each before their stores. kRealign: rows
// shift against the output's vectors (T - 1 vectors a pass, the T-th lane
// loads the last one's neighbour), else T vectors a pass with no shuffle.
// kTwo: rows [bk.h, n_rows) live in the cold block; `table` is the
// first block's pointer.
template <int T, int kRows, int kUnroll, bool kRealign, bool kTwo>
__device__ __forceinline__ void gather_rows_body(
    const unsigned char* __restrict__ table, const Blocks& bk,
    int64_t n_rows, int64_t rb, const int* __restrict__ rows, int b,
    unsigned char* __restrict__ out, int passes) {
  constexpr int kSegs = 32 / T;
  constexpr int kPer = kRealign ? T - 1 : T;   // output vectors a pass
  const int lane = threadIdx.x & 31;
  const int t = lane & (T - 1);
  const unsigned warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const unsigned row0 = warp * (kRows * kSegs);

  Row w[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u)
    w[u] = plan_row<kRealign, kTwo>(bk, n_rows, rb, rows,
                                    row0 + u * kSegs + lane / T,
                                    static_cast<unsigned>(b));
  // every lane runs every pass and shuffle: rows past b and rows of the
  // byte path load nothing and store nothing
  for (int p0 = 0; p0 < passes; p0 += kUnroll) {
    uint4 v[kRows][kUnroll];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int j = (p0 + q) * kPer + t;
        v[u][q] = make_uint4(0, 0, 0, 0);
        if (w[u].ok && p0 + q < passes && j >= w[u].jlo && j <= w[u].jhi)
          v[u][q] = __ldg(reinterpret_cast<const uint4*>((w[u].q0 + j)
                                                         << 4));
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int j = (p0 + q) * kPer + t;
        uint4 x = v[u][q];
        if (kRealign) {
          uint4 hi;
          hi.x = __shfl_down_sync(0xffffffffu, x.x, 1, T);
          hi.y = __shfl_down_sync(0xffffffffu, x.y, 1, T);
          hi.z = __shfl_down_sync(0xffffffffu, x.z, 1, T);
          hi.w = __shfl_down_sync(0xffffffffu, x.w, 1, T);
          x = realign(x, hi, w[u].d);
        }
        if (w[u].ok && t < kPer && j < w[u].n) {
          const int lo_b = j == 0 ? w[u].oh : 0;
          const int hi_b = j == w[u].n - 1 ? w[u].tail : 16;
          unsigned char* dst = out + (((w[u].ob >> 4) + j) << 4);
          if (lo_b == 0 && hi_b == 16)
            *reinterpret_cast<uint4*>(dst) = x;
          else
            store_bytes(dst, x, lo_b, hi_b);
        }
      }
    }
  }
  // rows whose cover leaves the table: byte by byte
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    if (!w[u].live || w[u].ok) continue;
    // the row's first byte: source vector q0's byte d, then oh bytes on
    // (one table: through the kernel's restrict pointer; an address cast
    // here compiled the kernel to more registers and a slower gather of a
    // link batch on an H100 80GB HBM3 at 700 W, PERF.md)
    const uintptr_t first = (w[u].q0 << 4) + w[u].d + w[u].oh;
    const unsigned char* src = kTwo
        ? reinterpret_cast<const unsigned char*>(first)
        : table + (first - bk.hot);
    for (int64_t k = t; k < rb; k += T) out[w[u].ob + k] = __ldg(src + k);
  }
}

// One table: rows [0, n_rows) at `table`.
template <int T, int kRows, int kUnroll, bool kRealign>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const unsigned char* __restrict__ table, int64_t n_rows,
                   int64_t rb, const int* __restrict__ rows, int b,
                   unsigned char* __restrict__ out, int passes) {
  Blocks bk;
  bk.h = n_rows;
  bk.hot = reinterpret_cast<uintptr_t>(table);
  bk.hot_end = bk.hot + static_cast<uintptr_t>(n_rows * rb);
  bk.cold = bk.cold_end = 0;
  gather_rows_body<T, kRows, kUnroll, kRealign, false>(table, bk, n_rows, rb,
                                                       rows, b, out, passes);
}

// A split store: rows [0, h) at `hot`, rows [h, n_rows) at `cold`.
template <int T, int kRows, int kUnroll, bool kRealign>
__global__ void __launch_bounds__(kThreads)
gather_rows_mixed_kernel(const unsigned char* __restrict__ hot, int64_t h,
                         const unsigned char* __restrict__ cold,
                         int64_t n_rows, int64_t rb,
                         const int* __restrict__ rows, int b,
                         unsigned char* __restrict__ out, int passes) {
  Blocks bk;
  bk.h = h;
  bk.hot = reinterpret_cast<uintptr_t>(hot);
  bk.hot_end = bk.hot + static_cast<uintptr_t>(h * rb);
  bk.cold = reinterpret_cast<uintptr_t>(cold);
  bk.cold_end = bk.cold + static_cast<uintptr_t>((n_rows - h) * rb);
  gather_rows_body<T, kRows, kUnroll, kRealign, true>(hot, bk, n_rows, rb,
                                                      rows, b, out, passes);
}

// the kernels' arguments: one table's, a split store's
using Args = std::tuple<const unsigned char*, int64_t, int64_t, const int*,
                        int, unsigned char*, int>;
using MixedArgs = std::tuple<const unsigned char*, int64_t,
                             const unsigned char*, int64_t, int64_t,
                             const int*, int, unsigned char*, int>;

template <int T, int kRows, int kUnroll, bool kRealign, typename A>
int launch(int device, void* stream, const A& a) {
  const int b = std::get<std::tuple_size_v<A> - 3>(a);
  const dim3 grid((b - 1) / (kWarps * kRows * (32 / T)) + 1);
  return std::apply([&](auto... v) {
    if constexpr (std::is_same_v<A, MixedArgs>)
      return glt::Launch<gather_rows_mixed_kernel<T, kRows, kUnroll,
                                                  kRealign>>::run(
          grid, dim3(kThreads), device, stream, v...);
    else
      return glt::Launch<gather_rows_kernel<T, kRows, kUnroll, kRealign>>::
          run(grid, dim3(kThreads), device, stream, v...);
  }, a);
}

template <int T, int kRows, int kUnroll, typename A>
int launch_mode(bool realign, int device, void* stream, const A& a) {
  if (!realign) return launch<T, kRows, kUnroll, false>(device, stream, a);
  if constexpr (T > 1)
    return launch<T, kRows, kUnroll, true>(device, stream, a);
  return CUDA_ERROR_INVALID_VALUE;   // a realigning row needs a neighbour
}

// rows of one pass: T of any size, two rows a segment; wider rows: T =
// 32, one row a segment, kWideUnroll passes in flight
template <typename A>
int launch_layout(int lanes, bool realign, int passes, int device,
                  void* stream, const A& a) {
  if (passes > 1) {
    if (lanes == 32)
      return launch_mode<32, 1, kWideUnroll>(realign, device, stream, a);
    return CUDA_ERROR_INVALID_VALUE;
  }
  switch (lanes) {
    case 1: return launch_mode<1, 2, 1>(realign, device, stream, a);
    case 2: return launch_mode<2, 2, 1>(realign, device, stream, a);
    case 4: return launch_mode<4, 2, 1>(realign, device, stream, a);
    case 8: return launch_mode<8, 2, 1>(realign, device, stream, a);
    case 16: return launch_mode<16, 2, 1>(realign, device, stream, a);
    case 32: return launch_mode<32, 2, 1>(realign, device, stream, a);
    default: return CUDA_ERROR_INVALID_VALUE;
  }
}

bool bad_layout(int64_t row_bytes, int passes, const void* out, bool realign,
                uintptr_t addresses) {
  return row_bytes <= 0 || passes <= 0
         || reinterpret_cast<uintptr_t>(out) % 16
         || (!realign && (row_bytes % 16 || addresses % 16));
}

}  // namespace

// row_bytes = D * itemsize; lanes T, realign and passes are
// gather_rows_layout's (ops/cuda_kernels.py). Rows of one pass take T
// lanes and two rows a segment; wider rows take 32 lanes, one row a
// segment and kWideUnroll passes in flight. Refuses wider rows on fewer
// lanes, copy mode on a row size or table address that is not a multiple
// of 16, and an output that is not 16-byte aligned. Returns the launch's
// CUresult (entry.cuh).
extern "C" int glt_gather_rows(const void* table, const void* rows, void* out,
                               int64_t n, int64_t row_bytes, int b,
                               int lanes, int realign, int passes,
                               int device, void* stream) {
  if (b <= 0) return 0;
  if (n <= 0 || bad_layout(row_bytes, passes, out, realign,
                           reinterpret_cast<uintptr_t>(table)))
    return CUDA_ERROR_INVALID_VALUE;
  const Args a{static_cast<const unsigned char*>(table), n, row_bytes,
               static_cast<const int*>(rows), b,
               static_cast<unsigned char*>(out), passes};
  return launch_layout(lanes, realign, passes, device, stream, a);
}

// A split store's gather: rows [0, h) from `hot` (device memory), rows
// [h, h + c) from `cold` (pinned host memory at its mapped device
// address, or device memory); the layout is gather_rows_layout's over
// both addresses. h == 0 or c == 0 is the one-block launch over the
// other block.
extern "C" int glt_gather_rows_mixed(const void* hot, int64_t h,
                                     const void* cold, int64_t c,
                                     const void* rows, void* out,
                                     int64_t row_bytes, int b, int lanes,
                                     int realign, int passes, int device,
                                     void* stream) {
  if (b <= 0) return 0;
  if (h < 0 || c < 0) return CUDA_ERROR_INVALID_VALUE;
  if (c == 0)
    return glt_gather_rows(hot, rows, out, h, row_bytes, b, lanes, realign,
                           passes, device, stream);
  if (h == 0)
    return glt_gather_rows(cold, rows, out, c, row_bytes, b, lanes, realign,
                           passes, device, stream);
  if (bad_layout(row_bytes, passes, out, realign,
                 reinterpret_cast<uintptr_t>(hot)
                     | reinterpret_cast<uintptr_t>(cold)))
    return CUDA_ERROR_INVALID_VALUE;
  const MixedArgs a{static_cast<const unsigned char*>(hot), h,
                    static_cast<const unsigned char*>(cold), h + c,
                    row_bytes, static_cast<const int*>(rows), b,
                    static_cast<unsigned char*>(out), passes};
  return launch_layout(lanes, realign, passes, device, stream, a);
}

// Page-locks the `bytes` bytes of host memory at `ptr` in place and maps
// them for the card `device`; writes their device address to the 8 bytes
// at `address` and returns 0, or returns the runtime's error.
extern "C" int glt_host_register(const void* ptr, int64_t bytes,
                                 void* address, int device) {
  glt::DeviceGuard guard(device);
  if (guard.err != CUDA_SUCCESS) return guard.err;
  if (!ptr || bytes <= 0 || !address) return cudaErrorInvalidValue;
  void* p = const_cast<void*>(ptr);
  cudaError_t err = cudaHostRegister(
      p, static_cast<size_t>(bytes),
      cudaHostRegisterMapped | cudaHostRegisterPortable);
  if (err != cudaSuccess) return err;
  void* dev = nullptr;
  err = cudaHostGetDevicePointer(&dev, p, 0);
  if (err != cudaSuccess) {
    cudaHostUnregister(p);
    return err;
  }
  *static_cast<uint64_t*>(address) = reinterpret_cast<uint64_t>(dev);
  return 0;
}

// Undoes glt_host_register.
extern "C" int glt_host_unregister(const void* ptr, int device) {
  glt::DeviceGuard guard(device);
  if (guard.err != CUDA_SUCCESS) return guard.err;
  return cudaHostUnregister(const_cast<void*>(ptr));
}

GLT_MODULE(gather_rows,
           GLT_LAUNCH(glt_gather_rows),
           GLT_LAUNCH(glt_gather_rows_mixed),
           GLT_ENTRY(glt_host_register),
           GLT_ENTRY(glt_host_unregister))
