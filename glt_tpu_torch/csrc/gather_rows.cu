// gather_rows: out[i] = table[clamp(rows[i], 0, N-1)].
//
// Replaces: glt_tpu/ops/pallas_kernels.py gather_rows (:236), the
// row_gather seam of Feature.device_gather.
//
// Bound on this card: bytes. Each output row is one table row read and one
// row written (400 B each for 100 float32 features), with no arithmetic,
// so the floor is 2 * B * row_bytes over the 3.35 TB/s of device memory.
// Design: one warp per row, the 32 lanes striding the row in the widest
// unit that the row size and both base pointers allow: 16-byte vectors
// (the common float32 width of 100 qualifies), 4-byte words (any float32
// row, or a bf16 row of even width), 2-byte halves (a bf16 or fp16 row of
// odd width) or single bytes (a uint8 row whose width is not even).
// The TPU kernel paid one grid step per row; here 8 rows share a block and
// the row index is loaded once per warp.
#include "entry.cuh"
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename Unit>
__global__ void gather_rows_kernel(const Unit* __restrict__ table,
                                   const int* __restrict__ rows,
                                   Unit* __restrict__ out, int64_t n,
                                   int64_t units_per_row, int64_t b) {
  const int warps = blockDim.x / 32;
  int64_t i = static_cast<int64_t>(blockIdx.x) * warps + threadIdx.x / 32;
  if (i >= b) return;
  const int lane = threadIdx.x % 32;
  int64_t r = rows[i];
  r = r < 0 ? 0 : (r >= n ? n - 1 : r);
  const Unit* src = table + r * units_per_row;
  Unit* dst = out + i * units_per_row;
  for (int64_t u = lane; u < units_per_row; u += 32) dst[u] = __ldg(src + u);
}

template <typename Unit>
int launch(const void* table, const void* rows, void* out, int64_t n,
           int64_t row_bytes, int64_t b, int device, void* stream) {
  const int threads = 256;  // 8 rows per block
  const int64_t blocks = (b + threads / 32 - 1) / (threads / 32);
  return glt::Launch<gather_rows_kernel<Unit>>::run(
      dim3(static_cast<unsigned>(blocks)), dim3(threads), device, stream,
      static_cast<const Unit*>(table), static_cast<const int*>(rows),
      static_cast<Unit*>(out), n, row_bytes / sizeof(Unit), b);
}

}  // namespace

// row_bytes = D * itemsize; unit is the copy width in bytes (16, 4, 2 or
// 1), chosen by the wrapper from row_bytes and pointer alignment. Returns
// the launch's CUresult (entry.cuh).
extern "C" int glt_gather_rows(const void* table, const void* rows, void* out,
                               int64_t n, int64_t row_bytes, int64_t b,
                               int unit, int device, void* stream) {
  if (b <= 0) return 0;
  switch (unit) {
    case 16:
      return launch<uint4>(table, rows, out, n, row_bytes, b, device, stream);
    case 4:
      return launch<uint32_t>(table, rows, out, n, row_bytes, b, device,
                              stream);
    case 2:
      return launch<uint16_t>(table, rows, out, n, row_bytes, b, device,
                              stream);
    case 1:
      return launch<uint8_t>(table, rows, out, n, row_bytes, b, device,
                             stream);
    default:
      return CUDA_ERROR_INVALID_VALUE;
  }
}

GLT_MODULE(gather_rows,
           GLT_ENTRY(glt_gather_rows))
