// dedup_table_insert: insert pre-labelled ids into the dedup table.
//
// Replaces: glt_tpu/ops/pallas_kernels.py dedup_table_insert (:588), the
// seed phase of the TPU walk (sample_walk_dedup :1119-1131).
//
// Bound on this card: neither bytes nor operations -- the seed phase moves
// a few KB (12 bytes per id in, 8 bytes per inserted slot out), so one
// launch is latency: launch overhead plus one dependent probe chain per id.
// Design: one thread per id, lock-free insert with atomicCAS on the key;
// the thread that claims a slot writes its label, so an id already present
// keeps its label. The TPU kernel walks the ids in one sequential loop over
// a VMEM table; here the table is in global memory (it stays in the 50 MB
// L2 at serving sizes) and every id probes in parallel.
#include "entry.cuh"
#include "dedup_table.cuh"

namespace {

__global__ void dedup_table_insert_kernel(int* __restrict__ keys,
                                          int* __restrict__ vals, int mask,
                                          const int* __restrict__ ids,
                                          const int* __restrict__ labs,
                                          const int* __restrict__ valid,
                                          int m) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int x = ids[i];
  if (x < 0 || valid[i] == 0) return;
  bool inserted;
  int s = glt::table_probe_insert(keys, mask, x, &inserted);
  if (inserted) vals[s] = labs[i];
}

}  // namespace

// Returns the launch's CUresult (entry.cuh).
extern "C" int glt_dedup_table_insert(void* keys, void* vals, int slots,
                                      const void* ids, const void* labs,
                                      const void* valid, int m,
                                      int device, void* stream) {
  if (m <= 0) return 0;
  const int threads = 256;
  return glt::Launch<dedup_table_insert_kernel>::run(
      dim3(glt::blocks_for(m, threads)), dim3(threads), device, stream,
      static_cast<int*>(keys), static_cast<int*>(vals), slots - 1,
      static_cast<const int*>(ids), static_cast<const int*>(labs),
      static_cast<const int*>(valid), m);
}

GLT_MODULE(dedup_table_insert,
           GLT_ENTRY(glt_dedup_table_insert))
