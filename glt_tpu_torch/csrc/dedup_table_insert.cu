// dedup_table_insert: a fresh dedup table with the seed uniques inserted
// (dedup_table_init), or pre-labelled ids inserted into a table in place.
//
// Replaces: glt_tpu/ops/pallas_kernels.py dedup_table_insert (:588) and
// with it glt_tpu/ops/sample.py's init_table (:587-593: make_dedup_table,
// then the seed insert), the seed phase of the hetero walk before its
// first hop; the homogeneous walk inserts its seeds in its own launch
// (sample_walk_dedup.cu's P0).
//
// Bound on this card: bytes. The init writes the table's three int32
// planes (12 bytes a slot), reads a 1-byte flag a lane and a 4-byte id
// where the flag is set, and for each inserted id reads its label and
// writes a key and a label (12 bytes): 50.3 MB for the 2^22-slot table
// (4,194,304 slots) of an igbh-rgat request at bucket 256, 15.0 us at
// 3.35 TB/s. The insert alone is a few KB, so the in-place mode is one
// launch of latency.
//
// The first design took the fill from three torch.full calls and the
// masked ids from a torch.where, a full_like, a comparison and a
// bool-to-int32 conversion of the flags, then inserted in its own launch:
// 0.0254 ms a launch on an H100 80GB HBM3 at 700 W (PERF.md), seven
// host-driven ops before the hetero walk's first hop.
//
// Design: one kernel in two modes. The init is one cooperative launch
// (glt::CoopLaunch, as the walk's P0): P0 fills the planes grid-stride
// (keys -1, vals -1, first INT32_MAX), a grid barrier, then P1 inserts
// with one thread an id: lanes whose flag is 0, and ids that are negative
// or INT32_MAX (the seed hop's non-heads), are skipped, the type's base is
// added and the id probes with atomicCAS (glt::table_probe_insert); the
// thread that claims a slot writes its label, so an id already present
// keeps its label. The in-place mode is the same kernel with P0 and the
// barrier compiled out, launched plainly (glt::Launch). The TPU kernel
// walks its ids in one sequential loop over a VMEM table; here the table
// is in global memory (it stays in the 50 MB L2 at serving sizes) and
// every id probes in parallel.
#include "entry.cuh"
#include "dedup_table.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

template <bool kFill>
__global__ void __launch_bounds__(kThreads)
table_insert_kernel(int* __restrict__ keys, int* __restrict__ vals,
                    int* __restrict__ first, int slots,
                    const int* __restrict__ ids, const int* __restrict__ labs,
                    const unsigned char* __restrict__ ok, int base, int m) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  if constexpr (kFill) {
    for (int i = tid; i < slots; i += stride) {
      keys[i] = glt::kEmpty;
      vals[i] = -1;
      first[i] = INT_MAX;
    }
    cg::this_grid().sync();
  }
  for (int i = tid; i < m; i += stride) {
    if (!__ldg(ok + i)) continue;
    const int x = __ldg(ids + i);
    if (x < 0 || (kFill && x == INT_MAX)) continue;
    bool inserted;
    const int s = glt::table_probe_insert(keys, slots - 1, x + base,
                                          &inserted);
    if (inserted) vals[s] = __ldg(labs + i);
  }
}

using InitLaunch = glt::CoopLaunch<table_insert_kernel<true>, kThreads>;

bool bad_table(int slots) { return slots <= 0 || slots & (slots - 1); }

}  // namespace

// A fresh table in `planes` (keys, vals, first: `slots` int32 each, one
// after another) with ids[i] + base inserted under labs[i] wherever
// ok[i] (bytes) is set and ids[i] is neither negative nor INT32_MAX; ids
// + base must stay below INT32_MAX. One cooperative launch of at most the
// blocks that fit on `device` at once. Returns the launch's CUresult (entry.cuh).
extern "C" int glt_dedup_table_init(void* planes, int slots, const void* ids,
                                    const void* labs, const void* ok,
                                    int base, int m, int device,
                                    void* stream) {
  if (bad_table(slots) || m < 0) return CUDA_ERROR_INVALID_VALUE;
  const int blocks = InitLaunch::blocks(device);
  if (blocks <= 0) return -blocks;
  const int work = slots > m ? slots : m;
  const int need = (work + kThreads - 1) / kThreads;
  const int grid = need < 1 ? 1 : (need < blocks ? need : blocks);
  int* keys = static_cast<int*>(planes);
  return InitLaunch::run(grid, device, stream, keys, keys + slots,
                         keys + 2 * slots, slots,
                         static_cast<const int*>(ids),
                         static_cast<const int*>(labs),
                         static_cast<const unsigned char*>(ok), base, m);
}

// ids[i] inserted under labs[i] into the (keys, vals) table in place,
// wherever ok[i] (bytes) is set and ids[i] is not negative. Returns the
// launch's CUresult (entry.cuh).
extern "C" int glt_dedup_table_insert(void* keys, void* vals, int slots,
                                      const void* ids, const void* labs,
                                      const void* ok, int m, int device,
                                      void* stream) {
  if (bad_table(slots)) return CUDA_ERROR_INVALID_VALUE;
  if (m <= 0) return 0;
  return glt::Launch<table_insert_kernel<false>>::run(
      dim3(glt::blocks_for(m, kThreads)), dim3(kThreads), device, stream,
      static_cast<int*>(keys), static_cast<int*>(vals), nullptr, slots,
      static_cast<const int*>(ids), static_cast<const int*>(labs),
      static_cast<const unsigned char*>(ok), 0, m);
}

GLT_MODULE(dedup_table_insert,
           GLT_ENTRY(glt_dedup_table_insert),
           GLT_ENTRY(glt_dedup_table_init))
