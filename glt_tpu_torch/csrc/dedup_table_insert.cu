// dedup_table_insert: a fresh dedup table with the seed uniques inserted
// (dedup_table_init: one seed type; dedup_table_init_types: several), or
// pre-labelled ids inserted into a table in place.
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
//
// Seeds of several types (a two-type link batch seeds its users and its
// items at once; glt_tpu/ops/pipeline.py:1042-1088 inserts both into one
// table before the first hop): the kernel takes up to kMaxSegs segments,
// each a type's ids, labels, flags, count and tag base, by value in one
// parameter block, and P1 walks them in turn, so the fill and every
// type's insert stay one cooperative launch with no host read. The
// yardstick is what it replaces: the one-type init followed by an
// in-place insert of the second type, two launches. Its bound adds every
// segment's lanes to the fill's 12 bytes a slot: 25.2 MB for the
// 2^21-slot table of a Taobao-shaped link batch, 7.5 us at 3.35 TB/s.
#include "entry.cuh"
#include "dedup_table.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegs = 8;   // node types seeded in one launch

// The ids to insert: up to kMaxSegs segments, each its own ids, labels,
// byte flags, lane count and tag base (a kernel parameter, by value).
struct Segs {
  int n;
  const int* ids[kMaxSegs];
  const int* labs[kMaxSegs];
  const unsigned char* ok[kMaxSegs];
  int base[kMaxSegs];
  int m[kMaxSegs];
};

Segs one_seg(const void* ids, const void* labs, const void* ok, int base,
             int m) {
  Segs g{};
  g.n = 1;
  g.ids[0] = static_cast<const int*>(ids);
  g.labs[0] = static_cast<const int*>(labs);
  g.ok[0] = static_cast<const unsigned char*>(ok);
  g.base[0] = base;
  g.m[0] = m;
  return g;
}

template <bool kFill>
__global__ void __launch_bounds__(kThreads)
table_insert_kernel(int* __restrict__ keys, int* __restrict__ vals,
                    int* __restrict__ first, int slots, Segs segs) {
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
  for (int g = 0; g < segs.n; ++g) {
    const int* __restrict__ ids = segs.ids[g];
    const int* __restrict__ labs = segs.labs[g];
    const unsigned char* __restrict__ ok = segs.ok[g];
    const int base = segs.base[g];
    for (int i = tid; i < segs.m[g]; i += stride) {
      if (!__ldg(ok + i)) continue;
      const int x = __ldg(ids + i);
      if (x < 0 || (kFill && x == INT_MAX)) continue;
      bool inserted;
      const int s = glt::table_probe_insert(keys, slots - 1, x + base,
                                            &inserted);
      if (inserted) vals[s] = __ldg(labs + i);
    }
  }
}

using InitLaunch = glt::CoopLaunch<table_insert_kernel<true>, kThreads>;

bool bad_table(int slots) { return slots <= 0 || slots & (slots - 1); }

// One cooperative launch: the planes filled, then every segment inserted.
int init_table(void* planes, int slots, const Segs& segs, int device,
               void* stream) {
  const int blocks = InitLaunch::blocks(device);
  if (blocks <= 0) return -blocks;
  int work = slots;
  for (int g = 0; g < segs.n; ++g) work = segs.m[g] > work ? segs.m[g] : work;
  const int need = (work + kThreads - 1) / kThreads;
  const int grid = need < 1 ? 1 : (need < blocks ? need : blocks);
  int* keys = static_cast<int*>(planes);
  return InitLaunch::run(grid, device, stream, keys, keys + slots,
                         keys + 2 * slots, slots, segs);
}

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
  return init_table(planes, slots, one_seg(ids, labs, ok, base, m), device,
                    stream);
}

// The same fresh table with several seed types inserted in the one
// launch: segment g is ids[g], labs[g], ok[g] (pointers as ints) of m[g]
// lanes under tag base base[g]; every list holds one entry a segment, at
// most kMaxSegs. Returns the launch's CUresult (entry.cuh).
extern "C" int glt_dedup_table_init_types(void* planes, int slots,
                                          glt::Ints<kMaxSegs> ids,
                                          glt::Ints<kMaxSegs> labs,
                                          glt::Ints<kMaxSegs> ok,
                                          glt::Ints<kMaxSegs> base,
                                          glt::Ints<kMaxSegs> m, int device,
                                          void* stream) {
  if (bad_table(slots) || ids.n < 1 || labs.n != ids.n || ok.n != ids.n
      || base.n != ids.n || m.n != ids.n)
    return CUDA_ERROR_INVALID_VALUE;
  Segs segs{};
  segs.n = ids.n;
  for (int g = 0; g < segs.n; ++g) {
    if (m.v[g] < 0 || base.v[g] < 0) return CUDA_ERROR_INVALID_VALUE;
    segs.ids[g] = reinterpret_cast<const int*>(ids.v[g]);
    segs.labs[g] = reinterpret_cast<const int*>(labs.v[g]);
    segs.ok[g] = reinterpret_cast<const unsigned char*>(ok.v[g]);
    segs.base[g] = static_cast<int>(base.v[g]);
    segs.m[g] = static_cast<int>(m.v[g]);
  }
  return init_table(planes, slots, segs, device, stream);
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
      one_seg(ids, labs, ok, 0, m));
}

GLT_MODULE(dedup_table_insert,
           GLT_ENTRY(glt_dedup_table_insert),
           GLT_ENTRY(glt_dedup_table_init),
           GLT_ENTRY(glt_dedup_table_init_types))
