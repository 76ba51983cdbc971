// sample_hop_dedup: one hop of the hetero walk -- every edge type's picks
// read from the flat edge-type plane and deduplicated against one table of
// type-tagged ids.
//
// Replaces: glt_tpu/ops/pallas_kernels.py sample_hop_dedup (:653) on its
// hetero path (_multihop_sample_hetero_fused, glt_tpu/ops/pipeline.py
// :1010-1230), and the per-type value-order relabel of that path's XLA
// epilogue (:1162-1203). The offsets are drawn before the launch, in the
// wrapper (glt_tpu_torch/ops/cuda_kernels.py), as the TPU path draws them
// in its XLA prologue.
//
// Bound on this card: latency, not bytes. A hop reads one start per row,
// one offset and validity per lane and one neighbour id per valid lane,
// and writes a few int32 per lane: at the IGBH-small shapes of bucket 256
// the largest hop (268,800 rows x 5 lanes) moves about 30 MB, some 9 us
// of the 3.35 TB/s. But every valid lane is a dependent random read
// (start -> indices_flat -> table probe) and the hop's labels need all of
// its picks first.
// Design: three launches per hop on one stream, no host synchronisation.
//   sample  -- one thread per lane: x = indices_flat[starts[r] + offsets
//              [r, j]] (a thread reads any element, so the TPU's W-padded
//              windows and hub tail pass are gone), the edge id beside it,
//              and a lock-free probe/insert of x; an id new in this hop
//              records its minimum lane with atomicMin (table_claim).
//   heads   -- dedup_table.cuh table_heads_kernel: seen ids take their
//              stored label, each new id's minimum lane is its head.
//   labels  -- after one sort of the heads' ids (torch.sort in the wrapper)
//              each new lane's label is counts[t] + its id's rank among
//              the hop's new ids of type t, where t is the type whose range
//              [type_bounds[t], type_bounds[t+1]) holds the tagged id: the
//              sort groups the tags by type and orders each type by value,
//              so one binary search gives the rank and a second the first
//              rank of the type. The head writes the label into the table.
// The TPU kernel labels new ids provisionally in the order of its
// sequential grid and an XLA remap rewrites them; blocks here run in no
// order, so the table holds final labels from the start and no remap is
// needed.
#include "entry.cuh"
#include "dedup_table.cuh"

namespace {

__global__ void hop_sample_kernel(
    const int* __restrict__ indices_flat, const int* __restrict__ eids_flat,
    const int* __restrict__ starts, const int* __restrict__ offsets,
    const unsigned char* __restrict__ valid, int m, int k, int* keys,
    const int* __restrict__ vals, int* first, int mask,
    int* __restrict__ picks, int* __restrict__ eid_picks,
    int* __restrict__ tslot) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  if (!valid[e]) {
    picks[e] = -1;
    if (eid_picks) eid_picks[e] = -1;
    tslot[e] = -1;
    return;
  }
  const int slot = starts[e / k] + offsets[e];
  const int x = indices_flat[slot];
  picks[e] = x;
  if (eid_picks) eid_picks[e] = eids_flat[slot];
  tslot[e] = glt::table_claim(keys, vals, first, mask, x, e);
}

__global__ void hop_labels_kernel(const int* __restrict__ picks,
                                  const unsigned char* __restrict__ new_head,
                                  const int* __restrict__ tslot,
                                  const int* __restrict__ sorted_new,
                                  const int* __restrict__ type_bounds,
                                  int num_types,
                                  const int* __restrict__ counts, int m,
                                  int* __restrict__ labels,
                                  int* __restrict__ vals) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m || labels[e] != -2) return;
  const int x = picks[e];
  int t = num_types - 1;
  while (t > 0 && type_bounds[t] > x) --t;
  const int lab = counts[t] + glt::lower_bound(sorted_new, m, x)
                  - glt::lower_bound(sorted_new, m, type_bounds[t]);
  labels[e] = lab;
  if (new_head[e]) vals[tslot[e]] = lab;
}

}  // namespace

extern "C" int glt_hop_sample(const void* indices_flat, const void* eids_flat,
                              const void* starts, const void* offsets,
                              const void* valid, int s, int k, void* keys,
                              const void* vals, void* first, int slots_n,
                              void* picks, void* eid_picks, void* tslot,
                              int device, void* stream) {
  const int m = s * k;
  if (m <= 0) return 0;
  const int threads = 256;
  return glt::Launch<hop_sample_kernel>::run(
      dim3(glt::blocks_for(m, threads)), dim3(threads), device, stream,
      static_cast<const int*>(indices_flat),
      static_cast<const int*>(eids_flat), static_cast<const int*>(starts),
      static_cast<const int*>(offsets),
      static_cast<const unsigned char*>(valid), m, k,
      static_cast<int*>(keys), static_cast<const int*>(vals),
      static_cast<int*>(first), slots_n - 1, static_cast<int*>(picks),
      static_cast<int*>(eid_picks), static_cast<int*>(tslot));
}

extern "C" int glt_hop_heads(const void* picks, const void* valid,
                             const void* tslot, const void* vals,
                             const void* first, int m, void* labels,
                             void* new_head, void* next_key, int device,
                             void* stream) {
  if (m <= 0) return 0;
  const int threads = 256;
  return glt::Launch<glt::table_heads_kernel>::run(
      dim3(glt::blocks_for(m, threads)), dim3(threads), device, stream,
      static_cast<const int*>(picks),
      static_cast<const unsigned char*>(valid),
      static_cast<const int*>(tslot), static_cast<const int*>(vals),
      static_cast<const int*>(first), m, static_cast<int*>(labels),
      static_cast<unsigned char*>(new_head), static_cast<int*>(next_key));
}

extern "C" int glt_hop_labels(const void* picks, const void* new_head,
                              const void* tslot, const void* sorted_new,
                              const void* type_bounds, int num_types,
                              const void* counts, int m, void* labels,
                              void* vals, int device, void* stream) {
  if (m <= 0) return 0;
  const int threads = 256;
  return glt::Launch<hop_labels_kernel>::run(
      dim3(glt::blocks_for(m, threads)), dim3(threads), device, stream,
      static_cast<const int*>(picks),
      static_cast<const unsigned char*>(new_head),
      static_cast<const int*>(tslot), static_cast<const int*>(sorted_new),
      static_cast<const int*>(type_bounds), num_types,
      static_cast<const int*>(counts), m, static_cast<int*>(labels),
      static_cast<int*>(vals));
}

GLT_MODULE(sample_hop_dedup,
           GLT_ENTRY(glt_hop_sample),
           GLT_ENTRY(glt_hop_heads),
           GLT_ENTRY(glt_hop_labels))
