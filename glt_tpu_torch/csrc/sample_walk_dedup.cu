// sample_walk_dedup: the uniform multi-hop walk with exact dedup/relabel.
//
// Replaces: glt_tpu/ops/pallas_kernels.py sample_walk_dedup (:998) and the
// relabel epilogue of glt_tpu/ops/pipeline.py _multihop_sample_walk
// (:584-633). The seed phase is dedup_table_insert.cu, called first by the
// wrapper (glt_tpu_torch/ops/cuda_kernels.py).
//
// Bound on this card: latency, not bytes. A hop reads two indptr entries
// and K neighbour ids per frontier row and writes a few int32 per pick --
// about 20 MB for the whole walk at batch 1024, fanouts [15, 10, 5], i.e.
// a few microseconds of the 3.35 TB/s -- but every pick is a dependent
// random read (indptr -> indices -> hash table probe) and hop h+1 cannot
// start before hop h's picks are deduplicated.
// Design: three launches per hop on one stream, no host synchronisation.
//   sample  -- one thread per frontier row: degree from indptr_pad (an
//              invalid id INT32_MAX clamps to row N, degree 0), Floyd or
//              with-replacement offsets from the injected uniforms in the
//              exact float32 arithmetic of the TPU draw, direct reads of
//              indices[start + offset] (no windows and no hub lists: a
//              thread reads any element), and a lock-free probe/insert of
//              every valid pick; an id new in this hop records its minimum
//              slot with atomicMin. The row's offsets live in a 64-entry
//              thread-local array for fanouts up to 64 (the main paths'
//              [15, 10, 5]); a wider fanout has its own instantiation that
//              keeps them in the row's own span of the tslot output, which
//              only the owning thread touches (so it stays in L1/L2) and
//              which the same thread overwrites, column by column, with
//              the table slots once each offset is read. Every fanout the
//              JAX walk takes (k > 0) runs, with the same picks.
//   heads   -- one thread per slot: seen ids take their stored label; the
//              minimum slot of a new id is its head, and heads form the next
//              frontier where(new_head, pick, INT32_MAX).
//   labels  -- after one sort of the next frontier (torch.sort in the
//              wrapper, as the TPU path sorts in XLA), each new slot's label
//              is count + its id's rank among the hop's new ids (binary
//              search), and the head writes that label into the table.
// The TPU kernel gets first-occurrence order from its sequential grid;
// blocks here run in no order, so the order comes from atomicMin and the
// value-order labels from the sort, which is the label contract the TPU
// path restores in its epilogue anyway.
#include "entry.cuh"
#include "dedup_table.cuh"

namespace {

// fanouts up to this keep a row's offsets in a thread-local array
constexpr int kLocalFanout = 64;

template <bool kWide>
__global__ void walk_sample_kernel(
    const int* __restrict__ indptr_pad, int num_nodes,
    const int* __restrict__ indices, const int* __restrict__ frontier,
    const int* __restrict__ frontier_ok, int s, int k,
    const float* __restrict__ u, int replace, int* keys,
    const int* __restrict__ vals, int* first, int mask,
    int* __restrict__ picks, int* __restrict__ slots,
    unsigned char* __restrict__ valid, int* __restrict__ tslot) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= s) return;
  const int fid = frontier[r];
  const bool ok = frontier_ok ? frontier_ok[r] != 0 : fid != INT_MAX;
  const int addr = fid < 0 ? 0 : (fid > num_nodes ? num_nodes : fid);
  const int start = indptr_pad[addr];
  const int deg = ok ? indptr_pad[addr + 1] - start : 0;
  const float* ur = u + static_cast<int64_t>(r) * k;

  int local_off[kWide ? 1 : kLocalFanout];
  int* off = kWide ? tslot + static_cast<int64_t>(r) * k : local_off;
  int n_valid;
  if (replace) {
    // offsets = min(int(u * deg), max(deg - 1, 0)); every lane valid iff
    // deg > 0 (ops/sample.py _draw_hop, replace branch)
    for (int j = 0; j < k; ++j) {
      int t = __float2int_rz(__fmul_rn(ur[j], __int2float_rn(deg)));
      off[j] = min(t, max(deg - 1, 0));
    }
    n_valid = deg > 0 ? k : 0;
  } else if (deg <= k) {
    for (int j = 0; j < k; ++j) off[j] = j;
    n_valid = deg;
  } else {
    // Floyd: draw t in [0, bound], take bound on a collision with an
    // earlier column (ops/sample.py _floyd_offsets)
    for (int j = 0; j < k; ++j) {
      const int bound = max(deg - k + j, 0);
      int t = __float2int_rz(__fmul_rn(ur[j], __int2float_rn(bound + 1)));
      t = min(t, bound);
      bool dup = false;
      for (int q = 0; q < j; ++q) dup |= off[q] == t;
      off[j] = dup ? bound : t;
    }
    n_valid = k;
  }

  for (int j = 0; j < k; ++j) {
    const int e = r * k + j;
    if (j >= n_valid) {
      picks[e] = -1;
      valid[e] = 0;
      tslot[e] = -1;
      if (slots) slots[e] = -1;
      continue;
    }
    const int slot = start + off[j];   // read before tslot[e] is written
    const int x = indices[slot];
    picks[e] = x;
    valid[e] = 1;
    if (slots) slots[e] = slot;
    tslot[e] = glt::table_claim(keys, vals, first, mask, x, e);
  }
}

__global__ void walk_labels_kernel(const int* __restrict__ picks,
                                   const unsigned char* __restrict__ new_head,
                                   const int* __restrict__ tslot,
                                   const int* __restrict__ sorted_new,
                                   const int* __restrict__ count, int m,
                                   int* __restrict__ labels,
                                   int* __restrict__ vals) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m || labels[e] != -2) return;
  const int lab = *count + glt::lower_bound(sorted_new, m, picks[e]);
  labels[e] = lab;
  if (new_head[e]) vals[tslot[e]] = lab;
}

}  // namespace

extern "C" int glt_walk_sample(const void* indptr_pad, int num_nodes,
                               const void* indices, const void* frontier,
                               const void* frontier_ok, int s, int k,
                               const void* u, int replace, void* keys,
                               const void* vals, void* first, int slots_n,
                               void* picks, void* slots, void* valid,
                               void* tslot, int device, void* stream) {
  if (s <= 0) return 0;
  const int threads = 128;
  auto run = k <= kLocalFanout ? glt::Launch<walk_sample_kernel<false>>::run
                               : glt::Launch<walk_sample_kernel<true>>::run;
  return run(
      dim3(glt::blocks_for(s, threads)), dim3(threads), device, stream,
      static_cast<const int*>(indptr_pad), num_nodes,
      static_cast<const int*>(indices), static_cast<const int*>(frontier),
      static_cast<const int*>(frontier_ok), s, k,
      static_cast<const float*>(u), replace, static_cast<int*>(keys),
      static_cast<const int*>(vals), static_cast<int*>(first), slots_n - 1,
      static_cast<int*>(picks), static_cast<int*>(slots),
      static_cast<unsigned char*>(valid), static_cast<int*>(tslot));
}

extern "C" int glt_walk_heads(const void* picks, const void* valid,
                              const void* tslot, const void* vals,
                              const void* first, int m, void* labels,
                              void* new_head, void* next_frontier,
                              int device, void* stream) {
  if (m <= 0) return 0;
  const int threads = 256;
  return glt::Launch<glt::table_heads_kernel>::run(
      dim3(glt::blocks_for(m, threads)), dim3(threads), device, stream,
      static_cast<const int*>(picks),
      static_cast<const unsigned char*>(valid),
      static_cast<const int*>(tslot), static_cast<const int*>(vals),
      static_cast<const int*>(first), m, static_cast<int*>(labels),
      static_cast<unsigned char*>(new_head),
      static_cast<int*>(next_frontier));
}

extern "C" int glt_walk_labels(const void* picks, const void* new_head,
                               const void* tslot, const void* sorted_new,
                               const void* count, int m, void* labels,
                               void* vals, int device, void* stream) {
  if (m <= 0) return 0;
  const int threads = 256;
  return glt::Launch<walk_labels_kernel>::run(
      dim3(glt::blocks_for(m, threads)), dim3(threads), device, stream,
      static_cast<const int*>(picks),
      static_cast<const unsigned char*>(new_head),
      static_cast<const int*>(tslot), static_cast<const int*>(sorted_new),
      static_cast<const int*>(count), m, static_cast<int*>(labels),
      static_cast<int*>(vals));
}

GLT_MODULE(sample_walk_dedup,
           GLT_ENTRY(glt_walk_sample),
           GLT_ENTRY(glt_walk_heads),
           GLT_ENTRY(glt_walk_labels))
