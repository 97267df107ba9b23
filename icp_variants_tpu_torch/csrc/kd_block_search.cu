// kd_block_search: per query, the exact nearest point among the points of
// its own top-k kd blocks, below a per-query starting bound.
//
// Replaces the TPU kernel icp_variants_tpu/ops/knn.py
// _make_resident_kernel in its base mode (launched by
// _run_resident_kernel_flat). On the TPU a pair's whole page table stayed
// resident in VMEM and a gate of queries walked the union of its picks; an
// H100 SM has at most 227 KB of shared memory, and a gate-major walk leaves
// most lanes idle (a lane works only on blocks its own query picked), so
// here the work is turned block-major.
//
// Semantics (held against the plain version in ops/kdtree.py bit for bit):
// block_major.cuh's, each row starting at its own bound, `binit` (B, N):
// among the points of the row's picks `sel` (B, N, k) strictly below it,
// the least (d2, pick position, slot); (binit, -1) where none is.
//
// Layout: one C entry, the five launches of block_major.cuh (bin, scan,
// scatter, walk, out; the counting sort of the (query, pick) entries by
// (pair, block) in a workspace the wrapper allocates, a cp.async.bulk
// stage of each bucket chunk's block, every lane on a live (query, block)
// pair, a 64-bit atomicMin merge). cached_block_search.cu runs the same
// machinery at k = 1 from a common bound, so the header holds it once.
//
// `counters` (null: none) takes the three work counts of the launch, added
// where the work happens (block_major.cuh): rows searched (rows with a
// pick), the (query, block) entries bucketed, and the bucket chunks staged,
// the block loads those entries share.
//
// With probe != 0 (a measurement aid: the JAX kernel's probe >= 1) the
// bucketing runs and every chunk still stages its block, but no distance is
// taken and every row gets (binit, -1).
//
// What bounds it on the H100: f32 issue. Per (query, slot), D subtractions,
// D products and D - 1 sums, each rounded on its own (built with
// -fmad=false, so no FMA: the non-FMA issue rate, about half the 67
// TFLOP/s peak), and a min per slot and a compare per 4 slots. The
// shared-memory issue (D LDS.128 per 4 slots x Q queries) and the staging
// (each chunk's block read once from L2) are below that; the bucketing
// launches read sel and write a few words per entry.
//
// Built with -DKDB_LANE_COUNT (a measurement build, loaded by
// scripts/resident_bench.lane_use; never on the main path), the walk also
// counts, at each warp step, the lanes that __activemask() reports active,
// and kd_block_search_lanes reads the sums.
#define BM_KERNEL(part) kd_block_search_##part
#include "block_major.cuh"

template <int D>
static cudaError_t launch(const float* q, const int32_t* sel, const float* binit,
                          const float* pages, float* d2, int32_t* idx, void* ws, int B, int N,
                          int nc, int cap_pad, int k, int probe, unsigned long long* counters,
                          cudaStream_t s) {
  return probe ? block_major_launch<D, true, false, false>(q, nullptr, sel, binit, 0.0f, pages,
                                                           d2, idx, ws, B, N, nc, cap_pad, k,
                                                           counters, s)
               : block_major_launch<D, false, false, false>(q, nullptr, sel, binit, 0.0f, pages,
                                                            d2, idx, ws, B, N, nc, cap_pad, k,
                                                            counters, s);
}

// counters: null, or three int64 counters (rows, entries, chunks) to add to.
extern "C" int kd_block_search_launch(const float* q, const int32_t* sel, const float* binit,
                                      const float* pages, float* d2, int32_t* idx, void* ws,
                                      long long ws_bytes, int B, int N, int nc, int cap_pad,
                                      int k, int probe, unsigned long long* counters, int D,
                                      void* stream) {
  bool empty;
  cudaError_t err = block_major_check(pages, ws_bytes, B, N, nc, cap_pad, k, &empty);
  if (err != cudaSuccess || empty) return static_cast<int>(err);
  return static_cast<int>(ICP_DISPATCH_D(D, launch, q, sel, binit, pages, d2, idx, ws, B, N, nc,
                                         cap_pad, k, probe, counters,
                                         static_cast<cudaStream_t>(stream)));
}

#ifdef KDB_LANE_COUNT
// The measurement build's lane counts into `out` (4 values, kdb_lanes), then
// zeroed when `reset`; synchronous.
extern "C" int kd_block_search_lanes(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, kdb_lanes, sizeof(kdb_lanes));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[4] = {0, 0, 0, 0};
    err = cudaMemcpyToSymbol(kdb_lanes, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif
