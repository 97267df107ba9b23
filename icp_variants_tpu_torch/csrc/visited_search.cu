// visited_search: exact 1-NN against a tiled target index with per-query
// search radii; a negative radius freezes the query out.
//
// Replaces the TPU kernel icp_variants_tpu/ops/knn.py _make_visited_kernel
// in its per-query-bound mode (launched by _run_visited_kernel through
// nn_search_pruned_v2(per_query_bound=..., use_phase1=False)), which serves
// the exact arm's certificate-failure fallback.
//
// Semantics (held against the plain version in ops/knn.py):
//   live = radius >= 0; a live query returns the target row of smallest
//   squared distance strictly below its radius (lowest row on ties), or
//   idx -1 and d2 = radius; a frozen query returns idx -1, d2 = radius.
//   idx is the tiled position tile * tile_t + slot (TargetIndex.perm maps
//   it to the original row).
//
// What bounds it on the H100: f32 issue, 3D operations per (live query,
// slot of a tile whose box lies within the query's distance), and on the
// fallback's few live rows the latency of reading those tiles from L2.
// The design this replaces ran one thread per query row, 128 rows a CTA:
// on the fallback almost every row is frozen, so a CTA with one live row
// staged each visited tile with 128 threads and scored it on one lane; it
// visited every tile within the largest live radius of its 128-row box
// (the fallback's radius is the whole bound), never pruned by a running
// best, and scanned the bounds of every tile serially per CTA.
//
// Layout: three launches on the caller's stream.
//  1. A memset of the per-pair live counts.
//  2. visited_search_compact: one thread per row; frozen rows get
//     (radius, -1) at once, live rows are listed per pair (a warp ballot
//     and a CTA prefix, one global atomic per CTA and pair, so each CTA's
//     rows keep their order).
//  3. visited_search_walk: persistent CTAs of warps; each warp takes one
//     live query at a time. It writes the query's squared box lower bound
//     to every tile (rounded as the distances are) into shared memory,
//     each lane keeping the least of its own tiles, and then walks tiles
//     in ascending order of that bound by repeated warp argmin (only the
//     lane whose tile was taken looks at its tiles again). It stops once
//     the next tile's bound is strictly above the query's running best:
//     every later tile is at least as far, and the best only falls, so the
//     stop is exact (a tile whose bound equals the best is walked: a tie
//     at a lower index can still win). A visited tile's 1,024 slots are
//     split over the 32 lanes, four consecutive slots a float4 load from
//     L2 (coalesced); at D = 6 the colour terms are added only where a
//     spatial partial can still win. After each tile the lanes' bests are
//     merged for the stop test; at the end the (d2, index) is merged
//     lexicographically across the warp. A warp serving 2, 4 or 8
//     neighbouring live queries, sharing each tile's loads, was measured
//     slower on the sparse fallbacks of the main paths (PERF.md §6).
//
// `counters` (null: none) takes one int64 count, the live rows the launch
// searches (the rows whose certificate failed), added by one thread a CTA
// of the compaction.
//
// Built for D = 3 (geometry) and D = 6 (colour features).
#include <algorithm>

#include "common.cuh"

#define VS_THREADS 256  // threads of the compaction; most of the walk's
#define VS_WARPS (VS_THREADS / 32)
#define VS_SMEM_MAX (200 * 1024)  // the walk's tile-bound lists per CTA

namespace {

// Workspace: per-pair live counts, then per-pair live-row lists (B, N).
// ops/knn.py (_visited_search_workspace_bytes) allocates the same sum.
size_t workspace_bytes(int B, int N) {
  return icp_align16(4 * static_cast<size_t>(B)) + 4 * static_cast<size_t>(B) * N;
}

__device__ __forceinline__ float tile_lb(const float* qv, const float* __restrict__ tmin,
                                         const float* __restrict__ tmax, size_t box, int D) {
  float lb = icp_gap2(qv[0], __ldg(&tmin[box]), __ldg(&tmax[box]));
  for (int j = 1; j < D; ++j)
    lb = __fadd_rn(lb, icp_gap2(qv[j], __ldg(&tmin[box + j]), __ldg(&tmax[box + j])));
  return lb;
}

// (d, i) takes (dn, in) if dn is smaller, or equal at a lower index; i = -1
// is nothing found (so dn equal to a radius never wins).
__device__ __forceinline__ void take_min(float& d, int& i, float dn, int in) {
  if (dn < d || (dn == d && in < i)) d = dn, i = in;
}

}  // namespace

// 2. Frozen rows out, live rows listed per pair. Grid (ceil(N / VS_THREADS), B).
__global__ void __launch_bounds__(VS_THREADS)
visited_search_compact(const float* __restrict__ radius, int* __restrict__ cnt,
                       int* __restrict__ list, float* __restrict__ d2_out,
                       int32_t* __restrict__ idx_out, int N,
                       unsigned long long* __restrict__ counters) {
  __shared__ int s_warp[VS_WARPS];
  __shared__ int s_base;
  const int b = blockIdx.y;
  const int n = blockIdx.x * VS_THREADS + threadIdx.x;
  const size_t row = static_cast<size_t>(b) * N + n;
  bool live = false;
  if (n < N) {
    const float r = radius[row];
    live = r >= 0.0f;
    if (!live) {
      d2_out[row] = r;
      idx_out[row] = -1;
    }
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < VS_WARPS; ++w) {
      const int c = s_warp[w];
      s_warp[w] = total;
      total += c;
    }
    s_base = total ? atomicAdd(&cnt[b], total) : 0;
    if (counters != nullptr && total) atomicAdd(counters, static_cast<unsigned long long>(total));
  }
  __syncthreads();
  if (live)
    list[static_cast<size_t>(b) * N + s_base + s_warp[warp] +
         __popc(ballot & ((1u << lane) - 1))] = n;
}

// 3. The walk: warp w of CTA c takes live queries c * warps + w, then every
// gridDim.x * warps later one (counted over the pairs in turn).
template <int D>
__global__ void __launch_bounds__(VS_THREADS)
visited_search_walk(const float* __restrict__ q, const float* __restrict__ radius,
                    const float* __restrict__ pages, const float* __restrict__ tmin,
                    const float* __restrict__ tmax, const int* __restrict__ cnt,
                    const int* __restrict__ list, float* __restrict__ d2_out,
                    int32_t* __restrict__ idx_out, int B, int N, int n_tiles, int tile_t) {
  constexpr int H = D > 3 ? 3 : D;  // features summed before the colour skip
  extern __shared__ float s_lb_all[];  // (warps, n_tiles) bounds; +inf once visited
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  float* s_lb = s_lb_all + static_cast<size_t>(warp) * n_tiles;
  const int n4 = tile_t / 4;
  int total = 0;
  for (int b = 0; b < B; ++b) total += cnt[b];

#pragma unroll 1
  for (int gi = blockIdx.x * warps + warp; gi < total; gi += gridDim.x * warps) {
    int b = 0, pos = gi;
    for (; pos >= cnt[b]; ++b) pos -= cnt[b];
    const size_t row = static_cast<size_t>(b) * N + list[static_cast<size_t>(b) * N + pos];
    float qv[D];
#pragma unroll
    for (int j = 0; j < D; ++j) qv[j] = q[row * D + j];
    const float r = radius[row];
    float best = r, merged = r;
    int bidx = -1;
    // The query's bound to every tile; each lane's least (lowest tile on ties).
    float cl = INFINITY;
    int ct = -1;
    for (int t = lane; t < n_tiles; t += 32) {
      const float lb = tile_lb(qv, tmin, tmax, (static_cast<size_t>(b) * n_tiles + t) * 8, D);
      s_lb[t] = lb;
      if (ct < 0 || lb < cl) cl = lb, ct = t;
    }
    __syncwarp();
#pragma unroll 1
    for (;;) {
      // The next tile: the least (bound, tile) over the lanes.
      float ml = cl;
      int mt = ct < 0 ? 0x7fffffff : ct;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ol = __shfl_xor_sync(0xffffffffu, ml, o);
        const int ot = __shfl_xor_sync(0xffffffffu, mt, o);
        if (ol < ml || (ol == ml && ot < mt)) ml = ol, mt = ot;
      }
      if (mt == 0x7fffffff || ml == INFINITY || ml > merged) break;  // uniform
      if (lane == (mt & 31)) {
        // This lane's tile is taken: mark it and find the lane's next.
        s_lb[mt] = INFINITY;
        cl = INFINITY;
        ct = -1;
        for (int t = lane; t < n_tiles; t += 32) {
          const float lb = s_lb[t];
          if (ct < 0 || lb < cl) cl = lb, ct = t;
        }
      }
      __syncwarp();
      const float4* src = reinterpret_cast<const float4*>(
          pages + (static_cast<size_t>(b) * n_tiles + mt) * 8 * tile_t);
      const int base = mt * tile_t;
#pragma unroll 2
      for (int s4 = lane; s4 < n4; s4 += 32) {
        float4 t[D];
#pragma unroll
        for (int j = 0; j < H; ++j) t[j] = __ldg(&src[j * n4 + s4]);
        float4 dq = make_float4(icp_diff2(t[0].x, qv[0]), icp_diff2(t[0].y, qv[0]),
                                icp_diff2(t[0].z, qv[0]), icp_diff2(t[0].w, qv[0]));
#pragma unroll
        for (int j = 1; j < H; ++j) icp_add_diff2(dq, t[j], qv[j]);
        if (!(icp_min4(dq) <= best)) continue;
        if (H < D) {
          // A partial sum only grows (every term >= 0, rounding is monotone).
#pragma unroll
          for (int j = H; j < D; ++j) t[j] = __ldg(&src[j * n4 + s4]);
#pragma unroll
          for (int j = H; j < D; ++j) icp_add_diff2(dq, t[j], qv[j]);
        }
        const int s = base + 4 * s4;
        take_min(best, bidx, dq.x, s);
        take_min(best, bidx, dq.y, s + 1);
        take_min(best, bidx, dq.z, s + 2);
        take_min(best, bidx, dq.w, s + 3);
      }
      merged = best;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        merged = fminf(merged, __shfl_xor_sync(0xffffffffu, merged, o));
    }
    // The (d2, index) merged over the lanes; nothing found: (radius, -1).
    unsigned long long key =
        bidx >= 0 ? (static_cast<unsigned long long>(__float_as_uint(best)) << 32) |
                        static_cast<uint32_t>(bidx)
                  : ~0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
      key = other < key ? other : key;
    }
    if (lane == 0) {
      const bool found = key != ~0ull;
      d2_out[row] = found ? __uint_as_float(static_cast<uint32_t>(key >> 32)) : r;
      idx_out[row] = found ? static_cast<int32_t>(static_cast<uint32_t>(key)) : -1;
    }
    __syncwarp();  // the lane bounds are no longer read
  }
}

template <int D>
static cudaError_t launch(const float* q, const float* radius, const float* pages,
                          const float* tmin, const float* tmax, float* d2, int32_t* idx,
                          void* ws, int B, int N, int n_tiles, int tile_t,
                          unsigned long long* counters, cudaStream_t s) {
  int* cnt = static_cast<int*>(ws);
  int* list =
      reinterpret_cast<int*>(static_cast<char*>(ws) + icp_align16(4 * static_cast<size_t>(B)));
  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * B, s);
  if (err != cudaSuccess) return err;
  visited_search_compact<<<dim3((N + VS_THREADS - 1) / VS_THREADS, B), VS_THREADS, 0, s>>>(
      radius, cnt, list, d2, idx, N, counters);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // Warps per CTA: as many as the tile-bound lists fit, at most VS_WARPS.
  const int warps = static_cast<int>(
      std::min<size_t>(VS_WARPS, VS_SMEM_MAX / (sizeof(float) * static_cast<size_t>(n_tiles))));
  const size_t smem = sizeof(float) * static_cast<size_t>(n_tiles) * warps;
  int sms = 0, per_sm = 0;
  if ((err = icp_launch_fit(visited_search_walk<D>, 32 * warps, smem, &sms, &per_sm)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // Enough warps for every row of the largest possible count, at most a full card.
  const long long rows = static_cast<long long>(B) * N;
  const long long grid =
      std::min<long long>((rows + warps - 1) / warps, static_cast<long long>(sms) * per_sm);
  visited_search_walk<D><<<static_cast<unsigned>(grid), 32 * warps, smem, s>>>(
      q, radius, pages, tmin, tmax, cnt, list, d2, idx, B, N, n_tiles, tile_t);
  return cudaGetLastError();
}

// counters: null, or one int64 counter of the live rows searched.
extern "C" int visited_search_launch(const float* q, const float* radius, const float* pages,
                                     const float* tmin, const float* tmax, float* d2,
                                     int32_t* idx, void* ws, long long ws_bytes, int B, int N,
                                     int n_tiles, int tile_t, unsigned long long* counters, int D,
                                     void* stream) {
  if (tile_t % 4 != 0 || tile_t < 4 || n_tiles < 1) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  // The tiled index fits an int; one warp's tile bounds fit the walk's shared memory.
  if (static_cast<long long>(n_tiles) * tile_t >= (1ll << 31) ||
      sizeof(float) * static_cast<size_t>(n_tiles) > VS_SMEM_MAX ||
      static_cast<long long>(workspace_bytes(B, N)) > ws_bytes)
    return cudaErrorInvalidValue;
  return static_cast<int>(ICP_DISPATCH_D(D, launch, q, radius, pages, tmin, tmax, d2, idx, ws, B,
                                         N, n_tiles, tile_t, counters,
                                         static_cast<cudaStream_t>(stream)));
}
