// Exact k nearest valid map slots per query, for NVIDIA Hopper (sm_90a).
//
// Replaces lidarslam_tpu/ops/pallas_knn.py::_knn_kernel (the TPU's fused
// bucketed k-NN). The TPU kernel kept a running minimum per lane bucket
// because its vector unit has no per-lane sort; here each lane of a warp
// owns one query and keeps an exact, sorted register list of its k best
// (d2, slot) pairs. Ties order by the lower slot, as the plain PyTorch
// version (and XLA's top_k) do, so on the same inputs the two agree bit
// for bit: the squared distance is dx*dx + dy*dy + dz*dz evaluated in that
// order with round-to-nearest intrinsics, which nvcc may not contract into
// FMAs.
//
// What bounds it on this card: instruction issue, not bytes. The map is
// 16 bytes a slot (1 MB at 65,536 slots) and sits in the 50 MB L2; what
// costs is 9 FP32 operations per (query, slot) pair that pruning keeps,
// and above all the sorted insert (~6 instructions per list entry), which
// a warp runs whenever any of its 32 lanes inserts. Tensor cores are no
// lever: the contraction depth is 3, TF32 would break the bit-equality
// with the plain scan, and after the distances the work is a selection,
// not a product. (A per-query bound on the k-th distance, taken in the
// plan from each query's nearest sub-block, cut the scan's and the merge's
// inserts but cost the plan more than it saved on the main path's maps, so
// it is not here.) The design:
//
//   1. knn_plan, one CTA per 32-query tile (queries arrive Morton-sorted,
//      dead ones last, so a tile is a compact cloud): lists, in slot
//      order, the 64-slot sub-blocks whose AABB lies within the prune
//      radius of the AABB of the tile's live queries.
//   2. knn_prefix, one CTA: the exclusive prefix of the lists' lengths, so
//      all tiles' sub-blocks form one sequence of N entries.
//   3. knn_scan<K>, a persistent grid sized from the card's occupancy (not
//      from the data): warp w of W takes entries [w N / W, (w+1) N / W) of
//      that sequence, so every warp gets the same number of sub-blocks
//      (to within one) however unevenly they fall on the tiles. A warp's
//      range crosses a few tile boundaries at most; for each tile it
//      touches it writes one partial sorted list per query to slot
//      (w + t) of a workspace, which is unique per (warp, tile). Within a
//      range the warp
//        - stages the next sub-block into a warp-private double buffer in
//          shared memory with cp.async (16 bytes a lane per copy) while
//          it scans the current one;
//        - skips a sub-block unless some live lane has a box distance to
//          it <= the radius and <= its current k-th distance (box distance
//          never exceeds a point's distance in the same rounded
//          arithmetic, so the second test loses nothing; an equal d2 with
//          a higher slot would not enter the list either);
//        - reads each slot once from shared memory as one broadcast
//          16-byte load for all 32 lanes, computes a run of 8 distances,
//          and inserts only behind warp votes that some lane's run, then
//          some lane's slot, beats its k-th distance.
//   4. knn_merge<K>, one CTA per tile: its 8 warps merge the tile's
//      partial lists in (d2, slot) order, loading each list whole, then
//      one warp merges the 8 results and writes the outputs by query row,
//      with the neighbours' coordinates.
// The order is a strict total order, so merging in any order gives the
// same lists, and nothing is handed out by atomics: repeated launches are
// bit-identical. No launch allocates, reads the host or synchronises; the
// grid sizes depend only on Q, the map's capacity and the card, so the
// sequence can be captured in a CUDA graph.
//
// Each kernel counts its own executions on the device: the first thread of
// its first CTA adds one to a per-kernel counter (knn_executions reads the
// four, knn_reset_executions clears them). A graph replay runs the same
// count, so a caller can tell exactly how often the kernels ran without
// relying on a profiler's trace, which can lose records under load.
//
// Interface: plain C, loaded with ctypes. All pointers are device pointers;
// the launches go on `stream` and the call returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 32;         // queries per tile: lane = query
constexpr int kSub = 64;          // map slots per sub-block (1 KB staged)
constexpr int kMaxK = 16;
constexpr int kPlanThreads = 256;
constexpr int kPlanWarps = kPlanThreads / 32;
constexpr int kPrefixThreads = 1024;
constexpr int kScanWarps = 8;     // warps per scan CTA
// scan CTAs per SM the registers must allow: 3 (24 warps) up to k = 12;
// k = 13-16 needs 2 to keep its 32-register list out of local memory
constexpr int scan_min_blocks(int k) { return k > 12 ? 2 : 3; }
constexpr int kMergeWarps = 8;    // warps per merge CTA
constexpr int kMinPerWarp = 4;    // fewest sub-blocks a scan warp is given

// executions of knn_plan, knn_prefix, knn_scan, knn_merge, in that order
__device__ unsigned long long g_executions[4];

__device__ __forceinline__ void count_execution(int kernel) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_executions[kernel], 1ULL);
}
constexpr int kRun = 8;           // distances computed before one vote
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Squared distance between the boxes [alo, ahi] and [blo, bhi] (a point is
// a box with lo == hi); never above the squared distance of two points in
// them, in the same rounded arithmetic.
__device__ __forceinline__ float box_d2(float alox, float aloy, float aloz,
                                        float ahix, float ahiy, float ahiz,
                                        const float4& blo, const float4& bhi) {
  const float gx = fmaxf(fmaxf(__fsub_rn(blo.x, ahix), __fsub_rn(alox, bhi.x)), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(blo.y, ahiy), __fsub_rn(aloy, bhi.y)), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(blo.z, ahiz), __fsub_rn(aloz, bhi.z)), 0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
}

// Insert (nd, ns) into the ascending list of one scan range, whose slots
// arrive in ascending order: entries with an equal distance stay ahead of
// it. Caller checks nd < d[K-1].
template <int K>
__device__ __forceinline__ void insert(float (&d)[K], int (&s)[K], float nd,
                                       int ns) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool move = nd < d[j - 1];          // entry j-1 shifts up into j
    const bool place = !move && nd < d[j];    // nd lands exactly at j
    d[j] = move ? d[j - 1] : (place ? nd : d[j]);
    s[j] = move ? s[j - 1] : (place ? ns : s[j]);
  }
  if (nd < d[0]) {
    d[0] = nd;
    s[0] = ns;
  }
}

// (ad, as) strictly before (bd, bs) in (d2, slot) order.
__device__ __forceinline__ bool before(float ad, int as, float bd, int bs) {
  return ad < bd || (ad == bd && as < bs);
}

// Insert in (d2, slot) order, for merging lists of any slot ranges.
template <int K>
__device__ __forceinline__ void insert_lex(float (&d)[K], int (&s)[K], float nd,
                                           int ns) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool move = before(nd, ns, d[j - 1], s[j - 1]);
    const bool place = !move && before(nd, ns, d[j], s[j]);
    d[j] = move ? d[j - 1] : (place ? nd : d[j]);
    s[j] = move ? s[j - 1] : (place ? ns : s[j]);
  }
  if (before(nd, ns, d[0], s[0])) {
    d[0] = nd;
    s[0] = ns;
  }
}

// Load a sorted list of K entries (stride 32 between them).
template <int K>
__device__ __forceinline__ void load_list(float (&cd)[K], int (&cs)[K], const float* ld,
                                          const int* ls) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    cd[j] = ld[j * kTile];
    cs[j] = ls[j * kTile];
  }
}

// Merge a loaded sorted list into (d, s), while some lane's next entry
// still enters.
template <int K>
__device__ __forceinline__ void merge_loaded(float (&d)[K], int (&s)[K],
                                             const float (&cd)[K], const int (&cs)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool in = before(cd[j], cs[j], d[K - 1], s[K - 1]);
    if (!__any_sync(kFull, in)) break;
    if (in) insert_lex<K>(d, s, cd[j], cs[j]);
  }
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// One sub-block into shared memory, 16 bytes a lane per copy.
__device__ __forceinline__ void stage(float4* dst, const float4* src, int lane) {
#pragma unroll
  for (int j = lane; j < kSub; j += kTile) cp_async16(dst + j, src + j);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The query of lane `lane` of tile `tile`: whether it is live, and its
// coordinates (0 when not).
struct Query {
  bool live;
  float x, y, z;
};

__device__ __forceinline__ Query load_query(const float* __restrict__ queries,
                                            const unsigned char* __restrict__ q_valid,
                                            const long long* __restrict__ order, int q,
                                            int tile, int lane) {
  const int t = tile * kTile + lane;
  const int row = t < q ? static_cast<int>(order[t]) : 0;
  Query r;
  r.live = t < q && q_valid[row] != 0;
  r.x = r.live ? queries[3 * row] : 0.f;
  r.y = r.live ? queries[3 * row + 1] : 0.f;
  r.z = r.live ? queries[3 * row + 2] : 0.f;
  return r;
}

// Scan warps that share the N sub-block entries: at most n_warps, and
// each gets at least kMinPerWarp (so every used warp's range is non-empty).
__device__ __forceinline__ int used_warps(int total, int n_warps) {
  return min(n_warps, (total + kMinPerWarp - 1) / kMinPerWarp);
}

// The warp whose range [w N / W, (w+1) N / W) holds entry g.
__device__ __forceinline__ int warp_of(int g, int total, int used) {
  return static_cast<int>(((static_cast<long long>(g) + 1) * used - 1) / total);
}

__device__ __forceinline__ int range_start(int w, int total, int used) {
  return static_cast<int>(static_cast<long long>(w) * total / used);
}

// One step of a block-wide ordered compaction: the threads with `keep`
// write `b`, in thread order, after the `done` entries of `out`. Returns
// the new length (the same in every thread).
__device__ __forceinline__ int compact(bool keep, int b, int* out, int done,
                                       int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned vote = __ballot_sync(kFull, keep);
  if (lane == 0) s_warp[warp] = __popc(vote);
  __syncthreads();
  int off = done, sum = 0;
#pragma unroll
  for (int w = 0; w < kPlanWarps; ++w) {
    off += w < warp ? s_warp[w] : 0;
    sum += s_warp[w];
  }
  if (keep) out[off + __popc(vote & ((1u << lane) - 1u))] = b;
  __syncthreads();  // s_warp is rewritten by the next step; `out` is visible
  return done + sum;
}

// ---------------------------------------------------------------------------
// 1. per tile: the sub-blocks within the prune radius of the tile's AABB
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kPlanThreads)
knn_plan(const float4* __restrict__ sub_lo, const float4* __restrict__ sub_hi,
         int n_sub, const float* __restrict__ queries,
         const unsigned char* __restrict__ q_valid, const long long* __restrict__ order,
         int q, float r2, int* __restrict__ work, int* __restrict__ count) {
  __shared__ float s_box[6];
  __shared__ int s_warp[kPlanWarps];
  count_execution(0);
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    const Query qu = load_query(queries, q_valid, order, q, tile, lane);
    const float lox = warp_min(qu.live ? qu.x : CUDART_INF_F);
    const float loy = warp_min(qu.live ? qu.y : CUDART_INF_F);
    const float loz = warp_min(qu.live ? qu.z : CUDART_INF_F);
    const float hix = warp_max(qu.live ? qu.x : -CUDART_INF_F);
    const float hiy = warp_max(qu.live ? qu.y : -CUDART_INF_F);
    const float hiz = warp_max(qu.live ? qu.z : -CUDART_INF_F);
    if (lane == 0) {
      s_box[0] = lox; s_box[1] = loy; s_box[2] = loz;
      s_box[3] = hix; s_box[4] = hiy; s_box[5] = hiz;
    }
  }
  __syncthreads();
  const float lox = s_box[0], loy = s_box[1], loz = s_box[2];
  const float hix = s_box[3], hiy = s_box[4], hiz = s_box[5];
  int* out = work + static_cast<long long>(tile) * n_sub;
  int total = 0;  // the same in every thread
  if (lox <= hix) {  // the tile has a live query
    for (int base = 0; base < n_sub; base += kPlanThreads) {
      const int b = base + threadIdx.x;
      bool keep = false;
      if (b < n_sub) {
        const float4 lo = sub_lo[b], hi = sub_hi[b];
        keep = lo.x <= hi.x &&  // the sub-block holds a valid slot
               box_d2(lox, loy, loz, hix, hiy, hiz, lo, hi) <= r2;
      }
      total = compact(keep, b, out, total, s_warp);
    }
  }
  if (threadIdx.x == 0) count[tile] = total;
}

// ---------------------------------------------------------------------------
// 2. start[t] = sum of count[0..t), start[n_tiles] = N
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kPrefixThreads)
knn_prefix(const int* __restrict__ count, int n_tiles, int* __restrict__ start) {
  __shared__ int s_warp[kPrefixThreads / 32];
  __shared__ int s_carry;
  count_execution(1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  for (int base = 0; base < n_tiles; base += kPrefixThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n_tiles ? count[i] : 0;
    int x = v;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    const int excl = s_carry + (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
    if (i < n_tiles) start[i] = excl;
    __syncthreads();  // every thread has read s_carry
    if (threadIdx.x == kPrefixThreads - 1) s_carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) start[n_tiles] = s_carry;
}

// ---------------------------------------------------------------------------
// 3. balanced scan: partial top-k lists per (warp, tile)
// ---------------------------------------------------------------------------
template <int K>
__global__ void __launch_bounds__(kScanWarps * 32, scan_min_blocks(K))
knn_scan(const float4* __restrict__ pts, const float4* __restrict__ sub_lo,
         const float4* __restrict__ sub_hi, int n_sub,
         const float* __restrict__ queries, const unsigned char* __restrict__ q_valid,
         const long long* __restrict__ order, int q, int n_tiles, float r2,
         const int* __restrict__ work, const int* __restrict__ start, int n_warps,
         float* __restrict__ part_d2, int* __restrict__ part_slot,
         int* __restrict__ stats) {
  __shared__ __align__(16) float4 ring[kScanWarps][2][kSub];
  __shared__ int s_stats[2];
  count_execution(2);
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_stats[0] = 0;
    s_stats[1] = 0;
  }
  __syncthreads();

  const int total = start[n_tiles];
  const int used = used_warps(total, n_warps);
  const int w = wib * gridDim.x + blockIdx.x;  // used warps spread over every CTA
  int assigned = 0, scanned = 0;
  if (w < used) {
    const int g0 = range_start(w, total, used);
    const int g1 = range_start(w + 1, total, used);
    assigned = g1 - g0;
    // the tile holding g0: the last t with start[t] <= g0
    int t = 0, hi = n_tiles - 1;
    while (t < hi) {
      const int mid = (t + hi + 1) >> 1;
      if (start[mid] <= g0) t = mid; else hi = mid - 1;
    }
    float4(*buf)[kSub] = ring[wib];
    int g = g0;
    while (g < g1) {
      const int t0 = start[t];
      const int e = min(g1, start[t + 1]);
      const int n = e - g;
      const int* ids = work + static_cast<long long>(t) * n_sub + (g - t0);
      const Query qu = load_query(queries, q_valid, order, q, t, lane);

      float d[K];
      int s[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        d[j] = CUDART_INF_F;
        s[j] = 0;
      }
      int sb = ids[0];
      stage(buf[0], pts + static_cast<long long>(sb) * kSub, lane);
      cp_async_commit();
      float4 lo = sub_lo[sb], hi4 = sub_hi[sb];
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        int nsb = sb;
        float4 nlo = lo, nhi = hi4;
        if (i + 1 < n) {  // stage the next sub-block while this one is scanned
          nsb = ids[i + 1];
          stage(buf[(i + 1) & 1], pts + static_cast<long long>(nsb) * kSub, lane);
          nlo = sub_lo[nsb];
          nhi = sub_hi[nsb];
        }
        cp_async_commit();  // possibly empty: the wait below stays uniform
        const float box = box_d2(qu.x, qu.y, qu.z, qu.x, qu.y, qu.z, lo, hi4);
        const bool need = qu.live && box <= r2 && box <= d[K - 1];
        cp_async_wait_prev();
        __syncwarp();
        if (__any_sync(kFull, need)) {
          ++scanned;
          const float4* sp = buf[i & 1];
          const int base = sb * kSub;
#pragma unroll 1
          for (int j0 = 0; j0 < kSub; j0 += kRun) {
            float dd[kRun];
            float m = CUDART_INF_F;
#pragma unroll
            for (int u = 0; u < kRun; ++u) {
              const float4 p = sp[j0 + u];
              dd[u] = sq_dist(qu.x, qu.y, qu.z, p.x, p.y, p.z);
              m = fminf(m, dd[u]);
            }
            if (__any_sync(kFull, qu.live && m < d[K - 1])) {
#pragma unroll
              for (int u = 0; u < kRun; ++u) {
                const bool in = qu.live && dd[u] < d[K - 1];
                if (__any_sync(kFull, in) && in) insert<K>(d, s, dd[u], base + j0 + u);
              }
            }
          }
        }
        __syncwarp();  // every lane is done with this buffer before it is refilled
        sb = nsb;
        lo = nlo;
        hi4 = nhi;
      }

      // the partial lists, entry-major so that a warp's stores coalesce
      const long long p = static_cast<long long>(w + t) * K * kTile;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        part_d2[p + j * kTile + lane] = d[j];
        part_slot[p + j * kTile + lane] = s[j];
      }
      g = e;
      ++t;
      while (g < g1 && start[t + 1] <= g) ++t;  // past tiles with no entry
    }
  }
  if (lane == 0) {
    atomicAdd_block(&s_stats[0], assigned);
    atomicAdd_block(&s_stats[1], scanned);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    stats[2 * blockIdx.x] = s_stats[0];
    stats[2 * blockIdx.x + 1] = s_stats[1];
  }
}

// ---------------------------------------------------------------------------
// 4. per tile: merge the partial lists, write the outputs by query row
// ---------------------------------------------------------------------------
template <int K>
__global__ void __launch_bounds__(kMergeWarps * 32)
knn_merge(const float4* __restrict__ pts, const long long* __restrict__ order, int q,
          int n_tiles, const int* __restrict__ start, int n_warps,
          const float* __restrict__ part_d2, const int* __restrict__ part_slot,
          float* __restrict__ out_d2, int* __restrict__ out_idx,
          float* __restrict__ out_nbr) {
  __shared__ float s_d[kMergeWarps][K][kTile];
  __shared__ int s_s[kMergeWarps][K][kTile];
  count_execution(3);
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int total = start[n_tiles];
  const int a = start[t], b = start[t + 1];

  float d[K];
  int s[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    d[j] = CUDART_INF_F;
    s[j] = 0;
  }
  if (a < b) {
    // warp wib takes the partial lists of scan warps w0 + wib, + 8, ...,
    // loading the next one while it merges this one
    const int used = used_warps(total, n_warps);
    const int w1 = warp_of(b - 1, total, used);
    const float* pd = part_d2 + static_cast<long long>(t) * K * kTile + lane;
    const int* ps = part_slot + static_cast<long long>(t) * K * kTile + lane;
    int w = warp_of(a, total, used) + wib;
    float cd[K], nd[K];
    int cs[K], ns[K];
    if (w <= w1) load_list<K>(cd, cs, pd + w * K * kTile, ps + w * K * kTile);
    for (; w <= w1; w += kMergeWarps) {
      const int wn = w + kMergeWarps;
      if (wn <= w1) load_list<K>(nd, ns, pd + wn * K * kTile, ps + wn * K * kTile);
      merge_loaded<K>(d, s, cd, cs);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        cd[j] = nd[j];
        cs[j] = ns[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    s_d[wib][j][lane] = d[j];
    s_s[wib][j][lane] = s[j];
  }
  __syncthreads();
  if (wib != 0) return;
#pragma unroll 1
  for (int o = 1; o < kMergeWarps; ++o) {
    float cd[K];
    int cs[K];
    load_list<K>(cd, cs, &s_d[o][0][lane], &s_s[o][0][lane]);
    merge_loaded<K>(d, s, cd, cs);
  }

  const int tq = t * kTile + lane;
  if (tq >= q) return;
  const int row = static_cast<int>(order[tq]);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool found = d[j] < CUDART_INF_F;
    const long long o = static_cast<long long>(row) * K + j;
    const float4 p = found ? pts[s[j]] : make_float4(0.f, 0.f, 0.f, 0.f);
    out_d2[o] = d[j];
    out_idx[o] = found ? s[j] : 0;
    out_nbr[3 * o] = p.x;
    out_nbr[3 * o + 1] = p.y;
    out_nbr[3 * o + 2] = p.z;
  }
}

template <int K>
int scan_ctas_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, knn_scan<K>, kScanWarps * 32, 0)
      != cudaSuccess)
    return 0;
  return n;
}

template <int K>
void launch(const float4* pts, const float4* sub_lo, const float4* sub_hi, int n_sub,
            const float* queries, const unsigned char* q_valid, const long long* order,
            int q, float r2, int* work, int* count, int* start, int n_warps,
            float* part_d2, int* part_slot, int* stats, float* out_d2, int* out_idx,
            float* out_nbr, cudaStream_t st) {
  const int n_tiles = (q + kTile - 1) / kTile;
  knn_plan<<<n_tiles, kPlanThreads, 0, st>>>(sub_lo, sub_hi, n_sub, queries, q_valid,
                                             order, q, r2, work, count);
  knn_prefix<<<1, kPrefixThreads, 0, st>>>(count, n_tiles, start);
  knn_scan<K><<<n_warps / kScanWarps, kScanWarps * 32, 0, st>>>(
      pts, sub_lo, sub_hi, n_sub, queries, q_valid, order, q, n_tiles, r2, work,
      start, n_warps, part_d2, part_slot, stats);
  knn_merge<K><<<n_tiles, kMergeWarps * 32, 0, st>>>(
      pts, order, q, n_tiles, start, n_warps, part_d2, part_slot, out_d2, out_idx,
      out_nbr);
}

}  // namespace

extern "C" int knn_sub_block() { return kSub; }

// The four kernels' device execution counts into out[4] (host memory), on
// the current device; waits for the device first.
extern "C" int knn_executions(unsigned long long* out) {
  cudaError_t rc = cudaDeviceSynchronize();
  if (rc == cudaSuccess) rc = cudaMemcpyFromSymbol(out, g_executions, sizeof(g_executions));
  return static_cast<int>(rc);
}

extern "C" int knn_reset_executions() {
  const unsigned long long zero[4] = {0, 0, 0, 0};
  cudaError_t rc = cudaDeviceSynchronize();
  if (rc == cudaSuccess) rc = cudaMemcpyToSymbol(g_executions, zero, sizeof(zero));
  return static_cast<int>(rc);
}
extern "C" int knn_tile() { return kTile; }
extern "C" int knn_max_k() { return kMaxK; }
extern "C" int knn_scan_warps_per_cta() { return kScanWarps; }

// Warps in the scan grid for this k on the current device: as many scan
// CTAs as fit on every SM at once. 0 on error.
extern "C" int knn_grid_warps(int k) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
#define KNN_OCC(K_) \
  case K_:          \
    per_sm = scan_ctas_per_sm<K_>(); \
    break;
  switch (k) {
    KNN_OCC(1) KNN_OCC(2) KNN_OCC(3) KNN_OCC(4) KNN_OCC(5) KNN_OCC(6)
    KNN_OCC(7) KNN_OCC(8) KNN_OCC(9) KNN_OCC(10) KNN_OCC(11) KNN_OCC(12)
    KNN_OCC(13) KNN_OCC(14) KNN_OCC(15) KNN_OCC(16)
    default:
      return 0;
  }
#undef KNN_OCC
  return sms * per_sm * kScanWarps;
}

// pts: (n_sub * knn_sub_block(), 4) map slots as x, y, z, 0, with +inf
// coordinates where the slot is invalid or padding. sub_lo/sub_hi:
// (n_sub, 4) AABBs of each sub-block's valid slots (+inf/-inf when it has
// none). queries: (q, 3). q_valid: (q,) 0/1. order: (q,) int64, the query rows in
// scan order (Morton, dead last). r2: squared prune radius (+inf: no
// pruning). Workspace, with n_tiles = ceil(q / knn_tile()): work
// (n_tiles * n_sub,), count (n_tiles,), start (n_tiles + 1,), part_d2 and
// part_slot ((n_warps + n_tiles) * k * knn_tile(),) each, stats (2 * n_warps / knn_scan_warps_per_cta(),): per
// scan CTA, the sub-blocks it was given and those it scanned. n_warps:
// knn_grid_warps(k). Outputs are indexed by query row: out_d2 (q, k),
// out_idx (q, k), out_nbr (q, k, 3).
extern "C" int knn_launch(const void* pts, const void* sub_lo, const void* sub_hi,
                          int n_sub, const float* queries,
                          const unsigned char* q_valid, const long long* order, int q,
                          int k, float r2, int* work, int* count, int* start,
                          int n_warps, float* part_d2, int* part_slot, int* stats,
                          float* out_d2, int* out_idx, float* out_nbr, void* stream) {
  if (q <= 0) return static_cast<int>(cudaGetLastError());
  if (n_warps <= 0 || n_warps % kScanWarps != 0 || n_sub <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* p4 = static_cast<const float4*>(pts);
  const float4* lo4 = static_cast<const float4*>(sub_lo);
  const float4* hi4 = static_cast<const float4*>(sub_hi);
#define KNN_CASE(K_)                                                              \
  case K_:                                                                        \
    launch<K_>(p4, lo4, hi4, n_sub, queries, q_valid, order, q, r2, work, count,  \
               start, n_warps, part_d2, part_slot, stats, out_d2, out_idx,        \
               out_nbr, st);                                                      \
    break;
  switch (k) {
    KNN_CASE(1) KNN_CASE(2) KNN_CASE(3) KNN_CASE(4) KNN_CASE(5) KNN_CASE(6)
    KNN_CASE(7) KNN_CASE(8) KNN_CASE(9) KNN_CASE(10) KNN_CASE(11) KNN_CASE(12)
    KNN_CASE(13) KNN_CASE(14) KNN_CASE(15) KNN_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KNN_CASE
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Stage markers: empty kernels whose names carry a stage's ends into a device
// trace, inside a captured graph too, where the host's spans cannot split
// the replay's device time. They do no work (one thread, ~1.5 us a launch).
// ---------------------------------------------------------------------------
extern "C" __global__ void slam_mark_ego_begin() {}
extern "C" __global__ void slam_mark_ego_end() {}
extern "C" __global__ void slam_mark_extract_begin() {}
extern "C" __global__ void slam_mark_extract_end() {}

// Launch marker `which` (0: slam_mark_ego_begin, 1: slam_mark_ego_end,
// 2: slam_mark_extract_begin, 3: slam_mark_extract_end) on `stream`; a
// cudaError code, 0 on success.
extern "C" int slam_mark(int which, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0:
      slam_mark_ego_begin<<<1, 1, 0, st>>>();
      break;
    case 1:
      slam_mark_ego_end<<<1, 1, 0, st>>>();
      break;
    case 2:
      slam_mark_extract_begin<<<1, 1, 0, st>>>();
      break;
    case 3:
      slam_mark_extract_end<<<1, 1, 0, st>>>();
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
