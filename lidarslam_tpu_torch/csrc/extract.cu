// Keypoint labelling of one sweep on Hopper: one CTA per ring.
//
// Replaces no TPU kernel. On the TPU the extractor's stencils
// (lidarslam_tpu/ops/extractor.py) are jnp code that XLA fuses into a few
// loops; the port's torch form of them (ops/extractor.py::label_grids) runs
// each shift, window and NMS round as its own launch, ~4.5k a sweep. This
// kernel does the whole labelling of a sweep in one launch, in the torch
// form's order, and leaves the compaction to the torch code after it.
//
// Bound: it reads xyz, intensity and validity (17 B a slot) and writes five
// label grids and four score grids (21 B a slot): ~1.2 MB for 16 x 2048
// slots, ~5 MB for 64 x 2048, 0.4-1.5 us at 3.35 TB/s. The work is a few
// thousand flops a valid slot (three closed-form 3x3 eigenproblems), so the
// kernel is bound by its latency: a ring's stages follow each other inside
// one CTA, the slots in shared memory, with a barrier between stages and a
// few per NMS round.
//
// Every stage is independent per ring: CTA r loads ring r's slots into
// shared memory, then
//   1. n_ring (a block count of `valid`), `core`, the range and the
//      squared step to the next slot;
//   2. the occlusion invalidation (forward and backward runs) and the
//      point validity;
//   3. per valid slot, the two side line fits, their consistency and
//      accuracy, sin_angle, depth_gap, the far runs and their line fit for
//      saliency, and intensity_gap (ported from core/pca.py: masked_cov6,
//      eigh6, _eigvec6, restricted to the direction line_fit returns);
//   4. the four edge NMS passes chained through the edge validity, then
//      the plane pass; each a fixpoint of at most `rounds` rounds over
//      +-w windows (ties break toward the smaller column), left once no
//      candidate is left, after which the torch form's rounds are no-ops;
//   5. the label, validity and score grids out.
//
// Rounding: the torch form runs one ATen kernel per operation, so every
// product and sum is rounded on its own. Here every operation is an
// explicit round-to-nearest intrinsic, so nvcc contracts nothing into an
// FMA, and each composite ATen operation is written in the order its CUDA
// kernel takes: torch.sum over a short last dimension adds lane partials in
// a shuffle tree (asum), torch.linalg.cross fuses its first product
// (lcross), and a tensor divided by a Python float is multiplied by the
// float's reciprocal. The labels and scores then equal the torch form's on
// the same card.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;   // threads per CTA (one CTA per ring)
constexpr int kMaxW = 8;        // largest neighbor_width instantiated
constexpr int kMaxC = 4096;     // most slots per ring (shared memory sizing)
// shared memory per slot: 9 float planes, 5 byte planes
constexpr int kSlotBytes = 9 * 4 + 5;

// the torch form's constants, rounded from double as ATen casts a Python
// float for a float32 tensor
constexpr float kNeg = static_cast<float>(-3.0e38);
constexpr float kEps = static_cast<float>(1e-12);
constexpr float kMinPosDiff = static_cast<float>(0.02);
constexpr float kMinDepthGap = static_cast<float>(1.5);
constexpr float kMinPlaneSin = static_cast<float>(1e-6);
// x / 3.0 and x / 6.0 on a CUDA tensor: x * (1.0f / 3.0f), x * (1.0f / 6.0f)
constexpr float kThird = 1.0f / 3.0f;
constexpr float kSixth = 1.0f / 6.0f;

// label planes (out), in order
enum { kEdge = 0, kPlane, kBlob, kPointValid, kEdgeValidity };
// score planes (out), in order
enum { kSinAngle = 0, kSaliency, kDepthGap, kIntensityGap, kScores };
// bits of the per-slot flag byte
enum : uint8_t { kValid = 1, kFwd = 2, kBwd = 4, kPv = 8, kValidEdge = 16, kLabelEdge = 32 };

__device__ unsigned long long g_extract_executions = 0;

}  // namespace

// The launch's arguments, laid out as ops/cuda_extract.py's _Args.
struct ExtractArgs {
  const float* xyz;              // (R, C, 3) by xyz_stride
  const float* intensity;        // (R, C) by intensity_stride
  const unsigned char* valid;    // (R, C) 0/1 by valid_stride
  const float* az;               // device scalar, or null: az_value
  unsigned char* labels;         // (5, R, C) out, contiguous
  float* scores;                 // (4, R, C) out, contiguous
  long long xyz_stride[3];       // elements
  long long intensity_stride[2];
  long long valid_stride[2];
  int R, C, W, rounds, blob_stride;
  float az_value;
  float angle_beam_normal;       // radians
  float min_distance;
  float max_sin;                 // sin(line_max_angle)
  float sq_line_max_distance;
  float sq_dist_line_threshold;
  float depth_gap_threshold;     // squared
  float sin_angle_threshold;
  float saliency_threshold;      // squared
  float intensity_gap_threshold;
  float plane_threshold;
};

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ bool isnan_(float a) { return a != a; }
// torch.maximum / torch.minimum: NaN in, NaN out
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fminf(a, b));
}
// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan_(x) ? x : fmaxf(x, lo);
}

__host__ __device__ constexpr int pow2_floor(int n) {
  return n < 2 ? 1 : 2 * pow2_floor(n / 2);
}

// torch.sum(v, dim=-1) over a last dimension of N on the card: N / 2 < bw
// <= N lanes, lane t holding v[t] + v[t + bw], then a shuffle tree over the
// lanes with decreasing offsets (bw / 2, ..., 2, 1), as ATen's block_x_reduce.
template <int N>
__device__ __forceinline__ float asum(const float (&v)[N]) {
  constexpr int bw = pow2_floor(N);
  float lane[bw];
#pragma unroll
  for (int t = 0; t < bw; ++t) lane[t] = (t + bw < N) ? fa(v[t], v[t + bw]) : v[t];
#pragma unroll
  for (int off = bw / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int t = 0; t < off; ++t) lane[t] = fa(lane[t], lane[t + off]);
  }
  return lane[0];
}

// torch.sum(v * v, dim=-1) over xyz
__device__ __forceinline__ float sq3(V3 v) {
  const float p[3] = {fm(v.x, v.x), fm(v.y, v.y), fm(v.z, v.z)};
  return asum<3>(p);
}

__device__ __forceinline__ float norm3(V3 v) { return sqrtf(sq3(v)); }

__device__ __forceinline__ V3 sub3(V3 a, V3 b) {
  return {fs(a.x, b.x), fs(a.y, b.y), fs(a.z, b.z)};
}

// torch.linalg.cross on the card: a_i b_j - a_j b_i with the first product
// fused into the subtraction
__device__ __forceinline__ V3 lcross(V3 a, V3 b) {
  return {__fmaf_rn(a.y, b.z, -fm(a.z, b.y)), __fmaf_rn(a.z, b.x, -fm(a.x, b.z)),
          __fmaf_rn(a.x, b.y, -fm(a.y, b.x))};
}

// core/pca._cross: six elementwise operations, each rounded
__device__ __forceinline__ V3 ecross(float ax, float ay, float az, float bx, float by,
                                     float bz) {
  return {fs(fm(ay, bz), fm(az, by)), fs(fm(az, bx), fm(ax, bz)), fs(fm(ax, by), fm(ay, bx))};
}

// extractor.unit: v / clamp(|v|, min=1e-12)
__device__ __forceinline__ V3 unit(V3 v) {
  const float n = clamp_min(norm3(v), kEps);
  return {fd(v.x, n), fd(v.y, n), fd(v.z, n)};
}

// pca.sq_dist_to_line
__device__ __forceinline__ float sq_dist_to_line(V3 p, V3 pos, V3 dir) {
  return sq3(lcross(sub3(p, pos), dir));
}

__device__ __forceinline__ float dot_rows(V3 c) {
  return fa(fa(fm(c.x, c.x), fm(c.y, c.y)), fm(c.z, c.z));
}

// pca._eigvec6: unit eigenvector of the scaled matrix for eigenvalue lam
__device__ V3 eigvec6(float a00, float a01, float a02, float a11, float a12, float a22,
                      float lam) {
  const float m00 = fs(a00, lam), m11 = fs(a11, lam), m22 = fs(a22, lam);
  const V3 c01 = ecross(m00, a01, a02, a01, m11, a12);
  const V3 c02 = ecross(m00, a01, a02, a02, a12, m22);
  const V3 c12 = ecross(a01, m11, a12, a02, a12, m22);
  const float n01 = dot_rows(c01), n02 = dot_rows(c02), n12 = dot_rows(c12);
  const bool use01 = (n01 >= n02) && (n01 >= n12);
  const bool use02 = n02 >= n12;
  const V3 v = use01 ? c01 : (use02 ? c02 : c12);
  const float n = sqrtf(dot_rows(v));
  if (!(n > kEps)) return {1.0f, 0.0f, 0.0f};
  const float inv = fd(1.0f, clamp_min(n, kEps));
  return {fm(v.x, inv), fm(v.y, inv), fm(v.z, inv)};
}

// pca.eigh6's eigenvector of the largest eigenvalue (v2, what line_fit
// returns as the direction), in eigh6's own operations
__device__ V3 line_direction(float c00, float c01, float c02, float c11, float c12,
                             float c22) {
  float scale = tmax(tmax(tmax(fabsf(c00), fabsf(c11)), fabsf(c22)),
                     tmax(tmax(fabsf(c01), fabsf(c02)), fabsf(c12)));
  scale = clamp_min(scale, kEps);
  const float a00 = fd(c00, scale), a01 = fd(c01, scale), a02 = fd(c02, scale);
  const float a11 = fd(c11, scale), a12 = fd(c12, scale), a22 = fd(c22, scale);

  const float p1 = fa(fa(fm(a01, a01), fm(a02, a02)), fm(a12, a12));
  const bool is_diag = p1 < kEps;
  if (is_diag) {
    // identity column of the largest diagonal entry (stable: the higher
    // index wins a tie)
    const int i_hi = (a22 >= a00 && a22 >= a11) ? 2 : (a11 >= a00 ? 1 : 0);
    return {i_hi == 0 ? 1.0f : 0.0f, i_hi == 1 ? 1.0f : 0.0f, i_hi == 2 ? 1.0f : 0.0f};
  }
  const float q = fm(fa(fa(a00, a11), a22), kThird);
  const float d0 = fs(a00, q), d1 = fs(a11, q), d2 = fs(a22, q);
  const float p2 = fa(fa(fa(fm(d0, d0), fm(d1, d1)), fm(d2, d2)), fm(2.0f, p1));
  const float p = sqrtf(clamp_min(fm(p2, kSixth), 0.0f));
  const float safe_p = clamp_min(p, kEps);
  const float b00 = fd(d0, safe_p), b11 = fd(d1, safe_p), b22 = fd(d2, safe_p);
  const float b01 = fd(a01, safe_p), b02 = fd(a02, safe_p), b12 = fd(a12, safe_p);
  const float det_b = fa(fs(fm(b00, fs(fm(b11, b22), fm(b12, b12))),
                            fm(b01, fs(fm(b01, b22), fm(b12, b02)))),
                         fm(b02, fs(fm(b01, b12), fm(b11, b02))));
  const float r = tmin(tmax(fm(det_b, 0.5f), -1.0f), 1.0f);
  const float phi = fm(acosf(r), kThird);
  const float lam_hi = fa(q, fm(fm(2.0f, p), cosf(phi)));
  return eigvec6(a00, a01, a02, a11, a12, a22, lam_hi);
}

// A ring's slots in shared memory.
struct Ring {
  float *x, *y, *z, *L, *sq_next;
  float* score[kScores];
  uint8_t *flag, *cand, *mark, *peak, *sel;
  int C;

  __device__ V3 at(int c) const { return {x[c], y[c], z[c]}; }
  // torch form's squared occlusion threshold of slot i
  __device__ float sq_thr(int i, float coeff) const {
    const float m = clamp_min(fm(L[i], coeff), kMinPosDiff);
    return fm(m, m);
  }
};

// extractor.side_fit on the W neighbours of slot c on one side (step -1:
// left, +1: right), near to far
template <int W>
__device__ void side_fit(const Ring& g, int c, int step, float max_sin, float sq_line_max,
                         V3& pos, V3& dir, bool& flat) {
  const V3 chord = unit(sub3(g.at(c + step * W), g.at(c + step)));
  bool consistent = true;
#pragma unroll
  for (int k = 0; k + 1 < W; ++k) {
    const V3 seg = unit(sub3(g.at(c + step * (k + 2)), g.at(c + step * (k + 1))));
    consistent = consistent && (norm3(lcross(chord, seg)) <= max_sin);
  }
  // pca.line_fit with every neighbour counted (masked_cov6, mask of ones)
  const float denom = static_cast<float>(W);
  float vx[W], vy[W], vz[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = c + step * (k + 1);
    vx[k] = g.x[j];
    vy[k] = g.y[j];
    vz[k] = g.z[j];
  }
  pos = {fd(asum<W>(vx), denom), fd(asum<W>(vy), denom), fd(asum<W>(vz), denom)};
  float cx[W], cy[W], cz[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    cx[k] = fs(vx[k], pos.x);
    cy[k] = fs(vy[k], pos.y);
    cz[k] = fs(vz[k], pos.z);
  }
  float t[W];
  float c6[6];
#pragma unroll
  for (int e = 0; e < 6; ++e) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float a = e < 3 ? cx[k] : (e < 5 ? cy[k] : cz[k]);
      const float b = (e == 0) ? cx[k] : (e == 1 || e == 3) ? cy[k] : cz[k];
      t[k] = fm(a, b);
    }
    c6[e] = fd(asum<W>(t), denom);
  }
  dir = line_direction(c6[0], c6[1], c6[2], c6[3], c6[4], c6[5]);
  float d2max = kNeg;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float d2 = sq_dist_to_line(V3{vx[k], vy[k], vz[k]}, pos, dir);
    d2max = k == 0 ? d2 : tmax(d2max, d2);
  }
  flat = consistent && (d2max <= sq_line_max);
}

// extractor.far_run: which of the W neighbours on one side enter the far
// fit (bit k for neighbour k)
template <int W>
__device__ unsigned far_run(const Ring& g, int c, int step, float sq_depth) {
  unsigned incl = 0;
  bool flag = false, stopped = false;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const bool fk = fabsf(fs(sq3(g.at(c + step * (k + 1))), sq_depth)) > kMinDepthGap;
    if (fk && !stopped) incl |= 1u << k;
    stopped = stopped || (flag && !fk);
    flag = flag || fk;
  }
  return incl;
}

// The four scores of valid slot c (the neighbours on both sides exist: a
// valid slot is a core slot)
template <int W>
__device__ void slot_scores(const Ring& g, const float* inten, long long i_step, int c,
                            const ExtractArgs& a, float out[kScores]) {
  const V3 p = g.at(c);
  V3 lpos, ldir, rpos, rdir;
  bool lflat, rflat;
  side_fit<W>(g, c, -1, a.max_sin, a.sq_line_max_distance, lpos, ldir, lflat);
  side_fit<W>(g, c, +1, a.max_sin, a.sq_line_max_distance, rpos, rdir, rflat);
  const float dl_pt = sq_dist_to_line(p, lpos, ldir);
  const float dr_pt = sq_dist_to_line(p, rpos, rdir);

  const bool both = lflat && rflat;
  const bool angle_ok = both && (dl_pt < a.sq_dist_line_threshold) &&
                        (dr_pt < a.sq_dist_line_threshold);
  out[kSinAngle] = angle_ok ? norm3(lcross(ldir, rdir)) : 0.0f;

  float dist_left = both ? dl_pt : 0.0f;
  float dist_right = both ? dr_pt : 0.0f;
  if (!lflat && rflat) {
    float m = 0.0f;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float d = sq_dist_to_line(g.at(c - (k + 1)), rpos, rdir);
      m = k == 0 ? d : tmin(m, d);
    }
    dist_left = fm(0.25f, m);
  }
  if (lflat && !rflat) {
    float m = 0.0f;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float d = sq_dist_to_line(g.at(c + k + 1), lpos, ldir);
      m = k == 0 ? d : tmin(m, d);
    }
    dist_right = fm(0.25f, m);
  }
  out[kDepthGap] = tmax(dist_left, dist_right);

  // saliency: neither side flat, a far run of more than W neighbours,
  // fitted by pca.line_fit under the mask (left near to far, then right)
  out[kSaliency] = 0.0f;
  if (!lflat && !rflat) {
    const float sq_depth = fm(g.L[c], g.L[c]);
    const unsigned incl = far_run<W>(g, c, -1, sq_depth) |
                          (far_run<W>(g, c, +1, sq_depth) << W);
    const int count = __popc(incl);
    if (count > W) {
      constexpr int N = 2 * W;
      float m[N], vx[N], vy[N], vz[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int j = k < W ? c - (k + 1) : c + (k - W + 1);
        m[k] = (incl >> k) & 1u ? 1.0f : 0.0f;
        vx[k] = g.x[j];
        vy[k] = g.y[j];
        vz[k] = g.z[j];
      }
      const float denom = static_cast<float>(count);
      float t[N];
      V3 mean;
#pragma unroll
      for (int k = 0; k < N; ++k) t[k] = fm(vx[k], m[k]);
      mean.x = fd(asum<N>(t), denom);
#pragma unroll
      for (int k = 0; k < N; ++k) t[k] = fm(vy[k], m[k]);
      mean.y = fd(asum<N>(t), denom);
#pragma unroll
      for (int k = 0; k < N; ++k) t[k] = fm(vz[k], m[k]);
      mean.z = fd(asum<N>(t), denom);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        vx[k] = fm(fs(vx[k], mean.x), m[k]);
        vy[k] = fm(fs(vy[k], mean.y), m[k]);
        vz[k] = fm(fs(vz[k], mean.z), m[k]);
      }
      float c6[6];
#pragma unroll
      for (int e = 0; e < 6; ++e) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float u = e < 3 ? vx[k] : (e < 5 ? vy[k] : vz[k]);
          const float w = (e == 0) ? vx[k] : (e == 1 || e == 3) ? vy[k] : vz[k];
          t[k] = fm(u, w);
        }
        c6[e] = fd(asum<N>(t), denom);
      }
      const V3 fdir = line_direction(c6[0], c6[1], c6[2], c6[3], c6[4], c6[5]);
      out[kSaliency] = sq_dist_to_line(p, mean, fdir);
    }
  }
  out[kIntensityGap] = fabsf(fs(inten[(c + 1) * i_step], inten[(c - 1) * i_step]));
}

// One NMS fixpoint (extractor._nms) over the candidates in g.cand: at most
// `rounds` rounds, each selecting every candidate that dominates its +-w
// window (ties toward the smaller column) and suppressing the selections'
// +-w neighbourhoods. The selections land in g.sel. Every thread calls it.
__device__ void nms(const Ring& g, const float* score, int w, int rounds, bool minimize) {
  const int C = g.C;
  for (int c = threadIdx.x; c < C; c += kThreads) g.sel[c] = 0;
  for (int r = 0; r < rounds; ++r) {
    int any = 0;
    for (int c = threadIdx.x; c < C; c += kThreads) any |= g.cand[c];
    if (!__syncthreads_or(any)) break;   // later rounds are no-ops
    for (int c = threadIdx.x; c < C; c += kThreads) {
      bool is_max = false;
      if (g.cand[c]) {
        const float s = minimize ? -score[c] : score[c];
        is_max = s > kNeg;
        for (int j = max(c - w, 0); j <= min(c + w, C - 1) && is_max; ++j) {
          if (j == c || !g.cand[j]) continue;
          const float sj = minimize ? -score[j] : score[j];
          is_max = s >= sj;
        }
      }
      g.mark[c] = is_max;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      bool peak = g.mark[c];
      for (int j = max(c - w, 0); j < c && peak; ++j) peak = !g.mark[j];
      g.peak[c] = peak;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      bool hit = false;
      for (int j = max(c - w, 0); j <= min(c + w, C - 1) && !hit; ++j) hit = g.peak[j];
      if (g.peak[c]) g.sel[c] = 1;
      if (hit) g.cand[c] = 0;
    }
  }
  __syncthreads();
}

template <int W>
__global__ void __launch_bounds__(kThreads) extract_rings(ExtractArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C;
  const int ring = blockIdx.x;
  const int tid = threadIdx.x;
  if (ring == 0 && tid == 0) atomicAdd(&g_extract_executions, 1ULL);

  Ring g;
  float* f = reinterpret_cast<float*>(smem);
  g.x = f;
  g.y = f + C;
  g.z = f + 2 * C;
  g.L = f + 3 * C;
  g.sq_next = f + 4 * C;
  for (int s = 0; s < kScores; ++s) g.score[s] = f + (5 + s) * C;
  uint8_t* b = smem + 9 * 4 * C;
  g.flag = b;
  g.cand = b + C;
  g.mark = b + 2 * C;
  g.peak = b + 3 * C;
  g.sel = b + 4 * C;
  g.C = C;

  const float* xyz = a.xyz + ring * a.xyz_stride[0];
  const float* inten = a.intensity + ring * a.intensity_stride[0];
  const unsigned char* valid = a.valid + ring * a.valid_stride[0];

  // 1. slots in, range, the ring's valid count
  int n_valid = 0;
  for (int base = 0; base < C; base += kThreads) {
    const int c = base + tid;
    bool v = false;
    if (c < C) {
      const float* p = xyz + c * a.xyz_stride[1];
      const V3 q = {p[0], p[a.xyz_stride[2]], p[2 * a.xyz_stride[2]]};
      g.x[c] = q.x;
      g.y[c] = q.y;
      g.z[c] = q.z;
      g.L[c] = norm3(q);
      v = valid[c * a.valid_stride[1]] != 0;
      g.flag[c] = v ? kValid : 0;
    }
    n_valid += __syncthreads_count(v);
  }
  const int W_ = W;
  const bool ring_ok = n_valid >= 2 * W_ + 1;
  const float az = a.az != nullptr ? *a.az : a.az_value;
  const float coeff = fd(sinf(az), cosf(fa(az, a.angle_beam_normal)));
  auto core = [&](int c) {
    return ring_ok && c >= W_ && c < n_valid - W_ && (g.flag[c] & kValid);
  };

  // squared step to the next slot (0 past the end), forward / backward gaps
  for (int c = tid; c < C; c += kThreads) {
    const V3 q = g.at(c);
    const V3 nx = c + 1 < C ? g.at(c + 1) : V3{0.0f, 0.0f, 0.0f};
    g.sq_next[c] = sq3(sub3(nx, q));
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    const bool pair_in = (g.flag[c] & kValid) && c + 1 < C && (g.flag[c + 1] & kValid);
    const bool gap0 = (g.sq_next[c] > g.sq_thr(c, coeff)) && pair_in && core(c);
    const bool closer = g.L[c] < (c + 1 < C ? g.L[c + 1] : static_cast<float>(3.0e38));
    g.flag[c] |= gap0 ? (closer ? kFwd : kBwd) : 0;
  }
  __syncthreads();

  // 2. occlusion invalidation and point validity
  for (int c = tid; c < C; c += kThreads) {
    bool inv = (g.flag[c] & kBwd) || (c >= 1 && (g.flag[c - 1] & kFwd));
#pragma unroll
    for (int k = 1; k < W; ++k) {
      const int i = c - k - 1;
      if (!inv && i >= 0 && (g.flag[i] & kFwd)) {
        const float thr = g.sq_thr(i, coeff);
        bool ok = true;
        for (int j = 1; j <= k; ++j) ok = ok && (g.sq_next[i + j] <= thr);
        inv = ok;
      }
      const int ib = c + k;
      if (!inv && ib < C && (g.flag[ib] & kBwd)) {
        const float thr = g.sq_thr(ib, coeff);
        bool ok = true;
        for (int j = 1; j <= k; ++j) ok = ok && ((ib - j >= 0 ? g.sq_next[ib - j] : 0.0f) <= thr);
        inv = ok;
      }
    }
    const bool pv = core(c) && !(g.L[c] < a.min_distance) && !inv;
    if (pv) g.flag[c] |= kPv | kValidEdge;
  }
  __syncthreads();

  // 3. scores of the valid slots (0 elsewhere)
  for (int c = tid; c < C; c += kThreads) {
    float s[kScores] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (g.flag[c] & kPv) slot_scores<W>(g, inten, a.intensity_stride[1], c, a, s);
#pragma unroll
    for (int k = 0; k < kScores; ++k) g.score[k][c] = s[k];
  }
  __syncthreads();

  // 4. the edge passes, chained through the edge validity, then planes
  const float* edge_score[4] = {g.score[kDepthGap], g.score[kSinAngle], g.score[kSaliency],
                                g.score[kIntensityGap]};
  const float edge_thr[4] = {a.depth_gap_threshold, a.sin_angle_threshold,
                             a.saliency_threshold, a.intensity_gap_threshold};
  const int edge_w[4] = {W_ - 1, W_, W_ - 1, 1};
  for (int e = 0; e < 4; ++e) {
    for (int c = tid; c < C; c += kThreads)
      g.cand[c] = (g.flag[c] & kValidEdge) && edge_score[e][c] >= edge_thr[e];
    nms(g, edge_score[e], edge_w[e], a.rounds, false);
    const int w = edge_w[e];
    for (int c = tid; c < C; c += kThreads) {
      bool hit = false;
      for (int j = max(c - w, 0); j <= min(c + w, C - 1) && !hit; ++j) hit = g.sel[j];
      uint8_t fl = g.flag[c];
      if (hit) fl &= ~kValidEdge;
      if (g.sel[c]) fl |= kLabelEdge;
      g.flag[c] = fl;
    }
    __syncthreads();
  }
  const float* sin_angle = g.score[kSinAngle];
  for (int c = tid; c < C; c += kThreads)
    g.cand[c] = (g.flag[c] & kPv) && sin_angle[c] <= a.plane_threshold &&
                sin_angle[c] >= kMinPlaneSin;
  nms(g, sin_angle, 4, a.rounds, true);

  // 5. out
  const long long plane = static_cast<long long>(a.R) * C;
  const long long row = static_cast<long long>(ring) * C;
  for (int c = tid; c < C; c += kThreads) {
    const uint8_t fl = g.flag[c];
    const bool pv = fl & kPv;
    unsigned char* lab = a.labels + row + c;
    lab[kEdge * plane] = (fl & kLabelEdge) != 0;
    lab[kPlane * plane] = g.sel[c];
    lab[kBlob * plane] = pv && (c % a.blob_stride == 0);
    lab[kPointValid * plane] = pv;
    lab[kEdgeValidity * plane] = (fl & (kValidEdge | kLabelEdge)) != 0;
    float* sc = a.scores + row + c;
#pragma unroll
    for (int k = 0; k < kScores; ++k) sc[k * plane] = g.score[k][c];
  }
}

template <int W>
cudaError_t launch(const ExtractArgs& a, cudaStream_t st) {
  const int bytes = a.C * kSlotBytes;
  // above 48 KB only once the kernel allows it (per device)
  static int allowed[64] = {0};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && allowed[dev] < kMaxC * kSlotBytes) {
    rc = cudaFuncSetAttribute(extract_rings<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxC * kSlotBytes);
    if (rc != cudaSuccess) return rc;
    allowed[dev] = kMaxC * kSlotBytes;
  }
  extract_rings<W><<<a.R, kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int extract_max_w() { return kMaxW; }
extern "C" int extract_max_c() { return kMaxC; }
extern "C" int extract_args_bytes() { return static_cast<int>(sizeof(ExtractArgs)); }

// Label one sweep of a.R rings (see ExtractArgs) on `stream`: one launch of
// extract_rings<a.W>. A cudaError code, 0 on success.
extern "C" int extract_launch(const ExtractArgs* args, void* stream) {
  const ExtractArgs& a = *args;
  if (a.R <= 0 || a.C <= 0) return static_cast<int>(cudaGetLastError());
  if (a.C > kMaxC || a.W < 1 || a.W > kMaxW || a.rounds < 0 || a.blob_stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  switch (a.W) {
    case 1: rc = launch<1>(a, st); break;
    case 2: rc = launch<2>(a, st); break;
    case 3: rc = launch<3>(a, st); break;
    case 4: rc = launch<4>(a, st); break;
    case 5: rc = launch<5>(a, st); break;
    case 6: rc = launch<6>(a, st); break;
    case 7: rc = launch<7>(a, st); break;
    case 8: rc = launch<8>(a, st); break;
    default: break;
  }
  return static_cast<int>(rc);
}

// The kernel's device execution count into *out (host memory), on the
// current device; waits for the device first.
extern "C" int extract_executions(unsigned long long* out) {
  cudaError_t rc = cudaDeviceSynchronize();
  if (rc == cudaSuccess)
    rc = cudaMemcpyFromSymbol(out, g_extract_executions, sizeof(g_extract_executions));
  return static_cast<int>(rc);
}

extern "C" int extract_reset_executions() {
  const unsigned long long zero = 0;
  cudaError_t rc = cudaDeviceSynchronize();
  if (rc == cudaSuccess)
    rc = cudaMemcpyToSymbol(g_extract_executions, &zero, sizeof(zero));
  return static_cast<int>(rc);
}
