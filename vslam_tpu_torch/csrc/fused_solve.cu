// Whole-level Gauss-Newton solve of B RGB-D frame pairs, one thread block
// per pair; one template, two entries (quadratic and robust loss).
//
// Replaces the Pallas TPU kernel `_solve_kernel` / `_solve_impl` of
// vslam_tpu/alignment/fused_solve.py (`solve_level_fused`, quadratic-loss
// entry) and, with ROBUST = true, `_solve_kernel_robust`
// (vslam_tpu/alignment/fused_solve.py:520). Per pair and per iteration it
// composes the shared delta with each stacked frame's rel0, warps /
// projects / samples every interest point, accumulates JᵀWJ, JᵀWr and
// chi2, normalizes by the interest-point count,
// adds the motion prior, solves the 6x6 system by Cholesky with the
// log-det guard, applies the reference's guards, rollback and convergence
// tests (GaussNewton.cpp:33-102), updates delta <- delta . exp(-dx) and
// records chi2 / step history. Each block stops at its own convergence.
//
// What bounds it on an H100: per iteration a block reads ~11 values per
// point (pcl 3, J 6, template, mask) plus 1 or 4 scattered image loads,
// about 45 B/point; at the finest production level (1920 points, 480x640)
// that is ~90 KB per pair, which stays in L1/L2, so the pass is bound by
// load latency, not HBM bandwidth. The scalar tail (6x6 Cholesky, guards,
// series exp/log, Gram-Schmidt) runs on one thread and is serial, a few
// microseconds per iteration, while the other threads wait.
// What the design does about it: one launch per level for the whole batch
// (no per-iteration launches or host round trips), per-pair early exit,
// 256 threads striding over points with register partials reduced by warp
// shuffles and one shared-memory pass, and image reads through the
// read-only cache. One block per pair fills B of the 132 SMs (64 at the
// production batch). Caching points in shared memory, splitting a pair over
// a cluster and a parallel 6x6 tail are later work.
//
// Robust entry. Per iteration and stacked frame: pass A warps, samples and
// stores r (0 where invisible) and the visibility in a (B, F, P) global
// scratch; the scale is then computed over the frame's interest mask from
// that cache, never re-sampling (median and MAD: a block-wide min/max, then
// 24 value-domain bisection steps, each one block-wide count of
// mask & value(r) <= mid for both central ranks at once; mean: two sums;
// t-distribution: <= 30 fixed-point sums); pass B accumulates the weighted
// Gram sums. What bounds it: per iteration the median scaler takes 26
// block-wide passes over the frame's cached residuals (MAD 50, mean 2,
// t-dist <= 30), each ending in two __syncthreads, on top of the two point
// passes; the serial 6x6 tail runs as before. What this simple design does about it: each
// thread only re-reads the entries it wrote itself (L1/L2-resident, 8 B per
// point), the counts are integers (exact in any order), the two ranks share
// every pass, and the order-dependent sums (mean, sum |r - med|, t-dist)
// run in the fixed block order the plain version reproduces. Keeping the
// cache in shared memory and a warp per rank are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "warp_sample.cuh"

namespace vslam {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOut = 64;  // A (36), b (6), chi2, iterations, valid, R (9), t (3)

struct SolveParams {
  const float* pcl;            // (B, F, P, 3)
  const float* J;              // (B, F, P, 6)
  const float* templ;          // (B, F, P)
  const unsigned char* mask;   // (B, F, P) bool
  const float* n_constraints;  // (B, F)
  const float* rel0_R;         // (B, F, 3, 3)
  const float* rel0_t;         // (B, F, 3)
  const float* x_pred;         // (B, F, 6)
  const float* cam;            // (B, 4) fx, fy, cx, cy
  const void* image;           // (B, H, W) float or bf16
  int B, F, P, H, W;
  int include_prior;
  float prior_weight;
  int max_iterations;
  float min_step_size, min_gradient, min_reduction, min_relative_reduction;
  int use_min_rel;
  int orthonormalize;
  // robust entry only
  int loss_kind;    // 1 Huber, 2 Tukey, 3 t-distribution
  int scaler_kind;  // Huber / Tukey: 0 reference (median), 1 MAD, 2 mean
  float huber_c, tdist_v;
  float* r_buf;      // (B, F, P) residual cache, 0 where invisible
  float* vis_buf;    // (B, F, P) visibility cache, 0 or 1
  float* out;        // (B, kOut)
  float* chi2_hist;  // (B, max_iterations)
  float* step_hist;  // (B, max_iterations)
};

constexpr int kBisectSteps = 24;      // halvings of the [min, max] bracket per rank
constexpr int kTdistIterations = 30;  // t-distribution fixed point budget
constexpr float kTdistTol = 1e-5f;
constexpr float kTukeyC = 4.6851f;

// NaN-propagating max, as jnp.maximum / torch.maximum
__device__ __forceinline__ float maxp(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ void mat3_mul(const float* a, const float* b, float* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

__device__ __forceinline__ void mat3_vec(const float* a, const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = a[3 * i] * v[0] + a[3 * i + 1] * v[1] + a[3 * i + 2] * v[2];
}

__device__ __forceinline__ void hat(const float* w, float* W) {
  W[0] = 0.0f;  W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.0f;  W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0f;
}

// exp of xi = [rho; phi] with the series coefficients of fused_solve.py:71-87
__device__ void se3_exp_series(const float* xi, float* R, float* t) {
  const float* w = xi + 3;
  const float t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float A = 1.0f - t2 / 6.0f + t2 * t2 / 120.0f - t2 * t2 * t2 / 5040.0f;
  const float B = 0.5f - t2 / 24.0f + t2 * t2 / 720.0f - t2 * t2 * t2 / 40320.0f;
  const float C = 1.0f / 6.0f - t2 / 120.0f + t2 * t2 / 5040.0f - t2 * t2 * t2 / 362880.0f;
  float W[9], W2[9], V[9];
  hat(w, W);
  mat3_mul(W, W, W2);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float e = (k % 4 == 0) ? 1.0f : 0.0f;
    R[k] = e + A * W[k] + B * W2[k];
    V[k] = e + B * W[k] + C * W2[k];
  }
  mat3_vec(V, xi, t);
}

// log by series, valid below theta ~ pi/2 (fused_solve.py:90-107)
__device__ void se3_log_series(const float* R, const float* t, float* x) {
  const float v0 = R[7] - R[5], v1 = R[2] - R[6], v2 = R[3] - R[1];
  const float s2 = 0.25f * (v0 * v0 + v1 * v1 + v2 * v2);
  const float factor =
      0.5f * (1.0f + s2 / 6.0f + 3.0f * s2 * s2 / 40.0f + 15.0f * s2 * s2 * s2 / 336.0f);
  const float phi[3] = {factor * v0, factor * v1, factor * v2};
  const float t2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float cot = 1.0f / 12.0f + t2 / 720.0f + t2 * t2 / 30240.0f;
  float W[9], W2[9], Vinv[9];
  hat(phi, W);
  mat3_mul(W, W, W2);
#pragma unroll
  for (int k = 0; k < 9; ++k) Vinv[k] = ((k % 4 == 0) ? 1.0f : 0.0f) - 0.5f * W[k] + cot * W2[k];
  mat3_vec(Vinv, t, x);
  x[3] = phi[0];
  x[4] = phi[1];
  x[5] = phi[2];
}

// column Gram-Schmidt (fused_solve.py:110-127)
__device__ void orthonormalize(float* R) {
  float x[3] = {R[0], R[3], R[6]};
  const float c1[3] = {R[1], R[4], R[7]};
  const float n0 = sqrtf(maxp(x[0] * x[0] + x[1] * x[1] + x[2] * x[2], 1e-24f));
  x[0] /= n0; x[1] /= n0; x[2] /= n0;
  float z[3] = {x[1] * c1[2] - x[2] * c1[1], x[2] * c1[0] - x[0] * c1[2],
                x[0] * c1[1] - x[1] * c1[0]};
  const float nz = sqrtf(maxp(z[0] * z[0] + z[1] * z[1] + z[2] * z[2], 1e-24f));
  z[0] /= nz; z[1] /= nz; z[2] /= nz;
  const float y[3] = {z[1] * x[2] - z[2] * x[1], z[2] * x[0] - z[0] * x[2],
                      z[0] * x[1] - z[1] * x[0]};
  R[0] = x[0]; R[1] = y[0]; R[2] = z[0];
  R[3] = x[1]; R[4] = y[1]; R[5] = z[1];
  R[6] = x[2]; R[7] = y[2]; R[8] = z[2];
}

// Unrolled Cholesky solve with log|det| (solvers/linalg6.py): -inf when a
// pivot is <= 1e-10 x the largest diagonal entry or the scale is not finite.
__device__ float chol6_logdet_solve(const float (&A)[36], const float (&b)[6], float (&x)[6]) {
  float L[36];
  float scale = A[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) scale = maxp(scale, A[7 * j]);
  bool bad = !isfinite(scale);
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[7 * j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[6 * j + k] * L[6 * j + k];
    bad = bad || (s <= 1e-10f * scale);
    L[7 * j] = sqrtf(maxp(s, 1e-30f));
    const float inv_d = 1.0f / L[7 * j];
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float si = A[6 * i + j];
#pragma unroll
      for (int k = 0; k < j; ++k) si -= L[6 * i + k] * L[6 * j + k];
      L[6 * i + j] = si * inv_d;
    }
  }
  float logdet = logf(L[0]);
#pragma unroll
  for (int j = 1; j < 6; ++j) logdet += logf(L[7 * j]);
  logdet = bad ? -INFINITY : 2.0f * logdet;
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[6 * i + k] * y[k];
    y[i] = s / L[7 * i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[6 * k + i] * x[k];
    x[i] = s / L[7 * i];
  }
  return logdet;
}

// Sum the per-thread partials over the block: warp shuffles, then one pass
// over the per-warp rows in shared memory. Ends synchronized, so every
// thread may read s_sum and the next call may reuse s_warp.
__device__ __forceinline__ void block_reduce(float (&acc)[kGram], float (*s_warp)[kGram],
                                             float* s_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kGram; ++k) {
    float v = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) s_warp[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kGram) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_warp[w][threadIdx.x];
    s_sum[threadIdx.x] = v;
  }
  __syncthreads();
}

// Shared scratch of the robust entry's block-wide reductions.
struct ReduceScratch {
  float sum[kWarps + 1];
  float minmax[2 * kWarps + 2];
  int count[2 * kWarps + 2];
};

// Sum of one float per thread over the block in the kernel's order (a
// shuffle-down tree per warp, then the warps in sequence, as
// fused_solve._block_sum), returned to every thread.
__device__ __forceinline__ float block_sum(float v, ReduceScratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) s.sum[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += s.sum[w];
    s.sum[kWarps] = t;
  }
  __syncthreads();
  return s.sum[kWarps];
}

// Block-wide min of mn and max of mx, returned to every thread.
__device__ __forceinline__ void block_minmax(float& mn, float& mx, ReduceScratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_down_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, o));
  }
  if (lane == 0) {
    s.minmax[2 * warp] = mn;
    s.minmax[2 * warp + 1] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = s.minmax[0], b = s.minmax[1];
    for (int w = 1; w < kWarps; ++w) {
      a = fminf(a, s.minmax[2 * w]);
      b = fmaxf(b, s.minmax[2 * w + 1]);
    }
    s.minmax[2 * kWarps] = a;
    s.minmax[2 * kWarps + 1] = b;
  }
  __syncthreads();
  mn = s.minmax[2 * kWarps];
  mx = s.minmax[2 * kWarps + 1];
}

// Block-wide sums of two integer counts (exact in any order), returned to
// every thread.
__device__ __forceinline__ void block_count2(int& a, int& b, ReduceScratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    s.count[2 * warp] = a;
    s.count[2 * warp + 1] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int x = 0, y = 0;
    for (int w = 0; w < kWarps; ++w) {
      x += s.count[2 * w];
      y += s.count[2 * w + 1];
    }
    s.count[2 * kWarps] = x;
    s.count[2 * kWarps + 1] = y;
  }
  __syncthreads();
  a = s.count[2 * kWarps];
  b = s.count[2 * kWarps + 1];
}

// The statistic's domain: the cached residual, or its distance to `center`
// (the MAD's second pass).
__device__ __forceinline__ float stat_value(float r, bool absdev, float center) {
  return absdev ? fabsf(r - center) : r;
}

// Masked median of value(r) over the frame's interest set: ranks
// k_lo = floor((n-1)/2) and k_hi = floor(n/2) of the n = n_constraints
// entries, each the smallest x of the 24-step bisection of [min, max] with
// count(mask & value <= x) >= k + 1, averaged; 0 when n = 0
// (fused_solve.py:259-297). Every thread reads only the cache entries it
// wrote itself.
__device__ float bisect_median(const SolveParams& p, const unsigned char* mask, const float* rb,
                               float n, bool absdev, float center, ReduceScratch& s) {
  float mn = INFINITY, mx = -INFINITY;
  for (int q = threadIdx.x; q < p.P; q += kThreads) {
    if (!mask[q]) continue;
    const float v = stat_value(rb[q], absdev, center);
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
  block_minmax(mn, mx, s);
  const bool empty = !(mx >= mn);
  float lo[2], hi[2];
  lo[0] = lo[1] = empty ? 0.0f : mn;
  hi[0] = hi[1] = empty ? 0.0f : mx;
  const float k_lo = fmaxf(floorf((n - 1.0f) * 0.5f), 0.0f);
  const float k_hi = fmaxf(floorf(n * 0.5f), 0.0f);
  for (int step = 0; step < kBisectSteps; ++step) {
    const float mid0 = 0.5f * (lo[0] + hi[0]), mid1 = 0.5f * (lo[1] + hi[1]);
    int c0 = 0, c1 = 0;
    for (int q = threadIdx.x; q < p.P; q += kThreads) {
      if (!mask[q]) continue;
      const float v = stat_value(rb[q], absdev, center);
      c0 += v <= mid0;
      c1 += v <= mid1;
    }
    block_count2(c0, c1, s);
    if ((float)c0 >= k_lo + 1.0f) hi[0] = mid0; else lo[0] = mid0;
    if ((float)c1 >= k_hi + 1.0f) hi[1] = mid1; else lo[1] = mid1;
  }
  return n > 0.0f ? 0.5f * (hi[0] + hi[1]) : 0.0f;
}

// Sum of |r - center| over the interest set, in the kernel's order.
__device__ __forceinline__ float masked_absdev_sum(const SolveParams& p, const unsigned char* mask,
                                                   const float* rb, float center,
                                                   ReduceScratch& s) {
  float acc = 0.0f;
  for (int q = threadIdx.x; q < p.P; q += kThreads)
    if (mask[q]) acc += fabsf(rb[q] - center);
  return block_sum(acc, s);
}

// (offset, sigma) of the frame's cached residuals over its interest set,
// the same value in every thread (fused_solve.py:234-338).
__device__ void robust_scale(const SolveParams& p, const unsigned char* mask, const float* rb,
                             float n, ReduceScratch& s, float& offset, float& sigma) {
  if (p.loss_kind == 3) {
    // t-distribution fixed point, whatever the scaler (Scaler.cpp:49-67)
    const float n_safe = fmaxf(n, 1.0f), vp1 = p.tdist_v + 1.0f;
    float sig = 1.0f, step = INFINITY;
    for (int it = 0; it < kTdistIterations && step > kTdistTol; ++it) {
      const float sigma2 = fmaxf(sig * sig, 1e-24f);
      float acc = 0.0f;
      for (int q = threadIdx.x; q < p.P; q += kThreads) {
        if (!mask[q]) continue;
        const float r2 = rb[q] * rb[q];
        acc += r2 * vp1 / (p.tdist_v + r2 / sigma2);
      }
      const float sig_new = sqrtf(block_sum(acc, s) / n_safe);
      step = fabsf(sig - sig_new);
      sig = sig_new;
    }
    offset = 0.0f;
    sigma = fmaxf(sig, 1e-12f);
  } else if (p.scaler_kind == 2) {
    // mean (Scaler.cpp:37-47); an empty set gives offset 0, scale 1
    float acc = 0.0f;
    for (int q = threadIdx.x; q < p.P; q += kThreads)
      if (mask[q]) acc += rb[q];
    const float mean = block_sum(acc, s) / fmaxf(n, 1.0f);
    const float spread = sqrtf(masked_absdev_sum(p, mask, rb, mean, s) / fmaxf(n - 1.0f, 1.0f));
    const bool empty = n < 1.0f;
    offset = empty ? 0.0f : mean;
    sigma = (empty || spread <= 0.0f) ? 1.0f : spread;
  } else {
    const float med = bisect_median(p, mask, rb, n, false, 0.0f, s);
    offset = med;
    if (p.scaler_kind == 1) {
      // MAD: 1.4826 median |r - med|
      const float sig = 1.4826f * bisect_median(p, mask, rb, n, true, med, s);
      sigma = sig > 1e-6f ? sig : 1.0f;
    } else {
      // the reference's median scaler: sqrt(sum |r - med| / (n - 1))
      const float spread = sqrtf(masked_absdev_sum(p, mask, rb, med, s) / fmaxf(n - 1.0f, 1.0f));
      sigma = spread > 0.0f ? spread : 1.0f;
    }
  }
}

// M-estimator weight of the standardized residual (Loss.cpp; Huber's
// outlier weight is the reference's 1/|r|).
__device__ __forceinline__ float robust_weight(const SolveParams& p, float r) {
  if (p.loss_kind == 1) {
    const float a = fabsf(r);
    return a < p.huber_c ? 1.0f : 1.0f / fmaxf(a, 1e-30f);
  }
  if (p.loss_kind == 2) {
    const float rc = r / kTukeyC;
    const float t = 1.0f - rc * rc;
    return fabsf(r) < kTukeyC ? t * t : 0.0f;
  }
  return (p.tdist_v + 1.0f) / (p.tdist_v + r * r);
}

// T = rel0 . delta for frame bf
__device__ __forceinline__ void compose_frame(const SolveParams& p, size_t bf, const float* Rd,
                                              const float* td, Pose& T) {
  const float* R0 = p.rel0_R + 9 * bf;
  const float* t0 = p.rel0_t + 3 * bf;
  mat3_mul(R0, Rd, T.R);
  mat3_vec(R0, td, T.t);
#pragma unroll
  for (int i = 0; i < 3; ++i) T.t[i] += t0[i];
}

template <typename TImg, bool BILINEAR, bool ROBUST>
__global__ void __launch_bounds__(kThreads) solve_level_kernel(const SolveParams p) {
  __shared__ float s_warp[kWarps][kGram];
  __shared__ ReduceScratch s_red;  // robust entry
  __shared__ float s_sum[kGram];
  __shared__ float s_delta[12];  // delta R (9), t (3)
  __shared__ float s_A[36];      // last accepted A, b
  __shared__ float s_b[6];
  __shared__ int s_done;

  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const TImg* img = static_cast<const TImg*>(p.image) + (size_t)pair * p.H * p.W;
  const Intrinsics K = {p.cam[4 * pair], p.cam[4 * pair + 1], p.cam[4 * pair + 2],
                        p.cam[4 * pair + 3]};
  float* chist = p.chi2_hist + (size_t)pair * p.max_iterations;
  float* shist = p.step_hist + (size_t)pair * p.max_iterations;
  for (int i = tid; i < p.max_iterations; i += kThreads) {
    chist[i] = NAN;
    shist[i] = NAN;
  }

  // solver state, owned by thread 0
  float chi2_prev = INFINITY;
  int pushed = 0, it = 0;
  float n_total = 0.0f;
  if (tid == 0) {
    for (int k = 0; k < 12; ++k) s_delta[k] = (k < 9 && k % 4 == 0) ? 1.0f : 0.0f;
    for (int k = 0; k < 36; ++k) s_A[k] = (k % 7 == 0) ? 1.0f : 0.0f;
    for (int k = 0; k < 6; ++k) s_b[k] = 0.0f;
    for (int f = 0; f < p.F; ++f) n_total += p.n_constraints[(size_t)pair * p.F + f];
    s_done = p.max_iterations <= 0;
  }

  for (;;) {
    __syncthreads();  // s_delta / s_done published
    if (s_done) break;
    float Rd[9], td[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) Rd[k] = s_delta[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) td[k] = s_delta[9 + k];

    float A[36], bvec[6], chi2 = 0.0f;  // stacked normalized NE (thread 0)
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 36; ++k) A[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) bvec[k] = 0.0f;
    }
    for (int f = 0; f < p.F; ++f) {
      const size_t bf = (size_t)pair * p.F + f;
      Pose T;
      compose_frame(p, bf, Rd, td, T);
      const float* pcl = p.pcl + bf * p.P * 3;
      const float* J = p.J + bf * p.P * 6;
      const float* templ = p.templ + bf * p.P;
      const unsigned char* mask = p.mask + bf * p.P;

      float acc[kGram];
#pragma unroll
      for (int k = 0; k < kGram; ++k) acc[k] = 0.0f;
      if constexpr (ROBUST) {
        // pass A: cache r (0 where invisible) and the visibility; each
        // thread later re-reads only the entries it writes here
        float* rb = p.r_buf + bf * p.P;
        float* vb = p.vis_buf + bf * p.P;
        for (int q = tid; q < p.P; q += kThreads) {
          float r = 0.0f, vis = 0.0f, u, v;
          if (mask[q] && warp_project(T, K, __ldg(pcl + 3 * q), __ldg(pcl + 3 * q + 1),
                                      __ldg(pcl + 3 * q + 2), p.H, p.W, u, v)) {
            r = sample<BILINEAR>(img, p.W, u, v) - __ldg(templ + q);
            vis = 1.0f;
          }
          rb[q] = r;
          vb[q] = vis;
        }
        // the scale over the interest set, from the cache
        float offset, sigma;
        robust_scale(p, mask, rb, p.n_constraints[bf], s_red, offset, sigma);
        // pass B: weighted Gram sums over the visible points
        for (int q = tid; q < p.P; q += kThreads) {
          if (vb[q] == 0.0f) continue;
          const float r = rb[q];
          const float w = robust_weight(p, (r - offset) / sigma);
          float j[6];
#pragma unroll
          for (int k = 0; k < 6; ++k) j[k] = __ldg(J + 6 * q + k);
          gram_accumulate_weighted(acc, j, r, w);
        }
      } else {
        for (int q = tid; q < p.P; q += kThreads) {
          if (!mask[q]) continue;
          float u, v;
          if (!warp_project(T, K, __ldg(pcl + 3 * q), __ldg(pcl + 3 * q + 1),
                            __ldg(pcl + 3 * q + 2), p.H, p.W, u, v))
            continue;
          const float r = sample<BILINEAR>(img, p.W, u, v) - __ldg(templ + q);
          float j[6];
#pragma unroll
          for (int k = 0; k < 6; ++k) j[k] = __ldg(J + 6 * q + k);
          gram_accumulate(acc, j, r);
        }
      }
      block_reduce(acc, s_warp, s_sum);

      if (tid == 0) {
        // normalize by the interest-point count, add the prior, stack
        const float n = p.n_constraints[bf];
        const float inv_n = n > 1.0f ? 1.0f / fmaxf(n, 1.0f) : 1.0f;
        float Af[36], bf6[6];
        int k = 0;
        for (int a = 0; a < 6; ++a)
          for (int c = a; c < 6; ++c, ++k) Af[6 * a + c] = Af[6 * c + a] = s_sum[k] * inv_n;
        for (int a = 0; a < 6; ++a) bf6[a] = s_sum[kGramB + a] * inv_n;
        const float chi2_f = s_sum[kGramChi2] * inv_n;
        if (p.include_prior) {
          float x[6];
          se3_log_series(T.R, T.t, x);
          const float nrm = 1.0f / (255.0f * 255.0f);
          const float* xp = p.x_pred + 6 * bf;
          for (int a = 0; a < 6; ++a) {
            for (int c = 0; c < 6; ++c) Af[6 * a + c] *= nrm;
            Af[7 * a] += p.prior_weight;
            bf6[a] = bf6[a] * nrm + p.prior_weight * (x[a] - xp[a]);
          }
        }
        for (int a = 0; a < 36; ++a) A[a] += Af[a];
        for (int a = 0; a < 6; ++a) bvec[a] += bf6[a];
        chi2 += chi2_f;
      }
    }

    if (tid == 0) {
      float dx[6];
      const float logdet = chol6_logdet_solve(A, bvec, dx);
      const bool stop_constraints = n_total < 6.0f;
      const bool stop_det = !isfinite(logdet) || logdet < logf(1e-6f);
      const bool chi2_increased = pushed > 0 && chi2 > chi2_prev;
      const bool abort = stop_constraints || stop_det || chi2_increased;
      float step2 = 0.0f;
      for (int k = 0; k < 6; ++k) step2 += dx[k] * dx[k];
      const float step = sqrtf(step2);
      const bool nan_step = !isfinite(step);

      // compositional update delta <- delta . exp(-dx)
      float mdx[6], Re[9], te[3], R_new[9], t_new[3];
      for (int k = 0; k < 6; ++k) mdx[k] = -dx[k];
      se3_exp_series(mdx, Re, te);
      mat3_mul(Rd, Re, R_new);
      mat3_vec(Rd, te, t_new);
      for (int k = 0; k < 3; ++k) t_new[k] += td[k];
      if (p.orthonormalize) orthonormalize(R_new);

      chist[it] = chi2;
      shist[it] = step;

      float b_max = bvec[0];
      for (int k = 1; k < 6; ++k) b_max = maxp(b_max, bvec[k]);
      const float d_chi2 = fabsf(chi2 - chi2_prev);
      bool converged = pushed > 0 && (step < p.min_step_size || fabsf(b_max) < p.min_gradient ||
                                      d_chi2 < p.min_reduction);
      if (p.use_min_rel)
        converged = converged || (pushed > 0 && d_chi2 < p.min_relative_reduction * fabsf(chi2));

      // a NaN step is not an accepted iteration: delta rolls back and
      // A / b / chi2 keep the last accepted values
      const bool accepted = !abort && !nan_step;
      if (accepted) {
        for (int k = 0; k < 9; ++k) s_delta[k] = R_new[k];
        for (int k = 0; k < 3; ++k) s_delta[9 + k] = t_new[k];
        for (int k = 0; k < 36; ++k) s_A[k] = A[k];
        for (int k = 0; k < 6; ++k) s_b[k] = bvec[k];
        chi2_prev = chi2;
        ++pushed;
      }
      ++it;
      s_done = abort || nan_step || converged || it >= p.max_iterations;
    }
  }

  if (tid == 0) {
    float* out = p.out + (size_t)pair * kOut;
    for (int k = 0; k < 36; ++k) out[k] = s_A[k];
    for (int k = 0; k < 6; ++k) out[36 + k] = s_b[k];
    out[42] = chi2_prev;
    out[43] = (float)pushed;
    out[44] = pushed > 0 ? 1.0f : 0.0f;
    for (int k = 0; k < 12; ++k) out[45 + k] = s_delta[k];
    for (int k = 57; k < kOut; ++k) out[k] = 0.0f;
  }
}

template <typename TImg, bool ROBUST>
void launch(const SolveParams& p, int bilinear, cudaStream_t stream) {
  if (bilinear)
    solve_level_kernel<TImg, true, ROBUST><<<p.B, kThreads, 0, stream>>>(p);
  else
    solve_level_kernel<TImg, false, ROBUST><<<p.B, kThreads, 0, stream>>>(p);
}

template <bool ROBUST>
int launch_checked(const SolveParams& p, int image_is_bf16, int bilinear, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (image_is_bf16)
    launch<__nv_bfloat16, ROBUST>(p, bilinear, s);
  else
    launch<float, ROBUST>(p, bilinear, s);
  return static_cast<int>(cudaGetLastError());
}

SolveParams make_params(const void* pcl, const void* J, const void* templ, const void* mask,
                        const void* n_constraints, const void* rel0_R, const void* rel0_t,
                        const void* x_pred, const void* cam, const void* image, int B, int F,
                        int P, int H, int W, int include_prior, float prior_weight,
                        int max_iterations, float min_step_size, float min_gradient,
                        float min_reduction, float min_relative_reduction, int use_min_rel,
                        int orthonormalize, void* out, void* chi2_hist, void* step_hist) {
  SolveParams p = {};
  p.pcl = static_cast<const float*>(pcl);
  p.J = static_cast<const float*>(J);
  p.templ = static_cast<const float*>(templ);
  p.mask = static_cast<const unsigned char*>(mask);
  p.n_constraints = static_cast<const float*>(n_constraints);
  p.rel0_R = static_cast<const float*>(rel0_R);
  p.rel0_t = static_cast<const float*>(rel0_t);
  p.x_pred = static_cast<const float*>(x_pred);
  p.cam = static_cast<const float*>(cam);
  p.image = image;
  p.B = B;
  p.F = F;
  p.P = P;
  p.H = H;
  p.W = W;
  p.include_prior = include_prior;
  p.prior_weight = prior_weight;
  p.max_iterations = max_iterations;
  p.min_step_size = min_step_size;
  p.min_gradient = min_gradient;
  p.min_reduction = min_reduction;
  p.min_relative_reduction = min_relative_reduction;
  p.use_min_rel = use_min_rel;
  p.orthonormalize = orthonormalize;
  p.out = static_cast<float*>(out);
  p.chi2_hist = static_cast<float*>(chi2_hist);
  p.step_hist = static_cast<float*>(step_hist);
  return p;
}

}  // namespace vslam

// C entries for ctypes. Each launches on `stream` without synchronizing and
// returns cudaGetLastError() (0 = cudaSuccess).
extern "C" int vslam_solve_level_fused(
    const void* pcl, const void* J, const void* templ, const void* mask,
    const void* n_constraints, const void* rel0_R, const void* rel0_t, const void* x_pred,
    const void* cam, const void* image, int image_is_bf16, int B, int F, int P, int H, int W,
    int bilinear, int include_prior, float prior_weight, int max_iterations,
    float min_step_size, float min_gradient, float min_reduction, float min_relative_reduction,
    int use_min_rel, int orthonormalize, void* out, void* chi2_hist, void* step_hist,
    void* stream) {
  const vslam::SolveParams p = vslam::make_params(
      pcl, J, templ, mask, n_constraints, rel0_R, rel0_t, x_pred, cam, image, B, F, P, H, W,
      include_prior, prior_weight, max_iterations, min_step_size, min_gradient, min_reduction,
      min_relative_reduction, use_min_rel, orthonormalize, out, chi2_hist, step_hist);
  return vslam::launch_checked<false>(p, image_is_bf16, bilinear, stream);
}

// The robust entry: loss_kind 1 Huber, 2 Tukey, 3 t-distribution;
// scaler_kind 0 reference, 1 MAD, 2 mean; r_buf and vis_buf are (B, F, P)
// f32 scratch the kernel overwrites.
extern "C" int vslam_solve_level_fused_robust(
    const void* pcl, const void* J, const void* templ, const void* mask,
    const void* n_constraints, const void* rel0_R, const void* rel0_t, const void* x_pred,
    const void* cam, const void* image, int image_is_bf16, int B, int F, int P, int H, int W,
    int bilinear, int include_prior, float prior_weight, int max_iterations,
    float min_step_size, float min_gradient, float min_reduction, float min_relative_reduction,
    int use_min_rel, int orthonormalize, int loss_kind, int scaler_kind, float huber_c,
    float tdist_v, void* r_buf, void* vis_buf, void* out, void* chi2_hist, void* step_hist,
    void* stream) {
  vslam::SolveParams p = vslam::make_params(
      pcl, J, templ, mask, n_constraints, rel0_R, rel0_t, x_pred, cam, image, B, F, P, H, W,
      include_prior, prior_weight, max_iterations, min_step_size, min_gradient, min_reduction,
      min_relative_reduction, use_min_rel, orthonormalize, out, chi2_hist, step_hist);
  p.loss_kind = loss_kind;
  p.scaler_kind = scaler_kind;
  p.huber_c = huber_c;
  p.tdist_v = tdist_v;
  p.r_buf = static_cast<float*>(r_buf);
  p.vis_buf = static_cast<float*>(vis_buf);
  return vslam::launch_checked<true>(p, image_is_bf16, bilinear, stream);
}
