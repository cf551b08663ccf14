// Whole-level Gauss-Newton solve of B RGB-D frame pairs, one thread-block
// cluster of kCtas CTAs per pair; one template, two entries (quadratic and
// robust loss).
//
// Replaces the Pallas TPU kernel `_solve_kernel` / `_solve_impl` of
// vslam_tpu/alignment/fused_solve.py (`solve_level_fused`, quadratic-loss
// entry) and, with ROBUST = true, `_solve_kernel_robust`
// (vslam_tpu/alignment/fused_solve.py:520). Per pair and per iteration it
// composes the shared delta with each stacked frame's rel0, warps /
// projects / samples every interest point, accumulates JᵀWJ, JᵀWr and
// chi2, normalizes by the interest-point count, adds the motion prior,
// solves the 6x6 system by Cholesky with the log-det guard, applies the
// reference's guards, rollback and convergence tests (GaussNewton.cpp:
// 33-102), updates delta <- delta . exp(-dx) and records chi2 / step
// history. Each cluster stops at its own convergence.
//
// What bounds it on an H100: per iteration a pair reads ~41 B of level
// data per point (pcl 3, J 6, template, mask) plus 1 or 4 scattered image
// loads, ~160 KB at the robust profile's finest level (F = 2, P = 1920):
// nothing near the HBM rate. The time goes to latency: dependent loads,
// barriers, and the serial 6x6 tail between two point passes. At B = 1 (the
// online tracker) one block would use one of the 132 SMs.
//
// What the design does about it:
// - A pair runs on a cluster of kCtas CTAs (cudaLaunchKernelEx with a
//   cluster dimension), so B = 1 spreads over kCtas SMs. CTA c takes the
//   fixed contiguous share [c S, (c + 1) S) of every frame's points (S = 16
//   ceil(P / 16 kCtas)) and sums it in the single-block order (thread t
//   adds points t, t + 256, ...; a shuffle-down tree per warp; the warps in
//   sequence). Every CTA reads the kCtas partials through distributed shared
//   memory and adds them in rank order (`fused_solve._block_sum(ctas=)` is
//   the plain twin), so every CTA runs the same tail on the same values and
//   no result has to be sent back: one cluster barrier per iteration.
// - A CTA's share of pcl, J, template and mask is copied into shared memory
//   once per launch by TMA bulk copies (cp.async.bulk completing on an
//   mbarrier; 16-byte-unaligned pieces by plain loads) where it fits, and
//   every iteration reads it there.
// - All F frames' Gram partials go to shared memory in one point pass and
//   meet in one reduction per iteration.
// - The tail runs on warp 0: one normalized, prior-corrected and stacked
//   output element per lane, the Cholesky column's entries and the forward
//   substitution across lanes (each entry keeps the serial form's sequence
//   of operations, so the results are those of the serial tail bit for
//   bit). The prior's log series of each frame runs on a lane of the last
//   warp while the others sample, off the tail's path.
// - Robust entry: each iteration caches every frame's r (0 where invisible)
//   and visibility in shared memory where a CTA's share of every frame fits
//   there (5 B a point: up to ~180 K points a pair summed over frames), and
//   otherwise in a global scratch buffer that the wrapper allocates, one
//   region per CTA, read and written in the same order (each thread only
//   touches the entries it writes itself), then takes the scales from it,
//   all stacked frames sharing each cluster exchange. The median's two
//   ranks k_lo = floor((n-1)/2), k_hi = floor(n/2) are found by an exact
//   radix select over order-preserving uint32 keys (8-bit digits, 256-bin
//   shared-memory histograms built with warp-aggregated atomics and merged
//   over the cluster, 4 rounds, one histogram per rank after the first);
//   the 24 value-domain bisection steps of the reference
//   (fused_solve.py:259-297) are then replayed on one lane against the
//   selected value, with the same [min, max] bracket (NaN propagating) and
//   midpoints: the bisection's count(mask & v <= mid) >= k + 1 holds
//   exactly when the k-th smallest non-NaN value is <= mid, so the result
//   is the counting loop's bit for bit. At most 4 exchanges per median for
//   all frames (2 where the residuals are integers, as nearest samples of
//   8-bit images give: a bucket that holds one value ends the select)
//   instead of 26 block-wide count passes per frame. The
//   order-dependent sums (mean, sum |r - med|, t-distribution) keep the
//   block order and add the cluster's partials in rank order.
//
// Tensor cores are not used: JᵀWJ is 28 f32 sums per point in a fixed
// order that the plain version and the JAX parity tests (f32, "highest")
// rely on; TF32 mma would change both.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_sample.cuh"

namespace vslam {

constexpr int kOut = 64;  // A (36), b (6), chi2, iterations, valid, R (9), t (3)
// CTAs per pair (one cluster), chosen on the card by the robust-profile and
// align_pairs device times of 1, 2, 4 and 8 (PERF.md, Findings); mirrored by
// fused_solve.CTAS
constexpr int kCtas = 4;
constexpr int kShareAlign = 16;  // a CTA's share of a frame is a multiple of this many points

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
  int share;  // points of a frame per CTA (S)
  int stage;  // level data copied into shared memory
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
  // the residual cache in global memory, (B, kCtas, F, S), where the shared
  // one does not fit (cache_global, set at launch); else unused
  float* cache_r;
  unsigned char* cache_vis;
  int cache_global;
  float* out;        // (B, kOut)
  float* chi2_hist;  // (B, max_iterations)
  float* step_hist;  // (B, max_iterations)
};

constexpr int kBisectSteps = 24;      // halvings of the [min, max] bracket per rank
constexpr int kTdistIterations = 30;  // t-distribution fixed point budget
constexpr float kTdistTol = 1e-5f;
constexpr float kTukeyC = 4.6851f;
constexpr unsigned kFull = 0xffffffffu;

// NaN-propagating max and min, as jnp.maximum / torch.maximum
__device__ __forceinline__ float maxp(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float minp(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
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

// The Cholesky solve with log|det| of solvers/linalg6.py (-inf when a pivot
// is <= 1e-10 x the largest diagonal entry or the scale is not finite), on
// the 32 lanes of a warp, every lane returning the same logdet and x. Lane
// i < 6 holds row i of A and of L. Column j: lane j forms the pivot, lanes
// i > j their entry, each entry by the serial form's sequence of operations
// (its sum over k = 0..j-1 in order); the forward substitution runs by
// columns (y_i still subtracts k = 0..i-1 in order); the back substitution,
// whose sums need x in the other order, runs alike on every lane.
__device__ float chol6_logdet_solve_warp(const float* A, const float* b, float (&x)[6]) {
  const int lane = threadIdx.x & 31;
  const int row = lane < 6 ? lane : 5;  // lanes 6..31 shadow row 5; nothing reads them
  float a[6], L[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, dg = 1.0f;
#pragma unroll
  for (int c = 0; c < 6; ++c) a[c] = A[6 * row + c];
  float scale = A[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) scale = maxp(scale, A[7 * j]);
  bool bad = !isfinite(scale);
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = a[j];  // the pivot, as lane j forms it
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[k] * L[k];
    s = __shfl_sync(kFull, s, j);
    bad = bad || (s <= 1e-10f * scale);
    const float d = sqrtf(maxp(s, 1e-30f));
    const float inv_d = 1.0f / d;
    float si = a[j];
#pragma unroll
    for (int k = 0; k < j; ++k) si -= L[k] * __shfl_sync(kFull, L[k], j);
    if (row == j) dg = d;
    L[j] = row == j ? d : si * inv_d;
  }
  const float lg = logf(dg);
  float logdet = __shfl_sync(kFull, lg, 0);
#pragma unroll
  for (int j = 1; j < 6; ++j) logdet += __shfl_sync(kFull, lg, j);
  logdet = bad ? -INFINITY : 2.0f * logdet;
  float s = b[row], y[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    y[k] = __shfl_sync(kFull, s / dg, k);
    if (row > k) s -= L[k] * y[k];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float t = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) t -= __shfl_sync(kFull, L[i], k) * x[k];
    x[i] = t / __shfl_sync(kFull, dg, i);
  }
  return logdet;
}

// ---------------------------------------------------------------------------
// Cluster-wide exchanges of the robust scale
// ---------------------------------------------------------------------------

// One frame's part of a slot of the ring through which the CTAs of a
// cluster exchange the robust scale's partial results; all stacked frames
// share every exchange. Exchange number x uses slot x % 3 (F FrameSlots);
// while a CTA prepares exchange x it clears slot (x + 1) % 3, whose last
// readers (exchange x - 2) all passed exchange x - 1's barrier before.
struct __align__(16) FrameSlot {
  int hist[2][256];              // radix histograms, one per rank
  int odd[2][256];               // keys whose lower bits are not the bucket's canonical ones
  float mn[kWarps], mx[kWarps];  // per-warp min / max of the values (round 0)
  float sum;                     // a CTA's partial of an order-dependent sum
};
constexpr int kSlotCounts = 1024;  // hist and odd, cleared together

// the state of one rank's radix select
struct Select {
  unsigned prefix;  // the key digits selected so far (the whole key once done)
  unsigned krem;    // the rank within the keys that share the prefix
  int exists;       // k < the number of non-NaN masked values
  int done;         // the whole key is known
};

// one frame's robust scale, the same in every CTA of the cluster
struct FrameScale {
  Select sel[2];
  float mm[2];      // min, max of the values over the cluster
  float hi[2];      // each rank's bisection result
  float total;      // the cluster's sum of the last exchange
  float offset, sigma;
  float sig;        // t-distribution fixed point
  int active;
};

// The robust entry's shared memory and the running exchange count.
struct Robust {
  FrameSlot* ring;    // [3][F]
  FrameScale* fs;     // [F]
  float* wsum;        // [F][kWarps] per-warp partials of a sum
  float* rc;          // [F][S] residual cache, 0 where invisible
  unsigned char* vc;  // [F][S] visibility
  int F, S, xc;
};

struct Frame {             // a CTA's share of one frame's data
  const float* pcl;        // n x 3
  const float* J;          // n x 6
  const float* templ;      // n
  const unsigned char* mask;
  int n;                   // points in the share
};

__device__ __forceinline__ void cluster_sync() { cluster_barrier<kCtas>(); }

// ``p`` in the shared memory of the cluster's CTA ``rank``
template <typename T>
__device__ __forceinline__ T* at_rank(T* p, int rank) {
  return rank_ptr<kCtas>(p, rank);
}

// The cluster's sum of a CTA partial, in rank order.
__device__ __forceinline__ float cluster_total(float* local_sum) {
  float t = *at_rank(local_sum, 0);
#pragma unroll
  for (int c = 1; c < kCtas; ++c) t += *at_rank(local_sum, c);
  return t;
}

// Order-preserving uint32 key of a non-NaN float (-0 just below +0).
__device__ __forceinline__ unsigned float_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Add one to bin ``bin`` (none when < 0) for every lane of the warp, one
// shared-memory atomic per distinct bin.
__device__ __forceinline__ void warp_count(int* hist, int bin) {
  const unsigned peers = __match_any_sync(kFull, bin);
  if (bin >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(hist + bin, __popc(peers));
}

__device__ __forceinline__ FrameSlot* slot_of(const Robust& R) {
  return R.ring + (size_t)(R.xc % 3) * R.F;
}

// Publish the current exchange: clear the slot after it, then the cluster
// barrier.
__device__ __forceinline__ void publish(const Robust& R) {
  FrameSlot* next = R.ring + (size_t)((R.xc + 1) % 3) * R.F;
  for (int e = threadIdx.x; e < R.F * kSlotCounts; e += kThreads)
    (&next[e / kSlotCounts].hist[0][0])[e % kSlotCounts] = 0;
  cluster_sync();
}

// One thread's partial v of a frame's sum to the warp's slot dst[warp] (a
// shuffle-down tree).
__device__ __forceinline__ void warp_partial(float v, float* dst) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) dst[threadIdx.x >> 5] = v;
}

// After every frame's warp partials: each frame's CTA partial (the warps in
// sequence), the exchange, and the frame's cluster total in rank order to
// fs[f].total. Ends synchronized.
__device__ void exchange_sums(Robust& R) {
  __syncthreads();
  FrameSlot* slot = slot_of(R);
  for (int f = threadIdx.x; f < R.F; f += kThreads) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += R.wsum[f * kWarps + w];
    slot[f].sum = t;
  }
  publish(R);
  for (int f = threadIdx.x; f < R.F; f += kThreads) R.fs[f].total = cluster_total(&slot[f].sum);
  ++R.xc;
  __syncthreads();
}

// The calling warp: the bucket of rank j's key digit in the cluster's
// merged histogram of this round. Lane l sums bins 8l..8l+7 over the CTAs,
// a warp scan finds the lane whose range holds the rank. Where no key of
// the chosen bucket has other lower bits than the canonical ones (all
// zeros above zero, all ones below: the keys of the values an integer
// shares its bucket with have these), every key of the bucket is the
// same and the select is done.
__device__ void find_bucket(FrameSlot& slot, Select& sel, int j, int round, unsigned k0) {
  const int lane = threadIdx.x & 31;
  const int h = round == 0 ? 0 : j;
  int cnt[8], sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) cnt[i] = 0;
#pragma unroll
  for (int c = 0; c < kCtas; ++c) {
    const int4* src = reinterpret_cast<const int4*>(at_rank(&slot.hist[h][8 * lane], c));
    const int4 lo = src[0], hi = src[1];
    cnt[0] += lo.x; cnt[1] += lo.y; cnt[2] += lo.z; cnt[3] += lo.w;
    cnt[4] += hi.x; cnt[5] += hi.y; cnt[6] += hi.z; cnt[7] += hi.w;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) sum += cnt[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  const unsigned excl = (unsigned)(incl - sum), total = (unsigned)__shfl_sync(kFull, incl, 31);
  const unsigned k = round == 0 ? k0 : sel.krem;
  const bool exists = round == 0 ? k < total : sel.exists != 0;
  const bool mine = exists && k >= excl && k < (unsigned)incl;
  unsigned bin = 0, krem = 0;
  if (mine) {
    unsigned acc = excl;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (k < acc + (unsigned)cnt[i]) {
        bin = 8 * lane + i;
        krem = k - acc;
        break;
      }
      acc += (unsigned)cnt[i];
    }
  }
  int odd = 0;
  if (mine && round < 3)
    for (int c = 0; c < kCtas; ++c) odd += *at_rank(&slot.odd[h][bin], c);
  const unsigned who = __ballot_sync(kFull, mine);
  if (who) {
    bin = __shfl_sync(kFull, bin, __ffs(who) - 1);
    krem = __shfl_sync(kFull, krem, __ffs(who) - 1);
    odd = __shfl_sync(kFull, odd, __ffs(who) - 1);
  }
  if (lane == 0) {
    const unsigned prefix = round == 0 ? bin : (sel.prefix << 8) | bin;
    const int low = 24 - 8 * round;  // bits below this round's digit
    sel.exists = exists;
    sel.krem = krem;
    sel.done = exists && (round == 3 || odd == 0);
    sel.prefix = (sel.done && low > 0) ? (prefix << low) | ((prefix >> (31 - low)) & 1u ? 0u : (1u << low) - 1u)
                                       : prefix;
  }
}

// Masked medians of value(r) over the CTA shares of each frame's interest
// set, as the reference's 24-step value bisection computes them: ranks
// k_lo = floor((n-1)/2), k_hi = floor(n/2) of the n = n_constraints
// entries, each the smallest x of the bisection of [min, max] (NaN making
// the bracket empty) with count(mask & value <= x) >= k + 1
// (fused_solve.py:259-297). Both ranks of every frame are selected exactly
// in at most 4 radix rounds, one exchange each (fewer where a bucket holds
// one value only, as integer residuals do after 2), then the bisection is
// replayed against them; the results go to fs[f].hi. value is r, or
// |r - fs[f].offset| (``absdev``: the MAD's second pass). Every thread
// reads only the cache entries it wrote itself. Ends synchronized.
template <typename FrameFn>
__device__ void select_medians(const SolveParams& p, int pair, Robust& R, FrameFn frame, bool absdev) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int round = 0; round < 4; ++round) {
    FrameSlot* slot = slot_of(R);
    const int shift = 32 - 8 * round;  // bits of the selected prefix: key >> shift
    const unsigned low_mask = round < 3 ? (1u << (shift - 8)) - 1u : 0u;  // bits below the digit
    for (int f = 0; f < R.F; ++f) {
      const Frame fr = frame(f);
      const float* rc = R.rc + (size_t)f * R.S;
      const float center = absdev ? R.fs[f].offset : 0.0f;
      const Select sel0 = R.fs[f].sel[0], sel1 = R.fs[f].sel[1];
      const bool live0 = round == 0 || (sel0.exists && !sel0.done);
      const bool live1 = round > 0 && sel1.exists && !sel1.done;
      if (!live0 && !live1) continue;
      float mn = INFINITY, mx = -INFINITY;
      for (int i0 = tid - lane; i0 < fr.n; i0 += kThreads) {
        const int i = i0 + lane;
        int b0 = -1, b1 = -1;
        bool odd = false;
        if (i < fr.n && fr.mask[i]) {
          const float v = absdev ? fabsf(rc[i] - center) : rc[i];
          if (round == 0) {  // the bracket: a NaN makes it empty, as in the reference
            mn = minp(mn, v);
            mx = maxp(mx, v);
          }
          if (!isnan(v)) {
            const unsigned key = float_key(v);
            const int digit = (int)((key >> (shift - 8)) & 255u);
            odd = (key & low_mask) != ((key >> 31) ? 0u : low_mask);
            if (round == 0) {
              b0 = digit;
            } else {
              if (live0 && (key >> shift) == sel0.prefix) b0 = digit;
              if (live1 && (key >> shift) == sel1.prefix) b1 = digit;
            }
          }
        }
        warp_count(slot[f].hist[0], b0);
        if (round < 3) warp_count(slot[f].odd[0], odd ? b0 : -1);
        if (round > 0) {
          warp_count(slot[f].hist[1], b1);
          if (round < 3) warp_count(slot[f].odd[1], odd ? b1 : -1);
        }
      }
      if (round == 0) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          mn = minp(mn, __shfl_down_sync(kFull, mn, o));
          mx = maxp(mx, __shfl_down_sync(kFull, mx, o));
        }
        if (lane == 0) {
          slot[f].mn[warp] = mn;
          slot[f].mx[warp] = mx;
        }
      }
    }
    publish(R);
    // warp 2f + j finds rank j of frame f
    for (int fw = warp; fw < 2 * R.F; fw += kWarps) {
      const int f = fw >> 1, j = fw & 1;
      FrameScale& fs = R.fs[f];
      if (round > 0 && (!fs.sel[j].exists || fs.sel[j].done)) continue;
      const float n = p.n_constraints[(size_t)pair * R.F + f];
      const float k = j == 0 ? fmaxf(floorf((n - 1.0f) * 0.5f), 0.0f) : fmaxf(floorf(n * 0.5f), 0.0f);
      find_bucket(slot[f], fs.sel[j], j, round, (unsigned)k);
      if (round == 0 && j == 0) {  // the bracket over the cluster
        float a = INFINITY, b = -INFINITY;
        for (int e = lane; e < kCtas * kWarps; e += 32) {
          const FrameSlot* x = at_rank(&slot[f], e / kWarps);
          a = minp(a, x->mn[e % kWarps]);
          b = maxp(b, x->mx[e % kWarps]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          a = minp(a, __shfl_down_sync(kFull, a, o));
          b = maxp(b, __shfl_down_sync(kFull, b, o));
        }
        if (lane == 0) {
          fs.mm[0] = a;
          fs.mm[1] = b;
        }
      }
    }
    ++R.xc;
    __syncthreads();
    bool open = false;  // a rank of a frame still selecting (the same in every thread)
    for (int f = 0; f < R.F; ++f)
      for (int j = 0; j < 2; ++j) open = open || (R.fs[f].sel[j].exists && !R.fs[f].sel[j].done);
    if (!open) break;
  }
  // replay the bisection against each selected value
  if (lane == 0)
    for (int fw = warp; fw < 2 * R.F; fw += kWarps) {
      FrameScale& fs = R.fs[fw >> 1];
      const Select& sel = fs.sel[fw & 1];
      const float v = key_float(sel.prefix);
      const bool empty = !(fs.mm[1] >= fs.mm[0]);
      float lo = empty ? 0.0f : fs.mm[0], hi = empty ? 0.0f : fs.mm[1];
      for (int step = 0; step < kBisectSteps; ++step) {
        const float mid = 0.5f * (lo + hi);
        if (sel.exists && v <= mid) hi = mid; else lo = mid;
      }
      fs.hi[fw & 1] = hi;
    }
  __syncthreads();
}

__device__ __forceinline__ float median_of(const SolveParams& p, int pair, const Robust& R, int f) {
  const float n = p.n_constraints[(size_t)pair * R.F + f];
  return n > 0.0f ? 0.5f * (R.fs[f].hi[0] + R.fs[f].hi[1]) : 0.0f;
}

// Each frame's sum of |r - fs[f].offset| over its interest set, in the
// kernel's order, to fs[f].total.
template <typename FrameFn>
__device__ void absdev_sums(Robust& R, FrameFn frame) {
  for (int f = 0; f < R.F; ++f) {
    const Frame fr = frame(f);
    const float* rc = R.rc + (size_t)f * R.S;
    const float center = R.fs[f].offset;
    float acc = 0.0f;
    for (int i = threadIdx.x; i < fr.n; i += kThreads)
      if (fr.mask[i]) acc += fabsf(rc[i] - center);
    warp_partial(acc, R.wsum + f * kWarps);
  }
  exchange_sums(R);
}

// (offset, sigma) of every frame's cached residuals over its interest set
// to fs[f], the same in every CTA (fused_solve.py:234-338); all frames
// share each exchange. Ends synchronized.
template <typename FrameFn>
__device__ void robust_scales(const SolveParams& p, int pair, Robust& R, FrameFn frame) {
  const int tid = threadIdx.x;
  const float* n_f = p.n_constraints + (size_t)pair * R.F;
  if (p.loss_kind == 3) {
    // t-distribution fixed point, whatever the scaler (Scaler.cpp:49-67);
    // each frame stops at its own step <= tol
    const float vp1 = p.tdist_v + 1.0f;
    for (int f = tid; f < R.F; f += kThreads) {
      R.fs[f].sig = 1.0f;
      R.fs[f].active = 1;
    }
    __syncthreads();
    for (int it = 0; it < kTdistIterations; ++it) {
      bool any = false;
      for (int f = 0; f < R.F; ++f) any = any || R.fs[f].active;
      if (!any) break;
      for (int f = 0; f < R.F; ++f) {
        const Frame fr = frame(f);
        const float* rc = R.rc + (size_t)f * R.S;
        const float sigma2 = fmaxf(R.fs[f].sig * R.fs[f].sig, 1e-24f);
        float acc = 0.0f;
        for (int i = tid; i < fr.n; i += kThreads) {
          if (!fr.mask[i]) continue;
          const float r2 = rc[i] * rc[i];
          acc += r2 * vp1 / (p.tdist_v + r2 / sigma2);
        }
        warp_partial(acc, R.wsum + f * kWarps);
      }
      exchange_sums(R);
      for (int f = tid; f < R.F; f += kThreads) {
        FrameScale& fs = R.fs[f];
        const float sig_new = sqrtf(fs.total / fmaxf(n_f[f], 1.0f));
        if (fs.active) {
          fs.active = fabsf(fs.sig - sig_new) > kTdistTol;
          fs.sig = sig_new;
        }
      }
      __syncthreads();
    }
    for (int f = tid; f < R.F; f += kThreads) {
      R.fs[f].offset = 0.0f;
      R.fs[f].sigma = fmaxf(R.fs[f].sig, 1e-12f);
    }
  } else if (p.scaler_kind == 2) {
    // mean (Scaler.cpp:37-47); an empty set gives offset 0, scale 1
    for (int f = 0; f < R.F; ++f) {
      const Frame fr = frame(f);
      const float* rc = R.rc + (size_t)f * R.S;
      float acc = 0.0f;
      for (int i = tid; i < fr.n; i += kThreads)
        if (fr.mask[i]) acc += rc[i];
      warp_partial(acc, R.wsum + f * kWarps);
    }
    exchange_sums(R);
    for (int f = tid; f < R.F; f += kThreads) R.fs[f].offset = R.fs[f].total / fmaxf(n_f[f], 1.0f);
    __syncthreads();
    absdev_sums(R, frame);
    for (int f = tid; f < R.F; f += kThreads) {
      FrameScale& fs = R.fs[f];
      const float spread = sqrtf(fs.total / fmaxf(n_f[f] - 1.0f, 1.0f));
      const bool empty = n_f[f] < 1.0f;
      fs.offset = empty ? 0.0f : fs.offset;
      fs.sigma = (empty || spread <= 0.0f) ? 1.0f : spread;
    }
  } else {
    select_medians(p, pair, R, frame, false);
    for (int f = tid; f < R.F; f += kThreads) R.fs[f].offset = median_of(p, pair, R, f);
    __syncthreads();
    if (p.scaler_kind == 1) {
      // MAD: 1.4826 median |r - med|
      select_medians(p, pair, R, frame, true);
      for (int f = tid; f < R.F; f += kThreads) {
        const float sig = 1.4826f * median_of(p, pair, R, f);
        R.fs[f].sigma = sig > 1e-6f ? sig : 1.0f;
      }
    } else {
      // the reference's median scaler: sqrt(sum |r - med| / (n - 1))
      absdev_sums(R, frame);
      for (int f = tid; f < R.F; f += kThreads) {
        const float spread = sqrtf(R.fs[f].total / fmaxf(n_f[f] - 1.0f, 1.0f));
        R.fs[f].sigma = spread > 0.0f ? spread : 1.0f;
      }
    }
  }
  __syncthreads();
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

// Per-frame constants of the tail, loaded once per launch: 1 / n (1 when
// n <= 1) and x_pred.
constexpr int kFrameConst = 8;

// Stacked element e (A 0..35 row-major, b 36..41, chi2 42) of frame f: the
// cluster's Gram sum k of the element normalized by the interest-point
// count, with the prior (x 1/255^2, + w on the diagonal, b += w (x -
// x_pred)).
__device__ __forceinline__ float stacked_element(const SolveParams& p, float* gx, const float* xlog,
                                                 const float* fconst, int f, int e, int k) {
  const float* fc = fconst + kFrameConst * f;
  float v = cluster_total(gx + (size_t)f * kGram + k) * fc[0];
  if (p.include_prior) {
    const float nrm = 1.0f / (255.0f * 255.0f);
    if (e < 36) {
      v *= nrm;
      if (e % 7 == 0) v += p.prior_weight;
    } else if (e < 42) {
      const int a = e - 36;
      v = v * nrm + p.prior_weight * (xlog[6 * f + a] - fc[1 + a]);
    }
  }
  return v;
}

// the Gram sum of stacked element e
__device__ __forceinline__ int gram_index(int e) {
  if (e < 36) {
    const int a = e / 6, c = e % 6, lo = min(a, c), hi = max(a, c);
    return lo * 6 - lo * (lo - 1) / 2 + (hi - lo);
  }
  return e < 42 ? kGramB + (e - 36) : kGramChi2;
}

// Each warp's sum of the per-thread Gram partials (a shuffle-down tree per
// value, block_reduce's first half) to dst[warp][k].
__device__ __forceinline__ void warp_partials(float (&acc)[kGram], float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kGram; ++k) {
    float v = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) dst[warp * kGram + k] = v;
  }
}

// ---------------------------------------------------------------------------
// Dynamic shared memory
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets into a CTA's dynamic shared memory: the Gram exchange (two
// slots of F x kGram CTA partials), the per-warp Gram partials, the prior's
// log per frame; for the robust entry the exchange ring, the per-frame
// scale state and sum partials and, unless it lives in global memory
// (``global_cache``), the cache of every frame's share (r, visibility); and,
// when staged, the level data of the share (pcl, J, template, mask).
struct Layout {
  size_t gram, warp, xlog, fconst, ring, fs, wsum, r, vis, pcl, J, templ, mask, unstaged, staged;
};

__host__ __device__ inline Layout make_layout(int F, int S, bool robust, bool global_cache) {
  Layout L;
  size_t o = 0;
  L.gram = o;
  o = align16(o + sizeof(float) * 2 * F * kGram);
  L.warp = o;
  o = align16(o + sizeof(float) * F * kWarps * kGram);
  L.xlog = o;
  o = align16(o + sizeof(float) * F * 6);
  L.fconst = o;
  o = align16(o + sizeof(float) * F * kFrameConst);
  const size_t FS = robust && !global_cache ? (size_t)F * S : 0, Fr = robust ? F : 0;
  L.ring = o;
  o = align16(o + sizeof(FrameSlot) * 3 * Fr);
  L.fs = o;
  o = align16(o + sizeof(FrameScale) * Fr);
  L.wsum = o;
  o = align16(o + sizeof(float) * kWarps * Fr);
  L.r = o;
  o = align16(o + sizeof(float) * FS);
  L.vis = o;
  o = align16(o + FS);
  L.unstaged = o;
  L.pcl = o;
  o = align16(o + sizeof(float) * 3 * F * S);
  L.J = o;
  o = align16(o + sizeof(float) * 6 * F * S);
  L.templ = o;
  o = align16(o + sizeof(float) * F * S);
  L.mask = o;
  o = align16(o + (size_t)F * S);
  L.staged = o;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// true where a piece goes by TMA bulk copy: 16-byte aligned, a multiple of
// 16 bytes, not empty (shared destinations are 16-byte aligned by layout)
__device__ __forceinline__ bool bulk_ok(const void* src, size_t bytes) {
  return bytes > 0 && ((reinterpret_cast<uintptr_t>(src) | bytes) & 15) == 0;
}

// Copy bytes global -> shared: by TMA when bulk_ok (thread 0 issues it,
// completion on ``bar``), else by the block's threads, 4 or 1 bytes each.
template <typename T>
__device__ __forceinline__ void stage_piece(T* dst, const T* src, int count, uint64_t* bar) {
  const size_t bytes = sizeof(T) * (size_t)count;
  if (bulk_ok(src, bytes)) {
    if (threadIdx.x == 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          :: "r"(smem_u32(dst)), "l"(src), "r"((unsigned)bytes), "r"(smem_u32(bar)) : "memory");
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <typename TImg, bool BILINEAR, bool ROBUST>
__global__ void __launch_bounds__(kThreads) solve_level_kernel(const SolveParams p) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ float s_delta[12];     // delta R (9), t (3)
  __shared__ float s_A[36];         // last accepted A, b
  __shared__ float s_b[6];
  __shared__ float s_Acur[36];      // this iteration's stacked A, b
  __shared__ float s_bcur[6];
  __shared__ float s_chi2cur;
  __shared__ int s_done;
  __shared__ __align__(8) uint64_t s_bar;

  const int rank = (int)(blockIdx.x % kCtas);  // the cluster is kCtas consecutive CTAs
  const int pair = (int)(blockIdx.x / kCtas);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int F = p.F;
  const int first = rank * p.share;
  const int n_share = max(0, min(p.share, p.P - first));
  const Layout lay = make_layout(F, p.share, ROBUST, p.cache_global != 0);
  float* gram_x = reinterpret_cast<float*>(s_dyn + lay.gram);    // [2][F][kGram]
  float* gram_w = reinterpret_cast<float*>(s_dyn + lay.warp);    // [F][kWarps][kGram]
  float* xlog = reinterpret_cast<float*>(s_dyn + lay.xlog);      // [F][6]
  float* fconst = reinterpret_cast<float*>(s_dyn + lay.fconst);  // [F][kFrameConst]
  const size_t cache_at = ((size_t)pair * kCtas + rank) * F * p.share;  // this CTA's [F][S] region
  Robust R = {reinterpret_cast<FrameSlot*>(s_dyn + lay.ring), reinterpret_cast<FrameScale*>(s_dyn + lay.fs),
              reinterpret_cast<float*>(s_dyn + lay.wsum),
              p.cache_global ? p.cache_r + cache_at : reinterpret_cast<float*>(s_dyn + lay.r),
              p.cache_global ? p.cache_vis + cache_at : s_dyn + lay.vis, F, p.share, 0};

  const TImg* img = static_cast<const TImg*>(p.image) + (size_t)pair * p.H * p.W;
  const Intrinsics K = {p.cam[4 * pair], p.cam[4 * pair + 1], p.cam[4 * pair + 2],
                        p.cam[4 * pair + 3]};
  float* chist = p.chi2_hist + (size_t)pair * p.max_iterations;
  float* shist = p.step_hist + (size_t)pair * p.max_iterations;
  if (rank == 0)
    for (int i = tid; i < p.max_iterations; i += kThreads) {
      chist[i] = NAN;
      shist[i] = NAN;
    }
  if (ROBUST)
    for (int e = tid; e < 3 * F * kSlotCounts; e += kThreads) (&R.ring[e / kSlotCounts].hist[0][0])[e % kSlotCounts] = 0;

  // the share's level data, staged once per launch where it fits
  auto frame = [&](int f) {
    const size_t off = ((size_t)pair * F + f) * p.P + first;
    Frame fr;
    fr.n = n_share;
    if (p.stage) {
      const size_t o = (size_t)f * p.share;
      fr.pcl = reinterpret_cast<const float*>(s_dyn + lay.pcl) + 3 * o;
      fr.J = reinterpret_cast<const float*>(s_dyn + lay.J) + 6 * o;
      fr.templ = reinterpret_cast<const float*>(s_dyn + lay.templ) + o;
      fr.mask = s_dyn + lay.mask + o;
    } else {
      fr.pcl = p.pcl + 3 * off;
      fr.J = p.J + 6 * off;
      fr.templ = p.templ + off;
      fr.mask = p.mask + off;
    }
    return fr;
  };
  if (p.stage) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(&s_bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();
    size_t bulk = 0;
    for (int f = 0; f < F; ++f) {
      const size_t off = ((size_t)pair * F + f) * p.P + first;
      bulk += bulk_ok(p.pcl + 3 * off, 12 * (size_t)n_share) ? 12 * (size_t)n_share : 0;
      bulk += bulk_ok(p.J + 6 * off, 24 * (size_t)n_share) ? 24 * (size_t)n_share : 0;
      bulk += bulk_ok(p.templ + off, 4 * (size_t)n_share) ? 4 * (size_t)n_share : 0;
      bulk += bulk_ok(p.mask + off, (size_t)n_share) ? (size_t)n_share : 0;
    }
    if (tid == 0 && bulk > 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem_u32(&s_bar)), "r"((unsigned)bulk) : "memory");
    __syncthreads();
    for (int f = 0; f < F; ++f) {
      const size_t off = ((size_t)pair * F + f) * p.P + first;
      const size_t o = (size_t)f * p.share;
      stage_piece(reinterpret_cast<float*>(s_dyn + lay.pcl) + 3 * o, p.pcl + 3 * off, 3 * n_share, &s_bar);
      stage_piece(reinterpret_cast<float*>(s_dyn + lay.J) + 6 * o, p.J + 6 * off, 6 * n_share, &s_bar);
      stage_piece(reinterpret_cast<float*>(s_dyn + lay.templ) + o, p.templ + off, n_share, &s_bar);
      stage_piece(s_dyn + lay.mask + o, p.mask + off, n_share, &s_bar);
    }
    if (bulk > 0) {
      uint32_t done = 0;
      while (!done)
        asm volatile(
            "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; selp.u32 %0, 1, 0, p; }"
            : "=r"(done) : "r"(smem_u32(&s_bar)) : "memory");
    }
  }

  // solver state, the same in every CTA of the cluster (warp 0 keeps it)
  float chi2_prev = INFINITY, n_total = 0.0f;
  int pushed = 0, it = 0;
  if (tid == 0) {
    for (int k = 0; k < 12; ++k) s_delta[k] = (k < 9 && k % 4 == 0) ? 1.0f : 0.0f;
    for (int k = 0; k < 36; ++k) s_A[k] = (k % 7 == 0) ? 1.0f : 0.0f;
    for (int k = 0; k < 6; ++k) s_b[k] = 0.0f;
    s_done = p.max_iterations <= 0;
  }
  if (warp == 0)
    for (int f = 0; f < F; ++f) n_total += p.n_constraints[(size_t)pair * F + f];
  for (int f = tid; f < F; f += kThreads) {
    const size_t bf = (size_t)pair * F + f;
    const float n = p.n_constraints[bf];
    fconst[kFrameConst * f] = n > 1.0f ? 1.0f / fmaxf(n, 1.0f) : 1.0f;
    for (int a = 0; a < 6; ++a) fconst[kFrameConst * f + 1 + a] = p.x_pred[6 * bf + a];
  }

  for (;;) {
    __syncthreads();  // s_delta / s_done / the staged data published
    if (s_done) break;
    float Rd[9], td[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) Rd[k] = s_delta[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) td[k] = s_delta[9 + k];
    // the prior's log of each frame's pose, one lane per frame of the last
    // warp (the one with the fewest points), off the tail's path
    if (p.include_prior && warp == kWarps - 1)
      for (int f = lane; f < F; f += 32) {
        Pose T;
        compose_frame(p, (size_t)pair * F + f, Rd, td, T);
        se3_log_series(T.R, T.t, xlog + 6 * f);
      }

    if constexpr (ROBUST) {
      // pass A over every frame's share: cache r (0 where invisible) and
      // the visibility; each thread later re-reads only the entries it
      // writes here
      for (int f = 0; f < F; ++f) {
        Pose T;
        compose_frame(p, (size_t)pair * F + f, Rd, td, T);
        const Frame fr = frame(f);
        float* rc = R.rc + (size_t)f * p.share;
        unsigned char* vc = R.vc + (size_t)f * p.share;
        for (int i = tid; i < fr.n; i += kThreads) {
          float r = 0.0f, u, v;
          unsigned char vis = 0;
          if (fr.mask[i] && warp_project(T, K, fr.pcl[3 * i], fr.pcl[3 * i + 1], fr.pcl[3 * i + 2],
                                         p.H, p.W, u, v)) {
            r = sample<BILINEAR>(img, p.W, u, v) - fr.templ[i];
            vis = 1;
          }
          rc[i] = r;
          vc[i] = vis;
        }
      }
      // every frame's scale over its interest set, from the cache
      robust_scales(p, pair, R, frame);
      // pass B: weighted Gram sums over the visible points
      for (int f = 0; f < F; ++f) {
        const Frame fr = frame(f);
        const float* rc = R.rc + (size_t)f * p.share;
        const unsigned char* vc = R.vc + (size_t)f * p.share;
        const float offset = R.fs[f].offset, sigma = R.fs[f].sigma;
        float acc[kGram];
#pragma unroll
        for (int k = 0; k < kGram; ++k) acc[k] = 0.0f;
        for (int i = tid; i < fr.n; i += kThreads) {
          if (!vc[i]) continue;
          const float r = rc[i];
          const float w = robust_weight(p, (r - offset) / sigma);
          float j[6];
#pragma unroll
          for (int k = 0; k < 6; ++k) j[k] = fr.J[6 * i + k];
          gram_accumulate_weighted(acc, j, r, w);
        }
        warp_partials(acc, gram_w + (size_t)f * kWarps * kGram);
      }
    } else {
      // one point pass over every frame's share
      for (int f = 0; f < F; ++f) {
        Pose T;
        compose_frame(p, (size_t)pair * F + f, Rd, td, T);
        const Frame fr = frame(f);
        float acc[kGram];
#pragma unroll
        for (int k = 0; k < kGram; ++k) acc[k] = 0.0f;
        for (int i = tid; i < fr.n; i += kThreads) {
          if (!fr.mask[i]) continue;
          float u, v;
          if (!warp_project(T, K, fr.pcl[3 * i], fr.pcl[3 * i + 1], fr.pcl[3 * i + 2], p.H, p.W, u, v))
            continue;
          const float r = sample<BILINEAR>(img, p.W, u, v) - fr.templ[i];
          float j[6];
#pragma unroll
          for (int k = 0; k < 6; ++k) j[k] = fr.J[6 * i + k];
          gram_accumulate(acc, j, r);
        }
        warp_partials(acc, gram_w + (size_t)f * kWarps * kGram);
      }
    }
    __syncthreads();
    // the CTA's partials (warps in sequence), then the cluster barrier
    float* gx = gram_x + (size_t)(it & 1) * F * kGram;
    for (int e = tid; e < F * kGram; e += kThreads) {
      const float* w = gram_w + (size_t)(e / kGram) * kWarps * kGram + e % kGram;
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) v += w[k * kGram];
      gx[e] = v;
    }
    cluster_sync();

    if (warp == 0) {
      // normalize by the interest-point count, add the prior, stack: one
      // output element per lane (A 0..35, b 36..41, chi2 42), the frames
      // in order
      float acc2[2] = {0.0f, 0.0f};
      const int e1 = lane + 32, k0 = gram_index(lane), k1 = gram_index(min(e1, 42));
      for (int f = 0; f < F; ++f) {
        acc2[0] += stacked_element(p, gx, xlog, fconst, f, lane, k0);
        if (e1 <= 42) acc2[1] += stacked_element(p, gx, xlog, fconst, f, e1, k1);
      }
      s_Acur[lane] = acc2[0];
      if (lane < 4) s_Acur[32 + lane] = acc2[1];
      else if (lane < 10) s_bcur[lane - 4] = acc2[1];
      else if (lane == 10) s_chi2cur = acc2[1];
      __syncwarp();
      const float chi2 = s_chi2cur;

      float dx[6];
      const float logdet = chol6_logdet_solve_warp(s_Acur, s_bcur, dx);
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

      float b_max = s_bcur[0];
      for (int k = 1; k < 6; ++k) b_max = maxp(b_max, s_bcur[k]);
      const float d_chi2 = fabsf(chi2 - chi2_prev);
      bool converged = pushed > 0 && (step < p.min_step_size || fabsf(b_max) < p.min_gradient ||
                                      d_chi2 < p.min_reduction);
      if (p.use_min_rel)
        converged = converged || (pushed > 0 && d_chi2 < p.min_relative_reduction * fabsf(chi2));

      // a NaN step is not an accepted iteration: delta rolls back and
      // A / b / chi2 keep the last accepted values
      const bool accepted = !abort && !nan_step;
      if (accepted) {
        s_A[lane] = s_Acur[lane];
        if (lane < 4) s_A[32 + lane] = s_Acur[32 + lane];
        else if (lane < 10) s_b[lane - 4] = s_bcur[lane - 4];
      }
      if (lane == 0) {
        if (rank == 0) {
          chist[it] = chi2;
          shist[it] = step;
        }
        if (accepted) {
          for (int k = 0; k < 9; ++k) s_delta[k] = R_new[k];
          for (int k = 0; k < 3; ++k) s_delta[9 + k] = t_new[k];
        }
        s_done = abort || nan_step || converged || it + 1 >= p.max_iterations;
      }
      if (accepted) {
        chi2_prev = chi2;
        ++pushed;
      }
    }
    ++it;
  }
  // no CTA leaves while another may still read its shared memory
  if constexpr (kCtas > 1) cluster_sync();

  if (rank == 0 && tid == 0) {
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

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Points of a frame per CTA: S = 16 ceil(P / 16 kCtas).
inline int share_of(int P) {
  const int unit = kShareAlign * kCtas;
  return (P + unit - 1) / unit * kShareAlign;
}

// Dynamic shared memory a CTA may take beside the kernel's static shared
// memory, on the current device.
template <typename Kernel>
int dynamic_smem_limit(Kernel kernel, int* limit) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess) *limit = optin - (int)attr.sharedSizeBytes;
  return (int)e;
}

// The launch of the kernel at p: with ``clusters`` null, launched on
// ``stream``; else only the most clusters of it the card holds at once.
template <typename TImg, bool BILINEAR, bool ROBUST>
int launch(SolveParams p, cudaStream_t stream, int* clusters) {
  auto kernel = solve_level_kernel<TImg, BILINEAR, ROBUST>;
  int limit = 0;
  const int err = dynamic_smem_limit(kernel, &limit);
  if (err != 0) return err;
  p.share = share_of(p.P);
  // the robust residual cache stays in shared memory wherever it fits
  const bool global_cache = ROBUST && make_layout(p.F, p.share, true, false).unstaged > (size_t)limit;
  if (global_cache && !clusters && (!p.cache_r || !p.cache_vis))
    return (int)cudaErrorInvalidValue;  // the wrapper allocates the global cache
  p.cache_global = global_cache;
  const Layout lay = make_layout(p.F, p.share, ROBUST, global_cache);
  if (lay.unstaged > (size_t)limit) return (int)cudaErrorInvalidValue;  // the wrapper raises first
  p.stage = lay.staged <= (size_t)limit;
  const size_t smem = p.stage ? lay.staged : lay.unstaged;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * kCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  if (clusters) {
    cfg.numAttrs = 1;
    return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  }
  cfg.numAttrs = kCtas > 1 ? 1 : 0;  // one CTA a pair: a plain launch
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool ROBUST>
int launch_checked(const SolveParams& p, int image_is_bf16, int bilinear, void* stream,
                   int* clusters = nullptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (image_is_bf16)
    return bilinear ? launch<__nv_bfloat16, true, ROBUST>(p, s, clusters)
                    : launch<__nv_bfloat16, false, ROBUST>(p, s, clusters);
  return bilinear ? launch<float, true, ROBUST>(p, s, clusters) : launch<float, false, ROBUST>(p, s, clusters);
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
// returns the launch's CUDA error code (0 = cudaSuccess).
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
// scaler_kind 0 reference, 1 MAD, 2 mean. cache_r (float) and cache_vis
// (byte), B x `vslam_solve_level_global_cache` points each, hold the
// residual cache where it does not fit in shared memory; null elsewhere.
extern "C" int vslam_solve_level_fused_robust(
    const void* pcl, const void* J, const void* templ, const void* mask,
    const void* n_constraints, const void* rel0_R, const void* rel0_t, const void* x_pred,
    const void* cam, const void* image, int image_is_bf16, int B, int F, int P, int H, int W,
    int bilinear, int include_prior, float prior_weight, int max_iterations,
    float min_step_size, float min_gradient, float min_reduction, float min_relative_reduction,
    int use_min_rel, int orthonormalize, int loss_kind, int scaler_kind, float huber_c,
    float tdist_v, void* cache_r, void* cache_vis, void* out, void* chi2_hist, void* step_hist,
    void* stream) {
  vslam::SolveParams p = vslam::make_params(
      pcl, J, templ, mask, n_constraints, rel0_R, rel0_t, x_pred, cam, image, B, F, P, H, W,
      include_prior, prior_weight, max_iterations, min_step_size, min_gradient, min_reduction,
      min_relative_reduction, use_min_rel, orthonormalize, out, chi2_hist, step_hist);
  p.loss_kind = loss_kind;
  p.scaler_kind = scaler_kind;
  p.huber_c = huber_c;
  p.tdist_v = tdist_v;
  p.cache_r = static_cast<float*>(cache_r);
  p.cache_vis = static_cast<unsigned char*>(cache_vis);
  return vslam::launch_checked<true>(p, image_is_bf16, bilinear, stream);
}

// The shared memory one CTA of the kernel needs at (F, P) without staging
// the level data (``need``), with the robust entry's residual cache in it,
// and what the card lets it take (``limit``), both in bytes; returns a CUDA
// error code. Where need > limit the robust entry keeps its cache in global
// memory (`vslam_solve_level_global_cache`).
extern "C" int vslam_solve_level_smem(int F, int P, int robust, int* need, int* limit) {
  const vslam::Layout lay = vslam::make_layout(F, vslam::share_of(P), robust != 0, false);
  *need = (int)lay.unstaged;
  return robust ? vslam::dynamic_smem_limit(vslam::solve_level_kernel<float, false, true>, limit)
                : vslam::dynamic_smem_limit(vslam::solve_level_kernel<float, false, false>, limit);
}

// The robust entry's residual cache in global memory at (F, P): its entries
// per pair (``points``, kCtas CTA shares of every frame) and the shared
// memory a CTA then needs without staging (``need``, bytes).
extern "C" int vslam_solve_level_global_cache(int F, int P, int* points, int* need) {
  const int share = vslam::share_of(P);
  *points = vslam::kCtas * F * share;
  *need = (int)vslam::make_layout(F, share, true, true).unstaged;
  return 0;
}

// The most clusters of the launch at (B, F, P) the card holds at once
// (cudaOccupancyMaxActiveClusters): fewer than B run in waves.
extern "C" int vslam_solve_level_clusters(int B, int F, int P, int robust, int image_is_bf16, int bilinear,
                                          int* clusters) {
  vslam::SolveParams p = {};
  p.B = B;
  p.F = F;
  p.P = P;
  return robust ? vslam::launch_checked<true>(p, image_is_bf16, bilinear, nullptr, clusters)
                : vslam::launch_checked<false>(p, image_is_bf16, bilinear, nullptr, clusters);
}
