// The per-iteration residual pass at one pose, for B pairs x F stacked
// reference frames x P interest points; two kernels.
//
// sample_level_kernel replaces the Pallas TPU kernel `_sample_level_kernel`
// of `fused_level_sample` (vslam_tpu/alignment/fused_ne.py:312, pallas_call
// at :341): per point the SE(3) warp, pinhole projection, visibility and the
// nearest or bilinear intensity sample; an invisible point samples pixel
// (0, 0), as the TPU kernel does (fused_ne.py:145-148), so every output is
// defined.
//
// level_ne_kernel replaces `_ne_kernel` of `fused_level_ne`
// (vslam_tpu/alignment/fused_ne.py:252, pallas_call at :280): the raw
// per-frame JᵀJ, Jᵀr, Σ r² and visible count at one pose, weight 1 on the
// visible points (the quadratic loss).
//
// What bounds them on an H100: latency, not bytes. Per point the sampler
// reads 13 B (pcl, mask) and writes 5 B, the NE kernel reads 41 B (pcl, J,
// template, mask), and each reads 1 or 4 scattered pixels; a few tens of
// operations per point stay far below the f32 rate. At the finest level of
// `align_pairs` (B = 64, F = 1, P = 1920) that is ~2-5 MB per call, resident
// in L2, and every point is a chain of dependent loads: pcl, then the warp,
// then a pixel. The NE kernel's reduction and output write are a fixed cost
// that the coarse levels (480 and 120 points a frame) barely amortize.
//
// What the design does about it:
// - NE: a frame of more than kNeClusterPoints points runs on a thread-block
//   cluster of kNeCtas CTAs (cudaLaunchKernelEx with a cluster dimension),
//   so its points spread over kNeCtas SMs; a smaller frame runs on one CTA,
//   because a cluster's launch and barriers cost more than it saves there
//   (the sweep in PERF.md). CTA c takes the contiguous share [c S, (c + 1) S)
//   of the frame's points (S = 16 ceil(P / 16 C)) and sums it in the
//   single-block order (thread t adds points t, t + 256, ...; the warp's
//   tree; the warps in sequence); rank 0 adds the CTAs' sums in rank order
//   through distributed shared memory (`fused_solve._block_sum(ctas=)` is
//   the plain twin) and 44 of its threads write A (both triangles), b, chi2
//   and n, one value each.
// - NE: a thread loads kNeInFlight of its points (pcl, J, template, mask)
//   before it warps and samples them, so their loads and pixel reads
//   overlap; the points left over go one at a time, so no thread computes a
//   point it does not have. The per-point work has no branch: an invisible
//   point's terms are selected to +0.0 (never multiplied by a 0/1 weight,
//   which turns inf into NaN), and adding +0.0 leaves a sum's value as it
//   is, as the plain version's zeros do.
// - NE: a warp sums its 29 values (padded to 32) by a reduce-scatter
//   (warp_sample.cuh `warp_reduce_scatter`): 31 shuffles instead of 145,
//   in the shuffle-down tree's pairing, so the bits are that tree's.
// - Sampler: a 2-D grid, blockIdx.y the (pair, frame) and blockIdx.x a chunk
//   of kSampleThreads x kSamplePts points, so no thread divides to find its
//   frame, and the pose and camera are one cache line for the whole block.
//   Above 65535 (pair, frame) rows, the y extent's limit, a block also
//   takes the rows 65535 apart.
//   A thread takes kSamplePts consecutive points (one, the sweep's choice;
//   with more, their pcl, mask, samples and visibility move as 16-, 8- or
//   4-byte vectors where the addresses allow).
//
// Not carried over: the TPU's one-hot matmul sampling, its 128-row bands
// (VSLAM_FUSED_BAND), the 8 x 1024 point packing (`pack_level`) and the
// (8, 128) output tiles. Mosaic has no gather; Hopper has one, so each point
// reads its pixels directly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "warp_sample.cuh"

namespace vslam {

constexpr int kNeOut = 44;  // A (36), b (6), chi2, n_visible
// CTAs per (pair, frame) of the NE kernel (one cluster) for frames of more
// than kNeClusterPoints points, one CTA for smaller frames; both chosen on
// the card by chip_smoke.py's sweep of 1, 2, 4 and 8 CTAs at every level
// (PERF.md, Findings). Mirrored by fused_ne.NE_CTAS and
// fused_ne.NE_CLUSTER_POINTS, which fix the plain version's sum order.
constexpr int kNeCtas = 2;
constexpr int kNeClusterPoints = 1024;
constexpr int kShareAlign = 16;  // a CTA's share of a frame is a multiple of this many points
// points an NE thread loads before it computes, chosen on the card from 1,
// 2 and 4 by chip_smoke.py's sweep
constexpr int kNeInFlight = 2;
// consecutive points per sampler thread, chosen on the card from 1, 2 and 4
// by chip_smoke.py's sweep, and threads per sampler block
constexpr int kSamplePts = 1;
constexpr int kSampleThreads = 128;

struct LevelParams {
  const float* pcl;            // (B, F, P, 3)
  const float* J;              // (B, F, P, 6), NE only
  const float* templ;          // (B, F, P), NE only
  const unsigned char* mask;   // (B, F, P) bool
  const float* rel_R;          // (B, F, 3, 3)
  const float* rel_t;          // (B, F, 3)
  const float* cam;            // (B, 4) fx, fy, cx, cy
  const void* image;           // (B, H, W) float or bf16
  int B, F, P, H, W;
  int share;  // points of a frame per NE CTA (S)
};

__device__ __forceinline__ Pose load_pose(const LevelParams& p, size_t bf) {
  Pose T;
#pragma unroll
  for (int k = 0; k < 9; ++k) T.R[k] = p.rel_R[9 * bf + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) T.t[k] = p.rel_t[3 * bf + k];
  return T;
}

__device__ __forceinline__ Intrinsics load_cam(const LevelParams& p, int b) {
  return {p.cam[4 * b], p.cam[4 * b + 1], p.cam[4 * b + 2], p.cam[4 * b + 3]};
}

// N values of T through the read-only cache as chunks of type C
template <typename C, int N, typename T>
__device__ __forceinline__ void load_chunks(T (&d)[N], const T* s) {
  constexpr int per = sizeof(C) / sizeof(T);
#pragma unroll
  for (int i = 0; i < N / per; ++i) {
    const C x = __ldg(reinterpret_cast<const C*>(s) + i);
    memcpy(&d[i * per], &x, sizeof(C));
  }
}

template <typename C, int N, typename T>
__device__ __forceinline__ void store_chunks(T* dst, const T (&v)[N]) {
  constexpr int per = sizeof(C) / sizeof(T);
#pragma unroll
  for (int i = 0; i < N / per; ++i) {
    C x;
    memcpy(&x, &v[i * per], sizeof(C));
    reinterpret_cast<C*>(dst)[i] = x;
  }
}

// The N consecutive values at s, in the widest loads (16, 8, 4 or 2 bytes)
// that their size and s's alignment allow.
template <int N, typename T>
__device__ __forceinline__ void load_vec(T (&d)[N], const T* s) {
  constexpr int bytes = N * sizeof(T);
  const uintptr_t a = reinterpret_cast<uintptr_t>(s);
  if constexpr (bytes % 16 == 0)
    if (a % 16 == 0) return load_chunks<uint4>(d, s);
  if constexpr (bytes % 8 == 0)
    if (a % 8 == 0) return load_chunks<uint2>(d, s);
  if constexpr (bytes % 4 == 0 && sizeof(T) < 4)
    if (a % 4 == 0) return load_chunks<unsigned>(d, s);
  if constexpr (bytes % 2 == 0 && sizeof(T) < 2)
    if (a % 2 == 0) return load_chunks<unsigned short>(d, s);
  load_chunks<T>(d, s);
}

// v to the N consecutive values at dst, in the widest stores allowed.
template <int N, typename T>
__device__ __forceinline__ void store_vec(T* dst, const T (&v)[N]) {
  constexpr int bytes = N * sizeof(T);
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if constexpr (bytes % 16 == 0)
    if (a % 16 == 0) return store_chunks<uint4>(dst, v);
  if constexpr (bytes % 8 == 0)
    if (a % 8 == 0) return store_chunks<uint2>(dst, v);
  if constexpr (bytes % 4 == 0 && sizeof(T) < 4)
    if (a % 4 == 0) return store_chunks<unsigned>(dst, v);
  if constexpr (bytes % 2 == 0 && sizeof(T) < 2)
    if (a % 2 == 0) return store_chunks<unsigned short>(dst, v);
  store_chunks<T>(dst, v);
}

// A thread's kSamplePts points from q0 of the (pair, frame) row bf.
template <bool BILINEAR, typename TImg>
__device__ __forceinline__ void sample_row(const LevelParams& p, size_t bf, int q0, float* iwxp,
                                           unsigned char* visible) {
  const int b = (int)(bf / p.F);
  const Pose T = load_pose(p, bf);
  const Intrinsics K = load_cam(p, b);
  const TImg* img = static_cast<const TImg*>(p.image) + (size_t)b * p.H * p.W;
  const size_t i0 = bf * p.P + q0;
  const bool whole = q0 + kSamplePts <= p.P;
  float c[3 * kSamplePts] = {};
  unsigned char m[kSamplePts] = {};
  if (whole) {
    load_vec(c, p.pcl + 3 * i0);
    load_vec(m, p.mask + i0);
  } else {
#pragma unroll
    for (int j = 0; j < kSamplePts; ++j)
      if (q0 + j < p.P) {
#pragma unroll
        for (int k = 0; k < 3; ++k) c[3 * j + k] = __ldg(p.pcl + 3 * (i0 + j) + k);
        m[j] = __ldg(p.mask + i0 + j);
      }
  }
  float iw[kSamplePts];
  unsigned char vis[kSamplePts];
#pragma unroll
  for (int j = 0; j < kSamplePts; ++j) {
    float u, v;
    const bool in_view = warp_project(T, K, c[3 * j], c[3 * j + 1], c[3 * j + 2], p.H, p.W, u, v);
    vis[j] = m[j] && in_view;
    iw[j] = sample<BILINEAR>(img, p.W, vis[j] ? u : 0.0f, vis[j] ? v : 0.0f);  // else pixel (0, 0)
  }
  if (whole) {
    store_vec(iwxp + i0, iw);
    store_vec(visible + i0, vis);
  } else {
#pragma unroll
    for (int j = 0; j < kSamplePts; ++j)
      if (q0 + j < p.P) {
        iwxp[i0 + j] = iw[j];
        visible[i0 + j] = vis[j];
      }
  }
}

template <bool BILINEAR, typename TImg>
__global__ void __launch_bounds__(kSampleThreads) sample_level_kernel(const LevelParams p, float* iwxp,
                                                                      unsigned char* visible) {
  const int q0 = (blockIdx.x * kSampleThreads + threadIdx.x) * kSamplePts;
  if (q0 >= p.P) return;
  // a row of blocks per (pair, frame); where B x F exceeds the grid's y
  // extent, each row of blocks also takes the rows gridDim.y apart
  for (size_t bf = blockIdx.y; bf < (size_t)p.B * p.F; bf += gridDim.y)
    sample_row<BILINEAR, TImg>(p, bf, q0, iwxp, visible);
}

// Add one point's Gram terms (weight 1) where it is visible; an invisible
// point adds +0.0 to each sum (its terms selected away, not multiplied by a
// 0/1 weight).
__device__ __forceinline__ void gram_add_visible(float (&acc)[32], const float (&j)[6], float r,
                                                 bool vis) {
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) acc[k++] += vis ? j[a] * j[b] : 0.0f;
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[kGramB + a] += vis ? j[a] * r : 0.0f;
  acc[kGramChi2] += vis ? r * r : 0.0f;
  acc[kGramCount] += vis ? 1.0f : 0.0f;
}

// The Gram sum behind output e: A's entry (e / 6, e % 6) from the upper
// triangle, then b (21..26), chi2 (27) and n_visible (28).
__device__ __forceinline__ int ne_sum_index(int e) {
  if (e >= 36) return e - 15;
  const int a = e / 6, c = e % 6, lo = min(a, c), hi = max(a, c);
  return lo * 6 - lo * (lo - 1) / 2 + (hi - lo);
}

// A CTA's share of one frame's points.
struct Share {
  const float* pcl;  // n x 3
  const float* J;    // n x 6
  const float* templ;
  const unsigned char* mask;
  int n;
};

// Add the N points i0, i0 + kThreads, ..., i0 + (N - 1) kThreads of the
// share to the sums: all their loads first, then the warps and samples,
// then the sums in point order.
template <int N, bool BILINEAR, typename TImg>
__device__ __forceinline__ void ne_points(float (&acc)[32], const Share& sh, int i0, const Pose& T,
                                          const Intrinsics& K, const TImg* img, int H, int W) {
  float c[N][3], j[N][6], t[N];
  bool m[N];
#pragma unroll
  for (int f = 0; f < N; ++f) {
    const int q = i0 + f * kThreads;
#pragma unroll
    for (int k = 0; k < 3; ++k) c[f][k] = __ldg(sh.pcl + 3 * q + k);
    load_vec(j[f], sh.J + 6 * q);
    t[f] = __ldg(sh.templ + q);
    m[f] = __ldg(sh.mask + q);
  }
  float r[N];
  bool vis[N];
#pragma unroll
  for (int f = 0; f < N; ++f) {
    float u, v;
    const bool in_view = warp_project(T, K, c[f][0], c[f][1], c[f][2], H, W, u, v);
    vis[f] = m[f] && in_view;
    r[f] = sample<BILINEAR>(img, W, vis[f] ? u : 0.0f, vis[f] ? v : 0.0f) - t[f];
  }
#pragma unroll
  for (int f = 0; f < N; ++f) gram_add_visible(acc, j[f], r[f], vis[f]);
}

// C CTAs per (pair, frame): one cluster, or one plain CTA for C = 1.
template <int C, bool BILINEAR, typename TImg>
__global__ void __launch_bounds__(kThreads) level_ne_kernel(const LevelParams p, float* out) {
  __shared__ float warp_sum[kWarps][32];
  __shared__ float cta_sum[32];
  const int rank = (int)(blockIdx.x % C);  // the cluster is C consecutive CTAs
  const size_t bf = blockIdx.x / C;
  const int b = (int)(bf / p.F);
  const Pose T = load_pose(p, bf);
  const Intrinsics K = load_cam(p, b);
  const TImg* img = static_cast<const TImg*>(p.image) + (size_t)b * p.H * p.W;
  const int first = rank * p.share;
  const size_t base = bf * p.P + first;
  const Share sh = {p.pcl + 3 * base, p.J + 6 * base, p.templ + base, p.mask + base,
                    max(min(p.share, p.P - first), 0)};

  float acc[32];  // kGram sums, padded to a warp's width
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
  int i0 = threadIdx.x;  // thread t takes points t, t + kThreads, ... in turn
  for (; i0 + (kNeInFlight - 1) * kThreads < sh.n; i0 += kNeInFlight * kThreads)
    ne_points<kNeInFlight, BILINEAR>(acc, sh, i0, T, K, img, p.H, p.W);
  for (; i0 < sh.n; i0 += kThreads) ne_points<1, BILINEAR>(acc, sh, i0, T, K, img, p.H, p.W);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_sum[warp][lane] = warp_reduce_scatter(acc);
  __syncthreads();
  if (threadIdx.x < kGram) {
    float s = warp_sum[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += warp_sum[w][threadIdx.x];
    cta_sum[threadIdx.x] = s;
  }
  cluster_barrier<C>();  // every CTA's sums are in its shared memory
  if (rank == 0 && threadIdx.x < kNeOut) {
    const int g = ne_sum_index(threadIdx.x);
    float s = *rank_ptr<C>(&cta_sum[g], 0);
#pragma unroll
    for (int c = 1; c < C; ++c) s += *rank_ptr<C>(&cta_sum[g], c);
    out[bf * kNeOut + threadIdx.x] = s;
  }
  if constexpr (C > 1) cluster_barrier<C>();  // no CTA exits while rank 0 reads it
}

template <bool BILINEAR, typename TImg>
int launch_sample(const LevelParams& p, float* iwxp, unsigned char* visible, cudaStream_t stream) {
  constexpr int chunk = kSampleThreads * kSamplePts;
  constexpr int kMaxGridY = 65535;
  const int rows = p.B * p.F;
  const dim3 grid((unsigned)((p.P + chunk - 1) / chunk), (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  sample_level_kernel<BILINEAR, TImg><<<grid, kSampleThreads, 0, stream>>>(p, iwxp, visible);
  return (int)cudaGetLastError();
}

template <int C, bool BILINEAR, typename TImg>
int launch_ne_on(LevelParams p, float* out, cudaStream_t stream) {
  const int unit = kShareAlign * C;
  p.share = (p.P + unit - 1) / unit * kShareAlign;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.B * p.F * C));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;  // one CTA a frame: a plain launch
  const cudaError_t e = cudaLaunchKernelEx(&cfg, level_ne_kernel<C, BILINEAR, TImg>, p, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// A frame of more than kNeClusterPoints points spreads over a cluster of
// kNeCtas CTAs, a smaller one runs on one CTA (fused_ne.ne_ctas).
template <bool BILINEAR, typename TImg>
int launch_ne(const LevelParams& p, float* out, cudaStream_t stream) {
  return p.P > kNeClusterPoints ? launch_ne_on<kNeCtas, BILINEAR, TImg>(p, out, stream)
                                : launch_ne_on<1, BILINEAR, TImg>(p, out, stream);
}

LevelParams make_level_params(const void* pcl, const void* J, const void* templ, const void* mask,
                              const void* rel_R, const void* rel_t, const void* cam,
                              const void* image, int B, int F, int P, int H, int W) {
  LevelParams p = {};
  p.pcl = static_cast<const float*>(pcl);
  p.J = static_cast<const float*>(J);
  p.templ = static_cast<const float*>(templ);
  p.mask = static_cast<const unsigned char*>(mask);
  p.rel_R = static_cast<const float*>(rel_R);
  p.rel_t = static_cast<const float*>(rel_t);
  p.cam = static_cast<const float*>(cam);
  p.image = image;
  p.B = B;
  p.F = F;
  p.P = P;
  p.H = H;
  p.W = W;
  return p;
}

// A launcher instantiated for the image type and the sampling mode.
#define VSLAM_DISPATCH(LAUNCH, ...)                                                   \
  (image_is_bf16 ? (bilinear ? LAUNCH<true, __nv_bfloat16>(__VA_ARGS__)               \
                             : LAUNCH<false, __nv_bfloat16>(__VA_ARGS__))             \
                 : (bilinear ? LAUNCH<true, float>(__VA_ARGS__) : LAUNCH<false, float>(__VA_ARGS__)))

}  // namespace vslam

// C entries for ctypes. Each launches on `stream` without synchronizing and
// returns the launch's error or cudaGetLastError() (0 = cudaSuccess).

// iwxp (B, F, P) f32 and visible (B, F, P) bool.
extern "C" int vslam_fused_level_sample(const void* pcl, const void* mask, const void* rel_R,
                                        const void* rel_t, const void* cam, const void* image,
                                        int image_is_bf16, int B, int F, int P, int H, int W,
                                        int bilinear, void* iwxp, void* visible, void* stream) {
  using namespace vslam;
  const LevelParams p =
      make_level_params(pcl, nullptr, nullptr, mask, rel_R, rel_t, cam, image, B, F, P, H, W);
  return VSLAM_DISPATCH(launch_sample, p, static_cast<float*>(iwxp),
                        static_cast<unsigned char*>(visible), static_cast<cudaStream_t>(stream));
}

// out (B, F, 44) f32: A (36, symmetric), b (6), chi2, n_visible.
extern "C" int vslam_fused_level_ne(const void* pcl, const void* J, const void* templ,
                                    const void* mask, const void* rel_R, const void* rel_t,
                                    const void* cam, const void* image, int image_is_bf16, int B,
                                    int F, int P, int H, int W, int bilinear, void* out,
                                    void* stream) {
  using namespace vslam;
  const LevelParams p =
      make_level_params(pcl, J, templ, mask, rel_R, rel_t, cam, image, B, F, P, H, W);
  return VSLAM_DISPATCH(launch_ne, p, static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}
