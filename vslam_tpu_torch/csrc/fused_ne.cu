// The per-iteration residual pass at one pose, for B pairs x F stacked
// reference frames x P interest points; two kernels.
//
// sample_level_kernel replaces the Pallas TPU kernel `_sample_level_kernel`
// of `fused_level_sample` (vslam_tpu/alignment/fused_ne.py:312, pallas_call
// at :341): per point the SE(3) warp, pinhole projection, visibility and the
// nearest or bilinear intensity sample; an invisible point samples pixel
// (0, 0), as the TPU kernel does (fused_ne.py:145-148), so every output is
// defined. One thread per (pair, frame, point), 256 a block.
//
// level_ne_kernel replaces `_ne_kernel` of `fused_level_ne`
// (vslam_tpu/alignment/fused_ne.py:252, pallas_call at :280): the raw
// per-frame JᵀJ, Jᵀr, Σ r² and visible count at one pose, weight 1 on the
// visible points (the quadratic loss). One 256-thread block per (pair,
// frame): each thread strides over the points with `gram_accumulate`, then
// the fixed-order `block_reduce` of warp_sample.cuh, and thread 0 writes the
// symmetric A from the upper triangle, b, chi2 and n_visible.
//
// What bounds them on an H100: bytes and latency. Per point the sampler
// reads 13 B (pcl, mask) and writes 5 B, the NE kernel reads 41 B (pcl, J,
// template, mask), and each reads 1 or 4 scattered pixels; a few tens of
// operations per point stay far below the f32 rate. At the finest level of
// `align_pairs` (B = 64, F = 1, P = 1920) that is ~2-5 MB per call, which is
// L2-resident, so the pass is bound by load latency. What the design does
// about it: coalesced per-point loads (consecutive threads, consecutive
// points), pixels through the read-only cache, no intermediate written to
// device memory by the NE kernel. The NE kernel runs B x F blocks (64 at
// the finest `align_pairs` level, fewer than the 132 SMs); splitting a
// frame's points over several blocks is later work.
//
// Not carried over: the TPU's one-hot matmul sampling, its 128-row bands
// (VSLAM_FUSED_BAND), the 8 x 1024 point packing (`pack_level`) and the
// (8, 128) output tiles. Mosaic has no gather; Hopper has one, so each point
// reads its pixels directly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "warp_sample.cuh"

namespace vslam {

constexpr int kNeOut = 44;  // A (36), b (6), chi2, n_visible

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

template <bool BILINEAR, typename TImg>
__global__ void __launch_bounds__(kThreads) sample_level_kernel(const LevelParams p, float* iwxp,
                                                                unsigned char* visible) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (size_t)p.B * p.F * p.P) return;
  const size_t bf = i / p.P;
  const int b = (int)(bf / p.F);
  const Pose T = load_pose(p, bf);
  const TImg* img = static_cast<const TImg*>(p.image) + (size_t)b * p.H * p.W;
  float u = 0.0f, v = 0.0f;
  const bool vis = p.mask[i] && warp_project(T, load_cam(p, b), __ldg(p.pcl + 3 * i),
                                             __ldg(p.pcl + 3 * i + 1), __ldg(p.pcl + 3 * i + 2),
                                             p.H, p.W, u, v);
  if (!vis) u = v = 0.0f;  // invisible points sample pixel (0, 0)
  iwxp[i] = sample<BILINEAR>(img, p.W, u, v);
  visible[i] = vis;
}

template <bool BILINEAR, typename TImg>
__global__ void __launch_bounds__(kThreads) level_ne_kernel(const LevelParams p, float* out) {
  __shared__ GramScratch s;
  const size_t bf = blockIdx.x;
  const int b = (int)(bf / p.F);
  const Pose T = load_pose(p, bf);
  const Intrinsics K = load_cam(p, b);
  const TImg* img = static_cast<const TImg*>(p.image) + (size_t)b * p.H * p.W;
  const float* pcl = p.pcl + bf * p.P * 3;
  const float* J = p.J + bf * p.P * 6;
  const float* templ = p.templ + bf * p.P;
  const unsigned char* mask = p.mask + bf * p.P;

  float acc[kGram];
#pragma unroll
  for (int k = 0; k < kGram; ++k) acc[k] = 0.0f;
  for (int q = threadIdx.x; q < p.P; q += kThreads) {
    float u, v;
    if (!mask[q] || !warp_project(T, K, __ldg(pcl + 3 * q), __ldg(pcl + 3 * q + 1),
                                  __ldg(pcl + 3 * q + 2), p.H, p.W, u, v))
      continue;
    const float r = sample<BILINEAR>(img, p.W, u, v) - __ldg(templ + q);
    float j[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) j[k] = __ldg(J + 6 * q + k);
    gram_accumulate(acc, j, r);
  }
  block_reduce(acc, s);

  if (threadIdx.x == 0) {
    float* o = out + bf * kNeOut;
    int k = 0;
    for (int a = 0; a < 6; ++a)
      for (int c = a; c < 6; ++c, ++k) o[6 * a + c] = o[6 * c + a] = s.sum[k];
    for (int a = 0; a < 6; ++a) o[36 + a] = s.sum[kGramB + a];
    o[42] = s.sum[kGramChi2];
    o[43] = s.sum[kGramCount];
  }
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

// Instantiate a kernel template for the image type and the sampling mode.
#define VSLAM_DISPATCH(KERNEL, GRID, STREAM, ...)                                        \
  do {                                                                                   \
    if (image_is_bf16) {                                                                 \
      if (bilinear)                                                                      \
        KERNEL<true, __nv_bfloat16><<<GRID, kThreads, 0, STREAM>>>(__VA_ARGS__);         \
      else                                                                               \
        KERNEL<false, __nv_bfloat16><<<GRID, kThreads, 0, STREAM>>>(__VA_ARGS__);        \
    } else {                                                                             \
      if (bilinear)                                                                      \
        KERNEL<true, float><<<GRID, kThreads, 0, STREAM>>>(__VA_ARGS__);                 \
      else                                                                               \
        KERNEL<false, float><<<GRID, kThreads, 0, STREAM>>>(__VA_ARGS__);                \
    }                                                                                    \
  } while (0)

}  // namespace vslam

// C entries for ctypes. Each launches on `stream` without synchronizing and
// returns cudaGetLastError() (0 = cudaSuccess).

// iwxp (B, F, P) f32 and visible (B, F, P) bool.
extern "C" int vslam_fused_level_sample(const void* pcl, const void* mask, const void* rel_R,
                                        const void* rel_t, const void* cam, const void* image,
                                        int image_is_bf16, int B, int F, int P, int H, int W,
                                        int bilinear, void* iwxp, void* visible, void* stream) {
  using namespace vslam;
  const LevelParams p =
      make_level_params(pcl, nullptr, nullptr, mask, rel_R, rel_t, cam, image, B, F, P, H, W);
  const size_t n = (size_t)B * F * P;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  VSLAM_DISPATCH(sample_level_kernel, grid, static_cast<cudaStream_t>(stream), p,
                 static_cast<float*>(iwxp), static_cast<unsigned char*>(visible));
  return static_cast<int>(cudaGetLastError());
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
  VSLAM_DISPATCH(level_ne_kernel, (unsigned)(B * F), static_cast<cudaStream_t>(stream), p,
                 static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
