// Per-point device functions of the inverse-compositional residual pass:
// SE(3) warp + pinhole projection + visibility, intensity sampling, and the
// (robustly weighted) Gram accumulation of one point. Ports of `fused_ne._sample_chunk` and
// `fused_ne._gram_chunk` (vslam_tpu/alignment/fused_ne.py:113-231), shared
// by the whole-level solve kernel (fused_solve.cu) and, later, by the ports
// of `fused_level_ne` and `fused_level_sample`.
//
// The TPU kernels sample through one-hot matmuls because Mosaic has no
// gather; here every point reads its 1 (nearest) or 4 (bilinear) pixels
// directly through the read-only cache.
#pragma once

#include <cuda_bf16.h>

namespace vslam {

struct Pose {
  float R[9];  // row-major
  float t[3];
};

struct Intrinsics {
  float fx, fy, cx, cy;
};

// values accumulated per point: upper triangle of JᵀJ (21, row-major),
// Jᵀr (6), r² (1), visible count (1)
constexpr int kGram = 29;
constexpr int kGramB = 21;
constexpr int kGramChi2 = 27;
constexpr int kGramCount = 28;

__device__ __forceinline__ float load_px(const float* img, int idx) {
  return __ldg(img + idx);
}

__device__ __forceinline__ float load_px(const __nv_bfloat16* img, int idx) {
  return __bfloat162float(__ldg(img + idx));
}

// Warp a reference point by T, project it, and test visibility:
// z > 0 and 1 < u < W-1 and 1 < v < H-1 (the caller tests the interest
// mask). Mirrors fused_ne.py:127-144.
__device__ __forceinline__ bool warp_project(const Pose& T, const Intrinsics& K, float px,
                                             float py, float pz, int H, int W, float& u,
                                             float& v) {
  const float xw = T.R[0] * px + T.R[1] * py + T.R[2] * pz + T.t[0];
  const float yw = T.R[3] * px + T.R[4] * py + T.R[5] * pz + T.t[1];
  const float zw = T.R[6] * px + T.R[7] * py + T.R[8] * pz + T.t[2];
  const bool z_ok = zw > 0.0f;
  const float zi = 1.0f / (z_ok ? zw : 1.0f);
  u = K.fx * xw * zi + K.cx;
  v = K.fy * yw * zi + K.cy;
  return z_ok && u > 1.0f && u < (float)W - 1.0f && v > 1.0f && v < (float)H - 1.0f;
}

// Intensity at a visible (u, v): bilinear, or round-to-nearest as
// floor(x + 0.5) (the reference's std::round on non-negative coords).
// Visibility keeps every index inside the image.
template <bool BILINEAR, typename TImg>
__device__ __forceinline__ float sample(const TImg* img, int W, float u, float v) {
  if (BILINEAR) {
    const float u0 = floorf(u), v0 = floorf(v);
    const float ax = u - u0, ay = v - v0;
    const int base = (int)v0 * W + (int)u0;
    const float i00 = load_px(img, base), i01 = load_px(img, base + 1);
    const float i10 = load_px(img, base + W), i11 = load_px(img, base + W + 1);
    return (1.0f - ax) * ((1.0f - ay) * i00 + ay * i10) + ax * ((1.0f - ay) * i01 + ay * i11);
  }
  const int iu = (int)floorf(u + 0.5f), iv = (int)floorf(v + 0.5f);
  return load_px(img, iv * W + iu);
}

// Add one visible point (weight 1, the quadratic loss) to the partial sums.
__device__ __forceinline__ void gram_accumulate(float (&acc)[kGram], const float (&j)[6],
                                                float r) {
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) acc[k++] += j[a] * j[b];
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[kGramB + a] += j[a] * r;
  acc[kGramChi2] += r * r;
  acc[kGramCount] += 1.0f;
}

// Add one visible point with robust weight w: (J_a w) J_c, (J_a w) r and
// (w r) r, in this order of rounding (the plain PyTorch version's).
__device__ __forceinline__ void gram_accumulate_weighted(float (&acc)[kGram], const float (&j)[6],
                                                         float r, float w) {
  float wj[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) wj[a] = j[a] * w;
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) acc[k++] += wj[a] * j[b];
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[kGramB + a] += wj[a] * r;
  acc[kGramChi2] += w * r * r;
  acc[kGramCount] += 1.0f;
}

}  // namespace vslam
