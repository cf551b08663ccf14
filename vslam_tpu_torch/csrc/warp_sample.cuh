// Per-point device functions of the inverse-compositional residual pass:
// SE(3) warp + pinhole projection + visibility, intensity sampling, and the
// (robustly weighted) Gram accumulation of one point, plus a warp's
// reduce-scatter sum and the thread-block cluster's barrier and shared-memory
// map. Ports of `fused_ne._sample_chunk` and `fused_ne._gram_chunk`
// (vslam_tpu/alignment/fused_ne.py:113-231), shared by the whole-level solve
// kernel (fused_solve.cu) and the ports of `fused_level_ne` and
// `fused_level_sample` (fused_ne.cu).
//
// The TPU kernels sample through one-hot matmuls because Mosaic has no
// gather; here every point reads its 1 (nearest) or 4 (bilinear) pixels
// directly through the read-only cache.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

namespace vslam {

constexpr int kThreads = 256;  // threads per block of every kernel here
constexpr int kWarps = kThreads / 32;

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

// A bilinear row weight as the TPU kernel applies it: for a bf16 image the
// row weights are the one-hot matmul's bf16 operand (fused_ne.py:170-176,
// 202-205), so they are rounded to bf16; the column weights stay f32.
__device__ __forceinline__ float row_weight(float w, const float*) { return w; }

__device__ __forceinline__ float row_weight(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// Intensity at a visible (u, v), or at (0, 0): bilinear, or round-to-nearest
// as floor(x + 0.5) (the reference's std::round on non-negative coords).
// Visibility keeps every index inside the image.
template <bool BILINEAR, typename TImg>
__device__ __forceinline__ float sample(const TImg* img, int W, float u, float v) {
  if (BILINEAR) {
    const float u0 = floorf(u), v0 = floorf(v);
    const float ax = u - u0, ay = v - v0;
    const float wy0 = row_weight(1.0f - ay, img), wy1 = row_weight(ay, img);
    const int base = (int)v0 * W + (int)u0;
    const float i00 = load_px(img, base), i01 = load_px(img, base + 1);
    const float i10 = load_px(img, base + W), i11 = load_px(img, base + W + 1);
    return (1.0f - ax) * (wy0 * i00 + wy1 * i10) + ax * (wy0 * i01 + wy1 * i11);
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

// The warp's sums of 32 values held by every lane, one sum per lane: lane k
// returns the sum of value k over the 32 lanes (a reduce-scatter). At each
// xor offset o = 16, 8, 4, 2, 1 a lane sends its partner the half of its
// values that the partner keeps and adds the half it receives to the half it
// keeps: 31 shuffles, where a shuffle-down tree per value takes 5 each. Step
// o adds the partials of lanes l and l + o, the pairs the shuffle-down tree
// adds (xor pairs the same lanes, and f32 addition commutes), so lane k's
// sum is that tree's sum of value k bit for bit. The offset is a template
// argument, so every index is a constant and v stays in registers.
template <int O>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32], int lane) {
  const bool upper = lane & O;  // keeps the values whose bit O is set
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) reduce_scatter_step<O / 2>(v, lane);
}

__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32]) {
  reduce_scatter_step<16>(v, threadIdx.x & 31);
  return v[0];
}

// A barrier over the kC CTAs of a thread-block cluster (kC = 1: the block).
template <int kC>
__device__ __forceinline__ void cluster_barrier() {
  if constexpr (kC == 1)
    __syncthreads();
  else
    cooperative_groups::this_cluster().sync();
}

// ``p`` in the shared memory of CTA ``rank`` of a cluster of kC CTAs
template <int kC, typename T>
__device__ __forceinline__ T* rank_ptr(T* p, int rank) {
  if constexpr (kC == 1)
    return p;
  else
    return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

}  // namespace vslam
