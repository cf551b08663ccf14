// Bilinear samples of B images at M points each; one thread per (image,
// point), 256 a block.
//
// Replaces the Pallas TPU kernel of `bilinear_sample_mxu_single`
// (vslam_tpu/alignment/pallas_kernels.py:37, pallas_call at :55, body
// `_sample_body`), the `sampler="mxu"` path. It keeps that kernel's
// semantics, which are those of its one-hot formulation: a tap outside
// [0, H) x [0, W) contributes 0, with no clamping, negative coordinates
// included, and the sum is (wy0 i00 + wy1 i10) wx0 + (wy0 i01 + wy1 i11) wx1,
// the row mix first (the matmul), then the column mix.
//
// What bounds it on an H100: bytes and latency. Per point it reads u and v
// (8 B), up to four scattered pixels, and writes 4 B, with about a dozen
// operations. At the finest `align_pairs` level (B = 64, M = 1920) that is
// ~1.5 MB of coordinates and samples, L2-resident with the images, so it is
// bound by load latency. What the design does about it: coalesced
// coordinate loads and stores, pixels through the read-only cache.
//
// Not carried over: the one-hot row matmul on the MXU ((1024, H) x (H, W)
// per chunk of points) and the (8, 128) tiles. Mosaic has no gather; Hopper
// has one.
#include <cuda_runtime.h>

namespace vslam {

constexpr int kMxuThreads = 256;

__global__ void __launch_bounds__(kMxuThreads)
    sample_mxu_kernel(const float* img, const float* u, const float* v, int B, int M, int H, int W,
                      float* out) {
  const size_t i = (size_t)blockIdx.x * kMxuThreads + threadIdx.x;
  if (i >= (size_t)B * M) return;
  const float* im = img + (i / M) * H * W;
  const float uu = u[i], vv = v[i];
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float wx1 = uu - u0, wy1 = vv - v0;
  const float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
  // which of the rows v0, v0 + 1 and columns u0, u0 + 1 lie in the image
  // (compared as floats: exact for every finite coordinate)
  const bool y0 = v0 >= 0.0f && v0 <= (float)(H - 1), y1 = v0 >= -1.0f && v0 <= (float)(H - 2);
  const bool x0 = u0 >= 0.0f && u0 <= (float)(W - 1), x1 = u0 >= -1.0f && u0 <= (float)(W - 2);
  const int iv = (y0 || y1) ? (int)v0 : 0, iu = (x0 || x1) ? (int)u0 : 0;
  const float i00 = (y0 && x0) ? __ldg(im + iv * W + iu) : 0.0f;
  const float i01 = (y0 && x1) ? __ldg(im + iv * W + iu + 1) : 0.0f;
  const float i10 = (y1 && x0) ? __ldg(im + (iv + 1) * W + iu) : 0.0f;
  const float i11 = (y1 && x1) ? __ldg(im + (iv + 1) * W + iu + 1) : 0.0f;
  out[i] = (wy0 * i00 + wy1 * i10) * wx0 + (wy0 * i01 + wy1 * i11) * wx1;
}

}  // namespace vslam

// C entry for ctypes: img (B, H, W) f32, u and v (B, M) f32, out (B, M) f32.
// Launches on `stream` without synchronizing and returns cudaGetLastError()
// (0 = cudaSuccess).
extern "C" int vslam_bilinear_sample_mxu(const void* img, const void* u, const void* v, int B,
                                         int M, int H, int W, void* out, void* stream) {
  const size_t n = (size_t)B * M;
  const unsigned grid = (unsigned)((n + vslam::kMxuThreads - 1) / vslam::kMxuThreads);
  vslam::sample_mxu_kernel<<<grid, vslam::kMxuThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(u), static_cast<const float*>(v),
      B, M, H, W, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
