// Bilinear samples of B images at M points each, on a 2-D grid: blockIdx.y
// the image, blockIdx.x a chunk of 256 of its points, one a thread.
//
// Replaces the Pallas TPU kernel of `bilinear_sample_mxu_single`
// (vslam_tpu/alignment/pallas_kernels.py:37, pallas_call at :55, body
// `_sample_body`), the `sampler="mxu"` path. It keeps that kernel's
// semantics, which are those of its one-hot formulation: a tap outside
// [0, H) x [0, W) contributes 0, with no clamping, negative coordinates
// included, and the sum is (wy0 i00 + wy1 i10) wx0 + (wy0 i01 + wy1 i11) wx1,
// the row mix first (the matmul), then the column mix.
//
// What bounds it on an H100: the cache lines its taps touch, and latency.
// Per point it reads u and v (8 B), up to four scattered pixels in two rows,
// and writes 4 B, with about a dozen operations. At the finest
// `align_pairs` level (B = 64, M = 1920) a point's taps fall in two 32-byte
// sectors, one a row, that the other points of its warp do not touch: with
// the lines in the L2 the sampling runs at the L2's sector rate, and inside
// the Gauss-Newton loop, where the batch's 79 MB of images and the loop's
// other tensors pass through the 50 MB L2, a launch takes about twice as
// long: its lines come from device memory. The coarse levels are launch and
// latency: two dependent round trips (the coordinates, then the taps). The
// design, against the flat 1-D grid it replaces:
// - A 2-D grid, blockIdx.y the image: no thread divides to find its image
//   (a 64-bit division is tens of instructions on the critical path), the
//   image's base is one 64-bit product, and the taps' offsets in it are
//   32-bit (the wrapper refuses H W >= 2^31). Above kMxuMaxGridY images,
//   the y extent's limit, a block also takes the images kMxuMaxGridY apart.
// - Every tap a load under a predicate, never a branch, so a thread's taps
//   are in flight together.
// The variants measured and not taken (an L2 evict_last policy on the taps
// among them) are in scripts/sample_mxu_variants.cu.
//
// Not carried over: the one-hot row matmul on the MXU ((1024, H) x (H, W)
// per chunk of points) and the (8, 128) tiles. Mosaic has no gather; Hopper
// has one.
#include <cuda_runtime.h>

namespace vslam {

constexpr int kMxuThreads = 256;
constexpr int kMxuMaxGridY = 65535;
// 2: the sampler. Measurement builds only (chip_smoke.py's phase 15 split):
// 0, an empty kernel on the same grid; 1, the coordinates alone (u + v
// stored in the sample's place).
constexpr int kMxuStage = 2;

// ok ? *p : 0, by a load under a predicate, not a branch: a warp whose
// threads differ in ok issues it once, beside its other taps
__device__ __forceinline__ float tap(const float* p, bool ok) {
  float x = 0.0f;
  asm("{ .reg .pred q; setp.ne.b32 q, %2, 0; @q ld.global.nc.f32 %0, [%1]; }" : "+f"(x) : "l"(p), "r"((int)ok));
  return x;
}

__device__ __forceinline__ float sample(const float* im, int H, int W, float uu, float vv) {
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float wx1 = uu - u0, wy1 = vv - v0;
  const float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
  // which of the rows v0, v0 + 1 and columns u0, u0 + 1 lie in the image
  // (compared as floats: exact for every finite coordinate)
  const bool y0 = v0 >= 0.0f && v0 <= (float)(H - 1), y1 = v0 >= -1.0f && v0 <= (float)(H - 2);
  const bool x0 = u0 >= 0.0f && u0 <= (float)(W - 1), x1 = u0 >= -1.0f && u0 <= (float)(W - 2);
  const int iv = (y0 || y1) ? (int)v0 : 0, iu = (x0 || x1) ? (int)u0 : 0;
  const float* top = im + (iv * W + iu);
  const float* bottom = im + ((iv + 1) * W + iu);
  const float i00 = tap(top, y0 && x0), i01 = tap(top + 1, y0 && x1);
  const float i10 = tap(bottom, y1 && x0), i11 = tap(bottom + 1, y1 && x1);
  return (wy0 * i00 + wy1 * i10) * wx0 + (wy0 * i01 + wy1 * i11) * wx1;
}

__global__ void __launch_bounds__(kMxuThreads)
    sample_mxu_kernel(const float* __restrict__ img, const float* __restrict__ u, const float* __restrict__ v,
                      int B, int M, int H, int W, float* __restrict__ out) {
  const unsigned q = blockIdx.x * kMxuThreads + threadIdx.x;
  if (kMxuStage == 0 || q >= (unsigned)M) return;
  unsigned b = blockIdx.y;  // < B: the grid's y extent is at most B
  do {
    const size_t at = (size_t)b * M + q;
    const float uu = u[at], vv = v[at];
    out[at] = kMxuStage == 1 ? uu + vv : sample(img + (size_t)b * H * W, H, W, uu, vv);
    b += gridDim.y;
  } while (b < (unsigned)B);
}

}  // namespace vslam

// C entry for ctypes: img (B, H, W) f32, u and v (B, M) f32, out (B, M) f32;
// H W < 2^31. Launches on `stream` without synchronizing and returns
// cudaGetLastError() (0 = cudaSuccess).
extern "C" int vslam_bilinear_sample_mxu(const void* img, const void* u, const void* v, int B,
                                         int M, int H, int W, void* out, void* stream) {
  const dim3 grid((unsigned)(((long long)M + vslam::kMxuThreads - 1) / vslam::kMxuThreads),
                  (unsigned)(B < vslam::kMxuMaxGridY ? B : vslam::kMxuMaxGridY));
  vslam::sample_mxu_kernel<<<grid, vslam::kMxuThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(u), static_cast<const float*>(v),
      B, M, H, W, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
