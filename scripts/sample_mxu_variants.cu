// The mxu sampler of vslam_tpu_torch/csrc/sample_mxu.cu with the design
// variants that scripts/kernel_study.py measures, for that study alone: no
// part of the package builds it. At the values below it is the package's
// kernel (the 2-D grid, the taps as loads under predicates), bit for bit;
// the study builds it with one constant moved at a time (`_build.Variants`). It has the package's C entry, so the
// package's wrapper launches it (`pallas_kernels._launch(lib=)`), and its
// kernel's name, so the profiler finds it. The variants, each measured
// and not taken (PERF.md, Findings, PR 14):
// - kMxuEvictLast: the percent of the tap lines read with an L2 evict_last
//   policy (0, the package's, 25, 50 or 100).
// - kMxuPairedPoints: from launches of at least that many points (B M), a
//   row's two taps come from one 16-byte load where they lie in one 16-byte
//   group (three columns in four; the load may read up to 12 bytes of the
//   image, or of its allocation's padding, beside the taps, never used).
//   Fewer L1 requests, the same sectors. The study builds it at 0 and 65536;
//   at 2^31 - 1 it is off at every launch the study makes.
// - kMxuMinBlocks: threads a block halved from kMxuMaxThreads down to a
//   warp while the grid would have fewer blocks than this (`mxu_threads`;
//   0: kMxuMaxThreads always).
// - kMxuMaxThreads: 128, 256 (the package's) or 512.
// - kMxuStreaming: coordinates read, and samples written, evict-first.
// - kMxuPts: that many consecutive points a thread, coordinates and samples
//   as one vector where the addresses allow.
// - kMxuStage: 3 and 4, probes of where level 0's time goes (below).
#include <cuda_runtime.h>
#include <stdint.h>

namespace vslam {

// the variants' constants, each at the package's value
constexpr int kMxuEvictLast = 0;     // percent of the tap lines read evict_last: 0, 25, 50 or 100
constexpr int kMxuMaxThreads = 256;  // threads of a block at most
constexpr int kMxuMinBlocks = 0;     // blocks the grid should have (0: kMxuMaxThreads always)
// launches of at least this many points (B M) pair a row's taps (2^31 - 1:
// off at every launch the study makes)
constexpr int kMxuPairedPoints = 2147483647;
constexpr int kMxuStreaming = 0;
constexpr int kMxuPts = 1;  // consecutive points a thread: 1, 2 or 4
// 2: the sampler. Measurement builds: 0, an empty kernel on the same
// grid; 1, the coordinates alone (u + v stored in the sample's place); 3,
// the sampler with every image's taps read from the first image (the taps'
// footprint in the L2 cut B-fold); 4, the sampler without the lower row's
// taps (half the lines).
constexpr int kMxuStage = 2;
constexpr int kMxuMaxGridY = 65535;
static_assert(kMxuPts == 1 || kMxuPts == 2 || kMxuPts == 4, "kMxuPts: 1, 2 or 4");
static_assert(kMxuEvictLast == 0 || kMxuEvictLast == 25 || kMxuEvictLast == 50 || kMxuEvictLast == 100,
              "kMxuEvictLast: 0, 25, 50 or 100");

// the taps' L2 policy: kMxuEvictLast percent of the lines (by address)
// evict_last, the rest as without a hint
__device__ __forceinline__ uint64_t tap_policy() {
  uint64_t policy = 0;
  if constexpr (kMxuEvictLast == 100)
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  else if constexpr (kMxuEvictLast == 50)
    asm("createpolicy.fractional.L2::evict_last.L2::evict_unchanged.b64 %0, 0.5;" : "=l"(policy));
  else if constexpr (kMxuEvictLast == 25)
    asm("createpolicy.fractional.L2::evict_last.L2::evict_unchanged.b64 %0, 0.25;" : "=l"(policy));
  return policy;
}

// ok ? *p : 0, by a load the thread issues under a predicate, not a branch:
// a warp whose threads differ in ok issues it once, beside its other taps
__device__ __forceinline__ float tap1(const float* p, bool ok, uint64_t policy) {
  float x = 0.0f;
  if constexpr (kMxuEvictLast != 0)
    asm("{ .reg .pred q; setp.ne.b32 q, %2, 0; @q ld.global.nc.L2::cache_hint.f32 %0, [%1], %3; }"
        : "+f"(x) : "l"(p), "r"((int)ok), "l"(policy));
  else
    asm("{ .reg .pred q; setp.ne.b32 q, %2, 0; @q ld.global.nc.f32 %0, [%1]; }" : "+f"(x) : "l"(p), "r"((int)ok));
  return x;
}

// ok ? the 16-byte group at p (16-byte aligned) : 0, as tap1
__device__ __forceinline__ float4 tap4(const float* p, bool ok, uint64_t policy) {
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (kMxuEvictLast != 0)
    asm("{ .reg .pred q; setp.ne.b32 q, %4, 0;"
        " @q ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%5], %6; }"
        : "+f"(x.x), "+f"(x.y), "+f"(x.z), "+f"(x.w) : "r"((int)ok), "l"(p), "l"(policy));
  else
    asm("{ .reg .pred q; setp.ne.b32 q, %4, 0; @q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%5]; }"
        : "+f"(x.x), "+f"(x.y), "+f"(x.z), "+f"(x.w) : "r"((int)ok), "l"(p));
  return x;
}

// Pixels p[0] and p[1] of a row, each 0 where it is outside the image (a:
// the first inside, b: the second). Paired, with both inside, the 16-byte
// group around p gives both, or, where p ends its group, p[0] (and p[1]
// comes alone); every load is issued at once, under predicates.
template <bool kPaired>
__device__ __forceinline__ float2 row_taps(const float* p, bool a, bool b, uint64_t policy) {
  const bool both = kPaired && a && b;
  const int k = (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);  // p's place in its 16-byte group
  float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (kPaired) q = tap4(p - k, both, policy);
  const float first = tap1(p, a && !both, policy), second = tap1(p + 1, b && (!both || k == 3), policy);
  const float qa = k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
  const float qb = k == 0 ? q.y : k == 1 ? q.z : q.w;
  return make_float2(both ? qa : first, both && k < 3 ? qb : second);
}

template <bool kPaired>
__device__ __forceinline__ float sample(const float* im, int H, int W, float uu, float vv, uint64_t policy) {
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float wx1 = uu - u0, wy1 = vv - v0;
  const float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
  // which of the rows v0, v0 + 1 and columns u0, u0 + 1 lie in the image
  // (compared as floats: exact for every finite coordinate)
  const bool y0 = v0 >= 0.0f && v0 <= (float)(H - 1), y1 = v0 >= -1.0f && v0 <= (float)(H - 2);
  const bool x0 = u0 >= 0.0f && u0 <= (float)(W - 1), x1 = u0 >= -1.0f && u0 <= (float)(W - 2);
  const int iv = (y0 || y1) ? (int)v0 : 0, iu = (x0 || x1) ? (int)u0 : 0;
  const float2 top = row_taps<kPaired>(im + (iv * W + iu), y0 && x0, y0 && x1, policy);
  const bool lower = y1 && kMxuStage != 4;
  const float2 bottom = row_taps<kPaired>(im + ((iv + 1) * W + iu), lower && x0, lower && x1, policy);
  return (wy0 * top.x + wy1 * bottom.x) * wx0 + (wy0 * top.y + wy1 * bottom.y) * wx1;
}

__device__ __forceinline__ float load1(const float* p) {
  if constexpr (kMxuStreaming) return __ldcs(p);
  else return *p;
}

// x[j] = p[j] for j < n (n <= N), one vector load where all N are there
// and aligned
template <int N>
__device__ __forceinline__ void load_points(const float* p, int n, float (&x)[N]) {
  if constexpr (N > 1) {
    if (n == N && (reinterpret_cast<uintptr_t>(p) & (4 * N - 1)) == 0) {
      if constexpr (N == 2) {
        const float2* q = reinterpret_cast<const float2*>(p);
        const float2 t = kMxuStreaming ? __ldcs(q) : *q;
        x[0] = t.x, x[1] = t.y;
      } else {
        const float4* q = reinterpret_cast<const float4*>(p);
        const float4 t = kMxuStreaming ? __ldcs(q) : *q;
        x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = j < n ? load1(p + j) : 0.0f;
}

template <int N>
__device__ __forceinline__ void store_points(float* p, int n, const float (&x)[N]) {
  if constexpr (N > 1) {
    if (n == N && (reinterpret_cast<uintptr_t>(p) & (4 * N - 1)) == 0) {
      if constexpr (N == 2) {
        const float2 t = make_float2(x[0], x[1]);
        if constexpr (kMxuStreaming) __stcs(reinterpret_cast<float2*>(p), t);
        else *reinterpret_cast<float2*>(p) = t;
      } else {
        const float4 t = make_float4(x[0], x[1], x[2], x[3]);
        if constexpr (kMxuStreaming) __stcs(reinterpret_cast<float4*>(p), t);
        else *reinterpret_cast<float4*>(p) = t;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n) {
      if constexpr (kMxuStreaming) __stcs(p + j, x[j]);
      else p[j] = x[j];
    }
  }
}

template <bool kPaired>
__global__ void __launch_bounds__(kMxuMaxThreads)
    sample_mxu_kernel(const float* __restrict__ img, const float* __restrict__ u, const float* __restrict__ v,
                      int B, int M, int H, int W, float* __restrict__ out) {
  const unsigned q = (blockIdx.x * blockDim.x + threadIdx.x) * kMxuPts;
  if (kMxuStage == 0 || q >= (unsigned)M) return;
  const int n = min(kMxuPts, M - (int)q);
  const uint64_t policy = tap_policy();
  unsigned b = blockIdx.y;  // < B: the grid's y extent is at most B
  do {
    const size_t at = (size_t)b * M + q;
    float uu[kMxuPts], vv[kMxuPts], s[kMxuPts];
    load_points(u + at, n, uu);
    load_points(v + at, n, vv);
    const float* im = img + (kMxuStage == 3 ? 0 : (size_t)b * H * W);
#pragma unroll
    for (int j = 0; j < kMxuPts; ++j)
      s[j] = kMxuStage == 1 ? uu[j] + vv[j] : sample<kPaired>(im, H, W, uu[j], vv[j], policy);
    store_points(out + at, n, s);
    b += gridDim.y;
  } while (b < (unsigned)B);
}

// Threads a block: kMxuMaxThreads, halved down to a warp while B x M points
// would make fewer than kMxuMinBlocks blocks.
inline int mxu_threads(int B, int M) {
  int t = kMxuMaxThreads;
  while (t > 32 && (long long)B * ((M + (long long)t * kMxuPts - 1) / ((long long)t * kMxuPts)) < kMxuMinBlocks)
    t /= 2;
  return t;
}

}  // namespace vslam

// C entry for ctypes: img (B, H, W) f32, u and v (B, M) f32, out (B, M) f32;
// H W < 2^31. Launches on `stream` without synchronizing and returns
// cudaGetLastError() (0 = cudaSuccess).
extern "C" int vslam_bilinear_sample_mxu(const void* img, const void* u, const void* v, int B,
                                         int M, int H, int W, void* out, void* stream) {
  const int threads = vslam::mxu_threads(B, M);
  const long long chunk = (long long)threads * vslam::kMxuPts;
  const dim3 grid((unsigned)((M + chunk - 1) / chunk),
                  (unsigned)(B < vslam::kMxuMaxGridY ? B : vslam::kMxuMaxGridY));
  const auto kernel = (long long)B * M >= vslam::kMxuPairedPoints ? vslam::sample_mxu_kernel<true>
                                                                   : vslam::sample_mxu_kernel<false>;
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(u), static_cast<const float*>(v),
      B, M, H, W, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
