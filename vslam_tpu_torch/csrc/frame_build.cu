// Frame build: the image pyramid of B RGB-D frames, one launch a level.
// Per level l and frame it writes four f32 planes: intensity (level 0 the
// widened sensor image, above it cv::pyrDown of the level below), depth
// (level 0 the sensor depth times the scale with non-finite values at 0,
// above it the invalid-masked 3x3 median of the level below at the even
// rows and columns that the decimation keeps), and the Sobel-x and Sobel-y
// derivatives of the 3x3 Gaussian blur of the intensity, every border
// reflect-101. It is `core/frame_build.build_pyramid_plain` (the chain of
// `core/image` stencils that `core/frame.create_frame` ran) computed with
// the same roundings in the same order: the build has -fmad=false, and every
// stencil value is evaluated at the real pixel that the plain version's
// padding reflects to, so the two agree bit for bit.
//
// It replaces no TPU kernel: the JAX package builds a frame with XLA's
// fused stencils. It was added because frame build was 85 % of the device
// time of a step of the suite (512 VGA frames a step): 125.7 ms of ATen
// elementwise launches (~430 a frame build) over full-size planes.
//
// What bounds it on an H100: bytes. A VGA frame reads 3 B a pixel (uint8
// intensity, 16-bit depth) and writes 16 B a pixel at level 0, a quarter of
// that at level 1 and a sixteenth at level 2, with a few tens of f32
// operations a pixel. The design moves each byte once where it can:
// - A block takes a tile of kFbRows x kFbCols output pixels of one frame,
//   blockIdx.x the tile and blockIdx.y the frame (above kFbMaxGridY frames a
//   block also takes the frames kFbMaxGridY apart), and stages its input
//   with the halo in shared memory, widened to f32 once. The stencil stages
//   (pyramid rows, pyramid columns, blur down, blur across) each write
//   shared memory; the Sobel pair is computed from the blurred tile in
//   registers, so no intermediate plane reaches device memory.
// - Levels 0 and 1 read the sensor images themselves (widening is exact):
//   3 B a level-0 pixel instead of the 8 B of the f32 level-0 copies.
// - The median runs only at the positions that survive the decimation:
//   a quarter of the plain version's, with the same 25-exchange network.
// - Rows of the sensor images move as 16-byte loads (uint8 intensity 16
//   pixels, f32 4) and the four output planes as 16-byte stores where the
//   widths and addresses allow; 16-bit depth as 8-byte loads of 4 pixels.
//   The rest goes a pixel at a time.
// - Registers are capped (kFbTopBlocks, kFbDownBlocks) so that 4 blocks
//   share an SM and one's staging overlaps another's stores.
// Tried on the suite's 512 VGA frames and not kept (PERF.md §6): 4-byte
// uint8 loads into 16-byte aligned shared rows (free of the bank conflicts
// of widening a 16-byte load), the median's loads out of their branch and
// the depth asked for before the staging, together 12 % slower; 16-byte
// reads of the blur in the Sobel pass, 1 % faster, a second code path.
// One launch a level, not one for the whole pyramid: level l + 1 reads a
// 5x5 neighbourhood of level l around every pixel it writes, so a single
// launch would need a grid-wide barrier between levels or blocks that
// recompute the levels below with ever wider halos; two more launches a
// frame build cost a few microseconds of host time and nothing on the card.
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <cstring>

namespace vslam {

constexpr int kFbRows = 16;  // output rows of a tile
constexpr int kFbCols = 64;  // output columns of a tile
constexpr int kFbThreads = kFbRows * kFbCols / 4;  // a thread writes 4 columns of a row
constexpr int kFbMaxGridY = 65535;
// blocks an SM holds (the registers' cap, 64 a thread): level 0, and the
// levels above (chip_smoke.py's phase 31 sweeps both)
constexpr int kFbTopBlocks = 4;
constexpr int kFbDownBlocks = 4;

// staged regions, rows x columns at most
constexpr int kIRows = kFbRows + 4, kICols = kFbCols + 4;  // the level's intensity, halo 2
constexpr int kBRows = kFbRows + 2, kBCols = kFbCols + 2;  // its blur, halo 1
constexpr int kPRows = 2 * kIRows + 3, kPCols = 2 * kICols + 3;  // the level below under the 5 taps
// level 0: intensity, vertical blur pass, blur; above: the level below
// (whose space the blur passes reuse), the pyramid's row pass, intensity
constexpr int kTopFloats = kIRows * kICols + kBRows * kICols + kBRows * kBCols;
constexpr int kDownFloats = kPRows * kPCols + kIRows * kPCols + kIRows * kICols;
static_assert(kBRows * kICols + kBRows * kBCols <= kPRows * kPCols, "blur passes fit in the level below's space");

// the plain version's taps: cv::pyrDown's [1 4 6 4 1] / 16, the Gaussian's [1 2 1] / 4
constexpr float kP1 = 1.0f / 16.0f, kP4 = 4.0f / 16.0f, kP6 = 6.0f / 16.0f;
constexpr float kG1 = 0.25f, kG2 = 0.5f;

// reflect-101 (OpenCV's BORDER_DEFAULT) for an index at most n - 1 outside [0, n)
__device__ __forceinline__ int refl(int i, int n) { return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i); }

__device__ __forceinline__ float widen(uint8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float widen(uint16_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float widen(float x) { return x; }

// depth as it is ingested: the widened value times the scale, non-finite to 0
template <typename T>
__device__ __forceinline__ float ingest(T raw, float scale) {
  const float d = widen(raw) * scale;
  return isfinite(d) ? d : 0.0f;
}

// dst[(y - y0) * LD + (x - x0)] = f(src[y * W + x]) over rows [y0, y1] and
// columns [x0, x1] of one image, by the whole block. Where W and the image's
// address allow, the columns [bx0, min(bx0 + BODY, W)) move as 16-byte
// vectors and the halo around them, at most HALO / 2 columns a side, a value
// at a time.
template <int LD, int BODY, int HALO, typename T, typename F>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int W, int y0, int y1, int x0, int x1,
                                           int bx0, float* dst, F f) {
  constexpr int V = 16 / sizeof(T);
  static_assert(BODY % V == 0, "the body is whole vectors");
  const int rows = y1 - y0 + 1;
  if (W % V == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int bx1 = min(bx0 + BODY, W);  // bx0 and W are multiples of V
    constexpr int C = BODY / V;
    for (int i = threadIdx.x; i < rows * C; i += kFbThreads) {
      const int r = i / C;
      const int x = bx0 + (i - r * C) * V;
      if (x >= bx1) continue;
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(src + (y0 + r) * W + x));
      T e[V];
      memcpy(e, &q, sizeof(q));
      float* d = dst + r * LD + (x - x0);
#pragma unroll
      for (int j = 0; j < V; ++j) d[j] = f(e[j]);
    }
    constexpr int kSide = HALO / 2;
    for (int i = threadIdx.x; i < rows * HALO; i += kFbThreads) {
      const int r = i / HALO, k = i - r * HALO;
      const int x = k < kSide ? x0 + k : bx1 + (k - kSide);
      if (k < kSide ? x >= bx0 : x > x1) continue;
      dst[r * LD + (x - x0)] = f(src[(y0 + r) * W + x]);
    }
  } else {
    for (int i = threadIdx.x; i < rows * LD; i += kFbThreads) {
      const int r = i / LD;
      const int x = x0 + (i - r * LD);
      if (x > x1) continue;
      dst[r * LD + (x - x0)] = f(src[(y0 + r) * W + x]);
    }
  }
}

// 9-element sorting network (25 compare-exchanges): core/image._NET9
__device__ __forceinline__ void cx(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// the invalid-masked median of 9 values (core/image.median_blur_3x3_masked):
// invalid (<= 0) values sort last as FLT_MAX, the median of the n valid ones
// is the mean of ranks (n - 1) // 2 and n // 2, and 0 where none is valid.
// No value is NaN: depth is non-finite-free from ingest on.
__device__ __forceinline__ float masked_median9(const float (&v)[9]) {
  float s[9];
  int n = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const bool ok = !(v[k] <= 0.0f);
    s[k] = ok ? v[k] : FLT_MAX;
    n += ok;
  }
  cx(s[0], s[1]); cx(s[3], s[4]); cx(s[6], s[7]); cx(s[1], s[2]); cx(s[4], s[5]);
  cx(s[7], s[8]); cx(s[0], s[1]); cx(s[3], s[4]); cx(s[6], s[7]); cx(s[0], s[3]);
  cx(s[3], s[6]); cx(s[0], s[3]); cx(s[1], s[4]); cx(s[4], s[7]); cx(s[1], s[4]);
  cx(s[2], s[5]); cx(s[5], s[8]); cx(s[2], s[5]); cx(s[1], s[3]); cx(s[5], s[7]);
  cx(s[2], s[6]); cx(s[4], s[6]); cx(s[2], s[4]); cx(s[2], s[3]); cx(s[5], s[6]);
  const int lo = n > 0 ? (n - 1) / 2 : 0, hi = n / 2;  // both at most 4
  float a = s[0], b = s[0];
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    a = lo == k ? s[k] : a;
    b = hi == k ? s[k] : b;
  }
  return n > 0 ? 0.5f * (a + b) : 0.0f;
}

// 4 values of a row, as one vector where `vec` (the address then 4-aligned
// in elements and the row's width a multiple of 4), else those below n
template <typename T>
__device__ __forceinline__ void load4(const T* p, bool vec, int n, T (&e)[4]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      memcpy(e, &q, sizeof(q));
    } else if constexpr (sizeof(T) == 2) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      memcpy(e, &q, sizeof(q));
    } else {
      const uint32_t q = __ldg(reinterpret_cast<const unsigned int*>(p));
      memcpy(e, &q, sizeof(q));
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = k < n ? p[k] : T(0);
  }
}

__device__ __forceinline__ void store4(float* p, bool vec, int n, const float (&v)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < n) p[k] = v[k];
  }
}

__device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// One level for B frames. kTop: level 0, from the sensor images (TI, TD).
// Otherwise the level below, (Hp, Wp): the sensor images for level 1
// (`ingest_depth` set: depth is scaled and made finite as it is read), the
// f32 planes of level l - 1 above that.
template <typename TI, typename TD, bool kTop>
__global__ void __launch_bounds__(kFbThreads, kTop ? kFbTopBlocks : kFbDownBlocks)
    frame_level_kernel(const TI* __restrict__ src_i, const TD* __restrict__ src_d, float scale, int ingest_depth,
                       int B, int Hp, int Wp, int H, int W, int tiles_x, float* __restrict__ out_i,
                       float* __restrict__ out_d, float* __restrict__ out_x, float* __restrict__ out_y) {
  __shared__ float smem[kTop ? kTopFloats : kDownFloats];
  // this level's intensity; above level 0 after the level below (sP) and
  // its pyramid row pass (sR)
  float* const sI = smem + (kTop ? 0 : kPRows * kPCols + kIRows * kPCols);
  float* const sV = smem + (kTop ? kIRows * kICols : 0);  // the blur's vertical pass
  float* const sB = sV + kBRows * kICols;  // the blur

  const int ty = blockIdx.x / tiles_x;
  const int r0 = ty * kFbRows, c0 = (blockIdx.x - ty * tiles_x) * kFbCols;
  // intensity rows and columns the tile reads (halo 2), blurred ones (halo 1)
  const int br0 = max(0, r0 - 1), br1 = min(H - 1, r0 + kFbRows);
  const int bc0 = max(0, c0 - 1), bc1 = min(W - 1, c0 + kFbCols);
  const int ir0 = max(0, br0 - 1), ir1 = min(H - 1, br1 + 1);
  const int ic0 = max(0, bc0 - 1), ic1 = min(W - 1, bc1 + 1);
  // the level below under the pyramid's taps
  const int pr0 = max(0, 2 * ir0 - 2), pr1 = min(Hp - 1, 2 * ir1 + 2);
  const int pc0 = max(0, 2 * ic0 - 2), pc1 = min(Wp - 1, 2 * ic1 + 2);
  // this thread's 4 output columns of one row
  const int y = r0 + threadIdx.x / (kFbCols / 4);
  const int x = c0 + (threadIdx.x % (kFbCols / 4)) * 4;
  const int nx = min(4, W - x);

  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const TI* const fi = src_i + static_cast<size_t>(b) * Hp * Wp;
    const TD* const fd = src_d + static_cast<size_t>(b) * Hp * Wp;

    if constexpr (kTop) {
      stage_rows<kICols, kFbCols, 4>(fi, W, ir0, ir1, ic0, ic1, c0, sI, [](TI v) { return widen(v); });
      __syncthreads();
    } else {
      float* const sP = smem;
      float* const sR = smem + kPRows * kPCols;
      stage_rows<kPCols, 2 * kFbCols, 12>(fi, Wp, pr0, pr1, pc0, pc1, 2 * c0, sP, [](TI v) { return widen(v); });
      __syncthreads();
      // pyrDown, rows: the 5 taps down the level below at its row 2 i
      for (int k = threadIdx.x; k < (ir1 - ir0 + 1) * kPCols; k += kFbThreads) {
        const int r = k / kPCols, c = k - r * kPCols;
        if (pc0 + c > pc1) continue;
        const int Y = 2 * (ir0 + r);
        const float* col = sP + c;
        float s = kP1 * col[(refl(Y - 2, Hp) - pr0) * kPCols];
        s += kP4 * col[(refl(Y - 1, Hp) - pr0) * kPCols];
        s += kP6 * col[(Y - pr0) * kPCols];
        s += kP4 * col[(refl(Y + 1, Hp) - pr0) * kPCols];
        s += kP1 * col[(refl(Y + 2, Hp) - pr0) * kPCols];
        sR[r * kPCols + c] = s;
      }
      __syncthreads();
      // pyrDown, columns: the 5 taps across the row pass at its column 2 x
      for (int k = threadIdx.x; k < (ir1 - ir0 + 1) * kICols; k += kFbThreads) {
        const int r = k / kICols, c = k - r * kICols;
        if (ic0 + c > ic1) continue;
        const int X = 2 * (ic0 + c);
        const float* row = sR + r * kPCols - pc0;
        float s = kP1 * row[refl(X - 2, Wp)];
        s += kP4 * row[refl(X - 1, Wp)];
        s += kP6 * row[X];
        s += kP4 * row[refl(X + 1, Wp)];
        s += kP1 * row[refl(X + 2, Wp)];
        sI[r * kICols + c] = s;
      }
      __syncthreads();
    }

    // the Gaussian blur, down then across, at the blurred rows and columns
    for (int k = threadIdx.x; k < (br1 - br0 + 1) * kICols; k += kFbThreads) {
      const int r = k / kICols, c = k - r * kICols;
      if (ic0 + c > ic1) continue;
      const int yy = br0 + r;
      const float* col = sI + c;
      float s = kG1 * col[(refl(yy - 1, H) - ir0) * kICols];
      s += kG2 * col[(yy - ir0) * kICols];
      s += kG1 * col[(refl(yy + 1, H) - ir0) * kICols];
      sV[r * kICols + c] = s;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < (br1 - br0 + 1) * kBCols; k += kFbThreads) {
      const int r = k / kBCols, c = k - r * kBCols;
      const int xx = bc0 + c;
      if (xx > bc1) continue;
      const float* row = sV + r * kICols - ic0;
      float s = kG1 * row[refl(xx - 1, W)];
      s += kG2 * row[xx];
      s += kG1 * row[refl(xx + 1, W)];
      sB[r * kBCols + c] = s;
    }
    __syncthreads();

    if (y < H && x < W) {
      const size_t at = static_cast<size_t>(b) * H * W + static_cast<size_t>(y) * W + x;
      const bool vec = W % 4 == 0 && aligned16(out_i + (at - x)) && aligned16(out_d + (at - x)) &&
                       aligned16(out_x + (at - x)) && aligned16(out_y + (at - x));
      // Sobel of the blur: the [1 2 1] and [-1 0 1] passes down at the 6
      // columns x - 1 .. x + 4, reflected at the borders (one past W only
      // where unused)
      const float* bm = sB + (refl(y - 1, H) - br0) * kBCols - bc0;
      const float* bz = sB + (y - br0) * kBCols - bc0;
      const float* bp = sB + (refl(y + 1, H) - br0) * kBCols - bc0;
      float S[6], T[6];
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        const int c = refl(min(x - 1 + m, W), W);
        S[m] = bm[c] + 2.0f * bz[c];
        S[m] += bp[c];
        T[m] = -bm[c] + bp[c];
      }
      float vi[4], vd[4], vx[4], vy[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        vi[k] = sI[(y - ir0) * kICols + (x + k - ic0)];  // read only where k < nx
        vx[k] = -S[k] + S[k + 2];
        vy[k] = T[k] + 2.0f * T[k + 1];
        vy[k] += T[k + 2];
      }
      if constexpr (kTop) {
        TD e[4];
        load4(fd + static_cast<size_t>(y) * W + x, W % 4 == 0 && aligned16(fd), nx, e);
#pragma unroll
        for (int k = 0; k < 4; ++k) vd[k] = ingest(e[k], scale);
      } else {
        // the masked median of the level below at (2 y, 2 (x + k)), 0 on its
        // border; one output at a time, its 9 values loaded as it starts
        const int Y = 2 * y;
        const bool rows_in = Y >= 1 && Y <= Hp - 2;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int X = 2 * (x + k);
          vd[k] = 0.0f;
          if (rows_in && X >= 1 && X <= Wp - 2) {
            const TD* p = fd + static_cast<size_t>(Y - 1) * Wp + (X - 1);
            float nb[9];
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                const TD raw = p[dy * Wp + dx];
                nb[dy * 3 + dx] = ingest_depth ? ingest(raw, scale) : widen(raw);
              }
            vd[k] = masked_median9(nb);
          }
        }
      }
      store4(out_i + at, vec, nx, vi);
      store4(out_d + at, vec, nx, vd);
      store4(out_x + at, vec, nx, vx);
      store4(out_y + at, vec, nx, vy);
    }
    __syncthreads();  // the next frame restages the shared memory
  }
}

template <typename TI, typename TD>
int launch_levels(const void* img, const void* dep, float scale, int B, int H, int W, int n_levels, float* out,
                  cudaStream_t stream) {
  int hp = H, wp = W;  // the level below's size
  const float *prev_i = nullptr, *prev_d = nullptr;
  for (int l = 0; l < n_levels; ++l) {
    const int h = l == 0 ? H : (hp + 1) / 2, w = l == 0 ? W : (wp + 1) / 2;
    const size_t plane = static_cast<size_t>(B) * h * w;
    float *oi = out, *od = out + plane, *ox = out + 2 * plane, *oy = out + 3 * plane;
    const int tiles_x = (w + kFbCols - 1) / kFbCols, tiles_y = (h + kFbRows - 1) / kFbRows;
    const dim3 grid(static_cast<unsigned>(tiles_x * tiles_y), static_cast<unsigned>(B < kFbMaxGridY ? B : kFbMaxGridY));
    if (l == 0) {
      frame_level_kernel<TI, TD, true><<<grid, kFbThreads, 0, stream>>>(
          static_cast<const TI*>(img), static_cast<const TD*>(dep), scale, 1, B, H, W, h, w, tiles_x, oi, od, ox, oy);
    } else if (l == 1) {
      frame_level_kernel<TI, TD, false><<<grid, kFbThreads, 0, stream>>>(
          static_cast<const TI*>(img), static_cast<const TD*>(dep), scale, 1, B, hp, wp, h, w, tiles_x, oi, od, ox, oy);
    } else {
      frame_level_kernel<float, float, false><<<grid, kFbThreads, 0, stream>>>(
          prev_i, prev_d, 1.0f, 0, B, hp, wp, h, w, tiles_x, oi, od, ox, oy);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    prev_i = oi;
    prev_d = od;
    hp = h;
    wp = w;
    out += 4 * plane;
  }
  return 0;
}

}  // namespace vslam

// C entry for ctypes: img (B, H, W) uint8 (img_u8) or f32, dep (B, H, W)
// 16-bit unsigned depth counts (dep_u16) or f32, metres = dep * scale; out
// the levels one after the other, each its planes intensity, depth, dIx, dIy
// of (B, h_l, w_l) f32, h_l = ceil(h_{l-1} / 2). The wrapper holds H, W >= 3
// (and >= 3 for every level a pyrDown reads) and H W < 2^31. One launch a
// level on `stream`, no synchronisation; returns the first launch's
// cudaGetLastError() that is not 0, else 0.
extern "C" int vslam_frame_build(const void* img, const void* dep, int img_u8, int dep_u16, float scale, int B, int H,
                                 int W, int n_levels, void* out, void* stream) {
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_u8 && dep_u16) return vslam::launch_levels<uint8_t, uint16_t>(img, dep, scale, B, H, W, n_levels, o, s);
  if (img_u8) return vslam::launch_levels<uint8_t, float>(img, dep, scale, B, H, W, n_levels, o, s);
  if (dep_u16) return vslam::launch_levels<float, uint16_t>(img, dep, scale, B, H, W, n_levels, o, s);
  return vslam::launch_levels<float, float>(img, dep, scale, B, H, W, n_levels, o, s);
}
