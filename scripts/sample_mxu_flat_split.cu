// The split of the flat-grid design of csrc/sample_mxu.cu (one thread a
// point, 1-D blocks of 256 threads, the image found by a 64-bit division),
// for scripts/kernel_study.py: with kMxuStage 0 an empty kernel on that
// grid, with 1 the coordinates alone (u + v stored in the sample's place).
// It has the sampler's C entry, so the package's wrapper launches it
// (`pallas_kernels._launch(lib=)`), and its kernel's name, so the profiler
// finds it.
#include <cuda_runtime.h>

namespace vslam_flat {

constexpr int kMxuThreads = 256;
constexpr int kMxuStage = 1;

__global__ void __launch_bounds__(kMxuThreads)
    sample_mxu_kernel(const float* u, const float* v, int B, int M, float* out) {
  const size_t i = (size_t)blockIdx.x * kMxuThreads + threadIdx.x;
  if (kMxuStage == 0 || i >= (size_t)B * M) return;
  out[i] = u[i] + v[i];
}

}  // namespace vslam_flat

extern "C" int vslam_bilinear_sample_mxu(const void* img, const void* u, const void* v, int B,
                                         int M, int H, int W, void* out, void* stream) {
  (void)img, (void)H, (void)W;
  const size_t n = (size_t)B * M;
  const unsigned grid = (unsigned)((n + vslam_flat::kMxuThreads - 1) / vslam_flat::kMxuThreads);
  vslam_flat::sample_mxu_kernel<<<grid, vslam_flat::kMxuThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(v), B, M, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
