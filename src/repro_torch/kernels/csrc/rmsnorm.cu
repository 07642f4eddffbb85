// Fused RMSNorm over the last axis: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` / `fused_rmsnorm` in
// src/repro/kernels/rmsnorm.py. x (rows, d) float32 or bfloat16, scale (d,)
// float32; the sum of squares, rsqrt and both multiplies are float32 and the
// result is cast to x's type.
//
// What bounds it on an H100: a few operations per element against one read
// of x and one write of y, so bytes bound it (41.9 MB at (2048, 2560)
// float32, 12.5 us at 3.35 TB/s). Decode rows (4, 2560) are 82 KB: there the
// launch itself is the cost.
//
// Design: one 256-thread CTA per row; each thread strides over the row's
// columns (neighbouring threads on neighbouring addresses), the float32 sum
// of squares is reduced by warp shuffles and then across the 8 warps in
// shared memory, and the second pass re-reads the row (from L1/L2) to scale
// and store it. Any d is taken; no tensor cores are involved.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_rows(const T* __restrict__ x, const float* __restrict__ scale,
                 T* __restrict__ y, int d, float eps) {
  const long long base = (long long)blockIdx.x * d;
  const T* xr = x + base;
  T* yr = y + base;

  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float v = gs::to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  __shared__ float warp_sums[kWarps];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += warp_sums[w];

  const float r = rsqrtf(total / (float)d + eps);
  for (int c = threadIdx.x; c < d; c += kThreads)
    yr[c] = gs::from_f32<T>(gs::to_f32(xr[c]) * r * scale[c]);
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, void* y, long long rows,
                   int d, float eps, cudaStream_t stream) {
  rmsnorm_rows<T><<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gs_rmsnorm(int dtype, const void* x, const void* scale, void* y,
                          long long rows, int d, float eps, void* stream) {
  if (d < 1 || rows < 0 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const float* s = static_cast<const float*>(scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gs::kFloat32:
      return (int)launch<float>(x, s, y, rows, d, eps, st);
    case gs::kBFloat16:
      return (int)launch<__nv_bfloat16>(x, s, y, rows, d, eps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
