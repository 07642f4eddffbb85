// Fused RMSNorm over the last axis: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` / `fused_rmsnorm` in
// src/repro/kernels/rmsnorm.py. x (rows, d) float32 or bfloat16, scale
// (groups * d,) float32: row r takes the scale's slice r % groups, so a
// norm over groups of d channels of a (rows / groups, groups * d) tensor
// (Mamba-2's grouped gated norm) is one launch; groups is 1 for a plain
// norm. The sum of squares, rsqrt and both multiplies are float32 and the
// result is cast to x's type.
//
// What bounds it on an H100: a few operations per element against one read
// of x and one write of y, so bytes bound it: 41.9 MB at (2048, 2560)
// float32, 12.5 us at 3.35 TB/s. A kernel that reads x twice (from L2 the
// second time) or with 4-byte loads spends its time on load instructions
// and L2 round trips, not on HBM. Decode rows (4, d) are a few tens of KB:
// there the launch itself is the cost.
//
// Design: x is read once. On the register path each row belongs to a group
// of TPR threads (one warp, or 2, 4 or 8 warps for wider rows; a 256-thread
// CTA holds 256 / TPR rows), each thread loads up to 8 16-byte vectors of
// the row (4 float32 or 8 bfloat16 each, neighbouring threads on
// neighbouring addresses) into registers, the float32 sum of squares is
// reduced by warp shuffles (and across the row's warps in shared memory),
// and the scaled row leaves from the same registers as 16-byte stores.
// The vectors per thread are a template parameter, and TPR is the fewest
// threads that keep it at 8 or below: every served width fits exactly
// (float32 1536: 64 x 6, 2048: 64 x 8, 2560: 128 x 5, 3072: 128 x 6;
// bfloat16 2048: 32 x 8). Rows that are not in 16-byte units, bases that
// are not 16-byte aligned, and rows wider than 2048 vectors take the
// general path: one CTA per row, element-wise, reading x twice.

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVec = 8;  // 16-byte vectors per thread on the register path

// The 16-byte vector of T as float32 values, and back.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kPer = 4;
  __device__ static void load(float (&v)[4], const float* p) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kPer = 8;
  __device__ static void load(float (&v)[8], const __nv_bfloat16* p) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[8]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(gs::pack_bf16x2(v[0], v[1]), gs::pack_bf16x2(v[2], v[3]),
                   gs::pack_bf16x2(v[4], v[5]), gs::pack_bf16x2(v[6], v[7]));
  }
};

// Register path: V vectors per thread, `tpr` threads (a multiple of 32
// dividing kThreads) per row.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_vec(const T* __restrict__ x, const float* __restrict__ scale,
                T* __restrict__ y, long long rows, int d, int groups, int tpr,
                float eps) {
  constexpr int kPer = Vec16<T>::kPer;
  const int col0 = threadIdx.x % tpr;
  const long long row =
      (long long)blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const int nv = d / kPer;
  const T* xr = x + row * d;

  float v[V][kPer];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = col0 + k * tpr;
    if (live && c < nv) {
      Vec16<T>::load(v[k], xr + c * kPer);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) v[k][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) ss = fmaf(v[k][e], v[k][e], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {  // uniform over the CTA
    __shared__ float warp_sums[kWarps];
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
    __syncthreads();
    const int w0 = (threadIdx.x / tpr) * (tpr / 32);
    ss = 0.f;
    for (int w = 0; w < tpr / 32; ++w) ss += warp_sums[w0 + w];
  }
  if (!live) return;

  const float r = rsqrtf(ss / (float)d + eps);
  T* yr = y + row * d;
  const float* sr = scale + (row % groups) * d;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = col0 + k * tpr;
    if (c >= nv) continue;
    float s[kPer];
#pragma unroll
    for (int e = 0; e < kPer; e += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(sr + c * kPer + e);
      s[e] = s4.x, s[e + 1] = s4.y, s[e + 2] = s4.z, s[e + 3] = s4.w;
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) s[e] = v[k][e] * r * s[e];
    Vec16<T>::store(yr + c * kPer, s);
  }
}

// General path: one 256-thread CTA per row, any d and alignment; the
// second pass re-reads the row (from L1/L2) to scale and store it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_rows(const T* __restrict__ x, const float* __restrict__ scale,
                 T* __restrict__ y, int d, int groups, float eps) {
  const long long base = (long long)blockIdx.x * d;
  const T* xr = x + base;
  T* yr = y + base;
  const float* sr = scale + (long long)(blockIdx.x % groups) * d;

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
    yr[c] = gs::from_f32<T>(gs::to_f32(xr[c]) * r * sr[c]);
}

template <typename T, int V>
cudaError_t launch_vec(const T* x, const float* scale, T* y, long long rows,
                       int d, int groups, int tpr, float eps,
                       cudaStream_t stream) {
  const long long per_cta = kThreads / tpr;
  const long long blocks = (rows + per_cta - 1) / per_cta;
  rmsnorm_vec<T, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, scale, y, rows, d, groups, tpr, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xv, const float* scale, void* yv,
                   long long rows, int d, int groups, float eps,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  constexpr int kPer = Vec16<T>::kPer;
  const int nv = d / kPer;
  const bool vec = d % kPer == 0 && nv <= kMaxVec * kThreads &&
                   gs::aligned16(x) && gs::aligned16(y) &&
                   gs::aligned16(scale);
  if (!vec) {
    rmsnorm_rows<T><<<(unsigned)rows, kThreads, 0, stream>>>(x, scale, y, d,
                                                              groups, eps);
    return cudaGetLastError();
  }
  int tpr = 32;
  while (nv > kMaxVec * tpr) tpr *= 2;
  switch ((nv + tpr - 1) / tpr) {
    case 1: return launch_vec<T, 1>(x, scale, y, rows, d, groups, tpr, eps,
                                    stream);
    case 2: return launch_vec<T, 2>(x, scale, y, rows, d, groups, tpr, eps,
                                    stream);
    case 3: return launch_vec<T, 3>(x, scale, y, rows, d, groups, tpr, eps,
                                    stream);
    case 4: return launch_vec<T, 4>(x, scale, y, rows, d, groups, tpr, eps,
                                    stream);
    case 5: return launch_vec<T, 5>(x, scale, y, rows, d, groups, tpr, eps,
                                    stream);
    case 6: return launch_vec<T, 6>(x, scale, y, rows, d, groups, tpr, eps,
                                    stream);
    case 7: return launch_vec<T, 7>(x, scale, y, rows, d, groups, tpr, eps,
                                    stream);
    default: return launch_vec<T, 8>(x, scale, y, rows, d, groups, tpr, eps,
                                     stream);
  }
}

}  // namespace

extern "C" int gs_rmsnorm(int dtype, const void* x, const void* scale, void* y,
                          long long rows, int d, int groups, float eps,
                          void* stream) {
  if (d < 1 || groups < 1 || rows < 0 || rows > 0x7fffffffLL ||
      rows % groups)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const float* s = static_cast<const float*>(scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gs::kFloat32:
      return (int)launch<float>(x, s, y, rows, d, groups, eps, st);
    case gs::kBFloat16:
      return (int)launch<__nv_bfloat16>(x, s, y, rows, d, groups, eps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
