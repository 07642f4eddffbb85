// Grouped (per-expert) matmul: (E, C, d) @ (E, d, f) -> (E, C, f).
//
// Replaces the Pallas TPU kernel `_gmm_kernel` / `grouped_matmul` in
// src/repro/kernels/moe_matmul.py. Same function: x and w in float32 or
// bfloat16 (both of one type), float32 accumulation, the output in x's
// type. The MoE expert FF calls it three times per layer (gate, up, down)
// on the capacity layout (E, G*C, d).
//
// What bounds it on an H100: at qwen3-moe-30b-a3b's prefill,
// (128, 160, 2048) @ (128, 2048, 768) in bfloat16, the expert weights are
// 403 MB: 0.12 ms at 3.35 TB/s, against 0.065 ms for the 64.4 GFLOP at the
// 989 TFLOP/s bfloat16 tensor-core rate, so bytes bound it (0.155 ms with
// x and the output). At decode (C = 8) the weights are the whole cost.
// This first version uses no tensor cores: its float32 FMAs on CUDA cores
// take 4.25 ms at the prefill shape on an H100 80GB HBM3 at 700 W
// (chip_smoke.py), 22x torch.bmm and 1.8x the plain float32 einsum;
// tensor-core MMA comes later.
//
// Design: one CTA per (expert, BM-row tile, 64-column tile) walks the
// contraction in 32-deep steps through shared memory (x tile stored
// transposed, so a warp reads one broadcast row value and 16 consecutive
// w values); 256 threads as 16 x 16, each owning a (BM/16) x 4 register
// tile. BM is 64, or 16 when C <= 16 (decode), so a decode step does not
// multiply 56 rows of zeros per tile. Ragged C, d and f tails are masked.

#include "common.cuh"

namespace {

constexpr int kBN = 64;   // output columns per CTA
constexpr int kBK = 32;   // contraction depth per step
constexpr int kThreads = 256;

struct Params {
  const void* x;
  const void* w;
  void* o;
  int E, C, d, f;
};

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads) gmm_fwd(Params p) {
  constexpr int TM = BM / 16;  // rows per thread
  __shared__ float sX[kBK][BM + 1];  // x tile transposed: [k][row]
  __shared__ float sW[kBK][kBN];     // w tile: [k][col]

  const int e = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* x = static_cast<const T*>(p.x) + (long long)e * p.C * p.d;
  const T* w = static_cast<const T*>(p.w) + (long long)e * p.d * p.f;

  float acc[TM][4];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < p.d; k0 += kBK) {
    // x tile: consecutive threads read consecutive k of one row
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, k = i % kBK;
      const int gr = row0 + r, gk = k0 + k;
      sX[k][r] = (gr < p.C && gk < p.d)
                     ? gs::to_f32(x[(long long)gr * p.d + gk]) : 0.f;
    }
    // w tile: consecutive threads read consecutive columns of one k
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, c = i % kBN;
      const int gk = k0 + k, gc = col0 + c;
      sW[k][c] = (gk < p.d && gc < p.f)
                     ? gs::to_f32(w[(long long)gk * p.f + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float a[TM], b[4];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = sX[k][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = sW[k][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

  T* o = static_cast<T*>(p.o) + (long long)e * p.C * p.f;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gr = row0 + ty + 16 * r;
    if (gr >= p.C) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gc = col0 + tx + 16 * c;
      if (gc < p.f) o[(long long)gr * p.f + gc] = gs::from_f32<T>(acc[r][c]);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const unsigned cols = (p.f + kBN - 1) / kBN;
  if (p.C <= 16) {
    gmm_fwd<T, 16><<<dim3(cols, (p.C + 15) / 16, p.E), kThreads, 0, stream>>>(p);
  } else {
    gmm_fwd<T, 64><<<dim3(cols, (p.C + 63) / 64, p.E), kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int gs_grouped_matmul(int dtype, const void* x, const void* w,
                                 void* o, int E, int C, int d, int f,
                                 void* stream) {
  if (E < 0 || C < 0 || d < 0 || f < 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  if (E == 0 || C == 0 || f == 0) return (int)cudaSuccess;
  const Params p{x, w, o, E, C, d, f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gs::kFloat32:
      return (int)launch<float>(p, st);
    case gs::kBFloat16:
      return (int)launch<__nv_bfloat16>(p, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
