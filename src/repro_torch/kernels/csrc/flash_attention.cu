// Causal GQA flash attention with an optional sliding window, forward only.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py. Same function: q (B,Sq,H,D), k/v
// (B,Sk,Hkv,D) -> o (B,Sq,H,D) in q's type; query head h reads kv head
// h / (H/Hkv); key k is visible to query q when k <= q (causal) and
// k > q - window (window > 0); online softmax with float32 running max,
// denominator and accumulator; masked scores are -1e30 and a row that sees
// no key writes 0, as the Pallas kernel does.
//
// What bounds it on an H100: at the main-path shape (4,512,32,80) causal the
// work is ~5.4 GFLOP against 52 MB of q/k/v/o, so the floor is the
// arithmetic (80 us at the 67 TFLOP/s float32 rate without tensor cores,
// 5.4 us at the 989 TFLOP/s bf16 tensor-core rate); bytes alone would take
// 16 us. This first version uses no tensor cores: it is meant to be right
// and simple, and the CUDA-core FMAs it issues from shared memory bound it.
//
// Design: one CTA per (64-row q tile, q head, batch). The CTA loops over
// 64-key tiles itself, which replaces the Pallas grid's sequential key axis,
// and skips tiles wholly above the diagonal or wholly before the window.
// The Q tile and each K/V tile are converted to float32 in dynamic shared
// memory (rows padded by one float so the per-row reads fall in distinct
// banks); 4 threads own one query row: each computes 16 of the tile's 64
// scores, the row max and sum are reduced with two shuffles, the row's
// probabilities go to shared memory, and each thread accumulates a quarter
// of the row's D output columns (at most 32) in registers. q/k/v/o are read
// and written through their (B,S,H) strides, so no transposes are needed;
// any D <= 128 and ragged S tails are masked.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;                 // query rows per CTA
constexpr int kBK = 64;                 // keys per tile
constexpr int kTPR = 4;                 // threads per query row
constexpr int kThreads = kBQ * kTPR;    // 256
constexpr int kMaxD = 128;
constexpr int kKPT = kBK / kTPR;        // scores per thread per tile
constexpr int kDPT = kMaxD / kTPR;      // output columns per thread, at most
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, Hkv, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window;
  float scale;
};

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 1) +
                          (size_t)kBQ * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
  extern __shared__ float smem[];
  const int ld = p.D + 1;
  float* sQ = smem;               // kBQ x ld
  float* sK = sQ + kBQ * ld;      // kBK x ld
  float* sV = sK + kBK * ld;      // kBK x ld
  float* sP = sV + kBK * ld;      // kBQ x (kBK + 1)

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int row = tid / kTPR;
  const int sub = tid % kTPR;
  const int qpos = q0 + row;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < kBQ * p.D; i += kThreads) {
    const int r = i / p.D, c = i - r * p.D;
    const int s = q0 + r;
    sQ[r * ld + c] = s < p.Sq ? gs::to_f32(q[s * p.q_ss + c]) : 0.f;
  }

  // Keys any row of this tile can see: [k_begin, k_end).
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int t_begin = k_begin / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;

  float m = kNegInf, l = 0.f;
  float acc[kDPT];
#pragma unroll
  for (int u = 0; u < kDPT; ++u) acc[u] = 0.f;
  const float* qrow = sQ + row * ld;
  float* prow = sP + row * (kBK + 1);

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done (and sQ is in)
    for (int i = tid; i < kBK * p.D; i += kThreads) {
      const int r = i / p.D, c = i - r * p.D;
      const int s = k0 + r;
      const bool in = s < p.Sk;
      sK[r * ld + c] = in ? gs::to_f32(k[s * p.k_ss + c]) : 0.f;
      sV[r * ld + c] = in ? gs::to_f32(v[s * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float sc[kKPT];
#pragma unroll
    for (int j = 0; j < kKPT; ++j) sc[j] = 0.f;
    for (int d = 0; d < p.D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kKPT; ++j)
        sc[j] = fmaf(qd, sK[(sub + kTPR * j) * ld + d], sc[j]);
    }

    unsigned visible = 0;
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kKPT; ++j) {
      const int kpos = k0 + sub + kTPR * j;
      bool ok = kpos < p.Sk;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && kpos > qpos - p.window;
      sc[j] = ok ? sc[j] * p.scale : kNegInf;
      visible |= (unsigned)ok << j;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    // the 4 threads of a row are adjacent lanes of one warp
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKPT; ++j) {
      const float pj = (visible >> j) & 1u ? expf(sc[j] - m_new) : 0.f;
      psum += pj;
      prow[sub + kTPR * j] = pj;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();  // the row's probabilities are visible to its 4 threads

#pragma unroll
    for (int u = 0; u < kDPT; ++u) acc[u] *= alpha;
    for (int j = 0; j < kBK; ++j) {
      const float pj = prow[j];
      const float* vrow = sV + j * ld;
#pragma unroll
      for (int u = 0; u < kDPT; ++u) {
        const int c = sub + kTPR * u;
        if (c < p.D) acc[u] = fmaf(pj, vrow[c], acc[u]);
      }
    }
  }

  if (qpos < p.Sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* o = static_cast<T*>(p.o) + b * p.o_sb + qpos * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int u = 0; u < kDPT; ++u) {
      const int c = sub + kTPR * u;
      if (c < p.D) o[c] = gs::from_f32<T>(acc[u] / denom);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gs_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* o, int B,
    int Sq, int Sk, int H, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float scale,
    void* stream) {
  if (D < 1 || D > kMaxD || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaSuccess;
  const Params p{q,    k,    v,    o,    B,    Sq,   Sk,   H,    Hkv,
                 D,    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                 v_sh, o_sb, o_ss, o_sh, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gs::kFloat32:
      return (int)launch<float>(p, s);
    case gs::kBFloat16:
      return (int)launch<__nv_bfloat16>(p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
