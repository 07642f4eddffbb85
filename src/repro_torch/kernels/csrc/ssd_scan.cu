// Chunked SSD (Mamba-2 state-space duality) scan, forward only.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_scan_chunked` in
// src/repro/kernels/ssd_scan.py. Same function: x (B,S,H,P) and B/C
// (B,S,G,N) in float32 or bfloat16, dt (B,S,H), A and D (H,) and the
// optional initial state (B,H,P,N) in float32 ->
// y (B,S,H,P) in x's type and the final state (B,H,P,N) in float32, with
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t,
// computed chunk by chunk as the duality's lower-triangular "attention"
// inside a chunk plus the state carried across chunks. All math is float32.
//
// What bounds it on an H100: at mamba2-780m's prefill (B=4, S=512, H=48,
// P=64, N=128) the least work that computes the function is 4.03 GFLOP
// (chunked at the model's 256: the lower-triangle C.B^T and W.x, C.state
// where a state enters a chunk, the deposit), against ~59 MB of x, y, B,
// C, dt and the final state, so operations bound it: 0.0601 ms at the
// 67 TFLOP/s float32 rate without tensor cores (the bytes alone take
// 18 us). TF32 stays off: it keeps about three decimal digits and would
// break the 5e-4 parity bar.
//
// Design: the chunk-parallel split of the Mamba-2 GPU algorithm
// (arXiv:2405.21060 section 7; mamba_ssm's ssd_combined.py makes the same
// split), five kernels launched in order on the caller's stream. The TPU
// kernel walks the chunks of a head in order only because its grid runs
// in order; here only the state passing is sequential, and it is
// elementwise.
//   1. ssd_chunk_sums, grid (chunk, head, batch), one thread per step: dt
//      (0 past S), a = dt A and the chunk's log-decay sums by shuffle
//      scans, into a float32 workspace (B, H, nc, 5, 64).
//   2. ssd_chunk_cb, grid (chunk, group, batch): C_i . B_j of the chunk on
//      and below the diagonal, into a (B, nc, G, 64, 64) workspace. It
//      depends on no head, so it is computed once per B/C group instead of
//      once per head (48 times at mamba2's G = 1).
//   3. ssd_chunk_state, grid (head, chunk, batch): the chunk's deposit
//      sum_j dt_j exp(suffix_j) x_j B_j^T into a (B, nc, H, P, N) float32
//      workspace, as a 64-token outer-product loop over 4 x 8 register
//      tiles fed by 16-byte shared loads.
//   4. ssd_state_pass, grid (P N / 1024, head, batch): each thread walks 4
//      state elements (one 16-byte vector) through the chunks, with the
//      deposits of 8 chunks in flight, s_c = s_{c-1} exp(sum of a over
//      chunk c) + deposit_c, from the initial state or zeros; it writes
//      the state entering each chunk over that chunk's deposit (in place)
//      and the final state.
//   5. ssd_chunk_scan, grid (head, chunk, batch): y_i = exp(prefix_i) C_i.s
//      + sum_{j<=i} CB[i][j] exp(seg(i, j)) dt_j x_j + D x_i.
// The kernels chunk at 64 tokens whatever the caller's chunk is: the
// function does not depend on where chunks fall, the intra-chunk work per
// token grows with the chunk and the state work does not, and one 64-row
// tile per chunk leaves only a diagonal tile (the model's 256 would need
// 10 C.B^T tiles per chunk against 1 here). Kernels 2 and 5 are 256-thread
// CTAs (16 x 16) with 4 x 4 register tiles (rows ty + 16 r, columns
// tx + 16 q, a warp covering 4 ty x 8 tx) fed by 16-byte shared loads
// along N (C.B^T, C.state) or j (W in W.x, with x read 4 bytes a lane along
// p), rows padded to an odd number of 16-byte units against bank conflicts
// (N to 132 floats, 64 to 68). C.B^T and W.x run only on and below the
// diagonal (the 10 of 16 (r, q) sub-tiles with q <= r, fixed at compile
// time) and exps are taken only there. Kernel 5 copies C.B^T and x by
// 16-byte cp.async, then C and the entering state in a second group that
// lands while W and W.x are computed; 101 KB of shared memory give two
// CTAs per SM. The state term (and C) is skipped for a first chunk
// without an initial state.
//
// Precision: no log-decay is a difference of two cumulative sums. With A
// down to -48 a chunk's cumsum reaches -1e4, where one float32 ulp is
// 1e-3, and a difference of two such values loses that much of a short
// segment. Every log-decay is a sum of same-sign terms: the prefix and
// suffix sums by scans; a segment seg(i, j) = sum of a over (j, i] as the
// row's prefix in its 16-step sub-block + the whole sub-blocks between +
// the column's suffix in its sub-block, or, inside one sub-block, a direct
// sum of at most 15 steps. The state passing multiplies by exp of a
// chunk's own sum.
//
// B and C are read at group h / (H / G), through their strides. Any S is
// taken: positions past S act as dt = 0 (identity steps, no deposit) and
// are not written. P <= 64 and N <= 128. bfloat16 shares the design and
// converts on load (element-wise loads, no cp.async). The workspaces come
// from the caller (ops.ssd_scan allocates them with torch.empty on the
// input's device); nothing is allocated here.

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kLk = 64;        // tokens of the kernels' own chunk
constexpr int kSub = 16;       // sub-block of a chunk for segment sums
constexpr int kThreads = 256;  // 16 x 16 (kernels 2 to 5)
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kLdN = kMaxN + 4;  // 33 16-byte units: odd
constexpr int kLdX = kLk + 4;    // 17 16-byte units: odd (also kMaxP + 4)
constexpr int kSums = 5;         // arrays of kLk floats per chunk
enum SumArray : int { kDt = 0, kPre = 1, kSuf = 2, kP16 = 3, kQ16 = 4 };
static_assert(kMaxP == kLk, "x and W rows share the stride kLdX");

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;
  const float* s0;  // (B,H,P,N) contiguous, or null for zeros
  void* y;          // (B,S,H,P) contiguous
  float* sf;        // (B,H,P,N) contiguous
  float* sums;      // (B,H,nc,kSums,kLk): dt, prefix, suffix, p16, q16
  float* cb;        // (B,nc,G,kLk,kLk): C.B^T of each chunk and group
  float* states;    // (B,nc,H,P,N): deposits, then the entering states
  int Bsz, S, H, G, P, N, nc;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

__device__ __forceinline__ float* chunk_sums(const Params& p, int b, int h,
                                             int c) {
  return p.sums + (((long long)b * p.H + h) * p.nc + c) * (kSums * kLk);
}

__device__ __forceinline__ float* chunk_cb(const Params& p, int b, int g,
                                           int c) {
  return p.cb + (((long long)b * p.nc + c) * p.G + g) * (kLk * kLk);
}

__device__ __forceinline__ float* chunk_state(const Params& p, int b, int h,
                                              int c) {
  return p.states + (((long long)b * p.nc + c) * p.H + h) * p.P * p.N;
}

// ---------------------------------------------------------------- 1. sums
// Per chunk: dt (0 past S), the inclusive prefix of a over the chunk, the
// exclusive suffix to its end, and the same two inside each 16-step
// sub-block. Shuffle scans; every sum is of same-sign terms.
__global__ void __launch_bounds__(kLk) ssd_chunk_sums(Params p) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int i = threadIdx.x, sub = i & (kSub - 1);
  const int t = c * kLk + i;
  const float d =
      t < p.S ? p.dt[b * p.dt_sb + (long long)t * p.dt_ss + h * p.dt_sh] : 0.f;
  const float a = d * p.A[h];

  float p16 = a;  // sum of a over [sub-block start, i]
  float s16 = a;  // sum of a over [i, sub-block end]
#pragma unroll
  for (int off = 1; off < kSub; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, p16, off, kSub);
    const float dn = __shfl_down_sync(0xffffffffu, s16, off, kSub);
    if (sub >= off) p16 += up;
    if (sub + off < kSub) s16 += dn;
  }
  float q16 = __shfl_down_sync(0xffffffffu, s16, 1, kSub);  // over (i, end]
  if (sub == kSub - 1) q16 = 0.f;

  __shared__ float blk[kLk / kSub];  // each sub-block's sum
  if (sub == kSub - 1) blk[i / kSub] = p16;
  __syncthreads();
  float pre = p16, suf = q16;
#pragma unroll
  for (int k = 0; k < kLk / kSub; ++k) {
    if (k < i / kSub) pre += blk[k];
    if (k > i / kSub) suf += blk[k];
  }

  float* out = chunk_sums(p, b, h, c);
  out[kDt * kLk + i] = d;
  out[kPre * kLk + i] = pre;
  out[kSuf * kLk + i] = suf;
  out[kP16 * kLk + i] = p16;
  out[kQ16 * kLk + i] = q16;
}

// Rows [0, kLk) of a (rows, width) block with row stride ld_g, as float32
// into a shared tile of row stride LD, zero past `valid` rows and past
// `width` columns up to COLS. kVec: float32 with width, strides and base
// in 16-byte units, copied by cp.async (the caller commits and waits).
template <typename T, bool kVec, int COLS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ld_g, int valid,
                                          int width, int tid) {
  if constexpr (kVec && std::is_same<T, float>::value) {
    constexpr int kCh = COLS / 4;
    for (int e = tid; e < kLk * kCh; e += kThreads) {
      const int r = e / kCh, col = (e % kCh) * 4;
      const bool in = r < valid && col < width;
      gs::cp_async_16(dst + r * LD + col, in ? src + r * ld_g + col : src,
                      in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kLk * COLS; e += kThreads) {
      const int r = e / COLS, col = e % COLS;
      dst[r * LD + col] =
          (r < valid && col < width) ? gs::to_f32(src[r * ld_g + col]) : 0.f;
    }
  }
}

// Thread tid of 256 as (ty, tx) of a 16 x 16 grid, a warp covering 4 ty
// x 8 tx: its 16-byte shared loads of rows ty + 16 r (or 4 ty) and of rows
// tx + 16 q (or columns 4 tx) each touch at most 128 bytes, one wavefront.
__device__ __forceinline__ void tile_coords(int tid, int& ty, int& tx) {
  tx = (tid & 7) | ((tid >> 2) & 8);
  ty = ((tid >> 3) & 3) | ((tid >> 4) & 12);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ------------------------------------------------------------ 2. C.B^T
// CB[i][j] = C_i . B_j of one chunk and B/C group, on and below the
// diagonal sub-tiles: every head of the group shares it. Thread (ty, tx)
// owns rows i = ty + 16 r and columns j = tx + 16 q, q <= r.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) ssd_chunk_cb(Params p) {
  float* sC = gs::dynamic_smem<float>();  // kLk x kLdN: C_i[n]
  float* sB = sC + kLk * kLdN;            // kLk x kLdN: B_j[n]
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  int ty, tx;
  tile_coords(tid, ty, tx);
  const int t0 = c * kLk, valid = min(kLk, p.S - t0);
  const int n4 = (p.N + 3) & ~3;  // columns of C and B read
  const T* bg = static_cast<const T*>(p.Bm) + b * p.b_sb + g * p.b_sg +
                (long long)t0 * p.b_ss;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.c_sb + g * p.c_sg +
                (long long)t0 * p.c_ss;
  load_rows<T, kVec, kMaxN, kLdN>(sC, cg, p.c_ss, valid, p.N, tid);
  load_rows<T, kVec, kMaxN, kLdN>(sB, bg, p.b_ss, valid, p.N, tid);
  gs::cp_async_commit();
  gs::cp_async_wait<0>();
  __syncthreads();

  float t[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) t[r][q] = 0.f;
  for (int n = 0; n < n4; n += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) cv[r] = ld4(sC + (ty + 16 * r) * kLdN + n);
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = ld4(sB + (tx + 16 * q) * kLdN + n);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q <= r; ++q) t[r][q] = dot4(cv[r], bv[q], t[r][q]);
  }
  float* out = chunk_cb(p, b, g, c);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q <= r; ++q) out[(ty + 16 * r) * kLk + tx + 16 * q] = t[r][q];
}

// ----------------------------------------------------------- 3. deposits
// deposit[p][n] = sum_j x_j[p] dt_j exp(suf_j) B_j[n]. Thread (ty, tx)
// owns p = 4 ty .. 4 ty + 3 and n = 4 tx .. 4 tx + 3, 64 + 4 tx .. + 3.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) ssd_chunk_state(Params p) {
  float* sX = gs::dynamic_smem<float>();  // kLk x kLdX: x_j[p], weighted
  float* sB = sX + kLk * kLdX;            // kLk x kLdN: B_j[n]
  float* sWt = sB + kLk * kLdN;           // kLk: dt_j exp(suf_j)
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x;
  int ty, tx;
  tile_coords(tid, ty, tx);
  const int t0 = c * kLk, valid = min(kLk, p.S - t0);

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh +
                (long long)t0 * p.x_ss;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.b_sb + g * p.b_sg +
                (long long)t0 * p.b_ss;
  load_rows<T, kVec, kMaxP, kLdX>(sX, xg, p.x_ss, valid, p.P, tid);
  load_rows<T, kVec, kMaxN, kLdN>(sB, bg, p.b_ss, valid, p.N, tid);
  gs::cp_async_commit();
  const float* sums = chunk_sums(p, b, h, c);
  if (tid < kLk) sWt[tid] = sums[kDt * kLk + tid] * expf(sums[kSuf * kLk + tid]);
  gs::cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < kLk * kMaxP; e += kThreads) {
    const int j = e / kMaxP, q = e % kMaxP;
    sX[j * kLdX + q] *= sWt[j];
  }
  __syncthreads();

  float acc[4][8];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
#pragma unroll 4
  for (int j = 0; j < valid; ++j) {
    const float4 xv = ld4(sX + j * kLdX + 4 * ty);
    const float4 b0 = ld4(sB + j * kLdN + 4 * tx);
    const float4 b1 = ld4(sB + j * kLdN + 64 + 4 * tx);
    const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
    const float ba[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(xa[u], ba[v], acc[u][v]);
  }

  float* out = chunk_state(p, b, h, c);
  const int N = p.N;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int pp = 4 * ty + u;
    if (pp >= p.P) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n0 = 64 * half + 4 * tx;
      const float* v = acc[u] + 4 * half;
      float* dst = out + (long long)pp * N + n0;
      if (N % 4 == 0 && n0 < N) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (n0 + k < N) dst[k] = v[k];
      }
    }
  }
}

// ------------------------------------------------------- 4. state passing
// Each thread walks W consecutive state elements (W = 4: one 16-byte
// vector, where P N and the initial state allow it) through the chunks,
// with the deposits of 8 chunks in flight: the walk is bound by memory
// latency unless many loads are outstanding per thread.
template <int W>
struct Lane;
template <>
struct Lane<1> {
  float v[1];
  __device__ void load(const float* p) { v[0] = __ldcg(p); }
  __device__ void store(float* p) const { *p = v[0]; }
};
template <>
struct Lane<4> {
  float v[4];
  __device__ void load(const float* p) {
    const float4 r = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
  __device__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <int W>
__global__ void __launch_bounds__(kThreads) ssd_state_pass(Params p) {
  const int h = blockIdx.y, b = blockIdx.z;
  const long long PN = (long long)p.P * p.N;
  const long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) * W;
  if (e >= PN) return;
  const long long head = ((long long)b * p.H + h) * PN;
  Lane<W> s;
  if (p.s0) {
    s.load(p.s0 + head + e);
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) s.v[k] = 0.f;
  }
  const long long step = (long long)p.H * PN;  // one chunk of states
  float* st = p.states + (long long)b * p.nc * step + h * PN + e;
  // the sum of a over chunk c: its prefix at the last step
  const float* tot = p.sums + ((long long)b * p.H + h) * p.nc * (kSums * kLk) +
                     kPre * kLk + kLk - 1;
  constexpr int kAhead = 8;  // chunks in flight per thread
  for (int c0 = 0; c0 < p.nc; c0 += kAhead) {
    Lane<W> dep[kAhead];
    float dec[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < p.nc) {
        dep[k].load(st + (c0 + k) * step);
        dec[k] = tot[(long long)(c0 + k) * (kSums * kLk)];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < p.nc) {
        s.store(st + (c0 + k) * step);
        const float decay = expf(dec[k]);
#pragma unroll
        for (int u = 0; u < W; ++u) s.v[u] = fmaf(s.v[u], decay, dep[k].v[u]);
      }
    }
  }
  s.store(p.sf + head + e);
}

// ------------------------------------------------------------ 5. outputs
// Thread (ty, tx) owns rows i = ty + 16 r and columns tx + 16 q (keys j
// of W, head dims p of y and C.state).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_scan(Params p) {
  float* sC = gs::dynamic_smem<float>();  // kLk x kLdN: C_i[n]
  float* sS = sC + kLk * kLdN;   // kMaxP x kLdN: the entering state [p][n]
  float* sX = sS + kMaxP * kLdN;  // kLk x kLdX: x_j[p]
  float* sW = sX + kLk * kLdX;    // kLk x kLdX: C_i.B_j, then W[i][j]
  float* sA = sW + kLk * kLdX;     // kLk: a = dt A
  float* sDt = sA + kLk;
  float* sPre = sDt + kLk;
  float* sP16 = sPre + kLk;
  float* sQ16 = sP16 + kLk;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x;
  int ty, tx;
  tile_coords(tid, ty, tx);
  const int t0 = c * kLk, valid = min(kLk, p.S - t0);
  const bool has_state = c > 0 || p.s0 != nullptr;
  const int n4 = (p.N + 3) & ~3;  // columns of C and the state read

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh +
                (long long)t0 * p.x_ss;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.c_sb + g * p.c_sg +
                (long long)t0 * p.c_ss;
  // two copy groups: C.B^T and x for W.x first, C and the state for the
  // state term land meanwhile
  load_rows<float, true, kLk, kLdX>(sW, chunk_cb(p, b, g, c), kLk, kLk, kLk,
                                    tid);
  load_rows<T, kVec, kMaxP, kLdX>(sX, xg, p.x_ss, valid, p.P, tid);
  gs::cp_async_commit();
  if (has_state) {
    load_rows<T, kVec, kMaxN, kLdN>(sC, cg, p.c_ss, valid, p.N, tid);
    load_rows<float, kVec, kMaxN, kLdN>(sS, chunk_state(p, b, h, c), p.N,
                                        p.P, p.N, tid);
  }
  gs::cp_async_commit();
  if (tid < kLk) {
    const float* sums = chunk_sums(p, b, h, c);
    const float d = sums[kDt * kLk + tid];
    sDt[tid] = d;
    sA[tid] = d * p.A[h];
    sPre[tid] = sums[kPre * kLk + tid];
    sP16[tid] = sums[kP16 * kLk + tid];
    sQ16[tid] = sums[kQ16 * kLk + tid];
  }
  gs::cp_async_wait<1>();  // C.B^T and x
  __syncthreads();

  // W[i][j] = (C_i . B_j) exp(seg(i, j)) dt_j for j <= i, 0 above, in
  // place: each element is read and written by the thread that owns it
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int q = 0; q <= r; ++q) {
      const int j = tx + 16 * q;
      const float cb = sW[i * kLdX + j];
      float w = 0.f;
      if (q < r) {
        // row prefix in its sub-block + whole sub-blocks between + column
        // suffix in its sub-block
        float seg = sP16[i] + sQ16[j];
#pragma unroll
        for (int k = q + 1; k < r; ++k) seg += sP16[16 * k + 15];
        w = cb * expf(seg) * sDt[j];
      } else if (tx <= ty) {
        float seg = 0.f;  // a over (j, i] inside one sub-block
        for (int k = tx + 1; k <= ty; ++k) seg += sA[16 * r + k];
        w = cb * expf(seg) * sDt[j];
      }
      sW[i * kLdX + j] = w;
    }
  }
  __syncthreads();  // W is complete

  // y[i][p] = sum_{j <= i} W[i][j] x_j[p], p = tx + 16 q: column block jb
  // of W feeds the rows r >= jb only
  float y[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) y[r][q] = 0.f;
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) {
#pragma unroll
    for (int jj = 0; jj < 16; jj += 4) {
      const int j = 16 * jb + jj;
      float4 wv[4];
#pragma unroll
      for (int r = jb; r < 4; ++r) wv[r] = ld4(sW + (ty + 16 * r) * kLdX + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = sX[(j + e) * kLdX + tx + 16 * q];
#pragma unroll
        for (int r = jb; r < 4; ++r) {
          const float we = e == 0 ? wv[r].x
                           : e == 1 ? wv[r].y
                           : e == 2 ? wv[r].z
                                    : wv[r].w;
#pragma unroll
          for (int q = 0; q < 4; ++q) y[r][q] = fmaf(we, xv[q], y[r][q]);
        }
      }
    }
  }

  // the state entering the chunk: y += exp(prefix_i) C_i . state[p]
  gs::cp_async_wait<0>();
  if (has_state) {
    __syncthreads();  // C and the state are complete
    float u[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) u[r][q] = 0.f;
    for (int n = 0; n < n4; n += 4) {
      float4 cv[4], sv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = ld4(sC + (ty + 16 * r) * kLdN + n);
#pragma unroll
      for (int q = 0; q < 4; ++q) sv[q] = ld4(sS + (tx + 16 * q) * kLdN + n);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) u[r][q] = dot4(cv[r], sv[q], u[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = expf(sPre[ty + 16 * r]);
#pragma unroll
      for (int q = 0; q < 4; ++q) y[r][q] = fmaf(e, u[r][q], y[r][q]);
    }
  }

  const float Dh = p.D[h];
  T* yg = static_cast<T*>(p.y) + ((long long)b * p.S * p.H + h) * p.P;
  const long long y_ss = (long long)p.H * p.P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    if (i >= valid) continue;
    T* yrow = yg + (long long)(t0 + i) * y_ss;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pp = tx + 16 * q;
      if (pp < p.P)
        yrow[pp] = gs::from_f32<T>(y[r][q] + sX[i * kLdX + pp] * Dh);
    }
  }
}

constexpr int kCbSmem = (int)sizeof(float) * 2 * kLk * kLdN;
constexpr int kStateSmem = (int)sizeof(float) * (kLk * kLdX + kLk * kLdN + kLk);
constexpr int kScanSmem =
    (int)sizeof(float) * ((kLk + kMaxP) * kLdN + 2 * kLk * kLdX + 5 * kLk);

// 16-byte copies need float32, P and N in 16-byte units, 16-byte aligned
// bases and every stride of x, B and C a multiple of 4 elements.
bool vector_ok(const Params& p, int dtype) {
  const long long strides[] = {p.x_sb, p.x_ss, p.x_sh, p.b_sb, p.b_ss,
                               p.b_sg, p.c_sb, p.c_ss, p.c_sg};
  bool ok = dtype == gs::kFloat32 && p.P % 4 == 0 && p.N % 4 == 0 &&
            gs::aligned16(p.x) && gs::aligned16(p.Bm) && gs::aligned16(p.Cm);
  for (long long s : strides) ok = ok && s % 4 == 0;
  return ok;
}

template <typename T, bool kVec>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err;
  if (p.nc > 0) {
    ssd_chunk_sums<<<dim3(p.nc, p.H, p.Bsz), kLk, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ssd_chunk_cb<T, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kCbSmem);
    if (err != cudaSuccess) return err;
    ssd_chunk_cb<T, kVec>
        <<<dim3(p.nc, p.G, p.Bsz), kThreads, kCbSmem, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ssd_chunk_state<T, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStateSmem);
    if (err != cudaSuccess) return err;
    ssd_chunk_state<T, kVec>
        <<<dim3(p.H, p.nc, p.Bsz), kThreads, kStateSmem, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long PN = (long long)p.P * p.N;
  if (PN % 4 == 0 && (!p.s0 || gs::aligned16(p.s0)) && gs::aligned16(p.sf) &&
      gs::aligned16(p.states)) {
    ssd_state_pass<4><<<dim3((unsigned)((PN / 4 + kThreads - 1) / kThreads),
                             p.H, p.Bsz),
                        kThreads, 0, stream>>>(p);
  } else {
    ssd_state_pass<1><<<dim3((unsigned)((PN + kThreads - 1) / kThreads), p.H,
                             p.Bsz),
                        kThreads, 0, stream>>>(p);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p.nc > 0) {
    err = cudaFuncSetAttribute(ssd_chunk_scan<T, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kScanSmem);
    if (err != cudaSuccess) return err;
    ssd_chunk_scan<T, kVec>
        <<<dim3(p.H, p.nc, p.Bsz), kThreads, kScanSmem, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// The workspaces: `sums` holds B*H*nc*5*64 floats, `cb` B*nc*G*64*64 and
// `states` B*nc*H*P*N, nc = ceil(S / 64) (ops.ssd_scan allocates them).
extern "C" int gs_ssd_scan(
    int dtype, const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* s0, void* y, void* sf,
    void* sums, void* cb, void* states, int Bsz, int S, int H, int G, int P, int N,
    int L, long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
    long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
    long long b_sg, long long c_sb, long long c_ss, long long c_sg,
    void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || L < 1 || G < 1 ||
      H % G != 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != gs::kFloat32 && dtype != gs::kBFloat16)
    return (int)cudaErrorInvalidValue;
  if (Bsz == 0 || H == 0) return (int)cudaSuccess;
  const int nc = (S + kLk - 1) / kLk;
  if (Bsz > 65535 || H > 65535 || G > 65535 || nc > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{x,    static_cast<const float*>(dt),
                 static_cast<const float*>(A),
                 Bm,   Cm,
                 static_cast<const float*>(D),
                 static_cast<const float*>(s0),
                 y,    static_cast<float*>(sf),
                 static_cast<float*>(sums),
                 static_cast<float*>(cb),
                 static_cast<float*>(states),
                 Bsz,  S,    H,    G,    P,    N,    nc,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
                 b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gs::kBFloat16) return (int)launch<__nv_bfloat16, false>(p, st);
  return vector_ok(p, dtype) ? (int)launch<float, true>(p, st)
                             : (int)launch<float, false>(p, st);
}
