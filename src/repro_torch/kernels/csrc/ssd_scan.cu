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
// P=64, N=128, chunk 256) the work is ~8.1 GFLOP (lower-triangle C.B^T and
// W.x, the inter-chunk C.state and the state deposit) against ~59 MB of
// x, y, B, C and states, so operations bound it: 0.12 ms at the 67 TFLOP/s
// float32 rate without tensor cores; the bytes alone take 18 us. This
// first version uses CUDA-core FMAs from shared memory, no tensor cores.
//
// Design: one CTA per (batch, head) walks the chunks in order and keeps
// the (P, N) state in shared memory (32 KB at full width), which replaces
// the Pallas grid's sequential chunk axis. A whole chunk is never held:
// at chunk 256 one head's L x L decay tile alone would be 256 KB. The
// chunk is cut into 64-row sub-tiles; for each row tile i the CTA adds the
// inter-chunk term and then, for each column tile j <= i only, builds
// W = (C_i B_j^T) * exp(acum_i - acum_j) * dt_j in shared memory and
// multiplies it into x_j. The exponential is taken only where row >= col
// (acum_i - acum_j is positive and large above the diagonal), so no inf
// ever meets a 0/1 mask. No decay is formed as a difference of cumsums:
// with A down to -48 a chunk's cumsum reaches -1e4, where one float32 ulp
// is 1e-3, and a difference of two such values loses that much of a
// short segment. Every log-decay is instead a sum of same-sign terms:
// on the diagonal tile a direct running sum along each row, across tiles
// the row's prefix in its tile + the tiles between + the column's suffix
// in its tile, and to the chunk's end a direct suffix sum. B and C are
// read at group h / (H / G) instead of being repeated to every head. Any
// S is taken: positions past S act as dt = 0 (identity steps, no deposit)
// and are not written. Each thread owns a 4 x 4 (or 4 x 8) register tile
// of the products; P <= 64 and N <= 128.

#include "common.cuh"

namespace {

constexpr int kT = 64;          // rows of a sub-tile (i and j)
constexpr int kThreads = 256;   // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

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
  int Bsz, S, H, G, P, N, L;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

size_t smem_floats(int P, int N, int L) {
  const size_t ldN = N + 1, ldP = P + 1;
  return (size_t)P * ldN            // state
         + 2 * (size_t)kT * ldN     // C_i, B_j
         + (size_t)kT * ldP         // x_j
         + (size_t)kT * (kT + 1)    // W
         + 6 * (size_t)L;           // dt, a, prefix/suffix sums
}

// rows [r0, r0 + kT) of a (S, width) stream whose chunk starts at c0,
// converted to float32 into dst (row stride ld); rows past the chunk's
// valid length `valid` are zero.
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* src, long long s_stride,
                          int c0, int r0, int valid, int width) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kT; r += kWarps) {
    const int i = r0 + r;
    const bool in = i < valid;
    const T* row = src + (long long)(c0 + i) * s_stride;
    for (int c = lane; c < width; c += 32)
      dst[r * ld + c] = in ? gs::to_f32(row[c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_fwd(Params p) {
  extern __shared__ float smem[];
  const int P = p.P, N = p.N, L = p.L;
  const int ldN = N + 1, ldP = P + 1, ldW = kT + 1;
  float* sS = smem;                 // P x ldN: state [p][n]
  float* sC = sS + P * ldN;         // kT x ldN: C_i [i][n]
  float* sB = sC + kT * ldN;        // kT x ldN: B_j [j][n]
  float* sX = sB + kT * ldN;        // kT x ldP: x_j [j][p]
  float* sW = sX + kT * ldP;        // kT x ldW: W [i][j]
  float* sDt = sW + kT * ldW;       // L: dt of the chunk
  float* sStep = sDt + L;           // L: a = dt * A, the log-decay of a step
  float* sA = sStep + L;            // L: sum of a over [0, i] (chunk start)
  float* sSuf = sA + L;             // L: sum of a over (j, L) (to the end)
  float* sP = sSuf + L;             // L: sum of a over [tile start, i]
  float* sQ = sP + L;               // L: sum of a over (j, tile end)

  const int b = blockIdx.y, h = blockIdx.x;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float Ah = p.A[h], Dh = p.D[h];

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.b_sb + g * p.b_sg;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.c_sb + g * p.c_sg;
  T* yg = static_cast<T*>(p.y) + ((long long)b * p.S * p.H + h) * P;
  const long long y_ss = (long long)p.H * P;
  const long long st_off = ((long long)b * p.H + h) * P * N;

  for (int i = tid; i < P * N; i += kThreads) {
    const int pp = i / N, n = i - pp * N;
    sS[pp * ldN + n] = p.s0 ? p.s0[st_off + i] : 0.f;
  }

  const int nc = (p.S + L - 1) / L;
  const int nt = (L + kT - 1) / kT;
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * L;
    const int valid = min(L, p.S - c0);  // rows of this chunk inside S
    __syncthreads();  // the previous chunk's readers of sDt/sA are done
    for (int i = tid; i < L; i += kThreads) {
      const float d = i < valid ? dtg[(long long)(c0 + i) * p.dt_ss] : 0.f;
      sDt[i] = d;
      sStep[i] = d * Ah;
    }
    __syncthreads();
    // prefix and suffix sums of same-sign terms, each summed directly
    for (int i = tid; i < L; i += kThreads) {
      const int t0 = i / kT * kT, t1 = min(t0 + kT, L);
      float pre = 0.f, suf = 0.f, tp = 0.f, tq = 0.f;
      for (int k = 0; k <= i; ++k) pre += sStep[k];
      for (int k = i + 1; k < L; ++k) suf += sStep[k];
      for (int k = t0; k <= i; ++k) tp += sStep[k];
      for (int k = i + 1; k < t1; ++k) tq += sStep[k];
      sA[i] = pre;
      sSuf[i] = suf;
      sP[i] = tp;
      sQ[i] = tq;
    }
    __syncthreads();
    const float a_last = sA[L - 1];

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * kT;
      load_rows(sC, ldN, cg, p.c_ss, c0, i0, valid, N);
      __syncthreads();

      // inter-chunk term: exp(acum_i) * C_i . state[p]
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * ldN + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int pp = tx + 16 * q;
          sv[q] = pp < P ? sS[pp * ldN + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cv[r], sv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e = i < L ? expf(sA[i]) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= e;
      }

      // intra-chunk term over column tiles j <= i
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        load_rows(sB, ldN, bg, p.b_ss, c0, j0, valid, N);
        load_rows(sX, ldP, xg, p.x_ss, c0, j0, valid, P);
        if (jt == it) {
          // diagonal tile: sW[r][c] = sum of a over (i0 + c, i0 + r],
          // a running sum along each row, for c <= r
          for (int r = tid; r < kT && i0 + r < L; r += kThreads) {
            float run = 0.f;
            for (int c = r; c >= 0; --c) {
              sW[r * ldW + c] = run;
              run += sStep[i0 + c];
            }
          }
        }
        // across tiles: the sum of a over the whole tiles between j's and i's
        float mid = 0.f;
        for (int t = jt + 1; t < it; ++t) mid += sP[min(t * kT + kT, L) - 1];
        __syncthreads();
        float w[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) w[r][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * ldN + n];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = sB[(tx + 16 * q) * ldN + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) w[r][q] = fmaf(cv[r], bv[q], w[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tx + 16 * q;
            float v = 0.f;
            if (i >= j && i < L && j < L) {  // exp only on and below the diagonal
              const float seg = jt == it ? sW[(ty + 16 * r) * ldW + tx + 16 * q]
                                         : sP[i] + mid + sQ[j];
              v = w[r][q] * expf(seg) * sDt[j];
            }
            sW[(ty + 16 * r) * ldW + tx + 16 * q] = v;  // same thread read it
          }
        }
        __syncthreads();
        for (int j = 0; j < kT; ++j) {
          float wv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) wv[r] = sW[(ty + 16 * r) * ldW + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int pp = tx + 16 * q;
            xv[q] = pp < P ? sX[j * ldP + pp] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(wv[r], xv[q], acc[r][q]);
        }
        __syncthreads();  // sB, sX and sW are free for the next tile
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= valid) continue;
        const T* xrow = xg + (long long)(c0 + i) * p.x_ss;
        T* yrow = yg + (long long)(c0 + i) * y_ss;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int pp = tx + 16 * q;
          if (pp < P)
            yrow[pp] = gs::from_f32<T>(acc[r][q] + gs::to_f32(xrow[pp]) * Dh);
        }
      }
    }

    // state update: state * exp(acum_last) + sum_j dt_j exp(acum_last -
    // acum_j) x_j B_j^T, thread tile p = ty + 16 r, n = tx + 16 q
    float st[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int pp = ty + 16 * r;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tx + 16 * q;
        st[r][q] = (pp < P && n < N) ? sS[pp * ldN + n] * expf(a_last) : 0.f;
      }
    }
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * kT;
      load_rows(sB, ldN, bg, p.b_ss, c0, j0, valid, N);
      load_rows(sX, ldP, xg, p.x_ss, c0, j0, valid, P);
      __syncthreads();
      for (int i = tid; i < kT * P; i += kThreads) {
        const int j = i / P, pp = i - j * P;
        const int jj = j0 + j;
        sX[j * ldP + pp] *= jj < L ? sDt[jj] * expf(sSuf[jj]) : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < kT; ++j) {
        float xv[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int pp = ty + 16 * r;
          xv[r] = pp < P ? sX[j * ldP + pp] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int n = tx + 16 * q;
          bv[q] = n < N ? sB[j * ldN + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) st[r][q] = fmaf(xv[r], bv[q], st[r][q]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int pp = ty + 16 * r;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tx + 16 * q;
        if (pp < P && n < N) sS[pp * ldN + n] = st[r][q];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int pp = i / N, n = i - pp * N;
    p.sf[st_off + i] = sS[pp * ldN + n];
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.P, p.N, p.L);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.Bsz);
  ssd_fwd<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gs_ssd_scan(
    int dtype, const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* s0, void* y, void* sf, int Bsz,
    int S, int H, int G, int P, int N, int L, long long x_sb, long long x_ss,
    long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg, long long c_sb,
    long long c_ss, long long c_sg, void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || L < 1 || G < 1 ||
      H % G != 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  if (Bsz == 0 || H == 0) return (int)cudaSuccess;
  const Params p{x,    static_cast<const float*>(dt),
                 static_cast<const float*>(A),
                 Bm,   Cm,
                 static_cast<const float*>(D),
                 static_cast<const float*>(s0),
                 y,    static_cast<float*>(sf),
                 Bsz,  S,    H,    G,    P,    N,    L,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
                 b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
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
