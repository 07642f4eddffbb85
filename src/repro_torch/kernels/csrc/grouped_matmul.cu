// Grouped (per-expert) matmul: (E, C, d) @ (E, d, f) -> (E, C, f).
//
// Replaces the Pallas TPU kernel `_gmm_kernel` / `grouped_matmul` in
// src/repro/kernels/moe_matmul.py. Same function: x and w in float32 or
// bfloat16 (both of one type), float32 accumulation, the output in x's
// type. The MoE expert FF calls it three times per layer (gate, up, down)
// on the capacity layout (E, G*C, d).
//
// What bounds it on an H100: the expert weights. At qwen3-moe-30b-a3b's
// prefill, (128, 160, 2048) @ (128, 2048, 768) in bfloat16, they are
// 403 MB: with x and the output 518 MB, 0.155 ms at 3.35 TB/s, against
// 0.065 ms for the 64.4 GFLOP at the 989 TFLOP/s bfloat16 tensor-core
// rate. At decode, (128, 8, 2048) @ (128, 2048, 768), the weights are the
// whole cost: 408 MB, 0.122 ms. Both phases are a weight stream.
//
// bfloat16 design (tensor cores, asynchronous copies). The kernel computes
// the transposed product out^T (f x C) = W^T (f x d) . x^T (d x C): f fills
// the MMA's 16-row M tiles and C is its N dimension in steps of 8, so a
// decode step (C = 8) multiplies no empty rows and one design serves both
// phases. A CTA owns a BM (f) x BN (C) tile of one expert and walks d in
// 32-deep steps through a 4-stage ring of shared-memory tiles filled by
// 16-byte cp.async copies (zero-filled past the ragged edges), so three
// steps of W and x are in flight while one is multiplied; each thread
// copies one fixed 16-byte column down the tile's rows. W is (d, f) with
// f contiguous, so its tile is read as the A operand with ldmatrix.trans;
// x's rows are K-major, the B operand as ldmatrix reads it. Rows are padded
// by 16 bytes so that ldmatrix's eight row reads fall in distinct banks.
// Each warp runs mma.sync m16n8k16 (bfloat16 in, float32 accumulate) on a
// (16 MT) x (8 NTW) register tile. The epilogue writes the tile through
// shared memory, transposed back to (C, f), as 16-byte row stores. The
// tile follows C: BN = 8, 16, 32 or 64 on four warps of 16 rows each
// (BM = 64: decode is 128 x 12 CTAs), and BM = 128 with BN = 128, 160 or
// 256 on eight warps for prefill, so one CTA covers all of C = 160 and W
// is streamed once; C > 256 is tiled over the grid's y. The 8-warp tiles
// up to BN = 160 hold at most 128 registers a thread, so two CTAs share
// an SM (one alone stalled at every step's barrier: 0.36 ms at prefill).
// mma.sync rather than wgmma: the work is bytes-bound at both shapes, where
// mma.sync's rate (about half of wgmma's) is not the limit, and its
// per-warp 16 x 8 tiles give decode's C = 8 and every ragged edge one code
// path. Shapes whose rows are not 16-byte multiples (d or f not a multiple
// of 8, or a misaligned base) take the same MMA path with element-wise
// tile loads and stores. Measured: prefill gate/up 0.242 ms against
// torch.bmm's 0.190 ms and a 0.155 ms bound (4.26 ms before); decode
// gate/up 0.164 ms against 0.145 ms and a 0.122 ms bound (0.777 ms before).
// By count, the 32 x 80 warp tiles of prefill read about three times as
// many shared-memory bytes (ldmatrix) as the copies write: the likely
// remaining gap to the bound (not measured).
//
// float32 design (unchanged): no served full-width path runs it (qwen3's
// launcher refuses float32), so it stays the SIMT kernel: one CTA per
// (expert, BM-row tile, 64-column tile), float32 FMAs from shared memory.
// Times: chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).

#include "tensor_core.cuh"

namespace {

struct Params {
  const void* x;
  const void* w;
  void* o;
  int E, C, d, f;
};

// ---------------------------------------------------------------- float32

constexpr int kBN = 64;   // output columns per CTA
constexpr int kBK = 32;   // contraction depth per step
constexpr int kThreads = 256;

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

cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const unsigned cols = (p.f + kBN - 1) / kBN;
  if (p.C <= 16) {
    gmm_fwd<float, 16><<<dim3(cols, (p.C + 15) / 16, p.E), kThreads, 0,
                         stream>>>(p);
  } else {
    gmm_fwd<float, 64><<<dim3(cols, (p.C + 63) / 64, p.E), kThreads, 0,
                         stream>>>(p);
  }
  return cudaGetLastError();
}

// --------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

constexpr int kTcBK = 32;          // contraction depth per stage
constexpr int kStages = 4;         // cp.async ring depth
constexpr int kXLd = kTcBK + 8;    // x tile row stride (elements), 80 B

// WM x WN warps, each owning a (16 MT) x (8 NTW) tile of out^T.
template <int WM, int WN, int MT, int NTW>
struct TcTile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int BM = 16 * MT * WM;  // rows of out^T (f) per CTA
  static constexpr int BN = 8 * NTW * WN;  // columns of out^T (C) per CTA
  static constexpr int kWLd = BM + 8;      // W tile row stride (elements)
  static constexpr int kStage = kTcBK * kWLd + BN * kXLd;  // elements
  static constexpr int kOutLd = BM + 8;    // epilogue tile [BN][kOutLd]
  static constexpr int kSmem = kStages * kStage * 2;       // bytes
  // Two CTAs per SM where the accumulators leave room (<= 128 registers
  // a thread at eight warps): one 8-warp CTA alone stalls at every step's
  // barrier.
  static constexpr int kMinBlocks = MT * NTW * 4 <= 80 ? 2 : 1;
  static_assert(BN * kOutLd <= kStages * kStage, "epilogue tile fits");
};

template <int WM, int WN, int MT, int NTW, bool kVec>
__global__ void __launch_bounds__(32 * WM * WN,
                                  (TcTile<WM, WN, MT, NTW>::kMinBlocks))
    gmm_bf16_tc(Params p) {
  using Tile = TcTile<WM, WN, MT, NTW>;
  constexpr int BM = Tile::BM, BN = Tile::BN, kWLd = Tile::kWLd;
  constexpr int NT = Tile::kThreads;
  bf16* smem = gs::dynamic_smem<bf16>();

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM;  // first f of the tile
  const int n0 = blockIdx.y * BN;  // first row of x (C) of the tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const bf16* x = static_cast<const bf16*>(p.x) + (long long)e * p.C * p.d;
  const bf16* w = static_cast<const bf16*>(p.w) + (long long)e * p.d * p.f;
  const int n_k = (p.d + kTcBK - 1) / kTcBK;
  const bf16 zero = __float2bfloat16(0.f);

  // Stage s: W tile [kTcBK][kWLd] (k rows, f contiguous), then the x tile
  // [BN][kXLd] (C rows, k contiguous).
  auto load_stage = [&](int s, int kt) {
    bf16* dw = smem + s * Tile::kStage;
    bf16* dx = dw + kTcBK * kWLd;
    const int k0 = kt * kTcBK;
    if constexpr (kVec) {
      // Each thread keeps one 16-byte column of each tile and steps a
      // pointer down its rows (NT is a multiple of both chunk counts).
      constexpr int kWChunks = BM / 8, kWStep = NT / kWChunks;
      constexpr int kXChunks = kTcBK / 8, kXStep = NT / kXChunks;
      const int wc = (tid % kWChunks) * 8, wr = tid / kWChunks;
      const bool wc_in = m0 + wc < p.f;
      const bf16* gw = w + (long long)(k0 + wr) * p.f + m0 + wc;
#pragma unroll
      for (int r = wr; r < kTcBK; r += kWStep, gw += kWStep * (long long)p.f) {
        const bool in = wc_in && k0 + r < p.d;
        gs::cp_async_16(dw + r * kWLd + wc, in ? gw : w, in ? 16 : 0);
      }
      const int xc = (tid % kXChunks) * 8, xr = tid / kXChunks;
      const bool xc_in = k0 + xc < p.d;
      const bf16* gx = x + (long long)(n0 + xr) * p.d + k0 + xc;
#pragma unroll
      for (int r = xr; r < BN; r += kXStep, gx += kXStep * (long long)p.d) {
        const bool in = xc_in && n0 + r < p.C;
        gs::cp_async_16(dx + r * kXLd + xc, in ? gx : x, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kTcBK * BM; i += NT) {
        const int r = i / BM, c = i % BM;
        const int gk = k0 + r, gc = m0 + c;
        dw[r * kWLd + c] =
            (gk < p.d && gc < p.f) ? w[(long long)gk * p.f + gc] : zero;
      }
      for (int i = tid; i < BN * kTcBK; i += NT) {
        const int r = i / kTcBK, c = i % kTcBK;
        const int gn = n0 + r, gk = k0 + c;
        dx[r * kXLd + c] =
            (gn < p.C && gk < p.d) ? x[(long long)gn * p.d + gk] : zero;
      }
    }
  };

  float acc[MT][NTW][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    gs::cp_async_commit();
  }

  // ldmatrix row addresses of this lane (see tensor_core.cuh's layouts):
  // A = W^T from the [k][f] tile with .trans, B = x^T from the [C][k] tile.
  const int a_k = (lane & 7) + ((lane >> 4) << 3);
  const int a_m = wm * 16 * MT + ((lane >> 3) & 1) * 8;
  const int b_n = wn * 8 * NTW + (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) * 8;

  for (int kt = 0; kt < n_k; ++kt) {
    gs::cp_async_wait<kStages - 2>();  // step kt has landed
    __syncthreads();  // ... for every thread; step kt-1's stage is free
    const int next = kt + kStages - 1;
    if (next < n_k) load_stage(next % kStages, next);
    gs::cp_async_commit();

    const bf16* sw = smem + (kt % kStages) * Tile::kStage;
    const bf16* sx = sw + kTcBK * kWLd;
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        gs::ldmatrix_x4_trans(a[i], sw + (kk + a_k) * kWLd + a_m + 16 * i);
      // B fragments two n tiles at a time, used at once: few live registers.
#pragma unroll
      for (int j = 0; j + 1 < NTW; j += 2) {
        uint32_t r[4];
        gs::ldmatrix_x4(r, sx + (b_n + 8 * j) * kXLd + kk + b_k);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          gs::mma_bf16_16816(acc[i][j], a[i], b0);
          gs::mma_bf16_16816(acc[i][j + 1], a[i], b1);
        }
      }
      if constexpr (NTW % 2 == 1) {
        uint32_t b[2];  // lanes 0..15 address the last n tile's rows
        gs::ldmatrix_x2(
            b, sx + (wn * 8 * NTW + 8 * (NTW - 1) + (lane & 7)) * kXLd + kk +
                   b_k);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          gs::mma_bf16_16816(acc[i][NTW - 1], a[i], b);
      }
    }
  }
  gs::cp_async_wait<0>();
  __syncthreads();  // the ring is idle: reuse it for the output tile

  // out^T fragment -> sO[c][f] (rows of the (C, f) output), then 16-byte
  // row stores.
  bf16* sO = smem;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int m = wm * 16 * MT + 16 * i + g;
      const int n = wn * 8 * NTW + 8 * j + t2;
      sO[n * Tile::kOutLd + m] = __float2bfloat16(acc[i][j][0]);
      sO[(n + 1) * Tile::kOutLd + m] = __float2bfloat16(acc[i][j][1]);
      sO[n * Tile::kOutLd + m + 8] = __float2bfloat16(acc[i][j][2]);
      sO[(n + 1) * Tile::kOutLd + m + 8] = __float2bfloat16(acc[i][j][3]);
    }
  __syncthreads();
  bf16* o = static_cast<bf16*>(p.o) + (long long)e * p.C * p.f;
  if constexpr (kVec) {
    constexpr int kChunks = BM / 8;
    for (int i = tid; i < BN * kChunks; i += NT) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const int gn = n0 + r, gc = m0 + c;
      if (gn < p.C && gc < p.f)
        *reinterpret_cast<uint4*>(o + (long long)gn * p.f + gc) =
            *reinterpret_cast<const uint4*>(sO + r * Tile::kOutLd + c);
    }
  } else {
    for (int i = tid; i < BN * BM; i += NT) {
      const int r = i / BM, c = i % BM;
      const int gn = n0 + r, gc = m0 + c;
      if (gn < p.C && gc < p.f)
        o[(long long)gn * p.f + gc] = sO[r * Tile::kOutLd + c];
    }
  }
}

template <int WM, int WN, int MT, int NTW, bool kVec>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  using Tile = TcTile<WM, WN, MT, NTW>;
  auto kernel = gmm_bf16_tc<WM, WN, MT, NTW, kVec>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
  if (err != cudaSuccess) return err;
  const unsigned n_tiles = (p.C + Tile::BN - 1) / Tile::BN;
  if (n_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((p.f + Tile::BM - 1) / Tile::BM, n_tiles, p.E);
  kernel<<<grid, Tile::kThreads, Tile::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// The tile follows C (the N dimension of out^T), see the header note.
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const bool vec = p.d % 8 == 0 && p.f % 8 == 0 && gs::aligned16(p.x) &&
                   gs::aligned16(p.w) && gs::aligned16(p.o);
  if (!vec) return launch_tc<4, 1, 1, 4, false>(p, stream);
  if (p.C <= 8) return launch_tc<4, 1, 1, 1, true>(p, stream);
  if (p.C <= 16) return launch_tc<4, 1, 1, 2, true>(p, stream);
  if (p.C <= 32) return launch_tc<4, 1, 1, 4, true>(p, stream);
  if (p.C <= 64) return launch_tc<4, 1, 1, 8, true>(p, stream);
  if (p.C <= 128) return launch_tc<4, 2, 2, 8, true>(p, stream);
  if (p.C <= 160) return launch_tc<4, 2, 2, 10, true>(p, stream);
  return launch_tc<4, 2, 2, 16, true>(p, stream);
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
      return (int)launch_f32(p, st);
    case gs::kBFloat16:
      return (int)launch_bf16(p, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
