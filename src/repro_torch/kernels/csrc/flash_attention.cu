// Causal GQA flash attention with an optional sliding window, forward only.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py. Same function: q (B,Sq,H,D), k/v
// (B,Sk,Hkv,D) -> o (B,Sq,H,D) in q's type; query head h reads kv head
// h / (H/Hkv); key k is visible to query q when k <= q (causal) and
// k > q - window (window > 0); online softmax with float32 running max,
// denominator and accumulator; masked scores are -1e30 and a row that sees
// no key writes 0, as the Pallas kernel does. Any D <= 128 and any S.
//
// What bounds it on an H100: at qwen3-moe's prefill shape, q (4,512,32,128)
// and k/v (4,512,4,128) causal in bfloat16, 8.6 GFLOP against 37.7 MB of
// q/k/v/o: bytes bound it (11.3 us at 3.35 TB/s; the operations take 8.7 us
// at the 989 TFLOP/s bfloat16 tensor-core rate). At danube's float32 shape,
// q (4,512,32,80), k/v (4,512,8,80), the 5.4 GFLOP take 80 us at the
// 67 TFLOP/s float32 rate without tensor cores (TF32 stays off for parity).
//
// Both designs: one CTA per (64-row q tile, q head, batch) loops over key
// tiles itself (the Pallas grid's sequential key axis) and skips tiles
// wholly above the diagonal or wholly before the window. The q tiles are
// launched heaviest first (blockIdx.z counts down from the last tile of a
// causal row, which sees the most keys), so short tiles fill the grid's
// tail. K/V tiles stream through a two-stage ring of 16-byte cp.async
// copies (zero-filled past S and past D): tile t + 1 loads during all of
// tile t's math. q/k/v/o are read and written through their (B,S,H)
// strides, no transposes; rows that are not 16-byte multiples (or
// misaligned bases) take element-wise tile loads and stores instead.
//
// bfloat16: tensor cores. Four warps each own 16 query rows; key tiles are
// 32 wide. S = Q K^T runs on mma.sync m16n8k16 (bfloat16 in, float32
// accumulate) with Q and K read by ldmatrix; the online softmax stays in
// the S registers (row max and sum over the four lanes of a row by two
// shuffles, ex2 of log2-scaled scores); P is rounded to bfloat16 and fed
// from those registers as the A operand of P V, with V read by
// ldmatrix.trans. D is padded in shared memory to the next multiple of 16
// with zero columns (D = 80 runs 5 MMA k-steps; no swizzle width is
// involved: rows are padded by 16 bytes, so ldmatrix's eight row reads
// fall in distinct banks), and padded output columns are never stored. A
// warp skips a key tile that none of its 16 rows can see (the diagonal's
// upper half). The output goes through the warp's own rows of the Q tile
// and leaves as 16-byte row stores. 35 KB of shared memory and at most 128
// registers give four CTAs (16 warps) per SM. On the card, at qwen3's
// shape, the time followed the warps in flight and the work of issuing
// the copies more than the MMA rate: 32-row warps, which halve the
// shared-memory reads but also the warps, were slower. So each thread
// copies one fixed 16-byte column down the tile's rows (no division per
// chunk), and the design stays on mma.sync: its 16-row warps keep their
// softmax state private, and one template per padded width covers
// D = 16..128. Measured: 0.058 ms against SDPA's 0.038 ms (1.62 ms
// before).
//
// float32: CUDA cores (no tensor cores: TF32 would break parity). 256
// threads as 16 x 16, 64-key tiles; each thread owns a 4 x 4 tile of S
// (rows ty + 16 i, keys tx + 16 j), formed from 16-byte shared-memory loads
// along D (4 of Q, broadcast within a quarter-warp, and 4 of K per 64
// FMAs); a 16-lane shuffle reduces each row's max and sum, P goes through
// shared memory, and each thread accumulates 4 rows x up to 8 columns of O
// from 16-byte loads of P and V. Rows are padded to an odd number of
// 16-byte units, so the eight rows of a quarter-warp's 16-byte loads fall
// in distinct banks. Measured at danube's shape: 0.35-0.37 ms against
// SDPA's float32 0.89 ms (1.19 ms before).
// Times: chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).

#include "tensor_core.cuh"

namespace {

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// The CTA's BQ-row q tile, heaviest first, and the BK-key tiles
// [t_begin, t_end) any of its rows can see.
struct TileRange {
  int q0, t_begin, t_end;
};

template <int BQ, int BK>
__device__ __forceinline__ TileRange tile_range(const Params& p) {
  TileRange r;
  r.q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int q_last = min(r.q0 + BQ, p.Sq) - 1;
  const int k_begin = p.window > 0 ? max(0, r.q0 - p.window + 1) : 0;
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  r.t_begin = k_begin / BK;
  r.t_end = (k_end + BK - 1) / BK;
  return r;
}

// True when every (query, key) pair of q tile q0 x key tile k0 is visible
// and in range, so the tile needs no mask.
template <int BQ, int BK>
__device__ __forceinline__ bool tile_full(const Params& p, int q0, int k0) {
  return k0 + BK <= p.Sk && q0 + BQ <= p.Sq &&
         (!p.causal || k0 + BK - 1 <= q0) &&
         (p.window <= 0 || k0 > q0 + BQ - 1 - p.window);
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// Copy ROWS rows x `cols` elements (rows [row0, row0 + ROWS) of a tensor
// with row stride `ld_g`, `n_rows` rows and `D` columns) into a shared tile
// of row stride `ld_s`, zero past the rows and past D, with NT threads.
// kVec: 16-byte cp.async (D and the strides are multiples of 16 bytes);
// else element-wise. COLS > 0 fixes `cols` at compile time; where the NT
// threads split evenly over a row's 16-byte chunks, each thread keeps one
// column and steps a pointer down the rows (no division, one add a chunk).
template <typename T, bool kVec, int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile(T* dst, int ld_s, const T* src,
                                          long long ld_g, int row0,
                                          int n_rows, int D, int cols,
                                          int tid) {
  constexpr int kPer = 16 / sizeof(T);
  if constexpr (kVec && COLS > 0 && NT % (COLS / kPer) == 0) {
    constexpr int kCh = COLS / kPer, kStep = NT / kCh;
    const int c = (tid % kCh) * kPer, r0 = tid / kCh;
    const bool col_in = c < D;
    const T* g = src + (row0 + r0) * ld_g + c;
#pragma unroll
    for (int r = r0; r < ROWS; r += kStep, g += kStep * ld_g) {
      const bool in = col_in && row0 + r < n_rows;
      gs::cp_async_16(dst + r * ld_s + c, in ? g : src, in ? 16 : 0);
    }
  } else if constexpr (kVec) {
    const int chunks = (COLS > 0 ? COLS : cols) / kPer;
    for (int i = tid; i < ROWS * chunks; i += NT) {
      const int r = i / chunks, c = (i - r * chunks) * kPer;
      const int s = row0 + r;
      const bool in = s < n_rows && c < D;
      gs::cp_async_16(dst + r * ld_s + c, in ? src + s * ld_g + c : src,
                      in ? 16 : 0);
    }
  } else {
    const int n_cols = COLS > 0 ? COLS : cols;
    for (int i = tid; i < ROWS * n_cols; i += NT) {
      const int r = i / n_cols, c = i - r * n_cols;
      const int s = row0 + r;
      dst[r * ld_s + c] = (s < n_rows && c < D)
                              ? src[s * ld_g + c]
                              : gs::from_f32<T>(0.f);
    }
  }
}

// ---------------------------------------------------- bfloat16, tensor cores

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // 4 warps x 16 query rows
constexpr int kTcBQ = 64;        // query rows per CTA
constexpr int kTcBK = 32;        // keys per tile

template <int DP>  // D padded to a multiple of 16
struct TcSmem {
  static constexpr int kLd = DP + 8;  // row stride (elements): 16 B of pad
  static constexpr int kKV = kTcBK * kLd;  // one K or V tile (elements)
  static constexpr int kBytes = (kTcBQ * kLd + 4 * kKV) * 2;  // Q, 2 x (K, V)
};

// Four CTAs (16 warps) per SM: 35 KB of shared memory and at most 128
// registers a thread at D = 128. The kernel waits on memory more than it
// computes, so warps in flight and a whole tile of prefetch matter most.
template <int DP, bool kVec>
__global__ void __launch_bounds__(kTcThreads, 4) flash_fwd_bf16(Params p) {
  using S = TcSmem<DP>;
  constexpr int kLd = S::kLd;
  constexpr int kNT = DP / 8;  // n8 tiles of the output
  bf16* sQ = gs::dynamic_smem<bf16>();
  bf16* sK = sQ + kTcBQ * kLd;  // 2 stages
  bf16* sV = sK + 2 * S::kKV;   // 2 stages

  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.H / p.Hkv);
  const TileRange tr = tile_range<kTcBQ, kTcBK>(p);
  const int q0 = tr.q0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  auto load_kv = [&](int stage, int t) {
    load_tile<bf16, kVec, kTcBK, DP, kTcThreads>(
        sK + stage * S::kKV, kLd, k, p.k_ss, t * kTcBK, p.Sk, p.D, DP, tid);
    load_tile<bf16, kVec, kTcBK, DP, kTcThreads>(
        sV + stage * S::kKV, kLd, v, p.v_ss, t * kTcBK, p.Sk, p.D, DP, tid);
  };
  if (tr.t_begin < tr.t_end) {
    load_tile<bf16, kVec, kTcBQ, DP, kTcThreads>(sQ, kLd, q, p.q_ss, q0, p.Sq,
                                                 p.D, DP, tid);
    load_kv(0, tr.t_begin);
  }
  gs::cp_async_commit();

  // This thread's rows: g and g + 8 of its warp's 16.
  const int row_g = q0 + warp * 16 + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  const float scale2 = p.scale * kLog2e;  // scores in log2 units
  float o_acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o_acc[j][r] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_part[2] = {0.f, 0.f};  // this lane's share of the row sums

  // ldmatrix row addresses of this lane (tensor_core.cuh's layouts), as
  // 32-bit shared-window addresses: fewer registers than generic pointers.
  const uint32_t q_frag =
      gs::smem_addr(sQ + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             kLd + (lane >> 4) * 8);
  const uint32_t k_frag = gs::smem_addr(
      sK + ((lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8);
  const uint32_t v_frag = gs::smem_addr(
      sV + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8);

  // Two-stage K/V ring: tile t + 1 loads during all of tile t's math.
  for (int t = tr.t_begin; t < tr.t_end; ++t) {
    const int st = (t - tr.t_begin) & 1;
    gs::cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < tr.t_end) load_kv(st ^ 1, t + 1);
    gs::cp_async_commit();
    const uint32_t k_st = k_frag + st * S::kKV * 2;  // bytes
    const uint32_t v_st = v_frag + st * S::kKV * 2;
    const int k0 = t * kTcBK;
    // A warp whose 16 rows see none of the tile's keys (above the diagonal,
    // before the window) skips it: p = 0 would leave its state unchanged.
    const int w0 = q0 + warp * 16;
    if ((p.causal && k0 > w0 + 15) ||
        (p.window > 0 && k0 + kTcBK - 1 <= w0 - p.window))
      continue;

    // S = Q K^T for this warp's 16 rows x kTcBK keys.
    constexpr int kSN = kTcBK / 8;  // n8 tiles of S
    float s[kSN][4];
#pragma unroll
    for (int j = 0; j < kSN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4];
      gs::ldmatrix_x4(a, q_frag + kk * 2);
#pragma unroll
      for (int j = 0; j < kSN; j += 2) {
        uint32_t r[4];
        gs::ldmatrix_x4(r, k_st + (8 * j * kLd + kk) * 2);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        gs::mma_bf16_16816(s[j], a, b0);
        gs::mma_bf16_16816(s[j + 1], a, b1);
      }
    }

    // Scale (log2 units) and mask; register r of n-tile j is row
    // row_g + 8 * (r / 2), key k0 + 8 j + col_t + r % 2.
    const bool full = tile_full<kTcBQ, kTcBK>(p, q0, k0);
#pragma unroll
    for (int j = 0; j < kSN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool ok = full || visible(p, row_g + 8 * (r >> 1),
                                        k0 + 8 * j + col_t + (r & 1));
        s[j][r] = ok ? s[j][r] * scale2 : kNegInf;
      }

    // Online softmax: row max over the tile (the 4 lanes of a row), then
    // rescale the running sum and output.
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = m_run[hr];
#pragma unroll
      for (int j = 0; j < kSN; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[hr] = gs::fast_exp2(m_run[hr] - mx);
      m_run[hr] = mx;
      l_part[hr] *= alpha[hr];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      o_acc[j][0] *= alpha[0];
      o_acc[j][1] *= alpha[0];
      o_acc[j][2] *= alpha[1];
      o_acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < kSN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pr = s[j][r] == kNegInf
                             ? 0.f
                             : gs::fast_exp2(s[j][r] - m_run[r >> 1]);
        s[j][r] = pr;
        l_part[r >> 1] += pr;
      }

    // O += P V: P from registers (bfloat16), V by ldmatrix.trans.
#pragma unroll
    for (int kt = 0; kt < kTcBK / 16; ++kt) {
      const uint32_t a[4] = {
          gs::pack_bf16x2(s[2 * kt][0], s[2 * kt][1]),
          gs::pack_bf16x2(s[2 * kt][2], s[2 * kt][3]),
          gs::pack_bf16x2(s[2 * kt + 1][0], s[2 * kt + 1][1]),
          gs::pack_bf16x2(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t r[4];
        gs::ldmatrix_x4_trans(r, v_st + (16 * kt * kLd + 8 * j) * 2);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        gs::mma_bf16_16816(o_acc[j], a, b0);
        gs::mma_bf16_16816(o_acc[j + 1], a, b1);
      }
    }
  }
  gs::cp_async_wait<0>();

  // O / l through this warp's own 16 rows of the Q tile (no other warp
  // reads them), then 16-byte row stores.
  bf16* so = sQ + warp * 16 * kLd;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_part[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int r = (lane >> 2) + 8 * hr;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      *reinterpret_cast<uint32_t*>(so + r * kLd + 8 * j + col_t) =
          gs::pack_bf16x2(o_acc[j][2 * hr] * inv, o_acc[j][2 * hr + 1] * inv);
  }
  __syncwarp();
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  if constexpr (kVec) {
    constexpr int kChunks = DP / 8;
    for (int i = lane; i < 16 * kChunks; i += 32) {
      const int r = i / kChunks, c = (i - r * kChunks) * 8;
      const int qpos = q0 + warp * 16 + r;
      if (qpos < p.Sq && c < p.D)
        *reinterpret_cast<uint4*>(o + qpos * p.o_ss + c) =
            *reinterpret_cast<const uint4*>(so + r * kLd + c);
    }
  } else {
    for (int i = lane; i < 16 * p.D; i += 32) {
      const int r = i / p.D, c = i - r * p.D;
      const int qpos = q0 + warp * 16 + r;
      if (qpos < p.Sq) o[qpos * p.o_ss + c] = so[r * kLd + c];
    }
  }
}

template <int DP>
cudaError_t launch_bf16_dp(const Params& p, bool vec, cudaStream_t stream) {
  const int n_q = (p.Sq + kTcBQ - 1) / kTcBQ;
  if (n_q > 65535) return cudaErrorInvalidValue;
  auto kernel = vec ? flash_fwd_bf16<DP, true> : flash_fwd_bf16<DP, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TcSmem<DP>::kBytes);
  if (err != cudaSuccess) return err;
  // blockIdx.z runs the q tiles, heaviest first
  kernel<<<dim3(p.H, p.B, n_q), kTcThreads, TcSmem<DP>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// -------------------------------------------------------- float32, CUDA cores

constexpr int kF32Threads = 256;  // 16 x 16
constexpr int kBQ = 64;           // query rows per CTA
constexpr int kBK = 64;           // keys per tile

// Row stride (floats) of the float32 tiles: D rounded up to 4, then to an
// odd number of 16-byte units.
__host__ __device__ __forceinline__ int f32_ld(int D) {
  return 4 * ((((D + 3) / 4)) | 1);
}
constexpr int kPLd = kBK + 4;  // P tile row stride (floats)

int f32_smem_bytes(int D) {
  return (int)sizeof(float) * (5 * kBQ * f32_ld(D) + kBQ * kPLd);
}

template <bool kVec>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32(Params p) {
  const int ld = f32_ld(p.D);
  const int d4 = (p.D + 3) / 4;  // 16-byte column chunks
  float* sQ = gs::dynamic_smem<float>();
  float* sK = sQ + kBQ * ld;       // 2 stages
  float* sV = sK + 2 * kBK * ld;   // 2 stages
  float* sP = sV + 2 * kBK * ld;   // kBQ x kPLd

  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.H / p.Hkv);
  const TileRange tr = tile_range<kBQ, kBK>(p);
  const int q0 = tr.q0;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  auto load_kv = [&](int stage, int t) {
    load_tile<float, kVec, kBK, 0, kF32Threads>(
        sK + stage * kBK * ld, ld, k, p.k_ss, t * kBK, p.Sk, p.D, 4 * d4, tid);
    load_tile<float, kVec, kBK, 0, kF32Threads>(
        sV + stage * kBK * ld, ld, v, p.v_ss, t * kBK, p.Sk, p.D, 4 * d4, tid);
  };
  if (tr.t_begin < tr.t_end) {
    load_tile<float, kVec, kBQ, 0, kF32Threads>(sQ, ld, q, p.q_ss, q0, p.Sq,
                                                p.D, 4 * d4, tid);
    load_kv(0, tr.t_begin);
  }
  gs::cp_async_commit();

  float m_run[4], l_part[4], acc[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_part[i] = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][u][c] = 0.f;
  }

  for (int t = tr.t_begin; t < tr.t_end; ++t) {
    const int st = (t - tr.t_begin) & 1;
    gs::cp_async_wait<0>();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1
    if (t + 1 < tr.t_end) load_kv(st ^ 1, t + 1);
    gs::cp_async_commit();
    const float* sk = sK + st * kBK * ld;
    const float* sv = sV + st * kBK * ld;

    // S tile: rows ty + 16 i, keys tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d4; ++c) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * ld +
                                                 4 * c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * ld +
                                                 4 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    const int k0 = t * kBK;
    const bool full = tile_full<kBQ, kBK>(p, q0, k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = m_run[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = full || visible(p, qpos, k0 + tx + 16 * j);
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m_run[i] - mx);
      m_run[i] = mx;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = s[i][j] == kNegInf ? 0.f : expf(s[i][j] - mx);
        psum += pr;
        sP[(ty + 16 * i) * kPLd + tx + 16 * j] = pr;
      }
      l_part[i] = alpha * l_part[i] + psum;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][u][c] *= alpha;
    }
    __syncthreads();  // P is visible

    // O tile: rows ty + 16 i, 16-byte column chunks tx and tx + 16.
    const bool has0 = tx < d4, has1 = tx + 16 < d4;
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] =
            *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * kPLd + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = sv + (kk + e) * ld;
        const float4 v0 = has0
            ? *reinterpret_cast<const float4*>(vrow + 4 * tx)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 v1 = has1
            ? *reinterpret_cast<const float4*>(vrow + 4 * (tx + 16))
            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = e == 0 ? pv[i].x
                           : e == 1 ? pv[i].y
                           : e == 2 ? pv[i].z
                                    : pv[i].w;
          acc[i][0][0] = fmaf(pe, v0.x, acc[i][0][0]);
          acc[i][0][1] = fmaf(pe, v0.y, acc[i][0][1]);
          acc[i][0][2] = fmaf(pe, v0.z, acc[i][0][2]);
          acc[i][0][3] = fmaf(pe, v0.w, acc[i][0][3]);
          acc[i][1][0] = fmaf(pe, v1.x, acc[i][1][0]);
          acc[i][1][1] = fmaf(pe, v1.y, acc[i][1][1]);
          acc[i][1][2] = fmaf(pe, v1.z, acc[i][1][2]);
          acc[i][1][3] = fmaf(pe, v1.w, acc[i][1][3]);
        }
      }
    }
  }
  gs::cp_async_wait<0>();

  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_part[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = o + qpos * p.o_ss;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c0 = 4 * (tx + 16 * u);
      const float vals[4] = {acc[i][u][0], acc[i][u][1], acc[i][u][2],
                             acc[i][u][3]};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c0 + c < p.D) orow[c0 + c] = vals[c] * inv;
    }
  }
}

// 16-byte copies need 16-byte rows: D and every row/head/batch stride a
// multiple of `per` elements, and 16-byte aligned bases.
bool vector_ok(const Params& p, int per) {
  const long long strides[] = {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh,
                               p.v_sb, p.v_ss, p.v_sh, p.o_sb, p.o_ss, p.o_sh};
  bool ok = p.D % per == 0 && gs::aligned16(p.q) && gs::aligned16(p.k) &&
            gs::aligned16(p.v) && gs::aligned16(p.o);
  for (long long s : strides) ok = ok && s % per == 0;
  return ok;
}

cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if (p.B > 65535) return cudaErrorInvalidValue;
  if (dtype == gs::kFloat32) {
    const int n_q = (p.Sq + kBQ - 1) / kBQ;
    if (n_q > 65535) return cudaErrorInvalidValue;
    const bool vec = vector_ok(p, 4);
    auto kernel = vec ? flash_fwd_f32<true> : flash_fwd_f32<false>;
    const int smem = f32_smem_bytes(p.D);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    // blockIdx.z runs the q tiles, heaviest first
    kernel<<<dim3(p.H, p.B, n_q), kF32Threads, smem, stream>>>(p);
    return cudaGetLastError();
  }
  const bool vec = vector_ok(p, 8);
  switch ((p.D + 15) / 16) {
    case 1: return launch_bf16_dp<16>(p, vec, stream);
    case 2: return launch_bf16_dp<32>(p, vec, stream);
    case 3: return launch_bf16_dp<48>(p, vec, stream);
    case 4: return launch_bf16_dp<64>(p, vec, stream);
    case 5: return launch_bf16_dp<80>(p, vec, stream);
    case 6: return launch_bf16_dp<96>(p, vec, stream);
    case 7: return launch_bf16_dp<112>(p, vec, stream);
    default: return launch_bf16_dp<128>(p, vec, stream);
  }
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
  if (dtype != gs::kFloat32 && dtype != gs::kBFloat16)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaSuccess;
  const Params p{q,    k,    v,    o,    B,    Sq,   Sk,   H,    Hkv,
                 D,    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                 v_sh, o_sb, o_ss, o_sh, causal, window, scale};
  return (int)launch(p, dtype, static_cast<cudaStream_t>(stream));
}
