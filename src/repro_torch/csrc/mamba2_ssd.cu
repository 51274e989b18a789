// mamba2_ssd: the Mamba2 SSD (state-space dual) recurrence for Hopper
// (sm_90a), a float32 [N, P] state per (batch, head).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mamba2_ssd/kernel.py:_ssd_kernel (launcher ssd at
//   :78, pallas_call at :102);
// its plain PyTorch version is
//   repro_torch.kernels.mamba2_ssd.ops.ssd_plain
// (ssd_ref's sequential scan), and chip_smoke.py holds the two together on
// the card.  Per head h, with group g = h / (H / G) (the Pallas index map
// at kernel.py:99):
//
//   a_t = exp(dt_t * A_h);  S_t = a_t S_{t-1} + B_t (dt_t x_t)^T;
//   y_t = C_t^T S_t
//
// Bound: bytes.  The function reads x, dt, B and C once and writes y once:
// at zamba2's prefill shape (4096 tokens, 112 heads, P = 64, N = 64, G = 1,
// bf16) 119.4 MB, 0.036 ms at 3.35 TB/s, against 7.5 GFLOP of the
// sequential form (8 us at the bf16 tensor-core peak).
//
// Two paths, picked by the element type:
//
// bfloat16: mamba2_ssd_kernel_chunked, the chunked dual form of the TPU
//   kernel (kernel.py:1-19, 36-75) on the tensor cores.  Per chunk of
//   L = 64 steps, with la = cumsum(dt A) in float32 (kept in log2 units):
//     y   = ((C B^T) .* seg) (dt x) + exp(la) .* (C S)
//     S'  = exp(la_L) S + B^T (dt x .* exp(la_L - la))
//   seg[t, s] = exp(la_t - la_s) [s <= t].  Every decay factor is <= 1.
//   * Parallelism: grid = (ceil(P / 32), H, B); a block of 8 warps owns 32
//     state columns of one (batch, head) and walks its T / L chunks in
//     order (zamba2: 2 x 112 = 224 blocks, all resident on 132 SMs).  Warp
//     (wr, wc) computes the outputs of chunk rows 16 wr .. 16 wr + 15 in
//     the 16 columns of half wc, and carries the state m-tiles wr, wr + 4,
//     ... of those columns; C B^T is computed by both halves, which is
//     cheap.  This split needs no scratch; the three-phase form (chunk
//     states in parallel, a scan over them, outputs in parallel) would write
//     and read a float32 [H, T / L, N, P] scratch, 117 MB at this shape,
//     about as much as the inputs.
//   * The chunk's x, B and C land in shared memory as bf16 by cp.async
//     while the previous chunk computes (double-buffered; rows past T are
//     zero-filled, so padded steps have dt = 0, x = 0 and move nothing);
//     warp 0 loads the next chunk's dt into registers at the same time
//     (kept as bf16 until it is used: converting at the load made the warp
//     wait for it there, and the whole block at the next barrier) and
//     scans it into la, exp(la) and exp(la_L - la) once the chunk's
//     products are done.  Rows whose 16-byte chunks are not aligned (P or N not a
//     multiple of 8) are staged by plain loads instead.
//   * Products on mma.sync.m16n8k16 (bf16 operands, float32 accumulators):
//     C B^T [16 x L] per warp over the keys s <= t only; (C B^T .* seg) is
//     rounded to bf16 in registers and is the A operand of the product with
//     dt x [L x 16]; C S_in [16 x 16]; the carry B^T (dt x .* exp(la_L -
//     la)) [16 x 16] per m-tile, B's fragments by ldmatrix.trans.
//   * Rounding: C and B are bf16 inputs (exact).  dt x, dt x exp(la_L - la)
//     and (C B^T) .* seg are rounded to bf16 for the mma (2^-9 relative
//     each, every factor <= 1, float32 sums); the 2e-2 gate holds them
//     against max |y|.  The state stays float32 in registers across chunks
//     and is never rounded: for C S its copy enters the mma as bf16 hi +
//     lo parts (S - hi rounded again), so the product sees about 16 of its
//     bits.
//   * N padded with zeros to a multiple of 16 (NK = N / 16 <= 8, a template
//     parameter); dynamic shared memory 79,872 B at N = 64 (two blocks an
//     SM; ptxas: 125 registers, no spills), 133,120 B at N = 128.
//
// float32: mamba2_ssd_kernel_f32, sequential in T on the float32 CUDA cores
//   (TF32 would miss the float32 tolerance of 1e-4): a block of 256 threads
//   owns 32 columns p of one (batch, head)'s state, thread (pl, ng) keeping
//   the states n = ng, ng + 8, ... of column pl in registers; chunks of 32
//   steps are staged in shared memory as float32.
//
// Measured (chip_smoke.py; profiler device time a call in zamba2-7b's bf16
// prefill at (1, 4096, 112, 64, G=1, N=64), NVIDIA H100 80GB HBM3, 700 W):
// 0.241494 ms, 494 GB/s, 6.8x the byte bound (PERF.md).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;
using bf16 = __nv_bfloat16;

// Element types; the codes are repro_torch.kernels._build.DTYPE_CODES,
// pinned by tests/test_torch_kernel_layout.py.
enum DType { DT_F32 = 0, DT_BF16 = 1 };

constexpr int kMaxN = 128;

// ---------------------------------------------------------------------------
// bfloat16: the chunked dual form on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kL = 64;                   // chunk length
constexpr int kRowWarps = 4;             // 16 chunk rows a warp
constexpr int kColWarps = 2;             // column halves of a block
constexpr int kPB = 32;                  // state columns per block
constexpr int kChunkThreads = 32 * kRowWarps * kColWarps;
constexpr float kLog2e = 1.4426950408889634f;

template <int NK>
struct ChunkSmem {
  static constexpr int NP = 16 * NK;     // padded state size
  static constexpr int LDN = NP + 8;     // shared row stride of B, C
  static constexpr int LDX = kPB + 8;    // shared row stride of x-like tiles
  // per stage: x [L][LDX], B and C [L][LDN] (bf16)
  static constexpr int kStageElems = kL * LDX + 2 * kL * LDN;
  static constexpr size_t kBytes =
      sizeof(bf16) * (2 * kStageElems          // two stages
                      + 2 * kL * LDX           // dt x, dt x exp(la_L - la)
                      + 4 * NP * LDX)          // S hi, lo, two buffers
      + sizeof(float) * 2 * 4 * kL;            // per stage: dt, la, exp(la),
                                               // exp(la_L - la)
};

// rows [t0, t0 + L) of an [T, *]-strided matrix, `cols` real columns, into
// dst[L][ld] as bf16, width `width` (a multiple of 8), zero past T and past
// cols.  vec: 16-byte cp.async, else plain loads.
__device__ __forceinline__ void stage_chunk(bf16* dst, int ld, int width,
                                            const bf16* src,
                                            int64_t row_stride, int t0,
                                            int t_len, int cols, bool vec) {
  if (vec) {
    const int ch = width / 8;
    for (int i = threadIdx.x; i < kL * ch; i += kChunkThreads) {
      const int r = i / ch, c = (i - r * ch) * 8;
      bf16* dp = dst + r * ld + c;
      if (c < cols) {
        const bool ok = t0 + r < t_len;
        cp_async_16(dp, ok ? src + (t0 + r) * row_stride + c : src,
                    ok ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(dp) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kL * width; i += kChunkThreads) {
      const int r = i / width, c = i - r * width;
      bf16 val = __float2bfloat16(0.f);
      if (t0 + r < t_len && c < cols) val = src[(t0 + r) * row_stride + c];
      dst[r * ld + c] = val;
    }
  }
}

template <int NK>
__global__ void __launch_bounds__(kChunkThreads)
mamba2_ssd_kernel_chunked(const bf16* __restrict__ x,
                          const bf16* __restrict__ dt,
                          const float* __restrict__ A,
                          const bf16* __restrict__ Bm,
                          const bf16* __restrict__ Cm, bf16* __restrict__ y,
                          int t_len, int h_heads, int p_dim, int g_groups,
                          int n_state, int x_vec, int bc_vec) {
  using Sm = ChunkSmem<NK>;
  constexpr int NP = Sm::NP, LDN = Sm::LDN, LDX = Sm::LDX;
  constexpr int PT = kPB / 8 / kColWarps;            // n-tiles of a warp
  constexpr int MT = (NK + kRowWarps - 1) / kRowWarps;  // state m-tiles
  static_assert(PT % 2 == 0, "ldmatrix_x4_trans loads two n-tiles");
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  bf16* stage0 = reinterpret_cast<bf16*>(ssd_smem);
  bf16* xdt = stage0 + 2 * Sm::kStageElems;          // [L][LDX] dt x
  bf16* xdw = xdt + kL * LDX;                        // [L][LDX] dt x w
  bf16* Sst = xdw + kL * LDX;                        // [2][hi, lo][NP][LDX]
  float* fst = reinterpret_cast<float*>(Sst + 4 * NP * LDX);  // [2][4][L]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = blockIdx.x * kPB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (h_heads / g_groups);
  const float a2 = A[h] * kLog2e;        // log2 units: exp(x) = exp2(x log2 e)
  const int64_t x_stride = int64_t(h_heads) * p_dim;
  const int64_t bc_stride = int64_t(g_groups) * n_state;
  const bf16* xb = x + (int64_t(b) * t_len * h_heads + h) * p_dim + p0;
  const bf16* dtb = dt + int64_t(b) * t_len * h_heads + h;
  const bf16* Bb = Bm + (int64_t(b) * t_len * g_groups + grp) * n_state;
  const bf16* Cb = Cm + (int64_t(b) * t_len * g_groups + grp) * n_state;
  bf16* yb = y + (int64_t(b) * t_len * h_heads + h) * p_dim + p0;
  const int p_cols = min(kPB, p_dim - p0);
  const int n_chunks = (t_len + kL - 1) / kL;

  auto xs = [&](int st) { return stage0 + st * Sm::kStageElems; };
  auto Bs = [&](int st) { return xs(st) + kL * LDX; };
  auto Cs = [&](int st) { return Bs(st) + kL * LDN; };
  // per stage: dt, la (log2 units), exp(la), exp(la_L - la)
  auto fs = [&](int st, int which) { return fst + (st * 4 + which) * kL; };

  auto issue = [&](int c, int st) {
    const int t0 = c * kL;
    stage_chunk(xs(st), LDX, kPB, xb, x_stride, t0, t_len, p_cols,
                          x_vec);
    stage_chunk(Bs(st), LDN, NP, Bb, bc_stride, t0, t_len,
                          n_state, bc_vec);
    stage_chunk(Cs(st), LDN, NP, Cb, bc_stride, t0, t_len,
                          n_state, bc_vec);
    cp_async_commit();
  };
  // warp 0: the chunk's dt (steps 2 lane, 2 lane + 1), zero past T, kept
  // as bf16 until the scan, so the loads are not waited for where they issue
  auto load_dt = [&](int c, bf16& d0, bf16& d1) {
    const int t = c * kL + 2 * lane;
    const bf16 zero = __float2bfloat16(0.f);
    d0 = t < t_len ? dtb[int64_t(t) * h_heads] : zero;
    d1 = t + 1 < t_len ? dtb[int64_t(t + 1) * h_heads] : zero;
  };
  // warp 0: la = cumsum(dt A) and its exps into stage st
  auto scan_dt = [&](int st, bf16 b0, bf16 b1) {
    const float d0 = __bfloat162float(b0), d1 = __bfloat162float(b1);
    const float v0 = d0 * a2, v1 = d1 * a2;
    float incl = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    const float la1 = incl, la0 = incl - v1;
    const float total = __shfl_sync(0xffffffffu, incl, 31);
    fs(st, 0)[2 * lane] = d0;
    fs(st, 0)[2 * lane + 1] = d1;
    fs(st, 1)[2 * lane] = la0;
    fs(st, 1)[2 * lane + 1] = la1;
    fs(st, 2)[2 * lane] = fast_exp2(la0);
    fs(st, 2)[2 * lane + 1] = fast_exp2(la1);
    fs(st, 3)[2 * lane] = fast_exp2(total - la0);
    fs(st, 3)[2 * lane + 1] = fast_exp2(total - la1);
  };

  // prologue: chunk 0 in flight, its la scanned, S_in = 0
  issue(0, 0);
  if (warp == 0) {
    bf16 d0, d1;
    load_dt(0, d0, d1);
    scan_dt(0, d0, d1);
  }
  for (int i = threadIdx.x; i < 2 * NP * LDX; i += kChunkThreads)
    Sst[i] = __float2bfloat16(0.f);

  float S[MT][PT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < PT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[m][n][e] = 0.f;

  // ldmatrix lane offsets: A (16 x 16, row-major), B from [n][k] rows
  // (non-trans), B from [k][n] rows (trans), A from [k][m] rows (trans)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int bn_row = (lane & 7) + ((lane >> 4) << 3),
            bn_col = ((lane >> 3) & 1) * 8;
  const int bt_row = (lane & 7) + ((lane >> 3) & 1) * 8,
            bt_col = (lane >> 4) * 8;
  const int at_row = (lane & 7) + ((lane >> 4) & 1) * 8,
            at_col = ((lane >> 3) & 1) * 8;
  const int g = lane >> 2, cq = lane & 3;
  // warp (wr, wc): chunk rows 16 wr .. 16 wr + 15, state m-tiles wr,
  // wr + 4, ..., and the columns wc * 8 PT .. of the block's kPB
  const int wr = warp % kRowWarps, wc = warp / kRowWarps;
  const int r0 = 16 * wr, c0 = 8 * PT * wc;

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    cp_async_wait<0>();                  // chunk c has landed
    __syncthreads();
    bf16 nd0 = __float2bfloat16(0.f), nd1 = nd0;
    if (c + 1 < n_chunks) {
      issue(c + 1, st ^ 1);
      if (warp == 0) load_dt(c + 1, nd0, nd1);
    }
    const bf16* Xs = xs(st);
    const bf16* Bt = Bs(st);
    const bf16* Ct = Cs(st);
    const float* dts = fs(st, 0);
    const float* las = fs(st, 1);
    const float* ela = fs(st, 2);
    const float* wts = fs(st, 3);

    // dt x, and dt x exp(la_L - la) for the carry, rounded to bf16
    for (int i = threadIdx.x; i < kL * kPB / 2; i += kChunkThreads) {
      const int r = i / (kPB / 2), cc = 2 * (i - r * (kPB / 2));
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Xs + r * LDX + cc));
      const float d = dts[r], dw = dts[r] * wts[r];
      *reinterpret_cast<__nv_bfloat162*>(xdt + r * LDX + cc) =
          __floats2bfloat162_rn(d * xv.x, d * xv.y);
      *reinterpret_cast<__nv_bfloat162*>(xdw + r * LDX + cc) =
          __floats2bfloat162_rn(dw * xv.x, dw * xv.y);
    }
    __syncthreads();

    // ---- outputs of rows r0 .. r0 + 15 ----
    uint32_t cf[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      ldmatrix_x4(cf[kk], Ct + (r0 + a_row) * LDN + 16 * kk + a_col);
    float sc[kL / 8][4];                 // C B^T, keys s <= r0 + 15 only
#pragma unroll
    for (int j = 0; j < kL / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kL / 8; j += 2) {
      if (j <= 2 * wr) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          uint32_t bb[4];
          ldmatrix_x4(bb, Bt + (8 * j + bn_row) * LDN + 16 * kk + bn_col);
          mma_bf16_16816(sc[j], cf[kk], bb[0], bb[1]);
          mma_bf16_16816(sc[j + 1], cf[kk], bb[2], bb[3]);
        }
      }
    }
    // .* seg: exp(la_t - la_s) for s <= t, else 0
    const float la_t[2] = {las[r0 + g], las[r0 + g + 8]};
#pragma unroll
    for (int j = 0; j < kL / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + g + 8 * (e >> 1), s = 8 * j + 2 * cq + (e & 1);
        sc[j][e] = s <= t ? sc[j][e] * fast_exp2(la_t[e >> 1] - las[s]) : 0.f;
      }
    float yo[PT][4], yi[PT][4];
#pragma unroll
    for (int n = 0; n < PT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yo[n][e] = yi[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) {
      if (kk <= wr) {
        const uint32_t a[4] = {pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
                               pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
                               pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                               pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < PT; n += 2) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, xdt + (16 * kk + bt_row) * LDX + c0 + 8 * n +
                                    bt_col);
          mma_bf16_16816(yo[n], a, bb[0], bb[1]);
          mma_bf16_16816(yo[n + 1], a, bb[2], bb[3]);
        }
      }
    }
    // C S_in, S as bf16 hi + lo
    const bf16* Sh = Sst + st * 2 * NP * LDX;
    const bf16* Sl = Sh + NP * LDX;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int n = 0; n < PT; n += 2) {
        uint32_t bh[4], bl[4];
        const int off = (16 * kk + bt_row) * LDX + c0 + 8 * n + bt_col;
        ldmatrix_x4_trans(bh, Sh + off);
        ldmatrix_x4_trans(bl, Sl + off);
        mma_bf16_16816(yi[n], cf[kk], bh[0], bh[1]);
        mma_bf16_16816(yi[n + 1], cf[kk], bh[2], bh[3]);
        mma_bf16_16816(yi[n], cf[kk], bl[0], bl[1]);
        mma_bf16_16816(yi[n + 1], cf[kk], bl[2], bl[3]);
      }
    const float el[2] = {ela[r0 + g], ela[r0 + g + 8]};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = c * kL + r0 + g + 8 * r;
      if (t >= t_len) continue;
      bf16* yrow = yb + int64_t(t) * x_stride;
#pragma unroll
      for (int n = 0; n < PT; ++n) {
        const int col = c0 + 8 * n + 2 * cq;
        const float v0 = fmaf(el[r], yi[n][2 * r], yo[n][2 * r]);
        const float v1 = fmaf(el[r], yi[n][2 * r + 1], yo[n][2 * r + 1]);
        if ((p_dim & 1) == 0 && col + 1 < p_cols) {
          *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < p_cols) yrow[col] = __float2bfloat16(v0);
          if (col + 1 < p_cols) yrow[col + 1] = __float2bfloat16(v1);
        }
      }
    }

    // ---- carry: S' = exp(la_L) S + B^T (dt x exp(la_L - la)) ----
    const float decay = ela[kL - 1];
    bf16* Shn = Sst + (st ^ 1) * 2 * NP * LDX;
    bf16* Sln = Shn + NP * LDX;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int mt = wr + kRowWarps * m;
      if (mt >= NK) continue;
#pragma unroll
      for (int n = 0; n < PT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[m][n][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < kL / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, Bt + (16 * kk + at_row) * LDN + 16 * mt + at_col);
#pragma unroll
        for (int n = 0; n < PT; n += 2) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, xdw + (16 * kk + bt_row) * LDX + c0 + 8 * n +
                                    bt_col);
          mma_bf16_16816(S[m][n], a, bb[0], bb[1]);
          mma_bf16_16816(S[m][n + 1], a, bb[2], bb[3]);
        }
      }
      // the next chunk's S_in as bf16 hi + lo
#pragma unroll
      for (int n = 0; n < PT; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = (16 * mt + g + 8 * r) * LDX + c0 + 8 * n + 2 * cq;
          const __nv_bfloat162 hi =
              __floats2bfloat162_rn(S[m][n][2 * r], S[m][n][2 * r + 1]);
          const float2 hf = __bfloat1622float2(hi);
          *reinterpret_cast<__nv_bfloat162*>(Shn + off) = hi;
          *reinterpret_cast<__nv_bfloat162*>(Sln + off) =
              __floats2bfloat162_rn(S[m][n][2 * r] - hf.x,
                                    S[m][n][2 * r + 1] - hf.y);
        }
    }
    if (warp == 0 && c + 1 < n_chunks) scan_dt(st ^ 1, nd0, nd1);
  }
}

template <int NK>
int launch_chunked(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, int64_t b,
                   int64_t t, int64_t h, int64_t p, int64_t g, int64_t n,
                   cudaStream_t stream) {
  auto kernel = mamba2_ssd_kernel_chunked<NK>;
  const size_t smem = ChunkSmem<NK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
  };
  const int x_vec = p % 8 == 0 && aligned(x);
  const int bc_vec = n % 8 == 0 && aligned(Bm) && aligned(Cm);
  dim3 grid(unsigned((p + kPB - 1) / kPB), unsigned(h), unsigned(b));
  kernel<<<grid, kChunkThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<bf16*>(y), int(t), int(h),
      int(p), int(g), int(n), x_vec, bc_vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_chunked(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, int64_t b,
                     int64_t t, int64_t h, int64_t p, int64_t g, int64_t n,
                     cudaStream_t stream) {
  if (n <= 16)
    return launch_chunked<1>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
  if (n <= 32)
    return launch_chunked<2>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
  if (n <= 64)
    return launch_chunked<4>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
  return launch_chunked<8>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
}

// ---------------------------------------------------------------------------
// float32: sequential on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kCols = 32;                // state columns p per block
constexpr int kGroups = 8;               // threads sharing a column (split n)
constexpr int kThreads = kCols * kGroups;
constexpr int kChunk = 32;               // time steps staged at once

template <int KN>
__global__ void __launch_bounds__(kThreads)
mamba2_ssd_kernel_f32(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm, float* __restrict__ y,
                      int t_len, int h_heads, int p_dim, int g_groups,
                      int n_state) {
  constexpr int NP = kGroups * KN;        // padded state size
  __shared__ float xs[kChunk][kCols];
  __shared__ float ys[kChunk][kCols];
  __shared__ float dts[kChunk];
  __shared__ float Bs[kChunk][NP];
  __shared__ float Cs[kChunk][NP];

  const int tid = threadIdx.x;
  const int pl = tid / kGroups, ng = tid % kGroups;
  const int p0 = blockIdx.x * kCols;
  const int h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (h_heads / g_groups);
  const float a = A[h];

  float S[KN];
#pragma unroll
  for (int k = 0; k < KN; ++k) S[k] = 0.f;

  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int tc = min(kChunk, t_len - t0);
    __syncthreads();                      // previous chunk fully consumed
    for (int i = tid; i < kChunk * kCols; i += kThreads) {
      const int tt = i / kCols, c = i % kCols;
      float v = 0.f;
      if (tt < tc && p0 + c < p_dim)
        v = x[((int64_t(b) * t_len + t0 + tt) * h_heads + h) * p_dim + p0 +
              c];
      xs[tt][c] = v;
    }
    for (int i = tid; i < kChunk; i += kThreads)
      dts[i] = i < tc ? dt[(int64_t(b) * t_len + t0 + i) * h_heads + h]
                      : 0.f;
    for (int i = tid; i < kChunk * NP; i += kThreads) {
      const int tt = i / NP, n = i % NP;
      float bv = 0.f, cv = 0.f;
      if (tt < tc && n < n_state) {
        const int64_t off =
            ((int64_t(b) * t_len + t0 + tt) * g_groups + grp) * n_state + n;
        bv = Bm[off];
        cv = Cm[off];
      }
      Bs[tt][n] = bv;
      Cs[tt][n] = cv;
    }
    __syncthreads();

    for (int tt = 0; tt < tc; ++tt) {
      const float dtv = dts[tt];
      const float decay = expf(dtv * a);
      const float xdt = dtv * xs[tt][pl];
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < KN; ++k) {
        const int n = ng + kGroups * k;
        S[k] = decay * S[k] + Bs[tt][n] * xdt;
        acc = fmaf(Cs[tt][n], S[k], acc);
      }
      // sum over the column's 8 threads (consecutive lanes)
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (ng == 0) ys[tt][pl] = acc;
    }
    __syncthreads();
    for (int i = tid; i < tc * kCols; i += kThreads) {
      const int tt = i / kCols, c = i % kCols;
      if (p0 + c < p_dim)
        y[((int64_t(b) * t_len + t0 + tt) * h_heads + h) * p_dim + p0 + c] =
            ys[tt][c];
    }
  }
}

template <int KN>
int launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, void* y, int64_t b, int64_t t, int64_t h,
               int64_t p, int64_t g, int64_t n, cudaStream_t stream) {
  dim3 grid(unsigned((p + kCols - 1) / kCols), unsigned(h), unsigned(b));
  mamba2_ssd_kernel_f32<KN><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), int(t), int(h),
      int(p), int(g), int(n));
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, int64_t b, int64_t t, int64_t h,
                 int64_t p, int64_t g, int64_t n, cudaStream_t stream) {
  if (n <= kGroups * 2)
    return launch_f32<2>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
  if (n <= kGroups * 4)
    return launch_f32<4>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
  if (n <= kGroups * 8)
    return launch_f32<8>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
  return launch_f32<16>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
}

}  // namespace

// x [B,T,H,P], dt [B,T,H], B/C [B,T,G,N] of the element type `dtype`, A [H]
// float32, y [B,T,H,P] of `dtype`, all contiguous.  Returns a cudaError_t.
extern "C" int mamba2_ssd_launch(const void* x, const void* dt,
                                 const void* A, const void* Bm,
                                 const void* Cm, void* y, int64_t b,
                                 int64_t t, int64_t h, int64_t p, int64_t g,
                                 int64_t n, int64_t dtype, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || p <= 0) return 0;
  if (g <= 0 || h % g != 0 || n <= 0 || n > kMaxN || h > 65535 ||
      b > 65535 || t > 2147483647LL - kL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return dispatch_f32(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, s);
  if (dtype == DT_BF16)
    return dispatch_chunked(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
