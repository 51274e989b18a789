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
// sequential form (8 us at the bf16 tensor-core peak); in float32 at its
// train shape (2 x 1024 tokens) the same 119.4 MB, against 4.7 GFLOP at
// 3xTF32's 495/3 TFLOP/s, 0.029 ms.
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
// float32: mamba2_ssd_kernel_tf32, the same chunked dual form on the
//   tensor cores in 3xTF32.  One TF32 product keeps 11 significant bits,
//   which misses the float32 tolerance of 1e-4; three keep about 22: each
//   operand x is split into hi = tf32(x) and lo = tf32(x - hi)
//   (split_tf32, mma_sm90.cuh), and a product is hi * hi plus the small
//   terms lo * hi and hi * lo, each a mma.sync.m16n8k8 with tf32 operands
//   and float32 accumulators.
//   * Chunks of L = 32 steps (one a lane for the scan of dt); grid =
//     (ceil(P / 64), H, B); a block of 4 warps walks its chunks in order,
//     warp w owning the state columns p = 16 w .. + 15 as S^T [16 x N] in
//     registers: the carry's C fragments, which with each 8-column group
//     permuted (k-index c <- column 2c, c + 4 <- 2c + 1) are the A
//     fragments of C S, so the state never goes through shared memory.
//   * A chunk: x, B and C of the next chunk by cp.async (double-buffered,
//     whole rows without the source-size operand and rows past T zeroed by
//     plain stores: the zero-filling form made the kernel 15-17 % slower;
//     plain loads where P or N is not a multiple of 4); B and C split once
//     for all the warps,
//     in place (hi) with their lo parts beside them; M = (C B^T) .* seg in
//     six 16 x 8 tiles over the 4 warps, split into shared memory; then
//     each warp's y^T = (dt x)^T M^T + exp(la) .* (S^T C^T), its A operand
//     (dt x)^T made and split in registers from x, into shared memory, and
//     its carry S^T' = exp(la_L) S^T + (dt x exp(la_L - la))^T B, the
//     chunk's sum in a fresh accumulator added by one FMA.  The next
//     chunk stores y as float4 rows: a warp's own scattered stores of y
//     held up the copies behind them.
//   * C B^T and C S keep hi * hi in one accumulator and the small terms in
//     another (the tensor cores' float32 additions truncate; a long chain
//     drifts); C B^T and the product with M also split their k-steps into
//     even and odd accumulators, chains half as deep.
//   * Every operand read is conflict-free: float2 pairs (2c, 2c + 1) of a
//     row g, or rows c and c + 4, by the row strides of Tf32Smem.
//     Dynamic shared memory 92,672 B at N = 64 (two blocks an SM; ptxas:
//     255 registers, no spills), 141,824 B at N = 128 (one).
//   * No atomics, a fixed order of every sum: equal inputs give equal bits.
//
// Measured (chip_smoke.py; profiler device time a call in zamba2-7b's bf16
// prefill at (1, 4096, 112, 64, G=1, N=64), NVIDIA H100 80GB HBM3, 700 W):
// 0.241494 ms, 494 GB/s, 6.8x the byte bound.  Float32 at zamba2-7b's train
// shape (2, 1024, 112, 64, 1, 64), CUDA events, runs of 10 calls back to
// back: 0.160677-0.165283 ms, 4.5x the byte bound; the sequential kernel it
// replaced took 0.578771-0.607720 in the same runs (PERF.md).

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
// float32: the chunked dual form on the tensor cores, 3xTF32
// ---------------------------------------------------------------------------

constexpr int kTL = 32;                  // chunk length: one step a lane
constexpr int kTPB = 64;                 // state columns p a block
constexpr int kTWarps = kTPB / 16;       // a warp a 16-column p-tile
constexpr int kTThreads = 32 * kTWarps;
constexpr int kScanWarp = 3;             // one C B^T tile: it has the time
static_assert(kTL == 32, "scan_dt gives each lane one step");

template <int NK>
struct Tf32Smem {
  static constexpr int NP = 16 * NK;     // padded state size
  // row strides (floats), each so that the lanes of a fragment load fall
  // on distinct banks: B and C are read as float2 pairs (2c, 2c + 1) of a
  // row g or as rows c and c + 4, x as rows c and c + 4 (stride = 8 (mod
  // 16)); (C B^T) .* seg (M) as columns c and c + 4 of a row g (= 4 (mod
  // 32)); y is written as rows 2c and 2c + 1 (= 4 (mod 8))
  static constexpr int LDB = NP + 8;
  static constexpr int LDX = kTPB + 8;
  static constexpr int LDM = kTL + 4;
  static constexpr int LDY = kTPB + 4;
  static constexpr size_t kBytes =
      sizeof(float) * (2 * kTL * LDX     // x, two stages
                       + 4 * kTL * LDB   // B and C, two stages (hi in place)
                       + 2 * kTL * LDB   // B lo, C lo
                       + kTL * LDY       // y on its way out
                       + 2 * kTL * LDM   // (C B^T) .* seg: hi, lo
                       + 2 * 4 * kTL);   // per stage: dt, la, exp(la),
                                         // exp(la_L - la)
};

// the A fragment (16 columns p x 8 steps s) of (d x)^T, split: x0 points at
// x[s = c][p = g] of a tile of rows LDX apart, d0 and d1 scale the steps c
// and c + 4
template <int LDX>
__device__ __forceinline__ void x_frag(const float* x0, float d0, float d1,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(d0 * x0[0], hi[0], lo[0]);
  split_tf32(d0 * x0[8], hi[1], lo[1]);
  split_tf32(d1 * x0[4 * LDX], hi[2], lo[2]);
  split_tf32(d1 * x0[4 * LDX + 8], hi[3], lo[3]);
}

// MINB: the blocks an SM that the registers must allow (the shared memory
// allows them)
template <int NK, int MINB>
__global__ void __launch_bounds__(kTThreads, MINB)
mamba2_ssd_kernel_tf32(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm, float* __restrict__ y,
                       int t_len, int h_heads, int p_dim, int g_groups,
                       int n_state, int x_vec, int bc_vec, int y_vec) {
  using Sm = Tf32Smem<NK>;
  constexpr int NP = Sm::NP, LDB = Sm::LDB, LDX = Sm::LDX, LDM = Sm::LDM,
                LDY = Sm::LDY;
  constexpr int KN = NP / 8;             // k-steps (n-tiles) over the state
  constexpr int KL = kTL / 8;            // k-steps (n-tiles) over the chunk
  constexpr int NG = KN < 8 ? KN : 8;    // the carry's n-tiles at a time
  extern __shared__ __align__(16) unsigned char tf_smem[];
  float* xs0 = reinterpret_cast<float*>(tf_smem);    // [2][L][LDX]
  float* stage0 = xs0 + 2 * kTL * LDX;               // [2][B, C][L][LDB]
  float* Bl = stage0 + 4 * kTL * LDB;                // [L][LDB]
  float* Cl = Bl + kTL * LDB;
  float* Ys = Cl + kTL * LDB;                        // [L][LDY]
  float* Mh = Ys + kTL * LDY;                        // [L][LDM]
  float* Ml = Mh + kTL * LDM;
  float* fst = Ml + kTL * LDM;                       // [2][4][L]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, cq = lane & 3;
  const int p0 = blockIdx.x * kTPB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (h_heads / g_groups);
  const float a2 = A[h] * kLog2e;        // log2 units: exp(x) = exp2(x log2 e)
  const int64_t x_stride = int64_t(h_heads) * p_dim;
  const int64_t bc_stride = int64_t(g_groups) * n_state;
  const float* xb = x + (int64_t(b) * t_len * h_heads + h) * p_dim + p0;
  const float* dtb = dt + int64_t(b) * t_len * h_heads + h;
  const float* Bb = Bm + (int64_t(b) * t_len * g_groups + grp) * n_state;
  const float* Cb = Cm + (int64_t(b) * t_len * g_groups + grp) * n_state;
  float* yb = y + (int64_t(b) * t_len * h_heads + h) * p_dim + p0;
  const int p_cols = min(kTPB, p_dim - p0);
  const int n_chunks = (t_len + kTL - 1) / kTL;

  auto xs = [&](int st) { return xs0 + st * kTL * LDX; };
  auto Bs = [&](int st) { return stage0 + st * 2 * kTL * LDB; };
  auto Cs = [&](int st) { return Bs(st) + kTL * LDB; };
  // per stage: dt, la (log2 units), exp(la), exp(la_L - la)
  auto fs = [&](int st, int which) { return fst + (st * 4 + which) * kTL; };
  auto issue = [&](int c, int st) {
    stage_rows_f32<kTL, kTPB, LDX, kTThreads>(xs(st), xb, x_stride, c * kTL,
                                              t_len, p_cols, x_vec);
    stage_rows_f32<kTL, NP, LDB, kTThreads>(Bs(st), Bb, bc_stride, c * kTL,
                                            t_len, n_state, bc_vec);
    stage_rows_f32<kTL, NP, LDB, kTThreads>(Cs(st), Cb, bc_stride, c * kTL,
                                            t_len, n_state, bc_vec);
    cp_async_commit();
  };
  // chunk c's y, which the warps left in Ys, as float4 rows where P allows
  auto store_y = [&](int c, int i) {
    const int r = i / (kTPB / 4), cc = (i % (kTPB / 4)) * 4;
    const int t = c * kTL + r;
    if (t >= t_len || cc >= p_cols) return;
    const float4 v = *reinterpret_cast<const float4*>(Ys + r * LDY + cc);
    float* dst = yb + int64_t(t) * x_stride + cc;
    if (y_vec) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      dst[0] = v.x;
      if (cc + 1 < p_cols) dst[1] = v.y;
      if (cc + 2 < p_cols) dst[2] = v.z;
      if (cc + 3 < p_cols) dst[3] = v.w;
    }
  };
  // warp kScanWarp: step `lane` of chunk c's dt, zero past T
  auto load_dt = [&](int c) {
    const int t = c * kTL + lane;
    return t < t_len ? dtb[int64_t(t) * h_heads] : 0.f;
  };
  // warp kScanWarp: la = cumsum(dt A) (a shuffle scan) and its exps into
  // stage st
  auto scan_dt = [&](int st, float d) {
    float la = d * a2;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, la, o);
      if (lane >= o) la += u;
    }
    const float total = __shfl_sync(0xffffffffu, la, 31);
    fs(st, 0)[lane] = d;
    fs(st, 1)[lane] = la;
    fs(st, 2)[lane] = fast_exp2(la);
    fs(st, 3)[lane] = fast_exp2(total - la);
  };

  // prologue: chunk 0 in flight, its la scanned, S = 0
  issue(0, 0);
  if (warp == kScanWarp) scan_dt(0, load_dt(0));

  // the warp's p-tile of S^T: rows p = pw + g (+ 8), columns n of n-tile
  // k: a C fragment, and with each 8-column group permuted the A fragment
  // of the k-step k of C S
  const int pw = 16 * warp;
  float S[KN][4];
#pragma unroll
  for (int k = 0; k < KN; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[k][e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    cp_async_wait<0>();                  // chunk c has landed
    __syncthreads();                     // and chunk c - 1's reads are done
    float nd = 0.f;
    if (c + 1 < n_chunks) {
      issue(c + 1, st ^ 1);
      if (warp == kScanWarp) nd = load_dt(c + 1);
    }
    const float* xc = xs(st);
    float* Bh = Bs(st);
    float* Ch = Cs(st);
    const float* dts = fs(st, 0);
    const float* las = fs(st, 1);
    const float* ela = fs(st, 2);
    const float* wts = fs(st, 3);

    // ---- B and C split once, for all the warps: in place (hi), their lo
    // parts beside them; chunk c - 1's y out ----
    split_rows<kTL, NP, LDB, kTThreads>(Bh, Bl);
    split_rows<kTL, NP, LDB, kTThreads>(Ch, Cl);
    static_assert(kTL * kTPB / 4 % kTThreads == 0, "whole rounds of float4");
    if (c > 0) {
#pragma unroll
      for (int k = 0; k < kTL * kTPB / 4 / kTThreads; ++k)
        store_y(c - 1, threadIdx.x + k * kTThreads);
    }
    __syncthreads();

    // ---- M = (C B^T) .* seg over the keys s <= t, in six 16 x 8 tiles
    // (rows 16 rt .., keys 8 j ..): warp 0 (0, 0), (0, 1); 1 (1, 0),
    // (1, 1); 2 (1, 2); 3 (1, 3).  The state's k-steps read the pairs of
    // columns (2c, 2c + 1) of C's and B's rows; hi * hi apart from the
    // small terms.  M is written split, rows t, columns s ----
    {
      const int rt = warp == 0 ? 0 : 1;
      const int j0 = warp < 2 ? 0 : warp;
      const int nj = warp < 2 ? 2 : 1;
      // [tile][k-step parity]: chains half as deep
      float sc[2][2][4], scl[2][2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[q][k][e] = scl[q][k][e] = 0.f;
      const int ca = (16 * rt + g) * LDB + 2 * cq;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        const float2 h0 = ld2(Ch + ca + 8 * kk);
        const float2 h1 = ld2(Ch + ca + 8 * LDB + 8 * kk);
        const float2 l0 = ld2(Cl + ca + 8 * kk);
        const float2 l1 = ld2(Cl + ca + 8 * LDB + 8 * kk);
        const uint32_t ah[4] = {u32(h0.x), u32(h1.x), u32(h0.y), u32(h1.y)};
        const uint32_t al[4] = {u32(l0.x), u32(l1.x), u32(l0.y), u32(l1.y)};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q < nj) {
            const int o = (8 * (j0 + q) + g) * LDB + 8 * kk + 2 * cq;
            const float2 bh = ld2(Bh + o), bl = ld2(Bl + o);
            mma_tf32_1688(scl[q][kk & 1], al, u32(bh.x), u32(bh.y));
            mma_tf32_1688(scl[q][kk & 1], ah, u32(bl.x), u32(bl.y));
            mma_tf32_1688(sc[q][kk & 1], ah, u32(bh.x), u32(bh.y));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q < nj) {
          float cb[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            cb[e] = (sc[q][0][e] + sc[q][1][e]) + (scl[q][0][e] + scl[q][1][e]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int t = 16 * rt + g + 8 * r, s = 8 * (j0 + q) + 2 * cq;
            const float lt = las[t];
            const float v0 =
                s <= t ? cb[2 * r] * fast_exp2(lt - las[s]) : 0.f;
            const float v1 =
                s + 1 <= t ? cb[2 * r + 1] * fast_exp2(lt - las[s + 1]) : 0.f;
            uint32_t h0, l0, h1, l1;
            split_tf32(v0, h0, l0);
            split_tf32(v1, h1, l1);
            *reinterpret_cast<float2*>(Mh + t * LDM + s) =
                make_float2(__uint_as_float(h0), __uint_as_float(h1));
            *reinterpret_cast<float2*>(Ml + t * LDM + s) =
                make_float2(__uint_as_float(l0), __uint_as_float(l1));
          }
        }
      }
      if (warp == kScanWarp && c + 1 < n_chunks) scan_dt(st ^ 1, nd);
    }
    __syncthreads();

    // ---- y^T of the warp's p-tile, t-tiles tb (rows t = 8 tb ..) ----
    // C S: A = S^T from the registers (k-step k's pairs of columns as
    // k-indices cq, cq + 4), B = C^T read as pairs (2c, 2c + 1) of C's rows
    float yi[KL][4], yil[KL][4], yo[KL][2][4];   // yo: [.][key step parity]
#pragma unroll
    for (int tb = 0; tb < KL; ++tb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        yi[tb][e] = yil[tb][e] = yo[tb][0][e] = yo[tb][1][e] = 0.f;
#pragma unroll
    for (int k = 0; k < KN; ++k) {
      uint32_t ah[4], al[4];
      split_tf32(S[k][0], ah[0], al[0]);
      split_tf32(S[k][2], ah[1], al[1]);
      split_tf32(S[k][1], ah[2], al[2]);
      split_tf32(S[k][3], ah[3], al[3]);
#pragma unroll
      for (int tb = 0; tb < KL; ++tb) {
        const int o = (8 * tb + g) * LDB + 8 * k + 2 * cq;
        const float2 bh = ld2(Ch + o), bl = ld2(Cl + o);
        mma_tf32_1688(yil[tb], al, u32(bh.x), u32(bh.y));
        mma_tf32_1688(yil[tb], ah, u32(bl.x), u32(bl.y));
        mma_tf32_1688(yi[tb], ah, u32(bh.x), u32(bh.y));
      }
    }
    // ((C B^T) .* seg) (dt x): A = (dt x)^T of the warp's columns, made
    // and split here from rows c and c + 4 of x, B = M^T read as columns c
    // and c + 4 of M's rows, keys s <= t
#pragma unroll
    for (int ks = 0; ks < KL; ++ks) {
      uint32_t ah[4], al[4];
      x_frag<LDX>(xc + (8 * ks + cq) * LDX + pw + g, dts[8 * ks + cq],
             dts[8 * ks + cq + 4], ah, al);
#pragma unroll
      for (int tb = ks; tb < KL; ++tb) {
        const int m = (8 * tb + g) * LDM + 8 * ks + cq;
        mma_3xtf32(yo[tb][ks & 1], ah, al, u32(Mh[m]), u32(Mh[m + 4]),
                   u32(Ml[m]), u32(Ml[m + 4]));
      }
    }
    // y = ((C B^T) .* seg) (dt x) + exp(la) .* (C S): the fragment's rows
    // are columns p, its columns steps t; into Ys, which the next split
    // phase stores
#pragma unroll
    for (int tb = 0; tb < KL; ++tb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tl = 8 * tb + 2 * cq + (e & 1);
        Ys[tl * LDY + pw + g + 8 * (e >> 1)] =
            fmaf(ela[tl], yi[tb][e] + yil[tb][e],
                 yo[tb][0][e] + yo[tb][1][e]);
      }

    // ---- carry: S^T' = exp(la_L) S^T + (dt x exp(la_L - la))^T B, NG
    // n-tiles at a time, each sum in a fresh accumulator added by one FMA
    // (A made from rows c and c + 4 of x, B read as rows c and c + 4 of
    // B) ----
    const float decay = ela[kTL - 1];
#pragma unroll
    for (int k0 = 0; k0 < KN; k0 += NG) {
      float f[NG][4];
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[q][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KL; ++ks) {
        const int s = 8 * ks + cq;
        uint32_t ah[4], al[4];
        x_frag<LDX>(xc + s * LDX + pw + g, dts[s] * wts[s],
               dts[s + 4] * wts[s + 4], ah, al);
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          const int n = (8 * ks + cq) * LDB + 8 * (k0 + q) + g;
          mma_3xtf32(f[q], ah, al, u32(Bh[n]), u32(Bh[n + 4 * LDB]),
                     u32(Bl[n]), u32(Bl[n + 4 * LDB]));
        }
      }
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          S[k0 + q][e] = fmaf(S[k0 + q][e], decay, f[q][e]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kTL * kTPB / 4 / kTThreads; ++k)
    store_y(n_chunks - 1, threadIdx.x + k * kTThreads);
}

template <int NK, int MINB>
int launch_tf32(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, void* y, int64_t b, int64_t t, int64_t h,
                int64_t p, int64_t g, int64_t n, cudaStream_t stream) {
  auto kernel = mamba2_ssd_kernel_tf32<NK, MINB>;
  const size_t smem = Tf32Smem<NK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
  };
  const int x_vec = p % 4 == 0 && aligned(x);
  const int bc_vec = n % 4 == 0 && aligned(Bm) && aligned(Cm);
  const int y_vec = p % 4 == 0 && aligned(y);
  dim3 grid(unsigned((p + kTPB - 1) / kTPB), unsigned(h), unsigned(b));
  kernel<<<grid, kTThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), int(t), int(h),
      int(p), int(g), int(n), x_vec, bc_vec, y_vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_tf32(const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, void* y, int64_t b,
                  int64_t t, int64_t h, int64_t p, int64_t g, int64_t n,
                  cudaStream_t stream) {
  if (n <= 16)
    return launch_tf32<1, 2>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
  if (n <= 32)
    return launch_tf32<2, 2>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
  if (n <= 64)
    return launch_tf32<4, 2>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
  return launch_tf32<8, 1>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
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
    return dispatch_tf32(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, s);
  if (dtype == DT_BF16)
    return dispatch_chunked(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
