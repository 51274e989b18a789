// flash_attention: blocked online-softmax attention forward (GQA, causal,
// sliding window) for Hopper (sm_90a), float32 accumulation.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:_fa_kernel (launcher
//   flash_attention at :89, pallas_call at :113);
// its plain PyTorch version is
//   repro_torch.kernels.flash_attention.ops.attention_plain
// (attention_ref's semantics), and chip_smoke.py holds the two together on
// the card.
//
// Bound: operations.  Each visible (query, key) pair costs 4*D flops (QK^T
// and PV) against (Sq + 2 Sk) * D elements read and Sq * D written once.
// At zamba2's causal prefill shape (32 heads, 4096 tokens, D = 112, bf16)
// that is 120.3 GFLOP a call, 0.122 ms at the bf16 tensor-core peak
// (989 TFLOP/s), against 117 MB of bf16 traffic, 0.035 ms at 3.35 TB/s.
//
// Two paths, picked by the element type:
//
// bfloat16: flash_attention_kernel_mma, on the tensor cores (the FA2 shape).
//   * grid = (B * Hq, ceil(Sq / BQ)); a block of WARPS warps owns BQ query
//     rows of one (batch, q head), MR m16 tiles (16 MR rows) a warp; the kv
//     head is hq / (Hq / Hkv) (GQA head folding, as the Pallas index map).
//     Under causal masking the query tiles launch heaviest (last) first,
//     so the longest rows do not form the tail of the grid.
//   * Tiles are bf16 in shared memory, D padded with zeros to DP, a
//     multiple of 16 (KD = DP / 16 mma k-steps), rows DP + 8 elements
//     apart so each ldmatrix phase hits 8 distinct 16-byte bank groups.
//     K and V tiles of BK keys are double-buffered: cp.async brings tile
//     t + 1 while the warps compute on tile t (zero-filled past Sk).
//     Rows whose 16-byte chunks are not aligned (D % 8 != 0) are staged
//     by plain loads instead, the same layout without the overlap.
//   * Q is pre-scaled in bf16 (q * bf16(scale), rounded to bf16, as
//     attention_plain does) once in shared memory; its fragments are
//     re-read by ldmatrix at each k-step, which leaves the registers to the
//     scores and the float32 output of two m-tiles.
//   * S = Q K^T: mma.sync.m16n8k16 (bf16 in, float32 accumulators), K
//     fragments by ldmatrix; each K (and V) fragment feeds the MR m-tiles
//     of the warp, so MR = 2 halves the shared-memory reads per product.
//     The online softmax (running max, running sum) runs on the accumulator
//     fragment: a thread holds 2 rows of each m-tile, a row is reduced
//     across its quad with 2 shuffles, exp2 (ex2.approx) with log2(e)
//     folded into one FMA.  P is rounded to bf16 in registers and is the A
//     operand of P V directly (the C fragments of two n-tiles are the A
//     fragment of one k-step), as attention_plain rounds the probabilities
//     to bf16 before the value product; the running sum adds the unrounded
//     P, as attention_plain's denominator does.  V fragments by
//     ldmatrix.trans.
//   * Key tiles outside the causal / window band are skipped by the loop
//     bounds, as kernel.py:44-50 does, and a warp skips a tile that its
//     rows cannot see; only tiles straddling the diagonal, the window edge
//     or the ragged end of Sk are masked element by element.  Rows past Sq
//     are computed on zeros and never stored.
//   * Tile sizes per D bucket (template parameters): D <= 128 in 4 warps of
//     32 rows (BQ = 128, MR = 2) with 64-key tiles, 92,160 B of dynamic
//     shared memory at D = 112 (two blocks an SM; ptxas: 255 registers, 8
//     bytes spilled); D <= 256 in 8 warps of 16 rows (BQ = 128) with 32-key
//     tiles, 135,168 B.
//
// float32: flash_attention_kernel_tf32, on the tensor cores in 3xTF32.
//   One TF32 product keeps 11 significant bits, which misses the float32
//   tolerance of 1e-4; three keep about 22: each operand x is split into
//   hi = tf32(x) and lo = tf32(x - hi) (split_tf32, mma_sm90.cuh), and a
//   product is hi * hi plus the small terms lo * hi and hi * lo, each a
//   mma.sync.m16n8k8 with tf32 operands and float32 accumulators.
//   * grid = (B * Hq, ceil(Sq / BQ)), WARPS warps of 16 query rows, the
//     causal query tiles heaviest first, GQA folding and the band's key
//     tiles as the bf16 path.
//   * Shared memory, rows DP + 4 floats apart (DP = D rounded up to 8):
//     Q pre-scaled in float32 (q * scale, as attention_plain), re-read by
//     ldmatrix and split at each k-step; each key tile of K and V staged
//     by cp.async (plain loads when D % 4 != 0), then split once for all
//     the warps into its hi parts (in place) and lo parts beside them.
//     One stage: two blocks an SM hide one block's loads behind the
//     other's products better than a second stage that halves the
//     blocks; __launch_bounds__ holds the registers to the two blocks.  ldmatrix on rows of four floats
//     gives the tf32 A and B fragments; the row stride keeps the 8 rows
//     of a fragment load on distinct banks.
//   * S = Q K^T: the hi * hi products in one accumulator, the small terms
//     in another, added once a tile (the tensor cores' float32 additions
//     truncate; a long chain of them drifts).  The online softmax runs on
//     the accumulator fragment (two shuffles a row, exp2f with log2(e)
//     folded into one FMA); P stays float32 and is split in registers as
//     the A operand of P V, its keys permuted within each 8-key group
//     (C fragment column 2c -> k-index c, 2c + 1 -> c + 4), so V's B
//     fragment reads rows 2c and 2c + 1; the running sum adds the
//     unsplit P, as attention_plain's denominator does.
//   * O = alpha O + P V: each output n-tile's sum over the tile's keys in
//     a fresh accumulator (lo * hi, hi * lo, hi * hi a k-step), added to
//     O by one FMA with the softmax's rescale.
//   * No atomics, a fixed order of every sum: equal inputs give equal
//     bits.  Tile sizes per D bucket (WARPS, BK): D <= 96 (8, 32), 112
//     (8, 16), 128 (4, 32), 256 (8, 16, one block an SM); 89,088 B of
//     shared memory at D = 112, 101,376 at 128.
//
// Measured (chip_smoke.py; profiler device time a call in zamba2-7b's bf16
// prefill at (1, 32, 4096, 112) causal, NVIDIA H100 80GB HBM3, 700 W):
// 0.538038 ms, 224 TFLOP/s, 4.4x the bound; scaled_dot_product_attention
// took 0.305712 ms on the same card (PERF.md).

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

constexpr int kMaxD = 256;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

template <int KD, int WARPS, int MR, int BK>
struct MmaTile {
  static constexpr int DP = 16 * KD;       // padded head dim
  static constexpr int LD = DP + 8;        // shared row stride (elements)
  static constexpr int WQ = 16 * MR;       // query rows per warp
  static constexpr int BQ = WQ * WARPS;    // query rows per block
  static constexpr int NT = BK / 8;        // score n-tiles per key tile
  static constexpr int OT = DP / 8;        // output n-tiles
  static constexpr int kThreads = 32 * WARPS;
  static constexpr size_t kSmem = sizeof(bf16) * LD * (BQ + 4 * BK);
  static_assert(BK % 16 == 0, "P V takes 16 keys a k-step");
};

// rows [row0, row0 + ROWS) of a row-major [nrows, d] bf16 matrix into
// dst[ROWS][LD], zero past nrows and from d to DP.  vec: 16-byte cp.async
// (d % 8 == 0 and aligned rows), else plain loads.
template <int ROWS, int DP, int LD, int THREADS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int row0, int nrows, int d,
                                           bool vec) {
  if (vec) {
    constexpr int CH = DP / 8;             // 16-byte chunks a row
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = (i - r * CH) * 8;
      bf16* dp = dst + r * LD + c;
      if (c < d) {
        const bool ok = row0 + r < nrows;
        cp_async_16(dp, ok ? src + int64_t(row0 + r) * d + c : src,
                    ok ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(dp) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i - r * DP;
      bf16 val = __float2bfloat16(0.f);
      if (row0 + r < nrows && c < d) val = src[int64_t(row0 + r) * d + c];
      dst[r * LD + c] = val;
    }
  }
}

template <int KD, int WARPS, int MR, int BK>
__global__ void __launch_bounds__(32 * WARPS)
flash_attention_kernel_mma(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           int hq, int group, int sq, int sk, int d,
                           int causal, int64_t window, float scale, int vec) {
  using Tl = MmaTile<KD, WARPS, MR, BK>;
  constexpr int LD = Tl::LD, BQ = Tl::BQ, NT = Tl::NT, OT = Tl::OT;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);   // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                       // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                   // [2][BK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;                     // b * hq + h
  const int b = bh / hq, h = bh - b * hq;
  const int64_t kv_bh = int64_t(b) * (hq / group) + h / group;
  const int q_tile = causal ? int(gridDim.y - 1 - blockIdx.y)
                            : int(blockIdx.y);
  const int q0 = q_tile * BQ;
  const int q_offset = sk - sq;                  // queries end the timeline
  const bf16* qp = q + int64_t(bh) * sq * d;
  const bf16* kp = k + kv_bh * sk * d;
  const bf16* vp = v + kv_bh * sk * d;
  bf16* op = out + int64_t(bh) * sq * d;

  // key-tile range intersecting the block's band (kernel.py:44-50)
  const int n_tiles = (sk + BK - 1) / BK;
  const int blk_hi = min(q0 + BQ, sq) - 1 + q_offset;
  int hi = n_tiles;
  if (causal) hi = blk_hi < 0 ? 0 : min(blk_hi / BK + 1, n_tiles);
  int lo = 0;
  if (window >= 0) {
    const int64_t first = int64_t(q0 + q_offset) - window + 1;
    lo = first <= 0 ? 0 : int(min(first / BK, int64_t(n_tiles)));
  }

  // the warp's rows and their positions on the key timeline
  const int wq0 = q0 + Tl::WQ * warp;
  const bool w_live = wq0 < sq;
  const int w_lo = wq0 + q_offset;
  const int w_hi = min(wq0 + Tl::WQ - 1, sq - 1) + q_offset;

  stage_rows<BQ, Tl::DP, LD, Tl::kThreads>(Qs, qp, q0, sq, d, vec);
  if (lo < hi) {
    stage_rows<BK, Tl::DP, LD, Tl::kThreads>(Ks, kp, lo * BK, sk, d, vec);
    stage_rows<BK, Tl::DP, LD, Tl::kThreads>(Vs, vp, lo * BK, sk, d, vec);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  {  // q * bf16(scale), rounded to bf16 (attention_plain's pre-scale)
    const float sc = __bfloat162float(__float2bfloat16(scale));
    for (int i = threadIdx.x; i < BQ * LD; i += Tl::kThreads)
      Qs[i] = __float2bfloat16(__bfloat162float(Qs[i]) * sc);
  }
  __syncthreads();

  // ldmatrix row addresses of the lane: Q (A, 16 x 16), K (non-trans,
  // 16 keys x 16 dims as two B fragments), V (trans, 16 keys x 16 dims)
  const bf16* q_row = Qs + (Tl::WQ * warp + (lane & 15)) * LD + (lane >> 4) * 8;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;

  float m[MR][2], l[MR][2], acc[MR][OT][4];
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
    m[mr][0] = m[mr][1] = -INFINITY;
    l[mr][0] = l[mr][1] = 0.f;
#pragma unroll
    for (int n = 0; n < OT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mr][n][e] = 0.f;
  }

  for (int t = lo; t < hi; ++t) {
    const int st = (t - lo) & 1;
    if (t + 1 < hi) {
      stage_rows<BK, Tl::DP, LD, Tl::kThreads>(Ks + (st ^ 1) * BK * LD, kp,
                                               (t + 1) * BK, sk, d, vec);
      stage_rows<BK, Tl::DP, LD, Tl::kThreads>(Vs + (st ^ 1) * BK * LD, vp,
                                               (t + 1) * BK, sk, d, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();                  // tile t has landed
    __syncthreads();

    const int k0 = t * BK;
    bool visible = w_live;
    if (causal) visible = visible && k0 <= w_hi;
    if (window >= 0)
      visible = visible && int64_t(k0 + BK - 1) > int64_t(w_lo) - window;
    if (visible) {
      const bf16* Kt = Ks + st * BK * LD;
      const bf16* Vt = Vs + st * BK * LD;
      float s[MR][NT][4];
#pragma unroll
      for (int mr = 0; mr < MR; ++mr)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mr][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[MR][4];
#pragma unroll
        for (int mr = 0; mr < MR; ++mr)
          ldmatrix_x4(a[mr], q_row + 16 * mr * LD + 16 * kk);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, Kt + (8 * j + k_row) * LD + 16 * kk + k_col);
#pragma unroll
          for (int mr = 0; mr < MR; ++mr) {
            mma_bf16_16816(s[mr][j], a[mr], bk[0], bk[1]);
            mma_bf16_16816(s[mr][j + 1], a[mr], bk[2], bk[3]);
          }
        }
      }

      const bool edge =
          k0 + BK > sk || (causal && k0 + BK - 1 > w_lo) ||
          (window >= 0 && int64_t(k0) <= int64_t(w_hi) - window);
      if (edge) {
#pragma unroll
        for (int mr = 0; mr < MR; ++mr)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpos = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
              const int qpos =
                  wq0 + 16 * mr + (lane >> 2) + 8 * (e >> 1) + q_offset;
              bool ok = kpos < sk;
              if (causal) ok = ok && kpos <= qpos;
              if (window >= 0)
                ok = ok && int64_t(kpos) > int64_t(qpos) - window;
              if (!ok) s[mr][j][e] = -INFINITY;
            }
      }

      // online softmax on the fragment: rows g (e = 0, 1), g + 8 (2, 3)
#pragma unroll
      for (int mr = 0; mr < MR; ++mr) {
        float mx[2] = {m[mr][0], m[mr][1]};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[mr][j][0], s[mr][j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[mr][j][2], s[mr][j][3]));
        }
        float msc[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          msc[r] = (mx[r] == -INFINITY ? 0.f : mx[r]) * kLog2e;
          const float alpha = fast_exp2(fmaf(m[mr][r], kLog2e, -msc[r]));
          m[mr][r] = mx[r];
          l[mr][r] *= alpha;
#pragma unroll
          for (int n = 0; n < OT; ++n) {
            acc[mr][n][2 * r] *= alpha;
            acc[mr][n][2 * r + 1] *= alpha;
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mr][j][e] = fast_exp2(fmaf(s[mr][j][e], kLog2e, -msc[e >> 1]));
            l[mr][e >> 1] += s[mr][j][e];
          }
      }

      // O += P V, P rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[MR][4];
#pragma unroll
        for (int mr = 0; mr < MR; ++mr) {
          a[mr][0] = pack_bf16x2(s[mr][2 * kk][0], s[mr][2 * kk][1]);
          a[mr][1] = pack_bf16x2(s[mr][2 * kk][2], s[mr][2 * kk][3]);
          a[mr][2] = pack_bf16x2(s[mr][2 * kk + 1][0], s[mr][2 * kk + 1][1]);
          a[mr][3] = pack_bf16x2(s[mr][2 * kk + 1][2], s[mr][2 * kk + 1][3]);
        }
#pragma unroll
        for (int n = 0; n < OT; n += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, Vt + (16 * kk + v_row) * LD + 8 * n + v_col);
#pragma unroll
          for (int mr = 0; mr < MR; ++mr) {
            mma_bf16_16816(acc[mr][n], a[mr], bv[0], bv[1]);
            mma_bf16_16816(acc[mr][n + 1], a[mr], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();                     // stage st free for tile t + 2
  }

  if (!w_live) return;
#pragma unroll
  for (int mr = 0; mr < MR; ++mr)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mr][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float inv = 1.f / lr;
      const int row = wq0 + 16 * mr + (lane >> 2) + 8 * r;
      if (row >= sq) continue;
      bf16* orow = op + int64_t(row) * d;
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        const int c = 8 * n + 2 * (lane & 3);
        const float v0 = acc[mr][n][2 * r] * inv;
        const float v1 = acc[mr][n][2 * r + 1] * inv;
        if ((d & 1) == 0 && c + 1 < d) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < d) orow[c] = __float2bfloat16(v0);
          if (c + 1 < d) orow[c + 1] = __float2bfloat16(v1);
        }
      }
    }
}

template <int KD, int WARPS, int MR, int BK>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int64_t b, int64_t hq, int64_t hkv, int64_t sq, int64_t sk,
               int64_t d, int64_t causal, int64_t window, float scale,
               cudaStream_t stream) {
  using Tl = MmaTile<KD, WARPS, MR, BK>;
  const int64_t n_qt = (sq + Tl::BQ - 1) / Tl::BQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_kernel_mma<KD, WARPS, MR, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Tl::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  const int vec = d % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  dim3 grid(unsigned(b * hq), unsigned(n_qt));
  kernel<<<grid, Tl::kThreads, Tl::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), int(hq),
      int(hq / hkv), int(sq), int(sk), int(d), int(causal), window, scale,
      vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mma(const void* q, const void* k, const void* v, void* out,
                 int64_t b, int64_t hq, int64_t hkv, int64_t sq, int64_t sk,
                 int64_t d, int64_t causal, int64_t window, float scale,
                 cudaStream_t stream) {
  if (d <= 32)
    return launch_mma<2, 4, 2, 64>(q, k, v, out, b, hq, hkv, sq, sk,
                                          d, causal, window, scale, stream);
  if (d <= 64)
    return launch_mma<4, 4, 2, 64>(q, k, v, out, b, hq, hkv, sq, sk,
                                          d, causal, window, scale, stream);
  if (d <= 112)
    return launch_mma<7, 4, 2, 64>(q, k, v, out, b, hq, hkv, sq, sk,
                                          d, causal, window, scale, stream);
  if (d <= 128)
    return launch_mma<8, 4, 2, 64>(q, k, v, out, b, hq, hkv, sq, sk,
                                          d, causal, window, scale, stream);
  return launch_mma<16, 8, 1, 32>(q, k, v, out, b, hq, hkv, sq, sk,
                                         d, causal, window, scale, stream);
}

// ---------------------------------------------------------------------------
// float32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

template <int KD, int WARPS, int BK>
struct Tf32Tile {
  static constexpr int DP = 8 * KD;        // padded head dim
  static constexpr int LD = DP + 4;        // shared row stride (floats)
  static constexpr int BQ = 16 * WARPS;    // query rows per block
  static constexpr int NT = BK / 8;        // score n-tiles = P V k-steps
  static constexpr int kThreads = 32 * WARPS;
  // Q; K and V (their hi parts after the split); K's and V's lo parts
  static constexpr size_t kSmem = sizeof(float) * LD * (BQ + 4 * BK);
  static_assert(BK % 16 == 0, "K fragments come 16 keys an ldmatrix");
};

// rows [row0, row0 + ROWS) of a row-major [nrows, d] float32 matrix into
// dst[ROWS][LD], zero past nrows and from d to DP.  vec: 16-byte cp.async
// (d % 4 == 0 and aligned rows), else plain loads.
template <int ROWS, int DP, int LD, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int row0, int nrows, int d,
                                           bool vec) {
  if (vec) {
    constexpr int CH = DP / 4;             // 16-byte chunks a row
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = (i - r * CH) * 4;
      float* dp = dst + r * LD + c;
      if (c < d) {
        const bool ok = row0 + r < nrows;
        cp_async_16(dp, ok ? src + int64_t(row0 + r) * d + c : src,
                    ok ? 16 : 0);
      } else {
        *reinterpret_cast<float4*>(dp) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i - r * DP;
      float val = 0.f;
      if (row0 + r < nrows && c < d) val = src[int64_t(row0 + r) * d + c];
      dst[r * LD + c] = val;
    }
  }
}

// MINB: the blocks an SM that the registers must allow (the shared memory
// allows them)
template <int KD, int WARPS, int BK, int MINB>
__global__ void __launch_bounds__(32 * WARPS, MINB)
flash_attention_kernel_tf32(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ out, int hq, int group,
                            int sq, int sk, int d, int causal,
                            int64_t window, float scale, int vec) {
  using Tl = Tf32Tile<KD, WARPS, BK>;
  constexpr int DP = Tl::DP, LD = Tl::LD, BQ = Tl::BQ, NT = Tl::NT;
  constexpr int TH = Tl::kThreads;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* Qs = reinterpret_cast<float*>(fa_smem);   // [BQ][LD]
  float* Kh = Qs + BQ * LD;                        // [BK][LD] each
  float* Vh = Kh + BK * LD;
  float* Kl = Vh + BK * LD;
  float* Vl = Kl + BK * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x;                       // b * hq + h
  const int b = bh / hq, h = bh - b * hq;
  const int64_t kv_bh = int64_t(b) * (hq / group) + h / group;
  const int q_tile = causal ? int(gridDim.y - 1 - blockIdx.y)
                            : int(blockIdx.y);
  const int q0 = q_tile * BQ;
  const int q_offset = sk - sq;                    // queries end the timeline
  const float* qp = q + int64_t(bh) * sq * d;
  const float* kp = k + kv_bh * sk * d;
  const float* vp = v + kv_bh * sk * d;
  float* op = out + int64_t(bh) * sq * d;

  // key-tile range intersecting the block's band (kernel.py:44-50)
  const int n_tiles = (sk + BK - 1) / BK;
  const int blk_hi = min(q0 + BQ, sq) - 1 + q_offset;
  int hi = n_tiles;
  if (causal) hi = blk_hi < 0 ? 0 : min(blk_hi / BK + 1, n_tiles);
  int lo = 0;
  if (window >= 0) {
    const int64_t first = int64_t(q0 + q_offset) - window + 1;
    lo = first <= 0 ? 0 : int(min(first / BK, int64_t(n_tiles)));
  }

  // the warp's 16 rows and their positions on the key timeline
  const int wq0 = q0 + 16 * warp;
  const bool w_live = wq0 < sq;
  const int w_lo = wq0 + q_offset;
  const int w_hi = min(wq0 + 15, sq - 1) + q_offset;

  // q * scale in float32 (attention_plain's pre-scale), zero past sq and d
  for (int i = threadIdx.x; i < BQ * DP; i += TH) {
    const int r = i / DP, col = i - r * DP;
    float x = 0.f;
    if (q0 + r < sq && col < d) x = qp[int64_t(q0 + r) * d + col] * scale;
    Qs[r * LD + col] = x;
  }

  // ldmatrix row addresses of the lane: Q (A, 16 rows x 8 dims), K (two
  // n-tiles: 16 keys x 8 dims as four 8 x 4 tiles)
  const float* q_row = Qs + (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) *
                       LD + (lane >> 4) * 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) * 4;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    stage_rows<BK, DP, LD, TH>(Kh, kp, k0, sk, d, vec);
    stage_rows<BK, DP, LD, TH>(Vh, vp, k0, sk, d, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    split_rows<BK, DP, LD, TH>(Kh, Kl);    // once for all the warps
    split_rows<BK, DP, LD, TH>(Vh, Vl);
    __syncthreads();

    bool visible = w_live;
    if (causal) visible = visible && k0 <= w_hi;
    if (window >= 0)
      visible = visible && int64_t(k0 + BK - 1) > int64_t(w_lo) - window;
    if (visible) {
      // S = (q * scale) K^T, 3xTF32: the hi * hi products in s, the small
      // terms (lo * hi, hi * lo) apart in sl, added once at the end
      float s[NT][4], sl[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t raw[4], ah[4], al[4];
        ldmatrix_x4(raw, q_row + 8 * kk);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(raw[e]), ah[e], al[e]);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t kh[4], kl[4];
          const int ko = (8 * j + k_row) * LD + 8 * kk + k_col;
          ldmatrix_x4(kh, Kh + ko);
          ldmatrix_x4(kl, Kl + ko);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            mma_tf32_1688(sl[j + p], al, kh[2 * p], kh[2 * p + 1]);
            mma_tf32_1688(sl[j + p], ah, kl[2 * p], kl[2 * p + 1]);
            mma_tf32_1688(s[j + p], ah, kh[2 * p], kh[2 * p + 1]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += sl[j][e];

      const bool edge =
          k0 + BK > sk || (causal && k0 + BK - 1 > w_lo) ||
          (window >= 0 && int64_t(k0) <= int64_t(w_hi) - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * c + (e & 1);
            const int qpos = wq0 + g + 8 * (e >> 1) + q_offset;
            bool ok = kpos < sk;
            if (causal) ok = ok && kpos <= qpos;
            if (window >= 0)
              ok = ok && int64_t(kpos) > int64_t(qpos) - window;
            if (!ok) s[j][e] = -INFINITY;
          }
      }

      // online softmax on the fragment: rows g (e = 0, 1), g + 8 (2, 3);
      // P split into hi and lo as the A operand of P V.  P's C fragment
      // of n-tile j is the A fragment of k-step j with its keys permuted
      // (k-index c <- key 2c, c + 4 <- key 2c + 1), so V's B fragment
      // takes rows 2c and 2c + 1.
      float mx[2] = {m[0], m[1]}, msc[2], alpha[2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        msc[r] = (mx[r] == -INFINITY ? 0.f : mx[r]) * kLog2e;
        alpha[r] = exp2f(fmaf(m[r], kLog2e, -msc[r]));
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
      uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(fmaf(s[j][e], kLog2e, -msc[e >> 1]));
          l[e >> 1] += s[j][e];
        }
        split_tf32(s[j][0], ph[j][0], pl[j][0]);
        split_tf32(s[j][2], ph[j][1], pl[j][1]);
        split_tf32(s[j][1], ph[j][2], pl[j][2]);
        split_tf32(s[j][3], ph[j][3], pl[j][3]);
      }

      // O = alpha O + P V, 3xTF32: each output n-tile's sum over the tile's
      // keys in a fresh accumulator (a short chain of mma), added to O by
      // one rounded FMA
      const int vo = 2 * c * LD + g;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int o0 = vo + 8 * j * LD + 8 * n, o1 = o0 + LD;
          mma_3xtf32(pv, ph[j], pl[j], __float_as_uint(Vh[o0]),
                     __float_as_uint(Vh[o1]), __float_as_uint(Vl[o0]),
                     __float_as_uint(Vl[o1]));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[e]);
      }
    }
    __syncthreads();                     // the tile's buffers free
  }

  if (!w_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / lr;
    const int row = wq0 + g + 8 * r;
    if (row >= sq) continue;
    float* orow = op + int64_t(row) * d;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      const int col = 8 * n + 2 * c;
      const float v0 = acc[n][2 * r] * inv;
      const float v1 = acc[n][2 * r + 1] * inv;
      if ((d & 1) == 0 && col + 1 < d) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
      } else {
        if (col < d) orow[col] = v0;
        if (col + 1 < d) orow[col + 1] = v1;
      }
    }
  }
}

template <int KD, int WARPS, int BK, int MINB>
int launch_tf32(const void* q, const void* k, const void* v, void* out,
                int64_t b, int64_t hq, int64_t hkv, int64_t sq, int64_t sk,
                int64_t d, int64_t causal, int64_t window, float scale,
                cudaStream_t stream) {
  using Tl = Tf32Tile<KD, WARPS, BK>;
  const int64_t n_qt = (sq + Tl::BQ - 1) / Tl::BQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_kernel_tf32<KD, WARPS, BK, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Tl::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  const int vec = d % 4 == 0 && aligned(k) && aligned(v);
  dim3 grid(unsigned(b * hq), unsigned(n_qt));
  kernel<<<grid, Tl::kThreads, Tl::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), int(hq),
      int(hq / hkv), int(sq), int(sk), int(d), int(causal), window, scale,
      vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_tf32(const void* q, const void* k, const void* v, void* out,
                  int64_t b, int64_t hq, int64_t hkv, int64_t sq, int64_t sk,
                  int64_t d, int64_t causal, int64_t window, float scale,
                  cudaStream_t s) {
  if (d <= 32)
    return launch_tf32<4, 8, 32, 2>(q, k, v, out, b, hq, hkv, sq, sk, d,
                                    causal, window, scale, s);
  if (d <= 64)
    return launch_tf32<8, 8, 32, 2>(q, k, v, out, b, hq, hkv, sq, sk, d,
                                    causal, window, scale, s);
  if (d <= 96)
    return launch_tf32<12, 8, 32, 2>(q, k, v, out, b, hq, hkv, sq, sk, d,
                                     causal, window, scale, s);
  if (d <= 112)
    return launch_tf32<14, 8, 16, 2>(q, k, v, out, b, hq, hkv, sq, sk, d,
                                     causal, window, scale, s);
  if (d <= 128)
    return launch_tf32<16, 4, 32, 2>(q, k, v, out, b, hq, hkv, sq, sk, d,
                                     causal, window, scale, s);
  return launch_tf32<32, 8, 16, 1>(q, k, v, out, b, hq, hkv, sq, sk, d,
                                   causal, window, scale, s);
}

}  // namespace

// q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D], out [B,Hq,Sq,D], all contiguous, of the
// element type `dtype`; window < 0 means no window.  Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int64_t b,
                                      int64_t hq, int64_t hkv, int64_t sq,
                                      int64_t sk, int64_t d, int64_t causal,
                                      int64_t window, float scale,
                                      int64_t dtype, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0 || d <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || sk < 0 || d > kMaxD ||
      b * hq > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return dispatch_tf32(q, k, v, out, b, hq, hkv, sq, sk, d, causal, window,
                         scale, s);
  if (dtype == DT_BF16)
    return dispatch_mma(q, k, v, out, b, hq, hkv, sq, sk, d, causal, window,
                        scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
