// rwkv6_wkv: the RWKV6 (Finch) WKV recurrence for Hopper (sm_90a), a
// float32 [K, V] state per (batch, head).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_wkv/kernel.py:_wkv6_kernel (launcher wkv6 at
//   :55, pallas_call at :74);
// its plain PyTorch version is
//   repro_torch.kernels.rwkv6_wkv.ops.wkv6_plain
// (wkv6_ref's sequential scan), and chip_smoke.py holds the two together on
// the card.  Per (batch, head), with the head's bonus u:
//
//   y_t = sum_k r_t[k] (S[k, :] + u[k] k_t[k] v_t);
//   S  <- diag(w_t) S + k_t v_t^T
//
// Bound: bytes.  The function reads r, k, w and v once and writes y once:
// at rwkv6-7b's prefill shape (4096 tokens, 64 heads, K = V = 64, bf16)
// 167.8 MB, 0.050 ms at 3.35 TB/s.  The sequential form does 7 K V flops a
// step, 7.5 GFLOP (8 us at the bf16 tensor-core peak, 112 us on the
// float32 CUDA cores); in float32 at rwkv6-7b's train shape (2 x 1024
// tokens) the same 167.8 MB against 3.76 GFLOP, 0.023 ms at 3xTF32's
// 495/3 TFLOP/s.
//
// Two paths, picked by the element type:
//
// bfloat16: rwkv6_wkv_kernel_chunked, the chunked form on the tensor cores.
//   Per chunk of L = 64 steps entering with state S0, with P_t the product
//   of w_i over the chunk's steps i < t (per key k):
//     y_t = (r_t .* P_t)^T S0 + sum_{s<t} A[t, s] v_s + (sum_k r_t u k_t) v_t
//     A[t, s] = sum_k r_t[k] k_s[k] prod_{s<i<t} w_i[k]
//     S_L = P_L .* S0 + sum_s (k_s .* Q_s) v_s^T,  Q_s = prod_{s<i<L} w_i
//   * Stability.  The decay is a vector over K inside A's contraction, so
//     it has to be split between A's two operands at a reference step ref:
//     r_t .* prod_{ref<=i<t} w_i and k_s .* prod_{s<i<ref} w_i.  Both
//     factors are <= 1 only for s < ref <= t; one reference for the whole
//     chunk overflows as soon as decays are strong (w = 0 exactly happens
//     in bf16: the model's exp(-exp(x)), models/blocks.py).  Yang et al.
//     ("Gated Linear Attention Transformers with Hardware-Efficient
//     Training", 2023, section 4) cut the chunk into sub-chunks, factor the
//     pairs of different sub-chunks at a sub-chunk boundary and take the
//     diagonal blocks elementwise.  Here the cut is applied at every scale:
//     a pair (t, s) is factored at the start of the upper half of the
//     smallest aligned block of 2b steps that holds both, b = the highest
//     bit of t ^ s (b = 32, 16, 8, 4, 2, 1), where s < ref <= t always
//     holds.  For each level b one tile X_b holds, per row, the row's only
//     role at that level: r_t .* prod_{ref<=i<t} w_i if t is in its
//     block's upper half, else k_t .* prod_{t<i<ref} w_i; so the pairs of
//     level b are entries of X_b X_b^T, all on the tensor cores, and no
//     entry of A is taken elementwise.  Adjacent pairs (b = 1) carry no
//     decay, and the bonus is the diagonal of X_1 Y^T with Y's rows u k_t
//     (odd t) or u r_t (even t).  The factors are products of w in [0, 1],
//     not sums of log w: every factor lies in [0, 1], w = 0 gives exactly
//     0 and w = 1 exactly 1 (no clamp is needed), and nothing is divided
//     or exponentiated.  The products are taken from the start or to the
//     end of an 8-step half, and composed with the halves' totals.
//   * Parallelism: grid = (ceil(V / 32), H, B); a block owns 32 state
//     columns of one (batch, head) and walks its T / L chunks in order
//     (rwkv6-7b: 2 x 64 = 128 blocks on 132 SMs, one a SM).  A chunk's
//     operands depend only on the chunk, not on the columns, so the two
//     blocks of a head both compute them (no scratch in device memory).
//     The block's 16 warps are two groups, joined by one barrier a chunk:
//       - the producer (8 warps) reads chunk c + 1's r, k, w from device
//         memory into registers (thread: 2 keys x 8 steps) while it turns
//         chunk c's into an operand set of bf16 tiles in shared memory
//         (r P, k Q, Y, X_32 .. X_1), exchanging the 8-step halves' decay
//         totals through shared memory; it also stages v by cp.async;
//       - the consumer (8 warps) runs chunk c - 1's products from the
//         other operand set: warp (J, half) takes A's rows 16 J .. 16 J +
//         15, rounds them to bf16 in registers as the A operand of A V,
//         adds (r P) S0, stores its 16 x 16 tile of y, and carries S^T's
//         keys 16 J .. of its 16 columns.  The sub-chunks J and 3 - J
//         share a warp scheduler, which evens out their work.
//     The two groups take about as long as each other, and both are
//     latency-bound at 128 registers a thread (ptxas spills a few bytes).
//   * Products on mma.sync.m16n8k16 (bf16 operands, float32 accumulators).
//     The state is kept transposed (S^T [V x K]) in float32 registers
//     across chunks and is never rounded: the carry computes
//     S^T = P_L .* S^T + V^T (k .* Q) with V^T from ldmatrix.trans, and for
//     (r P) S its copy enters the mma as bf16 hi + lo parts in shared
//     memory (about 16 of its bits).  r, k, v are bf16 inputs; every factor
//     is <= 1; the operands and A are rounded to bf16 once each.
//   * Any T: steps past T are read as zeros (k = v = 0), so they move
//     neither y nor the state.  K <= 64, padded with zeros to a multiple of
//     16 (NK = K / 16, a template parameter); columns past V stay zero and
//     are not stored.  An odd K, or v rows not in 16-byte pieces, take
//     narrower loads.  Dynamic shared memory 202,240 B at K = 64 (v in a
//     ring of 3 chunks, two operand sets, the state's hi and lo twice).
//
// float32: rwkv6_wkv_kernel_tf32, the same chunked form on the tensor cores
//   in 3xTF32.  One TF32 product keeps 11 significant bits, which misses
//   the float32 tolerance of 1e-4; three keep about 22: each operand x is
//   split into hi = tf32(x) and lo = tf32(x - hi) (split_tf32,
//   mma_sm90.cuh), and a product is hi * hi plus the small terms lo * hi
//   and hi * lo, each a mma.sync.m16n8k8 with tf32 operands and float32
//   accumulators.
//   * Chunks of L = 32 steps; grid = (ceil(V / 64), H, B); a block of 8
//     warps owns 64 state columns of one (batch, head), so a head's chunk
//     operands are built once, and walks its chunks in order (rwkv6-7b's
//     train step: 128 blocks, one an SM).
//   * The pairs of A by levels, as above, with every factor a product of
//     w in float32: levels 16 and 8 (X_16, X_8) on the tensor cores, the
//     pairs closer than 8 steps (inside an aligned 8-step block) and the
//     bonus elementwise in float32 on the CUDA cores.
//   * A chunk, between four barriers: (1) warp (kq, j) takes the 8-step
//     block j, thread lane the key 32 kq + lane, its r, k, w read into
//     registers a chunk ahead: the block's decay for the others, and the
//     block's 28 pairs and 8 bonus terms, summed over the warp's keys by a
//     transposing butterfly of shuffles (a fixed order); (2) the two key
//     halves' sums added into A, the key tiles r P, k Q, X_16, X_8 as tf32
//     hi and lo planes; (3) one 16 x 8 tile of a level product a warp of
//     the first four into A (hi, lo); (4) warp (vw, kh), state columns
//     16 vw .. and keys KH kh .. (KH = K / 2 padded): y^T = S^T (r P)^T
//     over its keys (hi * hi apart from the small terms) plus V^T A^T for
//     its t-tiles (kh 0: 0 .. 2, kh 1: 3), the two halves' partials added
//     as y goes out a chunk later in float4 rows; the carry S^T = P_L .*
//     S^T + V^T (k Q) over its keys, the chunk's sum in a fresh
//     accumulator added by one FMA.  V^T's A fragments are split in
//     registers once for both products.  The state stays float32 in
//     registers across chunks and is never rounded: the carry's C
//     fragments, each 8-column group permuted, are the A fragments of S^T
//     (r P)^T.
//   * v by cp.async (double-buffered; whole rows without the source-size
//     operand, rows past T zeroed by stores; plain loads where V is not a
//     multiple of 4).  Every fragment read is conflict-free: float2 pairs
//     (2c, 2c + 1) of a row g, or rows c and c + 4, by the row strides.
//     Staging r, k and w by cp.async as well, in place of the registers,
//     was 5 % slower: the copies' issue cost the same.
//   * Any T (steps past T read as r = k = v = 0, w = 0), any V, K <= 64
//     padded with zeros to a multiple of 16 (NK = K / 16); dynamic shared
//     memory 120,640 B at K = 64 (one block an SM).
//   * No atomics, a fixed order of every sum: equal inputs give equal bits,
//     and a (batch, head)'s arithmetic does not depend on B, H or the grid.
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): the bf16 path
// at (1, 64, 4096, 64, 64), profiler device time a call in rwkv6-7b's bf16
// prefill, 0.206161 ms, 814 GB/s, 4.1x the byte bound (the sequential form
// took 0.679579 ms).  Float32 at rwkv6-7b's train shape (2, 64, 1024, 64,
// 64): see PERF.md (the sequential kernel it replaced took 0.388-0.446 ms
// a call).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;
using bf16 = __nv_bfloat16;

// Element types; the codes are repro_torch.kernels._build.DTYPE_CODES,
// pinned by tests/test_torch_kernel_layout.py.
enum DType { DT_F32 = 0, DT_BF16 = 1 };

constexpr int kMaxK = 64;

// ---------------------------------------------------------------------------
// bfloat16: the chunked form on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kL = 64;                   // chunk length
constexpr int kSub = 16;                 // a consumer warp's rows
constexpr int kNSub = kL / kSub;
constexpr int kHalf = kSub / 2;          // a producer thread's rows
constexpr int kLevels = 6;               // reference levels b = 32 .. 1
constexpr int kPB = 32;                  // state columns per block
constexpr int kGroupThreads = 256;       // 8 warps a group
constexpr int kChunkThreads = 2 * kGroupThreads;
constexpr int kLDV = kPB + 8;            // shared row stride of v
static_assert(kGroupThreads == 32 * kNSub * 2,
              "each warp of a group takes one (sub-chunk, half)");
static_assert(kL == 2 << (kLevels - 1), "levels 32 .. 1 cover the chunk");

// an operand set's [L][LDK] tiles (bf16), by index
constexpr int T_RP = 0;  // r_t P_t, for (r P) S0
constexpr int T_KQ = 1;  // k_s Q_s, for the carry
constexpr int T_Y = 2;   // the bonus partner of X_1: u k_t (odd t), u r_t
constexpr int T_X = 3;   // X_b for b = 32 >> (tile - T_X): rows in the
                         // upper half of their 2b-block hold r_t prod_{ref
                         // <= i < t} w_i, the others k_t prod_{t < i < ref}
                         // w_i (ref: the upper half's start)
constexpr int kTiles = T_X + kLevels;

template <int NK>
struct ChunkSmem {
  static constexpr int KP = 16 * NK;     // padded key dim
  static constexpr int LDK = KP + 8;     // shared row stride of key rows
  static constexpr int kVs = kL * kLDV;       // a chunk's v
  static constexpr int kOps = kTiles * kL * LDK;  // an operand set
  static constexpr size_t kBytes =
      sizeof(bf16) * (3 * kVs + 2 * kOps    // v ring, two operand sets
                      + 4 * kPB * LDK)      // S^T hi, lo, two buffers
      + sizeof(float) * (2 * KP             // the chunk's decay P_L, x2
                         + 2 * kNSub * KP); // the halves' decays
};

// rows [t0, t0 + L) of an [T, *]-strided matrix, `cols` real columns, into
// dst[L][ld] as bf16, width `width` (a multiple of 8), zero past T and past
// cols, by the producer warps.  vec: 16-byte cp.async, else plain loads.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, int width,
                                           const bf16* src,
                                           int64_t row_stride, int t0,
                                           int t_len, int cols, bool vec) {
  if (vec) {
    const int ch = width / 8;
    for (int i = threadIdx.x; i < kL * ch; i += kGroupThreads) {
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
    for (int i = threadIdx.x; i < kL * width; i += kGroupThreads) {
      const int r = i / width, c = i - r * width;
      bf16 val = __float2bfloat16(0.f);
      if (t0 + r < t_len && c < cols) val = src[(t0 + r) * row_stride + c];
      dst[r * ld + c] = val;
    }
  }
}

__device__ __forceinline__ float2 mul2(float2 a, float2 b) {
  return make_float2(a.x * b.x, a.y * b.y);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// a .* f rounded to bf16 into dst (two keys)
__device__ __forceinline__ void put2(bf16* dst, float2 a, float2 f) {
  *reinterpret_cast<__nv_bfloat162*>(dst) =
      __floats2bfloat162_rn(a.x * f.x, a.y * f.y);
}

template <int NK>
__global__ void __launch_bounds__(kChunkThreads, 1)
rwkv6_wkv_kernel_chunked(const bf16* __restrict__ r,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ w,
                         const float* __restrict__ u, bf16* __restrict__ y,
                         int t_len, int h_heads, int k_dim, int v_dim,
                         int k_pair, int v_vec) {
  using Sm = ChunkSmem<NK>;
  constexpr int KP = Sm::KP, LDK = Sm::LDK, TL = kL * LDK;
  extern __shared__ __align__(16) unsigned char wkv_smem[];
  bf16* vst0 = reinterpret_cast<bf16*>(wkv_smem);  // [3][L][kLDV]
  bf16* ops0 = vst0 + 3 * Sm::kVs;                 // [2][kTiles][L][LDK]
  bf16* Sst = ops0 + 2 * Sm::kOps;                 // [2][hi, lo][kPB][LDK]
  float* gc0 = reinterpret_cast<float*>(Sst + 4 * kPB * LDK);  // [2][KP]
  float* gh = gc0 + 2 * KP;                        // [8 halves][KP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int v0 = blockIdx.x * kPB;
  const int h = blockIdx.y;
  const int64_t bh = int64_t(blockIdx.z) * h_heads + h;
  const bf16* vb = v + bh * t_len * v_dim + v0;
  bf16* yb = y + bh * t_len * v_dim + v0;
  const int v_cols = min(kPB, v_dim - v0);
  const int n_chunks = (t_len + kL - 1) / kL;
  auto vst = [&](int c) { return vst0 + (c % 3) * Sm::kVs; };
  auto ops = [&](int c) { return ops0 + (c & 1) * Sm::kOps; };
  // a warp's scheduler is warp % 4: each scheduler gets the sub-chunks J
  // and 3 - J of a group (even work)
  const int sched = warp % 4, upper = (warp / 4) % 2;
  const int sj = upper ? kNSub - 1 - sched % 2 : sched % 2, shalf = sched / 2;

  for (int i = tid; i < 4 * kPB * LDK; i += kChunkThreads)
    Sst[i] = __float2bfloat16(0.f);

  if (warp < kGroupThreads / 32) {
    // ---- producer: the operands of chunk c in iteration c ----
    // thread (keys 2 pk, 2 pk + 1; sub-chunk pj; half ph): chunk rows
    // h0 .. h0 + 7, read from device memory into registers a chunk ahead
    const int pk = lane, pj = sj, ph = shalf, h0 = kSub * pj + kHalf * ph;
    const bool p_on = 2 * pk < KP;
    const int64_t koff = bh * t_len * k_dim + 2 * pk;
    float2 uu = make_float2(0.f, 0.f);
    if (2 * pk < k_dim) uu.x = u[int64_t(h) * k_dim + 2 * pk];
    if (2 * pk + 1 < k_dim) uu.y = u[int64_t(h) * k_dim + 2 * pk + 1];
    uint32_t nr[kHalf], nk[kHalf], nw[kHalf];   // bf16 pairs, next chunk
    auto fetch = [&](int c) {
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const int t = c * kL + h0 + i;
        nr[i] = nk[i] = nw[i] = 0u;
        if (t >= t_len || 2 * pk >= k_dim) continue;
        const int64_t off = koff + int64_t(t) * k_dim;
        if (k_pair) {
          nr[i] = *reinterpret_cast<const uint32_t*>(r + off);
          nk[i] = *reinterpret_cast<const uint32_t*>(k + off);
          nw[i] = *reinterpret_cast<const uint32_t*>(w + off);
        } else {
          const bool two = 2 * pk + 1 < k_dim;
          auto pair = [&](const bf16* p) {
            const bf16 zero = __float2bfloat16(0.f);
            __nv_bfloat162 b2;
            b2.x = p[off];
            b2.y = two ? p[off + 1] : zero;
            return *reinterpret_cast<uint32_t*>(&b2);
          };
          nr[i] = pair(r);
          nk[i] = pair(k);
          nw[i] = pair(w);
        }
      }
    };
    auto issue_v = [&](int c) {
      stage_rows(vst(c), kLDV, kPB, vb, v_dim, c * kL, t_len, v_cols, v_vec);
    };

    fetch(0);
    issue_v(0);
    cp_async_commit();
    for (int c = 0; c < n_chunks; ++c) {
      uint32_t cr[kHalf], ck[kHalf];
      float2 wv[kHalf];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        cr[i] = nr[i];
        ck[i] = nk[i];
        wv[i] = unpack2(nw[i]);
      }
      if (c + 1 < n_chunks) {
        fetch(c + 1);                    // in flight during this chunk
        issue_v(c + 1);
      }
      cp_async_commit();
      cp_async_wait<1>();                // chunk c's v has landed

      // the half's decay prod_i w_i, for the other threads
      float2 hw = make_float2(1.f, 1.f);
#pragma unroll
      for (int i = 0; i < kHalf; ++i) hw = mul2(hw, wv[i]);
      if (p_on)
        *reinterpret_cast<float2*>(gh + (2 * pj + ph) * KP + 2 * pk) = hw;
      named_barrier_sync(1, kGroupThreads);

      if (p_on) {
        const float2 one = make_float2(1.f, 1.f);
        float2 H[2 * kNSub], G[kNSub];
#pragma unroll
        for (int j = 0; j < 2 * kNSub; ++j)
          H[j] = *reinterpret_cast<const float2*>(gh + j * KP + 2 * pk);
        // prod G before and after pj; the other half's decay (p_t = hp pr,
        // suf_s = sfh hs); the factor of level 32 beyond the sub-chunk
        float2 pre = one, post = one, hp = one, hs = one, g32 = one;
#pragma unroll
        for (int j = 0; j < kNSub; ++j) {
          G[j] = mul2(H[2 * j], H[2 * j + 1]);
          if (j < pj) pre = mul2(pre, G[j]);
          if (j > pj) post = mul2(post, G[j]);
          if (j == pj) {
            if (ph) hp = H[2 * j];
            else hs = H[2 * j + 1];
          }
        }
        if (pj == 0) g32 = G[1];
        if (pj == kNSub - 1) g32 = G[2];
        if (pj == 0 && ph == 0)
          *reinterpret_cast<float2*>(gc0 + (c & 1) * KP + 2 * pk) =
              mul2(mul2(G[0], G[1]), mul2(G[2], G[3]));
        float2 sfh[kHalf];               // prod_{i < j < 8} w_j
        sfh[kHalf - 1] = one;
#pragma unroll
        for (int i = kHalf - 1; i > 0; --i) sfh[i - 1] = mul2(sfh[i], wv[i]);
        bf16* O = ops(c) + h0 * LDK + 2 * pk;
        float2 pr = one;                 // prod_{0 <= j < i} w_j
        float2 p4 = one;                 // prod_{4 <= j < i} w_j, i >= 4
#pragma unroll
        for (int i = 0; i < kHalf; ++i) {
          const float2 rv = unpack2(cr[i]), kv = unpack2(ck[i]);
          const float2 p = mul2(hp, pr), suf = mul2(sfh[i], hs);
          bf16* row = O + i * LDK;
          put2(row + T_RP * TL, rv, mul2(pre, p));
          put2(row + T_KQ * TL, kv, mul2(suf, post));
          put2(row + T_Y * TL, i % 2 ? kv : rv, uu);
          // X_32, X_16: sub-chunks 2, 3 and 1, 3 are upper
          if (pj >= 2) put2(row + (T_X + 0) * TL, rv, mul2(g32, p));
          else put2(row + (T_X + 0) * TL, kv, mul2(g32, suf));
          if (pj % 2) put2(row + (T_X + 1) * TL, rv, p);
          else put2(row + (T_X + 1) * TL, kv, suf);
          // X_8: the second half is upper
          if (ph) put2(row + (T_X + 2) * TL, rv, pr);
          else put2(row + (T_X + 2) * TL, kv, sfh[i]);
          // X_4, X_2, X_1 inside the half
          if (i >= 4) {
            put2(row + (T_X + 3) * TL, rv, p4);
            p4 = mul2(p4, wv[i]);
          } else {
            float2 s4 = one;
#pragma unroll
            for (int j = i + 1; j < 4; ++j) s4 = mul2(s4, wv[j]);
            put2(row + (T_X + 3) * TL, kv, s4);
          }
          if (i % 4 >= 2)
            put2(row + (T_X + 4) * TL, rv,
                 i % 4 == 3 ? wv[(i + kHalf - 1) % kHalf] : one);
          else
            put2(row + (T_X + 4) * TL, kv,
                 i % 4 == 0 ? wv[(i + 1) % kHalf] : one);
          put2(row + (T_X + 5) * TL, i % 2 ? rv : kv, one);
          pr = mul2(pr, wv[i]);
        }
      }
      named_barrier_sync(0, kChunkThreads);
    }
    named_barrier_sync(0, kChunkThreads);
  } else {
    // ---- consumer: the products of chunk c in iteration c + 1 ----
    // warp (mj, mv) = (rows 16 mj .., columns 16 mv .. of the block's 32)
    const int mj = sj, mv = shalf;
    const int g = lane >> 2, cq = lane & 3;
    // ldmatrix lane offsets: A (16 x 16, row-major), B from [n][k] rows
    // (non-trans), B from [k][n] rows (trans), A from [k][m] rows (trans)
    const int a_row = lane & 15, a_col = (lane >> 4) * 8;
    const int bn_row = (lane & 7) + ((lane >> 4) << 3),
              bn_col = ((lane >> 3) & 1) * 8;
    const int bt_row = (lane & 7) + ((lane >> 3) & 1) * 8,
              bt_col = (lane >> 4) * 8;
    const int at_row = (lane & 7) + ((lane >> 4) & 1) * 8,
              at_col = ((lane >> 3) & 1) * 8;
    float S[2][4];                       // S^T [16 mv + .., 16 mj + ..]
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[n][e] = 0.f;
    // rows 16 mj .. of xa times rows 16 jc .. of xb, keys contracted:
    // n-tiles 8 jc' .. (nt of them) into acc
    auto product = [&](const bf16* xa, const bf16* xb, int jc, int nt,
                       float (*acc)[4]) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, xa + (kSub * mj + a_row) * LDK + 16 * kk + a_col);
        ldmatrix_x4(bb, xb + (kSub * jc + bn_row) * LDK + 16 * kk + bn_col);
        mma_bf16_16816(acc[0], a, bb[0], bb[1]);
        if (nt > 1) mma_bf16_16816(acc[1], a, bb[2], bb[3]);
      }
    };

    named_barrier_sync(0, kChunkThreads);
    for (int c = 0; c < n_chunks; ++c) {
      const int st = c & 1;
      const bf16* O = ops(c);
      const bf16* Vt = vst(c);
      // A[t, s] for the rows of sub-chunk mj, n-tiles of 8 s: a pair in
      // different sub-chunks from X_32 or X_16 (the highest bit of
      // t ^ s), the diagonal block's pairs from X_8 .. X_1, its diagonal
      // (the bonus) from X_1 Y^T
      float sc[2 * kNSub][4];
#pragma unroll
      for (int j = 0; j < 2 * kNSub; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int jc = 0; jc < kNSub - 1; ++jc) {
        if (jc < mj) {
          const bf16* X = O + (T_X + ((mj ^ jc) >= 2 ? 0 : 1)) * TL;
          product(X, X, jc, 2, &sc[2 * jc]);
        }
      }
      float dg[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dg[n][e] = 0.f;
#pragma unroll
      for (int lv = 0; lv <= 4; ++lv) {  // b = 8, 4, 2, 1; the bonus
        const bf16* xa = O + (T_X + 2 + (lv < 4 ? lv : 3)) * TL;
        const bf16* xb = lv < 4 ? xa : O + T_Y * TL;
        float tmp[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) tmp[n][e] = 0.f;
        product(xa, xb, mj, lv == 0 ? 1 : 2, tmp);
        const int b = 8 >> lv;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tl = g + 8 * (e >> 1), sl = 8 * hh + 2 * cq + (e & 1);
            const int x = tl ^ sl;
            const bool take = lv == 4 ? x == 0
                                      : sl < tl && x >= b && x < 2 * b;
            if (take) dg[hh][e] = tmp[hh][e];
          }
      }
#pragma unroll
      for (int j = 0; j < kNSub; ++j) {
        if (j == mj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[2 * j][e] = dg[0][e];
            sc[2 * j + 1][e] = dg[1][e];
          }
        }
      }
      float yo[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yo[n][e] = 0.f;
      // A V over the keys s <= 16 mj + 15
#pragma unroll
      for (int kk = 0; kk < kNSub; ++kk) {
        if (kk <= mj) {
          const float(&lo)[4] = sc[2 * kk];
          const float(&hi)[4] = sc[2 * kk + 1];
          const uint32_t a[4] = {pack_bf16x2(lo[0], lo[1]),
                                 pack_bf16x2(lo[2], lo[3]),
                                 pack_bf16x2(hi[0], hi[1]),
                                 pack_bf16x2(hi[2], hi[3])};
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, Vt + (16 * kk + bt_row) * kLDV + 16 * mv +
                                    bt_col);
          mma_bf16_16816(yo[0], a, bb[0], bb[1]);
          mma_bf16_16816(yo[1], a, bb[2], bb[3]);
        }
      }
      // (r P) S0, S^T as bf16 hi + lo
      const bf16* Sh = Sst + st * 2 * kPB * LDK;
      const bf16* Sl = Sh + kPB * LDK;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t a[4], bh[4], bl[4];
        ldmatrix_x4(a, O + T_RP * TL + (kSub * mj + a_row) * LDK + 16 * kk +
                           a_col);
        const int off = (16 * mv + bn_row) * LDK + 16 * kk + bn_col;
        ldmatrix_x4(bh, Sh + off);
        ldmatrix_x4(bl, Sl + off);
        mma_bf16_16816(yo[0], a, bh[0], bh[1]);
        mma_bf16_16816(yo[1], a, bh[2], bh[3]);
        mma_bf16_16816(yo[0], a, bl[0], bl[1]);
        mma_bf16_16816(yo[1], a, bl[2], bl[3]);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int t = c * kL + kSub * mj + g + 8 * rr;
        if (t >= t_len) continue;
        bf16* yrow = yb + int64_t(t) * v_dim;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = 16 * mv + 8 * n + 2 * cq;
          const float y0 = yo[n][2 * rr], y1 = yo[n][2 * rr + 1];
          if ((v_dim & 1) == 0 && col + 1 < v_cols) {
            *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
                __floats2bfloat162_rn(y0, y1);
          } else {
            if (col < v_cols) yrow[col] = __float2bfloat16(y0);
            if (col + 1 < v_cols) yrow[col + 1] = __float2bfloat16(y1);
          }
        }
      }

      // carry: S^T[v, k] = P_L[k] S^T[v, k] + sum_s v_s[v] k_s[k] Q_s[k]
      if (mj < NK) {
        const float* gc = gc0 + st * KP;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float decay = gc[kSub * mj + 8 * n + 2 * cq + e];
            S[n][e] *= decay;
            S[n][e + 2] *= decay;
          }
#pragma unroll
        for (int kk = 0; kk < kNSub; ++kk) {
          uint32_t a[4], bb[4];
          ldmatrix_x4_trans(a, Vt + (16 * kk + at_row) * kLDV + 16 * mv +
                                   at_col);
          ldmatrix_x4_trans(bb, O + T_KQ * TL + (16 * kk + bt_row) * LDK +
                                    kSub * mj + bt_col);
          mma_bf16_16816(S[0], a, bb[0], bb[1]);
          mma_bf16_16816(S[1], a, bb[2], bb[3]);
        }
        // the next chunk's S^T as bf16 hi + lo
        bf16* Shn = Sst + (st ^ 1) * 2 * kPB * LDK;
        bf16* Sln = Shn + kPB * LDK;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int off = (16 * mv + g + 8 * rr) * LDK + kSub * mj +
                            8 * n + 2 * cq;
            const __nv_bfloat162 hi =
                __floats2bfloat162_rn(S[n][2 * rr], S[n][2 * rr + 1]);
            const float2 hf = __bfloat1622float2(hi);
            *reinterpret_cast<__nv_bfloat162*>(Shn + off) = hi;
            *reinterpret_cast<__nv_bfloat162*>(Sln + off) =
                __floats2bfloat162_rn(S[n][2 * rr] - hf.x,
                                      S[n][2 * rr + 1] - hf.y);
          }
      }
      named_barrier_sync(0, kChunkThreads);
    }
  }
}

template <int NK>
int launch_chunked(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* y, int64_t b,
                   int64_t h, int64_t t, int64_t kd, int64_t vd,
                   cudaStream_t stream) {
  auto kernel = rwkv6_wkv_kernel_chunked<NK>;
  const size_t smem = ChunkSmem<NK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* ptr, uintptr_t a) {
    return (reinterpret_cast<uintptr_t>(ptr) & (a - 1)) == 0;
  };
  const int k_pair =
      kd % 2 == 0 && aligned(r, 4) && aligned(k, 4) && aligned(w, 4);
  const int v_vec = vd % 8 == 0 && aligned(v, 16);
  dim3 grid(unsigned((vd + kPB - 1) / kPB), unsigned(h), unsigned(b));
  kernel<<<grid, kChunkThreads, smem, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(w),
      static_cast<const float*>(u), static_cast<bf16*>(y), int(t), int(h),
      int(kd), int(vd), k_pair, v_vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_chunked(const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* y, int64_t b,
                     int64_t h, int64_t t, int64_t kd, int64_t vd,
                     cudaStream_t stream) {
  if (kd <= 16)
    return launch_chunked<1>(r, k, v, w, u, y, b, h, t, kd, vd, stream);
  if (kd <= 32)
    return launch_chunked<2>(r, k, v, w, u, y, b, h, t, kd, vd, stream);
  if (kd <= 48)
    return launch_chunked<3>(r, k, v, w, u, y, b, h, t, kd, vd, stream);
  return launch_chunked<4>(r, k, v, w, u, y, b, h, t, kd, vd, stream);
}

// ---------------------------------------------------------------------------
// float32: the chunked form on the tensor cores, 3xTF32
// ---------------------------------------------------------------------------

constexpr int kTL = 32;                  // chunk length
constexpr int kTSub = 8;                 // an 8-step block: its pairs are
constexpr int kTBlocks = kTL / kTSub;    // elementwise
constexpr int kTPB = 64;                 // state columns per block
constexpr int kTWarps = 8;
constexpr int kTThreads = 32 * kTWarps;
constexpr int kTLDA = kTL + 4;           // A's row stride
constexpr int kTLDV = kTPB + 8;          // v's row stride
constexpr int kTLDY = kTPB + 4;          // y's row stride
constexpr int kTLDE = 36;                // a block's 28 pairs and 8 bonuses
static_assert(kTWarps == 2 * kTBlocks,
              "the operands' build: a warp a (key half, 8-step block)");
static_assert(kTWarps == 2 * (kTPB / 16),
              "the products: a warp a (16 columns, key half)");
static_assert(kTL == 32 && kTSub == 8,
              "levels 16 and 8 on the tensor cores, the rest elementwise");

// the chunk's [L][LDK] key tiles, each as tf32 hi and lo planes, by index
constexpr int F_RP = 0;   // r_t P_t
constexpr int F_KQ = 1;   // k_s Q_s
constexpr int F_X16 = 2;  // level 16: rows t >= 16 r_t prod_{16<=i<t} w_i,
                          // rows t < 16 k_t prod_{t<i<16} w_i
constexpr int F_X8 = 3;   // level 8, in each 16-step half: the upper 8 rows
                          // r_t prod_{ref<=i<t} w_i, the lower 8 k_t
                          // prod_{t<i<ref} w_i (ref: the upper 8's start)
constexpr int kFTiles = 4;

template <int NK>
struct Tf32Smem {
  static constexpr int KP = 16 * NK;     // padded key dim
  // row strides (floats), each so that the lanes of a fragment load fall
  // on distinct banks: the key tiles are read as float2 pairs (2c, 2c + 1)
  // of a row g or as rows c and c + 4, v as rows c and c + 4 (stride = 8
  // (mod 16)); A as columns c and c + 4 of a row g (= 4 (mod 32)); y is
  // written as rows 2c and 2c + 1 (= 4 (mod 8))
  static constexpr int LDK = KP + 8;
  static constexpr int kTile = kTL * LDK;
  static constexpr size_t kBytes =
      sizeof(float) * (2 * kFTiles * kTile   // the key tiles, hi and lo
                       + 2 * kTL * kTLDA     // A: hi, lo
                       + 2 * kTL * kTLDV     // v, two stages
                       + 2 * kTL * kTLDY     // y's two partial sums
                       + (kTBlocks + 1) * KP // the blocks' decays, P_L
                       + kTBlocks * kTLDE);  // the upper keys' pair sums
};

// x split into tf32 hi and lo, stored at hi and lo (two floats)
__device__ __forceinline__ void put_split2(float* hi, float* lo, float2 x) {
  uint32_t h0, l0, h1, l1;
  split_tf32(x.x, h0, l0);
  split_tf32(x.y, h1, l1);
  *reinterpret_cast<float2*>(hi) =
      make_float2(__uint_as_float(h0), __uint_as_float(h1));
  *reinterpret_cast<float2*>(lo) =
      make_float2(__uint_as_float(l0), __uint_as_float(l1));
}

__device__ __forceinline__ void put_split(float* hi, float* lo, float x) {
  uint32_t h, l;
  split_tf32(x, h, l);
  *hi = __uint_as_float(h);
  *lo = __uint_as_float(l);
}

// v[i] of every lane summed over the warp's 32 lanes, in a fixed order:
// each step exchanges half of the values a lane keeps with the lane O
// apart, so after log2(N) steps lane l keeps one sum in v[0], that of
// value 16 b4 + 8 b3 + .. (the lane's bits from 16 down, as many as N
// needs); the steps left add that sum over the remaining lanes.  Every
// index is a constant (a loop whose bound is not would put v in local
// memory).
template <int N, int O = 16>
__device__ __forceinline__ void warp_transpose_sum(float* v, int lane) {
  static_assert(N >= 1 && (N & (N - 1)) == 0 && (O == 0 || N <= 2 * O),
                "N: a power of 2, 1 .. 32");
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[H + i];
        const float keep = up ? v[H + i] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      warp_transpose_sum<H, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      warp_transpose_sum<1, O / 2>(v, lane);
    }
  }
}

template <int NK>
__global__ void __launch_bounds__(kTThreads, 1)
rwkv6_wkv_kernel_tf32(const float* __restrict__ r,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ w,
                      const float* __restrict__ u, float* __restrict__ y,
                      int t_len, int h_heads, int k_dim, int v_dim,
                      int v_vec, int y_vec) {
  using Sm = Tf32Smem<NK>;
  constexpr int KP = Sm::KP, LDK = Sm::LDK, TS = Sm::kTile;
  constexpr int KH = KP / 2;             // a product warp's keys (NK n-tiles)
  extern __shared__ __align__(16) unsigned char wt_smem[];
  float* tiles = reinterpret_cast<float*>(wt_smem);  // [4][hi, lo][L][LDK]
  float* Ah = tiles + 2 * kFTiles * TS;              // [L][kTLDA]
  float* Al = Ah + kTL * kTLDA;
  float* vs0 = Al + kTL * kTLDA;                     // [2][L][kTLDV]
  float* Ys = vs0 + 2 * kTL * kTLDV;                 // [2][L][kTLDY]
  float* gh = Ys + 2 * kTL * kTLDY;                  // [kTBlocks][KP]
  float* PL = gh + kTBlocks * KP;                    // [KP]
  float* Es = PL + KP;                               // [kTBlocks][kTLDE]
  auto tile_hi = [&](int f) { return tiles + 2 * f * TS; };
  auto tile_lo = [&](int f) { return tiles + (2 * f + 1) * TS; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, cq = lane & 3;
  const int v0 = blockIdx.x * kTPB;
  const int h = blockIdx.y;
  const int64_t bh = int64_t(blockIdx.z) * h_heads + h;
  const int64_t koff = bh * t_len * k_dim;
  const float* vb = v + bh * t_len * v_dim + v0;
  float* yb = y + bh * t_len * v_dim + v0;
  const int v_cols = min(kTPB, v_dim - v0);
  const int n_chunks = (t_len + kTL - 1) / kTL;

  // ---- the operands' build: thread (key 32 kq + lane, 8-step block bj:
  // steps 8 bj .. 8 bj + 7) ----
  const int kq = warp / kTBlocks, bj = warp % kTBlocks;
  const int key = 32 * kq + lane;
  const bool k_on = key < KP;            // its key is in the tiles
  const int b0 = kTSub * bj;
  const float uk = key < k_dim ? u[int64_t(h) * k_dim + key] : 0.f;
  float nr[kTSub], nk[kTSub], nw[kTSub];  // the next chunk's, in flight
  auto fetch = [&](int c) {
    const int t0 = c * kTL + b0;
    const int64_t off = koff + int64_t(t0) * k_dim + key;
    const bool on = key < k_dim;
    if (on && t0 + kTSub <= t_len) {
#pragma unroll
      for (int i = 0; i < kTSub; ++i) {
        nr[i] = r[off + i * k_dim];
        nk[i] = k[off + i * k_dim];
        nw[i] = w[off + i * k_dim];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kTSub; ++i) {
        const bool ok = on && t0 + i < t_len;
        nr[i] = ok ? r[off + i * k_dim] : 0.f;
        nk[i] = ok ? k[off + i * k_dim] : 0.f;
        nw[i] = ok ? w[off + i * k_dim] : 0.f;
      }
    }
  };
  // after the warp's sums, lane l holds the pair (pt, ps) of its block (l <
  // 28: l = pt (pt - 1) / 2 + ps) or the bonus of step l - 28
  int pt = lane - 28, ps = lane - 28;
  if (lane < 28) {
    pt = 1;
    while ((pt + 1) * pt / 2 <= lane) ++pt;
    ps = lane - pt * (pt - 1) / 2;
  }
  auto vst = [&](int st) { return vs0 + st * kTL * kTLDV; };
  auto stage = [&](int c, int st) {
    stage_rows_f32<kTL, kTPB, kTLDV, kTThreads>(vst(st), vb, v_dim, c * kTL,
                                                t_len, v_cols, v_vec);
    cp_async_commit();
  };
  // chunk c's y: the sum of the two partials the product warps left in Ys
  auto store_y = [&](int c) {
    constexpr int CH = kTPB / 4;
#pragma unroll
    for (int kk = 0; kk < kTL * CH / kTThreads; ++kk) {
      const int i = threadIdx.x + kk * kTThreads;
      const int rr = i / CH, cc = (i % CH) * 4;
      const int t = c * kTL + rr;
      if (t >= t_len || cc >= v_cols) continue;
      const float4 a = *reinterpret_cast<const float4*>(Ys + rr * kTLDY + cc);
      const float4 b = *reinterpret_cast<const float4*>(
          Ys + (kTL + rr) * kTLDY + cc);
      const float4 s = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
      float* dst = yb + int64_t(t) * v_dim + cc;
      if (y_vec) {
        *reinterpret_cast<float4*>(dst) = s;
      } else {
        dst[0] = s.x;
        if (cc + 1 < v_cols) dst[1] = s.y;
        if (cc + 2 < v_cols) dst[2] = s.z;
        if (cc + 3 < v_cols) dst[3] = s.w;
      }
    }
  };

  // ---- the products' view: warp (vw, kh) = (value columns 16 vw .., keys
  // KH kh ..): S^T [16 x KH] in registers, rows v = 16 vw + g (+ 8),
  // columns KH kh + 8 n + 2 cq (+ 1): the carry's C fragments, and with
  // each 8-column group permuted the A fragments of S^T (r P)^T ----
  const int vw = warp % (kTPB / 16), kh = warp / (kTPB / 16);
  float S[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[n][e] = 0.f;

  // A's entries above the diagonal of the 8-step blocks stay zero
  for (int i = threadIdx.x; i < 2 * kTL * kTLDA; i += kTThreads) Ah[i] = 0.f;

  fetch(0);
  stage(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    float cr[kTSub], ck[kTSub], cw[kTSub];
#pragma unroll
    for (int i = 0; i < kTSub; ++i) {
      cr[i] = nr[i];
      ck[i] = nk[i];
      cw[i] = nw[i];
    }
    cp_async_wait<0>();                  // chunk c's v has landed
    __syncthreads();                     // and chunk c - 1's products are done
    if (c > 0) store_y(c - 1);
    if (c + 1 < n_chunks) {
      fetch(c + 1);                      // in flight during this chunk
      stage(c + 1, st ^ 1);
    }

    // ---- the block's decay, for the other warps; the pairs closer than 8
    // steps and the bonus, elementwise in float32, summed over the warp's
    // keys; the upper keys' sums to Es ----
    float e[32], e4[4];
    {
      float G = 1.f;
#pragma unroll
      for (int i = 0; i < kTSub; ++i) G *= cw[i];
      if (k_on) gh[bj * KP + key] = G;
      // e[t (t - 1) / 2 + s] = r_t k_s prod_{s<i<t} w_i (s < t), then the
      // bonus r_t u k_t of steps 0 .. 3; e4 that of steps 4 .. 7
#pragma unroll
      for (int s = 0; s < kTSub - 1; ++s) {
        float f = ck[s];
#pragma unroll
        for (int t = s + 1; t < kTSub; ++t) {
          e[t * (t - 1) / 2 + s] = cr[t] * f;
          if (t + 1 < kTSub) f *= cw[t];
        }
      }
#pragma unroll
      for (int t = 0; t < kTSub; ++t) {
        const float b = cr[t] * uk * ck[t];
        if (t < 4) e[28 + t % 4] = b;
        else e4[t % 4] = b;
      }
      warp_transpose_sum<32>(e, lane);
      warp_transpose_sum<4>(e4, lane);
      if (kq == 1) {
        Es[bj * kTLDE + lane] = e[0];
        if ((lane & 7) == 0) Es[bj * kTLDE + 32 + (lane >> 3)] = e4[0];
      }
    }
    __syncthreads();

    // ---- the block's pairs into A, the two key halves added; the key
    // tiles ----
    if (kq == 0) {
      const int o = (b0 + pt) * kTLDA + b0 + ps;
      put_split(Ah + o, Al + o, e[0] + Es[bj * kTLDE + lane]);
      if ((lane & 7) == 0) {
        const int tb = b0 + 4 + (lane >> 3);
        put_split(Ah + tb * kTLDA + tb, Al + tb * kTLDA + tb,
                  e4[0] + Es[bj * kTLDE + 32 + (lane >> 3)]);
      }
    }
    if (k_on) {
      float G[kTBlocks];
#pragma unroll
      for (int j = 0; j < kTBlocks; ++j) G[j] = gh[j * KP + key];
      float pre = 1.f, post = 1.f;       // prod G before and after the block
#pragma unroll
      for (int j = 0; j < kTBlocks; ++j) {
        if (j < bj) pre *= G[j];
        if (j > bj) post *= G[j];
      }
      if (bj == 0) PL[key] = (G[0] * G[1]) * (G[2] * G[3]);
      const float g16u = bj == 3 ? G[2] : 1.f;   // rows t >= 16
      const float g16l = bj == 0 ? G[1] : 1.f;   // rows t < 16
      float sf[kTSub];                   // prod_{i < j < 8} w_j in the block
      sf[kTSub - 1] = 1.f;
#pragma unroll
      for (int i = kTSub - 1; i > 0; --i) sf[i - 1] = sf[i] * cw[i];
      float pr = 1.f;                    // prod_{0 <= j < i} w_j
#pragma unroll
      for (int i = 0; i < kTSub; ++i) {
        const int o = (b0 + i) * LDK + key;
        put_split(tile_hi(F_RP) + o, tile_lo(F_RP) + o, cr[i] * (pre * pr));
        put_split(tile_hi(F_KQ) + o, tile_lo(F_KQ) + o, ck[i] * (sf[i] * post));
        put_split(tile_hi(F_X16) + o, tile_lo(F_X16) + o,
                  bj >= 2 ? cr[i] * (g16u * pr) : ck[i] * (sf[i] * g16l));
        put_split(tile_hi(F_X8) + o, tile_lo(F_X8) + o,
                  bj & 1 ? cr[i] * pr : ck[i] * sf[i]);
        pr *= cw[i];
      }
    }
    __syncthreads();

    // ---- the levels' pairs, X_b X_b^T, one 16 x 8 tile a warp of the
    // first four: 0 and 1 level 16 (rows 16 .., keys 0 .. 7 and 8 .. 15); 2
    // and 3 level 8 (rows 0 .. 15 x keys 0 .. 7, rows 16 .. x 16 .., of
    // which rows 8 .. 15 and 24 .. 31 are the level's).  The keys are read
    // as pairs (2c, 2c + 1), the same permutation on both sides; hi * hi
    // apart from the small terms, each by k-step parity ----
    if (warp < 4) {
      const int f = warp < 2 ? F_X16 : F_X8;
      const float* Xh = tile_hi(f);
      const float* Xl = tile_lo(f);
      const int m0 = warp == 2 ? 0 : 16;
      const int n0 = warp == 1 ? 8 : warp == 3 ? 16 : 0;
      float sc[2][4], scl[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[q][e] = scl[q][e] = 0.f;
      const int ca = (m0 + g) * LDK + 2 * cq, cb = (n0 + g) * LDK + 2 * cq;
#pragma unroll
      for (int kk = 0; kk < KP / 8; ++kk) {
        const float2 h0 = ld2(Xh + ca + 8 * kk);
        const float2 h1 = ld2(Xh + ca + 8 * LDK + 8 * kk);
        const float2 l0 = ld2(Xl + ca + 8 * kk);
        const float2 l1 = ld2(Xl + ca + 8 * LDK + 8 * kk);
        const uint32_t ah[4] = {u32(h0.x), u32(h1.x), u32(h0.y), u32(h1.y)};
        const uint32_t al[4] = {u32(l0.x), u32(l1.x), u32(l0.y), u32(l1.y)};
        const float2 bh = ld2(Xh + cb + 8 * kk), bl = ld2(Xl + cb + 8 * kk);
        mma_tf32_1688(scl[kk & 1], al, u32(bh.x), u32(bh.y));
        mma_tf32_1688(scl[kk & 1], ah, u32(bl.x), u32(bl.y));
        mma_tf32_1688(sc[kk & 1], ah, u32(bh.x), u32(bh.y));
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (rr == 0 && warp >= 2) continue;
        const int o = (m0 + g + 8 * rr) * kTLDA + n0 + 2 * cq;
        float a[2];
#pragma unroll
        for (int q = 0; q < 2; ++q)
          a[q] = (sc[0][2 * rr + q] + sc[1][2 * rr + q]) +
                 (scl[0][2 * rr + q] + scl[1][2 * rr + q]);
        put_split2(Ah + o, Al + o, make_float2(a[0], a[1]));
      }
    }
    __syncthreads();

    // ---- the products of warp (vw, kh) ----
    {
      const float* vc = vst(st);
      // V^T's A fragments (16 columns v x 8 steps s) for the 4 step k-steps,
      // split: rows c and c + 4 of v
      uint32_t vh[kTL / 8][4], vl[kTL / 8][4];
#pragma unroll
      for (int ks = 0; ks < kTL / 8; ++ks) {
        const float* x0 = vc + (8 * ks + cq) * kTLDV + 16 * vw + g;
        split_tf32(x0[0], vh[ks][0], vl[ks][0]);
        split_tf32(x0[8], vh[ks][1], vl[ks][1]);
        split_tf32(x0[4 * kTLDV], vh[ks][2], vl[ks][2]);
        split_tf32(x0[4 * kTLDV + 8], vh[ks][3], vl[ks][3]);
      }
      // y^T over the warp's keys: S^T (r P)^T, B = (r P)^T read as pairs
      // (2c, 2c + 1) of r P's rows t, hi * hi apart from the small terms;
      // and A V for the t-tiles tb of the warp's half (kh 0: 0 .. 2, kh 1:
      // 3), B = A^T read as columns c and c + 4 of A's rows, steps s <= t
      float yi[kTL / 8][4], yil[kTL / 8][4], yo[kTL / 8][4];
#pragma unroll
      for (int tb = 0; tb < kTL / 8; ++tb)
#pragma unroll
        for (int e = 0; e < 4; ++e) yi[tb][e] = yil[tb][e] = yo[tb][e] = 0.f;
      const float* RPh = tile_hi(F_RP);
      const float* RPl = tile_lo(F_RP);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t ah[4], al[4];
        split_tf32(S[n][0], ah[0], al[0]);
        split_tf32(S[n][2], ah[1], al[1]);
        split_tf32(S[n][1], ah[2], al[2]);
        split_tf32(S[n][3], ah[3], al[3]);
#pragma unroll
        for (int tb = 0; tb < kTL / 8; ++tb) {
          const int o = (8 * tb + g) * LDK + KH * kh + 8 * n + 2 * cq;
          const float2 bh = ld2(RPh + o), bl = ld2(RPl + o);
          mma_tf32_1688(yil[tb], al, u32(bh.x), u32(bh.y));
          mma_tf32_1688(yil[tb], ah, u32(bl.x), u32(bl.y));
          mma_tf32_1688(yi[tb], ah, u32(bh.x), u32(bh.y));
        }
      }
#pragma unroll
      for (int tb = 0; tb < kTL / 8; ++tb) {
        if ((tb == kTL / 8 - 1) != (kh == 1)) continue;
#pragma unroll
        for (int ks = 0; ks <= tb; ++ks) {
          const int m = (8 * tb + g) * kTLDA + 8 * ks + cq;
          mma_3xtf32(yo[tb], vh[ks], vl[ks], u32(Ah[m]), u32(Ah[m + 4]),
                     u32(Al[m]), u32(Al[m + 4]));
        }
      }
      // the warp's partial y, rows t, columns v, into Ys[kh]
      float* Y = Ys + kh * kTL * kTLDY;
#pragma unroll
      for (int tb = 0; tb < kTL / 8; ++tb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Y[(8 * tb + 2 * cq + (e & 1)) * kTLDY + 16 * vw + g + 8 * (e >> 1)] =
              (yi[tb][e] + yil[tb][e]) + yo[tb][e];

      // carry: S^T = P_L .* S^T + V^T (k Q) over the warp's keys, the
      // chunk's sum in a fresh accumulator added by one FMA (B = k Q read
      // as rows c and c + 4)
      const float* KQh = tile_hi(F_KQ);
      const float* KQl = tile_lo(F_KQ);
      float fr[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) fr[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kTL / 8; ++ks) {
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int o = (8 * ks + cq) * LDK + KH * kh + 8 * n + g;
          mma_3xtf32(fr[n], vh[ks], vl[ks], u32(KQh[o]), u32(KQh[o + 4 * LDK]),
                     u32(KQl[o]), u32(KQl[o + 4 * LDK]));
        }
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const float2 d = ld2(PL + KH * kh + 8 * n + 2 * cq);
        S[n][0] = fmaf(S[n][0], d.x, fr[n][0]);
        S[n][1] = fmaf(S[n][1], d.y, fr[n][1]);
        S[n][2] = fmaf(S[n][2], d.x, fr[n][2]);
        S[n][3] = fmaf(S[n][3], d.y, fr[n][3]);
      }
    }
  }
  __syncthreads();
  store_y(n_chunks - 1);
}

template <int NK>
int launch_tf32(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* y, int64_t b, int64_t h, int64_t t,
                int64_t kd, int64_t vd, cudaStream_t stream) {
  auto kernel = rwkv6_wkv_kernel_tf32<NK>;
  const size_t smem = Tf32Smem<NK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
  };
  const int v_vec = vd % 4 == 0 && aligned(v);
  const int y_vec = vd % 4 == 0 && aligned(y);
  dim3 grid(unsigned((vd + kTPB - 1) / kTPB), unsigned(h), unsigned(b));
  kernel<<<grid, kTThreads, smem, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(y), int(t), int(h),
      int(kd), int(vd), v_vec, y_vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_tf32(const void* r, const void* k, const void* v, const void* w,
                  const void* u, void* y, int64_t b, int64_t h, int64_t t,
                  int64_t kd, int64_t vd, cudaStream_t stream) {
  if (kd <= 16)
    return launch_tf32<1>(r, k, v, w, u, y, b, h, t, kd, vd, stream);
  if (kd <= 32)
    return launch_tf32<2>(r, k, v, w, u, y, b, h, t, kd, vd, stream);
  if (kd <= 48)
    return launch_tf32<3>(r, k, v, w, u, y, b, h, t, kd, vd, stream);
  return launch_tf32<4>(r, k, v, w, u, y, b, h, t, kd, vd, stream);
}

}  // namespace

// r, k, w [B,H,T,K] and v [B,H,T,V] of the element type `dtype`, u [H,K]
// float32, y [B,H,T,V] of `dtype`, all contiguous.  Returns a cudaError_t.
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const void* w, const void* u, void* y,
                                int64_t b, int64_t h, int64_t t, int64_t kd,
                                int64_t vd, int64_t dtype, void* stream) {
  if (b <= 0 || h <= 0 || t <= 0 || vd <= 0) return 0;
  if (kd <= 0 || kd > kMaxK || h > 65535 || b > 65535 ||
      t > 2147483647LL - kL || vd > 2147483647LL - kPB)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return dispatch_tf32(r, k, v, w, u, y, b, h, t, kd, vd, s);
  if (dtype == DT_BF16)
    return dispatch_chunked(r, k, v, w, u, y, b, h, t, kd, vd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
