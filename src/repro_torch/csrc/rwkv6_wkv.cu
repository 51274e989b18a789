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
// float32 CUDA cores).
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
// float32: rwkv6_wkv_kernel_f32, the sequential form on the float32 CUDA
//   cores (TF32 would miss the float32 tolerance of 1e-4), latency-bound on
//   its step, with the state in registers.
//   * grid = (ceil(V / 16), H, B); a block of 128 threads owns 16 value
//     columns of one (batch, head)'s state for the whole sequence: thread
//     (pl, ng) keeps, of column pl, the 4 J states k = 32 j + 4 ng + e
//     (j < J, e < 4; J = ceil(K / 32) a template parameter) in registers.
//   * The block walks T in chunks of 32 steps.  Each chunk's r, k and w rows
//     (K padded with zeros to 32 J) and v columns are staged in shared
//     memory as float32.  The global loads of chunk c + 1 go to registers
//     before chunk c's steps run, so their latency hides behind the steps
//     (the staging loads, waited for in place, had cost the first design
//     more than half its time).  Each thread runs the 32 steps from shared
//     memory, reading its r, k, w slices as float4s (a column's 8 threads
//     read 128 contiguous bytes: no bank conflicts).  A step's only
//     dependent chain is the thread's partial sum of y_t over its k; the
//     partials go to shared memory, and the sum over a column's 8 threads is
//     taken once a chunk, in the coalesced store of the chunk's y tile.
//   * Any T: the last chunk is cut short; any V: columns past V stay zero
//     and are not stored; K <= 64: padded keys have k = 0, so their states
//     stay 0.
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): the bf16 path
// at (1, 64, 4096, 64, 64), profiler device time a call in rwkv6-7b's bf16
// prefill, 0.206161 ms, 814 GB/s, 4.1x the byte bound (the sequential form
// took 0.679579 ms); the float32 path 0.6824 ms a call (PERF.md).

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
// float32: sequential on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kCols = 16;                // value columns per block
constexpr int kGroups = 8;               // threads sharing a column (split k)
constexpr int kThreads = kCols * kGroups;
constexpr int kChunk = 32;               // time steps staged at once
static_assert(kGroups == 8, "the y partials are summed as two float4s");
static_assert(kChunk * kCols % kThreads == 0 && 32 * kChunk % kThreads == 0,
              "the staging loops give every thread the same trip count");

// one state of the column: its share of y_t, then the decayed update
__device__ __forceinline__ void wkv_step(float r, float k, float w, float u,
                                         float v, float& s, float& acc) {
  const float kv = k * v;
  acc = fmaf(r, fmaf(u, kv, s), acc);
  s = fmaf(w, s, kv);
}

template <int J>
__global__ void __launch_bounds__(kThreads)
rwkv6_wkv_kernel_f32(const float* __restrict__ r,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ w,
                     const float* __restrict__ u, float* __restrict__ y,
                     int t_len, int h_heads, int k_dim, int v_dim) {
  constexpr int KP = 32 * J;               // padded key dim
  __shared__ __align__(16) float rs[kChunk][KP];
  __shared__ __align__(16) float ks[kChunk][KP];
  __shared__ __align__(16) float ws[kChunk][KP];
  __shared__ float vs[kChunk][kCols];
  __shared__ __align__(16) float ys[kChunk][kCols][kGroups];  // partials

  const int tid = threadIdx.x;
  const int pl = tid / kGroups, ng = tid % kGroups;
  const int c0 = blockIdx.x * kCols;
  const int h = blockIdx.y;
  const int64_t bh = int64_t(blockIdx.z) * h_heads + h;
  const float* rb = r + bh * t_len * k_dim;
  const float* kb = k + bh * t_len * k_dim;
  const float* wb = w + bh * t_len * k_dim;
  const float* vb = v + bh * t_len * v_dim;
  float* yb = y + bh * t_len * v_dim;

  float S[J][4], U[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 32 * j + 4 * ng + e;
      U[j][e] = kk < k_dim ? u[h * k_dim + kk] : 0.f;
      S[j][e] = 0.f;
    }
  }

  // this thread's share of a chunk of r, k, w (NL each) and v (NV)
  constexpr int NL = kChunk * KP / kThreads, NV = kChunk * kCols / kThreads;
  float pr[NL], pk[NL], pw[NL], pv[NV];
  auto fetch = [&](int t0) {
    const int tc = min(kChunk, t_len - t0);
#pragma unroll
    for (int it = 0; it < NL; ++it) {
      const int i = tid + it * kThreads;
      const int tt = i / KP, kk = i % KP;
      pr[it] = pk[it] = pw[it] = 0.f;
      if (tt < tc && kk < k_dim) {
        const int64_t off = int64_t(t0 + tt) * k_dim + kk;
        pr[it] = rb[off];
        pk[it] = kb[off];
        pw[it] = wb[off];
      }
    }
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      const int i = tid + it * kThreads;
      const int tt = i / kCols, c = i % kCols;
      pv[it] = (tt < tc && c0 + c < v_dim)
                   ? vb[int64_t(t0 + tt) * v_dim + c0 + c]
                   : 0.f;
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int tc = min(kChunk, t_len - t0);
    __syncthreads();                      // previous chunk fully consumed
#pragma unroll
    for (int it = 0; it < NL; ++it) {
      const int i = tid + it * kThreads;
      const int tt = i / KP, kk = i % KP;
      rs[tt][kk] = pr[it];
      ks[tt][kk] = pk[it];
      ws[tt][kk] = pw[it];
    }
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      const int i = tid + it * kThreads;
      vs[i / kCols][i % kCols] = pv[it];
    }
    __syncthreads();
    if (t0 + kChunk < t_len) fetch(t0 + kChunk);   // in flight during steps

#pragma unroll 4
    for (int tt = 0; tt < tc; ++tt) {
      const float vt = vs[tt][pl];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int kk = 32 * j + 4 * ng;
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[tt][kk]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[tt][kk]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[tt][kk]);
        wkv_step(r4.x, k4.x, w4.x, U[j][0], vt, S[j][0], acc);
        wkv_step(r4.y, k4.y, w4.y, U[j][1], vt, S[j][1], acc);
        wkv_step(r4.z, k4.z, w4.z, U[j][2], vt, S[j][2], acc);
        wkv_step(r4.w, k4.w, w4.w, U[j][3], vt, S[j][3], acc);
      }
      ys[tt][pl][ng] = acc;
    }
    __syncthreads();
    // y_t of a column: the sum of its 8 threads' partials
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      const int i = tid + it * kThreads;
      const int tt = i / kCols, c = i % kCols;
      if (tt < tc && c0 + c < v_dim) {
        const float4 a = *reinterpret_cast<const float4*>(&ys[tt][c][0]);
        const float4 b = *reinterpret_cast<const float4*>(&ys[tt][c][4]);
        yb[int64_t(t0 + tt) * v_dim + c0 + c] =
            ((a.x + a.y) + (a.z + a.w)) + ((b.x + b.y) + (b.z + b.w));
      }
    }
  }
}

template <int J>
int launch_f32(const void* r, const void* k, const void* v, const void* w,
               const void* u, void* y, int64_t b, int64_t h, int64_t t,
               int64_t kd, int64_t vd, cudaStream_t stream) {
  dim3 grid(unsigned((vd + kCols - 1) / kCols), unsigned(h), unsigned(b));
  rwkv6_wkv_kernel_f32<J><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(y), int(t), int(h),
      int(kd), int(vd));
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* r, const void* k, const void* v, const void* w,
                 const void* u, void* y, int64_t b, int64_t h, int64_t t,
                 int64_t kd, int64_t vd, cudaStream_t stream) {
  if (kd <= 32)
    return launch_f32<1>(r, k, v, w, u, y, b, h, t, kd, vd, stream);
  return launch_f32<2>(r, k, v, w, u, y, b, h, t, kd, vd, stream);
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
    return dispatch_f32(r, k, v, w, u, y, b, h, t, kd, vd, s);
  if (dtype == DT_BF16)
    return dispatch_chunked(r, k, v, w, u, y, b, h, t, kd, vd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
