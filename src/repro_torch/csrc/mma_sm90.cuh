// mma_sm90.cuh: the tensor-core and asynchronous-copy building blocks of
// the float kernels (flash_attention.cu, mamba2_ssd.cu, rwkv6_wkv.cu), in
// bf16 and in float32 (3xTF32), as inline PTX for sm_90a.
//
//   * mma_bf16_16816: one warp-wide mma.sync.m16n8k16, bf16 operands,
//     float32 accumulators (row-major A, column-major B).
//   * mma_tf32_1688: one warp-wide mma.sync.m16n8k8, tf32 operands,
//     float32 accumulators; split_tf32 cuts a float32 into a tf32 high
//     part and a tf32 remainder, so that three such products (lo * hi,
//     hi * lo, hi * hi: mma_3xtf32) keep a float32 product to about 2^-22
//     (3xTF32); split_rows splits a shared tile once for all the warps.
//   * ldmatrix_x4 / ldmatrix_x4_trans: four 8x8 bf16 tiles from shared
//     memory into fragments; lane i gives the row address of tile i / 8.
//   * cp_async_16: a 16-byte global -> shared copy that bypasses the
//     registers (cp.async.cg); src_bytes < 16 zero-fills the rest, so a
//     row past the end of a tensor lands as zeros.  cp_async_16_full: the
//     same copy without that operand; stage_rows_f32 stages a float32
//     tile's rows with it.
//   * ld2, u32: a float2 from shared memory; a float's bits.
//   * fast_exp2: 2^x on the special-function unit.
//   * pack_bf16x2: two floats rounded to bf16 into one 32-bit register,
//     the lower address in the low half (the mma operand order).
//   * named_barrier_sync: bar.sync for a group of warps.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and c = lane % 4:
//   A (16x16): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g, 2c+8..),
//              a3 = (g+8, 2c+8..)
//   B (16x8):  b0 = (k 2c..2c+1, n g), b1 = (k 2c+8.., n g)
//   C (16x8):  c0, c1 = (g, 2c..2c+1), c2, c3 = (g+8, 2c..2c+1)
// so the C fragments of two neighbouring n-tiles are, packed to bf16, the
// A fragment of one k-step: a product's result feeds the next product
// without leaving the registers.
//
// mma.m16n8k8 with tf32 operands (one 32-bit register an element):
//   A (16x8):  a0 = (g, c), a1 = (g+8, c), a2 = (g, c+4), a3 = (g+8, c+4)
//   B (8x8):   b0 = (k c, n g), b1 = (k c+4, n g)
//   C (16x8):  as above, c0, c1 = (g, 2c..2c+1), c2, c3 = (g+8, 2c..2c+1)
// ldmatrix .b16 on rows of four floats gives lane (g, c) the float (g, c)
// of each 8x4 tile, which is the A and the B layout; a C fragment is an A
// fragment only with the columns of each 8-column group permuted
// (2c -> c, 2c+1 -> c+4), which the caller undoes on the other operand.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace mma_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32_1688(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (to nearest, ties away from zero: half a tf32 ulp
// added to the magnitude, the low 13 bits cleared), as cvt.rna.tf32.f32
// rounds a finite x, in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + e, |e| <= 2^-22 |x|: hi = tf32(x), lo = tf32(x - hi)
// (x - hi is exact in float32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// split_tf32 of four floats, the parts as floats
__device__ __forceinline__ void split_tf32x4(float4 v, float4& h, float4& l) {
  uint32_t a, b;
  split_tf32(v.x, a, b); h.x = __uint_as_float(a); l.x = __uint_as_float(b);
  split_tf32(v.y, a, b); h.y = __uint_as_float(a); l.y = __uint_as_float(b);
  split_tf32(v.z, a, b); h.z = __uint_as_float(a); l.z = __uint_as_float(b);
  split_tf32(v.w, a, b); h.w = __uint_as_float(a); l.w = __uint_as_float(b);
}

// rows [0, ROWS) of x[ROWS][LD] (DP columns, a multiple of 4, 16-byte
// aligned rows) split in place into their tf32 hi parts, the lo parts into
// lo[ROWS][LD], by THREADS threads
template <int ROWS, int DP, int LD, int THREADS>
__device__ __forceinline__ void split_rows(float* x, float* lo) {
  constexpr int CH = DP / 4;
#pragma unroll
  for (int k = 0; k < (ROWS * CH + THREADS - 1) / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (ROWS * CH % THREADS != 0 && i >= ROWS * CH) break;
    const int o = i / CH * LD + (i % CH) * 4;
    float4 h, l;
    split_tf32x4(*reinterpret_cast<float4*>(x + o), h, l);
    *reinterpret_cast<float4*>(x + o) = h;
    *reinterpret_cast<float4*>(lo + o) = l;
  }
}

// acc += a * b in 3xTF32: lo * hi, then hi * lo, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32_1688(acc, al, bh0, bh1);
  mma_tf32_1688(acc, ah, bl0, bl1);
  mma_tf32_1688(acc, ah, bh0, bh1);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

// the same copy of 16 bytes that are all there, without the source-size
// operand: staging with cp_async_16's zero fill, its size chosen at run
// time, made mamba2_ssd's float32 kernel 15-17 % slower (PERF.md), though
// the instruction alone issues no slower (scripts/tf32_probe.py)
__device__ __forceinline__ void cp_async_16_full(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [t0, t0 + ROWS) of a [T, *]-strided float32 matrix, `cols` real
// columns, into dst[ROWS][LD], WIDTH columns (a multiple of 4), zero past
// T and past cols, by THREADS threads.  vec: 16-byte cp.async without the
// source-size operand (cols a multiple of 4, aligned rows; the zeros by
// plain stores), else plain loads.
template <int ROWS, int WIDTH, int LD, int THREADS>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               int64_t row_stride, int t0,
                                               int t_len, int cols,
                                               bool vec) {
  constexpr int CH = WIDTH / 4;
  static_assert(ROWS * CH % THREADS == 0, "whole rounds of 16 bytes");
  if (vec) {
#pragma unroll
    for (int k = 0; k < ROWS * CH / THREADS; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const int r = i / CH, c = (i % CH) * 4;
      float* dp = dst + r * LD + c;
      if (c < cols && t0 + r < t_len)
        cp_async_16_full(dp, src + (t0 + r) * row_stride + c);
      else
        *reinterpret_cast<float4*>(dp) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * WIDTH; i += THREADS) {
      const int r = i / WIDTH, c = i % WIDTH;
      float val = 0.f;
      if (t0 + r < t_len && c < cols) val = src[(t0 + r) * row_stride + c];
      dst[r * LD + c] = val;
    }
  }
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ uint32_t u32(float v) { return __float_as_uint(v); }

// 2^x on the special-function unit (ex2.approx.ftz: about 2 ulp; -inf
// gives +0), what exp2f becomes under --use_fast_math
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bar.sync on barrier `id` for `count` threads (a multiple of 32): a
// barrier of some of the block's warps, or of all of them where the warps
// reach it from different code (warp-specialised kernels)
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace mma_sm90
