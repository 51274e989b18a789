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
// At zamba2's causal prefill shape (32 heads, 4096 tokens, D = 112) that is
// 120 GFLOP a call, 0.12 ms at the bf16 tensor-core peak, and 7 MB of
// bf16 traffic.  This first kernel runs on the CUDA cores in float32 (no
// mma.sync / wgmma / TMA yet), so it sits well above that bound.
//
// Design:
//   * grid = (B * Hq, ceil(Sq / 32)); a block of 4 warps owns 32 query rows
//     of one (batch, q head), 8 rows a warp.  The kv head is
//     hq / (Hq / Hkv) (GQA head folding, as the Pallas index map).
//   * The block's query tile and each 32-key K and V tile are staged in
//     shared memory as float32 (bfloat16 inputs are widened on load), rows
//     padded to a multiple of 4 floats with zeros, so any D <= 256 works
//     and the dot products read float4s.  The K rows have an odd number
//     of float4s, so the 8 lanes of a quarter warp read 8 distinct bank
//     groups.
//   * Scores: lane j owns key j of the tile; each warp computes its 8 rows'
//     scores with one K float4 and 8 broadcast Q float4s per 4 dims.
//   * Online softmax per row (running max m, sum l) with warp shuffles; the
//     output row is kept in registers, lane i owning dims i, i+32, ...
//     (NI = ceil(D/32) of them, NI a template parameter).
//   * Key tiles outside the causal / window band are skipped by the loop
//     bounds, as kernel.py:44-50 does; the ragged ends (Sq, Sk, D) are
//     masked by index, so there is no padding contract.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// Element types; the codes are repro_torch.kernels._build.DTYPE_CODES,
// pinned by tests/test_torch_kernel_layout.py.
enum DType { DT_F32 = 0, DT_BF16 = 1 };

constexpr int kWarps = 4;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per block
constexpr int kBK = 32;                  // keys per tile (one per lane)
constexpr int kMaxD = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Geometry {
  int d4;    // D rounded up to a multiple of 4 (Q row stride)
  int ks;    // K row stride: d4, or d4 + 4 when d4 / 4 is even
  int vs;    // V row stride: 32 * NI
};

__host__ __device__ inline Geometry geometry(int d, int ni) {
  Geometry g;
  g.d4 = (d + 3) / 4 * 4;
  g.ks = ((g.d4 / 4) % 2 == 0) ? g.d4 + 4 : g.d4;
  g.vs = 32 * ni;
  return g;
}

__host__ __device__ inline size_t smem_bytes(int d, int ni) {
  Geometry g = geometry(d, ni);
  return sizeof(float) *
         (size_t(kBQ) * g.d4 + size_t(kBK) * g.ks + size_t(kBK) * g.vs);
}

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* src, int rows,
                                          int row0, int nrows, int d,
                                          int width) {
  // dst[r * stride + c] = src[(row0 + r) * d + c] for r < rows, c < width;
  // zero past nrows (ragged sequence end) and past d (dim padding)
  for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
    int r = i / width, c = i - r * width;
    int row = row0 + r;
    float v = 0.f;
    if (row < nrows && c < d) v = to_f32(src[int64_t(row) * d + c]);
    dst[r * stride + c] = v;
  }
}

template <typename T, int NI>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int hq, int group, int sq, int sk, int d,
                       int causal, int64_t window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Geometry g = geometry(d, NI);
  float* Qs = smem;                       // [kBQ][d4]
  float* Ks = Qs + kBQ * g.d4;            // [kBK][ks]
  float* Vs = Ks + kBK * g.ks;            // [kBK][vs]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;              // b * hq + h
  const int b = bh / hq, h = bh - b * hq;
  const int hkv = hq / group;
  const int64_t kv_bh = int64_t(b) * hkv + h / group;
  const int q0 = blockIdx.y * kBQ;
  const int q_offset = sk - sq;           // queries end the key timeline

  const T* qp = q + int64_t(bh) * sq * d;
  const T* kp = k + kv_bh * sk * d;
  const T* vp = v + kv_bh * sk * d;
  T* op = out + int64_t(bh) * sq * d;

  load_tile(Qs, g.d4, qp, kBQ, q0, sq, d, g.d4);

  // key-tile range intersecting the block's band (kernel.py:44-50)
  const int q_lo = q0 + q_offset;
  const int q_hi = min(q0 + kBQ, sq) - 1 + q_offset;
  const int n_tiles = (sk + kBK - 1) / kBK;
  int hi = n_tiles;
  if (causal) hi = q_hi < 0 ? 0 : min(q_hi / kBK + 1, n_tiles);
  int lo = 0;
  if (window >= 0) {
    int64_t first = int64_t(q_lo) - window + 1;  // first visible key
    lo = first <= 0 ? 0
         : (first / kBK < n_tiles ? int(first / kBK) : n_tiles);
  }

  float m[kRows], l[kRows], acc[kRows][NI];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  }

  for (int tile = lo; tile < hi; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();                      // previous tile fully consumed
    load_tile(Ks, g.ks, kp, kBK, k0, sk, d, g.d4);
    load_tile(Vs, g.vs, vp, kBK, k0, sk, d, g.vs);
    __syncthreads();

    // scores of this lane's key against the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(Ks + lane * g.ks);
    const float4* qrows =
        reinterpret_cast<const float4*>(Qs + warp * kRows * g.d4);
    const int n4 = g.d4 / 4;
    for (int c = 0; c < n4; ++c) {
      const float4 kv = krow[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = qrows[r * n4 + c];
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    // mask + online softmax update, one row at a time
    const int kpos = k0 + lane;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r + q_offset;
      bool ok = kpos < sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window >= 0) ok = ok && int64_t(kpos) > int64_t(qpos) - window;
      const float sv = ok ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sv));
      float alpha, pv;
      if (m_new == -INFINITY) {           // nothing visible yet
        alpha = 1.f;
        pv = 0.f;
      } else {
        alpha = expf(m[r] - m_new);
        pv = ok ? expf(sv - m_new) : 0.f;
      }
      l[r] = l[r] * alpha + warp_sum(pv);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] *= alpha;
      p[r] = pv;
    }

    // acc[r][i] += sum_j p[r](lane j) * V[j][lane + 32 i]
    const int kmax = min(kBK, sk - k0);
    for (int j = 0; j < kmax; ++j) {
      float vv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) vv[i] = Vs[j * g.vs + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= sq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int c = lane + 32 * i;
      if (c < d) op[int64_t(row) * d + c] = from_f32<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int NI>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t b, int64_t hq, int64_t hkv, int64_t sq, int64_t sk,
           int64_t d, int64_t causal, int64_t window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(int(d), NI);
  auto kernel = flash_attention_kernel<T, NI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(unsigned(b * hq), unsigned((sq + kBQ - 1) / kBQ));
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), int(hq),
      int(hq / hkv), int(sq), int(sk), int(d), int(causal), window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_ni(const void* q, const void* k, const void* v, void* out,
                int64_t b, int64_t hq, int64_t hkv, int64_t sq, int64_t sk,
                int64_t d, int64_t causal, int64_t window, float scale,
                cudaStream_t stream) {
  const int64_t d4 = (d + 3) / 4 * 4;
  if (d4 <= 32)
    return launch<T, 1>(q, k, v, out, b, hq, hkv, sq, sk, d, causal,
                        window, scale, stream);
  if (d4 <= 64)
    return launch<T, 2>(q, k, v, out, b, hq, hkv, sq, sk, d, causal,
                        window, scale, stream);
  if (d4 <= 128)
    return launch<T, 4>(q, k, v, out, b, hq, hkv, sq, sk, d, causal,
                        window, scale, stream);
  return launch<T, 8>(q, k, v, out, b, hq, hkv, sq, sk, d, causal, window,
                      scale, stream);
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
      b * hq > 2147483647LL || (sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return dispatch_ni<float>(q, k, v, out, b, hq, hkv, sq, sk, d, causal,
                              window, scale, s);
  if (dtype == DT_BF16)
    return dispatch_ni<__nv_bfloat16>(q, k, v, out, b, hq, hkv, sq, sk, d,
                                      causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
