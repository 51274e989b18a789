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
// Bound: bytes.  A step does 7 K V flops per (batch, head) against K
// elements each of r, k, w and V of v read and V of y written; at
// rwkv6-7b's prefill shape (4096 tokens, 64 heads, K = V = 64, bf16) that
// is 7.5 GFLOP (8 us at the bf16 tensor-core peak, 112 us on the float32
// CUDA cores this form runs on) against 168 MB (50 us at 3.35 TB/s).
//
// Design: the sequential form, latency-bound on its step, with the state in
// registers; the chunked form on the tensor cores is later work.
//   * grid = (ceil(V / 16), H, B); a block of 128 threads owns 16 value
//     columns of one (batch, head)'s state for the whole sequence: thread
//     (pl, ng) keeps, of column pl, the 4 J states k = 32 j + 4 ng + e
//     (j < J, e < 4; J = ceil(K / 32) a template parameter) in registers.
//   * The block walks T in chunks of 32 steps.  Each chunk's r, k and w rows
//     (K padded with zeros to 32 J) and v columns are staged in shared
//     memory as float32 (bfloat16 widened there).  The global loads of
//     chunk c + 1 go to registers before chunk c's steps run, so their
//     latency hides behind the steps (the staging loads, waited for in
//     place, had cost the first design more than half its time); a
//     thread's share is 52 values at K = 64, coalesced across the block.
//     Each thread runs the 32 steps from shared memory, reading its r, k, w
//     slices as float4s (a column's 8 threads read 128 contiguous bytes: no
//     bank conflicts).  A step's only dependent chain is the thread's
//     partial sum of y_t over its k; the partials go to shared memory, and
//     the sum over a column's 8 threads is taken once a chunk, in the
//     coalesced store of the chunk's y tile.
//   * Any T: the last chunk is cut short; any V: columns past V stay zero
//     and are not stored; K <= 64: padded keys have k = 0, so their states
//     stay 0.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Element types; the codes are repro_torch.kernels._build.DTYPE_CODES,
// pinned by tests/test_torch_kernel_layout.py.
enum DType { DT_F32 = 0, DT_BF16 = 1 };

constexpr int kCols = 16;                // value columns per block
constexpr int kGroups = 8;               // threads sharing a column (split k)
constexpr int kThreads = kCols * kGroups;
constexpr int kChunk = 32;               // time steps staged at once
constexpr int kMaxK = 64;
static_assert(kGroups == 8, "the y partials are summed as two float4s");
static_assert(kChunk * kCols % kThreads == 0 && 32 * kChunk % kThreads == 0,
              "the staging loops give every thread the same trip count");

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

// one state of the column: its share of y_t, then the decayed update
__device__ __forceinline__ void wkv_step(float r, float k, float w, float u,
                                         float v, float& s, float& acc) {
  const float kv = k * v;
  acc = fmaf(r, fmaf(u, kv, s), acc);
  s = fmaf(w, s, kv);
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
rwkv6_wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, T* __restrict__ y, int t_len,
                 int h_heads, int k_dim, int v_dim) {
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
  const T* rb = r + bh * t_len * k_dim;
  const T* kb = k + bh * t_len * k_dim;
  const T* wb = w + bh * t_len * k_dim;
  const T* vb = v + bh * t_len * v_dim;
  T* yb = y + bh * t_len * v_dim;

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
  T pr[NL], pk[NL], pw[NL], pv[NV];
  auto fetch = [&](int t0) {
    const int tc = min(kChunk, t_len - t0);
#pragma unroll
    for (int it = 0; it < NL; ++it) {
      const int i = tid + it * kThreads;
      const int tt = i / KP, kk = i % KP;
      pr[it] = pk[it] = pw[it] = from_f32<T>(0.f);
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
                   : from_f32<T>(0.f);
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
      rs[tt][kk] = to_f32(pr[it]);
      ks[tt][kk] = to_f32(pk[it]);
      ws[tt][kk] = to_f32(pw[it]);
    }
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      const int i = tid + it * kThreads;
      vs[i / kCols][i % kCols] = to_f32(pv[it]);
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
        yb[int64_t(t0 + tt) * v_dim + c0 + c] = from_f32<T>(
            ((a.x + a.y) + (a.z + a.w)) + ((b.x + b.y) + (b.z + b.w)));
      }
    }
  }
}

template <typename T, int J>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, int64_t b, int64_t h, int64_t t,
           int64_t kd, int64_t vd, cudaStream_t stream) {
  dim3 grid(unsigned((vd + kCols - 1) / kCols), unsigned(h), unsigned(b));
  rwkv6_wkv_kernel<T, J><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<T*>(y), int(t), int(h),
      int(kd), int(vd));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_k(const void* r, const void* k, const void* v, const void* w,
               const void* u, void* y, int64_t b, int64_t h, int64_t t,
               int64_t kd, int64_t vd, cudaStream_t stream) {
  if (kd <= 32) return launch<T, 1>(r, k, v, w, u, y, b, h, t, kd, vd, stream);
  return launch<T, 2>(r, k, v, w, u, y, b, h, t, kd, vd, stream);
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
      t > 2147483647LL - kChunk || vd > 2147483647LL - kCols)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return dispatch_k<float>(r, k, v, w, u, y, b, h, t, kd, vd, s);
  if (dtype == DT_BF16)
    return dispatch_k<__nv_bfloat16>(r, k, v, w, u, y, b, h, t, kd, vd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
