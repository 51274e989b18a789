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
// Bound: bytes.  A step does about 4 N P flops per (batch, head) against
// P elements of x read and P of y written (plus dt and the group's B, C);
// at zamba2's prefill shape (4096 tokens, 112 heads, P = 64, N = 64, bf16)
// that is 7.5 GFLOP (8 us at the bf16 peak) against 118 MB (35 us at
// 3.35 TB/s).
//
// Design: sequential in T, with the state in registers; the TPU kernel's
// chunked dual form (on the tensor cores here) is later work.
//   * grid = (ceil(P / 32), H, B); a block of 256 threads owns 32 columns
//     p of one (batch, head)'s state: thread (pl, ng) keeps the states
//     n = ng, ng + 8, ..., (KN of them, KN a template parameter) of column
//     pl in registers, across the whole sequence.
//   * The block walks T in chunks of 32 steps.  Each chunk's x columns,
//     dt, and the group's B and C rows are staged in shared memory as
//     float32 (bfloat16 widened on load, N padded with zeros to 8 KN), with
//     coalesced loads by all threads; then each thread runs the 32 steps
//     from shared memory.  y_t's sum over n is a shuffle reduction over the
//     8 threads of a column, and the chunk's y tile leaves in one coalesced
//     store.
//   * Any T: the last chunk is cut short; any P: columns past P stay zero
//     and are not stored.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// Element types; the codes are repro_torch.kernels._build.DTYPE_CODES,
// pinned by tests/test_torch_kernel_layout.py.
enum DType { DT_F32 = 0, DT_BF16 = 1 };

constexpr int kCols = 32;                // state columns p per block
constexpr int kGroups = 8;               // threads sharing a column (split n)
constexpr int kThreads = kCols * kGroups;
constexpr int kChunk = 32;               // time steps staged at once
constexpr int kMaxN = 128;

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

template <typename T, int KN>
__global__ void __launch_bounds__(kThreads)
mamba2_ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, T* __restrict__ y, int t_len,
                  int h_heads, int p_dim, int g_groups, int n_state) {
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
        v = to_f32(x[((int64_t(b) * t_len + t0 + tt) * h_heads + h) * p_dim
                     + p0 + c]);
      xs[tt][c] = v;
    }
    for (int i = tid; i < kChunk; i += kThreads)
      dts[i] = i < tc ? to_f32(dt[(int64_t(b) * t_len + t0 + i) * h_heads
                                  + h])
                      : 0.f;
    for (int i = tid; i < kChunk * NP; i += kThreads) {
      const int tt = i / NP, n = i % NP;
      float bv = 0.f, cv = 0.f;
      if (tt < tc && n < n_state) {
        const int64_t off =
            ((int64_t(b) * t_len + t0 + tt) * g_groups + grp) * n_state + n;
        bv = to_f32(Bm[off]);
        cv = to_f32(Cm[off]);
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
            from_f32<T>(ys[tt][c]);
    }
  }
}

template <typename T, int KN>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, int64_t b, int64_t t, int64_t h,
           int64_t p, int64_t g, int64_t n, cudaStream_t stream) {
  dim3 grid(unsigned((p + kCols - 1) / kCols), unsigned(h), unsigned(b));
  mamba2_ssd_kernel<T, KN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), int(t), int(h),
      int(p), int(g), int(n));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_kn(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, void* y, int64_t b, int64_t t, int64_t h,
                int64_t p, int64_t g, int64_t n, cudaStream_t stream) {
  if (n <= kGroups * 2)
    return launch<T, 2>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
  if (n <= kGroups * 4)
    return launch<T, 4>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
  if (n <= kGroups * 8)
    return launch<T, 8>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
  return launch<T, 16>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, stream);
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
      b > 65535 || t > 2147483647LL - kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return dispatch_kn<float>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n, s);
  if (dtype == DT_BF16)
    return dispatch_kn<__nv_bfloat16>(x, dt, A, Bm, Cm, y, b, t, h, p, g, n,
                                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}
