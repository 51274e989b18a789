#!/usr/bin/env python3
"""Two probes of the card behind the float32 kernels' design (PERF.md §6):

* ``mma.sync.m16n8k8`` with tf32 operands: cycles from one product to the
  next on one accumulator (its latency), and cycles a product when a warp
  keeps four accumulators in flight (its issue rate), one warp an SMSP;
* a 16-byte ``cp.async``: cycles a warp spends issuing eight, without
  the source-size operand, with it at a constant 16, and with it chosen
  at run time (16 for a row that exists, else 0, as a kernel staging the
  rows of a ragged last chunk chooses it: ``cp_async_16`` and
  ``cp_async_16_full`` in ``src/repro_torch/csrc/mma_sm90.cuh``).

Compiles its own CUDA source with nvcc into a temporary directory, runs on
one block an SM and prints the cycles (``clock64``) as JSON::

    python3 scripts/tf32_probe.py

Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

SOURCE = r"""
#include <cstdint>

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t b0) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %4, %4, %4}, {%5, %5}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a0), "r"(b0));
}

// ITERS rounds of CHAINS independent accumulators; cycles of warp 0
template <int CHAINS>
__global__ void mma_probe(float* out, long long* cycles, int iters) {
  float acc[CHAINS][4] = {};
  const uint32_t a0 = threadIdx.x | 0x3f800000u, b0 = 0x3f800000u;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mma(acc[c], a0, b0);
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

// ROUNDS x 8 copies of 16 bytes a thread into shared memory; the cycles
// warp 0 spends issuing them (each round's wait for the data is outside)
// MODE 0: no source-size operand; 1: the operand, 16; 2: the operand, 16
// or 0 by a comparison with `rows` at run time (every row exists here)
template <int MODE>
__global__ void copy_probe(const float4* src, long long* cycles,
                           int rounds, int rows) {
  __shared__ __align__(16) float4 dst[8 * 128];
  const float4* p = src + blockIdx.x * 8 * 128;
  long long issuing = 0;
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    const long long t0 = clock64();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t d = static_cast<uint32_t>(
          __cvta_generic_to_shared(dst + k * 128 + threadIdx.x));
      const float4* s = p + k * 128 + threadIdx.x;
      const bool ok = k * 128 + int(threadIdx.x) < rows;
      if (MODE == 0)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(d), "l"(s));
      else
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(ok || MODE == 1 ? s : p),
                        "r"(ok || MODE == 1 ? 16 : 0));
    }
    issuing += clock64() - t0;
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  if (threadIdx.x == 0) cycles[blockIdx.x] = issuing;
}

extern "C" int run_mma(int chains, float* out, long long* cycles, int sms,
                       int iters) {
  if (chains == 1) mma_probe<1><<<sms, 128>>>(out, cycles, iters);
  else mma_probe<4><<<sms, 128>>>(out, cycles, iters);
  return static_cast<int>(cudaDeviceSynchronize());
}

extern "C" int run_copy(int mode, const float4* src, long long* cycles,
                        int sms, int rounds, int rows) {
  if (mode == 0) copy_probe<0><<<sms, 128>>>(src, cycles, rounds, rows);
  if (mode == 1) copy_probe<1><<<sms, 128>>>(src, cycles, rounds, rows);
  if (mode == 2) copy_probe<2><<<sms, 128>>>(src, cycles, rounds, rows);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tf32_probe.py: no CUDA card", file=sys.stderr)
        return 1
    nvcc = "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = pathlib.Path(tmp, "probe.cu"), pathlib.Path(tmp, "probe.so")
        cu.write_text(SOURCE)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                        str(so), str(cu)], check=True)
        lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.run_mma.argtypes = [I, P, P, I, I]
    lib.run_copy.argtypes = [I, P, P, I, I, I]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cycles = torch.zeros(sms, dtype=torch.int64, device=dev)
    out = torch.empty(sms * 128, device=dev)
    iters, rounds = 4096, 256
    result = {"device": torch.cuda.get_device_name(0)}
    for chains in (1, 4):
        for _ in range(2):                  # the second run is the reading
            assert lib.run_mma(chains, out.data_ptr(), cycles.data_ptr(),
                               sms, iters) == 0
        result[f"mma_tf32_cycles_a_product_{chains}_chains"] = \
            float(cycles.double().mean()) / (iters * chains)
    src = torch.zeros(sms * 8 * 128 * 4, device=dev)
    for mode, key in enumerate(("without_size_operand", "size_operand_16",
                                "size_operand_at_run_time")):
        for _ in range(2):
            assert lib.run_copy(mode, src.data_ptr(), cycles.data_ptr(),
                                sms, rounds, 8 * 128) == 0
        result[f"cp_async_cycles_a_round_of_8_{key}"] = \
            float(cycles.double().mean()) / rounds
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
