// bf16 SiLU and sigmoid, each step rounded to bf16 as the JAX program
// rounds them, in one elementwise pass.
//
// Replaces no TPU kernel: a port-only kernel.  JAX writes flax's bf16
// SiLU into its StableHLO as five bf16 ops (negate, exponential, add 1,
// divide 1 by it, multiply by x), jax.nn.sigmoid as the first four, so
// every backend rounds after each step.  torch's F.silu and torch.sigmoid
// round once; five torch passes round as JAX does but read and write the
// tensor five times.
// Plain version: litepi_tpu_torch/ops/act.py::silu_bf16_plain and
// sigmoid_bf16_plain.
//
// Contract: x and y n bf16 values, any dense layout (both the same), y =
// silu(x) or sigmoid(x): e = bf16(expf(-x)), a = bf16(1 + e), s = bf16(1 /
// a), silu: y = bf16(x * s), sigmoid: y = s.  expf is the one torch's CUDA
// exp takes, so each step rounds as the plain version's (--fmad=false keeps
// every operation apart).  1 / a comes from the hardware reciprocal
// (rcp.approx.f32, at most 1 float32 ulp off) and is rounded to bf16 all
// the same as the IEEE quotient: a is a bf16 value, A * 2^k with A an
// 8-bit integer, so 1/a = 2^-k / A is never a bf16 rounding midpoint (odd
// 9-bit significand times a power of two; A * odd is no power of two) and
// lies at least 2^-17 of its size from one, far beyond that 1 ulp (2^-23).
// The divide's Newton steps and range checks were a quarter of the
// instructions per value.
//
// What bounds it on the H100: bytes.  It reads and writes 2 bytes per
// value, 4 bytes against ~20 operations: at the YOLOv11n B=128 bf16 batch's
// largest SiLU (128 x 16 x 320 x 320 values) 420 MB, 0.125 ms at 3.35 TB/s.
//
// Design: each thread takes 8 values as one 16-byte load and store, in a
// grid-stride loop over whole 8-value groups; a scalar tail takes the rest,
// and the whole tensor when either pointer is not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 1 / a for a bf16 value a >= 1 (or inf), within 1 float32 ulp, subnormal
// results kept: its bf16 rounding is the IEEE quotient's (see above)
__device__ __forceinline__ float rcp_of_bf16(float a) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

template <bool kSilu>
__device__ __forceinline__ __nv_bfloat16 act(__nv_bfloat16 xv) {
  const float x = __bfloat162float(xv);
  const float e = round_bf16(expf(-x));
  const float a = round_bf16(1.0f + e);
  const float s = rcp_of_bf16(a);
  return __float2bfloat16_rn(kSilu ? x * round_bf16(s) : s);
}

template <bool kSilu>
__global__ void act_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                               long long groups) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < groups;
       i += (long long)gridDim.x * blockDim.x) {
    uint4 v = x[i];
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = act<kSilu>(h[j]);
    y[i] = v;
  }
}

template <bool kSilu>
__global__ void act_scalar_kernel(const __nv_bfloat16* __restrict__ x,
                                  __nv_bfloat16* __restrict__ y, long long start,
                                  long long n) {
  for (long long i = start + blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    y[i] = act<kSilu>(x[i]);
  }
}

int blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

template <bool kSilu>
cudaError_t launch(const void* x, void* y, long long n, cudaStream_t s) {
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const long long groups = aligned ? n / 8 : 0;
  if (groups > 0) {
    act_vec_kernel<kSilu><<<blocks_for(groups), kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), groups);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long long start = groups * 8;
  if (start < n) {
    act_scalar_kernel<kSilu><<<blocks_for(n - start), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), start, n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int litepi_act_bf16(const void* x, void* y, long long n, int silu,
                               void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return silu ? launch<true>(x, y, n, s) : launch<false>(x, y, n, s);
}
