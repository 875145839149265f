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
// and the whole tensor when any pointer is not 16-byte aligned.
//
// Backward mode (litepi_act_bf16_backward): dx from x and the output's
// gradient g, as jax.vjp of the same bf16 ops computes it, each op rounded
// to bf16 (its plain version: ops/act.py::silu_bf16_grad_plain and
// sigmoid_bf16_grad_plain).  JAX differentiates logistic as s * (1 - s):
// with s the forward's bf16 sigmoid, d = bf16(s * bf16(1 - s)); SiLU's
// dx = bf16(bf16(g * s) + bf16(bf16(x * g) * d)), sigmoid's dx = bf16(g *
// d).  One pass, reading x and g and writing dx: 6 bytes per value, what
// bounds it on the card.
//
// Bias mode (litepi_silu_bias_bf16): y = silu(bf16(x + bias[c])) for a
// biased conv's output x (N, C, H, W) taken without its bias, in place of
// the conv's bias add and the SiLU pass after it.  Replaces no TPU kernel:
// the JAX program's biased bf16 nn.Conv adds its bias as an op of its own
// (float sum of the two bf16 values, one rounding), then flax's SiLU; on
// the card torch's biased bf16 conv does the same (cuDNN's output, then
// ATen's bf16 add of the broadcast bias, which TensorIterator cannot
// vectorise).  Here v = bf16(float(x) + float(bias[c])), ATen's add with
// alpha 1, then the five SiLU steps on v, each rounded as above: the same
// bits as the two passes (chip_smoke.py holds it to the plain version on
// every pair of bf16 values).  Plain version:
// ops/act.py::silu_bias_bf16_plain.
// Bound by bytes: 4 bytes per value plus the bias, one pass where the two
// passes moved 8.  Layouts: NCHW-contiguous, channel (i / HW) % C, where
// with HW % 8 == 0 a 16-byte group of 8 values lies in one channel, so the
// vector path loads its bias once (other HW take the scalar path); and
// channels_last-contiguous, channel i % C, one bias per lane (C may be 12).
// What held it back on the H100, over the litepi detector's 56 SiLU conv
// outputs at B=256 (9.5 GB, 2.83 ms at 3.35 TB/s): first the channel index,
// two 32-bit divides per 8 values (4.21 ms), then the roundings' float ->
// bf16 conversions (4.03 ms with the divides gone).  Indices are 32-bit
// below 2^31 values and divided by a multiply and a shift (Divider); the
// vector path takes its values in pairs and rounds each pair with one
// packed conversion (cvt.rn.bf16x2.f32): 3.58-3.61 ms, 79% of the bound,
// where the SiLU pass alone takes 3.64-3.66 ms.
//
// BatchNorm mode (litepi_bn_act_bf16): y = silu(v) or y = v, v = bf16(w *
// (x - m) * invstd + s), for a bias-free conv's output x (N, C, H, W) and
// an eval BatchNorm's float32 running mean m and variance, weight w and
// bias s, in place of ATen's BatchNorm pass and the SiLU pass after it
// (the identity: the ConvBNs without an activation).  Replaces no TPU
// kernel: the JAX program's flax BatchNorm in bf16.  ATen's eval BatchNorm
// on a bf16 tensor with float32 parameters (batch_norm_transform_input
// and its channels-last twin, ATen/native/cuda/Normalization.cuh) takes
// invstd = rsqrtf(var + float(eps)) in a kernel of its own and computes w
// * (x - m) * invstd + s in float32, the last multiply and the add
// contracted into one FMA (ATen builds with contraction on; here it is
// written out), rounded once to bf16; the SiLU steps then round as
// above.  Here the same operations in the same order, so the same bits
// (chip_smoke.py holds the mode to ATen's two passes and to the plain
// versions, ops/act.py::batch_norm_bf16_plain and
// batch_norm_silu_bf16_plain).  Each block stages the C channels' (m,
// invstd, w, s) in shared memory from the live buffers, a 16-byte record
// per channel with one record of padding after every 8, so that a warp's
// lanes, 8 channels apart in channels last, read 8 different banks' words
// in each quarter-warp; NCHW's groups of 8 lie in one channel (H * W % 8
// == 0, else the scalar path).  C is at most kMaxBnChannels (37 KB).
// Layouts, index types and pair rounding as the bias mode's.  Bound by
// bytes: 4 bytes per value, where the two passes it replaces move 8 and
// ATen's BatchNorm pass also launches a copy of the mean and the invstd
// kernel.

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

// the forward's bf16 sigmoid of x, as a float
__device__ __forceinline__ float sigmoid_bf16(float x) {
  const float e = round_bf16(expf(-x));
  const float a = round_bf16(1.0f + e);
  return round_bf16(rcp_of_bf16(a));
}

template <bool kSilu>
__device__ __forceinline__ __nv_bfloat16 act_grad(__nv_bfloat16 xv, __nv_bfloat16 gv) {
  const float x = __bfloat162float(xv);
  const float g = __bfloat162float(gv);
  const float s = sigmoid_bf16(x);
  const float d = round_bf16(s * round_bf16(1.0f - s));
  if (kSilu) {
    return __float2bfloat16_rn(round_bf16(g * s) + round_bf16(round_bf16(x * g) * d));
  }
  return __float2bfloat16_rn(g * d);
}

template <bool kSilu>
__global__ void grad_vec_kernel(const uint4* __restrict__ x, const uint4* __restrict__ g,
                                uint4* __restrict__ dx, long long groups) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < groups;
       i += (long long)gridDim.x * blockDim.x) {
    uint4 v = x[i];
    const uint4 w = g[i];
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
    const __nv_bfloat16* k = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = act_grad<kSilu>(h[j], k[j]);
    dx[i] = v;
  }
}

template <bool kSilu>
__global__ void grad_scalar_kernel(const __nv_bfloat16* __restrict__ x,
                                   const __nv_bfloat16* __restrict__ g,
                                   __nv_bfloat16* __restrict__ dx, long long start,
                                   long long n) {
  for (long long i = start + blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    dx[i] = act_grad<kSilu>(x[i], g[i]);
  }
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

// SiLU of v = bf16(x + b), the bias add rounded as ATen's bf16 add
__device__ __forceinline__ __nv_bfloat16 silu_biased(__nv_bfloat16 xv, float b) {
  return act<true>(__float2bfloat16_rn(__bfloat162float(xv) + b));
}

// silu_biased on two values at once: each rounding to bf16 one packed
// conversion (cvt.rn.bf16x2.f32) for the pair
__device__ __forceinline__ float2 round_bf16x2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// the five SiLU steps on two bf16 values v (as floats)
__device__ __forceinline__ __nv_bfloat162 silu2(float2 v) {
  const float2 e = round_bf16x2(expf(-v.x), expf(-v.y));
  const float2 a = round_bf16x2(1.0f + e.x, 1.0f + e.y);
  const float2 s = round_bf16x2(rcp_of_bf16(a.x), rcp_of_bf16(a.y));
  return __floats2bfloat162_rn(v.x * s.x, v.y * s.y);
}

__device__ __forceinline__ __nv_bfloat162 silu_biased2(__nv_bfloat162 xv, float b0, float b1) {
  const float2 x = __bfloat1622float2(xv);
  return silu2(round_bf16x2(x.x + b0, x.y + b1));
}

// one channel of an eval BatchNorm: its running mean, rsqrtf(var + eps),
// weight and bias
struct __align__(16) BnChannel {
  float mean, invstd, weight, shift;
};

constexpr int kMaxBnChannels = 2048;  // ops/act.py::BN_ACT_MAX_CHANNELS

// channel c's record in shared memory: one record of padding after every 8
__device__ __forceinline__ unsigned bn_slot(unsigned c) { return c + (c >> 3); }

size_t bn_shared_bytes(long long c) { return (size_t)(c + c / 8 + 1) * sizeof(BnChannel); }

// ATen's w * (x - m) * invstd + s, its last multiply and add one FMA
__device__ __forceinline__ float bn_value(float x, const BnChannel& p) {
  return __fmaf_rn(__fmul_rn(p.weight, __fsub_rn(x, p.mean)), p.invstd, p.shift);
}

template <bool kSilu>
__device__ __forceinline__ __nv_bfloat16 bn_act(__nv_bfloat16 xv, const BnChannel& p) {
  const __nv_bfloat16 v = __float2bfloat16_rn(bn_value(__bfloat162float(xv), p));
  return kSilu ? act<true>(v) : v;
}

template <bool kSilu>
__device__ __forceinline__ __nv_bfloat162 bn_act2(__nv_bfloat162 xv, const BnChannel& p0,
                                                  const BnChannel& p1) {
  const float2 x = __bfloat1622float2(xv);
  const float v0 = bn_value(x.x, p0), v1 = bn_value(x.y, p1);
  return kSilu ? silu2(round_bf16x2(v0, v1)) : __floats2bfloat162_rn(v0, v1);
}

struct BnArgs {
  const float *mean, *var, *weight, *bias;
  float eps;
};

// the C channels' records into shared memory, from the live buffers
__device__ __forceinline__ void stage_bn(BnChannel* sm, const BnArgs& bn, unsigned c) {
  for (unsigned k = threadIdx.x; k < c; k += blockDim.x) {
    sm[bn_slot(k)] = BnChannel{bn.mean[k], rsqrtf(__fadd_rn(bn.var[k], bn.eps)), bn.weight[k],
                               bn.bias[k]};
  }
  __syncthreads();
}

// n / d in the kernels' index type.  32-bit (below 2^31 values): a multiply
// and a shift, (umulhi(n, magic) + n) >> shift with magic and shift from the
// host (Granlund and Montgomery; ATen's IntDivider<unsigned>), exact for n <
// 2^31, where the sum stays below 2^32.  64-bit: the divide.
template <typename I>
struct Divider;

template <>
struct Divider<unsigned> {
  unsigned d, magic, shift;
  explicit Divider(unsigned long long divisor) : d((unsigned)divisor), shift(0) {
    while ((1ULL << shift) < divisor) ++shift;
    magic = (unsigned)(((1ULL << 32) * ((1ULL << shift) - divisor)) / divisor + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

template <>
struct Divider<unsigned long long> {
  unsigned long long d;
  explicit Divider(unsigned long long divisor) : d(divisor) {}
  __device__ __forceinline__ unsigned long long div(unsigned long long n) const { return n / d; }
};

template <typename I>
__device__ __forceinline__ I mod_by(I n, const Divider<I>& c) {
  return n - c.div(n) * c.d;
}

// groups of 8 values; NCHW: hw8 = HW / 8 groups per channel plane
template <bool kChannelsLast, typename I>
__global__ void act_bias_vec_kernel(const uint4* __restrict__ x,
                                    const __nv_bfloat16* __restrict__ bias,
                                    uint4* __restrict__ y, I groups, Divider<I> c,
                                    Divider<I> hw8) {
  for (I i = blockIdx.x * (I)blockDim.x + threadIdx.x; i < groups;
       i += (I)gridDim.x * blockDim.x) {
    uint4 v = x[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
    if (kChannelsLast) {
      I ch = mod_by(i * 8, c);
      float b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b[j] = __bfloat162float(bias[ch]);
        ch = ch + 1 == c.d ? 0 : ch + 1;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = silu_biased2(h[j], b[2 * j], b[2 * j + 1]);
    } else {
      const float b = __bfloat162float(bias[mod_by(hw8.div(i), c)]);
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = silu_biased2(h[j], b, b);
    }
    y[i] = v;
  }
}

template <bool kChannelsLast, typename I>
__global__ void act_bias_scalar_kernel(const __nv_bfloat16* __restrict__ x,
                                       const __nv_bfloat16* __restrict__ bias,
                                       __nv_bfloat16* __restrict__ y, I start, I n,
                                       Divider<I> c, Divider<I> hw) {
  for (I i = start + blockIdx.x * (I)blockDim.x + threadIdx.x; i < n;
       i += (I)gridDim.x * blockDim.x) {
    const I ch = mod_by(kChannelsLast ? i : hw.div(i), c);
    y[i] = silu_biased(x[i], __bfloat162float(bias[ch]));
  }
}

// groups of 8 values, as act_bias_vec_kernel
template <bool kSilu, bool kChannelsLast, typename I>
__global__ void bn_act_vec_kernel(const uint4* __restrict__ x, BnArgs bn,
                                  uint4* __restrict__ y, I groups, Divider<I> c,
                                  Divider<I> hw8) {
  extern __shared__ BnChannel sm[];
  stage_bn(sm, bn, (unsigned)c.d);
  for (I i = blockIdx.x * (I)blockDim.x + threadIdx.x; i < groups;
       i += (I)gridDim.x * blockDim.x) {
    uint4 v = x[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
    if (kChannelsLast) {
      unsigned ch = (unsigned)mod_by(i * 8, c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const BnChannel p0 = sm[bn_slot(ch)];
        ch = ch + 1 == c.d ? 0 : ch + 1;
        const BnChannel p1 = sm[bn_slot(ch)];
        ch = ch + 1 == c.d ? 0 : ch + 1;
        h[j] = bn_act2<kSilu>(h[j], p0, p1);
      }
    } else {
      const BnChannel p = sm[bn_slot((unsigned)mod_by(hw8.div(i), c))];
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = bn_act2<kSilu>(h[j], p, p);
    }
    y[i] = v;
  }
}

template <bool kSilu, bool kChannelsLast, typename I>
__global__ void bn_act_scalar_kernel(const __nv_bfloat16* __restrict__ x, BnArgs bn,
                                     __nv_bfloat16* __restrict__ y, I start, I n,
                                     Divider<I> c, Divider<I> hw) {
  extern __shared__ BnChannel sm[];
  stage_bn(sm, bn, (unsigned)c.d);
  for (I i = start + blockIdx.x * (I)blockDim.x + threadIdx.x; i < n;
       i += (I)gridDim.x * blockDim.x) {
    const I ch = mod_by(kChannelsLast ? i : hw.div(i), c);
    y[i] = bn_act<kSilu>(x[i], sm[bn_slot((unsigned)ch)]);
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

template <bool kSilu>
cudaError_t launch_grad(const void* x, const void* g, void* dx, long long n, cudaStream_t s) {
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)g % 16 == 0) &&
                       ((uintptr_t)dx % 16 == 0);
  const long long groups = aligned ? n / 8 : 0;
  if (groups > 0) {
    grad_vec_kernel<kSilu><<<blocks_for(groups), kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<const uint4*>(g), static_cast<uint4*>(dx),
        groups);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long long start = groups * 8;
  if (start < n) {
    grad_scalar_kernel<kSilu><<<blocks_for(n - start), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), start, n);
  }
  return cudaGetLastError();
}

template <bool kChannelsLast, typename I>
cudaError_t launch_bias(const void* x, const void* bias, void* y, long long n, long long c,
                        long long hw, cudaStream_t s) {
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const long long groups = aligned && (kChannelsLast || hw % 8 == 0) ? n / 8 : 0;
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(bias);
  if (groups > 0) {
    act_bias_vec_kernel<kChannelsLast, I><<<blocks_for(groups), kThreads, 0, s>>>(
        static_cast<const uint4*>(x), b, static_cast<uint4*>(y), (I)groups, Divider<I>(c),
        Divider<I>(hw / 8 > 0 ? hw / 8 : 1));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long long start = groups * 8;
  if (start < n) {
    act_bias_scalar_kernel<kChannelsLast, I><<<blocks_for(n - start), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), b, static_cast<__nv_bfloat16*>(y), (I)start,
        (I)n, Divider<I>(c), Divider<I>(hw));
  }
  return cudaGetLastError();
}

template <typename I>
cudaError_t launch_bias_as(const void* x, const void* bias, void* y, long long n, long long c,
                           long long hw, bool channels_last, cudaStream_t s) {
  return channels_last ? launch_bias<true, I>(x, bias, y, n, c, hw, s)
                       : launch_bias<false, I>(x, bias, y, n, c, hw, s);
}

template <bool kSilu, bool kChannelsLast, typename I>
cudaError_t launch_bn(const void* x, const BnArgs& bn, void* y, long long n, long long c,
                      long long hw, cudaStream_t s) {
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const long long groups = aligned && (kChannelsLast || hw % 8 == 0) ? n / 8 : 0;
  const size_t smem = bn_shared_bytes(c);
  if (groups > 0) {
    bn_act_vec_kernel<kSilu, kChannelsLast, I><<<blocks_for(groups), kThreads, smem, s>>>(
        static_cast<const uint4*>(x), bn, static_cast<uint4*>(y), (I)groups, Divider<I>(c),
        Divider<I>(hw / 8 > 0 ? hw / 8 : 1));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long long start = groups * 8;
  if (start < n) {
    bn_act_scalar_kernel<kSilu, kChannelsLast, I><<<blocks_for(n - start), kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), bn, static_cast<__nv_bfloat16*>(y), (I)start,
        (I)n, Divider<I>(c), Divider<I>(hw));
  }
  return cudaGetLastError();
}

template <typename I>
cudaError_t launch_bn_as(const void* x, const BnArgs& bn, void* y, long long n, long long c,
                         long long hw, bool channels_last, bool silu, cudaStream_t s) {
  if (silu) {
    return channels_last ? launch_bn<true, true, I>(x, bn, y, n, c, hw, s)
                         : launch_bn<true, false, I>(x, bn, y, n, c, hw, s);
  }
  return channels_last ? launch_bn<false, true, I>(x, bn, y, n, c, hw, s)
                       : launch_bn<false, false, I>(x, bn, y, n, c, hw, s);
}

}  // namespace

extern "C" int litepi_act_bf16_backward(const void* x, const void* g, void* dx, long long n,
                                        int silu, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return silu ? launch_grad<true>(x, g, dx, n, s) : launch_grad<false>(x, g, dx, n, s);
}

extern "C" int litepi_act_bf16(const void* x, void* y, long long n, int silu,
                               void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return silu ? launch<true>(x, y, n, s) : launch<false>(x, y, n, s);
}

extern "C" int litepi_silu_bias_bf16(const void* x, const void* bias, void* y, long long n,
                                     long long c, long long hw, int channels_last,
                                     void* stream) {
  if (n < 0 || c <= 0 || hw <= 0 || n % (c * hw) != 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n < (1LL << 31)
             ? launch_bias_as<unsigned>(x, bias, y, n, c, hw, channels_last != 0, s)
             : launch_bias_as<unsigned long long>(x, bias, y, n, c, hw, channels_last != 0, s);
}

extern "C" int litepi_bn_act_bf16(const void* x, const void* mean, const void* var,
                                  const void* weight, const void* bias, double eps, void* y,
                                  long long n, long long c, long long hw, int channels_last,
                                  int silu, void* stream) {
  if (n < 0 || c <= 0 || c > kMaxBnChannels || hw <= 0 || n % (c * hw) != 0) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // eps as ATen's kernel takes it: the double rounded to float on the host
  const BnArgs bn{static_cast<const float*>(mean), static_cast<const float*>(var),
                  static_cast<const float*>(weight), static_cast<const float*>(bias),
                  static_cast<float>(eps)};
  return n < (1LL << 31)
             ? launch_bn_as<unsigned>(x, bn, y, n, c, hw, channels_last != 0, silu != 0, s)
             : launch_bn_as<unsigned long long>(x, bn, y, n, c, hw, channels_last != 0,
                                                silu != 0, s);
}
