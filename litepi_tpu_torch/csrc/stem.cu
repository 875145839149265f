// The detector's stem on uint8 frames: 3x3 conv, stride 2, pad 1, + bias
// + SiLU, in one pass.
//
// Replaces: litepi_tpu/ops/pallas_stem.py::pallas_stem (Pallas body from
// _make_kernel), which Mosaic could not lower, so the JAX package ran the
// stem as a float canvas cast + XLA convolution instead.
// Plain version: litepi_tpu_torch/ops/stem.py::stem_plain.
//
// Contract: frames (B, H, W, 3) uint8 NHWC in the host's colour order,
// H and W even; weight (27, C) float32, the deploy-form HWIO kernel with
// the 1/255 input scale and the colour flip folded in, row t = (dy * 3 +
// dx) * 3 + ci; bias (C,) float32 -> out (B, C, H/2, W/2) NCHW, float32 or
// bfloat16 (rounded to nearest even once, from float32).  Output pixel
// (oy, ox) reads input pixels (2 * oy - 1 + dy, 2 * ox - 1 + dx), zero
// outside the frame.  y = the sum over the 27 taps in t order (fused
// multiply-adds) + bias, then y * sigmoid(y), all in float32.
//
// What bounds it on the H100: bytes and operations about equally.  At the
// serving size (B=128, 640x640, C=16, bf16 out) it reads 157 MB of uint8
// and writes 419 MB of bf16: 577 MB, 0.172 ms at 3.35 TB/s; 27
// multiply-adds, the bias add and SiLU's add, divide and multiply are 58
// operations per output value, 12.2 GFLOP, 0.182 ms at 67 TFLOP/s.  The
// cuDNN path it replaces wrote a bf16 canvas first (a separate cast pass)
// and then ran a generic 3-channel convolution; here each frame byte is
// read once and no float canvas exists.
//
// Design: one thread per output pixel computing all C channels, the
// simplest form that reads the frame once.  The weights and bias sit in
// shared memory (28 * C floats; every thread of a warp reads the same
// words, a broadcast); the 27 taps sit in registers.  Channels go in
// chunks of 16 register accumulators: per tap, 4 128-bit shared loads and
// 16 fused multiply-adds (explicit fmaf: the build's --fmad=false would
// otherwise split each into a multiply and an add, twice the instructions
// of this issue-bound loop); channel counts that are not a multiple of 4
// take a plain loop.  Consecutive threads take consecutive output columns,
// so for each channel a warp writes one contiguous run of the NCHW plane.
// A grid-stride loop over a few blocks per SM loads the weights once per
// block.  The TPU kernel's 40-row chunks, im2col matmul and lane
// regrouping were TPU devices and are gone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 27;
constexpr int kMaxChannels = 256;  // 28 * 256 floats = 28 KB of shared memory
constexpr int kBlocksPerSM = 16;
constexpr int kChunk = 16;  // channels per pass of register accumulators

__device__ __forceinline__ float silu(float y) { return y * (1.f / (1.f + expf(-y))); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) stem_kernel(
    const uint8_t* __restrict__ frames, const float* __restrict__ weight,
    const float* __restrict__ bias, T* __restrict__ out, int H, int W, int C,
    size_t total) {
  extern __shared__ float4 smem4[];  // weight (27, C), then bias (C)
  float* smem = reinterpret_cast<float*>(smem4);
  for (int i = threadIdx.x; i < (kTaps + 1) * C; i += blockDim.x)
    smem[i] = i < kTaps * C ? weight[i] : bias[i - kTaps * C];
  __syncthreads();
  const float* w_s = smem;
  const float* b_s = smem + kTaps * C;

  const int OH = H / 2, OW = W / 2;
  const size_t plane = (size_t)OH * OW;
  // 128-bit weight loads need 16-byte aligned rows: C a multiple of 4
  const int c_chunked = C % 4 == 0 ? C - C % kChunk : 0;
  for (size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x; p < total;
       p += (size_t)gridDim.x * blockDim.x) {
    const int ox = (int)(p % OW);
    const int oy = (int)((p / OW) % OH);
    const size_t b = p / plane;
    const uint8_t* img = frames + b * H * W * 3;

    float x[kTaps];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int iy = 2 * oy - 1 + dy;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ix = 2 * ox - 1 + dx;
        const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
        const uint8_t* px = img + ((size_t)(inside ? iy : 0) * W + (inside ? ix : 0)) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          x[(dy * 3 + dx) * 3 + c] = inside ? (float)px[c] : 0.f;
      }
    }

    T* o = out + b * C * plane + (size_t)oy * OW + ox;
    for (int c0 = 0; c0 < c_chunked; c0 += kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const float4* wr = reinterpret_cast<const float4*>(w_s + t * C + c0);
#pragma unroll
        for (int q = 0; q < kChunk / 4; ++q) {
          const float4 w4 = wr[q];
          acc[4 * q + 0] = __fmaf_rn(x[t], w4.x, acc[4 * q + 0]);
          acc[4 * q + 1] = __fmaf_rn(x[t], w4.y, acc[4 * q + 1]);
          acc[4 * q + 2] = __fmaf_rn(x[t], w4.z, acc[4 * q + 2]);
          acc[4 * q + 3] = __fmaf_rn(x[t], w4.w, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        store(o + (size_t)(c0 + j) * plane, silu(acc[j] + b_s[c0 + j]));
    }
    for (int co = c_chunked; co < C; ++co) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) acc = __fmaf_rn(x[t], w_s[t * C + co], acc);
      store(o + (size_t)co * plane, silu(acc + b_s[co]));
    }
  }
}

}  // namespace

extern "C" int litepi_stem(const void* frames, const void* weight,
                           const void* bias, void* out, int B, int H, int W,
                           int C, int out_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || C <= 0 ||
      C > kMaxChannels)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)B * (H / 2) * (W / 2);
  const size_t want = (total + kThreads - 1) / kThreads;
  const unsigned blocks =
      (unsigned)(want < (size_t)sms * kBlocksPerSM ? want : (size_t)sms * kBlocksPerSM);
  const size_t shmem = (size_t)(kTaps + 1) * C * sizeof(float);
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  const float* w = static_cast<const float*>(weight);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    stem_kernel<__nv_bfloat16><<<blocks, kThreads, shmem, s>>>(
        f, w, bi, static_cast<__nv_bfloat16*>(out), H, W, C, total);
  else
    stem_kernel<float><<<blocks, kThreads, shmem, s>>>(
        f, w, bi, static_cast<float*>(out), H, W, C, total);
  return cudaGetLastError();
}
