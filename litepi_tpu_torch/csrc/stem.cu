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
// outside the frame.  y = the 27 taps in t order as float32 fused
// multiply-adds.  float32 out: onto the bias for C = 16 and 32, onto 0
// with the bias added last otherwise, then y * sigmoid(y) from the
// hardware exp2 and reciprocal (ex2.approx, rcp.approx: a few float32
// ulps), rounded once.  bfloat16 out, as the JAX bf16 program rounds its
// stem (a biased bf16 conv, then flax's SiLU, whose five steps JAX writes
// into its StableHLO as bf16 ops): the 27 multiply-adds onto 0, rounded
// to bf16; plus the bias, rounded; then SiLU's negate, exp, add 1, divide
// and multiply, each rounded to bf16.  That SiLU is a function of one bf16
// value, so it is read from silu_table: its 65,536 values, indexed by the
// bf16 bit pattern, made once per device by csrc/act.cu's kernel
// (kernels/stem.py::silu_table), which equals the plain version's five
// torch passes bit for bit.  The conv sum rounds as the plain version's
// (its float32 taps sum in the same order, each product exact), so the two
// are bit-equal.  Computing the five steps here (expf, the IEEE divide and
// four roundings) took the serving stem from 0.338 to 0.638 ms.
//
// What bounds it on the H100: bytes and operations about equally.  At the
// serving size (B=128, 640x640, C=16, bf16 out) it reads 157 MB of uint8
// and writes 419 MB of bf16: 577 MB, 0.172 ms at 3.35 TB/s; 27
// multiply-adds, the bias add and SiLU's add, divide and multiply are 58
// operations per output value, 12.2 GFLOP, 0.182 ms at 67 TFLOP/s.  In
// instructions the floor is the 27 fused multiply-adds per value on the
// float32 pipe; everything else a thread issues (loads, conversions, SiLU,
// stores, addresses) comes on top, so the design keeps that small.
//
// Design for C = 16 and 32 (every serving detector's stem, and the small
// test detector's), stem_tiled_kernel:
// - A block takes 4 output rows by 64 output columns of one frame.  It
//   stages the 9 input rows x 400 bytes it needs into shared memory with
//   16-byte cp.async copies (zero-filled outside the frame) when rows are
//   16-byte aligned (W % 16 == 0), byte by byte otherwise.  Each frame
//   byte comes from device memory about once.
// - Warp r computes output row r; lane j computes the two horizontally
//   adjacent pixels 2j and 2j+1.  Their windows share an input column, so
//   a lane reads 5 columns x 3 rows x 3 channels = 45 bytes (as 12 32-bit
//   shared loads) for 2 pixels, converts each once, and keeps 2 x C
//   float32 accumulators.
// - The weights and bias are a kernel parameter (a __grid_constant__
//   struct, 28 * C floats: 1,792 B at C=16), so with the tap and channel
//   loops unrolled every fused multiply-add takes its weight from the
//   constant bank (through a uniform register, one 64-bit uniform load per
//   two weights): no per-thread load is issued for a weight.  The values
//   are on the host at launch; the caller packs them once
//   (kernels/stem.py::pack_stem_params).
// - In float32 out SiLU is 5 instructions (multiply, exp2, add,
//   reciprocal, multiply); __expf and __fdividef without fast math add
//   subnormal range fixes that take several times that.  In bf16 out it is
//   one read of the 128 KB table, which stays in L1 / L2.
// - For each channel a warp stores 64 contiguous outputs as bf16x2 (128
//   bytes) or float2 pairs, into the NCHW plane; odd output widths store
//   one value at a time.
// Four pixels per lane (twice the accumulators, half the blocks per SM)
// and 8- or 16-row tiles ran slower on the H100.  Other channel
// counts take stem_generic_kernel: one thread per output pixel, 27 taps in
// registers, weights in shared memory, 16-channel chunks of register
// accumulators.  The TPU kernel's 40-row chunks, im2col matmul and lane
// regrouping were TPU devices and are gone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTaps = 27;

// y * sigmoid(y) = y / (1 + 2^(-y log2 e)): the hardware exp2 and
// reciprocal, flushing subnormals (what __expf and __fdividef compile to
// under fast math; without it each also pays for subnormal range fixes)
__device__ __forceinline__ float silu(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return y * r;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16 out: the conv sum rounded, the bias added and rounded, then SiLU's
// five bf16 steps, read from the table by the bit pattern
__device__ __forceinline__ unsigned short silu_bf16_bits(
    float conv, float bias, const unsigned short* __restrict__ silu_table) {
  const __nv_bfloat16 y = __float2bfloat16_rn(round_bf16(conv) + bias);
  return __ldg(silu_table + __bfloat16_as_ushort(y));
}

template <typename T>
constexpr bool kBf16Out = sizeof(T) == 2;

// one output value from its conv sum (the bias not in it)
__device__ __forceinline__ void finish(float* p, float conv, float bias,
                                       const unsigned short*) {
  *p = silu(conv + bias);
}
__device__ __forceinline__ void finish(__nv_bfloat16* p, float conv, float bias,
                                       const unsigned short* __restrict__ silu_table) {
  *reinterpret_cast<unsigned short*>(p) = silu_bf16_bits(conv, bias, silu_table);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// two adjacent outputs of one row in one aligned store
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ------------------------------------------------------------------------
// C = 16 and 32: tiled, weights as kernel parameters
// ------------------------------------------------------------------------

constexpr int kTileH = 4;                     // output rows per block: one warp each
constexpr int kTiledThreads = 32 * kTileH;
constexpr int kInRows = 2 * kTileH + 1;       // input rows a block reads

template <int C>
struct StemParams {
  float w[kTaps * C];  // (27, C), row t = (dy * 3 + dx) * 3 + ci
  float b[C];
};

constexpr int kPixels = 2;                    // output pixels per lane
constexpr int kTileW = 32 * kPixels;          // output columns per block
constexpr int kSpan = 16 + 6 * kTileW;        // staged bytes per input row
constexpr int kChunks = kSpan / 16;
constexpr int kCols = 2 * kPixels + 1;        // input columns a lane reads
constexpr int kWords = (3 * kCols + 4) / 4;   // ... as 32-bit words

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

template <int C, typename T>
__global__ void __launch_bounds__(kTiledThreads) stem_tiled_kernel(
    const uint8_t* __restrict__ frames, T* __restrict__ out, int H, int W, int vec_in,
    const unsigned short* __restrict__ silu_table, const __grid_constant__ StemParams<C> p) {
  // Staged row r holds input row 2 * oy0 - 1 + r; its byte k is byte
  // 6 * ox0 - 16 + k of that image row, so input column ix sits at byte
  // (ix - 2 * ox0) * 3 + 16, and the 16 bytes before column 2 * ox0 begin
  // on a 16-byte boundary of the image row.
  __shared__ __align__(16) uint8_t tile[kInRows * kSpan];
  const int OH = H / 2, OW = W / 2;
  const int ox0 = blockIdx.x * kTileW, oy0 = blockIdx.y * kTileH;
  const int row_bytes = W * 3;
  const uint8_t* img = frames + (size_t)blockIdx.z * H * row_bytes;
  const int g0 = 6 * ox0 - 16, iy0 = 2 * oy0 - 1;
  if (vec_in) {
    // rows are 16-byte aligned and row_bytes % 16 == 0: a chunk lies
    // wholly inside the row or wholly outside it (then zero-filled)
    for (int i = threadIdx.x; i < kInRows * kChunks; i += kTiledThreads) {
      const int r = i / kChunks, q = i - r * kChunks;
      const int iy = iy0 + r, gb = g0 + 16 * q;
      const bool inside = iy >= 0 && iy < H && gb >= 0 && gb < row_bytes;
      cp_async16(tile + r * kSpan + 16 * q,
                 inside ? img + (size_t)iy * row_bytes + gb : frames, inside ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  } else {
    for (int i = threadIdx.x; i < kInRows * kSpan; i += kTiledThreads) {
      const int r = i / kSpan, k = i - r * kSpan;
      const int iy = iy0 + r, gb = g0 + k;
      tile[i] = iy >= 0 && iy < H && gb >= 0 && gb < row_bytes
                    ? img[(size_t)iy * row_bytes + gb]
                    : 0;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int oy = oy0 + r, ox = ox0 + kPixels * lane;
  if (oy >= OH || ox >= OW) return;

  float acc[kPixels][C];  // pixels ox and ox + 1
#pragma unroll
  for (int k = 0; k < kPixels; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] = kBf16Out<T> ? 0.f : p.b[c];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    // the lane's input columns 2 * ox - 1 .. 2 * ox + 3 are bytes 1 .. 15
    // of the 4-byte aligned word run at 12 * lane + 12
    const uint32_t* wr =
        reinterpret_cast<const uint32_t*>(tile + (2 * r + dy) * kSpan + 12 * lane + 12);
    uint32_t wd[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) wd[i] = wr[i];
    float x[3 * kCols];
#pragma unroll
    for (int i = 0; i < 3 * kCols; ++i)
      x[i] = (float)((wd[(i + 1) >> 2] >> (8 * ((i + 1) & 3))) & 0xffu);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) {
        const int t = (dy * 3 + dx) * 3 + ci;
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int k = 0; k < kPixels; ++k)
            acc[k][c] = __fmaf_rn(x[3 * (2 * k + dx) + ci], p.w[t * C + c], acc[k][c]);
      }
    }
  }

  const size_t plane = (size_t)OH * OW;
  T* o = out + (size_t)blockIdx.z * C * plane + (size_t)oy * OW + ox;
  // an even OW keeps a lane's pair inside one row and its store aligned;
  // odd widths store one value at a time
  const bool pair = OW % 2 == 0, second = ox + 1 < OW;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    T* oc = o + (size_t)c * plane;
    if constexpr (kBf16Out<T>) {
      const unsigned a = silu_bf16_bits(acc[0][c], p.b[c], silu_table);
      const unsigned b = silu_bf16_bits(acc[1][c], p.b[c], silu_table);
      unsigned short* ob = reinterpret_cast<unsigned short*>(oc);
      if (pair) {
        *reinterpret_cast<unsigned*>(ob) = a | (b << 16);
      } else {
        ob[0] = (unsigned short)a;
        if (second) ob[1] = (unsigned short)b;
      }
    } else {
      const float a = silu(acc[0][c]), b = silu(acc[1][c]);
      if (pair) {
        store_pair(oc, a, b);
      } else {
        store(oc, a);
        if (second) store(oc + 1, b);
      }
    }
  }
}

// ------------------------------------------------------------------------
// other channel counts: one thread per output pixel
// ------------------------------------------------------------------------


constexpr int kThreads = 256;
constexpr int kMaxChannels = 256;  // 28 * 256 floats = 28 KB of shared memory
constexpr int kBlocksPerSM = 16;
constexpr int kChunk = 16;  // channels per pass of register accumulators

template <typename T>
__global__ void __launch_bounds__(kThreads) stem_generic_kernel(
    const uint8_t* __restrict__ frames, const float* __restrict__ weight,
    const float* __restrict__ bias, const unsigned short* __restrict__ silu_table,
    T* __restrict__ out, int H, int W, int C, size_t total) {
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
        finish(o + (size_t)(c0 + j) * plane, acc[j], b_s[c0 + j], silu_table);
    }
    for (int co = c_chunked; co < C; ++co) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) acc = __fmaf_rn(x[t], w_s[t * C + co], acc);
      finish(o + (size_t)co * plane, acc, b_s[co], silu_table);
    }
  }
}

template <int C, typename T>
cudaError_t launch_tiled(const uint8_t* frames, const float* params,
                         const unsigned short* silu_table, T* out, int B, int H, int W,
                         cudaStream_t s) {
  StemParams<C> p;
  memcpy(&p, params, sizeof p);
  const int OH = H / 2, OW = W / 2;
  const dim3 grid((OW + kTileW - 1) / kTileW, (OH + kTileH - 1) / kTileH, B);
  const int vec_in = W % 16 == 0 && reinterpret_cast<uintptr_t>(frames) % 16 == 0;
  stem_tiled_kernel<C, T><<<grid, kTiledThreads, 0, s>>>(frames, out, H, W, vec_in,
                                                         silu_table, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const uint8_t* frames, const float* weight, const float* bias,
                   const float* params, const unsigned short* silu_table, T* out, int B,
                   int H, int W, int C, cudaStream_t s) {
  if (C == 16) return launch_tiled<16, T>(frames, params, silu_table, out, B, H, W, s);
  if (C == 32) return launch_tiled<32, T>(frames, params, silu_table, out, B, H, W, s);
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
  stem_generic_kernel<T><<<blocks, kThreads, shmem, s>>>(frames, weight, bias, silu_table,
                                                         out, H, W, C, total);
  return cudaGetLastError();
}

}  // namespace

// params: host float32 (28, C), the weight rows then the bias row; read
// for C = 16 and 32 (copied into the launch), may be null otherwise.
// silu_table: device, 65,536 bf16 values (bf16 SiLU of each bit pattern);
// read for bf16 out, may be null for float32 out.
extern "C" int litepi_stem(const void* frames, const void* weight, const void* bias,
                           const void* params, const void* silu_table, void* out, int B,
                           int H, int W, int C, int out_bf16, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || H % 2 || W % 2 || C <= 0 ||
      C > kMaxChannels)
    return cudaErrorInvalidValue;
  if ((C == 16 || C == 32) && params == nullptr) return cudaErrorInvalidValue;
  if (out_bf16 && silu_table == nullptr) return cudaErrorInvalidValue;
  const unsigned short* table = static_cast<const unsigned short*>(silu_table);
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  const float* w = static_cast<const float*>(weight);
  const float* bi = static_cast<const float*>(bias);
  const float* pr = static_cast<const float*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch(f, w, bi, pr, table, static_cast<__nv_bfloat16*>(out), B, H, W, C, s);
  return launch(f, w, bi, pr, table, static_cast<float*>(out), B, H, W, C, s);
}
