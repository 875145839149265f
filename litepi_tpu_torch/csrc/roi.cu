// ROI crop + bilinear resize of uint8 frames, in one of two modes.
//
// Replaces: litepi_tpu/ops/pallas_roi.py::pallas_crop_and_resize (Pallas
// body from _make_kernel) and, in dense mode, the hat-matmul crop
// litepi_tpu/ops/roi.py::crop_and_resize.
// Plain version: litepi_tpu_torch/ops/roi.py::crop_and_resize_plain.
//
// Contract: levels[k] (B, H_k, W_k, C) uint8 NHWC (level 0 the frames;
// dense mode passes one level), boxes (B, D, 4) float32 xyxy in frame
// pixels, valid (B, D) uint8 -> out (B, D, S, S, C) float32.  Per ROI:
// integer-truncated box (floor), width/height >= 1; the level is the
// number of k < n-1 with extent > exact_extent * 4^k (always 0 in dense
// mode); sample o of an axis sits at u = (o + 0.5) * (extent / S) - 0.5 +
// start in that level's pixels, clamped to [0, limit - 1]; the two taps
// floor(u) and floor(u) + 1 carry weights max(0, 1 - |u - g|), which is the
// JAX hat matrix row restricted to its non-zero entries.  Lerp along y at
// the two source columns, then along x.  Invalid slots are written 0.
// With round_bf16 (the crop of a bf16 pipeline, in either mode) the tap
// weights and both y-lerps are rounded to bf16 values, where the JAX bf16
// dense crop rounds its hat matrices and its y-stage and where the Pallas
// kernel rounds its hat weights and its y-pass dot before the x-pass dot;
// each product is then exact in float32, so every two-tap sum rounds once,
// as in the plain version.
//
// What bounds it on the H100: bytes.  At the serving size (B=128, D=8,
// S=64, C=3) it writes 50 MB of float32 and reads at most 4 taps per
// output pixel, ~15 us at 3.35 TB/s; its ~9 flops per output value are
// noise.  The dense JAX crop spent most of its FLOPs multiplying zero hat
// weights against the whole frame; here each output reads only its taps.
//
// Design: one block per ROI slot, B * D blocks at the serving size.  When
// the batch holds too few ROIs to give every SM kBlocksPerSm blocks (B=8,
// D=8: 64 blocks on 132 SMs), each ROI's output rows are cut into bands,
// one block each, so a small batch still fills the card.  The block
// decides validity and the level once, then builds the ROI's S y-taps and
// S x-taps (source offset
// and weight of both taps) in shared memory, so no output recomputes a
// floor or a divide.  Invalid slots are zeroed with 16-byte stores.  For a
// valid slot the output rows go in chunks: the chunk's two source rows per
// output row, cut to the byte span the ROI's x-taps cover, are staged in
// shared memory with 16-byte cp.async copies; then the threads walk the
// chunk's output floats, which are contiguous, as float4 groups, read
// their taps from shared memory and write 16 bytes each.  Reading each
// tap straight from device memory instead was bound by the latency of
// those scattered byte loads, not by their bytes.  When a chunk
// row does not fit the buffer, S * C % 4 != 0, or the ROI's output does
// not start on a 16-byte boundary, every value gathers its taps from
// device memory instead, with a scalar head and tail around its float4
// groups.  The Pallas kernel's DMA slabs, ROI pairing and planar layout
// were TPU workarounds and are gone; the pyramid levels are built outside
// with plain PyTorch, as the JAX wrapper builds them with reduce_window.
// Built with --fmad=false so that every product and sum rounds as in the
// plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;
constexpr int kMaxOut = 512;  // 2 * 512 taps of 16 bytes: 16 KB of shared memory
constexpr int kSmemBytes = 46 * 1024;  // per block: tap tables + staged rows
                                       // (a larger buffer, fewer chunks: faster)
constexpr int kBlocksPerSm = 4;  // blocks of kSmemBytes that fit on one SM

struct Levels {
  const uint8_t* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int n;
};

struct Taps {
  int i0, i1;
  float w0, w1;
};

// one axis tap of the table: byte offsets of both source lines in the
// level image, and their weights
struct __align__(16) Tap {
  int off0, off1;
  float w0, w1;
};

// x rounded to the nearest bf16 value (ties to even) when kBf16
template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <bool kBf16>
__device__ __forceinline__ Taps axis_taps(int o, float start, float extent,
                                          float limit, int out_size) {
  const float step = extent / (float)out_size;
  float u = ((float)o + 0.5f) * step - 0.5f + start;
  u = fminf(fmaxf(u, 0.f), limit - 1.f);
  const float g0 = floorf(u);
  const float g1 = g0 + 1.f;
  Taps t;
  t.w0 = rnd<kBf16>(fmaxf(1.f - fabsf(u - g0), 0.f));
  t.w1 = rnd<kBf16>(fmaxf(1.f - fabsf(u - g1), 0.f));
  t.i0 = (int)g0;
  t.i1 = (int)fminf(g1, limit - 1.f);
  return t;
}

// floats [f0, f1) of one ROI's output o: a scalar head up to the first
// 16-byte boundary, float4 groups, a scalar tail; value(f) gives float f,
// value4(f, v) the four floats f .. f + 3
template <typename V, typename V4>
__device__ __forceinline__ void walk(float* o, int f0, int f1, V value, V4 value4) {
  const unsigned mis = (unsigned)(reinterpret_cast<uintptr_t>(o + f0) & 15u);
  const int a = f0 + min(f1 - f0, (int)(((16u - mis) & 15u) >> 2));
  const int groups = (f1 - a) >> 2;
  for (int f = f0 + threadIdx.x; f < a; f += blockDim.x) o[f] = value(f);
  float4* o4 = reinterpret_cast<float4*>(o + a);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float v[4];
    value4(a + 4 * g, v);
    o4[g] = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int f = a + 4 * groups + threadIdx.x; f < f1; f += blockDim.x) o[f] = value(f);
}

// one output value from its two source rows r0, r1 (in device or shared
// memory), in the plain version's order: lerp along y at both source
// columns, then along x
template <bool kBf16>
__device__ __forceinline__ float lerp(const uint8_t* r0, const uint8_t* r1, const Tap& y,
                                      const Tap& x, int c) {
  const float t0 = rnd<kBf16>(y.w0 * (float)r0[x.off0 + c] + y.w1 * (float)r1[x.off0 + c]);
  const float t1 = rnd<kBf16>(y.w0 * (float)r0[x.off1 + c] + y.w1 * (float)r1[x.off1 + c]);
  return x.w0 * t0 + x.w1 * t1;
}

// the four values from float f of the ROI on; rows(oy, r0, r1) points r0
// and r1 at output row oy's two source rows, with column byte 0 at offset 0.
// A tap is read from the tables only when the output column or row moves.
template <bool kBf16, typename Rows>
__device__ __forceinline__ void values4(int f, int C, int S, const Tap* ty, const Tap* tx,
                                        Rows rows, float* v) {
  const int p = f / C;
  int c = f - p * C, oy = p / S, ox = p - oy * S;
  Tap y = ty[oy], x = tx[ox];
  const uint8_t *r0, *r1;
  rows(oy, r0, r1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = lerp<kBf16>(r0, r1, y, x, c);
    if (j < 3 && ++c == C) {
      c = 0;
      if (++ox == S) {
        ox = 0;
        y = ty[++oy];
        rows(oy, r0, r1);
      }
      x = tx[ox];
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// one block per ROI slot and band of `band` output rows (gridDim.y bands).
// kC: the channel count, or 0 to take it from c_rt at run time; C = 3
// (every frame the pipeline crops) has its own instantiation, 4% faster on
// an H100 at B=128, D=8, 640x640 (tools/roi_ab.py).  kBf16: round_bf16.
template <int kC, bool kBf16>
__global__ void __launch_bounds__(kThreads) roi_crop_kernel(
    Levels lv, const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
    float* __restrict__ out, int D, int c_rt, int S, int band, float exact_extent) {
  const int C = kC ? kC : c_rt;
  // S y taps, S x taps, then the staged source rows
  extern __shared__ float4 smem4[];
  Tap* ty = reinterpret_cast<Tap*>(smem4);
  Tap* tx = ty + S;
  uint8_t* staged = reinterpret_cast<uint8_t*>(tx + S);
  const int stage_bytes = kSmemBytes - 2 * S * (int)sizeof(Tap);
  const int roi = blockIdx.x;  // b * D + d
  // this block's output rows [oy_begin, oy_end) of the ROI, floats [f0, f1)
  const int oy_begin = blockIdx.y * band, oy_end = min(S, oy_begin + band);
  const int f0 = oy_begin * S * C, f1 = oy_end * S * C;
  float* o = out + (size_t)roi * S * S * C;
  if (!valid[roi]) {
    walk(o, f0, f1, [](int) { return 0.f; },
         [](int, float* v) { v[0] = v[1] = v[2] = v[3] = 0.f; });
    return;
  }
  const float* bx = boxes + (size_t)roi * 4;
  const float x1 = floorf(bx[0]);
  const float y1 = floorf(bx[1]);
  const float bw = fmaxf(floorf(bx[2]) - x1, 1.f);
  const float bh = fmaxf(floorf(bx[3]) - y1, 1.f);
  const float ext = fmaxf(bw, bh);
  int k = 0;
  float s = 1.f;
  for (int q = 0; q + 1 < lv.n; ++q, s *= 4.f) {
    if (ext > exact_extent * s) ++k;
  }
  s = 1.f;
  for (int q = 0; q < k; ++q) s *= 4.f;
  const int lh = lv.h[k], lw = lv.w[k];
  const int row = lw * C;
  for (int i = threadIdx.x; i < 2 * S; i += blockDim.x) {
    const bool along_y = i < S;
    const Taps t = along_y ? axis_taps<kBf16>(i, y1 / s, bh / s, (float)lh, S)
                           : axis_taps<kBf16>(i - S, x1 / s, bw / s, (float)lw, S);
    const int stride = along_y ? row : C;
    ty[i] = Tap{t.i0 * stride, t.i1 * stride, t.w0, t.w1};
  }
  __syncthreads();
  const uint8_t* img = lv.ptr[k] + (size_t)(roi / D) * lh * row;

  // The ROI's source columns span bytes [a0, a0 + span) of a row (taps
  // rise with o).  Output rows go in chunks: the chunk's two source rows
  // per output row are staged in shared memory with 16-byte copies, then
  // its float4 groups are computed from there.
  const int a0 = tx[0].off0 & ~15;
  const int span = ((tx[S - 1].off1 + C + 15) & ~15) - a0;
  const int chunk = min(oy_end - oy_begin, stage_bytes / (2 * span));
  if ((S * C) % 4 == 0 && (reinterpret_cast<uintptr_t>(o) & 15) == 0 && chunk >= 1) {
    // 16-byte copies need 16-byte aligned rows; then span ends in the row
    const bool vec = (reinterpret_cast<uintptr_t>(img) & 15) == 0 && row % 16 == 0;
    const int pieces = span >> 4;
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int oy0 = oy_begin; oy0 < oy_end; oy0 += chunk) {
      const int nr = min(chunk, oy_end - oy0);
      for (int i = threadIdx.x; i < 2 * nr * pieces; i += blockDim.x) {
        const int r = i / pieces, q = i - r * pieces;
        const Tap& t = ty[oy0 + (r >> 1)];
        const int col = a0 + 16 * q;
        const uint8_t* src = img + ((r & 1) ? t.off1 : t.off0) + col;
        uint8_t* dst = staged + r * span + 16 * q;
        if (vec) {
          cp_async16(dst, src);
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) dst[j] = col + j < row ? src[j] : 0;
        }
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      const auto rows = [&](int oy, const uint8_t*& r0, const uint8_t*& r1) {
        r0 = staged + 2 * (oy - oy0) * span - a0;
        r1 = r0 + span;
      };
      const int g1 = (oy0 + nr) * S * C / 4;
      for (int g = oy0 * S * C / 4 + threadIdx.x; g < g1; g += blockDim.x) {
        float v[4];
        values4<kBf16>(4 * g, C, S, ty, tx, rows, v);
        o4[g] = make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
    }
    return;
  }

  // otherwise every value gathers its taps from device memory
  const auto rows = [&](int oy, const uint8_t*& r0, const uint8_t*& r1) {
    r0 = img + ty[oy].off0;
    r1 = img + ty[oy].off1;
  };
  walk(
      o, f0, f1,
      [&](int f) {
        const int p = f / C, oy = p / S;
        const uint8_t *r0, *r1;
        rows(oy, r0, r1);
        return lerp<kBf16>(r0, r1, ty[oy], tx[p - oy * S], f - p * C);
      },
      [&](int f, float* v) { values4<kBf16>(f, C, S, ty, tx, rows, v); });
}

}  // namespace

extern "C" int litepi_roi_crop(const void* const* level_ptrs,
                               const int* level_h, const int* level_w,
                               int n_levels, const void* boxes,
                               const void* valid, void* out, int B, int D,
                               int C, int out_size, float exact_extent,
                               void* stream, int round_bf16) {
  if (n_levels < 1 || n_levels > kMaxLevels || B <= 0 || D <= 0 || C <= 0 ||
      out_size <= 0 || out_size > kMaxOut)
    return cudaErrorInvalidValue;
  Levels lv;
  for (int k = 0; k < kMaxLevels; ++k) {
    const bool used = k < n_levels;
    lv.ptr[k] = used ? static_cast<const uint8_t*>(level_ptrs[k]) : nullptr;
    lv.h[k] = used ? level_h[k] : 0;
    lv.w[k] = used ? level_w[k] : 0;
  }
  lv.n = n_levels;
  // bands of output rows per ROI: enough blocks to fill every SM when the
  // batch holds few ROIs (B=8, D=8: 64), one band when it holds many
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long rois = (long long)B * D;
  const int want = (int)std::min<long long>(out_size, (kBlocksPerSm * sms + rois - 1) / rois);
  const int band = (out_size + want - 1) / want;
  const dim3 grid((unsigned)rois, (unsigned)((out_size + band - 1) / band));
  const auto kernel = round_bf16 ? (C == 3 ? roi_crop_kernel<3, true> : roi_crop_kernel<0, true>)
                                 : (C == 3 ? roi_crop_kernel<3, false> : roi_crop_kernel<0, false>);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), D, C, out_size, band, exact_extent);
  return cudaGetLastError();
}
