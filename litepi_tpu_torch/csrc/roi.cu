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
//
// What bounds it on the H100: bytes.  At the serving size (B=128, D=8,
// S=64, C=3) it writes 50 MB of float32 and reads at most 4 taps per
// output pixel, ~15 us at 3.35 TB/s; its ~9 flops per output value are
// noise.  The dense JAX crop spent most of its FLOPs multiplying zero hat
// weights against the whole frame; here each output reads only its taps.
//
// Design: one thread per output pixel, all C channels, so consecutive
// threads write consecutive 12-byte pixels of one crop row and the writes
// coalesce; taps of neighbouring outputs share cache lines in L1/L2.  Each
// thread recomputes its ROI's few scalars: cheaper than a second pass.
// The Pallas kernel's DMA slabs, ROI pairing and planar layout were TPU
// workarounds and are gone; the pyramid levels are built outside with
// plain PyTorch, as the JAX wrapper builds them with reduce_window.
// Built with --fmad=false so that every product and sum rounds as in the
// plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;

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

__device__ __forceinline__ Taps axis_taps(int o, float start, float extent,
                                          float limit, int out_size) {
  const float step = extent / (float)out_size;
  float u = ((float)o + 0.5f) * step - 0.5f + start;
  u = fminf(fmaxf(u, 0.f), limit - 1.f);
  const float g0 = floorf(u);
  const float g1 = g0 + 1.f;
  Taps t;
  t.w0 = fmaxf(1.f - fabsf(u - g0), 0.f);
  t.w1 = fmaxf(1.f - fabsf(u - g1), 0.f);
  t.i0 = (int)g0;
  t.i1 = (int)fminf(g1, limit - 1.f);
  return t;
}

__global__ void __launch_bounds__(kThreads) roi_crop_kernel(
    Levels lv, const float* __restrict__ boxes,
    const uint8_t* __restrict__ valid, float* __restrict__ out, int D, int C,
    int out_size, float exact_extent, size_t total) {
  const size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const int ox = (int)(p % out_size);
  const int oy = (int)((p / out_size) % out_size);
  const size_t roi = p / ((size_t)out_size * out_size);  // b * D + d
  float* o = out + p * C;
  if (!valid[roi]) {
    for (int c = 0; c < C; ++c) o[c] = 0.f;
    return;
  }
  const float* bx = boxes + roi * 4;
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
  const Taps ty = axis_taps(oy, y1 / s, bh / s, (float)lh, out_size);
  const Taps tx = axis_taps(ox, x1 / s, bw / s, (float)lw, out_size);

  const int b = (int)(roi / D);
  const size_t row = (size_t)lw * C;
  const uint8_t* img = lv.ptr[k] + (size_t)b * lh * row;
  const uint8_t* r0 = img + (size_t)ty.i0 * row;
  const uint8_t* r1 = img + (size_t)ty.i1 * row;
  const int c0 = tx.i0 * C, c1 = tx.i1 * C;
  for (int c = 0; c < C; ++c) {
    const float t0 = ty.w0 * (float)r0[c0 + c] + ty.w1 * (float)r1[c0 + c];
    const float t1 = ty.w0 * (float)r0[c1 + c] + ty.w1 * (float)r1[c1 + c];
    o[c] = tx.w0 * t0 + tx.w1 * t1;
  }
}

}  // namespace

extern "C" int litepi_roi_crop(const void* const* level_ptrs,
                               const int* level_h, const int* level_w,
                               int n_levels, const void* boxes,
                               const void* valid, void* out, int B, int D,
                               int C, int out_size, float exact_extent,
                               void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || B <= 0 || D <= 0 || C <= 0 ||
      out_size <= 0)
    return cudaErrorInvalidValue;
  Levels lv;
  for (int k = 0; k < kMaxLevels; ++k) {
    const bool used = k < n_levels;
    lv.ptr[k] = used ? static_cast<const uint8_t*>(level_ptrs[k]) : nullptr;
    lv.h[k] = used ? level_h[k] : 0;
    lv.w[k] = used ? level_w[k] : 0;
  }
  lv.n = n_levels;
  const size_t total = (size_t)B * D * out_size * out_size;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  roi_crop_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      lv, static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), D, C, out_size, exact_extent, total);
  return cudaGetLastError();
}
