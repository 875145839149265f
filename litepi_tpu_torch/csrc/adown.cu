// YOLOv9's ADown front end as one pass: the 2x2 stride-1 average pool of
// x, its first half of channels written dense, and the 3x3/2 max pool (pad
// 1) of its second half written dense, with no full-size averaged map, no
// copies of the halves and no max-pool indices in between.
//
// Replaces no TPU kernel: ADown has no counterpart in the JAX package.  It
// is added for YOLOv9-E (litepi_tpu_torch/models/yolov9.py::ADown), whose 8
// ADowns a frame ran as ATen's NHWC avg_pool2d over the whole map, chunk
// (two halves not dense in channels last, so cuDNN and the max pool each
// copied theirs), and ATen's max_pool2d with its int64 indices.  Plain
// version: litepi_tpu_torch/kernels/adown.py::adown_front_plain (that
// chain).
//
// Contract: x (B, C, H, W) bf16 dense channels last, C a multiple of 16, H
// and W at least 2; Ch = C / 2.  x1 (B, Ch, H-1, W-1) and x2 (B, Ch, Ho,
// Wo), Ho = (H-2)/2 + 1 and Wo = (W-2)/2 + 1, bf16 dense channels last.
// Bit for bit as ATen's chain on the card:
//   - each average is ATen's: a float32 sum from 0 over the 2x2 window,
//     rows outer and columns inner, times 0.25 (the same value as ATen's
//     division by 4, which is exact), rounded once to bf16 by
//     __float2bfloat16 (c10::BFloat16's conversion on sm_80 and later);
//   - x1 holds the averages of channels [0, Ch);
//   - x2[p, q] folds the bf16 averages of channels [Ch, C) over rows
//     2p-1 .. 2p+1 and columns 2q-1 .. 2q+1, clipped to the averaged map,
//     in ATen's order (rows outer) and by ATen's rule: start at -inf, take
//     a value that is greater or NaN.  So the largest wins, of equal ones
//     (-0 and +0) the first, and of NaNs the last.
//
// What bounds it on the H100: bytes.  At the YOLOv9-E cell (B=32 at 1280)
// the 8 calls read x once (6.50 GB) and write x1 and x2 once (4.03 GB):
// 10.53 GB, 3.14 ms at 3.35 TB/s, against about 0.6 operations a byte.
//
// Design: every thread moves 8 channels (16 bytes) per access, neighbouring
// threads on neighbouring channels, and walks down a band of kBand rows of
// x holding the rows it still needs in registers, so that it loads each row
// of its columns once.  A thread first makes two columns of x1 (three
// columns of x) over the band's kBand rows of x1, then one column of x2
// (four columns of x, the outer two shared with its neighbours) over the
// band's kBand / 2 rows of x2, carrying the fold of the averaged row it
// shares with the next output row; so both halves of a pixel are read close
// in time.  The columns neighbouring threads share, and the rows a band
// shares with the next, are read again from L1 or L2: blocks of adjacent
// columns and bands run together.  Tile, timed on an H100 at the cell's 8
// calls: 256 threads and 3 blocks an SM (80 registers, no spills), ahead of
// 16- and 32-row bands and of 2 or 4 blocks an SM (4 spills).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;  // blocks per SM the registers must allow
constexpr int kVec = 8;        // bf16 channels per 16-byte access
constexpr int kBand = 8;       // x rows per thread: kBand rows of x1, kBand / 2 of x2

struct Shape {
  long long b;
  int h, w, c;  // x
  int v;        // 16-byte vectors per half of a pixel: C / 16
  int cols;     // column pairs of x1, columns of x2: W / 2
  int bands;    // bands of kBand rows of x
  int ho;       // rows of x2
  long long threads;
};

__device__ __forceinline__ void widen(const uint4& u, float f[kVec]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// The bf16 averages of one 2x2 window, per channel: ATen's float32 sum from
// 0 (top left, top right, bottom left, bottom right), times 0.25, rounded;
// returned widened to float32 (exactly).
__device__ __forceinline__ void average(const uint4& tl, const uint4& tr, const uint4& bl,
                                        const uint4& br, float out[kVec]) {
  float a[kVec], b[kVec], c[kVec], d[kVec];
  widen(tl, a);
  widen(tr, b);
  widen(bl, c);
  widen(br, d);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    float s = __fadd_rn(0.0f, a[k]);
    s = __fadd_rn(s, b[k]);
    s = __fadd_rn(s, c[k]);
    s = __fadd_rn(s, d[k]);
    out[k] = __bfloat162float(__float2bfloat16(__fmul_rn(s, 0.25f)));
  }
}

// 8 floats that hold bf16 values, packed: their upper halves, exactly.
__device__ __forceinline__ uint4 pack(const float f[kVec]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = (__float_as_uint(f[2 * k]) >> 16) | (__float_as_uint(f[2 * k + 1]) & 0xffff0000u);
  }
  return u;
}

// ATen's max-pool step on one value, per channel.
__device__ __forceinline__ void fold(float m[kVec], const float v[kVec]) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (v[k] > m[k] || isnan(v[k])) m[k] = v[k];
  }
}

__device__ __forceinline__ uint4 load(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const uint4& u) {
  *reinterpret_cast<uint4*>(p) = u;
}

// x columns 2q-1 .. 2q+2 of one row (p at column 2q); the outer two only
// where they exist, else a copy of their neighbour, never read.
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, int c, bool left, bool right,
                                         uint4 r[4]) {
  r[1] = load(p);
  r[2] = load(p + c);
  r[0] = left ? load(p - c) : r[1];
  r[3] = right ? load(p + 2 * c) : r[2];
}

// The first half: x1's columns 2q and 2q + 1 (where it exists) over x1 rows
// i0 .. i1 - 1; `in` at x's row i0, column 2q, `out` at x1's row i0,
// column 2q.
__device__ __forceinline__ void first_half(const __nv_bfloat16* in, __nv_bfloat16* out,
                                           const Shape& s, int i0, int i1, bool two) {
  const long long row = static_cast<long long>(s.w) * s.c;
  const long long out_row = static_cast<long long>(s.w - 1) * (s.c / 2);
  uint4 t0 = load(in), t1 = load(in + s.c), t2 = two ? load(in + 2 * s.c) : t1;
  for (int i = i0; i < i1; ++i) {
    in += row;
    const uint4 b0 = load(in), b1 = load(in + s.c);
    const uint4 b2 = two ? load(in + 2 * s.c) : b1;
    float a[kVec];
    average(t0, t1, b0, b1, a);
    store(out, pack(a));
    if (two) {
      average(t1, t2, b1, b2, a);
      store(out + s.c / 2, pack(a));
    }
    out += out_row;
    t0 = b0;
    t1 = b1;
    t2 = b2;
  }
}

// The second half: x2's column q over x2 rows p0 .. p1 - 1; `col` at x's
// row 0, column 2q, `out` at x2's row p0, column q.  Output row p folds the
// averaged rows 2p - 1 (carried from row p - 1), 2p and 2p + 1.
__device__ __forceinline__ void second_half(const __nv_bfloat16* col, __nv_bfloat16* out,
                                            const Shape& s, int p0, int p1, bool left,
                                            bool right) {
  const long long row = static_cast<long long>(s.w) * s.c;
  const long long out_row = static_cast<long long>(s.w / 2) * (s.c / 2);
  float carry[kVec];  // the fold of averaged row 2p - 1: ATen's start for output row p
#pragma unroll
  for (int k = 0; k < kVec; ++k) carry[k] = -INFINITY;
  uint4 r[4], n[4];
  float a[kVec];
  if (p0 > 0) {
    load_row(col + (2 * p0 - 1) * row, s.c, left, right, r);
    load_row(col + (2 * p0) * row, s.c, left, right, n);
    if (left) {
      average(r[0], r[1], n[0], n[1], a);
      fold(carry, a);
    }
    average(r[1], r[2], n[1], n[2], a);
    fold(carry, a);
    if (right) {
      average(r[2], r[3], n[2], n[3], a);
      fold(carry, a);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = n[k];
  } else {
    load_row(col, s.c, left, right, r);
  }
  for (int p = p0; p < p1; ++p) {
    // r holds x row 2p: averaged row 2p lies between it and row 2p + 1
    load_row(col + (2 * p + 1) * row, s.c, left, right, n);
    float m[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) m[k] = carry[k];
    if (left) {
      average(r[0], r[1], n[0], n[1], a);
      fold(m, a);
    }
    average(r[1], r[2], n[1], n[2], a);
    fold(m, a);
    if (right) {
      average(r[2], r[3], n[2], n[3], a);
      fold(m, a);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = n[k];
    if (2 * p + 2 <= s.h - 1) {  // averaged row 2p + 1 exists
      load_row(col + (2 * p + 2) * row, s.c, left, right, n);
#pragma unroll
      for (int k = 0; k < kVec; ++k) carry[k] = -INFINITY;
      if (left) {
        average(r[0], r[1], n[0], n[1], a);
        fold(m, a);
        fold(carry, a);
      }
      average(r[1], r[2], n[1], n[2], a);
      fold(m, a);
      fold(carry, a);
      if (right) {
        average(r[2], r[3], n[2], n[3], a);
        fold(m, a);
        fold(carry, a);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k] = n[k];
    }
    store(out, pack(m));  // m holds bf16 values: ATen's output bits
    out += out_row;
  }
}

// One thread: the column pair q of x1 over the band's kBand rows, then
// column q of x2 over its kBand / 2 rows, 8 channels of each half.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
adown_front_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ x1,
                   __nv_bfloat16* __restrict__ x2, Shape s) {
  long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= s.threads) return;
  const int vec = static_cast<int>(t % s.v);
  t /= s.v;
  const int q = static_cast<int>(t % s.cols);
  t /= s.cols;
  const int band = static_cast<int>(t % s.bands);
  const long long b = t / s.bands;
  const int ch = s.c / 2;
  const long long image = b * s.h * s.w * s.c;
  const int c0 = vec * kVec;

  const int i0 = band * kBand;
  first_half(x + image + (static_cast<long long>(i0) * s.w + 2 * q) * s.c + c0,
             x1 + ((b * (s.h - 1) + i0) * (s.w - 1) + 2 * q) * ch + c0, s, i0,
             min(i0 + kBand, s.h - 1), 2 * q + 1 < s.w - 1);
  const int p0 = band * (kBand / 2);
  second_half(x + image + static_cast<long long>(2 * q) * s.c + ch + c0,
              x2 + ((b * s.ho + p0) * s.cols + q) * ch + c0, s, p0,
              min(p0 + kBand / 2, s.ho), q > 0, 2 * q + 2 <= s.w - 1);
}

}  // namespace

extern "C" int litepi_adown_front_bf16(const void* x, void* x1, void* x2, long long b, int h,
                                       int w, int c, void* stream) {
  Shape s;
  s.b = b;
  s.h = h;
  s.w = w;
  s.c = c;
  s.v = c / 2 / kVec;
  s.cols = w / 2;  // ceil((W - 1) / 2) column pairs of x1, (W - 2) / 2 + 1 columns of x2
  s.bands = (h - 1 + kBand - 1) / kBand;  // also ceil(Ho / (kBand / 2))
  s.ho = (h - 2) / 2 + 1;
  s.threads = b * s.bands * s.cols * s.v;
  const long long blocks = (s.threads + kThreads - 1) / kThreads;
  adown_front_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(x1),
      static_cast<__nv_bfloat16*>(x2), s);
  return static_cast<int>(cudaGetLastError());
}
