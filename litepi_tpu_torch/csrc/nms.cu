// Greedy per-class NMS keep mask over score-descending candidates.
//
// Replaces: litepi_tpu/ops/pallas_nms.py::pallas_suppress (Pallas body
// _nms_kernel), the suppression step of ops/nms.py::nms_sorted.
// Plain version: litepi_tpu_torch/ops/nms.py::suppress_sorted.
//
// Contract: boxes (B, K, 4) float32 xyxy, cls (B, K) int32, valid (B, K)
// uint8 (torch.bool) -> keep (B, K) uint8, any K (the scratch buffer,
// B*W*(64W + 1) words, is what bounds it).  Candidate j
// suppresses i when j < i, cls[j] == cls[i] and IoU(j, i) > thr, IoU
// computed exactly as the Pallas kernel does: areas clamped at 0, union =
// area_j + area_i - inter + 1e-6, one IEEE division.  keep[i] = valid[i]
// and no KEPT j suppresses i: the fixpoint the Pallas kernel iterates to,
// which is the greedy result.  Built with --fmad=false: an FMA contraction
// of area_j + area_i - inter could flip iou > thr at the boundary against
// the plain version.
//
// What bounds it on the H100: not bytes (~180 KB at the serving B=128,
// K=64).  Two things cost time: the IoU work, up to B*K*(K-1)/2 pairs of
// ~45 instructions each (an IEEE division among them), which at K=512
// keeps the card busy for tens of microseconds; and the greedy pass, a
// chain of K dependent decisions per image that no parallelism shortens.
//
// Design.  The suppression relation is cut into 64-bit words: word c of
// row j holds bit q when j suppresses candidate 64*c + q.  Only pairs
// whose suppressor is valid are computed: an invalid candidate is never
// kept, so it suppresses nothing, and the bits of invalid suppressees are
// never read (the greedy pass counts them removed from the start).
//
// * K <= 64 (the serving budget): nms_small_kernel, one block of 4 warps
//   per image, no device-memory mask.  Lane l of each warp computes rows
//   l and 63 - l (63 IoUs together, so no lane idles), the 63 pairs of a
//   row pair cut into one run per warp; the partial words meet in shared
//   memory, and warp 0 runs the greedy pass on them.
// * K > 64: two kernels.  nms_mask_kernel computes the upper triangle of
//   64 x 64 tiles across the whole card, one block per tile (B=128, K=512:
//   4,608 blocks) up to 65,535 tiles per image (K = 23,104), beyond that a
//   grid-stride loop over them, so that memory alone bounds K.  The tile's
//   64 suppressee boxes are staged in shared memory, two threads per
//   suppressor row, 32 columns each; a tile stops at its last valid
//   column, and one with none returns at once.  The words go to a scratch
//   buffer the wrapper allocates (B*W*(64W + 1) words, W = K/64 rounded
//   up: 4 MB at B=128, K=512, which stays in L2; 8.9 MB per image at
//   K = 8,400).  The diagonal tiles also write each word's valid bits.
//   The greedy pass walks the words in order: the whole warp decides the
//   64 candidates of word w together (greedy_word below: two instructions
//   per candidate on the chain, in registers, with the row words loaded
//   ahead of it), then ORs the kept rows' later words into the removed
//   set across the lanes (__reduce_or_sync).
//   - K <= 1024 (W <= 16): nms_greedy_kernel, one warp per image, copies
//     the image's triangle into shared memory by cp.async and holds word c
//     of the removed set in lane c.
//   - K > 1024: the triangle outgrows shared memory (227 KB per block from
//     K ~ 1,345) and the removed set a warp's lanes.
//     nms_greedy_large_kernel, one block of kLargeWarps warps per image,
//     keeps the removed set in shared memory and reads the row words from
//     global memory (L2): warp 0 decides word w, then every warp ORs the
//     kept rows' words of a share of the later columns, the part that
//     grows as K^2 / 64 per image.
//
// The keep mask goes out one byte per lane, 32 bytes per store.  The TPU
// kernel's matvec fixpoint and its 8-images-per-instance blocking were TPU
// scheduling devices and are gone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kSharedMaxWords = 16;  // K <= 1024: the greedy pass in shared memory
constexpr int kSmallMaxK = 64;  // K up to one word takes nms_small_kernel
constexpr int kSmallWarps = 4;  // warps per image in nms_small_kernel
constexpr int kLargeWarps = 16;  // warps per image in nms_greedy_large_kernel
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float box_area(float4 b) {
  return fmaxf(b.z - b.x, 0.f) * fmaxf(b.w - b.y, 0.f);
}

// j (box a) suppresses i (box c): same class and IoU > thr, in the Pallas
// kernel's order of operations.  Most pairs do not overlap (inter = 0),
// and the IEEE division takes its slow path (a call) for a zero dividend.
// For inter = +-0 and uni > 0 (+inf included) the quotient is +-0
// exactly, so those lanes skip the division and compare 0 with thr: the
// same bit.  A NaN or a non-positive union still divides.  (Dividing 1
// instead, without the branch, is folded back into 0 / uni by the
// compiler, since the quotient is then unused.  Deciding the bit without
// the division where thr * uni scaled by 1 +- 2^-20 makes it certain was
// slower: ~20 more instructions per pair than the division's fast path.)
__device__ __forceinline__ bool suppresses(float4 a, float area_a, int cls_a,
                                           float4 c, float area_c, int cls_c,
                                           float thr) {
  const float lt_x = fmaxf(a.x, c.x);
  const float lt_y = fmaxf(a.y, c.y);
  const float rb_x = fminf(a.z, c.z);
  const float rb_y = fminf(a.w, c.w);
  const float inter = fmaxf(rb_x - lt_x, 0.f) * fmaxf(rb_y - lt_y, 0.f);
  const float uni = area_a + area_c - inter + 1e-6f;
  float iou = 0.f;
  if (inter != 0.f || !(uni > 0.f)) iou = inter / uni;
  return (iou > thr) & (cls_a == cls_c);
}

// x with bit b copied into every bit above it (bits b and below kept):
// PTX szext, x sign-extended from b + 1 bits.
__device__ __forceinline__ unsigned spread_up(unsigned x, int b) {
  unsigned r;
  asm("szext.clamp.s32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(b + 1));
  return r;
}

// acc | (row & ~s) as one instruction (LOP3 table 0xF4), so that the
// compiler cannot regroup it into two on the chain.
__device__ __forceinline__ unsigned or_where_clear(unsigned acc, unsigned row, unsigned s) {
  unsigned r;
  asm("lop3.b32 %0, %1, %2, %3, 0xF4;" : "=r"(r) : "r"(acc), "r"(row), "r"(s));
  return r;
}

// The greedy pass over the 64 candidates of one word, q = 0..63 in order.
// ``r`` is the removed set on entry, invalid candidates included; q is kept
// iff its bit of r is still clear, and a kept q adds its row word d[q].
// d[q] of a valid candidate has bits above q only, so bit q is final when
// q is reached.  The chain from one q to the next is two instructions:
// spread bit q over the bits above it, then OR in the row's bits above q
// where that spread is clear (the row is cut to those bits beforehand: a
// word the mask kernel did not write is read only for a removed q).  The
// row words do not depend on the chain and load ahead.  Below q = 32 the
// low half alone decides.  Returns the kept candidates.
__device__ __forceinline__ u64 greedy_word(const u64* d, u64 r) {
  unsigned lo = static_cast<unsigned>(r), hi = static_cast<unsigned>(r >> 32);
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const u64 row = d[q];
    const unsigned above = q == 31 ? 0u : ~0u << (q + 1);
    const unsigned s = spread_up(lo, q);
    lo = or_where_clear(lo, static_cast<unsigned>(row) & above, s);
    hi = or_where_clear(hi, static_cast<unsigned>(row >> 32),
                        static_cast<unsigned>(static_cast<int>(s) >> 31));
  }
#pragma unroll
  for (int q = 32; q < 64; ++q) {
    const unsigned above = q == 63 ? 0u : ~0u << (q - 31);
    const unsigned row = static_cast<unsigned>(d[q] >> 32) & above;
    hi = or_where_clear(hi, row, spread_up(hi, q - 32));
  }
  return ~((static_cast<u64>(hi) << 32) | lo);
}

// Valid bits of candidates 64*w + lane and 64*w + 32 + lane as one word
// (every lane gets it).
__device__ __forceinline__ u64 valid_word(bool v0, bool v1) {
  return (static_cast<u64>(__ballot_sync(0xffffffffu, v1)) << 32) |
         __ballot_sync(0xffffffffu, v0);
}

template <int NW>
__global__ void __launch_bounds__(32 * NW) nms_small_kernel(
    const float4* __restrict__ boxes, const int* __restrict__ cls,
    const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep, int K,
    float thr) {
  __shared__ float4 s_box[64];
  __shared__ float2 s_ac[64];  // area, class id (its bits)
  __shared__ u64 s_part[NW][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t img = (size_t)blockIdx.x * K;

  // candidates past K are zero boxes; their bits are never read
  for (int i = threadIdx.x; i < 64; i += 32 * NW) {
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    int c = 0;
    if (i < K) {
      b = boxes[img + i];
      c = cls[img + i];
    }
    s_box[i] = b;
    s_ac[i] = make_float2(box_area(b), __int_as_float(c));
  }
  __syncthreads();

  // rows r0 = lane (pairs i = r0+1..63) and r1 = 63 - lane (i = r1+1..63):
  // 63 pairs, indexed t = 0..62, cut into NW runs, one per warp
  const int r0 = lane, r1 = 63 - lane;
  const float4 b0 = s_box[r0], b1 = s_box[r1];
  const float2 ac0 = s_ac[r0], ac1 = s_ac[r1];
  constexpr int kRun = (63 + NW - 1) / NW;
  const int t_end = min((warp + 1) * kRun, 63);
  u64 w0 = 0ull, w1 = 0ull;
#pragma unroll 4
  for (int t = warp * kRun; t < t_end; ++t) {
    const bool first = t < 63 - lane;
    const int i = first ? lane + 1 + t : t + 1;
    const float4 c = s_box[i];
    const float2 ac = s_ac[i];
    const bool o = suppresses(first ? b0 : b1, first ? ac0.x : ac1.x,
                              __float_as_int(first ? ac0.y : ac1.y), c, ac.x,
                              __float_as_int(ac.y), thr);
    const u64 bit = static_cast<u64>(o) << i;
    w0 |= first ? bit : 0ull;
    w1 |= first ? 0ull : bit;
  }
  s_part[warp][r0] = w0;
  s_part[warp][r1] = w1;
  __syncthreads();
  if (warp != 0) return;

  u64 m0 = s_part[0][lane], m1 = s_part[0][lane + 32];
#pragma unroll
  for (int w = 1; w < NW; ++w) {
    m0 |= s_part[w][lane];
    m1 |= s_part[w][lane + 32];
  }
  s_part[0][lane] = m0;
  s_part[0][lane + 32] = m1;
  __syncwarp();
  const int q1 = lane + 32;
  const u64 v = valid_word(lane < K && valid[img + lane], q1 < K && valid[img + q1]);
  const u64 kept = greedy_word(s_part[0], ~v);
  if (lane < K) keep[img + lane] = (kept >> lane) & 1ull;
  if (q1 < K) keep[img + q1] = (kept >> q1) & 1ull;
}

// One 64 x 64 tile (row block rb, column block cb >= rb) of image ``image``,
// in 128 threads: thread t computes row 64*rb + t % 64 against the tile's
// columns 32*h .. 32*h + 31, h = t / 64, and writes those 32 bits of the
// row's word cb (its low half for h = 0) into mask[image][cb][row].  Two
// threads of 32 pairs per row rather than one of 64: the last blocks on
// the card finish sooner (measured: 1 and 4 parts were slower).
__device__ __forceinline__ void mask_tile(
    const float4* __restrict__ boxes, const int* __restrict__ cls,
    const uint8_t* __restrict__ valid, u64* __restrict__ mask,
    u64* __restrict__ valid_words, int K, int W, float thr, int image, int rb, int cb,
    float4* s_box, float2* s_ac, unsigned* s_cols) {
  const int tid = threadIdx.x, r = tid & 63, h = tid >> 6;
  const size_t img = (size_t)image * K;
  const int j = rb * 64 + r;
  const bool vj = j < K && valid[img + j];
  if (h == 0) {  // warps 0 and 1 stage the tile's columns
    const int i = cb * 64 + tid;
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    int c = 0;
    bool vi = false;
    if (i < K) {
      b = boxes[img + i];
      c = cls[img + i];
      vi = valid[img + i];
    }
    s_box[tid] = b;
    s_ac[tid] = make_float2(box_area(b), __int_as_float(c));
    const unsigned cols = __ballot_sync(0xffffffffu, vi);
    if ((tid & 31) == 0) s_cols[tid >> 5] = cols;
    if (cb == rb) {  // the diagonal tile also writes the row block's valid bits
      const unsigned rows = __ballot_sync(0xffffffffu, vj);
      if ((tid & 31) == 0)
        reinterpret_cast<unsigned*>(valid_words + (size_t)image * W + rb)[tid >> 5] = rows;
    }
  }
  __syncthreads();
  // The bits of an invalid column are never read (the greedy pass counts
  // it removed from the start), so a tile with no valid column writes
  // nothing and a half stops at the tile's last valid column: n columns.
  const u64 vcols = (static_cast<u64>(s_cols[1]) << 32) | s_cols[0];
  if (vcols == 0ull || j >= K) return;
  const int n = min(64 - __clzll(vcols) - 32 * h, 32);

  unsigned bits = 0u;
  if (vj) {  // an invalid row is never kept, so it suppresses nothing
    const float4 a = boxes[img + j];
    const float area_a = box_area(a);
    const int cls_a = cls[img + j];
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      if (q >= n) break;
      const float2 ac = s_ac[32 * h + q];
      if (suppresses(a, area_a, cls_a, s_box[32 * h + q], ac.x, __float_as_int(ac.y), thr))
        bits |= 1u << q;
    }
  }
  const int first = r + 1 - 32 * h;  // on the diagonal, i > j only
  if (cb == rb && first > 0) bits &= first >= 32 ? 0u : ~0u << first;
  reinterpret_cast<unsigned*>(mask + ((size_t)image * W + cb) * (64 * (size_t)W) + j)[h] = bits;
}

// Tiles before row block r: r*W - r*(r - 1)/2.  (int: the scratch, 512 W^2
// bytes per image, runs out of card memory long before W(W + 1)/2 leaves
// int's range at W ~ 65,000.)
__device__ __forceinline__ int tiles_before(int r, int W) {
  return r * W - (r * (r - 1) >> 1);
}

// The upper triangle of 64 x 64 tiles of image blockIdx.x, tile t =
// blockIdx.y, blockIdx.y + gridDim.y, ... (a grid-stride loop, so that the
// grid's 65,535 limit on blockIdx.y does not bound K; one tile per block up
// to W = 361, K = 23,104).  t -> (rb, cb) row by row, rb the largest r with
// tiles_before(r) <= t: a float32 estimate, corrected in integers.  At
// most 32 registers, so that 16 blocks (2,048 threads) fit on an SM.
__global__ void __launch_bounds__(128, 16) nms_mask_kernel(
    const float4* __restrict__ boxes, const int* __restrict__ cls,
    const uint8_t* __restrict__ valid, u64* __restrict__ mask,
    u64* __restrict__ valid_words, int K, int W, float thr) {
  __shared__ float4 s_box[64];
  __shared__ float2 s_ac[64];
  __shared__ unsigned s_cols[2];  // valid bits of the tile's columns
  const int n_tiles = W * (W + 1) / 2;
  const float b = 2.f * W + 1.f;
  for (int t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    int rb = static_cast<int>((b - sqrtf(b * b - 8.f * t)) * 0.5f);
    while (rb > 0 && tiles_before(rb, W) > t) --rb;
    while (tiles_before(rb + 1, W) <= t) ++rb;
    mask_tile(boxes, cls, valid, mask, valid_words, K, W, thr, blockIdx.x, rb,
              rb + t - tiles_before(rb, W), s_box, s_ac, s_cols);
    if (t + gridDim.y < n_tiles) __syncthreads();  // the next tile restages s_box
  }
}

// The greedy pass of one image over the tiles of nms_mask_kernel: lane c <
// W holds word c of the removed set and of the valid bits.
__global__ void __launch_bounds__(32) nms_greedy_kernel(
    const u64* __restrict__ mask, const u64* __restrict__ valid_words,
    uint8_t* __restrict__ keep, int K, int W) {
  extern __shared__ __align__(16) u64 s_mask[];  // [W][64 W], as in mask
  const int lane = threadIdx.x;
  const int kp = 64 * W;
  const u64* m = mask + (size_t)blockIdx.x * W * kp;
  // word c is read for rows < 64 (c + 1) only: the upper triangle
  for (int c = 0; c < W; ++c) {
    for (int p = lane; p < 32 * (c + 1); p += 32) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(s_mask + c * kp + 2 * p));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(m + c * kp + 2 * p));
    }
  }
  const u64 vw = lane < W ? valid_words[(size_t)blockIdx.x * W + lane] : 0ull;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  const size_t img = (size_t)blockIdx.x * K;
  u64 removed = 0ull;
  for (int w = 0; w < W; ++w) {
    const u64 r = __shfl_sync(0xffffffffu, removed, w) | ~__shfl_sync(0xffffffffu, vw, w);
    const u64 kept = greedy_word(s_mask + w * kp + 64 * w, r);
    const int q0 = 64 * w + lane, q1 = q0 + 32;
    if (q0 < K) keep[img + q0] = (kept >> lane) & 1ull;
    if (q1 < K) keep[img + q1] = (kept >> (lane + 32)) & 1ull;
    // the kept rows' later words, ORed across the lanes into word c
    const u64 k0 = ((kept >> lane) & 1ull) ? ~0ull : 0ull;
    const u64 k1 = ((kept >> (lane + 32)) & 1ull) ? ~0ull : 0ull;
#pragma unroll 4
    for (int c = w + 1; c < W; ++c) {
      const u64 x = (s_mask[c * kp + q0] & k0) | (s_mask[c * kp + q1] & k1);
      const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x));
      const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x >> 32));
      if (lane == c) removed |= (static_cast<u64>(hi) << 32) | lo;
    }
  }
}

// The greedy pass of one image for W > 16, in kLargeWarps warps: the
// removed set in shared memory (``s_removed[c]``: word c, the invalid
// candidates set from the start), the row words read from global memory.
// For each word w, warp 0 decides its 64 candidates (greedy_word on the
// diagonal tile's row words); then warp v ORs the kept rows' words of
// columns w + 1 + v, w + 1 + v + kLargeWarps, ... into the removed set,
// lane l holding rows 64w + l and 64w + 32 + l, whose loads are skipped
// for a row not kept (only a kept row's words are read, and those the
// mask kernel wrote).
__global__ void __launch_bounds__(32 * kLargeWarps) nms_greedy_large_kernel(
    const u64* __restrict__ mask, const u64* __restrict__ valid_words,
    uint8_t* __restrict__ keep, int K, int W) {
  extern __shared__ u64 s_removed[];  // [W]
  __shared__ u64 s_kept;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t kp = 64 * (size_t)W;
  const u64* m = mask + (size_t)blockIdx.x * W * kp;
  for (int c = threadIdx.x; c < W; c += 32 * kLargeWarps)
    s_removed[c] = ~valid_words[(size_t)blockIdx.x * W + c];
  __syncthreads();
  const size_t img = (size_t)blockIdx.x * K;
  for (int w = 0; w < W; ++w) {
    if (warp == 0) {
      const u64 kept = greedy_word(m + w * kp + 64 * w, s_removed[w]);
      const int q0 = 64 * w + lane, q1 = q0 + 32;
      if (q0 < K) keep[img + q0] = (kept >> lane) & 1ull;
      if (q1 < K) keep[img + q1] = (kept >> (lane + 32)) & 1ull;
      if (lane == 0) s_kept = kept;
    }
    __syncthreads();
    const u64 kept = s_kept;
    const bool k0 = (kept >> lane) & 1ull, k1 = (kept >> (lane + 32)) & 1ull;
    if (kept != 0ull) {
      const u64* rows = m + 64 * (size_t)w + lane;
#pragma unroll 4
      for (int c = w + 1 + warp; c < W; c += kLargeWarps) {
        u64 x = 0ull;
        if (k0) x = rows[c * kp];
        if (k1) x |= rows[c * kp + 32];
        const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x));
        const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x >> 32));
        if (lane == 0) s_removed[c] |= (static_cast<u64>(hi) << 32) | lo;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Bytes of device scratch litepi_nms_suppress needs for (B, K): 0 where
// one kernel does the work, else the tiles' words and the valid words.
extern "C" size_t litepi_nms_scratch_bytes(int B, int K) {
  if (B <= 0 || K <= kSmallMaxK) return 0;
  const size_t W = (K + 63) / 64;
  return (size_t)B * W * (64 * W + 1) * sizeof(u64);
}

extern "C" int litepi_nms_suppress(const void* boxes, const void* cls,
                                   const void* valid, void* keep,
                                   void* scratch, int B, int K, float thr,
                                   void* stream) {
  if (B <= 0 || K <= 0) return cudaErrorInvalidValue;
  const int W = (K + 63) / 64;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b = static_cast<const float4*>(boxes);
  const int* c = static_cast<const int*>(cls);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint8_t* out = static_cast<uint8_t*>(keep);
  if (K <= kSmallMaxK) {
    nms_small_kernel<kSmallWarps><<<B, 32 * kSmallWarps, 0, s>>>(
        b, c, v, out, K, thr);
    return cudaGetLastError();
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  u64* mask = static_cast<u64*>(scratch);
  u64* valid_words = mask + (size_t)B * W * 64 * W;
  const int n_tiles = W * (W + 1) / 2;
  const unsigned grid_y = n_tiles < kMaxGridY ? n_tiles : kMaxGridY;
  nms_mask_kernel<<<dim3(B, grid_y), 128, 0, s>>>(b, c, v, mask, valid_words, K, W, thr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (W <= kSharedMaxWords) {
    const size_t smem = (size_t)W * 64 * W * sizeof(u64);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(nms_greedy_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    nms_greedy_kernel<<<B, 32, smem, s>>>(mask, valid_words, out, K, W);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)W * sizeof(u64);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(nms_greedy_large_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  nms_greedy_large_kernel<<<B, 32 * kLargeWarps, smem, s>>>(mask, valid_words, out, K, W);
  return cudaGetLastError();
}
