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
//   - nms_greedy_kernel, one warp per image, copies the image's triangle
//     into shared memory by cp.async and holds word c of the removed set in
//     lane c: up to W = 16 at B > 16 (the serving batch), and up to W = 15
//     at B <= 16.
//   - nms_greedy_cluster_kernel, from W = 16 at B <= 16 and at every W > 16
//     (the triangle outgrows a block's shared memory from K ~ 1,345): one
//     thread-block cluster of 16 blocks per image (8 where the card cannot
//     hold B clusters of 16 at once), block r owning the columns r, r + 16,
//     ... of the removed set.  Each block streams its own columns' 512-byte
//     mask segments into a ring in shared memory (1-D bulk copies under
//     mbarriers, a producer lane running ahead of the consumer warp), so
//     the chain reads shared memory only.  The owner of column w + 1 ORs
//     word w's kept rows into that column first and decides word w + 1 at
//     once, while the other blocks OR word w into their later columns;
//     it publishes the keep word to every block of the cluster (st.async
//     into distributed shared memory, one remote write per block,
//     completing on that block's mbarrier).  The pass ends after the last
//     word holding a valid candidate.
//
// What bounds the greedy pass above 1,024 candidates at small B: neither
// bytes nor operations in bulk.  The triangle is W (W + 1) / 2 segments of
// 512 bytes per image (4.5 MB at K = 8,400), streamed once over the
// cluster's 16 SMs (0.28 MB each); at B = 8 that is 36 MB, 0.011 ms of the
// card's 3.35 TB/s.  The bound is the chain of ``words`` decisions, each
// greedy_word's 128 dependent integer instructions: ~0.26 us at 4 cycles
// each and 1.98 GHz, 0.034 ms for 132 words.  Measured
// (tools/nms_trace.py, H100 SXM at 700 W, (8, 8,400)), a word costs the
// deciding block ~2,500 SM cycles: greedy_word on rows read from shared
// memory ~1,200, the next column's OR ~530 (its slot's barrier, two loads,
// two __reduce_or_sync), the wait for the keep word ~440, the diagonal's
// slot ~180, the publication ~170; the remote write itself lands within
// ~0.1 us.  Each block's ORs of its later columns cost about as much per
// word (~870 cycles for one column, ~2,400 for six).
//
// The keep mask goes out one byte per lane, 32 bytes per store.  The TPU
// kernel's matvec fixpoint and its 8-images-per-instance blocking were TPU
// scheduling devices and are gone.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

typedef unsigned long long u64;

constexpr int kSmallMaxK = 64;  // K up to one word takes nms_small_kernel
constexpr int kSmallWarps = 4;  // warps per image in nms_small_kernel
constexpr int kMaxGridY = 65535;
// The greedy pass: nms_greedy_cluster_kernel above kSharedMaxWords words
// (the triangle outgrows nms_greedy_kernel's shared memory from K ~ 1,345),
// and at B <= kClusterMaxBatch from kClusterMinWords words; else
// nms_greedy_kernel.  Measured at B = 8 (tools/nms_ab.py, H100 SXM at
// 700 W), the cluster pass against nms_greedy_kernel: 0.0128 against
// 0.0145 ms at K = 1,024, 0.0105 each at K = 768, 0.0083 against 0.0069 at
// K = 512.  The serving batch (B = 128, K <= 1,024) keeps nms_greedy_kernel.
constexpr int kSharedMaxWords = 16;
constexpr int kClusterMaxBatch = 16;
constexpr int kClusterMinWords = 16;
constexpr int kRing = 64;  // mask segments in flight per cluster block
constexpr int kKeptSlots = 32;  // published keep words per block, reused: > the cluster size
constexpr int kGroup = 4;  // columns a cluster block ORs together
constexpr unsigned kSegmentBytes = 64 * sizeof(unsigned long long);

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

// Thread-block cluster primitives (sm_90).  Shared-memory addresses are the
// 32-bit ones of cvta; a block's own address is valid in the cluster's
// window, and mapa turns it into the same variable's address in block
// ``rank`` of the cluster.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: what each wrote before is
// visible to all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Arrive, and expect ``bytes`` more of transfers in the current phase.
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed.  kCluster: also
// acquire what blocks of the cluster released into the barrier (st.async).
template <bool kCluster>
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    if constexpr (kCluster)
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    else
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One bulk copy (TMA, 1-D) of ``bytes`` from global memory into this
// block's shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar) : "memory");
}

// Store ``v`` into ``slot`` of block ``rank`` and complete 8 bytes on that
// block's ``bar`` (one remote write; the barrier's completion releases it).
__device__ __forceinline__ void publish(unsigned slot, unsigned bar, u64 v, unsigned rank) {
  unsigned rs, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rs) : "r"(slot), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rb) : "r"(bar), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
               ::"r"(rs), "l"(v), "r"(rb) : "memory");
}

// The OR of the rows of a 64-row segment ``seg`` that are kept (lane l
// holds rows l and l + 32, kept iff k0 / k1); the rows not kept are not
// loaded.  Every lane gets the word.
__device__ __forceinline__ u64 kept_rows_or(const u64* seg, bool k0, bool k1) {
  const int lane = threadIdx.x & 31;
  u64 x = 0ull;
  if (k0) x = seg[lane];
  if (k1) x |= seg[lane + 32];
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x));
  const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x >> 32));
  return (static_cast<u64>(hi) << 32) | lo;
}

// The smallest column c >= x that block ``rank`` of ``n`` owns (c % n == rank).
__device__ __forceinline__ int first_owned(int x, int rank, int n) {
  return x + (rank - x % n + n) % n;
}

// Dynamic shared memory of nms_greedy_cluster_kernel: the segment ring and
// its barriers, the published keep words and theirs, the owned columns of
// the removed set.
__host__ __device__ constexpr size_t cluster_smem_bytes(int owned) {
  return (static_cast<size_t>(kRing) * 64 + 2 * kRing + 2 * kKeptSlots + owned) * sizeof(u64);
}

// The greedy pass of one image on a cluster of n blocks (n = 8 or 16), block
// r owning the columns c = r, r + n, ... of the removed set.  The mask is
// read in 512-byte segments: segment (c, w) is column c of word w's 64 rows,
// m + c*kp + 64*w, contiguous.  Per block, warp 1's lane 0 streams the
// segments of the block's own columns into a ring of kRing slots in the
// order warp 0 consumes them (full / empty barriers per slot; the bulk copy
// completes on full):
//
//   word 0's diagonal (0, 0) if r owns column 0; then for w = 0, 1, ...:
//   (c, w) for each owned column c > w in ascending order, each followed by
//   the diagonal (c, c) when c == w + 1.
//
// Warp 0 waits for word w's keep word, ORs the kept rows of each owned
// column's segment into the removed set (two rows per lane, __reduce_or_sync
// across the lanes, loads of rows not kept skipped; kGroup columns at a
// time), and when it owns w + 1 (the first of its columns in that order)
// decides word w + 1 at once, on the diagonal segment (greedy_word), before
// the ORs of its later columns.
// Lanes 0..n-1 then publish the keep word into slot (w + 1) % kKeptSlots of
// every block of the cluster (st.async, completing on that slot's barrier:
// one remote write each).  The pass stops after the last word that holds a
// valid candidate: past it nothing is kept, so nothing is streamed, decided
// or published, and the owners write the keep bytes 0.
//
// Slot reuse: every block decides one word in any n consecutive ones, and
// only after it has waited for all words before, so when word x is
// published every block has waited for words <= x - n.  kKeptSlots > n.
__global__ void __launch_bounds__(64) nms_greedy_cluster_kernel(
    const u64* __restrict__ mask, const u64* __restrict__ valid_words,
    uint8_t* __restrict__ keep, int K, int W) {
  extern __shared__ __align__(128) u64 smem[];
  __shared__ int s_words;
  u64* ring = smem;                           // [kRing][64]
  u64* full = ring + kRing * 64;              // [kRing] barriers: segment landed
  u64* empty = full + kRing;                  // [kRing] barriers: slot read
  u64* kept_slot = empty + kRing;             // [kKeptSlots] published keep words
  u64* kept_bar = kept_slot + kKeptSlots;     // [kKeptSlots] their barriers
  u64* removed = kept_bar + kKeptSlots;       // [owned column c / n]
  const int n = cluster_blocks(), rank = cluster_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t kp = 64 * (size_t)W;
  const u64* m = mask + (size_t)(blockIdx.x / n) * W * kp;
  const u64* vw = valid_words + (size_t)(blockIdx.x / n) * W;
  uint8_t* out = keep + (size_t)(blockIdx.x / n) * K;

  if (threadIdx.x == 0) {
    s_words = 0;
    for (int s = 0; s < kRing; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 1);
    }
    for (int s = 0; s < kKeptSlots; ++s) mbar_init(smem_u32(kept_bar + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    const u64 v = vw[c];
    if (v != 0ull) atomicMax(&s_words, c + 1);
    if (c % n == rank) removed[c / n] = ~v;  // the invalid candidates, removed from the start
  }
  cluster_sync();  // every block's barriers exist before any block signals one
  const int words = s_words;  // words past the last valid candidate: none kept
  for (int c = first_owned(words, rank, n); c < W; c += n) {
    const int q = 64 * c + static_cast<int>(threadIdx.x);
    if (q < K) out[q] = 0;
  }

  if (warp == 1) {
    if (lane == 0) {
      unsigned i = 0;  // segments issued
      auto issue = [&](int c, int w) {
        const unsigned s = i % kRing;
        if (i >= kRing) mbar_wait<false>(smem_u32(empty + s), (i / kRing - 1) & 1);
        const unsigned bar = smem_u32(full + s);
        mbar_expect_tx(bar, kSegmentBytes);
        bulk_load(smem_u32(ring + 64 * s), m + c * kp + 64 * w, kSegmentBytes, bar);
        ++i;
      };
      if (rank == 0 && words > 0) issue(0, 0);
      for (int w = 0; w + 1 < words; ++w)
        for (int c = first_owned(w + 1, rank, n); c < words; c += n) {
          issue(c, w);
          if (c == w + 1) issue(c, c);
        }
    }
    __syncwarp();
  } else {
    unsigned i = 0;  // segments consumed
    auto next = [&]() {  // the slot of the next segment, once it has landed
      const unsigned s = i % kRing;
      mbar_wait<false>(smem_u32(full + s), (i / kRing) & 1);
      ++i;
      return s;
    };
    auto release = [&](unsigned s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(empty + s));
    };
    auto decide = [&](int c, u64 r) {  // word c, its removed set r
      const unsigned s = next();
      const u64 kept = greedy_word(ring + 64 * s, r);
      release(s);
      if (c + 1 < words && lane < n)
        publish(smem_u32(kept_slot + c % kKeptSlots), smem_u32(kept_bar + c % kKeptSlots), kept,
                lane);
      const int q0 = 64 * c + lane, q1 = q0 + 32;
      if (q0 < K) out[q0] = (kept >> lane) & 1ull;
      if (q1 < K) out[q1] = (kept >> (lane + 32)) & 1ull;
    };
    if (rank == 0 && words > 0) decide(0, removed[0]);
    for (int w = 0; w + 1 < words; ++w) {
      const unsigned ks = w % kKeptSlots;
      if (lane == 0) mbar_expect_tx(smem_u32(kept_bar + ks), sizeof(u64));
      mbar_wait<true>(smem_u32(kept_bar + ks), (w / kKeptSlots) & 1);
      const u64 kept = kept_slot[ks];
      const bool k0 = (kept >> lane) & 1ull, k1 = (kept >> (lane + 32)) & 1ull;
      int c = first_owned(w + 1, rank, n);
      if (c == w + 1) {  // the next word's column first, then that word at once
        const unsigned s = next();
        const u64 r = removed[c / n] | (kept ? kept_rows_or(ring + 64 * s, k0, k1) : 0ull);
        release(s);
        removed[c / n] = r;  // every lane stores the same word
        decide(c, r);
        c += n;
      }
      // the later columns, kGroup at a time, so that their loads and
      // reductions overlap
      for (; c < words; c += kGroup * n) {
        unsigned s[kGroup];
        u64 x[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          if (c + g * n < words) s[g] = next();
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          x[g] = c + g * n < words && kept ? kept_rows_or(ring + 64 * s[g], k0, k1) : 0ull;
        __syncwarp();
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (c + g * n >= words) break;
          if (lane == 0) mbar_arrive(smem_u32(empty + s[g]));
          removed[c / n + g] |= x[g];  // every lane stores the same word
        }
      }
    }
  }
  cluster_sync();  // no block leaves while a block of its cluster may still signal it
}

// 0: nms_small_kernel alone; 1: nms_mask_kernel, then nms_greedy_kernel;
// 2: nms_mask_kernel, then nms_greedy_cluster_kernel.
int route(int B, int K) {
  if (K <= kSmallMaxK) return 0;
  const int W = (K + 63) / 64;
  return W > kSharedMaxWords || (B <= kClusterMaxBatch && W >= kClusterMinWords) ? 2 : 1;
}

cudaError_t max_active_clusters(int n, size_t smem, int* count) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n);
  cfg.blockDim = dim3(64);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(count, nms_greedy_cluster_kernel, &cfg);
}

// The cluster for B images of W words: 16 blocks (non-portable) when the
// card holds B such clusters at once, else 8 (portable; clusters past what
// the card holds wait for a free place).  ``smem``: the kernel's dynamic
// shared memory, sized for the 8-block cluster's share of the columns.
// The card's capacity is queried once per device and size.
cudaError_t cluster_plan(int B, int W, int* n, int* max_active, size_t* smem) {
  static std::mutex lock;
  static int device = -1;
  static size_t known_smem = 0;
  static int cap16 = 0, cap8 = 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  *smem = cluster_smem_bytes((W + 7) / 8);
  std::lock_guard<std::mutex> guard(lock);
  if (dev != device || *smem != known_smem) {
    device = -1;
    e = cudaFuncSetAttribute(nms_greedy_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess && *smem > 48 * 1024)
      e = cudaFuncSetAttribute(nms_greedy_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (e == cudaSuccess) e = max_active_clusters(16, *smem, &cap16);
    if (e == cudaSuccess) e = max_active_clusters(8, *smem, &cap8);
    if (e != cudaSuccess) return e;
    device = dev;
    known_smem = *smem;
  }
  *n = B <= cap16 ? 16 : 8;
  *max_active = B <= cap16 ? cap16 : cap8;
  return cudaSuccess;
}

}  // namespace

// Which greedy pass litepi_nms_suppress runs for (B, K): 0 none (one
// kernel does all), 1 nms_greedy_kernel, 2 nms_greedy_cluster_kernel.
extern "C" int litepi_nms_greedy_route(int B, int K) { return route(B, K); }

// For route 2: the blocks per cluster and how many such clusters the card
// holds at once (both 0 for another route).
extern "C" int litepi_nms_cluster_shape(int B, int K, int* blocks, int* max_active) {
  *blocks = *max_active = 0;
  if (B <= 0 || route(B, K) != 2) return cudaSuccess;
  size_t smem;
  return cluster_plan(B, (K + 63) / 64, blocks, max_active, &smem);
}

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
  if (route(B, K) == 1) {
    const size_t smem = (size_t)W * 64 * W * sizeof(u64);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(nms_greedy_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    nms_greedy_kernel<<<B, 32, smem, s>>>(mask, valid_words, out, K, W);
    return cudaGetLastError();
  }
  int n, max_active;
  size_t smem;
  e = cluster_plan(B, W, &n, &max_active, &smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * n);
  cfg.blockDim = dim3(64);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, nms_greedy_cluster_kernel, static_cast<const u64*>(mask),
                         static_cast<const u64*>(valid_words), out, K, W);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
