// Greedy per-class NMS keep mask over score-descending candidates.
//
// Replaces: litepi_tpu/ops/pallas_nms.py::pallas_suppress (Pallas body
// _nms_kernel), the suppression step of ops/nms.py::nms_sorted.
// Plain version: litepi_tpu_torch/ops/nms.py::suppress_sorted.
//
// Contract: boxes (B, K, 4) float32 xyxy, cls (B, K) int32, valid (B, K)
// uint8 (torch.bool) -> keep (B, K) uint8.  Candidate j suppresses i when
// j < i, cls[j] == cls[i] and IoU(j, i) > thr, IoU computed exactly as the
// Pallas kernel does: areas clamped at 0, union = area_j + area_i - inter
// + 1e-6, one IEEE division.  keep[i] = valid[i] and no KEPT j suppresses
// i: the fixpoint the Pallas kernel iterates to, which is the greedy result.
//
// What bounds it on the H100: nothing the card is short of.  At the
// serving size (B=128, K=64) it reads ~180 KB and does ~3.6 MFLOP of IoU
// math, a fraction of a microsecond at 3.35 TB/s or 67 TFLOP/s; the
// launch and the K-step sequential greedy pass (a chain of dependent
// shared-memory reads inside one block) are what it costs.
//
// Design: one block per image.  All threads first build the suppression
// relation as a bitmask in shared memory, ceil(K/64) 64-bit words per row
// (32 KB at K=512), each thread filling whole words so that no atomics are
// needed.  Then one warp walks the candidates in score order: lane l holds
// word l of the "removed" set, the owner lane's word is broadcast with a
// shuffle to decide candidate i, and a kept candidate ORs its row into the
// set, one word per lane.  The TPU kernel's matvec fixpoint and its
// 8-images-per-instance blocking were TPU scheduling devices and are gone.
// Built with --fmad=false: an FMA contraction of area_j + area_i - inter
// could flip iou > thr at the boundary against the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 32;  // one word per lane of the greedy warp

__global__ void __launch_bounds__(kThreads) nms_suppress_kernel(
    const float4* __restrict__ boxes, const int* __restrict__ cls,
    const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep, int K,
    int W, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_box = reinterpret_cast<float4*>(smem);
  unsigned long long* s_mask =
      reinterpret_cast<unsigned long long*>(smem + (size_t)K * 16);
  float* s_area = reinterpret_cast<float*>(smem + (size_t)K * 16 +
                                           (size_t)K * W * 8);
  int* s_cls = reinterpret_cast<int*>(s_area + K);
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_cls + K);

  const size_t img = (size_t)blockIdx.x * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const float4 b = boxes[img + i];
    s_box[i] = b;
    s_area[i] = fmaxf(b.z - b.x, 0.f) * fmaxf(b.w - b.y, 0.f);
    s_cls[i] = cls[img + i];
    s_valid[i] = valid[img + i];
  }
  __syncthreads();

  // row j, word w: bit q set iff j suppresses i = 64 * w + q
  for (int t = threadIdx.x; t < K * W; t += blockDim.x) {
    const int j = t / W;
    const int i0 = (t - j * W) * 64;
    const int i_end = min(i0 + 64, K);
    unsigned long long bits = 0ull;
    const float4 a = s_box[j];
    const float area_j = s_area[j];
    const int cj = s_cls[j];
    for (int i = max(i0, j + 1); i < i_end; ++i) {
      if (s_cls[i] != cj) continue;
      const float4 c = s_box[i];
      const float lt_x = fmaxf(a.x, c.x);
      const float lt_y = fmaxf(a.y, c.y);
      const float rb_x = fminf(a.z, c.z);
      const float rb_y = fminf(a.w, c.w);
      const float inter = fmaxf(rb_x - lt_x, 0.f) * fmaxf(rb_y - lt_y, 0.f);
      const float uni = area_j + s_area[i] - inter + 1e-6f;
      if (inter / uni > thr) bits |= 1ull << (i - i0);
    }
    s_mask[t] = bits;
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned long long removed = 0ull;  // word `lane` of the removed set
    uint8_t* out = keep + img;
    for (int i = 0; i < K; ++i) {
      const unsigned long long word =
          __shfl_sync(0xffffffffu, removed, i >> 6);
      const bool kept = s_valid[i] && !((word >> (i & 63)) & 1ull);
      if (lane == 0) out[i] = kept;
      if (kept && lane < W) removed |= s_mask[(size_t)i * W + lane];
    }
  }
}

}  // namespace

extern "C" int litepi_nms_suppress(const void* boxes, const void* cls,
                                   const void* valid, void* keep, int B,
                                   int K, float thr, void* stream) {
  const int W = (K + 63) / 64;
  if (B <= 0 || K <= 0 || W > kMaxWords) return cudaErrorInvalidValue;
  const size_t smem = (size_t)K * 16 + (size_t)K * W * 8 + (size_t)K * 9;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  nms_suppress_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(cls),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), K, W,
      thr);
  return cudaGetLastError();
}
