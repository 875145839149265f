// YOLO-World's contrastive class head at vocabulary width as one GEMM per
// level: the class logits of one level written straight into the float32
// (B, A, nc) tensor, the bias added in the epilogue.
//
// Replaces no TPU kernel: YOLO-World has no counterpart in the JAX package.
// It takes the place of three passes on the card, per level: the 512 -> nc
// 1x1 conv (cls{i}_out, cuDNN; nc = 1,203 is no multiple of 8, so cuDNN
// takes an sm75 mma.sync kernel), ATen's bf16 bias add, and the float32
// copy of the level into the (B, A, nc) logits.  Plain version:
// litepi_tpu_torch/kernels/vocab.py::vocab_logits_plain (F.conv2d in the
// input's dtype, the bias add, the flatten and the float32 copy).
//
// Contract: x, the level's BatchNorm output (B, K, H, W) bf16 dense
// channels last, is an (M, K) row-major matrix, M = B * H * W; w (nc, K)
// and bias (nc,) bf16.  Row m = b * HW + p of the product goes to row
// b * A + a0 + p of out, a float32 (B, A, nc) tensor.  Each value rounds as
// the three passes round it: the float32 sum rounded to bf16 (the conv's
// output), plus the bf16 bias in float32 rounded to bf16 (ATen's add),
// widened to float32.  Only the order of the float32 sum differs from
// cuDNN's.  K is a multiple of 64; any M and nc.
//
// What bounds it on the H100: bytes.  At the YOLO-World-v2-L cell (B=32 at
// 1280: M = 1,075,200 over the three levels, K = 512, nc = 1,203) it
// writes 5.17 GB of float32 logits and reads 1.10 GB of bf16 embeddings:
// 1.87 ms at 3.35 TB/s, against 1.34 ms for its 1.325 TFLOP of bf16
// products at 989 TFLOP/s.
//
// Design: a persistent block per SM walks items of 128 rows by 256
// classes, the items of a row tile side by side (consecutive blocks), each
// item's product starting kOverlap classes before its share of kStep.  One
// producer thread streams each item's x and w pieces (64 deep) by TMA
// through a ring of kStages (zeros past M and nc, and before class 0).  Two
// consumer warpgroups take 64 rows each, one m64n256k16 wgmma per 16 of K
// into float32 sums.  Writing the float32 logits is the cost: the card
// takes them at about 2 TB/s in row pieces this size (3.2 TB/s
// contiguous), so they are written while the next item's products run.  After
// its products each consumer finishes its sums (the two roundings and the
// bias) into a bf16 tile in shared memory; during the next item's pieces of
// K each consumer warp widens its share of the tile's rows to float32 and
// stores them, the 32-byte sectors of out as whole float4 stores and the up
// to 7 values before a row's first sector and after its last alone.  Rows
// of out are 4 * nc bytes apart (4,812: no multiple of 16, so TMA cannot
// store them); each row's piece runs from the sector boundary at its share's
// start to the one at its end, so no sector but a row's first and last is
// written by two items.

#include <cuda.h>  // CUtensorMap and its enums; the entry point comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;    // rows of x per item
constexpr int kBlockN = 256;    // classes per item's product
// an item's product starts kOverlap classes before its share of kStep, so
// that each row's piece can start and end on a 32-byte sector of out
constexpr int kOverlap = 8;
constexpr int kStep = kBlockN - kOverlap;
constexpr int kChunkK = 64;     // K per ring stage (128-byte swizzle)
constexpr int kStages = 3;      // ring stages of x and w pieces
constexpr int kConsumers = 2;   // warpgroups, 64 rows of the item each
constexpr int kProducerWarp = kConsumers * 4;
constexpr int kThreads = 32 * (kProducerWarp + 1);
constexpr int kABytes = kBlockM * kChunkK * 2;
constexpr int kWBytes = kBlockN * kChunkK * 2;
constexpr int kTilePitch = kBlockN + 8;  // bf16 per staged row

struct Smem {
  alignas(1024) uint8_t a[kStages][kABytes];
  alignas(1024) uint8_t w[kStages][kWBytes];
  __nv_bfloat16 tile[kBlockM][kTilePitch];  // the item's finished logits
  long long row_off[2][kBlockM];  // the element offset in out of each row, by item parity
  float2 bias[kBlockN / 2];       // the item's bias as float pairs
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // room to align the base to 1024

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` has completed; the thread
// sleeps in the hardware meanwhile (the hint: up to 10 ms a try), so that
// waiting warps take no issue slots from the working ones
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, 10000000;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// a K-major wgmma operand in the 128-byte swizzle TMA writes: 64 bf16 a
// row, atoms of 8 rows 1,024 bytes apart
__device__ __forceinline__ uint64_t operand_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (64 x 256 float32, the warpgroup's fragment) += a (64 x 16) * b (256 x
// 16)^T, both bf16 K-major in shared memory; d is overwritten when
// accumulate is 0
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t a, uint64_t b,
                                          uint32_t accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// the element offset in out of row `row` of x, or -1 past m
__device__ __forceinline__ long long row_offset(int row, int m, int hw, long long anchors, int a0,
                                                int nc) {
  if (row >= m) return -1;
  const int b = row / hw;
  return (static_cast<long long>(b) * anchors + a0 + (row - b * hw)) * nc;
}

// The column of row r's piece boundary at class `col`: the last column at
// or before it that starts a 32-byte sector of out (off: the row's element
// offset), or col itself at the row's ends.
__device__ __forceinline__ int piece_edge(long long off, int col, int nc) {
  return col <= 0 || col >= nc ? min(col < 0 ? 0 : col, nc)
                               : col - static_cast<int>((off + col) & 7);
}

// Row r of the staged tile to out, widened to float32: its piece of the
// row, from the sector boundary at n0 + kOverlap to the one at n0 + kOverlap
// + kStep (so that no sector but the row's first and last is shared with
// another item), as float4s over whole sectors, and the values before the
// row's first sector boundary and after its last alone.  One warp; n0 is
// the class of the tile's column 0.
__device__ __forceinline__ void store_row(const Smem& s, int r, const long long* row_off, int n0,
                                          int nc, float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const long long off = row_off[r];
  if (off < 0) return;
  const int lo = piece_edge(off, n0 + kOverlap, nc);
  const int hi = piece_edge(off, n0 + kOverlap + kStep, nc);
  const int head = min(static_cast<int>((8 - ((off + lo) & 7)) & 7), hi - lo);
  const int quads = (hi - lo - head) / 8 * 2;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(s.tile[r]);
  float* dst = out + off + lo;
  const int j0 = lo - n0;  // the piece's first column in the tile
#pragma unroll
  for (int h = 0; h < kBlockN / 128; ++h) {
    const int q = lane + 32 * h;
    if (q < quads) {
      // four bf16 from tile column j0 + head + 4 q on, at any 2-byte alignment
      const int pos = j0 + head + 4 * q;
      uint32_t v0 = words[pos >> 1], v1 = words[(pos >> 1) + 1];
      if (pos & 1) {
        v0 = __byte_perm(v0, v1, 0x5432);
        v1 = __byte_perm(v1, words[(pos >> 1) + 2], 0x5432);
      }
      reinterpret_cast<float4*>(dst + head)[q] =
          make_float4(__uint_as_float(v0 << 16), __uint_as_float(v0 & 0xffff0000u),
                      __uint_as_float(v1 << 16), __uint_as_float(v1 & 0xffff0000u));
    }
  }
  const int j = lane < 8 ? lane : head + 4 * quads + lane - 8;  // head, then tail
  if ((lane < 8 && lane < head) || (lane >= 8 && lane < 16 && j < hi - lo)) {
    dst[j] = __bfloat162float(s.tile[r][j0 + j]);
  }
}

// the consumers' own barrier (named barrier 1), apart from the producer
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 128) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1) vocab_gemm_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
    const __nv_bfloat16* __restrict__ bias, float* __restrict__ out, int m, int nc, int k,
    int hw, long long anchors, int a0) {
  extern __shared__ uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                     ~static_cast<uintptr_t>(1023));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = (nc + kStep - 1) / kStep;
  const int items = (m + kBlockM - 1) / kBlockM * n_tiles;
  const int chunks = k / kChunkK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    // producer: one thread streams each item's x and w pieces through the ring
    if (lane != 0) return;
    uint32_t issued = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int mt = item / n_tiles, nt = item % n_tiles;
      for (int kc = 0; kc < chunks; ++kc, ++issued) {
        const int st = issued % kStages;
        mbar_wait(&s.empty[st], ((issued / kStages) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], kABytes + kWBytes);
        tma_load(s.a[st], &x_map, kc * kChunkK, mt * kBlockM, &s.full[st]);
        tma_load(s.w[st], &w_map, kc * kChunkK, nt * kStep - kOverlap, &s.full[st]);
      }
    }
    return;
  }

  // consumer c: warps 4c .. 4c + 3, rows 64c .. 64c + 63 of each item.  The
  // last item's logits, staged in the tile, go to out while this item's
  // products run: warp w stores rows w, w + 8, ... of the tile, a share
  // after each piece of K
  const int c = warp / 4;
  const int t = threadIdx.x;  // 0 .. 255
  const int rows_per_piece = (kBlockM / 8 + chunks - 1) / chunks;
  uint32_t taken = 0;
  int last = 0;  // the parity of the last item's row offsets
  bool staged = false;  // the tile holds the last item's logits
  int staged_n0 = 0;    // the class of its column 0
  for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
    const int mt = item / n_tiles, n0 = item % n_tiles * kStep - kOverlap;
    const long long* staged_rows = s.row_off[(it & 1) ^ 1];
    float acc[128];
    int held = -1;  // the stage of the last piece, released after its products
    for (int kc = 0; kc < chunks; ++kc, ++taken) {
      const int st = taken % kStages;
      mbar_wait(&s.full[st], (taken / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kChunkK / 16; ++j) {
        wgmma_256(acc, operand_desc(s.a[st] + c * 64 * 128 + j * 32),
                  operand_desc(s.w[st] + j * 32), (kc | j) != 0);
      }
      wgmma_commit();
      if (kc == 0) {
        // this item's row offsets and bias pairs, while its products run
        // (the staging of the last item read the bias before the last sync)
        if (t < kBlockM) {
          s.row_off[it & 1][t] = row_offset(mt * kBlockM + t, m, hw, anchors, a0, nc);
        } else {
          // n0 is even: a pair lies wholly before class 0 or wholly after it
          const int col = n0 + 2 * (t - kBlockM);
          float2 b = make_float2(0.0f, 0.0f);
          if (col >= 0 && col + 1 < nc) {
            b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
          } else if (col >= 0 && col < nc) {
            b.x = __bfloat162float(bias[col]);
          }
          s.bias[t - kBlockM] = b;
        }
      }
      // the last piece's stage back to the producer before the stores,
      // which may wait on the memory system
      if (held >= 0) {
        wgmma_wait<1>();
        mbar_arrive(&s.empty[held]);
      }
      held = st;
      if (staged) {
        for (int j = kc * rows_per_piece; j < min(kBlockM / 8, (kc + 1) * rows_per_piece); ++j) {
          store_row(s, warp + 8 * j, staged_rows, staged_n0, nc, out);
        }
      }
    }
    wgmma_wait<0>();
    mbar_arrive(&s.empty[held]);
    // every warp is done with the tile: this item's finished logits into it.
    // Register i of acc is column 8 * (i / 4) + 2 * (lane % 4) + i % 2 of
    // row 16 * (warp % 4) + lane / 4, + 8 when (i / 2) % 2, of the
    // warpgroup's 64
    consumers_sync();
    const int row = c * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int q = 0; q < kBlockN / 8; ++q) {
      const int col = 8 * q + 2 * (lane % 4);
      const float2 b = s.bias[col / 2];
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int i = q * 4 + rh * 2;
        // the conv's bf16 output, then ATen's bf16 bias add
        const float2 conv = __bfloat1622float2(__floats2bfloat162_rn(acc[i], acc[i + 1]));
        *reinterpret_cast<__nv_bfloat162*>(&s.tile[row + rh * 8][col]) =
            __floats2bfloat162_rn(conv.x + b.x, conv.y + b.y);
      }
    }
    consumers_sync();
    staged = true;
    staged_n0 = n0;
    last = it;
  }
  if (staged) {
    for (int j = 0; j < kBlockM / 8; ++j) {
      store_row(s, warp + 8 * j, s.row_off[last & 1], staged_n0, nc, out);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, the driver's entry point as the runtime the
// library links hands it out (the library links no libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a (rows, k) bf16 row-major matrix in boxes of box_rows x box_k, swizzled
bool encode(CUtensorMap* map, const void* p, long long rows, long long k, int box_k,
            int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_k), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// out[b, a0 + p, n] for row m = b * hw + p of x (m, k) and class n of w (nc,
// k): bf16(bf16(x[m] . w[n]) + bias[n]) as float32; out is (m / hw, anchors,
// nc) float32.  Returns a cudaError_t.
extern "C" int litepi_vocab_gemm(const void* x, const void* w, const void* bias, void* out,
                                 long long m, long long k, long long nc, long long hw,
                                 long long anchors, long long a0, void* stream) {
  if (m <= 0 || m >= (1LL << 31) || k < kChunkK || k % kChunkK != 0 ||
      nc <= 0 || nc >= (1LL << 31) || hw <= 0 || m % hw != 0 || a0 < 0 ||
      a0 + hw > anchors || anchors >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || reinterpret_cast<uintptr_t>(bias) % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap x_map, w_map;
  if (!encode(&x_map, x, m, k, kChunkK, kBlockM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&w_map, w, nc, k, kChunkK, kBlockN, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  int dev = 0, sms = 1;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(vocab_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  }
  if (e != cudaSuccess) return e;
  const long long items = (m + kBlockM - 1) / kBlockM * ((nc + kStep - 1) / kStep);
  if (items >= (1LL << 31)) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < sms ? items : sms);
  vocab_gemm_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, static_cast<const __nv_bfloat16*>(bias), static_cast<float*>(out),
      static_cast<int>(m), static_cast<int>(nc), static_cast<int>(k), static_cast<int>(hw),
      anchors, static_cast<int>(a0));
  return cudaGetLastError();
}

