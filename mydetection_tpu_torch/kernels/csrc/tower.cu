// Chain of L x [3x3 same conv + bias + ReLU] for Hopper (sm_90a): the
// RetinaNet head towers.
//
// Replaces the TPU kernel mydetection_tpu/ops/pallas/tower_kernel.py
// _chain_kernel (conv3x3_chain_pallas_impl), which RetinaNet's two
// subnets run at each of the five pyramid levels: 4 layers of a 3x3
// conv C -> C (C = 256), each followed by its bias and a ReLU.
//
// Each layer is an implicit GEMM, the TPU kernel's formulation:
//   out[m, n] = relu(sum_k A[m, k] * Wt[k, n] + bias[n])
// with M = B*H*W output pixels, N = C output channels and K = 9*C,
// k = tap * C + ci, tap = (dy + 1) * 3 + (dx + 1), and
//   A[m, k] = x[pixel m shifted by (dy, dx), ci], zero off the image.
// Wt is the layer's (9*C, C) block of the packed weights: row block
// (l*9 + t)*C is layer l, tap t's (C_in, C_out) matrix, as in the TPU
// kernel. A tap that falls off the image reads zero (the TPU kernel's
// border mask), never the neighbouring row.
//
// Numerics, the TPU kernel's: a float32 accumulator, the float32 bias
// added to it, the ReLU, then one rounding to x's type per layer.
//
// Bound on an H100: operations. At batch 32 and 608 the ten calls of a
// forward do 2.33 TFLOP of bf16 products against about 0.3 GB moved,
// 2.35 ms at 989 TFLOP/s. Only wgmma reaches that rate, and a block of
// wgmma needs its operands in shared memory ahead of it.
//
// bf16 (C a multiple of 64): one wgmma kernel, replacing an earlier
// nvcuda::wmma (mma.sync) kernel whose loads went through registers into
// two buffers, with a 128 x 128 tile that gathered A once per N half.
//   - Tiles. A block owns BM x BN outputs with two consumer warpgroups:
//     at BM = 128 each takes 64 rows and all BN columns (128 x 256 at
//     C = 256: the whole N, so A is gathered once), at BM = 64 each
//     takes all rows and half the columns. Each runs wgmma.mma_async
//     m64nNk16 bf16 -> f32 with both operands in shared memory and keeps
//     one wgmma group in flight (wait_group 1).
//   - Ring. K advances 64 at a time, one 128-byte row of one tap's
//     channels (a chunk never straddles two taps), through 4 stages of
//     shared memory (A BM x 64 and Wt 64 x BN; 48 KB at 128 x 256).
//     One producer thread (a third warpgroup, its registers given to the
//     consumers by setmaxnreg) fills a stage with TMA as soon as both
//     consumer warpgroups release it (an mbarrier pair a stage, full and
//     empty), so three chunks are in flight ahead of the products:
//       A: the 9-tap gather is TMA's im2col mode: one box of BM output
//          pixels x 64 channels, walked in flat (B, H, W) order from the
//          tile's first pixel, each pixel shifted by the tap; a pixel off
//          the image, or past the batch, reads zero (the TPU kernel's
//          border mask);
//       Wt: 64 x 64 boxes of the packed weights, which are N-contiguous,
//          so MN-major (the transpose bit) in 64-column blocks.
//     Both land in the 128-byte swizzle the wgmma descriptors name
//     (16-byte column c of 128-byte row r at c ^ (r % 8)). The
//     descriptors of the weights and of each layer's input are encoded
//     on the host per call.
//   - Small levels. The launcher takes 64 x 128 tiles (two blocks an
//     SM, four times the blocks) where 128-row tiles would occupy fewer
//     than half the SMs (P6 and P7 at batch 32: 25 and 7 tiles). P5's
//     91 keep the large tile, which measured faster there than 362
//     small ones.
//   - Epilogue. Bias, ReLU and the rounding in float32 straight from
//     the accumulator fragment (row lane/4 (+8), columns 2 * (lane%4)
//     (+1) of each 8-column group), rows past M masked, bf16 pairs
//     stored channels_last.
// Measured on an H100 (PERF.md §6): loading A with cp.async 16 B
// (zero-filled by src-size 0) left P3 at 51% of its bound, TMA for Wt
// alone at 57%, and TMA for both at 64%.
//
// float32 (the parity runs): a SIMT tile of 64 x 64, K in chunks of
// 16, 4 x 4 outputs a thread, accumulated with explicit fmaf in k
// order (the build's -fmad=false does not touch an explicit fmaf).
//
// Both sum every output in one fixed order, with no split of K and no
// atomics, so two runs give the same bits.
//
// Layers: the host launches one kernel per layer, ping-ponging between
// the caller's output and one scratch slab, so the intermediates go
// through device memory. The TPU kernel keeps the whole level slab in
// VMEM; P3 at 608 is 2.9 MB a image in bf16, more than an SM's 228 KB
// of shared memory. Keeping a layer's output on chip (clusters sharing
// their shared memory, a halo exchange between them) is later work.

#include <cstdint>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

// ---- bf16 wgmma path -------------------------------------------------------

constexpr int kWgThreads = 384;       // two consumer warpgroups, a producer

constexpr int kStages = 4;
constexpr int kBK = 64;               // K a chunk: one 128-byte swizzle row
constexpr int kRowBytes = kBK * 2;
constexpr int kBlockBytes = kBK * kRowBytes;  // 64 x 64 bf16, 8 KB
// a layer whose 128-row tiles would occupy fewer than half of an H100's
// 132 SMs takes the 64 x 128 tile
constexpr int kSmallTileBelow = 66;

template <int BM, int BN>
struct Tile {
  static constexpr int kWN = BM == 128 ? BN : BN / 2;  // a warpgroup's columns
  static constexpr int kABytes = BM * kRowBytes;
  static constexpr int kStageBytes = kABytes + BN * kRowBytes;
  // + 1024: the ring starts on a 1024-byte boundary (a swizzle atom)
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;
};

// BM pixels of x, 64 channels each, for one tap: the im2col box that
// starts at output pixel (n, hq, wq), shifted by the tap (fx, fy) in
// 0..2; pixels off the image or past the batch read zero
__device__ __forceinline__ void tma_im2col(uint32_t dst, const CUtensorMap* map,
                                           int ci, int wq, int hq, int n,
                                           uint16_t fx, uint16_t fy,
                                           uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(ci), "r"(wq), "r"(hq), "r"(n),
      "r"(bar), "h"(fx), "h"(fy)
      : "memory");
}

template <int WN>
__device__ __forceinline__ void wgmma(float* d, uint64_t a, uint64_t b) {
  if constexpr (WN == 256) {
    wgmma_ss_n256(d, a, b);
  } else {
    static_assert(WN == 64, "a warpgroup takes 256 or 64 columns");
    wgmma_ss_n64(d, a, b);
  }
}


template <int BM, int BN>
__global__ void __launch_bounds__(kWgThreads, BM == 64 ? 2 : 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, int w_row0,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     int m_total, int h, int w, int c) {
  using T = Tile<BM, BN>;
  constexpr int kWN = T::kWN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // full, then empty
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = smem_u32(bars);
  const uint32_t empty = full + 8 * kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int chunks = 9 * c / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full with TMA copies
    if constexpr (kWN == 256) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    }
    if (tid == 256) {
      const int hw = h * w;
      const int img = m0 / hw;
      const int hq = (m0 % hw) / w;
      const int wq = m0 % w;
      for (int kc = 0; kc < chunks; ++kc) {
        const int s = kc % kStages;
        mbar_wait(empty + 8 * s, ((kc / kStages) & 1) ^ 1);
        const uint32_t stage = ring + s * T::kStageBytes;
        const int k0 = kc * kBK;
        const int tap = k0 / c;
        mbar_expect(full + 8 * s, (BM + BN) * kRowBytes);
        // the box's corner is the tap window's top left: (hq - 1, wq - 1)
        tma_im2col(stage, &xmap, k0 - tap * c, wq - 1, hq - 1, img,
                   static_cast<uint16_t>(tap % 3),
                   static_cast<uint16_t>(tap / 3), full + 8 * s);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          tma_load(stage + T::kABytes + j * kBlockBytes, &wmap, n0 + 64 * j,
                   w_row0 + k0, full + 8 * s);
        }
      }
    }
  } else {
    if constexpr (kWN == 256) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    }
    float acc[kWN / 2];
#pragma unroll
    for (int i = 0; i < kWN / 2; ++i) acc[i] = 0.0f;
    // this warpgroup's operands inside a stage
    const uint32_t a_off = BM == 128 ? wg * 64 * kRowBytes : 0;
    const uint32_t b_off =
        T::kABytes + (BM == 128 ? 0 : wg * (kWN / 64) * kBlockBytes);
    for (int kc = 0; kc < chunks; ++kc) {
      const int s = kc % kStages;
      mbar_wait(full + 8 * s, (kc / kStages) & 1);
      const uint32_t stage = ring + s * T::kStageBytes;
      fence_acc<kWN / 2>(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: next 16 K = 32 bytes along the swizzled row; 8-row groups
        // 1024 bytes apart. Wt: next 16 K = 16 rows; 64-column blocks
        // kBlockBytes apart, 8-row groups 1024 bytes apart.
        const uint64_t da = sw128_desc(stage + a_off + kk * 32, 16, 1024);
        const uint64_t db = sw128_desc(stage + b_off + kk * 16 * kRowBytes,
                                       kBlockBytes, 1024);
        wgmma<kWN>(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc<kWN / 2>(acc);
      // the products of chunk kc - 1 are done: its stage may refill
      if (kc > 0) mbar_arrive(empty + 8 * ((kc - 1) % kStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc<kWN / 2>(acc);

    // acc[4j + 2 half + e] is row lane/4 + 8 half, column 8j + 2 (lane%4)
    // + e of the warpgroup's 64 x kWN tile (warp q: rows 16q .. 16q + 15)
    const int lane = tid % 32;
    const int row = m0 + (BM == 128 ? wg * 64 : 0) + ((tid % 128) / 32) * 16 +
                    lane / 4;
    const int col = n0 + (BM == 128 ? 0 : wg * kWN) + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
      const int n = col + j * 8;
      const float2 bv = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = row + half * 8;
        if (m < m_total) {
          const float y0 = fmaxf(acc[4 * j + 2 * half] + bv.x, 0.0f);
          const float y1 = fmaxf(acc[4 * j + 2 * half + 1] + bv.y, 0.0f);
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<int64_t>(m) * c + n) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
  }
}

// The TMA descriptor of the packed weights, (rows, C) bf16 row-major,
// read in 64 x 64 boxes in the 128-byte swizzle.
cudaError_t weight_map(CUtensorMap* map, const bf16* wt, int rows, int c) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(c) * 2};
  const cuuint32_t box[2] = {64, kBK};
  return encode_tiled(map, wt, 2, dims, strides, box);
}

// The im2col TMA descriptor of x (B, H, W, C) bf16: `pixels` output
// pixels a box, 64 channels each, in the 128-byte swizzle; the window of
// a 3x3 "same" conv (corners -1, -1: a box's coordinates are its first
// output pixel less one in H and W, the tap offsets 0..2). The encoder
// lives in libcuda, looked up through the runtime's entry-point query.
cudaError_t x_map(CUtensorMap* map, const bf16* x, int b, int h, int w, int c,
                  int pixels) {
  static const auto encode = libcuda_entry<PFN_cuTensorMapEncodeIm2col_v12000>(
      "cuTensorMapEncodeIm2col");
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
      static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(c) * 2,
                                 static_cast<cuuint64_t>(w) * c * 2,
                                 static_cast<cuuint64_t>(h) * w * c * 2};
  const int lower[2] = {-1, -1};
  const int upper[2] = {-1, -1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(x), dims,
      strides, lower, upper, kBK, pixels, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BM, int BN>
cudaError_t launch_wgmma(const bf16* x, const CUtensorMap& wmap, int w_row0,
                         const float* bias, bf16* out, int b, int h, int w,
                         int c, cudaStream_t stream) {
  constexpr int smem = Tile<BM, BN>::kSmemBytes;
  CUtensorMap xmap;
  cudaError_t err = x_map(&xmap, x, b, h, w, c, BM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3x3_wgmma_kernel<BM, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int m_total = b * h * w;
  const dim3 grid((m_total + BM - 1) / BM, c / BN);
  conv3x3_wgmma_kernel<BM, BN><<<grid, kWgThreads, smem, stream>>>(
      xmap, wmap, w_row0, bias, out, m_total, h, w, c);
  return cudaGetLastError();
}

// One bf16 layer. 128 x 256 tiles where C is a multiple of 256 (128 x 64
// otherwise); 64 x 128 tiles where the 128-row tiles would be fewer than
// kSmallTileBelow blocks.
cudaError_t conv3x3_bf16(const bf16* x, const CUtensorMap& wmap, int w_row0,
                         const float* bias, bf16* out, int b, int h, int w,
                         int c, cudaStream_t stream) {
  const int64_t big = static_cast<int64_t>((b * h * w + 127) / 128) *
                      (c % 256 == 0 ? c / 256 : c / 64);
  if (c % 128 == 0 && big < kSmallTileBelow) {
    return launch_wgmma<64, 128>(x, wmap, w_row0, bias, out, b, h, w, c,
                                 stream);
  }
  if (c % 256 == 0) {
    return launch_wgmma<128, 256>(x, wmap, w_row0, bias, out, b, h, w, c,
                                  stream);
  }
  return launch_wgmma<128, 64>(x, wmap, w_row0, bias, out, b, h, w, c, stream);
}

// ---- float32 SIMT path -----------------------------------------------------

constexpr int kThreads = 256;
constexpr int kFM = 64;
constexpr int kFN = 64;
constexpr int kFK = 16;

__global__ void __launch_bounds__(kThreads)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int m_total, int h, int w, int c) {
  __shared__ float as[kFK][kFM];
  __shared__ float bs[kFK][kFN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // 4 output columns tx*4 .. +4
  const int ty = tid / 16;   // 4 output rows ty*4 .. +4
  const int m0 = blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;
  const int k_total = 9 * c;
  const int hw = h * w;

  // A staging: element e = tid + 256*i is row e/16, k e%16 of the chunk
  const int a_k = tid % 16;
  int a_m[4], a_h[4], a_w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a_m[i] = m0 + tid / 16 + i * 16;
    const int rem = a_m[i] % hw;
    a_h[i] = rem / w;
    a_w[i] = rem % w;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k_total; k0 += kFK) {
    const int k = k0 + a_k;
    int tap = 0, ci = 0, dy = 0, dx = 0;
    if (k < k_total) {
      tap = k / c;
      ci = k - tap * c;
      dy = tap / 3 - 1;
      dx = tap % 3 - 1;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.0f;
      const int hs = a_h[i] + dy;
      const int ws = a_w[i] + dx;
      if (k < k_total && a_m[i] < m_total && hs >= 0 && hs < h && ws >= 0 &&
          ws < w) {
        v = x[static_cast<int64_t>(a_m[i] + dy * w + dx) * c + ci];
      }
      as[a_k][tid / 16 + i * 16] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kThreads;
      const int kr = k0 + e / kFN;
      const int n = n0 + e % kFN;
      bs[e / kFN][e % kFN] =
          (kr < k_total && n < c) ? wt[static_cast<int64_t>(kr) * c + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < c) {
        out[static_cast<int64_t>(m) * c + n] = fmaxf(acc[i][j] + bias[n], 0.0f);
      }
    }
  }
}

template <typename T>
int launch_chain(const T* x, const T* wt, const float* bias, T* out,
                 T* scratch, int layers, int b, int h, int w, int c,
                 cudaStream_t stream) {
  const int m_total = b * h * w;
  const int64_t layer_w = static_cast<int64_t>(9) * c * c;
  CUtensorMap wmap;
  if constexpr (sizeof(T) == 2) {
    const cudaError_t err = weight_map(&wmap, wt, layers * 9 * c, c);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const T* src = x;
  for (int l = 0; l < layers; ++l) {
    // the last layer writes `out`, and the ones before alternate so
    // that no layer reads the slab it writes
    T* dst = ((layers - 1 - l) % 2 == 0) ? out : scratch;
    cudaError_t err;
    if constexpr (sizeof(T) == 2) {
      err = conv3x3_bf16(src, wmap, l * 9 * c, bias + l * c, dst, b, h, w, c,
                         stream);
    } else {
      const dim3 grid((m_total + kFM - 1) / kFM, (c + kFN - 1) / kFN);
      conv3x3_f32_kernel<<<grid, kThreads, 0, stream>>>(
          src, wt + l * layer_w, bias + l * c, dst, m_total, h, w, c);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

}  // namespace

extern "C" {

// x, out, scratch: (B, H, W, C) in memory, 16-byte aligned; wt: (L, 9*C,
// C) in x's type, 16-byte aligned; bias: (L, C) float32; C a multiple of
// 16 in float32, of 64 in bfloat16. dtype: 0 = float32, 1 = bfloat16.
// Launches L kernels on `stream` and returns the first cudaError_t that
// is not cudaSuccess, else 0.
int conv3x3_chain_launch(const void* x, const void* wt, const float* bias,
                         void* out, void* scratch, int layers, int b, int h,
                         int w, int c, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_chain<float>(
        static_cast<const float*>(x), static_cast<const float*>(wt), bias,
        static_cast<float*>(out), static_cast<float*>(scratch), layers, b, h,
        w, c, s);
  }
  return launch_chain<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wt), bias,
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(scratch),
      layers, b, h, w, c, s);
}

const char* tower_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
