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
// bf16: a block owns a 128 x 128 output tile and walks K in chunks of
// 32 through two shared-memory buffers (the next chunk's global loads
// are issued before the current chunk's products). Eight warps, 4
// along M by 2 along N, each hold 2 x 4 nvcuda::wmma 16x16x16 bf16
// fragments with float accumulators. A thread stages two 16-byte
// vectors of A (8 channels of one tap of one pixel, zero where the tap
// leaves the image or the pixel is past M) and two of Wt per chunk.
// The epilogue goes through a 16x16 float tile per warp in shared
// memory: bias, ReLU, round, one 16-byte store per lane.
//
// float32 (the parity runs): a SIMT tile of 64 x 64, K in chunks of
// 16, 4 x 4 outputs a thread, accumulated with explicit fmaf in k
// order (the build's -fmad=false does not touch an explicit fmaf).
//
// Both sum every output in one fixed order, so two runs give the same
// bits.
//
// Layers: the host launches one kernel per layer, ping-ponging between
// the caller's output and one scratch slab, so the intermediates go
// through device memory. The TPU kernel keeps the whole level slab in
// VMEM; P3 at 608 is 2.9 MB a image in bf16, more than an SM's 228 KB
// of shared memory. Keeping a layer's output on chip (clusters sharing
// their shared memory, a halo exchange between them) is later work.
//
// Bound on an H100: operations. At batch 32 and 608 the ten calls of a
// forward do 2.33 TFLOP of bf16 products against about 0.3 GB moved,
// ~2.4 ms at 989 TFLOP/s. This first version does not use wgmma or TMA
// and leaves the tensor cores well short of that rate; it is right
// before it is fast.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

// ---- bf16 tensor-core path -------------------------------------------------

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;     // 8 warps: 4 along M x 2 along N
constexpr int kApad = kBK + 8;    // A tile row stride (elements)
constexpr int kBpad = kBN + 8;    // Wt tile row stride (elements)
constexpr int kWarpM = 32;        // a warp's rows
constexpr int kWarpN = 64;        // a warp's columns

__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ wt,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int m_total, int h,
                    int w, int c) {
  __shared__ __align__(128) __nv_bfloat16 as[2][kBM][kApad];
  __shared__ __align__(128) __nv_bfloat16 bs[2][kBK][kBpad];
  __shared__ __align__(128) float cs[kThreads / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int warp_m = warp / 2;
  const int warp_n = warp % 2;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int k_total = 9 * c;
  const int hw = h * w;

  // A staging: rows tid/4 and tid/4 + 64, channels (tid%4)*8 .. +8 of
  // the chunk. Their pixel coordinates stay fixed over the K walk.
  const int a_vec = tid % 4;
  int a_m[2], a_h[2], a_w[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a_m[i] = m0 + tid / 4 + i * 64;
    const int rem = a_m[i] % hw;
    a_h[i] = rem / w;
    a_w[i] = rem % w;
  }
  // Wt staging: rows tid/16 and tid/16 + 16 of the chunk, columns
  // (tid%16)*8 .. +8 of the tile.
  const int b_row = tid / 16;
  const int b_col = (tid % 16) * 8;

  uint4 a_reg[2], b_reg[2];
  auto load_chunk = [&](int kc) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = kc * kBK + a_vec * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (a_m[i] < m_total && k < k_total) {
        const int tap = k / c;
        const int ci = k - tap * c;
        const int dy = tap / 3 - 1;
        const int dx = tap % 3 - 1;
        const int hs = a_h[i] + dy;
        const int ws = a_w[i] + dx;
        if (hs >= 0 && hs < h && ws >= 0 && ws < w) {
          const int64_t src = static_cast<int64_t>(a_m[i] + dy * w + dx) * c + ci;
          v = *reinterpret_cast<const uint4*>(x + src);
        }
      }
      a_reg[i] = v;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = kc * kBK + b_row + i * 16;
      const int n = n0 + b_col;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < k_total && n < c) {
        v = *reinterpret_cast<const uint4*>(
            wt + static_cast<int64_t>(k) * c + n);
      }
      b_reg[i] = v;
    }
  };
  auto store_chunk = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint4*>(&as[buf][tid / 4 + i * 64][a_vec * 8]) =
          a_reg[i];
      *reinterpret_cast<uint4*>(&bs[buf][b_row + i * 16][b_col]) = b_reg[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int chunks = (k_total + kBK - 1) / kBK;
  load_chunk(0);
  store_chunk(0);
  __syncthreads();
  for (int kc = 0; kc < chunks; ++kc) {
    const int cur = kc & 1;
    if (kc + 1 < chunks) load_chunk(kc + 1);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &as[cur][warp_m * kWarpM + i * 16][kk * 16],
                               kApad);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &bs[cur][kk * 16][warp_n * kWarpN + j * 16],
                               kBpad);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (kc + 1 < chunks) store_chunk(cur ^ 1);
    __syncthreads();
  }

  // epilogue: a lane takes row lane/2, columns (lane%2)*8 .. +8 of each
  // 16x16 fragment
  float* tile = cs[warp];
  const int er = lane / 2;
  const int ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(tile, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + warp_m * kWarpM + i * 16 + er;
      const int n = n0 + warp_n * kWarpN + j * 16 + ec;
      if (m < m_total && n < c) {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float y = tile[er * 16 + ec + e] + bias[n + e];
          v[e] = __float2bfloat16_rn(fmaxf(y, 0.0f));
        }
        *reinterpret_cast<uint4*>(out + static_cast<int64_t>(m) * c + n) =
            *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

// ---- float32 SIMT path -----------------------------------------------------

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
  const T* src = x;
  for (int l = 0; l < layers; ++l) {
    // the last layer writes `out`, and the ones before alternate so
    // that no layer reads the slab it writes
    T* dst = ((layers - 1 - l) % 2 == 0) ? out : scratch;
    if constexpr (sizeof(T) == 2) {
      const dim3 grid((m_total + kBM - 1) / kBM, (c + kBN - 1) / kBN);
      conv3x3_bf16_kernel<<<grid, kThreads, 0, stream>>>(
          src, wt + l * layer_w, bias + l * c, dst, m_total, h, w, c);
    } else {
      const dim3 grid((m_total + kFM - 1) / kFM, (c + kFN - 1) / kFN);
      conv3x3_f32_kernel<<<grid, kThreads, 0, stream>>>(
          src, wt + l * layer_w, bias + l * c, dst, m_total, h, w, c);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

}  // namespace

extern "C" {

// x, out, scratch: (B, H, W, C) in memory, 16-byte aligned; wt: (L, 9*C,
// C) in x's type; bias: (L, C) float32; C a multiple of 16. dtype: 0 =
// float32, 1 = bfloat16. Launches L kernels on `stream` and returns the
// first cudaError_t that is not cudaSuccess, else 0.
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
