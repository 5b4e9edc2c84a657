// Stride-1 ResNet bottleneck with eval BatchNorm folded into the weights,
// one kernel for the whole block, for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/resnet_stage_experiments.py
// fused_block (kernel body `kernel`), written for ResNet stage 0 (152²,
// 64 -> 256 with the projection, then 256 -> 256, c_mid 64) and stage 1's
// stride-1 blocks (76², 512 -> 512, c_mid 128) at 608. With the folded
// weights W' = w * s and biases b' = bias - mean * s (s = scale *
// rsqrt(var + 1e-5), folded in float32 by the caller, W' then cast to x's
// type, b' kept float32), a block computes
//   y1  = round(relu(x . W1' + b1'))                     1x1, c_in -> c_mid
//   y2  = round(relu(sum over 9 taps of y1 . W2'_t + b2')) 3x3, zero outside
//   out = round(relu(y2 . W3' + b3' + x . Wd' + bd'))     with a projection
//   out = round(relu(y2 . W3' + b3' + float(x)))          without one
// every sum in float32, each of the three results rounded once to x's type.
// y1 is ZERO outside the image (the TPU kernel zeroes its halo rows and
// border columns): a halo pixel computed as relu(b1') would be wrong.
//
// Design. A block owns an 8 x 16 pixel tile of one image (128 GEMM rows)
// and keeps its intermediates in shared memory, as the TPU kernel keeps
// its strip in VMEM:
//   1. conv1 over the tile's 10 x 18 halo (180 rows, padded to 192), x
//      streamed from device memory in 32-channel chunks, into y1 (pixel
//      stride c_mid + 16, so every pixel starts 32-byte aligned and a
//      wmma fragment may start at any pixel: the taps shift by one);
//   2. conv2 as 9 taps x (c_mid / 32) chunks, A read straight from y1 at
//      the tap's offset, into y2;
//   3. conv3 (+ the projection, x re-read at the tile's pixels) in passes
//      of 128 output channels, bias, residual, ReLU, one rounding, store.
// The folded weights stream through shared memory in 32-row chunks:
// stage 1's (W1 128 KB, W2 288 KB, W3 128 KB in bf16) do not fit in an
// SM's 228 KB, where the TPU kernel kept them all in VMEM.
//
// bf16: eight warps, 4 along M by 2 along N, on nvcuda::wmma 16x16x16 bf16
// fragments with float accumulators; the next chunk's global loads are
// issued before the current chunk's products (two shared buffers). Each
// float fragment drains through a 16x16 float tile per warp in shared
// memory, where a lane adds the float32 bias (and the residual), applies
// the ReLU and rounds once.
// float32 (the parity runs): the same tiles and phases on SIMT, 16-deep
// K chunks, explicit fmaf in k order (-fmad=false leaves fmaf alone).
// Both sum every output in one fixed order, so two runs give the same bits.
//
// Bound on an H100: bytes. The six routed blocks of a 608 batch-32 forward
// do 623.8 GFLOP (0.63 ms at 989 TFLOP/s bf16) and must read x and write
// out once, 3.12 GB (0.93 ms at 3.35 TB/s). This first version re-reads
// each tile's halo and its stage's weights from L2, runs one block an SM
// (158-221 registers a thread) and uses neither wgmma nor TMA: it is
// right before it is fast.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kTileM = kTileH * kTileW;   // 128 output pixels
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloM = (kTileH + 2) * kHaloW;  // 180 halo pixels
constexpr int kHaloRows = 192;            // kHaloM rounded up to 4 x 48
constexpr int kBK = 32;                   // bf16 K chunk
constexpr int kNB = 128;                  // conv3 output channels a pass
constexpr int kALd = kBK + 8;             // staged A row stride (elements)

struct Args {
  const void* x;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  const void* w3;
  const float* b3;
  const void* wd;   // null without a projection
  const float* bd;
  void* out;
  int h, w, c_in, c_out, tiles_w;
};

// Where a block's tile lies, and the image coordinates of its pixels.
struct Tile {
  int img, h0, w0, h, w;
  __device__ bool inside(int y, int x) const {
    return y >= 0 && y < h && x >= 0 && x < w;
  }
  __device__ int64_t pixel(int y, int x) const {
    return (static_cast<int64_t>(img) * h + y) * w + x;
  }
  __device__ int halo_y(int p) const { return h0 - 1 + p / kHaloW; }
  __device__ int halo_x(int p) const { return w0 - 1 + p % kHaloW; }
  __device__ bool halo_inside(int p) const {
    return p < kHaloM && inside(halo_y(p), halo_x(p));
  }
  __device__ int tile_y(int m) const { return h0 + m / kTileW; }
  __device__ int tile_x(int m) const { return w0 + m % kTileW; }
};

__device__ __forceinline__ Tile block_tile(const Args& a) {
  return Tile{static_cast<int>(blockIdx.y),
              static_cast<int>(blockIdx.x) / a.tiles_w * kTileH,
              static_cast<int>(blockIdx.x) % a.tiles_w * kTileW, a.h, a.w};
}

// ---- bf16 tensor-core path -------------------------------------------------

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;

// A K chunk of weights, kBK rows by NB columns, through registers into
// shared memory (row stride NB + 8); rows past k_total and columns past
// n_total read zero.
template <int NB>
struct BStage {
  static constexpr int kVecs = kBK * NB / 8 / kThreads;
  static constexpr int kLd = NB + 8;
  uint4 reg[kVecs];
  __device__ void fetch(const bf16* wt, int ld, int k0, int k_total, int n0,
                        int n_total) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = threadIdx.x + i * kThreads;
      const int k = k0 + v / (NB / 8);
      const int n = n0 + v % (NB / 8) * 8;
      reg[i] = (k < k_total && n < n_total)
                   ? *reinterpret_cast<const uint4*>(
                         wt + static_cast<int64_t>(k) * ld + n)
                   : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ void stash(bf16* bs) const {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = threadIdx.x + i * kThreads;
      *reinterpret_cast<uint4*>(bs + v / (NB / 8) * kLd + v % (NB / 8) * 8) =
          reg[i];
    }
  }
};

// A K chunk of x at ROWS pixels (pix[i]: the element offset of the row's
// channel 0, or -1 for a row that reads zero), kBK channels a row, into
// shared memory (row stride kALd).
template <int ROWS>
struct AStage {
  static constexpr int kVecs = ROWS * kBK / 8 / kThreads;
  int64_t pix[kVecs];
  uint4 reg[kVecs];
  __device__ static int row(int i) { return (threadIdx.x + i * kThreads) / 4; }
  __device__ void fetch(const bf16* x, int k0, int c_in) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int k = k0 + (threadIdx.x % 4) * 8;
      reg[i] = (pix[i] >= 0 && k < c_in)
                   ? *reinterpret_cast<const uint4*>(x + pix[i] + k)
                   : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ void stash(bf16* as) const {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      *reinterpret_cast<uint4*>(as + row(i) * kALd + (threadIdx.x % 4) * 8) =
          reg[i];
    }
  }
};

// The K walk: chunk c + 1's global loads are in flight while chunk c's
// products run; two shared buffers. Every thread must be done with both
// buffers when it starts, and is again when it returns.
template <class Fetch, class Stash, class Mma>
__device__ __forceinline__ void k_walk(int chunks, Fetch fetch, Stash stash,
                                       Mma mma) {
  fetch(0);
  stash(0, 0);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) fetch(c + 1);
    mma(c & 1, c);
    if (c + 1 < chunks) stash((c + 1) & 1, c + 1);
    __syncthreads();
  }
}

// One accumulator fragment through the warp's float tile: lane l gets
// row l / 2, columns (l % 2) * 8 .. + 8, and hands them to f.
template <class F>
__device__ __forceinline__ void drain(const Acc& acc, float* tile, F f) {
  const int lane = threadIdx.x % 32;
  wmma::store_matrix_sync(tile, acc, 16, wmma::mem_row_major);
  __syncwarp();
  f(lane / 2, (lane % 2) * 8, tile + (lane / 2) * 16 + (lane % 2) * 8);
  __syncwarp();
}

template <int CM>
struct Bf16Smem {
  static constexpr int kY1Ld = CM + 16;   // 32-byte aligned pixels
  static constexpr int kY2Ld = CM + 8;
  static constexpr int kASize = kHaloRows * kALd;
  static constexpr int kBSize = kBK * (kNB + 8);   // CM <= kNB
  static constexpr size_t kY1 = 0;
  static constexpr size_t kY2 = kY1 + sizeof(bf16) * kHaloM * kY1Ld;
  static constexpr size_t kA = kY2 + sizeof(bf16) * kTileM * kY2Ld;
  static constexpr size_t kB = kA + sizeof(bf16) * 2 * kASize;
  static constexpr size_t kC = kB + sizeof(bf16) * 2 * kBSize;
  static constexpr size_t kBytes = kC + sizeof(float) * (kThreads / 32) * 256;
  static_assert(kY2 % 128 == 0 && kA % 128 == 0 && kB % 128 == 0 &&
                    kC % 128 == 0,
                "every region starts 128-byte aligned");
};

template <int CM>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_bf16_kernel(const Args a) {
  using S = Bf16Smem<CM>;
  constexpr int FN = CM / 32;   // a warp's fragments along c_mid
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* y1s = reinterpret_cast<bf16*>(smem + S::kY1);
  bf16* y2s = reinterpret_cast<bf16*>(smem + S::kY2);
  bf16* as = reinterpret_cast<bf16*>(smem + S::kA);
  bf16* bs = reinterpret_cast<bf16*>(smem + S::kB);
  const int warp = threadIdx.x / 32;
  float* tile = reinterpret_cast<float*>(smem + S::kC) + warp * 256;
  const int warp_m = warp / 2;
  const int warp_n = warp % 2;
  const Tile t = block_tile(a);
  const bf16* x = static_cast<const bf16*>(a.x);
  const int c_in = a.c_in;

  // ---- 1. y1 = relu(x . W1' + b1') over the halo, zero off the image
  {
    Acc acc[3][FN];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    AStage<kHaloRows> ast;
#pragma unroll
    for (int i = 0; i < AStage<kHaloRows>::kVecs; ++i) {
      const int p = AStage<kHaloRows>::row(i);
      ast.pix[i] = t.halo_inside(p)
                       ? t.pixel(t.halo_y(p), t.halo_x(p)) * c_in
                       : int64_t{-1};
    }
    BStage<CM> bst;
    const bf16* w1 = static_cast<const bf16*>(a.w1);
    k_walk(
        (c_in + kBK - 1) / kBK,
        [&](int c) {
          ast.fetch(x, c * kBK, c_in);
          bst.fetch(w1, CM, c * kBK, c_in, 0, CM);
        },
        [&](int buf, int) {
          ast.stash(as + buf * S::kASize);
          bst.stash(bs + buf * S::kBSize);
        },
        [&](int buf, int) {
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            FragA fa[3];
            FragB fb[FN];
#pragma unroll
            for (int i = 0; i < 3; ++i)
              wmma::load_matrix_sync(
                  fa[i], as + buf * S::kASize + (warp_m * 48 + i * 16) * kALd +
                             kk * 16,
                  kALd);
#pragma unroll
            for (int j = 0; j < FN; ++j)
              wmma::load_matrix_sync(
                  fb[j], bs + buf * S::kBSize + kk * 16 * (CM + 8) +
                             warp_n * (CM / 2) + j * 16,
                  CM + 8);
#pragma unroll
            for (int i = 0; i < 3; ++i)
#pragma unroll
              for (int j = 0; j < FN; ++j)
                wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
          }
        });
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        drain(acc[i][j], tile, [&](int er, int ec, const float* v) {
          const int p = warp_m * 48 + i * 16 + er;
          const int n = warp_n * (CM / 2) + j * 16 + ec;
          if (p >= kHaloM) return;
          const bool in = t.halo_inside(p);
          __align__(16) bf16 o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] = __float2bfloat16_rn(in ? fmaxf(v[e] + a.b1[n + e], 0.0f)
                                          : 0.0f);
          *reinterpret_cast<uint4*>(y1s + p * S::kY1Ld + n) =
              *reinterpret_cast<const uint4*>(o);
        });
  }
  __syncthreads();

  // ---- 2. y2 = relu(sum over taps of y1 . W2'_t + b2')
  {
    constexpr int kPerTap = CM / kBK;
    Acc acc[2][FN];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    BStage<CM> bst;
    const bf16* w2 = static_cast<const bf16*>(a.w2);
    k_walk(
        9 * kPerTap,
        [&](int c) { bst.fetch(w2, CM, c * kBK, 9 * CM, 0, CM); },
        [&](int buf, int) { bst.stash(bs + buf * S::kBSize); },
        [&](int buf, int c) {
          const int tap = c / kPerTap;
          const int k0 = (c % kPerTap) * kBK;
          const int dy = tap / 3;   // the halo is offset by one already
          const int dx = tap % 3;
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            FragA fa[2];
            FragB fb[FN];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int r = warp_m * 2 + i;   // tile row = 16 GEMM rows
              wmma::load_matrix_sync(
                  fa[i], y1s + ((r + dy) * kHaloW + dx) * S::kY1Ld + k0 +
                             kk * 16,
                  S::kY1Ld);
            }
#pragma unroll
            for (int j = 0; j < FN; ++j)
              wmma::load_matrix_sync(
                  fb[j], bs + buf * S::kBSize + kk * 16 * (CM + 8) +
                             warp_n * (CM / 2) + j * 16,
                  CM + 8);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < FN; ++j)
                wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
          }
        });
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        drain(acc[i][j], tile, [&](int er, int ec, const float* v) {
          const int m = (warp_m * 2 + i) * 16 + er;
          const int n = warp_n * (CM / 2) + j * 16 + ec;
          __align__(16) bf16 o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] = __float2bfloat16_rn(fmaxf(v[e] + a.b2[n + e], 0.0f));
          *reinterpret_cast<uint4*>(y2s + m * S::kY2Ld + n) =
              *reinterpret_cast<const uint4*>(o);
        });
  }
  __syncthreads();

  // ---- 3. out = relu(y2 . W3' + b3' + (x . Wd' + bd' | x)), 128 channels
  // a pass
  {
    const bool down = a.wd != nullptr;
    const int k_y2 = CM / kBK;
    const int k_x = down ? (c_in + kBK - 1) / kBK : 0;
    AStage<kTileM> ast;
#pragma unroll
    for (int i = 0; i < AStage<kTileM>::kVecs; ++i) {
      const int m = AStage<kTileM>::row(i);
      ast.pix[i] = t.inside(t.tile_y(m), t.tile_x(m))
                       ? t.pixel(t.tile_y(m), t.tile_x(m)) * c_in
                       : int64_t{-1};
    }
    const bf16* w3 = static_cast<const bf16*>(a.w3);
    const bf16* wd = static_cast<const bf16*>(a.wd);
    bf16* out = static_cast<bf16*>(a.out);
    for (int n0 = 0; n0 < a.c_out; n0 += kNB) {
      Acc acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
      BStage<kNB> bst;
      k_walk(
          k_y2 + k_x,
          [&](int c) {
            if (c < k_y2) {
              bst.fetch(w3, a.c_out, c * kBK, CM, n0, a.c_out);
            } else {
              ast.fetch(x, (c - k_y2) * kBK, c_in);
              bst.fetch(wd, a.c_out, (c - k_y2) * kBK, c_in, n0, a.c_out);
            }
          },
          [&](int buf, int c) {
            bst.stash(bs + buf * S::kBSize);
            if (c >= k_y2) ast.stash(as + buf * S::kASize);
          },
          [&](int buf, int c) {
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk) {
              FragA fa[2];
              FragB fb[4];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int r = warp_m * 32 + i * 16;
                if (c < k_y2)
                  wmma::load_matrix_sync(
                      fa[i], y2s + r * S::kY2Ld + c * kBK + kk * 16, S::kY2Ld);
                else
                  wmma::load_matrix_sync(
                      fa[i], as + buf * S::kASize + r * kALd + kk * 16, kALd);
              }
#pragma unroll
              for (int j = 0; j < 4; ++j)
                wmma::load_matrix_sync(
                    fb[j], bs + buf * S::kBSize + kk * 16 * (kNB + 8) +
                               warp_n * 64 + j * 16,
                    kNB + 8);
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
            }
          });
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          drain(acc[i][j], tile, [&](int er, int ec, const float* v) {
            const int m = warp_m * 32 + i * 16 + er;
            const int n = n0 + warp_n * 64 + j * 16 + ec;
            const int y = t.tile_y(m);
            const int xx = t.tile_x(m);
            if (!t.inside(y, xx) || n >= a.c_out) return;
            const int64_t pix = t.pixel(y, xx);
            float res[8];
            if (down) {
#pragma unroll
              for (int e = 0; e < 8; ++e) res[e] = a.bd[n + e];
            } else {
              const uint4 xv =
                  *reinterpret_cast<const uint4*>(x + pix * c_in + n);
              const bf16* xe = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
              for (int e = 0; e < 8; ++e) res[e] = __bfloat162float(xe[e]);
            }
            __align__(16) bf16 o[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              o[e] = __float2bfloat16_rn(
                  fmaxf(v[e] + a.b3[n + e] + res[e], 0.0f));
            *reinterpret_cast<uint4*>(out + pix * a.c_out + n) =
                *reinterpret_cast<const uint4*>(o);
          });
    }
  }
}

// ---- float32 SIMT path -----------------------------------------------------

constexpr int kFK = 16;   // float32 K chunk

template <int CM>
struct F32Smem {
  static constexpr size_t kY1 = 0;
  static constexpr size_t kY2 = kY1 + sizeof(float) * kHaloM * CM;
  static constexpr size_t kA = kY2 + sizeof(float) * kTileM * CM;
  static constexpr size_t kB = kA + sizeof(float) * kFK * kHaloRows;
  static constexpr size_t kBytes = kB + sizeof(float) * kFK * kNB;
};

// Thread (tm, tn) = (tid / 16, tid % 16) owns GEMM rows tm + 16 i and
// columns tn + 16 j of a phase's tile; as is [kFK][rows], bs [kFK][ld].
template <int RM, int RN>
__device__ __forceinline__ void simt_chunk(float (&acc)[RM][RN],
                                           const float* as, int a_ld,
                                           const float* bs, int b_ld) {
  const int tm = threadIdx.x / 16;
  const int tn = threadIdx.x % 16;
#pragma unroll
  for (int kk = 0; kk < kFK; ++kk) {
    float av[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = as[kk * a_ld + tm + 16 * i];
#pragma unroll
    for (int j = 0; j < RN; ++j) bv[j] = bs[kk * b_ld + tn + 16 * j];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Weights rows k0 .. k0 + kFK, columns n0 .. n0 + nb into bs[kFK][nb],
// zero past k_total or n_total.
__device__ __forceinline__ void stage_weights(float* bs, const float* wt,
                                              int ld, int k0, int k_total,
                                              int n0, int nb, int n_total) {
  for (int e = threadIdx.x; e < kFK * nb; e += kThreads) {
    const int k = k0 + e / nb;
    const int n = n0 + e % nb;
    bs[e] = (k < k_total && n < n_total)
                ? wt[static_cast<int64_t>(k) * ld + n]
                : 0.0f;
  }
}

template <int CM>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_f32_kernel(const Args a) {
  using S = F32Smem<CM>;
  constexpr int RN = CM / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* y1s = reinterpret_cast<float*>(smem + S::kY1);   // [180][CM]
  float* y2s = reinterpret_cast<float*>(smem + S::kY2);   // [128][CM]
  float* as = reinterpret_cast<float*>(smem + S::kA);
  float* bs = reinterpret_cast<float*>(smem + S::kB);
  const int tm = threadIdx.x / 16;
  const int tn = threadIdx.x % 16;
  const Tile t = block_tile(a);
  const float* x = static_cast<const float*>(a.x);
  const int c_in = a.c_in;

  // ---- 1. conv1 over the halo: rows tm + 16 i (i < 12), columns tn + 16 j
  {
    float acc[kHaloRows / 16][RN] = {};
    for (int k0 = 0; k0 < c_in; k0 += kFK) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kHaloRows / 16; ++i) {
        const int p = tm + 16 * i;
        const int k = k0 + tn;
        as[tn * kHaloRows + p] =
            (t.halo_inside(p) && k < c_in)
                ? x[t.pixel(t.halo_y(p), t.halo_x(p)) * c_in + k]
                : 0.0f;
      }
      stage_weights(bs, static_cast<const float*>(a.w1), CM, k0, c_in, 0, CM,
                    CM);
      __syncthreads();
      simt_chunk(acc, as, kHaloRows, bs, CM);
    }
#pragma unroll
    for (int i = 0; i < kHaloRows / 16; ++i) {
      const int p = tm + 16 * i;
      if (p >= kHaloM) continue;
      const bool in = t.halo_inside(p);
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int n = tn + 16 * j;
        y1s[p * CM + n] = in ? fmaxf(acc[i][j] + a.b1[n], 0.0f) : 0.0f;
      }
    }
  }
  __syncthreads();

  // ---- 2. conv2: row m = tm + 16 i is tile row i, column tm
  {
    float acc[kTileH][RN] = {};
    const float* w2 = static_cast<const float*>(a.w2);
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      for (int k0 = 0; k0 < CM; k0 += kFK) {
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kTileH; ++i)
          as[tn * kTileM + tm + 16 * i] =
              y1s[((i + dy) * kHaloW + tm + dx) * CM + k0 + tn];
        stage_weights(bs, w2, CM, tap * CM + k0, 9 * CM, 0, CM, CM);
        __syncthreads();
        simt_chunk(acc, as, kTileM, bs, CM);
      }
    }
#pragma unroll
    for (int i = 0; i < kTileH; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int n = tn + 16 * j;
        y2s[(tm + 16 * i) * CM + n] = fmaxf(acc[i][j] + a.b2[n], 0.0f);
      }
  }
  __syncthreads();

  // ---- 3. conv3 (+ projection), 128 output channels a pass
  const bool down = a.wd != nullptr;
  const float* w3 = static_cast<const float*>(a.w3);
  const float* wd = static_cast<const float*>(a.wd);
  float* out = static_cast<float*>(a.out);
  for (int n0 = 0; n0 < a.c_out; n0 += kNB) {
    float acc[kTileH][kNB / 16] = {};
    for (int k0 = 0; k0 < CM; k0 += kFK) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kTileH; ++i)
        as[tn * kTileM + tm + 16 * i] = y2s[(tm + 16 * i) * CM + k0 + tn];
      stage_weights(bs, w3, a.c_out, k0, CM, n0, kNB, a.c_out);
      __syncthreads();
      simt_chunk(acc, as, kTileM, bs, kNB);
    }
    if (down) {
      for (int k0 = 0; k0 < c_in; k0 += kFK) {
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kTileH; ++i) {
          const int y = t.h0 + i;
          const int xx = t.w0 + tm;
          const int k = k0 + tn;
          as[tn * kTileM + tm + 16 * i] =
              (t.inside(y, xx) && k < c_in) ? x[t.pixel(y, xx) * c_in + k]
                                            : 0.0f;
        }
        stage_weights(bs, wd, a.c_out, k0, c_in, n0, kNB, a.c_out);
        __syncthreads();
        simt_chunk(acc, as, kTileM, bs, kNB);
      }
    }
#pragma unroll
    for (int i = 0; i < kTileH; ++i) {
      const int y = t.h0 + i;
      const int xx = t.w0 + tm;
      if (!t.inside(y, xx)) continue;
      const int64_t pix = t.pixel(y, xx);
#pragma unroll
      for (int j = 0; j < kNB / 16; ++j) {
        const int n = n0 + tn + 16 * j;
        if (n >= a.c_out) continue;
        const float res = down ? a.bd[n] : x[pix * c_in + n];
        out[pix * a.c_out + n] = fmaxf(acc[i][j] + a.b3[n] + res, 0.0f);
      }
    }
  }
}

template <int CM>
size_t smem_bytes(int dtype) {
  return dtype == 1 ? Bf16Smem<CM>::kBytes : F32Smem<CM>::kBytes;
}

template <int CM>
int launch(const Args& a, int b, int dtype, cudaStream_t stream) {
  const int tiles_h = (a.h + kTileH - 1) / kTileH;
  const dim3 grid(tiles_h * a.tiles_w, b);
  const size_t bytes = smem_bytes<CM>(dtype);
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(bottleneck_bf16_kernel<CM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    bottleneck_bf16_kernel<CM><<<grid, kThreads, bytes, stream>>>(a);
  } else {
    err = cudaFuncSetAttribute(bottleneck_f32_kernel<CM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    bottleneck_f32_kernel<CM><<<grid, kThreads, bytes, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (B, H, W, c_in) in memory, out: (B, H, W, c_out), both 16-byte
// aligned; w1 (c_in, c_mid), w2 (9 * c_mid, c_mid) with row t * c_mid +
// ci tap t = (dy + 1) * 3 + (dx + 1)'s weights from ci, w3 (c_mid, c_out),
// wd (c_in, c_out) or null, all in x's type; b1, b2 (c_mid,), b3, bd
// (c_out,) float32 (bd null with wd). c_in and c_out multiples of 16,
// c_mid 64 or 128, c_in == c_out without a projection. dtype: 0 =
// float32, 1 = bfloat16. Launches one kernel on `stream` and returns the
// cudaError_t of the launch (0 on success).
int fused_bottleneck_launch(const void* x, const void* w1, const float* b1,
                            const void* w2, const float* b2, const void* w3,
                            const float* b3, const void* wd, const float* bd,
                            void* out, int b, int h, int w, int c_in,
                            int c_mid, int c_out, int dtype, void* stream) {
  const Args a{x, w1, b1, w2, b2, w3, b3, wd, bd, out, h, w, c_in, c_out,
               (w + kTileW - 1) / kTileW};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_mid == 64) return launch<64>(a, b, dtype, s);
  if (c_mid == 128) return launch<128>(a, b, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory a block takes, in bytes (0 for an unsupported
// c_mid).
int fused_bottleneck_smem_bytes(int c_mid, int dtype) {
  if (c_mid == 64) return static_cast<int>(smem_bytes<64>(dtype));
  if (c_mid == 128) return static_cast<int>(smem_bytes<128>(dtype));
  return 0;
}

const char* bottleneck_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
