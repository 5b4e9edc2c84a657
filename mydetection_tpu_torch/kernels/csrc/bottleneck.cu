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
// Design. The work is cut into 8 x 16 pixel tiles of one image (128
// GEMM rows), and the block keeps a tile's intermediates in shared
// memory, as the TPU kernel keeps its strip in VMEM:
//   1. conv1 over the tile's 10 x 18 halo (180 rows, padded to 192) into
//      y1, zeroed off the image;
//   2. conv2 as 9 taps of y1 at the tap's offset, into y2;
//   3. conv3 (+ the projection on the tile's own pixels of x) in passes
//      of output channels, then bias, residual, ReLU, one rounding, store.
//
// bf16: a persistent, warp-specialised wgmma kernel fed by TMA. One block
// an SM (230,400 bytes of dynamic shared memory at c_mid 64, 222,208 at
// 128) walks tiles t, t + grid, ... in (image, row, column) order.
//   - Roles. One producer thread (a third warpgroup, its registers given
//     to the consumers by setmaxnreg) walks the block's tiles and fills
//     two rings by TMA, on an mbarrier pair a stage (full with its byte
//     count, empty with the 256 consumer threads): x's boxes (3 stages
//     of 24 KB) and the folded weights (5 stages of 16 KB at c_mid 64, 4
//     at 128). It runs ahead across phases and tiles, so the next tile's
//     halo arrives while this tile's conv3 runs.
//   - conv1: an x stage is 64 channels of the halo, one 4-D tiled box
//     (64 channels x 18 x 10 x 1 image) at signed coordinates that TMA
//     fills with zeros off the image, so no border code; a weight stage
//     64 rows of W1. A is three 64-row blocks of the box; at c_mid 128
//     each consumer warpgroup takes all three and half the columns, at
//     c_mid 64 one takes two blocks and the other one.
//   - conv2: a weight stage is 64 rows of W2 (one tap's 64 input
//     channels). A tap's rows start at halo offsets that are not on an
//     8-row swizzle atom, so A comes from y1 into registers by ldmatrix
//     at per-lane row addresses, one tile row a warp.
//   - conv3: a weight stage is 64 rows of W3, 128 columns (a pass); A is
//     y2, which conv2's epilogue writes in the swizzled layout a
//     descriptor reads. The projection adds x's 16 x 8 tile box and Wd.
//   - Products: wgmma.mma_async m64nNk16 bf16 -> f32 (N = 64 or 128),
//     one group in flight while the next stage is awaited (conv2 waits
//     for each group: its A registers are reloaded).
//   - Epilogues work on the accumulator fragments (row lane/4 (+8),
//     columns 2 (lane%4) (+1) of each 8-column group) and write shared
//     memory only, in the 128-byte swizzle: y1, y2, and conv3's output,
//     two 64-channel panels a warpgroup that one thread stores by TMA
//     (which leaves out pixels off the image) and into which it first
//     loads the residual x by TMA. Global stores and loads from the
//     epilogue's threads took about 100 clocks an instruction and made
//     the kernel 1.4 times slower (PERF.md §6).
//   - The folded weights stream from L2 through the ring for every tile
//     (stage 0's 136-144 KB, stage 1's 544 KB); cutting that traffic
//     did not move the time.
// float32 (the parity runs): the same tiles and phases on SIMT, one block
// a tile, 16-deep K chunks, explicit fmaf in k order (-fmad=false leaves
// fmaf alone).
// Both sum every output in one fixed order, with no split of K and no
// atomics, so two runs give the same bits.
//
// Bound on an H100: bytes. The six routed blocks of a 608 batch-32 forward
// do 623.8 GFLOP (0.63 ms at 989 TFLOP/s bf16) and must read x and write
// out once, 3.12 GB (0.93 ms at 3.35 TB/s). An earlier bf16 kernel on
// nvcuda::wmma (mma.sync), one block a tile with a barrier every 32
// channels, took 8.58 ms for the six (PERF.md §6).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kTileM = kTileH * kTileW;   // 128 output pixels
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloM = (kTileH + 2) * kHaloW;  // 180 halo pixels
constexpr int kHaloRows = 192;            // kHaloM rounded up to 3 x 64
constexpr int kNB = 128;                  // float32 conv3 columns a pass

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

// ---- bf16 wgmma path -------------------------------------------------------

constexpr int kWgThreads = 384;   // two consumer warpgroups, a producer
constexpr int kRowBytes = 128;    // 64 bf16 channels: one swizzled row
constexpr int kHaloBox = kHaloM * kRowBytes;    // x's 18 x 10 halo box
constexpr int kTileBox = kTileM * kRowBytes;    // x's 16 x 8 tile box
constexpr int kWBox = 64 * kRowBytes;           // 64 x 64 weights
constexpr int kXStage = kHaloRows * kRowBytes;  // an x stage: 192 rows
constexpr int kNP = 128;                        // conv3 columns a pass
constexpr int kWStage = (kNP / 64) * kWBox;     // a weight stage: 64 x 128
constexpr int kOutPanel = 64 * kRowBytes;       // 64 pixels x 64 channels

// y1 and y2 as c_mid / 64 panels of 128-byte swizzled rows (a halo pixel,
// a tile pixel); conv3's output tile (64 pixels x 128 channels a
// warpgroup, two panels each), on y1 at c_mid 128 (y1 is dead by then);
// then two rings of TMA stages: x's boxes and the weights'
template <int CM>
struct WgSmem {
  static constexpr int kPanels = CM / 64;
  static constexpr int kXStages = 3;
  static constexpr int kWStages = CM == 64 ? 5 : 4;
  static constexpr int kY1Panel = kHaloRows * kRowBytes;
  static constexpr int kY2Panel = kTileM * kRowBytes;
  static constexpr int kY2 = kPanels * kY1Panel;
  static constexpr bool kOutOnY1 = CM == 128;
  static constexpr int kOut = kOutOnY1 ? 0 : kY2 + kPanels * kY2Panel;
  static constexpr int kXRing =
      kY2 + kPanels * kY2Panel + (kOutOnY1 ? 0 : 4 * kOutPanel);
  static constexpr int kWRing = kXRing + kXStages * kXStage;
  // + 1024: everything starts on a 1024-byte boundary (a swizzle atom)
  static constexpr int kBytes = kWRing + kWStages * kWStage + 1024;
  static_assert(CM * kRowBytes <= kWStage, "a stage holds 64 rows of W2");
  static_assert(!kOutOnY1 || 4 * kOutPanel <= kPanels * kY1Panel,
                "the output panels fit on y1");
};

struct WgArgs {
  const bf16* x;
  const float* b1;
  const float* b2;
  const float* b3;
  const float* bd;   // null without a projection
  bf16* out;
  int h, w, c_in, c_out, tiles_w, tiles_hw, tiles;
};

struct TilePos {
  int img, h0, w0;
};

__device__ __forceinline__ TilePos tile_pos(const WgArgs& a, int t) {
  const int r = t % a.tiles_hw;
  return TilePos{t / a.tiles_hw, r / a.tiles_w * kTileH,
                 r % a.tiles_w * kTileW};
}

// The consumers' view of the two rings: stage addresses, the full and
// empty barriers (8 bytes a stage), and how many stages each has taken.
struct Rings {
  uint32_t x, w, xfull, xempty, wfull, wempty;
  int xi, wi;
};

__device__ __forceinline__ void consumer_bar() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the byte offset of channels c, c + 1 of row r in a swizzled panel
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * kRowBytes + ((((c % 64) / 8) ^ (r % 8)) << 4) + (c % 8) * 2;
}

// a barrier of one consumer warpgroup (ids 2, 3)
__device__ __forceinline__ void named_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// One phase of the consumers: `chunks` weight stages in order, with an x
// stage too where uses_x(c), each handed to `issue` (x stage, weight
// stage, c), which issues and commits one group of wgmma. DEPTH 1 keeps
// one group in flight while the next stages are awaited (operands in
// shared memory only); DEPTH 0 waits for each group (A in registers,
// which the next chunk's loads reuse). Stages are released once their
// products are done; every consumer thread arrives on `empty`.
template <int XS, int WS, int DEPTH, class UsesX, class Issue>
__device__ __forceinline__ void consume(Rings& r, int chunks, UsesX uses_x,
                                        Issue issue) {
  bool prev_x = false;
  for (int c = 0; c < chunks; ++c) {
    const bool ux = uses_x(c);
    const int ws = r.wi % WS;
    mbar_wait(r.wfull + 8 * ws, (r.wi / WS) & 1);
    uint32_t xs = 0;
    if (ux) {
      mbar_wait(r.xfull + 8 * (r.xi % XS), (r.xi / XS) & 1);
      xs = r.x + (r.xi % XS) * kXStage;
    }
    issue(xs, r.w + ws * kWStage, c);
    if constexpr (DEPTH == 1) {
      wgmma_wait<1>();
      if (c > 0) {
        mbar_arrive(r.wempty + 8 * ((r.wi + WS - 1) % WS));
        if (prev_x) mbar_arrive(r.xempty + 8 * ((r.xi + XS - 1) % XS));
      }
    } else {
      wgmma_wait<0>();
      mbar_arrive(r.wempty + 8 * ws);
      if (ux) mbar_arrive(r.xempty + 8 * (r.xi % XS));
    }
    ++r.wi;
    if (ux) ++r.xi;
    prev_x = ux;
  }
  if constexpr (DEPTH == 1) {
    wgmma_wait<0>();
    if (chunks > 0) {
      mbar_arrive(r.wempty + 8 * ((r.wi + WS - 1) % WS));
      if (prev_x) mbar_arrive(r.xempty + 8 * ((r.xi + XS - 1) % XS));
    }
  }
}

// conv1 for one warpgroup: NMB 64-row blocks of the halo from block MB0,
// output columns 64 nbox .. 64 nbox + 63, then y1 = relu(. + b1') in bf16,
// zero off the image (rows past the halo are never read)
template <int XS, int WS, int MB0, int NMB, bool OUT_ON_Y1>
__device__ __forceinline__ void conv1(const WgArgs& a, const TilePos& p,
                                      Rings& rings, int k1, uint32_t y1,
                                      int nbox) {
  float acc[NMB][32];
#pragma unroll
  for (int i = 0; i < NMB; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.0f;
  consume<XS, WS, 1>(
      rings, k1, [](int) { return true; },
      [&](uint32_t xs, uint32_t ws, int) {
        fence_acc<NMB * 32>(&acc[0][0]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = sw128_desc(
              ws + nbox * kWBox + kk * 16 * kRowBytes, kWBox, 1024);
#pragma unroll
          for (int i = 0; i < NMB; ++i) {
            wgmma_ss_n64(acc[i],
                         sw128_desc(xs + (MB0 + i) * 64 * kRowBytes + kk * 32,
                                    16, 1024),
                         db);
          }
        }
        wgmma_commit();
      });
  fence_acc<NMB * 32>(&acc[0][0]);
  if constexpr (OUT_ON_Y1) {
    // the last tile's output stores still read y1: both warpgroups' lead
    // threads wait for them before anyone writes
    if (threadIdx.x % 128 == 0) bulk_wait<true>();
    consumer_bar();
  }
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  uint8_t* smem = static_cast<uint8_t*>(__cvta_shared_to_generic(y1));
  // every load before the first store, which the compiler cannot move
  // them past
  float2 bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    bias[j] = *reinterpret_cast<const float2*>(a.b1 + nbox * 64 + j * 8 +
                                               (lane % 4) * 2);
#pragma unroll
  for (int i = 0; i < NMB; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (MB0 + i) * 64 + warp * 16 + lane / 4 + half * 8;
      if (r >= kHaloM) continue;
      const int hy = p.h0 - 1 + r / kHaloW;
      const int hx = p.w0 - 1 + r % kHaloW;
      const bool in = hy >= 0 && hy < a.h && hx >= 0 && hx < a.w;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = nbox * 64 + j * 8 + (lane % 4) * 2;
        const float v0 =
            in ? fmaxf(acc[i][4 * j + 2 * half] + bias[j].x, 0.0f) : 0.0f;
        const float v1 =
            in ? fmaxf(acc[i][4 * j + 2 * half + 1] + bias[j].y, 0.0f) : 0.0f;
        *reinterpret_cast<__nv_bfloat162*>(
            smem + (n / 64) * (kHaloRows * kRowBytes) + swizzled(r, n)) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int CM>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (CM == 128) {
    wgmma_rs_n128(d, a, b);
  } else {
    static_assert(CM == 64, "c_mid is 64 or 128");
    wgmma_rs_n64(d, a, b);
  }
}

template <int CM>
__global__ void __launch_bounds__(kWgThreads, 1)
bottleneck_wgmma_kernel(const __grid_constant__ CUtensorMap halo_map,
                        const __grid_constant__ CUtensorMap tile_map,
                        const __grid_constant__ CUtensorMap w1_map,
                        const __grid_constant__ CUtensorMap w2_map,
                        const __grid_constant__ CUtensorMap w3_map,
                        const __grid_constant__ CUtensorMap wd_map,
                        const __grid_constant__ CUtensorMap res_map,
                        const __grid_constant__ CUtensorMap out_map,
                        const WgArgs a) {
  using S = WgSmem<CM>;
  constexpr int P = S::kPanels;
  constexpr int XS = S::kXStages;
  constexpr int WS = S::kWStages;
  extern __shared__ uint8_t smem_raw[];
  // full, then empty: the x ring's, then the weight ring's; then each
  // consumer warpgroup's residual barrier
  __shared__ __align__(8) uint64_t bars[2 * (XS + WS) + 2];
  const uint32_t y1 = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t y2 = y1 + S::kY2;
  Rings rings{y1 + S::kXRing, y1 + S::kWRing, smem_u32(bars),
              smem_u32(bars) + 8 * XS, smem_u32(bars) + 16 * XS,
              smem_u32(bars) + 16 * XS + 8 * WS, 0, 0};
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const bool down = a.bd != nullptr;
  const int k1 = (a.c_in + 63) / 64;
  const int passes = (a.c_out + kNP - 1) / kNP;
  if (tid == 0) {
    for (int s = 0; s < XS; ++s) {
      mbar_init(rings.xfull + 8 * s, 1);
      mbar_init(rings.xempty + 8 * s, 256);   // every consumer thread
    }
    for (int s = 0; s < WS; ++s) {
      mbar_init(rings.wfull + 8 * s, 1);
      mbar_init(rings.wempty + 8 * s, 256);
    }
    mbar_init(rings.wempty + 8 * WS, 1);
    mbar_init(rings.wempty + 8 * WS + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread walks this block's tiles and keeps both rings
    // full, in the order the consumers take the stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 256) return;
    int xi = 0, wi = 0;
    auto next_x = [&](int bytes) {
      const int s = xi % XS;
      mbar_wait(rings.xempty + 8 * s, ((xi / XS) & 1) ^ 1);
      mbar_expect(rings.xfull + 8 * s, bytes);
      ++xi;
      return s;
    };
    auto next_w = [&](int bytes) {
      const int s = wi % WS;
      mbar_wait(rings.wempty + 8 * s, ((wi / WS) & 1) ^ 1);
      mbar_expect(rings.wfull + 8 * s, bytes);
      ++wi;
      return s;
    };
    // `boxes` 64 x 64 boxes of a weight matrix: columns col0 ..,
    // rows row ..
    auto weights = [&](const CUtensorMap* map, int boxes, int col0, int row) {
      const int s = next_w(boxes * kWBox);
      for (int j = 0; j < boxes; ++j)
        tma_load(rings.w + s * kWStage + j * kWBox, map, col0 + 64 * j, row,
                 rings.wfull + 8 * s);
    };
    // x's 16 x 8 tile box, channels c0 ..
    auto tile_box = [&](const TilePos& p, int c0) {
      const int s = next_x(kTileBox);
      tma_load_4d(rings.x + s * kXStage, &tile_map, c0, p.w0, p.h0, p.img,
                  rings.xfull + 8 * s);
    };
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const TilePos p = tile_pos(a, t);
      for (int kc = 0; kc < k1; ++kc) {   // conv1: the halo, W1
        const int s = next_x(kHaloBox);
        tma_load_4d(rings.x + s * kXStage, &halo_map, kc * 64, p.w0 - 1,
                    p.h0 - 1, p.img, rings.xfull + 8 * s);
        weights(&w1_map, P, 0, kc * 64);
      }
      for (int c = 0; c < 9 * P; ++c)     // conv2: W2, 64 rows a stage
        weights(&w2_map, P, 0, c * 64);
      for (int pass = 0; pass < passes; ++pass) {
        for (int kc = 0; kc < P; ++kc)    // conv3: W3
          weights(&w3_map, 2, pass * kNP, kc * 64);
        for (int kc = 0; down && kc < k1; ++kc) {   // the projection: x, Wd
          tile_box(p, kc * 64);
          weights(&wd_map, 2, pass * kNP, kc * 64);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int lane = tid % 32;
  const int warp = (tid % 128) / 32;
  uint8_t* y2p = static_cast<uint8_t*>(__cvta_shared_to_generic(y2));
  int res_phase = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const TilePos p = tile_pos(a, t);

    // ---- 1. y1 over the halo: c_mid 128 splits the columns between the
    // warpgroups, c_mid 64 the three 64-row blocks (two and one)
    if constexpr (P == 2) {
      conv1<XS, WS, 0, 3, S::kOutOnY1>(a, p, rings, k1, y1, wg);
    } else if (wg == 0) {
      conv1<XS, WS, 0, 2, S::kOutOnY1>(a, p, rings, k1, y1, 0);
    } else {
      conv1<XS, WS, 2, 1, S::kOutOnY1>(a, p, rings, k1, y1, 0);
    }
    consumer_bar();

    // ---- 2. y2 = relu(sum over taps of y1 . W2'_t + b2'): warp q of
    // warpgroup g computes tile row 4 g + q; A comes from y1 at the tap's
    // offset through ldmatrix (a tap's rows do not start on a swizzle
    // atom, so no descriptor can name them)
    {
      float acc[CM / 2];
#pragma unroll
      for (int e = 0; e < CM / 2; ++e) acc[e] = 0.0f;
      const int row = 4 * wg + warp;
      const int col = lane % 16;
      const int khalf = lane / 16;
      consume<XS, WS, 0>(
          rings, 9 * P, [](int) { return false; },
          [&](uint32_t, uint32_t ws, int c) {
            const int tap = c / P;
            const int kc = c % P;
            const int hr = (row + tap / 3) * kHaloW + col + tap % 3;
            const uint32_t base = y1 + kc * S::kY1Panel + hr * kRowBytes;
            uint32_t frag[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              ldmatrix_x4(frag[kk],
                          base + (((2 * kk + khalf) ^ (hr % 8)) << 4));
            fence_acc<CM / 2>(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs<CM>(acc, frag[kk],
                           sw128_desc(ws + kk * 16 * kRowBytes, kWBox, 1024));
            wgmma_commit();
          });
      fence_acc<CM / 2>(acc);
      float2 bias[CM / 8];
#pragma unroll
      for (int j = 0; j < CM / 8; ++j)
        bias[j] = *reinterpret_cast<const float2*>(a.b2 + j * 8 +
                                                   (lane % 4) * 2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = wg * 64 + warp * 16 + lane / 4 + half * 8;
#pragma unroll
        for (int j = 0; j < CM / 8; ++j) {
          const int n = j * 8 + (lane % 4) * 2;
          *reinterpret_cast<__nv_bfloat162*>(
              y2p + (n / 64) * S::kY2Panel + swizzled(m, n)) =
              __floats2bfloat162_rn(
                  fmaxf(acc[4 * j + 2 * half] + bias[j].x, 0.0f),
                  fmaxf(acc[4 * j + 2 * half + 1] + bias[j].y, 0.0f));
        }
      }
      // y2 is read next by wgmma, through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    consumer_bar();

    // ---- 3. out = relu(y2 . W3' + b3' + (x . Wd' + bd' | x)), kNP
    // columns a pass; warpgroup g takes tile rows 4 g .. 4 g + 3. Its
    // output goes through its two panels of shared memory, and thread 0
    // of the warpgroup stores them with TMA, which leaves out pixels off
    // the image; without a projection the same thread first loads x's
    // residual into those panels by TMA.
    const uint32_t out_s = y1 + S::kOut + wg * 2 * kOutPanel;
    uint8_t* out_p = static_cast<uint8_t*>(__cvta_shared_to_generic(out_s));
    const uint32_t res_bar = rings.wempty + 8 * WS + 8 * wg;
    const bool lead = tid % 128 == 0;
    for (int pass = 0; pass < passes; ++pass, ++res_phase) {
      if (lead) {
        bulk_wait<true>();   // the last pass's store has read its panels
        if (!down) {
          mbar_expect(res_bar, 2 * kOutPanel);
          for (int j = 0; j < 2; ++j)
            tma_load_4d(out_s + j * kOutPanel, &res_map,
                        pass * kNP + 64 * j, p.w0, p.h0 + 4 * wg, p.img,
                        res_bar);
        }
      }
      // the bias (+ bd) loaded before the products, so that the loads
      // overlap them (columns past c_out read column c_out - 2 and are
      // never stored)
      float2 bias[kNP / 8];
#pragma unroll
      for (int j = 0; j < kNP / 8; ++j) {
        const int n = min(pass * kNP + j * 8 + (lane % 4) * 2, a.c_out - 2);
        bias[j] = *reinterpret_cast<const float2*>(a.b3 + n);
        if (down) {
          const float2 bd = *reinterpret_cast<const float2*>(a.bd + n);
          bias[j].x += bd.x;
          bias[j].y += bd.y;
        }
      }
      float acc[kNP / 2];
#pragma unroll
      for (int e = 0; e < kNP / 2; ++e) acc[e] = 0.0f;
      consume<XS, WS, 1>(
          rings, P + (down ? k1 : 0), [](int c) { return c >= P; },
          [&](uint32_t xs, uint32_t ws, int c) {
            // y2's panel c, then the x stage's tile box
            const uint32_t a0 =
                (c < P ? y2 + c * S::kY2Panel : xs) + wg * 64 * kRowBytes;
            fence_acc<kNP / 2>(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss_n128(acc, sw128_desc(a0 + kk * 32, 16, 1024),
                            sw128_desc(ws + kk * 16 * kRowBytes, kWBox,
                                       1024));
            wgmma_commit();
          });
      fence_acc<kNP / 2>(acc);
      if (!down) {
        mbar_wait(res_bar, res_phase & 1);
      } else {
        named_bar(2 + wg);   // the lead's bulk_wait is behind everyone
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = warp * 16 + lane / 4 + half * 8;   // within the panels
        // the residual first, every load before the first store
        float2 r[kNP / 8];
#pragma unroll
        for (int j = 0; j < kNP / 8; ++j) {
          r[j] = make_float2(0.0f, 0.0f);
          if (!down)
            r[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                out_p + (j / 8) * kOutPanel + swizzled(m, j * 8 + (lane % 4) * 2)));
        }
#pragma unroll
        for (int j = 0; j < kNP / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(
              out_p + (j / 8) * kOutPanel + swizzled(m, j * 8 + (lane % 4) * 2)) =
              __floats2bfloat162_rn(
                  fmaxf(acc[4 * j + 2 * half] + bias[j].x + r[j].x, 0.0f),
                  fmaxf(acc[4 * j + 2 * half + 1] + bias[j].y + r[j].y, 0.0f));
        }
      }
      // the panels are read next by TMA, through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_bar(2 + wg);
      if (lead) {
        for (int j = 0; j < 2 && pass * kNP + 64 * j < a.c_out; ++j)
          tma_store_4d(&out_map, out_s + j * kOutPanel,
                       pass * kNP + 64 * j, p.w0, p.h0 + 4 * wg, p.img);
        bulk_commit();
      }
    }
  }
  if (tid % 128 == 0) bulk_wait<false>();
}

// The eight TMA descriptors of a call: x (B, H, W, c_in) as 64-channel
// boxes of the 18 x 10 halo and of the 16 x 8 tile, the packed weights in
// 64 x 64 boxes (wd's is w3's again without a projection), and x and out
// (B, H, W, c_out) as 64-channel boxes of 16 x 4 pixels (a warpgroup's
// residual and output).
cudaError_t wgmma_maps(const Args& a, int b, int c_mid, CUtensorMap* maps) {
  const cuuint64_t xdims[4] = {
      static_cast<cuuint64_t>(a.c_in), static_cast<cuuint64_t>(a.w),
      static_cast<cuuint64_t>(a.h), static_cast<cuuint64_t>(b)};
  const cuuint64_t xstrides[3] = {
      static_cast<cuuint64_t>(a.c_in) * 2,
      static_cast<cuuint64_t>(a.w) * a.c_in * 2,
      static_cast<cuuint64_t>(a.h) * a.w * a.c_in * 2};
  const cuuint32_t halo_box[4] = {64, kHaloW, kTileH + 2, 1};
  const cuuint32_t tile_box[4] = {64, kTileW, kTileH, 1};
  const cuuint32_t quarter_box[4] = {64, kTileW, kTileH / 2, 1};
  const cuuint64_t odims[4] = {
      static_cast<cuuint64_t>(a.c_out), static_cast<cuuint64_t>(a.w),
      static_cast<cuuint64_t>(a.h), static_cast<cuuint64_t>(b)};
  const cuuint64_t ostrides[3] = {
      static_cast<cuuint64_t>(a.c_out) * 2,
      static_cast<cuuint64_t>(a.w) * a.c_out * 2,
      static_cast<cuuint64_t>(a.h) * a.w * a.c_out * 2};
  cudaError_t err = encode_tiled(&maps[0], a.x, 4, xdims, xstrides, halo_box);
  if (err == cudaSuccess)
    err = encode_tiled(&maps[1], a.x, 4, xdims, xstrides, tile_box);
  if (err == cudaSuccess)
    err = encode_tiled(&maps[6], a.x, 4, xdims, xstrides, quarter_box);
  if (err == cudaSuccess)
    err = encode_tiled(&maps[7], a.out, 4, odims, ostrides, quarter_box);
  const void* wts[4] = {a.w1, a.w2, a.w3, a.wd != nullptr ? a.wd : a.w3};
  const int rows[4] = {a.c_in, 9 * c_mid, c_mid,
                       a.wd != nullptr ? a.c_in : c_mid};
  const int cols[4] = {c_mid, c_mid, a.c_out, a.c_out};
  const cuuint32_t wbox[2] = {64, 64};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols[i]),
                                static_cast<cuuint64_t>(rows[i])};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols[i]) * 2};
    err = encode_tiled(&maps[2 + i], wts[i], 2, dims, strides, wbox);
  }
  return err;
}

template <int CM>
cudaError_t launch_wgmma(const Args& a, int b, cudaStream_t stream) {
  constexpr int smem = WgSmem<CM>::kBytes;
  CUtensorMap maps[8];
  cudaError_t err = wgmma_maps(a, b, CM, maps);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bottleneck_wgmma_kernel<CM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return err;
  const int tiles_hw = (a.h + kTileH - 1) / kTileH * a.tiles_w;
  const WgArgs wa{static_cast<const bf16*>(a.x), a.b1, a.b2, a.b3,
                  a.wd != nullptr ? a.bd : nullptr, static_cast<bf16*>(a.out),
                  a.h, a.w, a.c_in, a.c_out, a.tiles_w, tiles_hw,
                  b * tiles_hw};
  // persistent: one block an SM walks tiles t, t + grid, ...
  const int grid = wa.tiles < sms ? wa.tiles : sms;
  bottleneck_wgmma_kernel<CM><<<grid, kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      wa);
  return cudaGetLastError();
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
  return dtype == 1 ? WgSmem<CM>::kBytes : F32Smem<CM>::kBytes;
}

template <int CM>
int launch(const Args& a, int b, int dtype, cudaStream_t stream) {
  if (dtype == 1) return static_cast<int>(launch_wgmma<CM>(a, b, stream));
  const int tiles_h = (a.h + kTileH - 1) / kTileH;
  const dim3 grid(tiles_h * a.tiles_w, b);
  const size_t bytes = smem_bytes<CM>(dtype);
  const cudaError_t err = cudaFuncSetAttribute(
      bottleneck_f32_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  bottleneck_f32_kernel<CM><<<grid, kThreads, bytes, stream>>>(a);
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
