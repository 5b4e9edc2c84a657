// Batched greedy NMS keep-mask for Hopper (sm_90a).
//
// Replaces the TPU kernel mydetection_tpu/ops/pallas/nms_kernel.py
// (_nms_kernel via nms_pallas_impl, with ops/pallas/common.py
// greedy_fixpoint_keep), which the JAX package vmaps over images. Here
// one launch covers every image of the batch: one CUDA block per image.
//
// Input: boxes (B, K, 4) float32 xyxy, sorted by descending score and
// already shifted by class (CLASS_OFFSET), valid (B, K) as 0/1 bytes.
// Output: keep (B, K) as 0/1 bytes. A box is kept iff it is valid and
// no kept box before it has IoU > thr with it. Greedy keep-sets are
// unique, so this equals the JAX oracle bit for bit as long as each IoU
// is the same float: each area is its own rounded product, the union
// is (area_i + area_j) - inter floored at 1e-9, and the division is
// IEEE. The build uses -fmad=false and no fast-math so nothing is
// contracted to an FMA and the division stays correctly rounded.
//
// Design: the block holds its image's boxes, areas and keep flags in
// shared memory (21 bytes a box; K = 1024 is 21 KB) and walks them in
// tiles of 128 in score order:
//   1. the tile's (128 x 128) suppression bitmask, rows of boxes still
//      kept, in parallel;
//   2. one thread resolves the tile's greedy order from the bitmask;
//   3. every later box still kept is tested, in parallel, against the
//      tile's kept boxes and dropped on the first IoU > thr.
//
// Bound on an H100: about 12 FLOP a pair over K^2/2 pairs per image —
// 0.2 GFLOP at B = 32, K = 1024, about 3 us at the 67 TFLOP/s fp32 rate;
// 0.56 MB of input, well under a microsecond at 3.35 TB/s. In practice
// the sequential resolve (K steps on one thread per image) and the
// per-tile barriers bound it, and B = 32 blocks fill 32 of 132 SMs.
// Making it fast (bitmask tiles for all pairs, warp ballots, several
// blocks per image) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;            // boxes resolved together
constexpr int kWords = kTile / 32;    // bitmask words per tile row
constexpr int kThreads = 1024;

struct Boxes {
  const float* x1;
  const float* y1;
  const float* x2;
  const float* y2;
  const float* area;
};

// IoU(i, j) > thr, evaluated in the JAX oracle's order.
__device__ __forceinline__ bool iou_above(const Boxes& s, int i, int j,
                                          float thr) {
  const float iw = fmaxf(fminf(s.x2[i], s.x2[j]) - fmaxf(s.x1[i], s.x1[j]),
                         0.0f);
  const float ih = fmaxf(fminf(s.y2[i], s.y2[j]) - fmaxf(s.y1[i], s.y1[j]),
                         0.0f);
  const float inter = iw * ih;
  const float uni = (s.area[i] + s.area[j]) - inter;
  return inter / fmaxf(uni, 1e-9f) > thr;
}

// True when a kept box of the tile at `start` suppresses box j.
__device__ __forceinline__ bool suppressed_by_tile(
    const Boxes& s, const uint32_t* tile_keep, int start, int j, float thr) {
  for (int w = 0; w < kWords; ++w) {
    uint32_t bits = tile_keep[w];
    while (bits) {
      const int c = __ffs(bits) - 1;
      bits &= bits - 1;
      if (iou_above(s, start + w * 32 + c, j, thr)) return true;
    }
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float* __restrict__ boxes,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep_out, int k, float thr) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + k;
  float* x2 = y1 + k;
  float* y2 = x2 + k;
  float* area = y2 + k;
  uint32_t* sup = reinterpret_cast<uint32_t*>(area + k);  // kTile*kWords
  uint8_t* keep = reinterpret_cast<uint8_t*>(sup + kTile * kWords);
  __shared__ uint32_t tile_keep[kWords];

  const size_t img = blockIdx.x;
  const float* b = boxes + img * k * 4;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    x1[j] = b[4 * j];
    y1[j] = b[4 * j + 1];
    x2[j] = b[4 * j + 2];
    y2[j] = b[4 * j + 3];
    const float w = fmaxf(x2[j] - x1[j], 0.0f);
    const float h = fmaxf(y2[j] - y1[j], 0.0f);
    area[j] = w * h;
    keep[j] = valid[img * k + j] != 0;
  }
  __syncthreads();
  const Boxes s{x1, y1, x2, y2, area};

  for (int start = 0; start < k; start += kTile) {
    const int n = min(kTile, k - start);
    // 1. bit c of sup[r * kWords + w]: box start+r, still kept, has
    //    IoU > thr with the later box start + 32w + c of the tile
    for (int e = threadIdx.x; e < kTile * kWords; e += blockDim.x) {
      const int r = e / kWords;
      const int w = e % kWords;
      uint32_t bits = 0;
      if (r < n && keep[start + r]) {
        for (int c = 0; c < 32; ++c) {
          const int col = w * 32 + c;
          if (col > r && col < n &&
              iou_above(s, start + r, start + col, thr)) {
            bits |= 1u << c;
          }
        }
      }
      sup[e] = bits;
    }
    __syncthreads();
    // 2. greedy order inside the tile
    if (threadIdx.x == 0) {
      uint32_t alive[kWords] = {0u, 0u, 0u, 0u};
      for (int r = 0; r < n; ++r) {
        if (keep[start + r]) alive[r >> 5] |= 1u << (r & 31);
      }
      for (int r = 0; r < n; ++r) {
        if ((alive[r >> 5] >> (r & 31)) & 1u) {
          for (int w = 0; w < kWords; ++w) alive[w] &= ~sup[r * kWords + w];
        }
      }
      for (int r = 0; r < n; ++r) {
        keep[start + r] = (alive[r >> 5] >> (r & 31)) & 1u;
      }
      for (int w = 0; w < kWords; ++w) tile_keep[w] = alive[w];
    }
    __syncthreads();
    // 3. the tile's kept boxes suppress every later box
    for (int j = start + n + threadIdx.x; j < k; j += blockDim.x) {
      if (keep[j] && suppressed_by_tile(s, tile_keep, start, j, thr)) {
        keep[j] = 0;
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    keep_out[img * k + j] = keep[j];
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for K boxes.
size_t nms_keep_smem_bytes(int k) {
  return static_cast<size_t>(k) * (5 * sizeof(float) + 1) +
         kTile * kWords * sizeof(uint32_t);
}

// Launches on `stream`; returns the cudaError_t of the launch.
int nms_keep_launch(const float* boxes, const uint8_t* valid,
                    uint8_t* keep, int b, int k, float thr, void* stream) {
  const size_t smem = nms_keep_smem_bytes(k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_keep_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      boxes, valid, keep, k, thr);
  return static_cast<int>(cudaGetLastError());
}

const char* nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
