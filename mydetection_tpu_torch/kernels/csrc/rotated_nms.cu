// Batched greedy suppress from a precomputed IoU matrix, for Hopper
// (sm_90a): the rotated-NMS keep-mask.
//
// Replaces the TPU kernel mydetection_tpu/ops/pallas/rotated_nms_kernel.py
// (_suppress_kernel via nms_from_iou_pallas_impl, with
// ops/pallas/common.py greedy_fixpoint_keep), which the JAX package runs
// once per image. Here one launch covers every image of the batch: one
// CUDA block per image.
//
// Input: iou (B, K, K) float32, row-major, rows and columns in
// descending score order; valid (B, K) as 0/1 bytes. Output: keep
// (B, K) as 0/1 bytes. Box j is kept iff it is valid and no kept box
// i < j has iou[i][j] > thr. The matrix is read as iou[earlier][later]
// only: a float32 rotated-IoU matrix need not be symmetric, and the
// oracle suppresses column j by row i < j. The kernel's only arithmetic
// is that strict float32 compare, so its keep-set is the oracle's bit
// for bit (greedy keep-sets are unique; NaN never suppresses).
//
// The TPU kernel's one-hot MXU contractions and fixpoint loop exist
// only because Mosaic has no dynamic slice; none of it carries over.
//
// Design: the block holds its image's suppression bitmask in shared
// memory, K rows of ceil(K/32) words (32 KB at K = 512):
//   1. each warp takes rows i; 32 lanes read 32 consecutive floats of
//      row i (coalesced, 8 words in flight a warp) and one ballot turns
//      them into the word's bits (iou > thr and column > i). Rows of
//      invalid boxes are never kept and the words left of the diagonal
//      are never read, so neither is loaded;
//   2. one warp resolves the greedy order a word (32 rows) at a time:
//      the word's alive rows are resolved in order against their own
//      word, then its kept rows are ORed into the removed bits of every
//      later word, one lane a word;
//   3. the keep bits are written out as bytes.
//
// Bound on an H100: bytes. The full matrix is B*K*K*4 bytes, 33.6 MB at
// B = 32, K = 512 (10 us at 3.35 TB/s); the upper triangle of the valid
// rows, which is all this kernel reads, is about half. The compares are
// at most 8.4e6 (0.13 us at the fp32 rate). B = 32 blocks fill 32 of the
// 132 SMs, and the one-warp resolve (K steps in 32-row words) is
// sequential: several blocks per image and a warp-parallel resolve are
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // bitmask words a warp has in flight

__global__ void __launch_bounds__(kThreads)
nms_from_iou_kernel(const float* __restrict__ iou,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep_out, int k, int words,
                    float thr) {
  extern __shared__ uint32_t smem[];
  uint32_t* mask = smem;                                  // k * words
  uint32_t* valid_bits = mask + static_cast<size_t>(k) * words;
  uint32_t* removed = valid_bits + words;
  uint32_t* kept = removed + words;

  const size_t img = blockIdx.x;
  const float* m = iou + img * static_cast<size_t>(k) * k;
  const uint8_t* v = valid + img * k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int w = warp; w < words; w += kWarps) {
    const int j = w * 32 + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, j < k && v[j] != 0);
    if (lane == 0) {
      valid_bits[w] = bits;
      removed[w] = 0u;
    }
  }
  __syncthreads();

  // 1. bit c of mask[i * words + w]: iou[i][32w + c] > thr, 32w + c > i
  for (int i = warp; i < k; i += kWarps) {
    if (!((valid_bits[i >> 5] >> (i & 31)) & 1u)) continue;
    const float* row = m + static_cast<size_t>(i) * k;
    uint32_t* out = mask + static_cast<size_t>(i) * words;
    for (int w0 = i >> 5; w0 < words; w0 += kUnroll) {
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = (w0 + u) * 32 + lane;
        x[u] = j < k ? __ldg(row + j) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = (w0 + u) * 32 + lane;
        const uint32_t bits =
            __ballot_sync(0xffffffffu, j > i && j < k && x[u] > thr);
        if (lane == 0 && w0 + u < words) out[w0 + u] = bits;
      }
    }
  }
  __syncthreads();

  // 2. greedy resolve, one warp, a word of 32 rows at a time
  if (warp == 0) {
    for (int wb = 0; wb < words; ++wb) {
      uint32_t alive = valid_bits[wb] & ~removed[wb];
      uint32_t kb = 0u;
      uint32_t scan = alive;
      while (scan) {
        const int c = __ffs(scan) - 1;
        kb |= 1u << c;
        alive &= ~mask[static_cast<size_t>(wb * 32 + c) * words + wb];
        scan = alive & ~((2u << c) - 1u);  // alive rows after c
      }
      for (int w = wb + 1 + lane; w < words; w += 32) {
        uint32_t acc = removed[w];
        uint32_t bits = kb;
        while (bits) {
          const int c = __ffs(bits) - 1;
          bits &= bits - 1u;
          acc |= mask[static_cast<size_t>(wb * 32 + c) * words + w];
        }
        removed[w] = acc;
      }
      if (lane == 0) kept[wb] = kb;
      __syncwarp();
    }
  }
  __syncthreads();

  // 3. keep bits out as bytes
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    keep_out[img * k + j] = (kept[j >> 5] >> (j & 31)) & 1u;
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for K boxes: the K x ceil(K/32)
// bitmask and three words a 32 boxes (valid, removed, kept bits).
size_t rotated_nms_smem_bytes(int k) {
  const size_t words = (static_cast<size_t>(k) + 31) / 32;
  return (static_cast<size_t>(k) + 3) * words * sizeof(uint32_t);
}

// Launches on `stream`; returns the cudaError_t of the launch.
int nms_from_iou_keep_launch(const float* iou, const uint8_t* valid,
                             uint8_t* keep, int b, int k, float thr,
                             void* stream) {
  const size_t smem = rotated_nms_smem_bytes(k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_from_iou_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_from_iou_kernel<<<b, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      iou, valid, keep, k, (k + 31) / 32, thr);
  return static_cast<int>(cudaGetLastError());
}

const char* rotated_nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
