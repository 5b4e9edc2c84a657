// Batched greedy suppress from a precomputed IoU matrix, for Hopper
// (sm_90a): the rotated-NMS keep-mask.
//
// Replaces the TPU kernel mydetection_tpu/ops/pallas/rotated_nms_kernel.py
// (_suppress_kernel via nms_from_iou_pallas_impl, with
// ops/pallas/common.py greedy_fixpoint_keep), which the JAX package runs
// once per image. Here one launch covers every image of the batch.
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
// Design (greedy_nms.cuh): a thread block cluster of up to 16 blocks an
// image, each reading a share of the rows of the matrix's upper triangle
// (a warp a row; 32 lanes read 32 consecutive floats, coalesced, 8 words
// in flight a warp, and one ballot turns them into the word's bits).
// Rows of invalid boxes, and columns past the last valid box, are never
// loaded. The words go straight into block 0's shared memory over
// distributed shared memory (the packed triangle is 17 KB at K = 512),
// or, above K = 1,856, to a global scratch that block 0 streams back in
// word blocks. One warp of block 0 then resolves the greedy order.
//
// Bound on an H100: bytes. The full matrix is B*K*K*4 bytes, 33.6 MB at
// B = 32, K = 512 (10 us at 3.35 TB/s); the upper triangle of the valid
// rows, which is all this kernel reads, is about half, spread over the
// B clusters' SMs. The compares are at most 8.4e6 (0.13 us at the fp32
// rate). Greedy itself consults far fewer entries
// (chip_smoke.py::rotated_nms_bound_ms).

#include <cstdint>
#include <cuda_runtime.h>

#include "greedy_nms.cuh"

namespace {

using greedy::kFull;
using greedy::kThreads;
using greedy::kWarps;

constexpr int kUnroll = 8;  // bitmask words a warp has in flight

template <bool kBanded>
__global__ void __launch_bounds__(kThreads)
nms_from_iou_kernel(const float* __restrict__ iou,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep_out,
                    uint32_t* __restrict__ scratch, int k, float thr,
                    int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  const greedy::Layout l = greedy::make_layout(k, 0, stages);
  const int n = greedy::cluster_size();
  const int rank = greedy::cluster_rank();
  const size_t img = blockIdx.x / n;
  const int n_valid = greedy::begin(valid + img * k, k, l, smem, stages);
  const uint32_t* valid_bits =
      reinterpret_cast<const uint32_t*>(smem + l.valid);
  // every block of the cluster has started: block 0 takes stores into its
  // shared memory from here on
  hopper::cluster_arrive();
  hopper::cluster_wait();

  // 1. the mask: row i (valid) in block i % n, warp (i / n) % kWarps;
  //    bit c of word w: iou[i][32w + c] > thr, 32w + c > i
  const float* m = iou + img * static_cast<size_t>(k) * k;
  const int lane = threadIdx.x & 31;
  const int last = (n_valid - 1) >> 5;  // the last word with a valid box
  uint32_t* mask =
      kBanded ? scratch + img * greedy::block_offset(l.words, l.words)
              : reinterpret_cast<uint32_t*>(smem + l.mask);
  for (int i = rank + n * (threadIdx.x >> 5); i < n_valid; i += n * kWarps) {
    if (!greedy::bit(valid_bits, i)) continue;
    const int q = i >> 5;
    uint32_t* row = greedy::row_start(mask, i, l.words);
    const float* src = m + static_cast<size_t>(i) * k;
    for (int w0 = q; w0 <= last; w0 += 32) {
      const int nw = min(32, last - w0 + 1);
      uint32_t mine = 0u;  // lane u keeps word w0 + u
      for (int u0 = 0; u0 < nw; u0 += kUnroll) {
        float x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = (w0 + u0 + u) * 32 + lane;
          x[u] = u0 + u < nw && j < n_valid ? __ldg(src + j) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = (w0 + u0 + u) * 32 + lane;
          const uint32_t word = __ballot_sync(
              kFull, u0 + u < nw && j > i && j < n_valid && x[u] > thr);
          if (lane == u0 + u) mine = word;
        }
      }
      if (lane < nw) greedy::store_word<kBanded>(row, w0 - q + lane, mine);
    }
  }
  // 2. block 0 resolves and writes the keep bytes
  if (!greedy::mask_done<kBanded>()) return;
  greedy::resolve_and_write<kBanded>(smem, l, scratch, stages, k, n_valid,
                                     img, keep_out);
}

}  // namespace

extern "C" {

// Dynamic shared memory a block takes for K boxes; stages 0: the mask on
// chip, else the banded resolve's ring stages (kernels/nms.py::smem_bytes
// computes the same).
size_t rotated_nms_layout_bytes(int k, int stages) {
  return greedy::make_layout(k, 0, stages).total;
}

// iou (B, K, K) float32; valid and keep (B, K) bytes; scratch (B, packed
// triangle words) uint32 where stages > 0, else unused; the plan
// (cluster, stages, smem) from kernels/nms.py::nms_plan. Launches on
// `stream`; returns the cudaError_t of the launch (cudaErrorInvalidValue
// for a plan the layout disagrees with).
int nms_from_iou_keep_launch(const float* iou, const uint8_t* valid,
                             uint8_t* keep, uint32_t* scratch, int b, int k,
                             float thr, int cluster, int stages, int smem,
                             void* stream) {
  if (!greedy::plan_ok(b, k, 0, cluster, stages, smem, scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      stages == 0
          ? greedy::launch(nms_from_iou_kernel<false>, b, cluster, smem, s,
                           iou, valid, keep, scratch, k, thr, stages)
          : greedy::launch(nms_from_iou_kernel<true>, b, cluster, smem, s,
                           iou, valid, keep, scratch, k, thr, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* rotated_nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
