// Batched greedy NMS keep-mask for Hopper (sm_90a).
//
// Replaces the TPU kernel mydetection_tpu/ops/pallas/nms_kernel.py
// (_nms_kernel via nms_pallas_impl, with ops/pallas/common.py
// greedy_fixpoint_keep), which the JAX package vmaps over images. Here
// one launch covers every image of the batch.
//
// Input: boxes (B, K, 4) float32 xyxy, sorted by descending score and
// already shifted by class (CLASS_OFFSET), valid (B, K) as 0/1 bytes.
// Output: keep (B, K) as 0/1 bytes. A box is kept iff it is valid and
// no kept box before it has IoU > thr with it. Greedy keep-sets are
// unique, so this equals the JAX oracle bit for bit as long as each IoU
// is the same float: each area is its own rounded product, the union
// is (area_i + area_j) - inter floored at 1e-9, and the division is
// IEEE. The build uses -fmad=false and no fast-math so nothing is
// contracted to an FMA. No pair divides: the rounded quotient
// RN(inter / u) exceeds thr exactly when the exact quotient lies above
// the midpoint m of thr and the next float up, or on it where rounding
// to even goes up (thr's last bit odd), so the bit is inter > m * u in
// double, where the product of a 25-bit m and a 24-bit u is exact (u,
// the union floored at 1e-9, is positive; inf / inf, the one NaN
// quotient, is excluded). That holds for any threshold, negative ones
// included, and makes every pair the same few instructions: the mask
// loop has no branch and keeps several pairs in flight.
//
// Design (greedy_nms.cuh): a thread block cluster of up to 16 blocks an
// image. Every block holds the image's boxes up to the last valid one
// in shared memory (a float4 and the area, 20 bytes a box) and builds its
// rows of
// the suppression bitmask, an IoU a lane and a word a ballot; the words
// go straight into block 0's shared memory over distributed shared
// memory, or, where K is too large for the packed triangle (above
// 1,696), to a global scratch that block 0 streams back in word blocks.
// One warp of block 0 then resolves the greedy order from the bitmask.
//
// Bound on an H100: about 12 FLOP a pair over the valid upper triangle,
// K^2/2 pairs at most per image — 0.2 GFLOP at B = 32, K = 1024, about
// 3 us at the 67 TFLOP/s fp32 rate; 0.56 MB of input, well under a
// microsecond at 3.35 TB/s; greedy itself consults far fewer pairs
// (chip_smoke.py::nms_bound_ms). What is left serial is the resolve, one
// warp an image walking its kept rows in order.

#include <cstdint>
#include <cuda_runtime.h>

#include "greedy_nms.cuh"

namespace {

using greedy::kFull;
using greedy::kThreads;
using greedy::kWarps;

constexpr int kBoxFloats = 5;  // x1, y1, x2, y2 (a float4) and the area

// thr as the IoU test reads it: the midpoint between thr and the next
// float up, and whether a quotient on it rounds up (thr's last bit odd)
struct Threshold {
  double mid;
  uint32_t odd;
};

__device__ __forceinline__ Threshold make_threshold(float thr) {
  const float next = nextafterf(thr, __int_as_float(0x7f800000));
  return {(static_cast<double>(thr) + static_cast<double>(next)) * 0.5,
          __float_as_uint(thr) & 1u};
}

// IoU(a, b) > thr, as 0 or 1, bit for bit as the JAX oracle's order
// rounds it: intersection and union in float32, then RN(inter / u) > thr
// decided without dividing (see the top of this file).
__device__ __forceinline__ uint32_t iou_above(float4 a, float aarea, float4 b,
                                              float barea, Threshold t) {
  const float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  const float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  const float inter = iw * ih;
  const float u = fmaxf((aarea + barea) - inter, 1e-9f);
  const double lhs = inter;
  const double rhs = t.mid * static_cast<double>(u);
  const uint32_t finite = (fabsf(inter) != __int_as_float(0x7f800000)) |
                          (u != __int_as_float(0x7f800000));
  return finite & ((lhs > rhs) | ((lhs == rhs) & t.odd));
}

template <bool kBanded>
__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float* __restrict__ boxes,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep_out, uint32_t* __restrict__ scratch,
                int k, float thr, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  const greedy::Layout l = greedy::make_layout(k, kBoxFloats, stages);
  const int n = greedy::cluster_size();
  const int rank = greedy::cluster_rank();
  const size_t img = blockIdx.x / n;
  const int n_valid = greedy::begin(valid + img * k, k, l, smem, stages);
  const uint32_t* valid_bits =
      reinterpret_cast<const uint32_t*>(smem + l.valid);

  // 32 * words boxes, so that a word's lanes never read past them (lanes
  // past the last valid box read what is there; their bits are masked)
  float4* box = reinterpret_cast<float4*>(smem + l.boxes);
  float* area = reinterpret_cast<float*>(box + 32 * l.words);
  const float4* b4 = reinterpret_cast<const float4*>(boxes) + img * k;
  for (int j = threadIdx.x; j < n_valid; j += kThreads) {
    const float4 b = b4[j];
    box[j] = b;
    area[j] = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
  }
  const Threshold t = make_threshold(thr);
  // every block of the cluster has started (block 0 takes stores into its
  // shared memory from here on) and this block's boxes are in
  hopper::cluster_arrive();
  hopper::cluster_wait();

  // 1. the mask: row i (valid) in block i % n, warp (i / n) % kWarps;
  //    bit c of word w: box 32w + c (valid, later) has IoU > thr with i
  const int lane = threadIdx.x & 31;
  const int last = (n_valid - 1) >> 5;  // the last word with a valid box
  uint32_t* mask =
      kBanded ? scratch + img * greedy::block_offset(l.words, l.words)
              : reinterpret_cast<uint32_t*>(smem + l.mask);
  for (int i = rank + n * (threadIdx.x >> 5); i < n_valid; i += n * kWarps) {
    if (!greedy::bit(valid_bits, i)) continue;
    const int q = i >> 5;
    uint32_t* row = greedy::row_start(mask, i, l.words);
    const float4 a = box[i];
    const float aarea = area[i];
    for (int w0 = q; w0 <= last; w0 += 32) {
      const int nw = min(32, last - w0 + 1);
      uint32_t mine = 0u;  // lane u keeps word w0 + u
#pragma unroll 4
      for (int u = 0; u < nw; ++u) {
        const int j = (w0 + u) * 32 + lane;
        const uint32_t hit = static_cast<uint32_t>(j > i) &
                             (valid_bits[w0 + u] >> lane) &
                             iou_above(a, aarea, box[j], area[j], t);
        const uint32_t word = __ballot_sync(kFull, hit);
        mine = lane == u ? word : mine;
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
size_t nms_keep_layout_bytes(int k, int stages) {
  return greedy::make_layout(k, kBoxFloats, stages).total;
}

// boxes (B, K, 4) float32, 16-byte aligned; valid and keep (B, K) bytes;
// scratch (B, packed triangle words) uint32 where stages > 0, else unused;
// the plan (cluster, stages, smem) from kernels/nms.py::nms_plan. Launches
// on `stream`; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a plan the layout disagrees with).
int nms_keep_launch(const float* boxes, const uint8_t* valid, uint8_t* keep,
                    uint32_t* scratch, int b, int k, float thr, int cluster,
                    int stages, int smem, void* stream) {
  if (!greedy::plan_ok(b, k, kBoxFloats, cluster, stages, smem, scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      stages == 0
          ? greedy::launch(nms_keep_kernel<false>, b, cluster, smem, s, boxes,
                           valid, keep, scratch, k, thr, stages)
          : greedy::launch(nms_keep_kernel<true>, b, cluster, smem, s, boxes,
                           valid, keep, scratch, k, thr, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
