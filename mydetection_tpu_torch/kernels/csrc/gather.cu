// Batched row gather for Hopper (sm_90a): out[b, k, :] = src[b, sel[b, k], :].
//
// Replaces the TPU kernel benchmarks/gather_experiments.py _kernel
// (gather_rows_sorted), written for the multi-label postprocess: after
// the stage-1 top-k it gathers the selected boxes' class rows, (B, K,
// C) out of the dense (B, N, C) head output (N = 69,354 anchors, C = 80
// classes, K = 1024 at RetinaNet-608).
//
// The TPU kernel needs `sel` sorted: it streams the source in strips
// and copies each strip's selected rows, and bit-packs bf16 pairs into
// int32; both are Mosaic layout devices. A GPU reads a 160-byte row
// wherever it lies, so this kernel takes any order, duplicates
// included: one warp per output row, each lane copying 16-byte vectors
// when every row is 16-byte aligned (C times the element size a
// multiple of 16, both bases aligned), else one element at a time. It
// copies bits, so it equals torch.gather exactly. It does not check
// sel < N: the caller's indices come from a top-k over N.
//
// Bound on an H100: bytes. Each output row is read once and written
// once: 2 * 32 * 1024 * 80 * 2 bytes at batch 32 in bf16, about 3 us
// at 3.35 TB/s. At that size the launch itself is most of the time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// E: the unit copied (uint4 for 16-byte vectors, else the element's
// own width); I: the index type.
template <typename E, typename I>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const E* __restrict__ src, const I* __restrict__ sel,
                   E* __restrict__ out, int rows, int n, int k, int units,
                   int64_t sel_stride) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int b = row / k;
  const int64_t idx = static_cast<int64_t>(sel[b * sel_stride + row % k]);
  const E* s = src + (static_cast<int64_t>(b) * n + idx) * units;
  E* o = out + static_cast<int64_t>(row) * units;
  for (int e = lane; e < units; e += 32) o[e] = s[e];
}

template <typename E>
int launch_idx(const void* src, const void* sel, void* out, int b, int n,
               int k, int units, int64_t sel_stride, int index_bytes,
               cudaStream_t stream) {
  const int rows = b * k;
  const dim3 grid((rows + kWarps - 1) / kWarps);
  if (index_bytes == 8) {
    gather_rows_kernel<E, int64_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const E*>(src), static_cast<const int64_t*>(sel),
        static_cast<E*>(out), rows, n, k, units, sel_stride);
  } else {
    gather_rows_kernel<E, int32_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const E*>(src), static_cast<const int32_t*>(sel),
        static_cast<E*>(out), rows, n, k, units, sel_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// src (B, N, C) and out (B, K, C) contiguous with elements of
// `elem_bytes` (2 or 4); sel (B, K) int64 or int32 (`index_bytes` 8 or
// 4) with row stride `sel_stride` elements. vectorized: the caller has
// checked that C * elem_bytes is a multiple of 16 and both bases are
// 16-byte aligned. Launches on `stream`; returns the cudaError_t.
int gather_rows_launch(const void* src, const void* sel, void* out, int b,
                       int n, int k, int c, int64_t sel_stride,
                       int elem_bytes, int index_bytes, int vectorized,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vectorized) {
    return launch_idx<uint4>(src, sel, out, b, n, k, c * elem_bytes / 16,
                             sel_stride, index_bytes, s);
  }
  if (elem_bytes == 2) {
    return launch_idx<uint16_t>(src, sel, out, b, n, k, c, sel_stride,
                                index_bytes, s);
  }
  return launch_idx<uint32_t>(src, sel, out, b, n, k, c, sel_stride,
                              index_bytes, s);
}

const char* gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
