// Fused bias + GroupNorm + ReLU for Hopper (sm_90a).
//
// Replaces the TPU kernel mydetection_tpu/ops/pallas/gn_kernel.py
// (_gn_kernel via bias_gn_relu_pallas_impl), which FCOS runs after each
// of the 8 tower convs on each of the 5 pyramid levels.
//
//   xf   = float(x) + bias[c]                         (float32 bias add)
//   mean = E[xf], var = max(E[xf^2] - mean^2, 0)      per (image, group)
//   y    = max(((xf - mean) * (1 / sqrt(var + eps))) * scale[c] + shift[c], 0)
//
// stored in x's type (float32 or bfloat16, round to nearest even). The
// sums are float32 and the statistics use the same E[x^2] - E[x]^2 form
// as the TPU kernel. The build uses -fmad=false and no fast-math, so
// nothing is contracted to an FMA and sqrt and the division are IEEE:
// only the order of the sums differs from the plain version.
//
// Layout: x is (B, H, W, C) in memory (PyTorch's channels_last for the
// NCHW tensor the convs emit), C = groups * cpg; out has the same
// layout. Each group's cpg channels of one pixel lie side by side.
//
// Design: one block per (image, group), B * groups blocks in one
// launch (1024 at batch 32). The block walks its H*W pixels twice:
// pass 1 sums xf and xf^2 (each thread a strided share, then a warp
// shuffle and shared-memory reduction), pass 2 normalizes and writes.
// Each thread takes one 16-byte vector of the group's channels at a
// time when the group's bytes are a multiple of 16 (cpg = 8 in bf16, a
// multiple of 4 in f32), else one element. The second read of a block's
// slab (92 KB at P3 of a 608 input in bf16) hits L2 only when little else
// ran in between.
//
// Bound on an H100: bytes. About 8 float32 operations per element
// against 4 bytes moved in bf16 (2 read, 2 written), far below the 20
// operations a byte at which the fp32 rate would bind. Known costs of
// this simple design: with 8 bf16 channels per group, a 32-byte sector
// holds two groups, so each block reads sectors half of whose bytes
// belong to its neighbour; at batch 1 it fills only 32 blocks; and
// pass 2 rereads x. Staging the slab in shared memory, several blocks
// per (image, group) and a cluster reduction are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements of type T, moved as one 16-byte access when V > 1.
template <typename T, int V>
struct alignas(V > 1 ? 16 : sizeof(T)) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bias_gn_relu_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, T* __restrict__ out,
                    int hw, int c, int groups, float eps) {
  extern __shared__ float params[];  // bias, scale, shift: cpg each
  __shared__ float red_sum[kWarps];
  __shared__ float red_sq[kWarps];
  __shared__ float stats[2];

  const int cpg = c / groups;
  const int img = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
  const int chunks = cpg / V;      // vectors per pixel and group
  const int items = hw * chunks;
  const size_t base = static_cast<size_t>(img) * hw * c +
                      static_cast<size_t>(g) * cpg;

  float* p_bias = params;
  float* p_scale = params + cpg;
  float* p_shift = params + 2 * cpg;
  for (int j = threadIdx.x; j < cpg; j += kThreads) {
    p_bias[j] = bias[g * cpg + j];
    p_scale[j] = scale[g * cpg + j];
    p_shift[j] = shift[g * cpg + j];
  }
  __syncthreads();

  // pass 1: float32 sums of xf and xf^2
  float sum = 0.0f;
  float sq = 0.0f;
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int p = i / chunks;
    const int q = (i - p * chunks) * V;
    const size_t at = base + static_cast<size_t>(p) * c + q;
    const Vec<T, V> in = *reinterpret_cast<const Vec<T, V>*>(x + at);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = to_f32(in.v[k]) + p_bias[q + k];
      sum += v;
      sq += v * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    red_sum[warp] = sum;
    red_sq[warp] = sq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    float s2 = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      s += red_sum[w];
      s2 += red_sq[w];
    }
    const float n = static_cast<float>(hw) * static_cast<float>(cpg);
    const float mean = s / n;
    const float var = fmaxf(s2 / n - mean * mean, 0.0f);
    stats[0] = mean;
    stats[1] = 1.0f / sqrtf(var + eps);
  }
  __syncthreads();
  const float mean = stats[0];
  const float inv = stats[1];

  // pass 2: normalize, affine, ReLU, store in T
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int p = i / chunks;
    const int q = (i - p * chunks) * V;
    const size_t at = base + static_cast<size_t>(p) * c + q;
    const Vec<T, V> in = *reinterpret_cast<const Vec<T, V>*>(x + at);
    Vec<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = to_f32(in.v[k]) + p_bias[q + k];
      const float y = ((v - mean) * inv) * p_scale[q + k] + p_shift[q + k];
      o.v[k] = from_f32<T>(fmaxf(y, 0.0f));
    }
    *reinterpret_cast<Vec<T, V>*>(out + at) = o;
  }
}

template <typename T>
int launch(const void* x, const float* bias, const float* scale,
           const float* shift, void* out, int b, int hw, int c, int groups,
           float eps, bool vectorized, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int cpg = c / groups;
  const size_t smem = 3 * cpg * sizeof(float);
  const dim3 grid(b * groups);
  if (vectorized) {
    bias_gn_relu_kernel<T, kVec><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), bias, scale, shift, static_cast<T*>(out),
        hw, c, groups, eps);
  } else {
    bias_gn_relu_kernel<T, 1><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), bias, scale, shift, static_cast<T*>(out),
        hw, c, groups, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vectorized: the caller has checked
// that x and out are 16-byte aligned and that cpg and C are multiples
// of 16 / sizeof(element). Launches on `stream`; returns the
// cudaError_t of the launch.
int bias_gn_relu_launch(const void* x, const float* bias, const float* scale,
                        const float* shift, void* out, int b, int hw, int c,
                        int groups, float eps, int dtype, int vectorized,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, bias, scale, shift, out, b, hw, c, groups, eps,
                         vectorized != 0, s);
  }
  return launch<__nv_bfloat16>(x, bias, scale, shift, out, b, hw, c, groups,
                               eps, vectorized != 0, s);
}

const char* gn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
