// Fused bias + GroupNorm + ReLU for Hopper (sm_90a): forward, forward
// with the saved statistics, and the fused backward.
//
// Replaces the TPU kernels of mydetection_tpu/ops/pallas/gn_kernel.py:
//   bias_gn_relu_kernel<T, V, false>  _gn_kernel (bias_gn_relu_pallas_impl),
//                                     which FCOS runs after each of the 8
//                                     tower convs on each of the 5 levels;
//   bias_gn_relu_kernel<T, V, true>   _gn_fwd_stats_kernel (_fwd_with_stats),
//                                     the same forward under autograd,
//                                     which also writes mean and inv;
//   gn_bwd_kernel + sum_images_kernel _gn_bwd_kernel (_bwd_fused), its
//                                     backward.
//
// Forward:
//   xf   = float(x) + bias[c]                         (float32 bias add)
//   mean = E[xf], var = max(E[xf^2] - mean^2, 0)      per (image, group)
//   inv  = 1 / sqrt(var + eps)
//   y    = max(((xf - mean) * inv) * scale[c] + shift[c], 0)
// stored in x's type (float32 or bfloat16, round to nearest even). The
// sums are float32 and the statistics use the same E[x^2] - E[x]^2 form
// as the TPU kernel.
//
// Backward (gn_kernel.py _gn_bwd_kernel), per (image, group) of n
// elements, with xhat = (xf - mean) * inv:
//   dpre   = dy if y > 0 else 0      (the ReLU mask from the saved y)
//   dxhat  = dpre * scale[c]
//   m1     = sum(dxhat) / n, m2 = sum(dxhat * xhat) / n
//   dx     = inv * ((dxhat - m1) - xhat * m2)             stored in T
//   dbias  = sum(dx), dscale = sum(dpre * xhat), dshift = sum(dpre)
// the last three per channel over every pixel of every image, float32.
//
// The build uses -fmad=false and no fast-math, so nothing is contracted
// to an FMA and sqrt and the division are IEEE: only the order of the
// sums differs from the plain versions in kernels/gn.py.
//
// Layout: x, y, dy, dx are (B, H, W, C) in memory (PyTorch's
// channels_last for the NCHW tensors the convs emit), C = groups * cpg.
// Each group's cpg channels of one pixel lie side by side.
//
// Design: one block per (image, group), B * groups blocks in one launch
// (512 at batch 16). Each walks its H*W pixels twice. Forward: pass 1
// sums xf and xf^2, pass 2 normalizes and writes. Backward: pass 1 sums
// dxhat and dxhat * xhat, pass 2 writes dx and keeps per-channel sums of
// dx, dpre * xhat and dpre in registers. A thread takes one 16-byte
// vector of the group's channels at a time when the group's bytes are a
// multiple of 16 (cpg = 8 in bf16, a multiple of 4 in f32), else one
// element. In the backward a thread keeps the same channels for the
// whole walk, so its per-channel sums are its own; the block adds them
// in shared memory in thread order and writes one (image, channel)
// partial, and sum_images_kernel adds the partials over the images in
// image order, as the TPU kernel's sequential grid does. No atomics:
// two runs give the same bits.
//
// Bound on an H100: bytes. About 9 float32 operations per element in
// the forward and about 16 in the backward (each element's work counted
// once; pass 2 recomputes about 6 of them), against 4 bytes (forward: x
// read, y written) and 8 bytes (backward: x, y, dy read, dx written)
// moved per element in bf16; the fp32 rate would bind at 20 operations
// a byte. Known costs of this simple design: with 8 bf16 channels per
// group, a 32-byte sector holds two groups, so each block reads sectors
// half of whose bytes belong to its neighbour; pass 2 rereads what pass
// 1 read (the backward three slabs); at batch 1 it fills only 32
// blocks. Staging the slab in shared memory, several blocks per
// (image, group) and a cluster reduction are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSumThreads = 256;

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

// Sums a and b over the block in a fixed order (warp shuffles, then
// thread 0 over the warps); the results are valid in thread 0 only.
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float* red_a, float* red_b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    red_a[warp] = a;
    red_b[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0.0f;
    b = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      a += red_a[w];
      b += red_b[w];
    }
  }
}

template <typename T, int V, bool kStats>
__global__ void __launch_bounds__(kThreads)
bias_gn_relu_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, T* __restrict__ out,
                    float* __restrict__ mean_out, float* __restrict__ inv_out,
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
  block_sum2(sum, sq, red_sum, red_sq);
  if (threadIdx.x == 0) {
    const float n = static_cast<float>(hw) * static_cast<float>(cpg);
    const float mean = sum / n;
    const float var = fmaxf(sq / n - mean * mean, 0.0f);
    stats[0] = mean;
    stats[1] = 1.0f / sqrtf(var + eps);
    if (kStats) {
      mean_out[blockIdx.x] = stats[0];
      inv_out[blockIdx.x] = stats[1];
    }
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

// One block per (image, group). Thread t keeps the vector of channels
// q = (t % chunks) * V for the whole walk and takes the pixels
// t / chunks, t / chunks + lanes, ...; the threads from lanes * chunks
// on idle. part is (3, B, C): the block's sums of dx, dpre * xhat and
// dpre for each of its channels.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
              const T* __restrict__ dy, const float* __restrict__ bias,
              const float* __restrict__ scale,
              const float* __restrict__ mean_g,
              const float* __restrict__ inv_g, T* __restrict__ dx,
              float* __restrict__ part, int hw, int c, int groups) {
  extern __shared__ float params[];  // bias, scale: cpg each
  __shared__ float red_s1[kWarps];
  __shared__ float red_s2[kWarps];
  __shared__ float coef[2];
  __shared__ float chan[3][V][kThreads];

  const int cpg = c / groups;
  const int b = gridDim.x / groups;
  const int img = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
  const int chunks = cpg / V;
  const int lanes = kThreads / chunks;
  const int active = lanes * chunks;
  const bool on = threadIdx.x < active;
  const int q = (threadIdx.x % chunks) * V;
  const int p0 = threadIdx.x / chunks;
  const size_t base = static_cast<size_t>(img) * hw * c +
                      static_cast<size_t>(g) * cpg;

  float* p_bias = params;
  float* p_scale = params + cpg;
  for (int j = threadIdx.x; j < cpg; j += kThreads) {
    p_bias[j] = bias[g * cpg + j];
    p_scale[j] = scale[g * cpg + j];
  }
  __syncthreads();
  const float mean = mean_g[blockIdx.x];
  const float inv = inv_g[blockIdx.x];

  // pass 1: float32 sums of dxhat and dxhat * xhat
  float s1 = 0.0f;
  float s2 = 0.0f;
  for (int p = on ? p0 : hw; p < hw; p += lanes) {
    const size_t at = base + static_cast<size_t>(p) * c + q;
    const Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(x + at);
    const Vec<T, V> yv = *reinterpret_cast<const Vec<T, V>*>(y + at);
    const Vec<T, V> dv = *reinterpret_cast<const Vec<T, V>*>(dy + at);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xhat = ((to_f32(xv.v[k]) + p_bias[q + k]) - mean) * inv;
      const float dpre = to_f32(yv.v[k]) > 0.0f ? to_f32(dv.v[k]) : 0.0f;
      const float dxhat = dpre * p_scale[q + k];
      s1 += dxhat;
      s2 += dxhat * xhat;
    }
  }
  block_sum2(s1, s2, red_s1, red_s2);
  if (threadIdx.x == 0) {
    const float n = static_cast<float>(hw) * static_cast<float>(cpg);
    coef[0] = s1 / n;
    coef[1] = s2 / n;
  }
  __syncthreads();
  const float m1 = coef[0];
  const float m2 = coef[1];

  // pass 2: dx, and this thread's per-channel sums
  float s_dx[V], s_dscale[V], s_dshift[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s_dx[k] = 0.0f;
    s_dscale[k] = 0.0f;
    s_dshift[k] = 0.0f;
  }
  for (int p = on ? p0 : hw; p < hw; p += lanes) {
    const size_t at = base + static_cast<size_t>(p) * c + q;
    const Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(x + at);
    const Vec<T, V> yv = *reinterpret_cast<const Vec<T, V>*>(y + at);
    const Vec<T, V> dv = *reinterpret_cast<const Vec<T, V>*>(dy + at);
    Vec<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xhat = ((to_f32(xv.v[k]) + p_bias[q + k]) - mean) * inv;
      const float dpre = to_f32(yv.v[k]) > 0.0f ? to_f32(dv.v[k]) : 0.0f;
      const float dxhat = dpre * p_scale[q + k];
      const float d = inv * ((dxhat - m1) - xhat * m2);
      o.v[k] = from_f32<T>(d);
      s_dx[k] += d;
      s_dscale[k] += dpre * xhat;
      s_dshift[k] += dpre;
    }
    *reinterpret_cast<Vec<T, V>*>(dx + at) = o;
  }

  // per-channel sums over the block's threads, in thread order
#pragma unroll
  for (int k = 0; k < V; ++k) {
    chan[0][k][threadIdx.x] = s_dx[k];
    chan[1][k][threadIdx.x] = s_dscale[k];
    chan[2][k][threadIdx.x] = s_dshift[k];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 3 * cpg; j += kThreads) {
    const int which = j / cpg;
    const int ch = j - which * cpg;
    const int k = ch % V;
    float acc = 0.0f;
    for (int t = ch / V; t < active; t += chunks) acc += chan[which][k][t];
    part[(static_cast<size_t>(which) * b + img) * c + g * cpg + ch] = acc;
  }
}

// out[w][ch] = sum over img of part[w][img][ch], images in order.
__global__ void sum_images_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int b, int c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * c) return;
  const int which = i / c;
  const int ch = i - which * c;
  float acc = 0.0f;
  for (int img = 0; img < b; ++img) {
    acc += part[(static_cast<size_t>(which) * b + img) * c + ch];
  }
  out[i] = acc;
}

template <typename T, bool kStats>
int launch_fwd(const void* x, const float* bias, const float* scale,
               const float* shift, void* out, float* mean_out,
               float* inv_out, int b, int hw, int c, int groups, float eps,
               bool vectorized, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int cpg = c / groups;
  const size_t smem = 3 * cpg * sizeof(float);
  const dim3 grid(b * groups);
  if (vectorized) {
    bias_gn_relu_kernel<T, kVec, kStats><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), bias, scale, shift, static_cast<T*>(out),
        mean_out, inv_out, hw, c, groups, eps);
  } else {
    bias_gn_relu_kernel<T, 1, kStats><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), bias, scale, shift, static_cast<T*>(out),
        mean_out, inv_out, hw, c, groups, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* y, const void* dy,
               const float* bias, const float* scale, const float* mean,
               const float* inv, void* dx, float* part, float* out, int b,
               int hw, int c, int groups, bool vectorized,
               cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int cpg = c / groups;
  const size_t smem = 2 * cpg * sizeof(float);
  const dim3 grid(b * groups);
  if (vectorized) {
    gn_bwd_kernel<T, kVec><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const T*>(dy), bias, scale, mean, inv,
        static_cast<T*>(dx), part, hw, c, groups);
  } else {
    gn_bwd_kernel<T, 1><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const T*>(dy), bias, scale, mean, inv,
        static_cast<T*>(dx), part, hw, c, groups);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_images_kernel<<<(3 * c + kSumThreads - 1) / kSumThreads, kSumThreads,
                      0, stream>>>(part, out, b, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vectorized: the caller has checked
// that every (B, H, W, C) pointer is 16-byte aligned and that cpg and C
// are multiples of 16 / sizeof(element). Each entry launches on
// `stream` and returns the cudaError_t of its launches.

// y = relu(GN(x + bias) * scale + shift).
int bias_gn_relu_launch(const void* x, const float* bias, const float* scale,
                        const float* shift, void* out, int b, int hw, int c,
                        int groups, float eps, int dtype, int vectorized,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_fwd<float, false>(x, bias, scale, shift, out, nullptr,
                                    nullptr, b, hw, c, groups, eps,
                                    vectorized != 0, s);
  }
  return launch_fwd<__nv_bfloat16, false>(x, bias, scale, shift, out, nullptr,
                                          nullptr, b, hw, c, groups, eps,
                                          vectorized != 0, s);
}

// The same y, and mean and inv as (B, groups) float32.
int bias_gn_relu_fwd_stats_launch(const void* x, const float* bias,
                                  const float* scale, const float* shift,
                                  void* out, float* mean, float* inv, int b,
                                  int hw, int c, int groups, float eps,
                                  int dtype, int vectorized, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_fwd<float, true>(x, bias, scale, shift, out, mean, inv, b,
                                   hw, c, groups, eps, vectorized != 0, s);
  }
  return launch_fwd<__nv_bfloat16, true>(x, bias, scale, shift, out, mean,
                                         inv, b, hw, c, groups, eps,
                                         vectorized != 0, s);
}

// dx (B, H, W, C) in x's type; out (3, C) float32: dbias, dscale,
// dshift. part is (3, B, C) float32 scratch.
int bias_gn_relu_bwd_launch(const void* x, const void* y, const void* dy,
                            const float* bias, const float* scale,
                            const float* mean, const float* inv, void* dx,
                            float* part, float* out, int b, int hw, int c,
                            int groups, int dtype, int vectorized,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd<float>(x, y, dy, bias, scale, mean, inv, dx, part, out,
                             b, hw, c, groups, vectorized != 0, s);
  }
  return launch_bwd<__nv_bfloat16>(x, y, dy, bias, scale, mean, inv, dx, part,
                                   out, b, hw, c, groups, vectorized != 0, s);
}

const char* gn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
