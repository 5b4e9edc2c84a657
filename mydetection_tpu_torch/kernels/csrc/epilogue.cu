// Conv epilogue for Hopper (sm_90a): eval BatchNorm (or a conv bias), the
// activation and a residual add in one pass over a conv's output.
//
// Replaces no TPU kernel: the JAX package leaves a conv's epilogue to
// XLA, which fuses it into the conv. On the card cuDNN runs the conv and
// eager PyTorch ran the epilogue as a dozen launches a conv: five float32
// ops folding the BN (var + eps, rsqrt, scale * r, mean * s, bias - ...),
// two casts of the pair, x * s, + t, then x >= 0, 0.1 * x and where (or
// relu), and the residual add, each a pass over the map.
//
// Bound on an H100: bytes. A pass reads the conv output once, writes the
// result once and reads the residual once where one joins: 4 or 6 bytes
// an element in bf16. Darknet-53 + the YOLOv3 head at 416, batch 32, is
// 1.2 G conv outputs a forward, 1.8 ms at 3.35 TB/s.
//
// Arithmetic: the eager ops' own, rounding where they round, so the
// result is bit-equal to them. Each block folds every channel's pair in
// float32 in their order, s = scale * rsqrtf(var + 1e-5), t = bias -
// mean * s (-fmad=false: no contraction), and rounds s and t to the
// activation type T (bias only: s = 1, t = T(bias)). An element then
// takes y = T(x * s), y = T(y + t), with a residual before the
// activation y = T(y + r), the activation (relu; or leaky: y where y >=
// 0, else T(0.1 * y)), with a residual after it y = T(r + y). Each
// product and sum is float32 and rounded once to T.
//
// Design. x is channels_last (NHWC memory), so an element's channel is
// its index modulo C. Grid-stride over 16-byte vectors (8 bf16 or 4
// float32); a thread steps its channel by the stride modulo C, so no
// division in the loop. The folded pairs sit in shared memory in T:
// where C is a multiple of the vector, a vector's pairs are two 16-byte
// shared loads; otherwise (the YOLOv3 head's 255 channels) each element
// finds its channel by wrapping. A tensor whose size or base does not
// allow 16-byte vectors takes one element a thread.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBlocksPerSm = 2;
constexpr float kBnEps = 1e-5f;
constexpr float kLeakySlope = 0.1f;

enum Act : int { kActNone = 0, kActRelu = 1, kActLeaky = 2 };
enum Res : int { kResNone = 0, kResBefore = 1, kResAfter = 2 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return widen(narrow<T>(v));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T e[VEC];
};

struct Params {
  const void* x;
  const void* res;
  void* out;
  const float* scale;  // null: bias only
  const float* bias;
  const float* mean;
  const float* var;
  int64_t n_vec;       // vectors of VEC elements
  int c;
  int c_pad;           // the shared arrays' stride, a multiple of 8
};

template <typename T, int ACT, int RES>
__device__ __forceinline__ T apply(T xv, T s, T t, T r) {
  float y = rounded<T>(widen(xv) * widen(s));
  y = rounded<T>(y + widen(t));
  if (RES == kResBefore) y = rounded<T>(y + widen(r));
  if (ACT == kActRelu) {
    y = isnan(y) ? y : fmaxf(y, 0.0f);
  } else if (ACT == kActLeaky) {
    y = y >= 0.0f ? y : rounded<T>(kLeakySlope * y);
  }
  if (RES == kResAfter) y = rounded<T>(widen(r) + y);
  return narrow<T>(y);
}

// VEC elements a vector; ALIGNED: C is a multiple of VEC, so a vector's
// channels are ch .. ch + VEC - 1.
template <typename T, int VEC, int ACT, int RES, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_sm = reinterpret_cast<T*>(smem);
  T* t_sm = s_sm + p.c_pad;
  const int c = p.c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float s = 1.0f;
    float t = p.bias[ch];
    if (p.scale != nullptr) {
      s = p.scale[ch] * rsqrtf(p.var[ch] + kBnEps);
      t = p.bias[ch] - p.mean[ch] * s;
    }
    s_sm[ch] = narrow<T>(s);
    t_sm[ch] = narrow<T>(t);
  }
  __syncthreads();

  using V = Pack<T, VEC>;
  const V* __restrict__ x = static_cast<const V*>(p.x);
  const V* __restrict__ res = static_cast<const V*>(p.res);
  V* __restrict__ out = static_cast<V*>(p.out);
  int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int step = static_cast<int>((stride * VEC) % c);
  int ch = static_cast<int>((v * VEC) % c);
  for (; v < p.n_vec; v += stride) {
    const V xv = x[v];
    V rv;
    if (RES != kResNone) rv = res[v];
    V o;
    if (ALIGNED) {
      const V sv = *reinterpret_cast<const V*>(s_sm + ch);
      const V tv = *reinterpret_cast<const V*>(t_sm + ch);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        o.e[j] = apply<T, ACT, RES>(xv.e[j], sv.e[j], tv.e[j],
                                    RES != kResNone ? rv.e[j] : xv.e[j]);
      }
    } else {
      int cj = ch;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        o.e[j] = apply<T, ACT, RES>(xv.e[j], s_sm[cj], t_sm[cj],
                                    RES != kResNone ? rv.e[j] : xv.e[j]);
        cj = cj + 1 == c ? 0 : cj + 1;
      }
    }
    out[v] = o;
    ch += step;
    if (ch >= c) ch -= c;
  }
}

template <typename T, int VEC, bool ALIGNED, int ACT>
void launch_res(const Params& p, int res, dim3 grid, size_t smem,
                cudaStream_t s) {
  if (res == kResBefore) {
    conv_epilogue_kernel<T, VEC, ACT, kResBefore, ALIGNED>
        <<<grid, kThreads, smem, s>>>(p);
  } else if (res == kResAfter) {
    conv_epilogue_kernel<T, VEC, ACT, kResAfter, ALIGNED>
        <<<grid, kThreads, smem, s>>>(p);
  } else {
    conv_epilogue_kernel<T, VEC, ACT, kResNone, ALIGNED>
        <<<grid, kThreads, smem, s>>>(p);
  }
}

template <typename T, int VEC, bool ALIGNED>
void launch_act(const Params& p, int act, int res, dim3 grid, size_t smem,
                cudaStream_t s) {
  if (act == kActRelu) {
    launch_res<T, VEC, ALIGNED, kActRelu>(p, res, grid, smem, s);
  } else if (act == kActLeaky) {
    launch_res<T, VEC, ALIGNED, kActLeaky>(p, res, grid, smem, s);
  } else {
    launch_res<T, VEC, ALIGNED, kActNone>(p, res, grid, smem, s);
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename T>
int launch_typed(Params p, int64_t n, int act, int res, int sms,
                 cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = n % kVec == 0 && aligned16(p.x) && aligned16(p.out)
                   && (res == kResNone || aligned16(p.res));
  const int unit = vec ? kVec : 1;
  p.n_vec = n / unit;
  p.c_pad = (p.c + 7) / 8 * 8;
  const size_t smem = 2 * static_cast<size_t>(p.c_pad) * sizeof(T);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (p.n_vec + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(
      blocks < int64_t{sms} * kBlocksPerSm ? blocks
                                            : int64_t{sms} * kBlocksPerSm));
  if (!vec) {
    launch_act<T, 1, true>(p, act, res, grid, smem, s);
  } else if (p.c % kVec == 0) {
    launch_act<T, kVec, true>(p, act, res, grid, smem, s);
  } else {
    launch_act<T, kVec, false>(p, act, res, grid, smem, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, res (null: none) and out: n elements in channels_last memory with c
// channels, float32 (dtype 0) or bfloat16 (1). scale, mean and var null
// for a bias only, else all three with bias: (c,) float32 BN parameters.
// act: 0 none, 1 relu, 2 leaky(0.1); res_mode: 0 none, 1 added before the
// activation, 2 after it. sms sizes the grid. Launches on `stream`;
// returns the cudaError_t (cudaErrorInvalidValue where 2 * c values of
// the type do not fit 48 KB of shared memory).
int conv_epilogue_launch(const void* x, const void* res, void* out,
                         const float* scale, const float* bias,
                         const float* mean, const float* var, int64_t n,
                         int c, int act, int res_mode, int dtype, int sms,
                         void* stream) {
  if (n == 0) return 0;
  Params p{x, res, out, scale, bias, mean, var, 0, c, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch_typed<__nv_bfloat16>(p, n, act, res_mode, sms, s);
  }
  return launch_typed<float>(p, n, act, res_mode, sms, s);
}

const char* epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
