// Fused bias + GroupNorm + ReLU for Hopper (sm_90a): forward, forward
// with the saved statistics, and the fused backward.
//
// Replaces the TPU kernels of mydetection_tpu/ops/pallas/gn_kernel.py:
//   gn_fwd_kernel<T, false>           _gn_kernel (bias_gn_relu_pallas_impl),
//                                     which FCOS runs after each of the 8
//                                     tower convs on each of the 5 levels;
//   gn_fwd_kernel<T, true>            _gn_fwd_stats_kernel (_fwd_with_stats),
//                                     the same forward under autograd,
//                                     which also writes mean and inv;
//   gn_bwd_kernel + sum_parts_kernel  _gn_bwd_kernel (_bwd_fused), its
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
// channels_last for the NCHW tensors the convs emit); a pixel's C
// channels (its row, a multiple of 16 bytes) lie side by side.
//
// Bound on an H100: bytes (4 a bf16 element forward, x read and y
// written; 8 backward, x, y, dy read and dx written), against about 9
// and 16 float32 operations an element.
//
// Design: the TPU kernel holds a whole image on chip (grid = (B,)). Here
// a thread block cluster does: an image's pixels are cut into `cluster`
// contiguous ranges, one a block, each one contiguous run of bytes in
// NHWC, so every copy moves whole 16-byte vectors of whole rows and every
// sector is used whole. kernels/gn.py::gn_plan picks the cut from
// the shape and the shared-memory budget and passes it here; the
// launcher checks it against the layout below.
//
// A block is eight consumer warps and one producer warp. The producer
// warp issues every bulk copy (cp.async.bulk, global to shared, on a
// full mbarrier a slot) and every bulk store, and retires each chunk
// when all eight consumer warps have arrived at its done mbarrier: the
// consumers never wait on an issue, and no per-chunk block barrier
// holds them together. Consumer thread t owns the 16-byte channel
// vector t % (row / 16) of every pixel it takes (pixels t / (row / 16),
// then every kThreads / (row / 16)-th), so its channels are fixed for
// the whole walk: at C = 256 in bf16, lane l of each warp owns channels
// 8l .. 8l + 7, one group. Each thread sums per channel; the consumers
// add the threads' sums over their pixel slots in slot order, then per
// group in channel order. The per-channel parameters (and the
// backward's mean and inv) are read at the start, before the bulk
// copies fill the SM's memory queue.
//
// Forward, resident (bf16 on the FCOS paths): the producer issues the
// block's whole range at once, in up to 4 copies, so the sums start on
// the first while the rest are in flight. The blocks write their group
// partials (sum, sum of squares) to their own shared memory; after the
// cluster barrier every block reads all of them through distributed
// shared memory (every load in flight at once) and adds them in rank
// order, so every block holds the same mean and inv bit for bit and two
// runs give the same bits. Then each chunk is normalized in place and
// stored as soon as every warp is done with it. x is read once and y
// written once. With the statistics, rank 0 writes mean and inv.
//
// Forward, streaming (an image no cluster of 16 holds: float32 at P3 at
// 608, 5.9 MB; bf16 at P3 at 1024): the same walk through a ring of
// `stages` chunks, twice: the sums, the cluster exchange, then x read
// again, normalized and stored from the ring.
//
// Backward, resident (bf16): pass 1 streams x, y and dy through a ring
// of `stages` stages, sums dxhat and dxhat * xhat per group and keeps
// the masked gradient dpre (lossless in T) in the block's tile; the
// cluster exchange gives m1 and m2; pass 2 streams x alone (three times
// the pixels a stage), writes dx over dpre in the tile, from where the
// producer stores it, and keeps per-channel sums of dx, dpre * xhat and
// dpre. x, y and dy are read once and x once more: 5 tensor passes
// against the bound's 4. Backward, streaming (float32 at P3): pass 2
// streams x, y and dy again and dx is stored from the ring. Each block
// writes its channel sums to part (3, B, cluster, C); sum_parts_kernel
// adds them over the cluster's ranks in rank order, then over the
// images in image order. No atomics anywhere: two runs give the same
// bits.
//
// What holds it (measured on an H100 80GB HBM3, PERF.md): a bulk copy's latency
// under load is a few microseconds, so an SM moves about as many bytes a
// second as it keeps in flight over that latency. The resident forward
// puts its whole range in flight; the resident backward at P3 keeps
// only its ring (3 stages of 7 pixels beside a 185 KB dpre tile).
//
// A cluster above 8 blocks is a non-portable size: the launcher allows
// it and asks cudaOccupancyMaxActiveClusters once for each (kernel,
// cluster, shared memory); a plan that cannot launch returns an error,
// which the wrapper raises.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;              // consumer threads
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = kThreads + 32;      // and one producer warp
constexpr int kSmemLimit = 232448;  // a block's shared memory on sm_90
constexpr int kMaxCluster = 16;
constexpr int kSumThreads = 256;

// kernels/gn.py::GNPlan; the launchers read the last nine from the int
// array gn.py passes, in this order
struct Plan {
  int b, hw, c, groups;
  int cluster;   // blocks an image (1 to 16)
  int resident;  // the block's range (forward) or dpre (backward) stays
  int chunk;     // pixels a bulk copy (backward: of each of x, y, dy)
  int chunk2;    // backward pass 2: pixels a stage
  int stages;    // ring stages (0: no ring)
  int tile;      // pixels the resident tile holds
  int slots;     // mbarriers
  int smem;      // dynamic shared memory bytes
  int blocks;    // grid
};

__host__ __device__ constexpr int round128(int v) { return (v + 127) / 128 * 128; }

// byte offsets of a block's shared-memory regions, in order;
// kernels/gn.py::_smem_bytes computes the same total
struct Layout {
  int tile, ring, params, red, gpart, stats, coef, bars, total;
};

__host__ __device__ inline Layout make_layout(const Plan& p, int elem,
                                              bool bwd) {
  const int row = p.c * elem;
  const int nslot = kThreads / (row / 16);
  Layout l;
  int at = 0;
  l.tile = at;
  at += round128(p.resident ? p.tile * row : 0);
  l.ring = at;
  at += round128(p.stages * (bwd ? 3 : 1) * p.chunk * row);
  l.params = at;
  at += round128((bwd ? 2 : 3) * p.c * 4);
  l.red = at;
  at += round128(nslot * p.c * 4);
  l.gpart = at;
  at += round128(2 * p.groups * 4);
  l.stats = at;
  at += round128(2 * p.groups * 4);
  l.coef = at;
  at += round128(bwd ? 2 * p.groups * 4 : 0);
  l.bars = at;
  at += round128(p.slots * 2 * 8);  // full and done barriers
  l.total = at;
  return l;
}

// the pixels a block owns: pixels lo .. lo + npix - 1 of image img
// (kernels/gn.py::gn_ranges)
struct Range {
  int img, lo, npix;
};

__device__ inline Range block_range(const Plan& p) {
  const int n = p.cluster;
  const int rank = blockIdx.x % n;
  Range r;
  r.img = blockIdx.x / n;
  r.lo = static_cast<int>(static_cast<long long>(rank) * p.hw / n);
  r.npix = static_cast<int>(static_cast<long long>(rank + 1) * p.hw / n) -
           r.lo;
  return r;
}

// 16 bytes of T as V floats, and back (bf16 rounded to nearest even)
template <typename T> struct Pack;

template <> struct Pack<float> {
  static constexpr int V = 4;
  __device__ static void load(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 store(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static float2 half2(uint32_t w) {
    __nv_bfloat162 h;
    memcpy(&h, &w, 4);
    return __bfloat1622float2(h);
  }
  __device__ static uint32_t word(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    uint32_t w;
    memcpy(&w, &h, 4);
    return w;
  }
  __device__ static void load(const uint4& u, float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = half2(w[k]);
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  }
  __device__ static uint4 store(const float (&f)[8]) {
    return make_uint4(word(f[0], f[1]), word(f[2], f[3]), word(f[4], f[5]),
                      word(f[6], f[7]));
  }
};

// the consumer threads' own barrier (named barrier 1; the producer warp
// takes no part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// a consumer warp is done with a chunk: one arrival a warp on `bar`
// (done barriers count kWarps), after every lane's shared-memory writes
__device__ __forceinline__ void warp_done(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// The block's per-channel totals of v (each consumer thread's V channel
// values) over its pixel slots, in slot order: left in red[0 .. c).
template <int V>
__device__ inline void sum_over_slots(const float (&v)[V], float* red, int c,
                                      int vp, int nslot) {
  const int j = threadIdx.x % vp;
  const int s = threadIdx.x / vp;
  consumers_sync();  // red's last readers are done
  if (s < nslot) {
#pragma unroll
    for (int e = 0; e < V; ++e) red[s * c + j * V + e] = v[e];
  }
  consumers_sync();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float a = red[ch];
    for (int t = 1; t < nslot; ++t) a += red[t * c + ch];
    red[ch] = a;
  }
  consumers_sync();
}

// out[g] = red[0 .. c)'s channels of group g added in channel order
__device__ inline void group_sums(const float* red, float* out, int groups,
                                  int cpg) {
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    float a = 0.0f;
    for (int k = 0; k < cpg; ++k) a += red[g * cpg + k];
    out[g] = a;
  }
}

// The cluster's group partials (2 x groups, at gpart in every block)
// added in rank order, by the consumer threads; calls f(g, first,
// second) for each group g. The
// producer warp arrives at the cluster barrier on its own (it writes no
// partials). Ends with this block's arrival at the barrier whose wait is
// the kernel's last instruction, so no block leaves while a peer may
// still read its shared memory.
template <typename F>
__device__ inline void cluster_totals(const float* gpart, int groups, int n,
                                      F&& f) {
  if (n > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    consumers_sync();
  }
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    float a = 0.0f;
    float b = 0.0f;
    if (n > 1) {
      float av[kMaxCluster], bv[kMaxCluster];  // every load in flight at once
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q < n) {
          av[q] = ld_cluster(gpart + g, q);
          bv[q] = ld_cluster(gpart + groups + g, q);
        }
      }
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q < n) {
          a += av[q];
          b += bv[q];
        }
      }
    } else {
      a = gpart[g];
      b = gpart[groups + g];
    }
    f(g, a, b);
  }
  if (n > 1) cluster_arrive();
  consumers_sync();
}

// A kernel's loads in order, walked without a division: load m is
// chunk q of pass `pass` (a pass walks the block's range in chunks of
// width[pass] pixels), into buffer slot `slot`, whose barriers are in
// phase `phase`. Slots wrap (a ring) or do not (the resident forward:
// one slot a load).
struct Cursor {
  int m = 0, q = 0, pass = 0, slot = 0;
  uint32_t phase = 0;
};

struct Loads {
  int npix, row, slots;
  int width[2], chunks[2];
  bool wrap;
  __device__ int pixels(const Cursor& c) const {
    return min(width[c.pass], npix - c.q * width[c.pass]);
  }
  // bytes from the block's first pixel
  __device__ size_t offset(const Cursor& c) const {
    return static_cast<size_t>(c.q) * width[c.pass] * row;
  }
  __device__ void next(Cursor& c) const {
    ++c.m;
    if (++c.slot == slots && wrap) {
      c.slot = 0;
      c.phase ^= 1;
    }
    if (++c.q == chunks[c.pass]) {
      c.q = 0;
      ++c.pass;
    }
  }
};

// The producer warp's walk over a kernel's `loads` loads: load m goes out
// once the load `lag` before it is retired (lag: the ring's slots, or
// every load at once), and a load is retired when every consumer warp is
// done with it; retire(c) then stores what the consumers left, if
// anything. The whole warp walks in step (every lane waits, lane 0
// issues): a lane that went ahead to the cluster barrier would hold the
// warp there. Around the walk the warp takes its part in the cluster
// barrier's two phases: it arrives for phase 1 at once (it writes no
// partials) and for phase 2 at the end.
template <typename Issue, typename Retire>
__device__ inline void produce(int n, const Loads& L, int loads,
                               uint64_t* done, Issue&& issue,
                               Retire&& retire) {
  const bool lead = (threadIdx.x & 31) == 0;
  if (n > 1) cluster_arrive();
  const int lag = L.wrap ? L.slots : loads;
  Cursor in, out;  // the next load to issue, and to retire
  auto finish = [&] {
    mbar_wait(smem_u32(&done[out.slot]), out.phase);
    if (lead) retire(out);
    __syncwarp();
    L.next(out);
  };
  for (int m = 0; m < loads; ++m) {
    if (m >= lag) finish();
    if (lead) issue(in);
    __syncwarp();
    L.next(in);
  }
  while (out.m < loads) finish();
  if (lead) bulk_wait<false>();
  __syncwarp();
  if (n > 1) {
    cluster_wait();
    cluster_arrive();
    cluster_wait();
  }
}

template <typename T, bool kStats>
__global__ void __launch_bounds__(kBlock)
gn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ bias,
              const float* __restrict__ scale,
              const float* __restrict__ shift, T* __restrict__ out,
              float* __restrict__ mean_out, float* __restrict__ inv_out,
              const Plan p, const float eps) {
  constexpr int V = Pack<T>::V;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(p, sizeof(T), false);
  const int row = p.c * static_cast<int>(sizeof(T));
  const int vp = row / 16;
  const int nslot = kThreads / vp;
  const int j = threadIdx.x % vp;
  const int s = threadIdx.x / vp;
  const bool on = s < nslot;
  const int G = p.groups;
  const int cpg = p.c / G;
  const int n = p.cluster;
  const int rank = blockIdx.x % n;
  const Range r = block_range(p);

  float* prm = reinterpret_cast<float*>(smem + L.params);  // bias, scale, shift
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* gpart = reinterpret_cast<float*>(smem + L.gpart);  // sum, sum of squares
  float* stats = reinterpret_cast<float*>(smem + L.stats);  // mean, inv
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* done = full + p.slots;
  unsigned char* buf = smem + (p.resident ? L.tile : L.ring);
  const size_t first = (static_cast<size_t>(r.img) * p.hw + r.lo) * row;

  // resident: the range's chunks, one slot each; streaming: its chunks
  // twice through the ring, the sums, then the normalize
  const int cpi = (r.npix + p.chunk - 1) / p.chunk;
  const int loads = p.resident ? cpi : 2 * cpi;
  const Loads W{r.npix, row, p.resident ? loads : p.stages,
                {p.chunk, p.chunk}, {cpi, cpi}, !p.resident};
  auto at = [&](const Cursor& c) {
    return p.resident ? buf + W.offset(c)
                      : buf + static_cast<size_t>(c.slot) * p.chunk * row;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.slots; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&done[i]), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kThreads) {
    produce(n, W, loads, done,
            [&](const Cursor& c) {
              const uint32_t bytes = W.pixels(c) * row;
              const uint32_t bar = smem_u32(&full[c.slot]);
              mbar_expect(bar, bytes);
              bulk_load(smem_u32(at(c)),
                        reinterpret_cast<const char*>(x) + first + W.offset(c),
                        bytes, bar);
            },
            [&](const Cursor& c) {
              if (!p.resident && c.pass == 0) return;  // a chunk of the sums
              bulk_store(reinterpret_cast<char*>(out) + first + W.offset(c),
                         smem_u32(at(c)), W.pixels(c) * row);
              bulk_commit();
              // a ring slot is loaded again once its store has read it
              if (!p.resident && c.m + p.stages < loads) bulk_wait_reads<0>();
            });
    return;
  }

  for (int k = threadIdx.x; k < 3 * p.c; k += kThreads) {
    prm[k] = k < p.c ? bias[k] : k < 2 * p.c ? scale[k - p.c]
                                              : shift[k - 2 * p.c];
  }
  consumers_sync();
  float b_r[V];
#pragma unroll
  for (int e = 0; e < V; ++e) b_r[e] = prm[j * V + e];

  // the sums
  Cursor c;
  float sum[V], sq[V];
#pragma unroll
  for (int e = 0; e < V; ++e) sum[e] = sq[e] = 0.0f;
  for (int q = 0; q < cpi; ++q, W.next(c)) {
    mbar_wait(smem_u32(&full[c.slot]), c.phase);
    const unsigned char* t = at(c);
    const int cnt = W.pixels(c);
    if (on) {
      for (int px = s; px < cnt; px += nslot) {
        float f[V];
        Pack<T>::load(*reinterpret_cast<const uint4*>(
                          t + static_cast<size_t>(px) * row + j * 16), f);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float v = f[e] + b_r[e];
          sum[e] += v;
          sq[e] += v * v;
        }
      }
    }
    if (!p.resident) warp_done(smem_u32(&done[c.slot]));
  }
  sum_over_slots(sum, red, p.c, vp, nslot);
  group_sums(red, gpart, G, cpg);
  sum_over_slots(sq, red, p.c, vp, nslot);
  group_sums(red, gpart + G, G, cpg);

  // mean and inv from the whole cluster's sums
  const float nf = static_cast<float>(p.hw) * static_cast<float>(cpg);
  cluster_totals(gpart, G, n, [&](int g, float a, float b) {
    const float mean = a / nf;
    const float var = fmaxf(b / nf - mean * mean, 0.0f);
    const float inv = 1.0f / sqrtf(var + eps);
    stats[g] = mean;
    stats[G + g] = inv;
    if (kStats && rank == 0) {
      mean_out[static_cast<size_t>(r.img) * G + g] = mean;
      inv_out[static_cast<size_t>(r.img) * G + g] = inv;
    }
  });

  // normalize in place, chunk by chunk; the producer stores each chunk
  // as soon as every warp is done with it (resident: the chunks again
  // from the first; streaming: the ring's second pass)
  if (p.resident) c = Cursor();
  float mu[V], iv[V], sc[V], sh[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int ch = j * V + e;
    const int g = ch / cpg;
    mu[e] = stats[g];
    iv[e] = stats[G + g];
    sc[e] = prm[p.c + ch];
    sh[e] = prm[2 * p.c + ch];
  }
  for (int q = 0; q < cpi; ++q, W.next(c)) {
    if (!p.resident) mbar_wait(smem_u32(&full[c.slot]), c.phase);
    unsigned char* t = at(c);
    const int cnt = W.pixels(c);
    if (on) {
      for (int px = s; px < cnt; px += nslot) {
        uint4* a = reinterpret_cast<uint4*>(
            t + static_cast<size_t>(px) * row + j * 16);
        float f[V];
        Pack<T>::load(*a, f);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float v = f[e] + b_r[e];
          f[e] = fmaxf(((v - mu[e]) * iv[e]) * sc[e] + sh[e], 0.0f);
        }
        *a = Pack<T>::store(f);
      }
    }
    fence_async_shared();
    warp_done(smem_u32(&done[c.slot]));
  }
  if (n > 1) cluster_wait();
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
              const T* __restrict__ dy, const float* __restrict__ bias,
              const float* __restrict__ scale,
              const float* __restrict__ mean_g,
              const float* __restrict__ inv_g, T* __restrict__ dx,
              float* __restrict__ part, const Plan p) {
  constexpr int V = Pack<T>::V;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(p, sizeof(T), true);
  const int row = p.c * static_cast<int>(sizeof(T));
  const int vp = row / 16;
  const int nslot = kThreads / vp;
  const int j = threadIdx.x % vp;
  const int s = threadIdx.x / vp;
  const bool on = s < nslot;
  const int G = p.groups;
  const int cpg = p.c / G;
  const int n = p.cluster;
  const int rank = blockIdx.x % n;
  const Range r = block_range(p);

  unsigned char* tile = smem + L.tile;  // dpre, then dx (resident)
  unsigned char* ring = smem + L.ring;
  float* prm = reinterpret_cast<float*>(smem + L.params);  // bias, scale
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* gpart = reinterpret_cast<float*>(smem + L.gpart);  // s1, s2
  float* stats = reinterpret_cast<float*>(smem + L.stats);  // mean, inv
  float* coef = reinterpret_cast<float*>(smem + L.coef);    // m1, m2
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* done = full + p.slots;
  const size_t first = (static_cast<size_t>(r.img) * p.hw + r.lo) * row;
  const size_t plane = static_cast<size_t>(p.chunk) * row;  // a tensor's part of a stage
  const size_t stage = 3 * plane;

  // pass 1: x, y, dy in chunks of `chunk` pixels; pass 2: x alone in
  // chunks of chunk2 (resident, three times the pixels a stage) or x, y,
  // dy again (streaming, chunk2 == chunk)
  const int cpi1 = (r.npix + p.chunk - 1) / p.chunk;
  const int cpi2 = (r.npix + p.chunk2 - 1) / p.chunk2;
  const int loads = cpi1 + cpi2;
  const Loads W{r.npix, row, p.stages, {p.chunk, p.chunk2}, {cpi1, cpi2},
                true};
  auto slot = [&](const Cursor& c) {
    return ring + static_cast<size_t>(c.slot) * stage;
  };
  // where pass 2 leaves a load's dx: over dpre in the tile, or over x in
  // the ring
  auto dx_at = [&](const Cursor& c) {
    return p.resident ? tile + W.offset(c) : slot(c);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.slots; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&done[i]), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kThreads) {
    produce(n, W, loads, done,
            [&](const Cursor& c) {
              const uint32_t bytes = W.pixels(c) * row;
              const size_t off = first + W.offset(c);
              const uint32_t st = smem_u32(slot(c));
              const uint32_t bar = smem_u32(&full[c.slot]);
              if (c.pass == 0 || !p.resident) {
                mbar_expect(bar, 3 * bytes);
                bulk_load(st, reinterpret_cast<const char*>(x) + off, bytes, bar);
                bulk_load(st + plane, reinterpret_cast<const char*>(y) + off,
                          bytes, bar);
                bulk_load(st + 2 * plane,
                          reinterpret_cast<const char*>(dy) + off, bytes, bar);
              } else {
                mbar_expect(bar, bytes);
                bulk_load(st, reinterpret_cast<const char*>(x) + off, bytes, bar);
              }
            },
            [&](const Cursor& c) {
              if (c.pass == 0) return;  // a chunk of pass 1
              bulk_store(reinterpret_cast<char*>(dx) + first + W.offset(c),
                         smem_u32(dx_at(c)), W.pixels(c) * row);
              bulk_commit();
              // a ring slot is loaded again once its store has read it
              if (!p.resident && c.m + p.stages < loads) bulk_wait_reads<0>();
            });
    return;
  }

  for (int k = threadIdx.x; k < 2 * p.c; k += kThreads) {
    prm[k] = k < p.c ? bias[k] : scale[k - p.c];
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    stats[g] = mean_g[static_cast<size_t>(r.img) * G + g];
    stats[G + g] = inv_g[static_cast<size_t>(r.img) * G + g];
  }
  consumers_sync();
  float b_r[V], sc[V], mu[V], iv[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int g = (j * V + e) / cpg;
    b_r[e] = prm[j * V + e];
    sc[e] = prm[p.c + j * V + e];
    mu[e] = stats[g];
    iv[e] = stats[G + g];
  }

  // pass 1: the group sums of dxhat and dxhat * xhat; dpre kept (resident)
  Cursor c;
  float s1[V], s2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.0f;
  for (int q = 0; q < cpi1; ++q, W.next(c)) {
    mbar_wait(smem_u32(&full[c.slot]), c.phase);
    const unsigned char* st = slot(c);
    unsigned char* keep = tile + W.offset(c);
    const int cnt = W.pixels(c);
    if (on) {
      for (int px = s; px < cnt; px += nslot) {
        const size_t o = static_cast<size_t>(px) * row + j * 16;
        float xf[V], yf[V], df[V];
        Pack<T>::load(*reinterpret_cast<const uint4*>(st + o), xf);
        Pack<T>::load(*reinterpret_cast<const uint4*>(st + plane + o), yf);
        Pack<T>::load(*reinterpret_cast<const uint4*>(st + 2 * plane + o), df);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xhat = ((xf[e] + b_r[e]) - mu[e]) * iv[e];
          df[e] = yf[e] > 0.0f ? df[e] : 0.0f;
          const float dxhat = df[e] * sc[e];
          s1[e] += dxhat;
          s2[e] += dxhat * xhat;
        }
        if (p.resident) {
          // exact: dy's own value or 0
          *reinterpret_cast<uint4*>(keep + o) = Pack<T>::store(df);
        }
      }
    }
    warp_done(smem_u32(&done[c.slot]));
  }
  sum_over_slots(s1, red, p.c, vp, nslot);
  group_sums(red, gpart, G, cpg);
  sum_over_slots(s2, red, p.c, vp, nslot);
  group_sums(red, gpart + G, G, cpg);

  const float nf = static_cast<float>(p.hw) * static_cast<float>(cpg);
  cluster_totals(gpart, G, n, [&](int g, float a, float b) {
    coef[g] = a / nf;
    coef[G + g] = b / nf;
  });

  // pass 2: dx, stored chunk by chunk by the producer, and the
  // per-channel sums
  float m1[V], m2[V], sdx[V], sds[V], ssh[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int g = (j * V + e) / cpg;
    m1[e] = coef[g];
    m2[e] = coef[G + g];
    sdx[e] = sds[e] = ssh[e] = 0.0f;
  }
  for (int q = 0; q < cpi2; ++q, W.next(c)) {
    mbar_wait(smem_u32(&full[c.slot]), c.phase);
    const unsigned char* st = slot(c);
    unsigned char* o_at = dx_at(c);
    const int cnt = W.pixels(c);
    if (on) {
      for (int px = s; px < cnt; px += nslot) {
        const size_t o = static_cast<size_t>(px) * row + j * 16;
        float xf[V], dp[V];
        Pack<T>::load(*reinterpret_cast<const uint4*>(st + o), xf);
        if (p.resident) {
          Pack<T>::load(*reinterpret_cast<const uint4*>(o_at + o), dp);
        } else {
          float yf[V];
          Pack<T>::load(*reinterpret_cast<const uint4*>(st + plane + o), yf);
          Pack<T>::load(*reinterpret_cast<const uint4*>(st + 2 * plane + o), dp);
#pragma unroll
          for (int e = 0; e < V; ++e) dp[e] = yf[e] > 0.0f ? dp[e] : 0.0f;
        }
        float d[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xhat = ((xf[e] + b_r[e]) - mu[e]) * iv[e];
          const float dxhat = dp[e] * sc[e];
          d[e] = iv[e] * ((dxhat - m1[e]) - xhat * m2[e]);
          sdx[e] += d[e];
          sds[e] += dp[e] * xhat;
          ssh[e] += dp[e];
        }
        *reinterpret_cast<uint4*>(o_at + o) = Pack<T>::store(d);
      }
    }
    fence_async_shared();
    warp_done(smem_u32(&done[c.slot]));
  }
  // this block's channel sums: part[w][img][rank][ch]
  auto write_part = [&](int w, const float (&v)[V]) {
    sum_over_slots(v, red, p.c, vp, nslot);
    for (int ch = threadIdx.x; ch < p.c; ch += kThreads) {
      part[((static_cast<size_t>(w) * p.b + r.img) * n + rank) * p.c + ch] =
          red[ch];
    }
  };
  write_part(0, sdx);
  write_part(1, sds);
  write_part(2, ssh);
  if (n > 1) cluster_wait();
}

// out[w][ch] = sum over images, in image order, of the sum over the
// image's cluster ranks, in rank order, of part[w][img][rank][ch]
__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int b, int n,
                                 int c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * c) return;
  const int w = i / c;
  const int ch = i - w * c;
  float acc = 0.0f;
#pragma unroll 8
  for (int img = 0; img < b; ++img) {
    const float* at = part + (static_cast<size_t>(w) * b + img) * n * c + ch;
    float s = 0.0f;
#pragma unroll 4
    for (int q = 0; q < n; ++q) s += at[static_cast<size_t>(q) * c];
    acc += s;
  }
  out[i] = acc;
}

Plan read_plan(const int* ints, int b, int hw, int c, int groups) {
  Plan p;
  p.b = b;
  p.hw = hw;
  p.c = c;
  p.groups = groups;
  p.cluster = ints[0];
  p.resident = ints[1];
  p.chunk = ints[2];
  p.chunk2 = ints[3];
  p.stages = ints[4];
  p.tile = ints[5];
  p.slots = ints[6];
  p.smem = ints[7];
  p.blocks = ints[8];
  return p;
}

// The plan against what the kernels assume; false if they cannot run it.
bool plan_ok(const Plan& p, int elem, bool bwd) {
  const int row = p.c * elem;
  if (p.b < 1 || p.hw < 1 || p.groups < 1 || p.c % p.groups) return false;
  if (row % 16 || row / 16 > kThreads) return false;
  if (p.cluster < 1 || p.cluster > kMaxCluster || p.cluster > p.hw) return false;
  if (p.blocks != p.b * p.cluster) return false;
  if (p.chunk < 1 || p.chunk2 < 1) return false;
  const int most = (p.hw + p.cluster - 1) / p.cluster;  // pixels a block
  if (p.resident && p.tile < most) return false;
  if (bwd || !p.resident) {
    if (p.stages < 2 || p.slots < p.stages) return false;
  }
  if (bwd) {
    if (p.resident ? p.chunk2 > 3 * p.chunk : p.chunk2 != p.chunk) return false;
  } else if (p.resident && p.slots < (most + p.chunk - 1) / p.chunk) {
    return false;
  }
  const Layout l = make_layout(p, elem, bwd);
  return l.total == p.smem && p.smem <= kSmemLimit;
}

// cudaOccupancyMaxActiveClusters for each (kernel, cluster, shared
// memory), asked once; the function attributes are set on first use
struct Checked {
  const void* fn;
  int cluster, smem, clusters;
};
std::mutex g_lock;
Checked g_checked[256];
int g_count = 0;

template <typename... Args>
cudaError_t max_clusters(void (*kernel)(Args...), const cudaLaunchConfig_t& cfg,
                         int cluster, int* clusters) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> hold(g_lock);
  for (int k = 0; k < g_count; ++k) {
    const Checked& e = g_checked[k];
    if (e.fn == fn && e.cluster == cluster &&
        e.smem == static_cast<int>(cfg.dynamicSmemBytes)) {
      *clusters = e.clusters;
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (g_count < 256) {
    g_checked[g_count++] = {fn, cluster, static_cast<int>(cfg.dynamicSmemBytes),
                            *clusters};
  }
  return cudaSuccess;
}

// the plan's launch configuration; attr (one entry) holds its cluster
// shape and must outlive the launch
cudaLaunchConfig_t config(const Plan& p, cudaLaunchAttribute* attr,
                          cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// launches kernel on the plan's grid and clusters; a plan that cannot
// run, or a cluster that cannot be resident, is refused before launch
template <typename... Args, typename... Given>
cudaError_t launch(void (*kernel)(Args...), const Plan& p, int elem, bool bwd,
                   cudaStream_t stream, Given&&... args) {
  if (!plan_ok(p, elem, bwd)) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(p, &attr, stream);
  int clusters = 0;
  const cudaError_t err = max_clusters(kernel, cfg, p.cluster, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Given>(args)...);
}

template <typename T, bool kStats>
int launch_fwd(const void* x, const float* bias, const float* scale,
               const float* shift, void* out, float* mean, float* inv,
               const Plan& p, float eps, cudaStream_t stream) {
  return static_cast<int>(launch(
      gn_fwd_kernel<T, kStats>, p, sizeof(T), false, stream,
      static_cast<const T*>(x), bias, scale, shift, static_cast<T*>(out),
      mean, inv, p, eps));
}

template <typename T>
int launch_bwd(const void* x, const void* y, const void* dy,
               const float* bias, const float* scale, const float* mean,
               const float* inv, void* dx, float* part, float* out,
               const Plan& p, cudaStream_t stream) {
  const cudaError_t err = launch(
      gn_bwd_kernel<T>, p, sizeof(T), true, stream, static_cast<const T*>(x),
      static_cast<const T*>(y), static_cast<const T*>(dy), bias, scale, mean,
      inv, static_cast<T*>(dx), part, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_parts_kernel<<<(3 * p.c + kSumThreads - 1) / kSumThreads, kSumThreads,
                     0, stream>>>(part, out, p.b, p.cluster, p.c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. plan: nine ints from
// kernels/gn.py::GNPlan.as_ints (cluster, resident, chunk, chunk2,
// stages, tile, slots, smem, blocks). Every (B, H, W, C) pointer
// is 16-byte aligned and C * sizeof(element) a multiple of 16 (the
// wrapper checks). Each entry launches on `stream` and returns the
// cudaError_t of its launches: cudaErrorInvalidValue for a plan that
// does not fit the kernel, cudaErrorLaunchOutOfResources for a cluster
// that cannot be resident.

// y = relu(GN(x + bias) * scale + shift).
int bias_gn_relu_launch(const void* x, const float* bias, const float* scale,
                        const float* shift, void* out, int b, int hw, int c,
                        int groups, float eps, int dtype, const int* plan,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = read_plan(plan, b, hw, c, groups);
  if (dtype == 0) {
    return launch_fwd<float, false>(x, bias, scale, shift, out, nullptr,
                                    nullptr, p, eps, s);
  }
  return launch_fwd<__nv_bfloat16, false>(x, bias, scale, shift, out, nullptr,
                                          nullptr, p, eps, s);
}

// The same y, and mean and inv as (B, groups) float32.
int bias_gn_relu_fwd_stats_launch(const void* x, const float* bias,
                                  const float* scale, const float* shift,
                                  void* out, float* mean, float* inv, int b,
                                  int hw, int c, int groups, float eps,
                                  int dtype, const int* plan, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = read_plan(plan, b, hw, c, groups);
  if (dtype == 0) {
    return launch_fwd<float, true>(x, bias, scale, shift, out, mean, inv, p,
                                   eps, s);
  }
  return launch_fwd<__nv_bfloat16, true>(x, bias, scale, shift, out, mean,
                                         inv, p, eps, s);
}

// dx (B, H, W, C) in x's type; out (3, C) float32: dbias, dscale,
// dshift. part is (3, B, cluster, C) float32 scratch.
int bias_gn_relu_bwd_launch(const void* x, const void* y, const void* dy,
                            const float* bias, const float* scale,
                            const float* mean, const float* inv, void* dx,
                            float* part, float* out, int b, int hw, int c,
                            int groups, int dtype, const int* plan,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = read_plan(plan, b, hw, c, groups);
  if (dtype == 0) {
    return launch_bwd<float>(x, y, dy, bias, scale, mean, inv, dx, part, out,
                             p, s);
  }
  return launch_bwd<__nv_bfloat16>(x, y, dy, bias, scale, mean, inv, dx,
                                   part, out, p, s);
}

// How many clusters of the plan's kernel (bwd 0: the forward, 1: the
// backward) can be resident at once; negative: the cudaError_t of a
// refused plan or query.
int gn_max_active_clusters(int bwd, int b, int hw, int c, int groups,
                           int dtype, const int* plan) {
  const Plan p = read_plan(plan, b, hw, c, groups);
  const int elem = dtype == 0 ? 4 : 2;
  if (!plan_ok(p, elem, bwd != 0)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(p, &attr, nullptr);
  int clusters = 0;
  cudaError_t err;
  if (bwd) {
    err = dtype == 0
              ? max_clusters(gn_bwd_kernel<float>, cfg, p.cluster, &clusters)
              : max_clusters(gn_bwd_kernel<__nv_bfloat16>, cfg, p.cluster,
                             &clusters);
  } else {
    err = dtype == 0
              ? max_clusters(gn_fwd_kernel<float, false>, cfg, p.cluster,
                             &clusters)
              : max_clusters(gn_fwd_kernel<__nv_bfloat16, false>, cfg,
                             p.cluster, &clusters);
  }
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

const char* gn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
