// Greedy NMS keep-masks on Hopper (sm_90a): what csrc/nms.cu and
// csrc/rotated_nms.cu share, as mydetection_tpu/ops/pallas/common.py's
// greedy_fixpoint_keep serves both TPU kernels.
//
// Both kernels run in two phases on a thread block cluster of n blocks an
// image (n = 1 to 16, the grid B * n blocks; kernels/nms.py::nms_plan
// picks n):
//
//   mask     every block builds a band of the image's suppression
//            bitmask: bit j of row i is set iff j > i and box i suppresses
//            box j. Row i goes to block i % n and to its warp
//            (i / n) % kWarps, so the triangle's rows are dealt out evenly.
//            A warp builds one word (32 columns) with one ballot and
//            stores 32 words of its row at once. Rows of invalid boxes,
//            and every row and column past the last valid box, are
//            neither built nor read.
//   resolve  one warp of the cluster's block 0 walks the rows in score
//            order, a word (32 rows) at a time, from shared memory, once
//            a cluster barrier has handed it the whole mask. The
//            word's rows suppressed by a row kept before it are removed
//            (on chip the kept rows' words are pulled, banded they are
//            pushed into `removed` as rows are kept), and the rest are
//            resolved against the word's own bits by common.py:22's
//            fixpoint, one warp reduction a round. A row is read only once
//            it is kept, so greedy's keep-set comes out bit for bit: it is
//            unique, and both kernels' bits are the oracle's.
//
// Where the mask lives. The upper triangle is packed by word blocks: word
// block q holds rows 32q..32q+31, each with its words q..W-1, padded by one
// word where that count is even (an odd row stride: the 32 lanes reading
// word q of 32 rows hit 32 banks); block q starts at block_offset(q).
// On chip (stages == 0), every block stores its words straight into block
// 0's shared memory over distributed shared memory. Where the packed triangle does not
// fit beside what the mask phase holds (K above 1,696 for nms.cu, 1,856
// for rotated_nms.cu), the blocks write it to a global scratch (B, tri
// words), and block 0 streams it back into a ring of `stages` word blocks
// by bulk copies on mbarriers, one word block ahead of the resolve each.
#pragma once

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <utility>

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace greedy {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxStages = 16;
constexpr int kSmemLimit = 232448;  // 227 KB a block on sm_90
constexpr uint32_t kFull = 0xffffffffu;

__host__ __device__ inline size_t round_up(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

// words a row of word block q holds: W - q, made odd
__host__ __device__ inline int block_len(int q, int words) {
  return (words - q) | 1;
}

// words of the packed triangle before word block q (q = words: all of it)
__host__ __device__ inline size_t block_offset(int q, int words) {
  const size_t qq = q, w = words;
  const size_t evens = w % 2 == 0 ? (qq + 1) / 2 : qq / 2;  // rows padded
  return 32 * (qq * w - qq * (qq - (qq > 0)) / 2 + evens);
}

// A block's shared memory, region by region, each rounded up to 128
// bytes: the block's scalars (one past its last valid box), the valid
// bits and the
// kept bits (a word a 32 boxes each), the resolve's work area (banded:
// `removed`, a word a 32 boxes; on chip: the kept rows' addresses, a word
// a box), the ring's mbarriers, then the data: `box_floats` floats for
// each of 32 * W boxes (nms.cu: a float4 box and the area) and either the
// packed triangle (on chip) or, over the same bytes as the boxes, the
// ring. kernels/nms.py::smem_bytes mirrors this.
struct Layout {
  int words;
  size_t valid, kept, work, bars, boxes, mask;  // byte offsets
  size_t stage;                                    // bytes a ring stage
  size_t total;
};

__host__ __device__ inline Layout make_layout(int k, int box_floats,
                                              int stages) {
  Layout l;
  l.words = (k + 31) / 32;
  const size_t bits = round_up(static_cast<size_t>(l.words) * 4);
  l.valid = 128;
  l.kept = l.valid + bits;
  l.work = l.kept + bits;
  l.bars = l.work + (stages == 0 ? round_up(static_cast<size_t>(l.words) * 128)
                                 : bits);
  l.boxes = l.bars + round_up(static_cast<size_t>(stages) * 8);
  const size_t column = static_cast<size_t>(l.words) * 32 * 4;  // 32W floats
  const size_t boxes = round_up(box_floats * column);
  l.stage = 128 * static_cast<size_t>(block_len(0, l.words));
  if (stages == 0) {
    l.mask = l.boxes + boxes;
    l.total = l.mask + round_up(block_offset(l.words, l.words) * 4);
  } else {
    l.mask = l.boxes;
    const size_t ring = static_cast<size_t>(stages) * l.stage;
    l.total = l.boxes + (boxes > ring ? boxes : ring);
  }
  return l;
}

// The launch against the layout; false if the kernel cannot run it.
inline bool plan_ok(int b, int k, int box_floats, int cluster, int stages,
                    int smem, const void* scratch) {
  if (b < 1 || k < 1 || cluster < 1 || cluster > kMaxCluster) return false;
  if (stages != 0 && (stages < 2 || stages > kMaxStages || !scratch)) {
    return false;
  }
  const Layout l = make_layout(k, box_floats, stages);
  return l.total == static_cast<size_t>(smem) && l.total <= kSmemLimit;
}

__device__ __forceinline__ int cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return static_cast<int>(n);
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ bool bit(const uint32_t* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

// The image's valid bits and `removed` (zeroed; banded) in shared memory,
// the ring's mbarriers initialised; returns one past the last valid box (0
// when none is). Every thread of the block calls it.
__device__ inline int begin(const uint8_t* valid, int k, const Layout& l,
                            uint8_t* smem, int stages) {
  int& last_valid = *reinterpret_cast<int*>(smem);
  uint32_t* valid_bits = reinterpret_cast<uint32_t*>(smem + l.valid);
  uint32_t* removed = reinterpret_cast<uint32_t*>(smem + l.work);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    last_valid = 0;
    const uint32_t bars = hopper::smem_u32(smem + l.bars);
    for (int s = 0; s < stages; ++s) hopper::mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int w = threadIdx.x >> 5; w < l.words; w += kWarps) {
    const int j = w * 32 + lane;
    const uint32_t bits = __ballot_sync(kFull, j < k && valid[j] != 0);
    if (lane == 0) {
      valid_bits[w] = bits;
      removed[w] = 0u;
      if (bits) atomicMax(&last_valid, w * 32 + 32 - __clz(bits));
    }
  }
  __syncthreads();
  return last_valid;
}

// Where a block's mask rows go: block 0's shared memory (on chip) or the
// image's global scratch (banded). `row` is the row's first word in the
// block's own layout.
template <bool kBanded>
__device__ __forceinline__ void store_word(uint32_t* row, int w, uint32_t v) {
  if constexpr (kBanded) {
    row[w] = v;
  } else {
    hopper::st_cluster(row + w, 0, v);
  }
}

// Row i's first word: in block 0's packed triangle at `mask` (on chip;
// the address is this block's, which st_cluster maps) or in the global one
__device__ __forceinline__ uint32_t* row_start(uint32_t* mask, int i,
                                               int words) {
  const int q = i >> 5;
  return mask + block_offset(q, words) +
         static_cast<size_t>(i & 31) * block_len(q, words);
}

// Hands the finished mask to block 0: a cluster barrier (its release and
// acquire order the stores, shared or global; bulk copies read the global
// ones after the proxy fence). Returns true in block 0, which resolves.
template <bool kBanded>
__device__ __forceinline__ bool mask_done() {
  if constexpr (kBanded) hopper::fence_async_global();
  hopper::cluster_arrive();
  hopper::cluster_wait();
  return cluster_rank() == 0;
}

// The banded resolve's word blocks, streamed from the global packed
// triangle through a ring of `stages` word blocks in shared memory, lane 0
// keeping a bulk copy in flight for each stage
struct Ring {
  const uint32_t* tri;  // the image's packed triangle in global memory
  uint32_t* ring;       // stages * stage bytes of shared memory
  uint32_t bars;        // the stages' mbarriers
  int stages, words, last;
  size_t stage_words;

  __device__ void issue(int q) const {
    const int s = q % stages;
    const uint32_t bytes = 128u * block_len(q, words);
    hopper::mbar_expect(bars + 8 * s, static_cast<int>(bytes));
    hopper::bulk_load(hopper::smem_u32(ring + s * stage_words),
                      tri + block_offset(q, words), bytes, bars + 8 * s);
  }
  __device__ void start() const {
    if ((threadIdx.x & 31) == 0) {
      hopper::fence_async_global();
      for (int q = 0; q < stages && q <= last; ++q) issue(q);
    }
  }
  __device__ const uint32_t* block(int q) const {
    hopper::mbar_wait(bars + 8 * (q % stages), (q / stages) & 1);
    return ring + (q % stages) * stage_words;
  }
  // every lane has read the stage: refill it with word block q + stages
  __device__ void release(int q) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0 && q + stages <= last) issue(q + stages);
  }
};

// The greedy order inside one word: `alive` rows (bits) of the word
// block, each lane holding its row's bits of the word (the later rows it
// suppresses); returns the kept rows. common.py:22's fixpoint: keep =
// alive & ~(rows suppressed by keep), from keep = alive until it stops
// changing. Row c's bit depends only on the rows before it, so the first
// n rows are settled after n rounds and the first unchanged round is
// greedy's answer; a round is one warp reduction, and real box sets
// settle in a few (PERF.md: 1.5 a word on the paths' data, where the
// walk in row order takes a shuffle a kept row).
__device__ __forceinline__ uint32_t resolve_word(uint32_t alive, uint32_t t) {
  const int lane = threadIdx.x & 31;
  uint32_t keep = alive;
  for (;;) {
    const uint32_t sup = __reduce_or_sync(kFull, (keep >> lane) & 1u ? t : 0u);
    const uint32_t next = alive & ~sup;
    if (next == keep) return keep;
    keep = next;
  }
}

// The resolve on chip, by one warp: word blocks 0..last in order, the
// kept bits of each into `kept`. Every kept row stays readable, so the
// removed bits of word q + 1 are the OR of word q + 1 of every row kept
// so far. Their loads do not wait for word q: the rows kept before it are
// pulled from `list` (each kept row's address less its word block, so
// that its word w is at list + w), sixteen loads a lane in flight over
// word q's fixpoint, and word q's own rows load their word q + 1 at the
// start; one warp reduction after the fixpoint is all word q + 1 waits
// for.
__device__ inline void resolve_on_chip(const uint32_t* mask,
                                       const uint32_t* valid_bits,
                                       uint32_t* list, uint32_t* kept,
                                       int words, int last) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  uint32_t offset = 0;  // block_offset(q, words)
  uint32_t alive = valid_bits[0];
  for (int q = 0; q <= last; ++q) {
    const int len = block_len(q, words);
    const bool more = q < last;
    const uint32_t* row = mask + offset + lane * len;  // row 32q + lane
    const uint32_t t = row[0];                          // its word q
    const uint32_t t1 = more ? row[1] : 0u;  // its word q + 1 (len >= 2)
    uint32_t pulled[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int e = lane + 32 * u;
      pulled[u] = more && e < n ? mask[list[e] + q + 1] : 0u;
    }
    uint32_t acc = 0u;
    for (int e = lane + 512; more && e < n; e += 32) acc |= mask[list[e] + q + 1];
    uint32_t kb = 0u;
    if (alive) {
      kb = resolve_word(alive, t);
      if ((kb >> lane) & 1u) {
        list[n + __popc(kb & ((1u << lane) - 1u))] = offset + lane * len - q;
      }
      n += __popc(kb);
    }
    if (lane == 0) kept[q] = kb;
    if (more) {
#pragma unroll
      for (int u = 0; u < 16; ++u) acc |= pulled[u];
      acc |= (kb >> lane) & 1u ? t1 : 0u;
      alive = valid_bits[q + 1] & ~__reduce_or_sync(kFull, acc);
    }
    __syncwarp();  // the list entries, for the next word's loads
    offset += 32u * len;
  }
}

// The banded resolve, by one warp, from the ring: `removed` starts
// zeroed; once word q is resolved, lane l ORs its kept rows into its
// later words q + 1 + l, q + 33 + l, ... of `removed`, four rows' loads
// in flight (kb is the same in every lane, so the walk over its bits does
// not diverge; a repeated row ORs nothing new).
__device__ inline void resolve_banded(const Ring& ring,
                                      const uint32_t* valid_bits,
                                      uint32_t* removed, uint32_t* kept,
                                      int words, int last) {
  const int lane = threadIdx.x & 31;
  ring.start();
  for (int q = 0; q <= last; ++q) {
    const uint32_t* blk = ring.block(q);
    const int len = block_len(q, words);
    const uint32_t t = blk[lane * len];  // row 32q + lane's bits of word q
    const uint32_t alive = valid_bits[q] & ~removed[q];
    uint32_t kb = 0u;
    if (alive) {
      kb = resolve_word(alive, t);
      for (int w = q + 1 + lane; w <= last; w += 32) {
        const uint32_t* col = blk + (w - q);
        uint32_t acc = removed[w];
        uint32_t bits = kb;
        while (bits) {
          const int c0 = __ffs(bits) - 1;
          bits &= bits - 1u;
          const int c1 = bits ? __ffs(bits) - 1 : c0;
          bits &= bits - 1u;
          const int c2 = bits ? __ffs(bits) - 1 : c0;
          bits &= bits - 1u;
          const int c3 = bits ? __ffs(bits) - 1 : c0;
          bits &= bits - 1u;
          acc |= col[c0 * len] | col[c1 * len] | col[c2 * len] | col[c3 * len];
        }
        removed[w] = acc;
      }
    }
    if (lane == 0) kept[q] = kb;
    ring.release(q);
  }
}

// Block 0, after the mask phase: warp 0 resolves, then the block writes the
// keep bytes of image `img`.
template <bool kBanded>
__device__ void resolve_and_write(uint8_t* smem, const Layout& l,
                                  const uint32_t* scratch, int stages, int k,
                                  int n_valid, size_t img, uint8_t* keep_out) {
  const uint32_t* valid_bits = reinterpret_cast<const uint32_t*>(smem + l.valid);
  uint32_t* work = reinterpret_cast<uint32_t*>(smem + l.work);
  uint32_t* kept = reinterpret_cast<uint32_t*>(smem + l.kept);
  const int last = (n_valid - 1) >> 5;
  if (threadIdx.x < 32 && n_valid > 0) {
    if constexpr (kBanded) {
      const Ring ring{scratch + img * block_offset(l.words, l.words),
                      reinterpret_cast<uint32_t*>(smem + l.mask),
                      hopper::smem_u32(smem + l.bars), stages, l.words, last,
                      l.stage / 4};
      resolve_banded(ring, valid_bits, work, kept, l.words, last);
    } else {
      resolve_on_chip(reinterpret_cast<const uint32_t*>(smem + l.mask),
                      valid_bits, work, kept, l.words, last);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += kThreads) {
    keep_out[img * k + j] = j < n_valid && bit(kept, j);
  }
}

// Launches kernel on B clusters of `cluster` blocks with `smem` bytes of
// dynamic shared memory each; the function attributes are set on first
// use of each kernel.
template <typename... Args, typename... Given>
cudaError_t launch(void (*kernel)(Args...), int b, int cluster, int smem,
                   cudaStream_t stream, Given&&... args) {
  static std::mutex lock;
  static const void* ready[8];
  static int n_ready = 0;
  {
    std::lock_guard<std::mutex> hold(lock);
    const void* fn = reinterpret_cast<const void*>(kernel);
    bool found = false;
    for (int i = 0; i < n_ready; ++i) found |= ready[i] == fn;
    if (!found) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      if (n_ready < 8) ready[n_ready++] = fn;
    }
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Given>(args)...);
}

}  // namespace greedy
