// Content-defined chunking on Hopper: Gear scan + min/max cut select.
//
// Replaces the Pallas `_select_kernel` of hdrf_tpu/ops/cdc_pallas.py
// (pallas_call at cdc_pallas.py:476).  The TPU kernel walks the block as a
// sequential grid, carrying the hash history and the cut frontier across
// grid steps in scratch.  Here the work is split in two launches on one
// stream (ops/cdc_cuda.py has the design note):
//
//   cdc_scan_kernel    one thread per 256-byte run, all runs in parallel:
//                      Gear hash h = (h << 1) + G[b] warmed up on the 32
//                      bytes before the run (zero history == the window-32
//                      sum because G[0] == 0), the big-endian word image,
//                      and a candidate bitmap (bit i <=> pos1 == i + 1).
//   cdc_select_kernel  one thread block walks the frontier
//                      lo = f + min, hi = min(f + max, n), cut = first
//                      candidate in [lo, hi] else hi (the rule of
//                      hdrf_tpu/native/src/cdc.cpp:74-92) over a shared-
//                      memory window of the bitmap with a one-bit-per-word
//                      summary, writing the cut table and the two binned
//                      offset/length lane tables.
//
// Bound: the scan moves the block's bytes (read once, written once as
// words); the select is serial in the number of cuts and costs a few
// shared-memory reads and warp ballots per cut.
//
// A third kernel replaces the Pallas `_scan_kernel` of the same file
// (pallas_call at cdc_pallas.py:570, reached through
// `local_candidate_words_pallas`), the per-shard candidate scan of the
// sharded reduction (hdrf_tpu_torch/parallel/sharded.py):
//
//   cdc_shard_scan_kernel  the parallel scan above over one shard of a
//                      block, warmed up from the 31-byte halo (the previous
//                      shard's tail) for the shard's first run; candidate
//                      bitmap words with no `<= n` clamp and no min-chunk
//                      floor (only pos1 >= 32 of the whole block), plus the
//                      candidate count: a warp reduce and one atomicAdd
//                      per thread block.  Bound: bytes (the shard and halo
//                      read once, the bitmap written once).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRun = 256;            // bytes per scan thread (multiple of 32)
constexpr int kScanThreads = 256;    // == 256 Gear table entries
constexpr int kSelThreads = 256;
constexpr int kWin = 16384;          // bitmap words in the shared window
constexpr int kSum = kWin / 32;      // one summary bit per window word
constexpr int kTableHdr = 8;
constexpr int kHalo = 31;            // WINDOW - 1 bytes of shard history

__device__ __forceinline__ uint32_t fmix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

// Roll one little-endian word (4 bytes) into the hash.
__device__ __forceinline__ uint32_t roll_word(uint32_t h, uint32_t w,
                                              const uint32_t *g) {
#pragma unroll
  for (int b = 0; b < 4; ++b) h = (h << 1) + g[(w >> (8 * b)) & 0xFFu];
  return h;
}

// The Gear table in shared memory, one entry per thread (kScanThreads
// == 256); the caller synchronises.
__device__ __forceinline__ void load_gear_table(uint32_t *g) {
  g[threadIdx.x] = fmix32(threadIdx.x * 0x9E3779B1u);
}

// The hash after the 32 bytes at `p` (16-byte aligned), from zero history:
// the warm-up of a run that starts at p + 32.
__device__ __forceinline__ uint32_t warm32(const uint8_t *p,
                                           const uint32_t *g) {
  const uint4 *wp = reinterpret_cast<const uint4 *>(p);
  const uint4 v0 = wp[0], v1 = wp[1];
  uint32_t h = 0;
  h = roll_word(h, v0.x, g);
  h = roll_word(h, v0.y, g);
  h = roll_word(h, v0.z, g);
  h = roll_word(h, v0.w, g);
  h = roll_word(h, v1.x, g);
  h = roll_word(h, v1.y, g);
  h = roll_word(h, v1.z, g);
  h = roll_word(h, v1.w, g);
  return h;
}

__global__ void __launch_bounds__(kScanThreads)
cdc_scan_kernel(const uint8_t *__restrict__ data, int64_t n_pad, int64_t n,
                uint32_t mask, int64_t thr, uint32_t *__restrict__ words_be,
                uint32_t *__restrict__ bitmap) {
  __shared__ uint32_t g[256];
  load_gear_table(g);
  __syncthreads();

  const int64_t start =
      (static_cast<int64_t>(blockIdx.x) * kScanThreads + threadIdx.x) * kRun;
  if (start >= n_pad) return;

  // warm-up: the 32 bytes before the run
  uint32_t h = start >= 32 ? warm32(data + start - 32, g) : 0u;

  const uint4 *src = reinterpret_cast<const uint4 *>(data + start);
  uint4 *dst = reinterpret_cast<uint4 *>(words_be + start / 4);
  uint32_t bits = 0;
#pragma unroll 2
  for (int i = 0; i < kRun / 16; ++i) {
    const uint4 v = src[i];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint4 o;
    o.x = __byte_perm(v.x, 0, 0x0123);
    o.y = __byte_perm(v.y, 0, 0x0123);
    o.z = __byte_perm(v.z, 0, 0x0123);
    o.w = __byte_perm(v.w, 0, 0x0123);
    dst[i] = o;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        h = (h << 1) + g[(w[k] >> (8 * b)) & 0xFFu];
        const int r = i * 16 + k * 4 + b;           // byte within the run
        const int64_t pos1 = start + r + 1;
        const bool c = ((h & mask) == 0u) && pos1 >= thr && pos1 <= n;
        bits |= static_cast<uint32_t>(c) << (r & 31);
      }
    }
    if (i & 1) {  // 32 bytes done: one bitmap word
      bitmap[(start + i * 16 - 16) >> 5] = bits;
      bits = 0;
    }
  }
}

__global__ void __launch_bounds__(kScanThreads)
cdc_shard_scan_kernel(const uint8_t *__restrict__ local,
                      const uint8_t *__restrict__ halo, int64_t m,
                      int64_t base, uint32_t mask,
                      uint32_t *__restrict__ words,
                      int32_t *__restrict__ count) {
  __shared__ uint32_t g[256];
  __shared__ int warp_sum[kScanThreads / 32];
  load_gear_table(g);
  __syncthreads();

  const int64_t start =
      (static_cast<int64_t>(blockIdx.x) * kScanThreads + threadIdx.x) * kRun;
  int cnt = 0;
  if (start < m) {
    uint32_t h = 0;
    if (start >= 32) {
      h = warm32(local + start - 32, g);
    } else {  // the shard's first run: the halo is its history
      for (int i = 0; i < kHalo; ++i) h = (h << 1) + g[halo[i]];
    }
    const uint4 *src = reinterpret_cast<const uint4 *>(local + start);
    uint32_t bits = 0;
#pragma unroll 2
    for (int i = 0; i < kRun / 16; ++i) {
      const uint4 v = src[i];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          h = (h << 1) + g[(w[k] >> (8 * b)) & 0xFFu];
          const int r = i * 16 + k * 4 + b;         // byte within the run
          const int64_t pos1 = base + start + r + 1;  // in the whole block
          const bool c = ((h & mask) == 0u) && pos1 >= 32;
          bits |= static_cast<uint32_t>(c) << (r & 31);
        }
      }
      if (i & 1) {  // 32 bytes done: one bitmap word
        words[(start + i * 16 - 16) >> 5] = bits;
        cnt += __popc(bits);
        bits = 0;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < kScanThreads / 32; ++i) total += warp_sum[i];
    if (total) atomicAdd(count, total);
  }
}

__global__ void __launch_bounds__(kSelThreads)
cdc_select_kernel(const uint32_t *__restrict__ bitmap, int64_t nbm, int64_t n,
                  int64_t min_chunk, int64_t max_chunk, int32_t b_small,
                  int32_t *__restrict__ table, int32_t *__restrict__ ols,
                  int32_t *__restrict__ olb, int64_t cap) {
  extern __shared__ uint32_t smem[];
  uint32_t *win = smem;          // kWin bitmap words starting at word wb
  uint32_t *sum = smem + kWin;   // sum[s] bit l <=> win[32 s + l] != 0
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t full = 0xFFFFFFFFu;

  // Every warp runs the walk in lockstep on identical shared data, so the
  // window reloads (and their __syncthreads) are block-uniform.
  int64_t wb = -1;
  auto load = [&](int64_t base) {  // base: a multiple of 32 words
    __syncthreads();
    for (int i = threadIdx.x; i < kWin / 4; i += kSelThreads) {
      const int64_t w = base + 4 * static_cast<int64_t>(i);
      uint4 v;
      if (w + 4 <= nbm) {
        v = *reinterpret_cast<const uint4 *>(bitmap + w);
      } else {
        v.x = w < nbm ? bitmap[w] : 0u;
        v.y = w + 1 < nbm ? bitmap[w + 1] : 0u;
        v.z = w + 2 < nbm ? bitmap[w + 2] : 0u;
        v.w = w + 3 < nbm ? bitmap[w + 3] : 0u;
      }
      reinterpret_cast<uint4 *>(win)[i] = v;
    }
    __syncthreads();
    for (int s = warp; s < kSum; s += kSelThreads / 32) {
      const uint32_t nz = __ballot_sync(full, win[s * 32 + lane] != 0u);
      if (lane == 0) sum[s] = nz;
    }
    __syncthreads();
    wb = base;
  };

  // First set bit in [b0, b1] (bit i <=> pos1 i + 1), or -1.
  auto find = [&](int64_t b0, int64_t b1) -> int64_t {
    int64_t w = b0 >> 5;
    const int64_t wend = b1 >> 5;
    if (wb < 0 || w < wb || w >= wb + kWin) load(w & ~int64_t{31});
    const uint32_t x = win[w - wb] & (full << (b0 & 31));
    if (x) {
      const int64_t b = (w << 5) + __ffs(x) - 1;
      return b <= b1 ? b : -1;
    }
    ++w;
    while (w <= wend) {
      if (w >= wb + kWin) load(w & ~int64_t{31});
      const int64_t rel = w - wb;
      const int64_t s0 = rel >> 5;
      const int64_t s = s0 + lane;
      uint32_t sw = s < kSum ? sum[s] : 0u;
      if (lane == 0) sw &= full << (rel & 31);
      const uint32_t any = __ballot_sync(full, sw != 0u);
      if (any) {
        const int l = __ffs(any) - 1;
        const uint32_t swl = __shfl_sync(full, sw, l);
        const int64_t wi = wb + ((s0 + l) << 5) + (__ffs(swl) - 1);
        if (wi > wend) return -1;
        const int64_t b = (wi << 5) + __ffs(win[wi - wb]) - 1;
        return b <= b1 ? b : -1;
      }
      w = wb + ((s0 + 32) << 5);
      if (w > wb + kWin) w = wb + kWin;
    }
    return -1;
  };

  int64_t f = 0, nc = 0, ns = 0, nbg = 0;
  while (f < n) {
    const int64_t lo = f + min_chunk;
    const int64_t hi = f + max_chunk < n ? f + max_chunk : n;
    int64_t cut = hi;
    if (lo <= hi) {
      const int64_t b = find(lo - 1, hi - 1);
      if (b >= 0) cut = b + 1;
    }
    const int64_t len = cut - f;
    const bool small = (len + 9 + 63) / 64 <= b_small;
    if (threadIdx.x == 0 && nc < cap) {
      table[kTableHdr + nc] = static_cast<int32_t>(cut);
      if (small) {
        ols[ns] = static_cast<int32_t>(f);
        ols[cap + ns] = static_cast<int32_t>(len);
      } else {
        olb[nbg] = static_cast<int32_t>(f);
        olb[cap + nbg] = static_cast<int32_t>(len);
      }
    }
    ++nc;
    if (small) ++ns; else ++nbg;
    f = cut;
  }
  if (threadIdx.x == 0) {
    table[0] = static_cast<int32_t>(nc);
    table[1] = nc > cap ? 1 : 0;  // unreachable: cap is the hard bound
    table[2] = static_cast<int32_t>(ns);
    table[3] = static_cast<int32_t>(nbg);
    for (int i = 4; i < kTableHdr; ++i) table[i] = 0;
  }
}

}  // namespace

// The scan: block bytes -> big-endian word image + candidate bitmap.
extern "C" int hdrf_cdc_scan(const void *data, int64_t n_pad, int64_t n,
                             uint32_t mask, int64_t min_chunk, void *words_be,
                             void *bitmap, void *stream) {
  const int64_t threads = n_pad / kRun;
  const int64_t thr = min_chunk > 32 ? min_chunk : 32;
  const unsigned blocks =
      static_cast<unsigned>((threads + kScanThreads - 1) / kScanThreads);
  cdc_scan_kernel<<<blocks, kScanThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t *>(data), n_pad, n, mask, thr,
      static_cast<uint32_t *>(words_be), static_cast<uint32_t *>(bitmap));
  return static_cast<int>(cudaGetLastError());
}

// The select: candidate bitmap -> cut table + the two binned lane tables.
extern "C" int hdrf_cdc_select(const void *bitmap, int64_t nbm, int64_t n,
                               int64_t min_chunk, int64_t max_chunk,
                               int32_t b_small, void *table, void *ols,
                               void *olb, int64_t cap, void *stream) {
  const size_t smem = (kWin + kSum) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      cdc_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cdc_select_kernel<<<1, kSelThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t *>(bitmap), nbm, n, min_chunk, max_chunk,
      b_small, static_cast<int32_t *>(table), static_cast<int32_t *>(ols),
      static_cast<int32_t *>(olb), cap);
  return static_cast<int>(cudaGetLastError());
}

// The shard scan: shard bytes + halo -> candidate bitmap words + count.
extern "C" int hdrf_cdc_shard_scan(const void *local, const void *halo,
                                   int64_t m, int64_t base, uint32_t mask,
                                   void *words, void *count, void *stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t threads = m / kRun;
  const unsigned blocks =
      static_cast<unsigned>((threads + kScanThreads - 1) / kScanThreads);
  cdc_shard_scan_kernel<<<blocks, kScanThreads, 0, s>>>(
      static_cast<const uint8_t *>(local), static_cast<const uint8_t *>(halo),
      m, base, mask, static_cast<uint32_t *>(words),
      static_cast<int32_t *>(count));
  return static_cast<int>(cudaGetLastError());
}
