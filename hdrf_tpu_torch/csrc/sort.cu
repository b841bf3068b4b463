// The LZ4 match scan's two device stages on Hopper: per-position match
// deltas and the per-row key/value sort.
//
// Replaces the two Pallas kernels of hdrf_tpu/ops/sort_pallas.py
// (ops/sort_cuda.py has the design note):
//
//   match_deltas_kernel  `_match_deltas_call` (pallas_call at
//                        sort_pallas.py:273).  For each position p of a
//                        row, q = the latest position < p with the same
//                        hash16 of its 4-gram; delta(p) = (p - q) * stride
//                        when the grams are equal, not degenerate
//                        (v != rotl8(v)) and the product is <= 65535, else
//                        0; output in position order.  The TPU sorts
//                        (hash16 << pos_bits | pos) keys and sorts back;
//                        a row of 65,536 keys does not fit one block's
//                        shared memory, so here one block per row keeps a
//                        65,536-entry table "latest position + 1 of each
//                        hash" (u16, 128 KiB) in shared memory.  Warp 0
//                        walks the row in position order, 32 positions a
//                        step: __match_any_sync finds earlier lanes of the
//                        same hash, the table covers earlier steps, and the
//                        last lane of each hash group updates the table.
//                        Then all threads compare the grams (re-read by
//                        position) and write the deltas.  Exactly the
//                        sorted-neighbour relation, without a sort.
//   sort_*_kernel        `_sort_rows_call` (pallas_call at
//                        sort_pallas.py:148).  A bitonic network over rows
//                        padded to a power of two with the caller's
//                        sentinel: rows of up to kTile entries sort in one
//                        block's shared memory (key + 2 values of 8,192
//                        entries = 96 KiB, dynamic shared memory); longer
//                        rows sort kTile-entry tiles in shared memory, then
//                        merge with one global-memory launch per stage
//                        stride >= kTile and one shared-memory launch for
//                        the strides below it.  u32 keys are biased by
//                        0x80000000 on load and unbiased on the final
//                        store, so signed compares give unsigned order.
//                        Equal keys never exchange (the network is not
//                        stable; callers tie only on dead slots).
//
// Bound: bytes for both — each row read once and written once — against
// which the bitonic network re-reads its tile log2(e)^2 / 2 times in
// shared memory and the match walk is serial in a row's positions.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 8192;        // row entries one block sorts in shared
constexpr int kHashes = 1 << 16;   // hash16 range: the match table's size
constexpr int kUnroll = 16;        // match-walk steps loaded ahead
constexpr int kStepThreads = 256;

// ------------------------------------------------------------ match deltas

__device__ __forceinline__ int64_t entry_of(int64_t p, int64_t half,
                                            int stride) {
  // stride 2 rows hold [even positions..., odd positions...]
  return stride == 2 ? ((p & 1) ? half + (p >> 1) : (p >> 1)) : p;
}

__global__ void __launch_bounds__(kThreads)
match_deltas_kernel(const uint32_t *__restrict__ vals, int64_t e, int stride,
                    uint32_t *__restrict__ out) {
  // latest position + 1 of each hash; 0 = none yet
  extern __shared__ __align__(16) uint16_t last[];
  const uint32_t *v = vals + blockIdx.x * e;
  uint32_t *d = out + blockIdx.x * e;
  const int64_t half = e / 2;
  uint32_t *last32 = reinterpret_cast<uint32_t *>(last);
  for (int i = threadIdx.x; i < kHashes / 2; i += kThreads) last32[i] = 0u;
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const uint32_t below = (1u << lane) - 1u;
    uint32_t cur[kUnroll], nxt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = 32 * u + lane;
      cur[u] = p < e ? v[entry_of(p, half, stride)] : 0u;
    }
    for (int64_t base = 0; base < e; base += 32 * kUnroll) {
      const int64_t nb = base + 32 * kUnroll;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // the next steps' loads in flight
        const int64_t p = nb + 32 * u + lane;
        nxt[u] = p < e ? v[entry_of(p, half, stride)] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t s = base + 32 * u;
        const int64_t p = s + lane;
        const bool live = p < e;
        // lanes past the row get keys outside the 16-bit range: no peers
        const uint32_t h = live ? (cur[u] * 2654435761u) >> 16
                                : 0x10000u + lane;
        const uint32_t peers = __match_any_sync(0xFFFFFFFFu, h);
        const uint32_t lower = peers & below;
        uint32_t q1 = 0u;
        if (lower) {
          q1 = static_cast<uint32_t>(s + (31 - __clz(lower)) + 1);
        } else if (live) {
          q1 = last[h];
        }
        __syncwarp();  // every read of last[h] before its update
        // the group's highest lane records it for later steps; the final
        // step's positions are never read again (and p + 1 may be 65536)
        if (live && (peers >> lane) == 1u && s + 32 < e) {
          last[h] = static_cast<uint16_t>(p + 1);
        }
        __syncwarp();
        if (live) d[p] = q1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
    }
  }
  __syncthreads();  // the walk's writes to d are visible to the block

  for (int64_t p = threadIdx.x; p < e; p += kThreads) {
    const uint32_t q1 = d[p];
    uint32_t delta = 0u;
    if (q1) {
      const int64_t q = q1 - 1;
      const uint32_t vp = v[entry_of(p, half, stride)];
      const uint32_t vq = v[entry_of(q, half, stride)];
      const uint32_t rot = (vp << 8) | (vp >> 24);
      const uint32_t dd = static_cast<uint32_t>(p - q) *
                          static_cast<uint32_t>(stride);
      if (vp == vq && vp != rot && dd <= 65535u) delta = dd;
    }
    d[p] = delta;
  }
}

// --------------------------------------------------------------- row sort

// One compare-exchange: ascending pairs take the smaller key low; equal
// keys stay where they are.
template <int NV>
__device__ __forceinline__ void cx(int32_t *k, uint32_t *v0, uint32_t *v1,
                                   int64_t i, int64_t l, bool asc) {
  const int32_t a = k[i], b = k[l];
  if (asc ? (a > b) : (a < b)) {
    k[i] = b;
    k[l] = a;
    const uint32_t t0 = v0[i];
    v0[i] = v0[l];
    v0[l] = t0;
    if constexpr (NV == 2) {
      const uint32_t t1 = v1[i];
      v1[i] = v1[l];
      v1[l] = t1;
    }
  }
}

// Bitonic stages (k, j) for k in [k0, k1], j from j0 (first k) or k / 2,
// over one tile of `tile` entries of a padded row of width E held in
// shared memory.  The direction of a pair follows its index in the row,
// so tiles sorted here are the alternating runs the next merge needs.
// With `first`, the tile loads from the caller's rows (width e, padded
// with the sentinel past e) and biases the keys; otherwise from the
// working rows.  With `last`, keys are unbiased on the store.
template <int NV>
__global__ void __launch_bounds__(kThreads)
sort_tile_kernel(const int32_t *__restrict__ kin,
                 const uint32_t *__restrict__ v0in,
                 const uint32_t *__restrict__ v1in, int64_t e,
                 int32_t *__restrict__ kout, uint32_t *__restrict__ v0out,
                 uint32_t *__restrict__ v1out, int64_t E, int tile, int64_t k0,
                 int64_t k1, int64_t j0, int32_t bias, int32_t pad_key,
                 uint32_t pad_v0, uint32_t pad_v1, int first, int last) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t *sk = smem;
  uint32_t *s0 = reinterpret_cast<uint32_t *>(smem + tile);
  uint32_t *s1 = s0 + tile;
  const int64_t tiles_per_row = E / tile;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t t0 = (blockIdx.x % tiles_per_row) * tile;  // index in row
  int32_t *ko = kout + row * E + t0;
  uint32_t *o0 = v0out + row * E + t0;
  uint32_t *o1 = NV == 2 ? v1out + row * E + t0 : nullptr;

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    if (first) {
      const int64_t g = t0 + i;
      const bool live = g < e;
      sk[i] = (live ? kin[row * e + g] : pad_key) ^ bias;
      s0[i] = live ? v0in[row * e + g] : pad_v0;
      if constexpr (NV == 2) s1[i] = live ? v1in[row * e + g] : pad_v1;
    } else {
      sk[i] = ko[i];
      s0[i] = o0[i];
      if constexpr (NV == 2) s1[i] = o1[i];
    }
  }
  __syncthreads();
  for (int64_t k = k0; k <= k1; k <<= 1) {
    for (int64_t j = (k == k0 ? j0 : k >> 1); j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
        const int64_t i = 2 * p - (p & (j - 1));
        cx<NV>(sk, s0, s1, i, i + j, ((t0 + i) & k) == 0);
      }
      __syncthreads();
    }
  }
  const int32_t unbias = last ? bias : 0;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    ko[i] = sk[i] ^ unbias;
    o0[i] = s0[i];
    if constexpr (NV == 2) o1[i] = s1[i];
  }
}

// One global-memory bitonic stage (k, j), j >= tile, over all rows.
template <int NV>
__global__ void __launch_bounds__(kStepThreads)
sort_step_kernel(int32_t *__restrict__ key, uint32_t *__restrict__ v0,
                 uint32_t *__restrict__ v1, int64_t rows, int64_t E,
                 int64_t k, int64_t j) {
  const int64_t half = E / 2;
  const int64_t pairs = rows * half;
  for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       p < pairs; p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = p / half;
    const int64_t q = p % half;
    const int64_t i = 2 * q - (q & (j - 1));
    const int64_t base = row * E;
    cx<NV>(key + base, v0 + base, NV == 2 ? v1 + base : nullptr, i, i + j,
           (i & k) == 0);
  }
}

template <int NV>
int sort_rows(const void *kin, const void *v0in, const void *v1in,
              int64_t t, int64_t e, int64_t E, int key_unsigned,
              int32_t pad_key, uint32_t pad_v0, uint32_t pad_v1, void *kout,
              void *v0out, void *v1out, cudaStream_t stream) {
  const int tile = static_cast<int>(E < kTile ? E : kTile);
  const int threads = tile / 2 < kThreads ? (tile / 2 > 32 ? tile / 2 : 32)
                                          : kThreads;
  const size_t smem = static_cast<size_t>(tile) * 4u * (1 + NV);
  cudaError_t err = cudaFuncSetAttribute(
      sort_tile_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t bias = key_unsigned ? INT32_MIN : 0;
  auto ki = static_cast<const int32_t *>(kin);
  auto a0 = static_cast<const uint32_t *>(v0in);
  auto a1 = static_cast<const uint32_t *>(v1in);
  auto ko = static_cast<int32_t *>(kout);
  auto b0 = static_cast<uint32_t *>(v0out);
  auto b1 = static_cast<uint32_t *>(v1out);
  const unsigned blocks = static_cast<unsigned>(t * (E / tile));
  // tiles: every stage up to k = tile
  sort_tile_kernel<NV><<<blocks, threads, smem, stream>>>(
      ki, a0, a1, e, ko, b0, b1, E, tile, 2, tile, 1, bias, pad_key, pad_v0,
      pad_v1, 1, E == tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int64_t k = 2LL * tile; k <= E; k <<= 1) {
    for (int64_t j = k >> 1; j >= tile; j >>= 1) {
      const int64_t pairs = t * (E / 2);
      int64_t g = (pairs + kStepThreads - 1) / kStepThreads;
      if (g > 132 * 64) g = 132 * 64;
      sort_step_kernel<NV><<<static_cast<unsigned>(g), kStepThreads, 0,
                             stream>>>(ko, b0, b1, t, E, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
    }
    sort_tile_kernel<NV><<<blocks, threads, smem, stream>>>(
        ki, a0, a1, e, ko, b0, b1, E, tile, k, k, tile / 2, bias, pad_key,
        pad_v0, pad_v1, 0, k == E);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" int hdrf_match_deltas(const void *vals, int64_t t, int64_t e,
                                 int32_t stride, void *out, void *stream) {
  const size_t smem = kHashes * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      match_deltas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  match_deltas_kernel<<<static_cast<unsigned>(t), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t *>(vals), e, stride,
      static_cast<uint32_t *>(out));
  return static_cast<int>(cudaGetLastError());
}

// Sort t rows of e entries (key + n_val carried 32-bit values) into
// outputs of width E (e padded to a power of two).
extern "C" int hdrf_sort_rows(const void *key, const void *v0,
                              const void *v1, int32_t n_val, int64_t t,
                              int64_t e, int64_t E, int32_t key_unsigned,
                              int32_t pad_key, uint32_t pad_v0,
                              uint32_t pad_v1, void *kout, void *v0out,
                              void *v1out, void *stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n_val == 1)
    return sort_rows<1>(key, v0, v1, t, e, E, key_unsigned, pad_key, pad_v0,
                        pad_v1, kout, v0out, v1out, s);
  return sort_rows<2>(key, v0, v1, t, e, E, key_unsigned, pad_key, pad_v0,
                      pad_v1, kout, v0out, v1out, s);
}
