// The LZ4 match scan's two device stages on Hopper: per-position match
// deltas and the per-row key/value sort.
//
// Replaces the two Pallas kernels of hdrf_tpu/ops/sort_pallas.py
// (ops/sort_cuda.py has the design note):
//
//   match_tile_kernel +  `_match_deltas_call` (pallas_call at
//   match_look_kernel    sort_pallas.py:273).  For each position p of a
//                        row, q = the latest position < p with the same
//                        hash16 of its 4-gram; delta(p) = (p - q) * stride
//                        when the grams are equal, not degenerate
//                        (v != rotl8(v)) and the product is <= 65535, else
//                        0; output in position order.  The TPU sorts
//                        (hash16 << pos_bits | pos) keys and sorts back.
//                        Only q >= p - 65535 / stride can give a delta,
//                        so the row is cut into tiles of 8,192 positions
//                        and each is answered from itself and the few
//                        tiles before it.  (1) One block per tile: a
//                        stable radix sort of the tile by hash16 (the
//                        machinery of sort_tile_kernel); a left neighbour
//                        of the same hash is q, and the gram compare,
//                        degenerate test and cap are done there, once.
//                        The tile's summary goes to scratch: a 65,536-bit
//                        hash bitmap with a running count of distinct
//                        hashes per word, and per distinct hash its first
//                        and last slot.  (2) One block per later tile: the
//                        first position of each hash looks back through
//                        the tiles that reach into its window (4 at stride
//                        2, 2 at stride 4), nearest first, one shared-
//                        memory bitmap probe each; the first tile holding
//                        the hash gives q as its last slot (bitmap rank).
//                        The result is the serial relation exactly, for
//                        any tile width.
//   sort_tile_kernel +   `_sort_rows_call` (pallas_call at
//   sort_merge_kernel    sort_pallas.py:148).  A stable sort: equal keys
//                        keep their input order, as torch.sort(stable=True)
//                        does.  Keys are mapped to u32 order (signed keys
//                        xor 0x80000000) on load and back on the final
//                        store.  Rows are padded to a power of two E with
//                        the caller's sentinel, past every live slot, so a
//                        pad slot stays after a live key equal to it.
//                        (1) One block per tile of min(E, 8,192) entries:
//                        an LSD radix sort in shared memory.  A block OR
//                        of key ^ key[0] finds the bits that vary in the
//                        tile, and only those are sorted, in passes of at
//                        most 8 bits (row-local indices 0..8192, the L1
//                        and L2 pack keys: 14 bits, two 7-bit passes).  A
//                        pass ranks each warp's entries in position order
//                        with __match_any_sync and a per-warp digit
//                        counter, scans the (digit, warp) counts, and
//                        scatters key and source slot; the carried values
//                        follow the source slots once, after the last pass.
//                        (2) Rows longer than a tile: log2(E / 8,192)
//                        merge passes, one launch each over all rows.  A
//                        block makes a fixed 2,048-entry slice of output:
//                        a merge-path search on its diagonals splits the
//                        two input runs (ties taken from the left run:
//                        stable), the slice is staged in shared memory and
//                        every thread merges 8 entries.
//
// Bound: bytes for both — each row read once and written once — against
// which the radix sort moves its tile through shared memory once per
// pass, a merge pass reads and writes the row once more, and the match
// deltas sort each tile by hash (two 8-bit passes on most data) and write
// a summary of up to 80 KiB a tile that the look-back reads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHashes = 1 << 16;   // hash16 range

constexpr int kTile = 8192;        // row entries one block radix-sorts
constexpr int kTileThreads = 512;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kPerThread = kTile / kTileThreads;   // 16 entries a thread
constexpr int kRadixMax = 256;     // 8-bit digits at most
constexpr int kCounters = (kRadixMax + 1) * kTileWarps;  // + pad bucket
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 8;
constexpr int kSlice = kMergeThreads * kMergeItems;      // 2,048 entries

// --------------------------------------------------------------- row sort

// Exclusive scan, in place, of the first n counters, by the whole block
// (kTileThreads threads; each sums a contiguous run, then a warp scan and
// a scan of the warp totals).
__device__ __forceinline__ void scan_counters(uint32_t *cnt, int n,
                                              uint32_t *part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n + kTileThreads - 1) / kTileThreads;
  const int b = threadIdx.x * per;
  uint32_t own = 0;
  for (int i = 0; i < per; ++i)
    if (b + i < n) own += cnt[b + i];
  uint32_t x = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const uint32_t p = lane < kTileWarps ? part[lane] : 0u;
    uint32_t q = p;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, q, o);
      if (lane >= o) q += y;
    }
    if (lane < kTileWarps) part[lane] = q - p;
  }
  __syncthreads();
  uint32_t run = part[warp] + x - own;
  for (int i = 0; i < per; ++i) {
    if (b + i < n) {
      const uint32_t c = cnt[b + i];
      cnt[b + i] = run;
      run += c;
    }
  }
  __syncthreads();
}

// Stable radix sort of one tile of T = min(E, kTile) entries of a row of
// the caller's width e, padded to E.  Thread `lane` of warp w holds the
// entries at positions w * 32 * kPerThread + k * 32 + lane (warp-striped,
// so a warp's entries are in position order step by step); positions past
// T (a row narrower than kTile) rank in an extra digit after every real
// one and are never stored.  Keys are stored xor `unflip`.
template <int NV>
__global__ void __launch_bounds__(kTileThreads, 2)
sort_tile_kernel(const uint32_t *__restrict__ kin,
                 const uint32_t *__restrict__ v0in,
                 const uint32_t *__restrict__ v1in, int64_t e, int64_t E,
                 int T, uint32_t flip, uint32_t pad_key, uint32_t pad_v0,
                 uint32_t pad_v1, uint32_t unflip, uint32_t *__restrict__ kout,
                 uint32_t *__restrict__ v0out, uint32_t *__restrict__ v1out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t *sk = smem;                                    // kTile keys
  uint16_t *sp = reinterpret_cast<uint16_t *>(smem + kTile);  // slots
  uint32_t *cnt = smem + kTile + kTile / 2;               // kCounters
  __shared__ uint32_t part[kTileWarps];
  __shared__ uint32_t ref, diff;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t lt = (1u << lane) - 1u;
  const int64_t tiles = E / T;
  const int64_t row = blockIdx.x / tiles;
  const int64_t t0 = (blockIdx.x % tiles) * T;
  const uint32_t *krow = kin + row * e;
  const int base = warp * 32 * kPerThread + lane;

  uint32_t u[kPerThread];   // keys in u32 order
  uint32_t rp[kPerThread];  // rank << 16 | source slot
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int p = base + 32 * k;
    const int64_t g = t0 + p;
    u[k] = (p < T ? (g < e ? krow[g] : pad_key) : 0u) ^ flip;
    rp[k] = static_cast<uint32_t>(p);
  }
  if (threadIdx.x == 0) {
    ref = u[0];
    diff = 0u;
  }
  __syncthreads();
  uint32_t d_own = 0u;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    if (base + 32 * k < T) d_own |= u[k] ^ ref;
  d_own = __reduce_or_sync(0xFFFFFFFFu, d_own);
  if (lane == 0 && d_own) atomicOr(&diff, d_own);
  __syncthreads();

  // only the bits that vary in the tile are sorted
  const uint32_t dv = diff;
  int lo = 0, bits = 0, npass = 0;
  if (dv) {
    lo = __ffs(dv) - 1;
    const int nb = 32 - __clz(dv) - lo;
    npass = (nb + 7) / 8;
    bits = (nb + npass - 1) / npass;
  }
  const uint32_t radix = 1u << bits;
  const int n_cnt = static_cast<int>(radix + 1) * kTileWarps;

  for (int pass = 0; pass < npass; ++pass) {
    const int shift = lo + pass * bits;
    for (int i = threadIdx.x; i < n_cnt; i += kTileThreads) cnt[i] = 0u;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const uint32_t d = base + 32 * k < T ? (u[k] >> shift) & (radix - 1u)
                                           : radix;
      const uint32_t peers = __match_any_sync(0xFFFFFFFFu, d);
      const int leader = __ffs(peers) - 1;
      uint32_t before = 0u;
      if (lane == leader) {
        uint32_t *c = cnt + d * kTileWarps + warp;
        before = *c;
        *c = before + __popc(peers);
      }
      before = __shfl_sync(0xFFFFFFFFu, before, leader);
      rp[k] = ((before + __popc(peers & lt)) << 16) | (rp[k] & 0xFFFFu);
      __syncwarp();
    }
    __syncthreads();
    scan_counters(cnt, n_cnt, part);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (base + 32 * k < T) {
        const uint32_t d = (u[k] >> shift) & (radix - 1u);
        const uint32_t r = cnt[d * kTileWarps + warp] + (rp[k] >> 16);
        sk[r] = u[k];
        sp[r] = static_cast<uint16_t>(rp[k]);
      }
    }
    __syncthreads();
    if (pass + 1 < npass) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int p = base + 32 * k;
        if (p < T) {
          u[k] = sk[p];
          rp[k] = sp[p];
        }
      }
    }
  }
  if (npass == 0) {  // every key equal: the input order is sorted
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int p = base + 32 * k;
      if (p < T) {
        sk[p] = u[k];
        sp[p] = static_cast<uint16_t>(p);
      }
    }
    __syncthreads();
  }

  const int64_t o = row * E + t0;
  for (int i = threadIdx.x; i < T; i += kTileThreads)
    kout[o + i] = sk[i] ^ unflip;
  // each carried value: the tile to shared memory, then out by source slot
  for (int j = 0; j < NV; ++j) {
    const uint32_t *vrow = (j == 0 ? v0in : v1in) + row * e;
    const uint32_t pad = j == 0 ? pad_v0 : pad_v1;
    uint32_t *vout = (j == 0 ? v0out : v1out) + o;
    __syncthreads();
    for (int i = threadIdx.x; i < T; i += kTileThreads) {
      const int64_t g = t0 + i;
      sk[i] = g < e ? vrow[g] : pad;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < T; i += kTileThreads) vout[i] = sk[sp[i]];
  }
}

// Entries of run a taken among the first d of the stable merge of a and b
// (ties from a first).
template <typename P>
__device__ __forceinline__ int64_t merge_path(P a, int64_t na, P b,
                                              int64_t nb, int64_t d) {
  int64_t lo = d > nb ? d - nb : 0;
  int64_t hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The same by a whole warp in device memory: 32 probes a step, so a
// 2^18-entry run takes 4 dependent loads instead of 18.
__device__ int64_t warp_merge_path(const uint32_t *__restrict__ a, int64_t na,
                                   const uint32_t *__restrict__ b, int64_t nb,
                                   int64_t d) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d > nb ? d - nb : 0;
  int64_t hi = d < na ? d : na;
  while (hi - lo > 32) {
    const int64_t span = hi - lo;
    const int64_t mid = lo + span * (lane + 1) / 33;  // inside [lo, hi)
    const int t = __popc(__ballot_sync(0xFFFFFFFFu, a[mid] <= b[d - 1 - mid]));
    const int64_t nlo = t ? lo + span * t / 33 + 1 : lo;
    hi = t < 32 ? lo + span * (t + 1) / 33 : hi;
    lo = nlo;
  }
  const int64_t mid = lo + lane;
  const bool take = mid < hi && a[mid] <= b[d - 1 - mid];
  return lo + __popc(__ballot_sync(0xFFFFFFFFu, take));
}

// One merge pass over all rows: sorted runs of width w (u32 keys) merge
// pairwise into runs of 2w.  Block = one kSlice-entry slice of output.
template <int NV>
__global__ void __launch_bounds__(kMergeThreads)
sort_merge_kernel(const uint32_t *__restrict__ kin,
                  const uint32_t *__restrict__ v0in,
                  const uint32_t *__restrict__ v1in, int64_t E, int64_t w,
                  uint32_t unflip, uint32_t *__restrict__ kout,
                  uint32_t *__restrict__ v0out,
                  uint32_t *__restrict__ v1out) {
  __shared__ uint32_t sk[kSlice];
  __shared__ uint32_t s0[kSlice];
  __shared__ uint32_t s1[NV == 2 ? kSlice : 1];
  __shared__ int64_t split[2];
  const int64_t slices = E / kSlice;
  const int64_t row = blockIdx.x / slices;
  const int64_t at = (blockIdx.x % slices) * kSlice;  // output index in row
  const int64_t pair = at / (2 * w);
  const int64_t base = row * E + pair * 2 * w;         // run a, then run b
  const int64_t d0 = at - pair * 2 * w;
  if (threadIdx.x < 64) {  // warp 0: the slice's start, warp 1: its end
    const int64_t at_d = warp_merge_path(kin + base, w, kin + base + w, w,
                                         d0 + (threadIdx.x >> 5) * kSlice);
    if ((threadIdx.x & 31) == 0) split[threadIdx.x >> 5] = at_d;
  }
  __syncthreads();
  const int64_t i0 = split[0];
  const int64_t j0 = d0 - i0;
  const int na = static_cast<int>(split[1] - i0);
  const int nb = kSlice - na;
  for (int x = threadIdx.x; x < kSlice; x += kMergeThreads) {
    const int64_t src = base + (x < na ? i0 + x : w + j0 + (x - na));
    sk[x] = kin[src];
    s0[x] = v0in[src];
    if constexpr (NV == 2) s1[x] = v1in[src];
  }
  __syncthreads();
  const int dt = threadIdx.x * kMergeItems;
  int ia = static_cast<int>(merge_path(sk, na, sk + na, nb, dt));
  int ib = dt - ia;
  uint32_t ok[kMergeItems], o0[kMergeItems], o1[kMergeItems];
#pragma unroll
  for (int k = 0; k < kMergeItems; ++k) {
    const bool take_a = ia < na && (ib >= nb || sk[ia] <= sk[na + ib]);
    const int src = take_a ? ia++ : na + ib++;
    ok[k] = sk[src];
    o0[k] = s0[src];
    if constexpr (NV == 2) o1[k] = s1[src];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kMergeItems; ++k) {
    sk[dt + k] = ok[k];
    s0[dt + k] = o0[k];
    if constexpr (NV == 2) s1[dt + k] = o1[k];
  }
  __syncthreads();
  const int64_t o = row * E + at;
  for (int x = threadIdx.x; x < kSlice; x += kMergeThreads) {
    kout[o + x] = sk[x] ^ unflip;
    v0out[o + x] = s0[x];
    if constexpr (NV == 2) v1out[o + x] = s1[x];
  }
}

template <int NV>
int sort_rows(const void *kin, const void *v0in, const void *v1in,
              int64_t t, int64_t e, int64_t E, int key_unsigned,
              uint32_t pad_key, uint32_t pad_v0, uint32_t pad_v1, void *kout,
              void *v0out, void *v1out, void *kscr, void *v0scr, void *v1scr,
              cudaStream_t stream) {
  const int T = static_cast<int>(E < kTile ? E : kTile);
  int passes = 0;
  for (int64_t w = T; w < E; w <<= 1) ++passes;
  const size_t smem = (kTile + kTile / 2 + kCounters) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sort_tile_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint32_t flip = key_unsigned ? 0u : 0x80000000u;
  uint32_t *out[3] = {static_cast<uint32_t *>(kout),
                      static_cast<uint32_t *>(v0out),
                      static_cast<uint32_t *>(v1out)};
  uint32_t *scr[3] = {static_cast<uint32_t *>(kscr),
                      static_cast<uint32_t *>(v0scr),
                      static_cast<uint32_t *>(v1scr)};
  // ping-pong so that the last pass lands in the outputs
  uint32_t **src = passes % 2 ? scr : out;
  uint32_t **dst = passes % 2 ? out : scr;
  sort_tile_kernel<NV><<<static_cast<unsigned>(t * (E / T)), kTileThreads,
                         smem, stream>>>(
      static_cast<const uint32_t *>(kin), static_cast<const uint32_t *>(v0in),
      static_cast<const uint32_t *>(v1in), e, E, T, flip, pad_key, pad_v0,
      pad_v1, passes ? 0u : flip, src[0], src[1], src[2]);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int64_t w = T; w < E; w <<= 1) {
    sort_merge_kernel<NV><<<static_cast<unsigned>(t * (E / kSlice)),
                            kMergeThreads, 0, stream>>>(
        src[0], src[1], src[2], E, w, 2 * w == E ? flip : 0u, dst[0], dst[1],
        dst[2]);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    uint32_t **tmp = src;
    src = dst;
    dst = tmp;
  }
  return 0;
}

// ------------------------------------------------------------ match deltas

constexpr int kHashWords = kHashes / 32;   // a tile's hash bitmap: 2,048
// Digit counters of the hash sort, (digit, warp) in scan order with one
// pad word a digit: a warp's counters for 32 different digits (random
// hashes) then fall in 32 different banks, not two.
constexpr int kCntStride = kTileWarps + 1;
constexpr int kMatchCounters = (kRadixMax + 1) * kCntStride;
constexpr int kLookThreads = 512;
constexpr int kLookBatch = 4;      // look-ups a thread keeps in flight

__device__ __forceinline__ int64_t entry_of(int64_t p, int64_t half,
                                            int stride) {
  // stride 2 rows hold [even positions..., odd positions...]
  return stride == 2 ? ((p & 1) ? half + (p >> 1) : (p >> 1)) : p;
}

__device__ __forceinline__ uint32_t hash16(uint32_t v) {
  return (v * 2654435761u) >> 16;
}

__device__ __forceinline__ bool degenerate(uint32_t v) {
  return v == ((v << 8) | (v >> 24));
}

// Rank of hash h among the distinct hashes of a tile, from its bitmap word
// and the count of distinct hashes before that word.
__device__ __forceinline__ uint32_t hash_rank(uint32_t bits, uint32_t before,
                                              uint32_t h) {
  return before + __popc(bits & ((1u << (h & 31)) - 1u));
}

// Phase 1, one block per tile of kTile positions of a row.  The tile's
// positions are radix-sorted by hash16 in shared memory (stable: equal
// hashes stay in position order, the sort of sort_tile_kernel over only
// the hash bits that vary in the tile); a position whose left neighbour in
// sorted order has its hash takes that neighbour as q, compares the grams
// and writes its delta.  The first position of each hash in the tile
// writes 0 and is left to phase 2.  The tile's summary goes to scratch:
// its hash bitmap with, per bitmap word, the count of distinct hashes
// before it (so a hash's rank is one popcount away), and per rank the
// first and the last tile slot holding that hash and the first slot's
// gram.
__global__ void __launch_bounds__(kTileThreads, 2)
match_tile_kernel(const uint32_t *__restrict__ vals, int64_t e, int stride,
                  int tiles, uint32_t *__restrict__ d, uint2 *__restrict__ bp,
                  uint32_t *__restrict__ fv, uint16_t *__restrict__ first,
                  uint16_t *__restrict__ last) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t *vs = smem;               // the tile's grams in position order
  uint32_t *sk = smem + kTile;       // sorted hash << 16 | slot
  uint32_t *cnt = smem + 2 * kTile;  // digit counters, then bitmap + prefix
  static_assert(kMatchCounters >= 2 * kHashWords, "bitmap + prefix fit");
  __shared__ uint32_t part[kTileWarps];
  __shared__ uint32_t diff;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t lt = (1u << lane) - 1u;
  const int64_t row = blockIdx.x / tiles;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x % tiles) * kTile;
  const int T = static_cast<int>(e - t0 < kTile ? e - t0 : kTile);
  const int64_t half = e / 2;
  const uint32_t *v = vals + row * e;
  for (int i = threadIdx.x; i < T; i += kTileThreads)
    vs[i] = v[entry_of(t0 + i, half, stride)];
  if (threadIdx.x == 0) diff = 0u;
  __syncthreads();

  const int base = warp * 32 * kPerThread + lane;
  const uint32_t h0 = hash16(vs[0]);
  uint32_t u[kPerThread];   // hashes
  uint32_t rp[kPerThread];  // rank << 16 | slot
  uint32_t d_own = 0u;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int p = base + 32 * k;
    u[k] = p < T ? hash16(vs[p]) : 0u;
    rp[k] = static_cast<uint32_t>(p);
    if (p < T) d_own |= u[k] ^ h0;
  }
  d_own = __reduce_or_sync(0xFFFFFFFFu, d_own);
  if (lane == 0 && d_own) atomicOr(&diff, d_own);
  __syncthreads();
  const uint32_t dv = diff;
  int lo = 0, bits = 0, npass = 0;
  if (dv) {
    lo = __ffs(dv) - 1;
    const int nb = 32 - __clz(dv) - lo;
    npass = (nb + 7) / 8;
    bits = (nb + npass - 1) / npass;
  }
  const uint32_t radix = 1u << bits;
  const int n_cnt = static_cast<int>(radix + 1) * kCntStride;
  for (int pass = 0; pass < npass; ++pass) {
    const int shift = lo + pass * bits;
    for (int i = threadIdx.x; i < n_cnt; i += kTileThreads) cnt[i] = 0u;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const uint32_t dg = base + 32 * k < T ? (u[k] >> shift) & (radix - 1u)
                                            : radix;
      const uint32_t peers = __match_any_sync(0xFFFFFFFFu, dg);
      const int leader = __ffs(peers) - 1;
      uint32_t before = 0u;
      if (lane == leader) {
        uint32_t *c = cnt + dg * kCntStride + warp;
        before = *c;
        *c = before + __popc(peers);
      }
      before = __shfl_sync(0xFFFFFFFFu, before, leader);
      rp[k] = ((before + __popc(peers & lt)) << 16) | (rp[k] & 0xFFFFu);
      __syncwarp();
    }
    __syncthreads();
    scan_counters(cnt, n_cnt, part);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (base + 32 * k < T) {
        const uint32_t dg = (u[k] >> shift) & (radix - 1u);
        sk[cnt[dg * kCntStride + warp] + (rp[k] >> 16)] =
            (u[k] << 16) | (rp[k] & 0xFFFFu);
      }
    }
    __syncthreads();
    if (pass + 1 < npass) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int p = base + 32 * k;
        if (p < T) {
          u[k] = sk[p] >> 16;
          rp[k] = sk[p] & 0xFFFFu;
        }
      }
    }
  }
  if (npass == 0) {  // one hash in the whole tile: position order is sorted
    for (int p = threadIdx.x; p < T; p += kTileThreads)
      sk[p] = (h0 << 16) | static_cast<uint32_t>(p);
  }

  uint32_t *hbits = cnt, *pre = cnt + kHashWords;
  for (int i = threadIdx.x; i < kHashWords; i += kTileThreads) hbits[i] = 0u;
  __syncthreads();
  // in-tile neighbours: thread x holds sorted entries x, x + 512, ...
  uint32_t dl[kPerThread], sl[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = threadIdx.x + j * kTileThreads;
    dl[j] = 0u;
    sl[j] = 0u;
    if (i < T) {
      const uint32_t key = sk[i], h = key >> 16, slot = key & 0xFFFFu;
      sl[j] = slot;
      const uint32_t prev = i ? sk[i - 1] : 0u;
      if (i == 0 || (prev >> 16) != h) {
        atomicOr(&hbits[h >> 5], 1u << (h & 31));
      } else {
        const uint32_t q = prev & 0xFFFFu, vp = vs[slot];
        const uint32_t dd = (slot - q) * static_cast<uint32_t>(stride);
        if (vp == vs[q] && !degenerate(vp) && dd <= 65535u) dl[j] = dd;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kHashWords; i += kTileThreads)
    pre[i] = __popc(hbits[i]);
  __syncthreads();
  scan_counters(pre, kHashWords, part);
  uint2 *bpt = bp + static_cast<int64_t>(blockIdx.x) * kHashWords;
  for (int i = threadIdx.x; i < kHashWords; i += kTileThreads)
    bpt[i] = make_uint2(hbits[i], pre[i]);
  uint16_t *ft = first + static_cast<int64_t>(blockIdx.x) * kTile;
  uint16_t *lt16 = last + static_cast<int64_t>(blockIdx.x) * kTile;
  uint32_t *fvt = fv + static_cast<int64_t>(blockIdx.x) * kTile;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = threadIdx.x + j * kTileThreads;
    if (i < T) {
      const uint32_t h = sk[i] >> 16;
      const bool is_first = i == 0 || (sk[i - 1] >> 16) != h;
      const bool is_last = i == T - 1 || (sk[i + 1] >> 16) != h;
      if (is_first || is_last) {
        const uint32_t r = hash_rank(hbits[h >> 5], pre[h >> 5], h);
        if (is_first) {
          ft[r] = static_cast<uint16_t>(sl[j]);
          fvt[r] = vs[sl[j]];
        }
        if (is_last) lt16[r] = static_cast<uint16_t>(sl[j]);
      }
    }
  }
  __syncthreads();  // every read of sk and vs done: vs stages the deltas
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    if (threadIdx.x + j * kTileThreads < T) vs[sl[j]] = dl[j];
  __syncthreads();
  uint32_t *drow = d + row * e + t0;
  for (int i = threadIdx.x; i < T; i += kTileThreads) drow[i] = vs[i];
}

// Phase 2, one block per tile after a row's first: the first position of
// each hash in the tile looks back through the earlier tiles that reach
// into its window (q >= p - 65535 / stride), nearest first, and stops at
// the first tile whose bitmap holds its hash: that tile's last slot of the
// hash is the latest q.  Only a nonzero delta is written.  The earlier
// tiles' bitmap words and prefix counts are staged in shared memory; a
// thread keeps kLookBatch lookups in flight, so their loads overlap.
__global__ void __launch_bounds__(kLookThreads)
match_look_kernel(const uint32_t *__restrict__ vals, int64_t e, int stride,
                  int tiles, const uint2 *__restrict__ bp,
                  const uint32_t *__restrict__ fv,
                  const uint16_t *__restrict__ first,
                  const uint16_t *__restrict__ last,
                  uint32_t *__restrict__ d) {
  extern __shared__ __align__(16) uint2 sbp[];   // [look-back][kHashWords]
  const int k = blockIdx.x % tiles;
  if (k == 0) return;
  const int64_t row = blockIdx.x / tiles;
  const int64_t win = 65535 / stride;
  const int nlb = min(k, static_cast<int>((win + kTile - 1) / kTile));
  for (int i = threadIdx.x; i < nlb * kHashWords; i += kLookThreads)
    sbp[i] = bp[(static_cast<int64_t>(blockIdx.x) - 1 - i / kHashWords) *
                    kHashWords + i % kHashWords];
  const uint2 own =
      bp[static_cast<int64_t>(blockIdx.x) * kHashWords + kHashWords - 1];
  const int n = static_cast<int>(own.y + __popc(own.x));
  __syncthreads();
  const int64_t t0 = static_cast<int64_t>(k) * kTile, half = e / 2;
  const uint32_t *v = vals + row * e;
  const int64_t own_at = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int r0 = threadIdx.x; r0 < n; r0 += kLookThreads * kLookBatch) {
    int64_t p[kLookBatch], q[kLookBatch];
    uint32_t vp[kLookBatch];
#pragma unroll
    for (int b = 0; b < kLookBatch; ++b) {
      const int r = r0 + b * kLookThreads;
      p[b] = r < n ? t0 + first[own_at + r] : -1;
      vp[b] = r < n ? fv[own_at + r] : 0u;
    }
#pragma unroll
    for (int b = 0; b < kLookBatch; ++b) {
      q[b] = -1;
      if (p[b] < 0 || degenerate(vp[b])) continue;
      const uint32_t h = hash16(vp[b]);
      for (int jj = 0; jj < nlb; ++jj) {
        const int64_t j = k - 1 - jj;
        if ((j + 1) * kTile - 1 < p[b] - win) break;   // the window ends
        const uint2 wd = sbp[jj * kHashWords + (h >> 5)];
        if (!((wd.x >> (h & 31)) & 1u)) continue;
        q[b] = j * kTile + last[(static_cast<int64_t>(blockIdx.x) - 1 - jj) *
                                    kTile + hash_rank(wd.x, wd.y, h)];
        break;
      }
    }
#pragma unroll
    for (int b = 0; b < kLookBatch; ++b) {
      if (q[b] >= 0 && p[b] - q[b] <= win &&
          v[entry_of(q[b], half, stride)] == vp[b])
        d[row * e + p[b]] = static_cast<uint32_t>((p[b] - q[b]) * stride);
    }
  }
}

}  // namespace

// Match deltas of t rows of e entries: phase 1 (every tile), then phase 2
// (the tiles after each row's first).  Scratch, each array whole over all
// tiles in order: per tile kHashWords uint2 (bitmap word, distinct hashes
// before it), kTile u32 first-slot grams, kTile u16 first slots, kTile u16
// last slots.
extern "C" int hdrf_match_deltas(const void *vals, int64_t t, int64_t e,
                                 int32_t stride, void *out, void *scratch,
                                 void *stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>((e + kTile - 1) / kTile);
  const int64_t n_tiles = t * tiles;
  auto *bp = static_cast<uint2 *>(scratch);
  auto *fv = reinterpret_cast<uint32_t *>(bp + n_tiles * kHashWords);
  auto *first = reinterpret_cast<uint16_t *>(fv + n_tiles * kTile);
  uint16_t *last = first + n_tiles * kTile;
  const auto *v = static_cast<const uint32_t *>(vals);
  auto *d = static_cast<uint32_t *>(out);
  const size_t smem = (2 * kTile + kMatchCounters) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      match_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  match_tile_kernel<<<static_cast<unsigned>(n_tiles), kTileThreads, smem, s>>>(
      v, e, stride, tiles, d, bp, fv, first, last);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (tiles == 1) return 0;
  const int64_t win = 65535 / stride;
  const int lb = static_cast<int>((win + kTile - 1) / kTile);
  const size_t smem2 =
      static_cast<size_t>(lb < tiles - 1 ? lb : tiles - 1) * kHashWords *
      sizeof(uint2);
  err = cudaFuncSetAttribute(match_look_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  match_look_kernel<<<static_cast<unsigned>(n_tiles), kLookThreads, smem2,
                      s>>>(v, e, stride, tiles, bp, fv, first, last, d);
  return static_cast<int>(cudaGetLastError());
}

// Stable sort of t rows of e entries (key + n_val carried 32-bit values)
// into outputs of width E (e padded to a power of two with the pads).
// Rows wider than one tile need scratch shaped like the outputs.
extern "C" int hdrf_sort_rows(const void *key, const void *v0,
                              const void *v1, int32_t n_val, int64_t t,
                              int64_t e, int64_t E, int32_t key_unsigned,
                              uint32_t pad_key, uint32_t pad_v0,
                              uint32_t pad_v1, void *kout, void *v0out,
                              void *v1out, void *kscr, void *v0scr,
                              void *v1scr, void *stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n_val == 1)
    return sort_rows<1>(key, v0, v1, t, e, E, key_unsigned, pad_key, pad_v0,
                        pad_v1, kout, v0out, v1out, kscr, v0scr, v1scr, s);
  return sort_rows<2>(key, v0, v1, t, e, E, key_unsigned, pad_key, pad_v0,
                      pad_v1, kout, v0out, v1out, kscr, v0scr, v1scr, s);
}
