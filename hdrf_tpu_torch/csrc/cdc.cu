// Content-defined chunking on Hopper: Gear scans + min/max cut select.
//
// Replaces the Pallas `_select_kernel` of hdrf_tpu/ops/cdc_pallas.py
// (pallas_call at cdc_pallas.py:476).  The TPU kernel walks the block as a
// sequential grid, carrying the hash history and the cut frontier across
// grid steps in scratch.  Here the work is split into a scan and a select on
// one stream (ops/cdc_cuda.py has the design note):
//
//   cdc_scan_kernel    the Gear hash h = (h << 1) + G[b] of every byte
//                      (zero history before the block == the window-32 sum
//                      because G[0] == 0), the big-endian word image, and a
//                      candidate bitmap (bit i <=> pos1 == i + 1).
//   be_image_kernel    the same scan's words-only mode: the word image
//                      alone, for callers that bring their own cuts (the
//                      LZ4 seal's entries, the sharded SHA routes).
//   cdc_select_*       the frontier lo = f + min, hi = min(f + max, n),
//                      cut = first candidate in [lo, hi] else hi (the rule
//                      of hdrf_tpu/native/src/cdc.cpp:74-92), as segmented
//                      speculative walks and a stitch, four launches:
//                      (a) spec: the block is cut into S segments of W
//                      positions; one warp per segment walks from the
//                      segment start as if a cut stood there, 4,096
//                      bitmap bits a warp step, and keeps its points up
//                      to the first cut past the segment (segment 0's
//                      walk is exact).  (b) converge: each walker goes on
//                      from its exit, at most four segments' worth of
//                      cuts, until it lands on a point of the chain of the
//                      segment it is in — from there the two chains agree
//                      — and keeps its cuts.  At once for zeros (cuts
//                      every min, W a multiple of min); within a cut or
//                      two on random data.  (c) stitch: one warp follows
//                      the merge pointers from segment 0 in shared memory;
//                      past a walker that did not merge it walks on alone,
//                      cut after cut through a shared-memory window of the
//                      bitmap, until the chain lands on a segment's point
//                      again.  The block then scans the segments' cut and
//                      small/big counts into output offsets.  (d) emit:
//                      every segment on the chain writes its points,
//                      walker cuts and serial run into the cut table and
//                      both lane tables in parallel.  The header's two
//                      telemetry lanes (the reference's H_SURV / H_CANDS)
//                      ride the same launches: kTallyBlocks more thread
//                      blocks of the spec grid count the bitmap's set bits
//                      and its 512-position rows holding one (16 words a
//                      row) while the walkers walk, a partial pair a
//                      block, and the stitch's first warp sums the pairs.
//
// Bound: the scan moves the block's bytes (read once, written once as
// words, plus the bitmap); the select reads the bitmap and writes a few
// words per cut.  The select's walks are latency-bound (one dependent L2
// load a warp step, a few steps a cut), so it is spread over ~n / 128 KiB
// warps.  Where chains never meet (a short period holding one candidate a
// period steps every chain by the same stride, so chains a non-multiple
// apart stay apart), the stitch's serial walk does the whole block: one
// warp, one shared-memory find a cut — the worst case, measured by
// chip_smoke.py on a 3-byte period.
//
// A third scan replaces the Pallas `_scan_kernel` of the same file
// (pallas_call at cdc_pallas.py:570, reached through
// `local_candidate_words_pallas`), the per-shard candidate scan of the
// sharded reduction (hdrf_tpu_torch/parallel/sharded.py):
//
//   cdc_shard_scan_kernel  the same scan over one shard of a block, its
//                      history the 31-byte halo (the previous shard's
//                      tail) read by bytes; candidate bitmap words with no
//                      `<= n` clamp and no min-chunk floor (only pos1 >= 32
//                      of the whole block), no word image, plus the
//                      candidate count: a warp reduce and one atomicAdd per
//                      thread block.
//
// The three scans are one body (`gear_scan`, a mode template).  They are
// byte-bound, so the design is built around coalesced movement:
//   * A persistent grid, sized by occupancy to fill every SM, gives each
//     warp a contiguous span of 1 KiB chunks.  A warp stages its chunks
//     through a private three-stage cp.async ring in shared memory (512
//     contiguous bytes a copy instruction), two chunks in flight while it
//     works on the third.  No block-wide barrier in the loop.
//   * A chunk is 32 pieces of 32 bytes, one a lane.  The window is 32
//     bytes, so the hash entering a piece is the hash of the piece before
//     it from zero history; and the Gear update is linear, so the hash
//     after byte j of a piece is hp_j + (s << (j + 1)) (mod 2^32), hp_j the
//     piece's own prefix hash from zero and s the hash entering it.  Each
//     lane hashes its piece once from zero (32 dependent steps), takes s
//     from its left neighbour's last hp by one shuffle (lane 0 from the
//     previous chunk's lane 31), and tests its 32 positions independently.
//     Only a span's first chunk needs history: a warp sum of
//     G[b_k] << (31 - k) over the 32 bytes before it, one byte a lane.
//     No byte is loaded or hashed twice in a span.
//   * A piece's 32 tests make one bitmap word, so a warp stores 32
//     consecutive words.  The word image is byte-swapped from the staged
//     chunk in 16-byte units, 512 contiguous bytes a store instruction.
//   * The position rule (thr <= pos1 <= n; shard: pos1 >= 32 of the whole
//     block) is a bit mask a piece, applied only in the chunks that hold a
//     bound (a warp-uniform branch); other chunks test nothing but the hash.
//   * The Gear table is one 1 KiB copy in shared memory.  Measured against
//     a copy a bank (32 KiB: lookups without bank conflicts) and fmix32 in
//     registers, it is as fast on random bytes, where lanes conflict, and
//     leaves room for a fourth block an SM (PERF.md).
//   * Staged 16-byte units are swizzled, so the lanes' piece reads and the
//     image's contiguous reads are both conflict-free.

#include <atomic>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;           // bytes a warp step: 32 pieces of 32
constexpr int kUnits = kChunk / 16;    // 16-byte units a chunk
constexpr int kStages = 3;             // chunks in a warp's cp.async ring
constexpr int kScanWarps = 8;
constexpr int kScanThreads = 32 * kScanWarps;   // == 256 Gear entries
constexpr int kWalkThreads = 128;      // select walkers: one warp a segment
constexpr int kStitchThreads = 1024;
constexpr int kMaxSegs = 8192;         // the stitch holds 3 x S ints shared
constexpr int kWin = 8192;             // bitmap words of the stitch's window
constexpr int kReach = 4;              // converge walks, in segments' worth
constexpr int kSegArrays = 12;         // scratch arrays of one int a segment
constexpr int kRunArrays = 4;          // scratch arrays of one int a serial cut
constexpr int kTallyBlocks = 256;      // spec blocks counting the lanes
constexpr int32_t kChainEnd = -1;      // merge pointer: the walker reached n
constexpr int32_t kChainOpen = -2;     // merge pointer: no merge in reach
constexpr int kTableHdr = 8;
constexpr int kHalo = 31;              // WINDOW - 1 bytes of shard history
constexpr int kMaxDevices = 64;        // cards a process may launch scans on

enum ScanMode { kBlockScan, kShardScan, kImageOnly };

__device__ __forceinline__ uint32_t fmix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

// Staged 16-byte unit u of a chunk lives at slot u ^ ((u >> 3) & 1): a
// quarter-warp reading lane pieces (units 2l, 2l + 1) or image units (l,
// l + 32) then touches eight distinct 16-byte bank groups.
__device__ __forceinline__ int unit_slot(int u) { return u ^ ((u >> 3) & 1); }

// The bits lo..hi of a word (none when lo > hi); lo, hi in any range.
__device__ __forceinline__ uint32_t bit_range(int64_t lo, int64_t hi) {
  if (lo > 31 || hi < 0 || lo > hi) return 0u;
  uint32_t m = ~0u;
  if (lo > 0) m <<= lo;
  if (hi < 31) m &= (2u << hi) - 1u;
  return m;
}

struct ScanArgs {
  const uint8_t *data;   // the block (or shard), 16-byte aligned
  const uint8_t *halo;   // shard: its 31 bytes of history
  int64_t len;           // bytes, a multiple of 256
  int64_t lo, hi;        // selectable pos1 within `data`: [lo, hi]
  uint32_t mask;
  uint32_t *words_be;    // block, image: uint32[len / 4]
  uint32_t *bitmap;      // block, shard: uint32[len / 32]
  int32_t *count;        // shard: += the candidates (zeroed by the caller)
  int64_t span;          // chunks a warp
};

// Copy chunk c of a warp's span into ring stage `st`, then commit a group
// (an empty one past the span, so the wait count stays uniform).
__device__ __forceinline__ void stage_chunk(const ScanArgs &a, uint4 *stage,
                                            int64_t c, int64_t c1,
                                            int lane) {
  if (c < c1) {
    const int64_t off = c * kChunk;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = lane + 32 * h;
      if (off + 16 * u < a.len)
        __pipeline_memcpy_async(stage + unit_slot(u), a.data + off + 16 * u,
                                16);
    }
  }
  __pipeline_commit();
}

template <int kMode>
__device__ __forceinline__ void gear_scan(const ScanArgs &a) {
  constexpr bool kHash = kMode != kImageOnly;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t *gear = reinterpret_cast<uint32_t *>(smem);
  uint4 *ring = reinterpret_cast<uint4 *>(
      smem + (kHash ? 256 * sizeof(uint32_t) : 0));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (kHash) {
    gear[threadIdx.x] = fmix32(threadIdx.x * 0x9E3779B1u);   // one a thread
    __syncthreads();
  }
  uint4 *buf = ring + warp * kStages * kUnits;
  const int64_t nchunks = (a.len + kChunk - 1) / kChunk;
  const int64_t c0 =
      (static_cast<int64_t>(blockIdx.x) * kScanWarps + warp) * a.span;
  const int64_t c1 = c0 + a.span < nchunks ? c0 + a.span : nchunks;

  // the hash entering the span: the 32 bytes before it, one a lane
  uint32_t carry = 0;
  if (kHash && c0 < c1) {
    const int64_t p = c0 * kChunk - 32 + lane;
    uint32_t b = 0;
    if (p >= 0)
      b = a.data[p];
    else if (kMode == kShardScan && p >= -kHalo)
      b = a.halo[kHalo + p];
    carry = __reduce_add_sync(0xFFFFFFFFu, gear[b] << (31 - lane));
  }

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k)
    stage_chunk(a, buf + k * kUnits, c0 + k, c1, lane);
  int cnt = 0;
  for (int64_t c = c0; c < c1; ++c) {
    const int i = static_cast<int>(c - c0);
    stage_chunk(a, buf + ((i + kStages - 1) % kStages) * kUnits,
                c + kStages - 1, c1, lane);
    __pipeline_wait_prior(kStages - 1);   // chunk c has landed
    __syncwarp();
    const uint4 *in = buf + (i % kStages) * kUnits;
    const int64_t off = c * kChunk;
    const int64_t rem = a.len - off < kChunk ? a.len - off : kChunk;
    if (kMode != kShardScan) {   // the word image, 512 B a store
      uint4 *dst = reinterpret_cast<uint4 *>(a.words_be) + off / 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = lane + 32 * h;
        if (16 * u < rem) {
          const uint4 v = in[unit_slot(u)];
          dst[u] = make_uint4(__byte_perm(v.x, 0, 0x0123),
                              __byte_perm(v.y, 0, 0x0123),
                              __byte_perm(v.z, 0, 0x0123),
                              __byte_perm(v.w, 0, 0x0123));
        }
      }
    }
    if (kHash) {   // the lane's piece: bytes off + 32 lane ..
      const uint4 v0 = in[unit_slot(2 * lane)];
      const uint4 v1 = in[unit_slot(2 * lane + 1)];
      const uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      uint32_t hp[32];
      uint32_t h = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        h = (h << 1) + gear[(w[j >> 2] >> (8 * (j & 3))) & 0xFFu];
        hp[j] = h;
      }
      const uint32_t left = __shfl_up_sync(0xFFFFFFFFu, h, 1);
      const uint32_t s = lane ? left : carry;
      carry = __shfl_sync(0xFFFFFFFFu, h, 31);
      uint32_t bits = static_cast<uint32_t>((h & a.mask) == 0u) << 31;
#pragma unroll
      for (int j = 0; j < 31; ++j)
        bits |= static_cast<uint32_t>(((hp[j] + (s << (j + 1))) & a.mask) ==
                                      0u)
                << j;
      if (off + 1 < a.lo || off + rem > a.hi) {   // a chunk holding a bound
        const int64_t p1 = off + 32 * lane + 1;    // pos1 of bit 0
        bits &= bit_range(a.lo - p1, a.hi - p1);
      }
      if (32 * lane < rem) {
        a.bitmap[off / 32 + lane] = bits;
        cnt += __popc(bits);
      }
    }
    __syncwarp();   // stage i % kStages is refilled next step
  }
  if (kMode == kShardScan) {
    // every copy has landed (the last groups are empty): each warp's ring
    // is free to hold its count
    cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
    if (lane == 0) *reinterpret_cast<int *>(buf) = cnt;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
      for (int i = 0; i < kScanWarps; ++i)
        total += *reinterpret_cast<const int *>(ring + i * kStages * kUnits);
      if (total) atomicAdd(a.count, total);
    }
  }
}

__global__ void __launch_bounds__(kScanThreads, 3)
cdc_scan_kernel(const ScanArgs a) {
  gear_scan<kBlockScan>(a);
}

__global__ void __launch_bounds__(kScanThreads, 3)
cdc_shard_scan_kernel(const ScanArgs a) {
  gear_scan<kShardScan>(a);
}

__global__ void __launch_bounds__(kScanThreads)
be_image_kernel(const ScanArgs a) {
  gear_scan<kImageOnly>(a);
}

// Launch one scan on a persistent grid: as many blocks as fit on every SM
// at once, each warp a contiguous span of ceil(chunks / warps) chunks.  The
// resident warps of a device are found once, so a launch makes no query.
template <int kMode>
cudaError_t launch_scan(void (*kernel)(ScanArgs), ScanArgs a,
                        cudaStream_t s) {
  constexpr int kSmem =   // under the 48 KiB default: no opt-in needed
      (kMode != kImageOnly ? 256 * 4 : 0) + kScanWarps * kStages * kChunk;
  static std::atomic<int> resident[kMaxDevices];   // warps; 0: not known
  if (a.len <= 0) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int warps = resident[dev].load(std::memory_order_relaxed);
  if (warps == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kScanThreads, kSmem);
    if (e != cudaSuccess) return e;
    warps = sms * (per_sm > 0 ? per_sm : 1) * kScanWarps;
    resident[dev].store(warps, std::memory_order_relaxed);
  }
  const int64_t nchunks = (a.len + kChunk - 1) / kChunk;
  a.span = (nchunks + warps - 1) / warps;
  const int64_t used = (nchunks + a.span - 1) / a.span;
  const unsigned blocks =
      static_cast<unsigned>((used + kScanWarps - 1) / kScanWarps);
  kernel<<<blocks, kScanThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------ cut select
//
// The chain of cuts f -> next(f): lo = f + min, hi = min(f + max, n), the
// first candidate in [lo, hi], else hi.  Segment i covers [i W, (i+1) W).
// Per-segment scratch: the speculative chain's points (pts: the segment
// start, then its cuts up to the first >= the next start or n; lcap
// entries) and the running count of small chunks at each point (csm); the
// cuts its walker made after the exit (ys; kReach * lcap entries) and
// their running small counts (ysm).  Per segment: the point count, the
// walker's merge pointer (segment, index; kChainEnd at n, kChainOpen when
// it made kReach * lcap cuts unmerged),
// its cut and small counts after the exit (ny, nys), the index where the
// true chain enters it (ent, -1 when it does not), the output offsets of
// its cuts and of its small and big chunks, and the stitch's serial run
// after its walker (start in the run arrays, cuts, small ones).  Per serial
// cut (cap entries): the cut, its chunk start, the small count of its run
// up to and with it, and its segment; then the serial cut count; then a
// (rows, candidates) pair per tally block.

struct SelScratch {
  int32_t *pts, *csm, *ys, *ysm;
  int32_t *npts, *mseg, *midx, *ny, *nys, *ent, *offc, *offs, *offb, *zst,
      *zn, *zns;
  int32_t *zcut, *zpos, *zrs, *zseg, *zcount, *tally;
};

// Thread blocks of the spec and converge grids: one warp a segment.
__host__ __device__ __forceinline__ int64_t walk_blocks_of(int64_t S) {
  return (S * 32 + kWalkThreads - 1) / kWalkThreads;
}

// pts and csm hold lcap ints a segment, ys and ysm kReach * lcap.
__device__ __forceinline__ SelScratch sel_scratch(int32_t *base, int64_t S,
                                                  int64_t lcap, int64_t cap) {
  SelScratch r;
  r.pts = base;
  r.csm = base + S * lcap;
  r.ys = base + 2 * S * lcap;
  r.ysm = r.ys + S * kReach * lcap;
  int32_t *p = r.ysm + S * kReach * lcap;
  int32_t **seg[] = {&r.npts, &r.mseg, &r.midx, &r.ny, &r.nys, &r.ent,
                     &r.offc, &r.offs, &r.offb, &r.zst, &r.zn, &r.zns};
  for (int i = 0; i < kSegArrays; ++i) *seg[i] = p + i * S;
  p += kSegArrays * S;
  int32_t **run[] = {&r.zcut, &r.zpos, &r.zrs, &r.zseg};
  for (int i = 0; i < kRunArrays; ++i) *run[i] = p + i * cap;
  r.zcount = p + kRunArrays * cap;
  r.tally = r.zcount + 1;
  return r;
}

// The header's telemetry lanes, counted over the bitmap by the spec
// grid's tally blocks (row r: bitmap words 16 r .. 16 r + 15, positions
// 512 r + 1 .. 512 r + 512, as the reference's (R, 128)-word tiles lay
// rows out): tally block b writes its (rows holding a candidate,
// candidates) pair.  They run beside the walkers, which are latency-bound,
// so the bitmap's second read costs the select little time.
__device__ __forceinline__ void tally_rows(const uint32_t *__restrict__ bm,
                                           int nbm, int64_t b,
                                           int32_t *tally) {
  __shared__ int32_t part[2][kWalkThreads / 32];
  const int64_t nrows = (static_cast<int64_t>(nbm) + 15) / 16;
  const int64_t stride = static_cast<int64_t>(kTallyBlocks) * kWalkThreads;
  int rows = 0, cands = 0;
  for (int64_t row = b * kWalkThreads + threadIdx.x; row < nrows;
       row += stride) {
    const int64_t w0 = row * 16;
    int c = 0;
    if (w0 + 16 <= nbm) {
      const uint4 *q = reinterpret_cast<const uint4 *>(bm + w0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 v = __ldg(q + j);
        c += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      }
    } else {
      for (int64_t w = w0; w < nbm; ++w) c += __popc(__ldg(bm + w));
    }
    rows += c != 0;
    cands += c;
  }
  rows = __reduce_add_sync(0xFFFFFFFFu, rows);
  cands = __reduce_add_sync(0xFFFFFFFFu, cands);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = rows;
    part[1][warp] = cands;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int a = 0, c = 0;
    for (int i = 0; i < kWalkThreads / 32; ++i) {
      a += part[0][i];
      c += part[1][i];
    }
    tally[2 * b] = a;
    tally[2 * b + 1] = c;
  }
}

// Positions, bit indices and word indices of the walks are 32-bit (the
// wrapper keeps n < 2^31): a walk is one dependent chain, and 64-bit
// arithmetic or a division a cut lengthens it several times over.

// First set bit in [b0, b1] (bit i <=> pos1 i + 1), or -1, by a whole
// warp: 128 words (4,096 bits) a step, one 16-byte load per lane.  Word w
// is src[w - off] for w < lim and zero past it: the bitmap itself
// (off 0), or the stitch's window of it in shared memory.
template <bool kShared>
__device__ int warp_find(const uint32_t *__restrict__ src, int off, int lim,
                         int b0, int b1) {
  const int lane = threadIdx.x & 31;
  const int wlo = b0 >> 5, whi = b1 >> 5;
  const uint32_t mlo = 0xFFFFFFFFu << (b0 & 31);
  const uint32_t mhi = 0xFFFFFFFFu >> (31 - (b1 & 31));
  for (int w = wlo & ~3; w <= whi; w += 128) {
    const int wi = w + 4 * lane;
    uint32_t x[4];
    if (wi + 3 < lim) {
      const uint4 *q = reinterpret_cast<const uint4 *>(src + (wi - off));
      const uint4 v = kShared ? *q : __ldg(q);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = wi + j < lim ? src[wi + j - off] : 0u;
    }
    int hit = -1;
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      const int word = wi + j;
      uint32_t m = word < wlo || word > whi ? 0u : x[j];
      if (word == wlo) m &= mlo;
      if (word == whi) m &= mhi;
      if (m) hit = (word << 5) + __ffs(m) - 1;
    }
    const uint32_t any = __ballot_sync(0xFFFFFFFFu, hit >= 0);
    if (any) return __shfl_sync(0xFFFFFFFFu, hit, __ffs(any) - 1);
  }
  return -1;
}

// The next cut after frontier f (warp-uniform): the first candidate in
// [f + mn, min(f + mx, n)], else the upper end.
__device__ __forceinline__ int warp_next(const uint32_t *bitmap, int nbm,
                                         int n, int mn, int mx, int f) {
  const int rem = n - f;
  const int hi = rem > mx ? f + mx : n;
  if (mn <= rem && mn <= mx) {
    const int b = warp_find<false>(bitmap, 0, nbm, f + mn - 1, hi - 1);
    if (b >= 0) return b + 1;
  }
  return hi;
}

__device__ __forceinline__ int small_chunk(int len, int32_t b_small) {
  return (len + 9 + 63) / 64 <= b_small;
}

// A warp's cursor over the points (sorted) of the segment a walk is in:
// lane l holds point j0 + l (INT32_MAX past the last), vmax the largest
// held.  A walk only moves forward, so it reloads only when it passes the
// points held or leaves the segment.
struct PointCursor {
  int k = -1;
  int64_t end = 0;  // (k + 1) W
  int j0 = 0;
  int32_t v = 0, vmax = 0;
};

__device__ __forceinline__ void cursor_load(PointCursor &c,
                                            const SelScratch &r,
                                            int64_t lcap) {
  const int i = c.j0 + (threadIdx.x & 31);
  c.v = i < r.npts[c.k] ? r.pts[c.k * lcap + i] : INT32_MAX;
  c.vmax = __shfl_sync(0xFFFFFFFFu, c.v, 31);
}

// Index of f among the points of the segment f lies in, or -1.
__device__ __forceinline__ int cursor_find(PointCursor &c,
                                           const SelScratch &r, int64_t lcap,
                                           int64_t W, int f) {
  if (f >= c.end) {  // a division once a segment, not once a cut
    c.k = static_cast<int>(f / W);
    c.end = (c.k + 1) * W;
    c.j0 = 0;
    cursor_load(c, r, lcap);
  }
  while (f > c.vmax) {
    c.j0 += 32;
    cursor_load(c, r, lcap);
  }
  const uint32_t eq = __ballot_sync(0xFFFFFFFFu, c.v == f);
  return eq ? c.j0 + __ffs(eq) - 1 : -1;
}

// (a) Speculate: one warp per segment walks from the segment start as if
// a cut stood there, up to the first cut >= the next start (or n); the
// kTallyBlocks blocks past the walkers' count the telemetry lanes.
__global__ void __launch_bounds__(kWalkThreads)
cdc_select_spec_kernel(const uint32_t *__restrict__ bitmap, int nbm, int n,
                       int mn, int mx, int32_t b_small, int64_t W, int64_t S,
                       int64_t lcap, int64_t cap,
                       int32_t *__restrict__ scratch) {
  const SelScratch r = sel_scratch(scratch, S, lcap, cap);
  const int64_t tb = static_cast<int64_t>(blockIdx.x) - walk_blocks_of(S);
  if (tb >= 0) {   // block-uniform
    tally_rows(bitmap, nbm, tb, r.tally);
    return;
  }
  const int64_t seg =
      (static_cast<int64_t>(blockIdx.x) * kWalkThreads + threadIdx.x) >> 5;
  if (seg >= S) return;  // warp-uniform
  const bool lead = (threadIdx.x & 31) == 0;
  int32_t *pts = r.pts + seg * lcap, *csm = r.csm + seg * lcap;
  const int64_t end = (seg + 1) * W;
  int f = static_cast<int>(seg * W);
  int k = 0, ns = 0;
  if (lead) {
    pts[0] = f;
    csm[0] = 0;
  }
  do {
    const int cut = warp_next(bitmap, nbm, n, mn, mx, f);
    ns += small_chunk(cut - f, b_small);
    ++k;
    if (lead) {
      pts[k] = cut;
      csm[k] = ns;
    }
    f = cut;
  } while (f < end && f < n);
  if (lead) r.npts[seg] = k + 1;
}

// (b) Converge: each walker goes on from its exit, at most kReach
// segments' worth of cuts, until it lands on a point of the chain of the
// segment it is in (the chains agree from there on) or reaches n, keeping
// its cuts.
__global__ void __launch_bounds__(kWalkThreads)
cdc_select_converge_kernel(const uint32_t *__restrict__ bitmap, int nbm,
                           int n, int mn, int mx, int32_t b_small, int64_t W,
                           int64_t S, int64_t lcap, int64_t cap,
                           int32_t *__restrict__ scratch) {
  const int64_t seg =
      (static_cast<int64_t>(blockIdx.x) * kWalkThreads + threadIdx.x) >> 5;
  if (seg >= S) return;  // warp-uniform
  const SelScratch r = sel_scratch(scratch, S, lcap, cap);
  const bool lead = (threadIdx.x & 31) == 0;
  const int64_t ycap = kReach * lcap;
  int32_t *ys = r.ys + seg * ycap, *ysm = r.ysm + seg * ycap;
  int f = r.pts[seg * lcap + r.npts[seg] - 1];
  PointCursor cur;
  int32_t ms = kChainEnd, mi = 0, ny = 0, nys = 0;
  while (f < n) {
    const int idx = cursor_find(cur, r, lcap, W, f);
    if (idx >= 0) {
      ms = cur.k;
      mi = idx;
      break;
    }
    if (ny == ycap) {
      ms = kChainOpen;
      break;
    }
    const int cut = warp_next(bitmap, nbm, n, mn, mx, f);
    nys += small_chunk(cut - f, b_small);
    if (lead) {
      ys[ny] = cut;
      ysm[ny] = nys;
    }
    ++ny;
    f = cut;
  }
  if (lead) {
    r.mseg[seg] = ms;
    r.midx[seg] = mi;
    r.ny[seg] = ny;
    r.nys[seg] = nys;
  }
}

// Stage bitmap words [wb, wb + kWin) in the window (zeros past nbm), by
// one warp: asynchronous copies, all in flight at once.
__device__ void stage_window(uint32_t *win, const uint32_t *__restrict__ bitmap,
                             int nbm, int wb) {
  __syncwarp();
  for (int i = 4 * (threadIdx.x & 31); i < kWin; i += 128) {
    const int w = wb + i;
    if (w + 3 < nbm) {
      __pipeline_memcpy_async(win + i, bitmap + w, 16);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) win[i + j] = w + j < nbm ? bitmap[w + j] : 0u;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
}

// The next cut after f for the stitch's serial walk (lane-uniform): the
// range's first word read from the shared window by every lane, the rest
// by a warp find there (the window restaged when the range leaves it), or
// in the bitmap itself when the range is wider than the window.  Dense
// runs, where chains fail to meet, end in the first word.
__device__ __forceinline__ int serial_next(uint32_t *win, int &wb,
                                           const uint32_t *bitmap, int nbm,
                                           int n, int mn, int mx, int f) {
  const int rem = n - f;
  const int hi = rem > mx ? f + mx : n;
  if (mn > rem || mn > mx) return hi;
  const int b0 = f + mn - 1, b1 = hi - 1;
  const int w0 = b0 >> 5, w1 = b1 >> 5;
  if (w1 - (w0 & ~3) >= kWin) {
    const int b = warp_find<false>(bitmap, 0, nbm, b0, b1);
    return b >= 0 ? b + 1 : hi;
  }
  if (wb < 0 || w0 < wb || w1 >= wb + kWin) {
    wb = w0 & ~3;
    stage_window(win, bitmap, nbm, wb);
  }
  uint32_t x = win[w0 - wb] & (0xFFFFFFFFu << (b0 & 31));
  if (w0 == w1) x &= 0xFFFFFFFFu >> (31 - (b1 & 31));
  if (x) return (w0 << 5) + __ffs(x);  // bit index + 1
  if (w0 == w1) return hi;
  const int b = warp_find<true>(win, wb, wb + kWin, (w0 + 1) << 5, b1);
  return b >= 0 ? b + 1 : hi;
}

// Index of point f in a segment's sorted points, or -1.
__device__ __forceinline__ int find_point(const int32_t *pts, int cnt, int f) {
  int lo = 0, hi = cnt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(pts + mid) < f) lo = mid + 1;
    else hi = mid;
  }
  return lo < cnt && __ldg(pts + lo) == f ? lo : -1;
}

// (c) Stitch: one warp follows the merge pointers from segment 0 (in
// shared memory).  Past a walker that did not merge it walks on itself,
// cut after cut through a shared window of the bitmap, until the chain
// lands on a point of the segment it is in, and keeps those cuts as that
// segment's serial run.  Then the block scans the segments' counts
// into output offsets and writes the table header.
__global__ void __launch_bounds__(kStitchThreads)
cdc_select_stitch_kernel(const uint32_t *__restrict__ bitmap, int nbm, int n,
                         int mn, int mx, int32_t b_small, int64_t W,
                         int64_t S, int64_t lcap, int64_t cap,
                         int32_t *__restrict__ table,
                         int32_t *__restrict__ scratch) {
  extern __shared__ uint4 sh4[];
  uint32_t *win = reinterpret_cast<uint32_t *>(sh4);
  int32_t *ms = reinterpret_cast<int32_t *>(win + kWin), *mi = ms + S,
          *ent = ms + 2 * S;
  __shared__ uint64_t part[kStitchThreads / 32];
  const SelScratch r = sel_scratch(scratch, S, lcap, cap);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t i = threadIdx.x; i < S; i += kStitchThreads) {
    ms[i] = r.mseg[i];
    mi[i] = r.midx[i];
    ent[i] = -1;
    r.zn[i] = 0;
    r.zns[i] = 0;
  }
  __syncthreads();
  if (warp == 0) {  // warp-uniform from here to the end of the chain
    const int64_t ycap = kReach * lcap;
    const int W32 = static_cast<int>(W < n ? W : n);  // f / W, f < n
    int wb = -1;
    int32_t k = 0, e = 0, zc = 0;
    for (;;) {
      if (lane == 0) ent[k] = e;
      const int32_t m = ms[k];
      if (m >= 0) {
        e = mi[k];
        k = m;
        continue;
      }
      if (m == kChainEnd) break;
      // kChainOpen (ny == ycap): walk on from the walker's last cut, 32
      // cuts a batch (lane l keeps cut l and its chunk start), then find
      // the batch's first cut that lands on a point of its segment or
      // reaches n, and keep the cuts up to it
      int f = r.ys[k * ycap + r.ny[k] - 1];
      const int32_t z0 = zc;
      int32_t ns = 0, idx = -1;
      for (;;) {
        int cut = 0, st = 0, cnt = 0;
        for (; cnt < 32 && f < n; ++cnt) {
          const int c = serial_next(win, wb, bitmap, nbm, n, mn, mx, f);
          if (lane == cnt) {
            cut = c;
            st = f;
          }
          f = c;
        }
        const int ks = lane < cnt && cut < n ? cut / W32 : -1;
        const int pi =
            ks < 0 ? -1 : find_point(r.pts + ks * lcap, r.npts[ks], cut);
        const uint32_t ev =
            __ballot_sync(0xFFFFFFFFu, pi >= 0 || (lane < cnt && cut >= n));
        const int take = ev ? __ffs(ev) : cnt;
        int sm = lane < take ? small_chunk(cut - st, b_small) : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xFFFFFFFFu, sm, o);
          if (lane >= o) sm += y;
        }
        if (lane < take) {
          r.zcut[zc + lane] = cut;
          r.zpos[zc + lane] = st;
          r.zrs[zc + lane] = ns + sm;
          r.zseg[zc + lane] = k;
        }
        ns += __shfl_sync(0xFFFFFFFFu, sm, take - 1);
        zc += take;
        if (ev) {
          const int l = __ffs(ev) - 1;
          idx = __shfl_sync(0xFFFFFFFFu, pi, l);  // -1: the walk reached n
          f = __shfl_sync(0xFFFFFFFFu, cut, l);
          break;
        }
      }
      if (lane == 0) {
        r.zst[k] = z0;
        r.zn[k] = zc - z0;
        r.zns[k] = ns;
      }
      if (idx < 0) break;
      e = idx;
      k = f / W32;
    }
    if (lane == 0) *r.zcount = zc;
  }
  __syncthreads();
  // per segment (cuts << 32 | small chunks), contiguous runs per thread
  const int64_t per = (S + kStitchThreads - 1) / kStitchThreads;
  const int64_t b = threadIdx.x * per;
  auto count = [&](int64_t k) -> uint64_t {
    const int e = ent[k];
    if (e < 0) return 0;
    const int last = r.npts[k] - 1;
    const int32_t *csm = r.csm + k * lcap;
    const uint64_t nc =
        static_cast<uint64_t>(last - e + r.ny[k] + r.zn[k]);
    const uint64_t ns =
        static_cast<uint64_t>(csm[last] - csm[e] + r.nys[k] + r.zns[k]);
    return nc << 32 | ns;
  };
  uint64_t own = 0;
  for (int64_t i = 0; i < per; ++i)
    if (b + i < S) own += count(b + i);
  uint64_t x = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int rows = 0, cands = 0;   // the telemetry lanes: sum the spec pairs
    for (int i = lane; i < kTallyBlocks; i += 32) {
      rows += r.tally[2 * i];
      cands += r.tally[2 * i + 1];
    }
    rows = __reduce_add_sync(0xFFFFFFFFu, rows);
    cands = __reduce_add_sync(0xFFFFFFFFu, cands);
    const uint64_t p = part[lane];
    uint64_t q = p;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint64_t y = __shfl_up_sync(0xFFFFFFFFu, q, o);
      if (lane >= o) q += y;
    }
    part[lane] = q - p;
    if (lane == 31) {  // the header: totals
      const int32_t nc = static_cast<int32_t>(q >> 32);
      const int32_t ns = static_cast<int32_t>(q & 0xFFFFFFFFu);
      table[0] = nc;
      table[1] = 0;  // no overflow: the tables hold the hard cut bound
      table[2] = ns;
      table[3] = nc - ns;
      table[4] = rows;
      table[5] = cands;
      for (int i = 6; i < kTableHdr; ++i) table[i] = 0;
    }
  }
  __syncthreads();
  uint64_t run = part[warp] + x - own;
  for (int64_t i = 0; i < per; ++i) {
    const int64_t k = b + i;
    if (k < S) {
      const int32_t nc = static_cast<int32_t>(run >> 32);
      const int32_t ns = static_cast<int32_t>(run & 0xFFFFFFFFu);
      r.ent[k] = ent[k];
      r.offc[k] = nc;
      r.offs[k] = ns;
      r.offb[k] = nc - ns;
      run += count(k);
    }
  }
}

// Cut i of a segment's piece of the chain (si of its cuts up to and with
// this one small), chunk [st, cut), at the piece's output offsets.
__device__ __forceinline__ void put_cut(const SelScratch &r, int64_t k,
                                        int64_t i, int64_t si, int32_t st,
                                        int32_t cut, int32_t b_small,
                                        int32_t *cuts, int32_t *ols,
                                        int32_t *olb, int64_t cap) {
  cuts[r.offc[k] + i] = cut;
  if (small_chunk(cut - st, b_small)) {
    const int64_t s = r.offs[k] + si - 1;
    ols[s] = st;
    ols[cap + s] = cut - st;
  } else {
    const int64_t g = r.offb[k] + i - si;
    olb[g] = st;
    olb[cap + g] = cut - st;
  }
}

// (d) Emit: every segment on the true chain writes its piece — its points
// from the entry on, its walker's cuts, its serial run — at the scanned
// offsets; the lanes of its warp write the points and walker cuts, the
// whole grid the serial runs.
__global__ void __launch_bounds__(kWalkThreads)
cdc_select_emit_kernel(int32_t b_small, int64_t S, int64_t lcap, int64_t cap,
                       int32_t *__restrict__ scratch,
                       int32_t *__restrict__ table, int32_t *__restrict__ ols,
                       int32_t *__restrict__ olb) {
  const SelScratch r = sel_scratch(scratch, S, lcap, cap);
  int32_t *cuts = table + kTableHdr;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * kWalkThreads + threadIdx.x;
  const int64_t zc = *r.zcount;
  for (int64_t t = tid; t < zc;
       t += static_cast<int64_t>(gridDim.x) * kWalkThreads) {
    const int64_t k = r.zseg[t];
    const int e = r.ent[k], last = r.npts[k] - 1;
    const int32_t *csm = r.csm + k * lcap;
    put_cut(r, k, last - e + r.ny[k] + (t - r.zst[k]),
            csm[last] - csm[e] + r.nys[k] + r.zrs[t], r.zpos[t], r.zcut[t],
            b_small, cuts, ols, olb, cap);
  }
  const int64_t seg = tid >> 5;
  if (seg >= S) return;  // warp-uniform
  const int e = r.ent[seg];
  if (e < 0) return;
  const int lane = threadIdx.x & 31;
  const int32_t *pts = r.pts + seg * lcap, *csm = r.csm + seg * lcap;
  const int32_t *ys = r.ys + seg * kReach * lcap;
  const int32_t *ysm = r.ysm + seg * kReach * lcap;
  const int last = r.npts[seg] - 1;
  for (int j = e + 1 + lane; j <= last; j += 32)
    put_cut(r, seg, j - e - 1, csm[j] - csm[e], pts[j - 1], pts[j], b_small,
            cuts, ols, olb, cap);
  for (int y = lane, ny = r.ny[seg]; y < ny; y += 32)
    put_cut(r, seg, last - e + y, csm[last] - csm[e] + ysm[y],
            y ? ys[y - 1] : pts[last], ys[y], b_small, cuts, ols, olb, cap);
}

}  // namespace

// The scan: block bytes -> big-endian word image + candidate bitmap.
extern "C" int hdrf_cdc_scan(const void *data, int64_t n_pad, int64_t n,
                             uint32_t mask, int64_t min_chunk, void *words_be,
                             void *bitmap, void *stream) {
  ScanArgs a{};
  a.data = static_cast<const uint8_t *>(data);
  a.len = n_pad;
  a.lo = min_chunk > 32 ? min_chunk : 32;   // skip_ahead_threshold(min)
  a.hi = n;
  a.mask = mask;
  a.words_be = static_cast<uint32_t *>(words_be);
  a.bitmap = static_cast<uint32_t *>(bitmap);
  return static_cast<int>(launch_scan<kBlockScan>(
      cdc_scan_kernel, a, static_cast<cudaStream_t>(stream)));
}

// The scan's words-only mode: block bytes -> big-endian word image.
extern "C" int hdrf_be_image(const void *data, int64_t n_pad,
                             void *words_be, void *stream) {
  ScanArgs a{};
  a.data = static_cast<const uint8_t *>(data);
  a.len = n_pad;
  a.words_be = static_cast<uint32_t *>(words_be);
  return static_cast<int>(launch_scan<kImageOnly>(
      be_image_kernel, a, static_cast<cudaStream_t>(stream)));
}

// The select: candidate bitmap -> cut table + the two binned lane tables,
// in four launches on the stream; `scratch` holds
// (2 + 2 kReach) S lcap + kSegArrays S + kRunArrays cap + 1
// + 2 kTallyBlocks ints
// (S = ceil(n / W) segments of W positions, lcap = min(W, n) / min + 3).
extern "C" int hdrf_cdc_select(const void *bitmap, int64_t nbm, int64_t n,
                               int64_t min_chunk, int64_t max_chunk,
                               int32_t b_small, void *table, void *ols,
                               void *olb, int64_t cap, int64_t W,
                               void *scratch, void *stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W <= 0 || n <= 0 || n > INT32_MAX || min_chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t S = (n + W - 1) / W;
  if (S > kMaxSegs) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t lcap = (W < n ? W : n) / min_chunk + 3;
  // 32-bit walks: min(f + max, n) is unchanged by max clamped to n
  const int n32 = static_cast<int>(n);
  const int nbm32 = static_cast<int>(nbm < INT32_MAX ? nbm : INT32_MAX);
  const int mn = static_cast<int>(min_chunk < INT32_MAX ? min_chunk
                                                        : INT32_MAX);
  const int mx = static_cast<int>(max_chunk < n ? max_chunk : n);
  const auto bm = static_cast<const uint32_t *>(bitmap);
  auto scr = static_cast<int32_t *>(scratch);
  auto tab = static_cast<int32_t *>(table);
  const unsigned walk_blocks = static_cast<unsigned>(walk_blocks_of(S));
  cdc_select_spec_kernel<<<walk_blocks + kTallyBlocks, kWalkThreads, 0, s>>>(
      bm, nbm32, n32, mn, mx, b_small, W, S, lcap, cap, scr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cdc_select_converge_kernel<<<walk_blocks, kWalkThreads, 0, s>>>(
      bm, nbm32, n32, mn, mx, b_small, W, S, lcap, cap, scr);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const size_t smem = kWin * sizeof(uint32_t) + 3 * S * sizeof(int32_t);
  e = cudaFuncSetAttribute(cdc_select_stitch_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cdc_select_stitch_kernel<<<1, kStitchThreads, smem, s>>>(
      bm, nbm32, n32, mn, mx, b_small, W, S, lcap, cap, tab, scr);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  cdc_select_emit_kernel<<<walk_blocks, kWalkThreads, 0, s>>>(
      b_small, S, lcap, cap, scr, tab, static_cast<int32_t *>(ols),
      static_cast<int32_t *>(olb));
  return static_cast<int>(cudaGetLastError());
}

// The shard scan: shard bytes + halo -> candidate bitmap words + count.
extern "C" int hdrf_cdc_shard_scan(const void *local, const void *halo,
                                   int64_t m, int64_t base, uint32_t mask,
                                   void *words, void *count, void *stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  ScanArgs a{};
  a.data = static_cast<const uint8_t *>(local);
  a.halo = static_cast<const uint8_t *>(halo);
  a.len = m;
  a.lo = 32 - base;   // pos1 >= 32 of the whole block
  a.hi = m;
  a.mask = mask;
  a.bitmap = static_cast<uint32_t *>(words);
  a.count = static_cast<int32_t *>(count);
  return static_cast<int>(launch_scan<kShardScan>(cdc_shard_scan_kernel, a,
                                                  s));
}
