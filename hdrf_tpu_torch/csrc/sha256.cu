// SHA-256 compression on Hopper: one consumer thread per message lane, fed
// by a producer warp through shared memory, over one or two lane tables
// in one launch.
//
// Replaces the Pallas `_kernel` of hdrf_tpu/ops/sha256_pallas.py
// (pallas_call at sha256_pallas.py:99).  Input per table: pre-padded
// big-endian messages msgs[L][W] (W = B*16 u32 words), per-lane block
// counts and an optional lane order; output: digests u8[L][32].  A lane
// stops at its own block count (a lane past its count holds its state).
//
// A lane is serial (Merkle–Damgård), so a launch lasts as long as its
// longest lane's chain of compressions (1,025 for a 64 KiB chunk).  The
// design takes everything but the rounds off that chain:
//
// - A pair of warps takes a unit of 32 lanes: the consumer runs the 64
//   rounds, one lane a thread; the producer stages message blocks and
//   computes the schedule.  A thread block holds two pairs, each synced by
//   its own named barrier.
// - The producer keeps kStages message blocks per lane in flight in a
//   shared-memory ring with cp.async: four threads copy one lane's 64-byte
//   block (a warp instruction moves eight whole blocks), 16-byte chunks
//   swizzled so that the read back is free of bank conflicts.
// - While the consumer runs block b's rounds, the producer computes block
//   b + 1's W[t] + K[t] (t < 64) into the other half of a double buffer;
//   one pair barrier a block hands it over.  The consumer adds h one
//   round early (h at round t is g at round t - 1) and d with it, so a
//   round's chain to the new e is Sigma1 (SHF, LOP3) and two adds.
// - One launch covers both of a block's lane tables, the big bucket's
//   units first and its lanes longest first (undone on store).  With big
//   lanes possible (past 256 compressions), one block stays resident per
//   SM and its pairs take
//   units in order from a counter: the longest chains start at once, each
//   warp alone in its SM sub-partition (a second warp there would take
//   dispatch slots from the chain), and the other pairs work through the
//   rest.  With short lanes alone, one pair a unit, as many per SM as fit.
// - A warp's integer ALU pipe takes a warp instruction every second cycle.
//   With short lanes alone the rounds put all 7 adds on the FMA pipe (IMAD
//   by a 1 the compiler cannot fold) beside the 10 rotates and logic ops,
//   which raises throughput when warps share a sub-partition; with long
//   chains they keep the compiler's adds, which measured faster for a
//   warp alone.
// - Every lane is hashed: each unit checks its lanes against L, so the
//   tail fault of sha256_pallas.py:82-86 cannot recur.
//
// Bound: the larger of integer operations (1,384 a 64-byte block as sm_90
// executes them) and the longest lane's chain: 64 rounds of a dependent
// SHF -> LOP3 -> IADD3 a compression (sha_chain_probe_kernel measures that
// latency on the card).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;    // lanes of a unit, one consumer thread each
constexpr int kPairs = 2;     // consumer + producer warp pairs per block
constexpr int kStages = 4;    // message blocks per lane in flight

// A pair's shared memory: the message ring and the schedule double buffer.
struct PairSmem {
  uint32_t msg[kStages][kLanes][16];
  uint4 sched[2][16][kLanes];   // W[t] + K[t]
};
constexpr int kSmem = kPairs * static_cast<int>(sizeof(PairSmem));   // 48 KiB
// Dynamic shared memory that keeps a second block off an SM (228 KiB):
// one block, its four warps one to a sub-partition.
constexpr int kResidentSmem = 120 * 1024;
// Table 0 lanes that can run past this many compressions (16 KiB chunks)
// make a launch chain-bound.
constexpr int kLongChain = 256;

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, uint32_t n) {
  return __funnelshift_r(x, x, n);
}

// a + b as IMAD a * one + b: `one` is a launch argument (1) the compiler
// cannot fold, so the add goes to the FMA pipe and leaves the integer ALU
// pipe, which takes a warp instruction every second cycle, to the rotates
// and logic ops.
__device__ __forceinline__ uint32_t fadd(uint32_t a, uint32_t b,
                                         uint32_t one) {
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(one), "r"(b));
  return r;
}

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16-byte chunk c of a lane's staged block: swizzled by the lane so that
// eight lanes reading the same chunk hit eight distinct bank quads.
__device__ __forceinline__ int chunk_at(int lane, int c) {
  return 4 * (c ^ ((lane >> 1) & 3));
}

// Producer: start the copies of message block blk of the 32 lanes into
// its ring stage (this thread's four 16-byte chunks), one commit group.
__device__ __forceinline__ void stage(uint32_t (*msg)[kLanes][16],
                                      const uint32_t *const *src,
                                      const int32_t *src_nb, int lane,
                                      int32_t blk) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int l = (lane >> 2) + 8 * m;
    if (blk < src_nb[m])
      cp_async16(&msg[blk % kStages][l][chunk_at(l, lane & 3)],
                 src[m] + blk * 16);
  }
  cp_async_commit();
}

// Producer: W[t] + K[t] of this thread's lane's staged block blk into
// half blk & 1 of the schedule buffer.
__device__ __forceinline__ void schedule(uint32_t (*msg)[kLanes][16],
                                         uint4 (*sched)[16][kLanes], int lane,
                                         int32_t blk, uint32_t one) {
  uint32_t w[16];
  const uint32_t *m = msg[blk % kStages][lane];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint4 x = *reinterpret_cast<const uint4 *>(m + chunk_at(lane, c));
    w[4 * c] = x.x;
    w[4 * c + 1] = x.y;
    w[4 * c + 2] = x.z;
    w[4 * c + 3] = x.w;
  }
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    uint32_t o[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * q + r;
      if (i >= 16) {
        const uint32_t x15 = w[(i - 15) & 15], x2 = w[(i - 2) & 15];
        w[i & 15] = fadd(
            fadd(w[i & 15], w[(i - 7) & 15], one),
            fadd(rotr(x15, 7) ^ rotr(x15, 18) ^ (x15 >> 3),
                 rotr(x2, 17) ^ rotr(x2, 19) ^ (x2 >> 10), one),
            one);
      }
      o[r] = fadd(w[i & 15], kK[i], one);
    }
    sched[blk & 1][q][lane] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// The 64 rounds of one compression from W[t] + K[t].  With kFma every add
// runs on the FMA pipe (more throughput when many warps share an SM
// sub-partition); without, the adds are the compiler's IADD3s on the ALU
// pipe (the shorter chain, for a long lane whose warp runs alone).
template <bool kFma>
__device__ __forceinline__ void compress(uint32_t &a, uint32_t &b,
                                         uint32_t &c, uint32_t &d,
                                         uint32_t &e, uint32_t &f,
                                         uint32_t &g, uint32_t &h,
                                         const uint32_t *kw, uint32_t one) {
  auto add = [one](uint32_t x, uint32_t y) {
    return kFma ? fadd(x, y, one) : x + y;
  };
  uint32_t hk = add(h, kw[0]);   // h + K[t] + W[t]
  uint32_t dhk = add(d, hk);     // and d: the new e's addend
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = g ^ (e & (f ^ g));
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) | (c & (a | b));
    const uint32_t t = add(S1, ch);
    const uint32_t ne = add(dhk, t);
    const uint32_t na = add(add(S0, maj), add(hk, t));
    if (i + 1 < 64) {   // next round's h is this g, its d this c
      hk = add(g, kw[i + 1]);
      dhk = add(c, hk);
    }
    h = g;
    g = f;
    f = e;
    e = ne;
    d = c;
    c = b;
    b = a;
    a = na;
  }
}

struct Table {
  const uint32_t *msgs;
  const int32_t *nblocks;
  const int32_t *order;   // lane of each slot, or null (identity)
  uint32_t *out;
  int64_t L;
  int32_t W;
};

// Named barrier of one consumer + producer pair (64 threads).
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + pair), "r"(2 * kLanes)
               : "memory");
}

// One unit = 32 lanes of one table.  The pairs walk the units in order
// (table 0's first): pair x starts at unit x and takes the next free one
// from `next` when it is done.  kFma: the rounds' adds on the FMA pipe.
template <bool kFma>
__global__ void __launch_bounds__(2 * kLanes * kPairs)
sha256_kernel(Table t0, Table t1, int64_t units0, int64_t units,
              int *__restrict__ next, uint32_t one) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int64_t next_unit[kPairs];
  const int pair = threadIdx.x / (2 * kLanes);
  PairSmem &sm = reinterpret_cast<PairSmem *>(smem_raw)[pair];
  const int lane = threadIdx.x & 31;
  const bool producer = (threadIdx.x / kLanes) & 1;
  const bool leader = (threadIdx.x & (2 * kLanes - 1)) == 0;
  for (int64_t unit = static_cast<int64_t>(blockIdx.x) * kPairs + pair;
       unit < units;) {
    const bool second = unit >= units0;
    const Table tb = second ? t1 : t0;
    const int64_t slot = (second ? unit - units0 : unit) * kLanes + lane;
    int64_t li = 0;   // this thread's lane (both warps hold the same 32)
    int32_t nb = 0;
    if (slot < tb.L) {
      li = tb.order ? tb.order[slot] : slot;
      nb = tb.nblocks[li];
      nb = nb < 0 ? 0 : (nb > tb.W / 16 ? tb.W / 16 : nb);
    }
    const int32_t nmax = __reduce_max_sync(0xFFFFFFFFu, nb);

    // Producer: thread x copies chunk x & 3 of lane x >> 2 (+ 8 m) of
    // each staged block; then computes its own lane's schedule.
    const uint32_t *src[4];
    int32_t src_nb[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int l = (lane >> 2) + 8 * m;
      const int64_t sl = __shfl_sync(0xFFFFFFFFu, li, l);
      src_nb[m] = __shfl_sync(0xFFFFFFFFu, nb, l);
      src[m] = tb.msgs + sl * tb.W + 4 * (lane & 3);
    }

    uint32_t s0 = 0x6a09e667u, s1 = 0xbb67ae85u, s2 = 0x3c6ef372u,
             s3 = 0xa54ff53au, s4 = 0x510e527fu, s5 = 0x9b05688cu,
             s6 = 0x1f83d9abu, s7 = 0x5be0cd19u;
    if (producer && nmax > 0) {
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s)
        stage(sm.msg, src, src_nb, lane, s);
      cp_async_wait<kStages - 2>();
      __syncwarp();
      schedule(sm.msg, sm.sched, lane, 0, one);
    }
    pair_sync(pair);
    for (int32_t blk = 0; blk < nmax; ++blk) {
      if (producer) {
        if (blk + 1 < nmax) {
          stage(sm.msg, src, src_nb, lane, blk + kStages - 1);
          cp_async_wait<kStages - 2>();   // block blk + 1 has landed
          __syncwarp();
          schedule(sm.msg, sm.sched, lane, blk + 1, one);
        }
      } else {
        uint32_t kw[64];
        const uint4 *in = sm.sched[blk & 1][0] + lane;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const uint4 x = in[q * kLanes];
          kw[4 * q] = x.x;
          kw[4 * q + 1] = x.y;
          kw[4 * q + 2] = x.z;
          kw[4 * q + 3] = x.w;
        }
        uint32_t a = s0, b = s1, c = s2, d = s3, e = s4, f = s5, g = s6,
                 h = s7;
        compress<kFma>(a, b, c, d, e, f, g, h, kw, one);
        if (blk < nb) {
          s0 += a; s1 += b; s2 += c; s3 += d;
          s4 += e; s5 += f; s6 += g; s7 += h;
        }
      }
      pair_sync(pair);
    }
    if (!producer && slot < tb.L) {
      // big-endian digest bytes: byte-swap each state word on store
      uint4 *o = reinterpret_cast<uint4 *>(tb.out + li * 8);
      o[0] = make_uint4(__byte_perm(s0, 0, 0x0123),
                        __byte_perm(s1, 0, 0x0123),
                        __byte_perm(s2, 0, 0x0123),
                        __byte_perm(s3, 0, 0x0123));
      o[1] = make_uint4(__byte_perm(s4, 0, 0x0123),
                        __byte_perm(s5, 0, 0x0123),
                        __byte_perm(s6, 0, 0x0123),
                        __byte_perm(s7, 0, 0x0123));
    }
    if (leader)
      next_unit[pair] = atomicAdd(next, 1) + int64_t{gridDim.x} * kPairs;
    pair_sync(pair);
    unit = next_unit[pair];
    pair_sync(pair);   // both warps have read it before it is rewritten
  }
}

// One thread walks `iters` x 16 links of a dependent SHF -> LOP3 -> IADD3
// chain (a SHA-256 round's critical path); y and z are launch arguments,
// so nothing folds.  cycles[0] = SM clocks over the walk.
__global__ void sha_chain_probe_kernel(uint32_t x, uint32_t y, uint32_t z,
                                       int iters, uint32_t *out,
                                       long long *cycles) {
  uint32_t v = x;
  const long long c0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      v = rotr(v, 6);
      v = v ^ y ^ z;
      v = v + y + z;
    }
  }
  const long long c1 = clock64();
  out[0] = v;
  cycles[0] = c1 - c0;
}


Table make_table(const void *msgs, int64_t L, int32_t W, const void *nb,
                 const void *order, void *out) {
  return Table{static_cast<const uint32_t *>(msgs),
               static_cast<const int32_t *>(nb),
               static_cast<const int32_t *>(order),
               static_cast<uint32_t *>(out), L, W};
}

}  // namespace

// SHA-256 of up to two lane tables in one launch, table 0's units first.
// A table with L = 0 is skipped; order may be null; `next` is one int,
// zeroed.  When table 0 holds lanes that can run past kLongChain blocks
// (the big bucket), one block stays resident on each SM (its shared memory
// keeps a second off), its two pairs' four warps one to a sub-partition,
// and the pairs walk the units: a long chain's warp then shares its
// sub-partition with no other warp.  Otherwise (short lanes only) one
// pair a unit, as many blocks as fit.
extern "C" int hdrf_sha256(const void *msgs0, int64_t L0, int32_t W0,
                           const void *nb0, const void *order0, void *out0,
                           const void *msgs1, int64_t L1, int32_t W1,
                           const void *nb1, const void *order1, void *out1,
                           void *next, void *stream) {
  const int64_t units0 = (L0 + kLanes - 1) / kLanes;
  const int64_t units = units0 + (L1 + kLanes - 1) / kLanes;
  if (units == 0) return 0;
  int64_t grid = (units + kPairs - 1) / kPairs;
  const Table t0 = make_table(msgs0, L0, W0, nb0, order0, out0);
  const Table t1 = make_table(msgs1, L1, W1, nb1, order1, out1);
  auto s = static_cast<cudaStream_t>(stream);
  auto *n = static_cast<int *>(next);
  cudaError_t err;
  if (units0 && W0 / 16 > kLongChain) {   // one resident block per SM
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(sha256_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kResidentSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    grid = grid < sms ? grid : sms;
    sha256_kernel<false><<<static_cast<unsigned>(grid), 2 * kLanes * kPairs,
                           kResidentSmem, s>>>(t0, t1, units0, units, n, 1u);
  } else {   // short lanes only: as many blocks as fit, FMA adds
    err = cudaFuncSetAttribute(sha256_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sha256_kernel<true><<<static_cast<unsigned>(grid), 2 * kLanes * kPairs,
                          kSmem, s>>>(t0, t1, units0, units, n, 1u);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hdrf_sha_chain_probe(uint32_t x, uint32_t y, uint32_t z,
                                    int32_t iters, void *out, void *cycles,
                                    void *stream) {
  sha_chain_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, iters, static_cast<uint32_t *>(out),
      static_cast<long long *>(cycles));
  return static_cast<int>(cudaGetLastError());
}
