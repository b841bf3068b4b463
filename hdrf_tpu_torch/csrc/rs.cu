// GF(2^8) Reed-Solomon coefficient apply on Hopper (`rs_apply_kernel`):
// out[r, x] = XOR_j gf_mul(C[r, j], in[j, x]) for a coefficient matrix
// C u8[nrows, k] (nrows <= 8, k <= 24) and shard rows in u8[k, L].
//
// Replaces the jitted XLA program hdrf_tpu/ops/rs.py:167 `_bit_matmul`,
// filed by the JAX package under its "TPU kernels" heading: there every
// byte is expanded into eight f32 bit planes and parity is one MXU
// product (bitmat f32[nrows*8, k*8] @ planes f32[k*8, L]) mod 2, because
// table lookups scalarize on the TPU.  That expansion moves 32x the
// bytes; here the multiply is register work on packed bytes instead.
//
// Bound: bytes.  The call reads k*L bytes and writes nrows*L (an RS(6,3)
// encode of a 32 MiB container reads 33.6 MB and writes 16.8 MB, ~15 us
// at 3.35 TB/s).  The integer work is Horner over the coefficient bits,
// high bit first, on four packed bytes a word: for each output row,
// acc = xtime(acc) ^ XOR_j (shard j times bit b of C[r, j]), where xtime
// is the SWAR doubling of four bytes mod 0x11D,
// ((a & 0x7f7f7f7f) << 1) ^ (0x1d1d1d1d & the bytes whose top bit is
// set, one PRMT in sign-replicate mode): rows * (8k + 28) integer ops a
// word, ~320M for an RS(6,3) call, ~20 us on the INT32 pipe alone.
//
// The first version unrolled every shard loop 24 wide, guarded each term
// by a test of a bit mask, and kept a thread to one 16-byte unit: every
// output row cost 8 x 24 tests whatever k was (a 2-shard partial sum took
// as long as a 6-shard encode), and no load was in flight while a thread
// computed.  This design does three things about that:
//  - The kernel is a template on the shard count K (1..24, a switch in
//    hdrf_rs_apply), so a row costs 8K terms, not 8 x 24.
//  - A term is branch-free.  The launch parameters (up to 6 KB, within
//    CUDA 12.1+'s 32 KB; `__grid_constant__`) carry each coefficient bit
//    as a 0/1 multiplier m[r][b][j]: x_j * m is an IMAD on the FMA pipe
//    and the XOR of two terms one LOP3 on the INT pipe, so the work
//    splits between the two.  The rows are a loop at every K.
//  - The grid is persistent (occupancy x SMs), each thread walks several
//    16-byte units, and up to kPrefetchMaxK shards the next unit's loads
//    are issued before the current unit's arithmetic (two register sets).
// The forms were chosen on the card (kernel_times.py on variants of this
// source; PERF.md): the multiplier beat an AND mask (x_j & m, m 0 or ~0)
// by 11-14 % at k 2-6 by 3 rows; rows unrolled took 1.9-3x the loop's
// time at k 24 by 8 rows and spilled with the prefetch from k 20; the
// prefetch saved 8-12 % at k 6 and 10 by 3 rows (RS(6,3), RS(10,4)),
// cost up to 5 % at k 24 and spilled at k 19, 21, 23.
//
// Rows may start at any byte (stripe_len is ceil(length / k), and partial
// sums stack survivors of odd length): a load from a row that is not
// 16-byte aligned is five aligned words and a funnel shift (uniform per
// row, so the branch never diverges); the last unit of a row shorter than
// 16 bytes is loaded and stored byte by byte, and stores to a row that is
// not 16-byte aligned go out as words or bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 24;
constexpr int kMaxRows = 8;
constexpr int kPrefetchMaxK = 10;   // two register sets of K x 4 words

// m[r][b][j]: bit b of C[r, j], 0 or 1 (rows >= nrows 0)
template <int K>
struct RsCoef {
  uint32_t m[kMaxRows][8][K];
};

// 0xff in each byte of `a` whose top bit is set (prmt sign-replicate)
__device__ __forceinline__ uint32_t msb_bytes(uint32_t a) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0xba98;" : "=r"(r) : "r"(a), "r"(0u));
  return r;
}

__device__ __forceinline__ uint32_t xtime4(uint32_t a) {
  return ((a & 0x7f7f7f7fu) << 1) ^ (msb_bytes(a) & 0x1d1d1d1du);
}

__device__ __forceinline__ uint4 load16(const uint8_t *p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15u) == 0) return __ldg(reinterpret_cast<const uint4 *>(p));
  const uint32_t *w = reinterpret_cast<const uint32_t *>(a & ~uintptr_t(3));
  const uint32_t sh = static_cast<uint32_t>(a & 3u) * 8u;
  const uint32_t w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2),
                 w3 = __ldg(w + 3);
  // an aligned word start needs no fifth word (it may lie past the row)
  const uint32_t w4 = sh ? __ldg(w + 4) : 0u;
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// unit x0 of every shard row: 16 bytes, or the n < 16 bytes left
template <int K>
__device__ __forceinline__ void load_unit(uint32_t (&x)[K][4],
                                          const uint8_t *in,
                                          int64_t in_stride, int64_t x0,
                                          int n) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint8_t *p = in + j * in_stride + x0;
    if (n == 16) {
      const uint4 v = load16(p);
      x[j][0] = v.x; x[j][1] = v.y; x[j][2] = v.z; x[j][3] = v.w;
    } else {
      uint32_t t[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (i < n) t[i >> 2] |= static_cast<uint32_t>(p[i]) << (8 * (i & 3));
#pragma unroll
      for (int w = 0; w < 4; ++w) x[j][w] = t[w];
    }
  }
}

__device__ __forceinline__ void store_unit(uint8_t *p, const uint32_t v[4],
                                           int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n < 16) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < n) p[i] = static_cast<uint8_t>(v[i >> 2] >> (8 * (i & 3)));
  } else if ((a & 15u) == 0) {
    *reinterpret_cast<uint4 *>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if ((a & 3u) == 0) {
    uint32_t *w = reinterpret_cast<uint32_t *>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = v[i];
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      p[i] = static_cast<uint8_t>(v[i >> 2] >> (8 * (i & 3)));
  }
}

// one output row of one unit: Horner over the coefficient bits, m the
// row's per-bit terms m[b][j]
template <int K>
__device__ __forceinline__ void apply_row(const uint32_t (&x)[K][4],
                                          const uint32_t (&m)[8][K],
                                          uint8_t *q, int n) {
  uint32_t acc[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t a = 0u;
#pragma unroll
    for (int b = 7; b >= 0; --b) {
      if (b < 7) a = xtime4(a);
#pragma unroll
      for (int j = 0; j < K; ++j)
        a ^= x[j][w] * m[b][j];
    }
    acc[w] = a;
  }
  store_unit(q, acc, n);
}

// every output row of one unit
template <int K>
__device__ __forceinline__ void apply_unit(const uint32_t (&x)[K][4],
                                           const RsCoef<K> &co, int nrows,
                                           uint8_t *out, int64_t out_stride,
                                           int64_t x0, int n) {
#pragma unroll 1
  for (int r = 0; r < nrows; ++r)
    apply_row<K>(x, co.m[r], out + r * out_stride + x0, n);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
rs_apply_kernel(const uint8_t *__restrict__ in, int64_t in_stride,
                uint8_t *__restrict__ out, int64_t out_stride, int nrows,
                int64_t L, const __grid_constant__ RsCoef<K> co) {
  const int64_t units = (L + 15) / 16;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t u = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const auto len = [L](int64_t v) {
    return static_cast<int>(L - v * 16 < 16 ? L - v * 16 : 16);
  };
  if (K <= kPrefetchMaxK) {
    // the next unit's loads go out before this unit's arithmetic
    uint32_t x[K][4], nx[K][4];
    if (u < units) load_unit<K>(nx, in, in_stride, u * 16, len(u));
    for (; u < units; u += step) {
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int w = 0; w < 4; ++w) x[j][w] = nx[j][w];
      if (u + step < units)
        load_unit<K>(nx, in, in_stride, (u + step) * 16, len(u + step));
      apply_unit<K>(x, co, nrows, out, out_stride, u * 16, len(u));
    }
  } else {
    for (; u < units; u += step) {
      uint32_t x[K][4];
      load_unit<K>(x, in, in_stride, u * 16, len(u));
      apply_unit<K>(x, co, nrows, out, out_stride, u * 16, len(u));
    }
  }
}

// SMs x resident blocks of rs_apply_kernel<K>: queried at the first
// launch of each K (a function-local static, initialised once and
// thread-safely; the port drives one kind of card)
template <int K>
int64_t grid_cap() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rs_apply_kernel<K>,
                                                kThreads, 0);
  return static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

template <int K>
int launch(const uint8_t *in, int64_t in_stride, uint8_t *out,
           int64_t out_stride, int nrows, int64_t L, const uint8_t *c,
           cudaStream_t stream) {
  RsCoef<K> co = {};
  for (int r = 0; r < nrows; ++r)
    for (int b = 0; b < 8; ++b)
      for (int j = 0; j < K; ++j) co.m[r][b][j] = (c[r * K + j] >> b) & 1u;
  // persistent grid: as many blocks as fit on the card
  static const int64_t cap = grid_cap<K>();
  const int64_t units = (L + 15) / 16;
  int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  rs_apply_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      in, in_stride, out, out_stride, nrows, L, co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: u8 rows of L bytes, row j at in + j * in_stride; out likewise with
// out_stride; coef: HOST u8[nrows, k] row-major (copied into the launch
// parameters, so it need only live until this call returns).
extern "C" int hdrf_rs_apply(const void *in, int64_t in_stride, int32_t k,
                             void *out, int64_t out_stride, int32_t nrows,
                             int64_t L, const void *coef, void *stream) {
  if (k < 1 || k > kMaxK || nrows < 1 || nrows > kMaxRows || L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  const auto *i = static_cast<const uint8_t *>(in);
  auto *o = static_cast<uint8_t *>(out);
  const auto *c = static_cast<const uint8_t *>(coef);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define HDRF_RS_K(n) \
    case n: return launch<n>(i, in_stride, o, out_stride, nrows, L, c, s);
    HDRF_RS_K(1) HDRF_RS_K(2) HDRF_RS_K(3) HDRF_RS_K(4) HDRF_RS_K(5)
    HDRF_RS_K(6) HDRF_RS_K(7) HDRF_RS_K(8) HDRF_RS_K(9) HDRF_RS_K(10)
    HDRF_RS_K(11) HDRF_RS_K(12) HDRF_RS_K(13) HDRF_RS_K(14) HDRF_RS_K(15)
    HDRF_RS_K(16) HDRF_RS_K(17) HDRF_RS_K(18) HDRF_RS_K(19) HDRF_RS_K(20)
    HDRF_RS_K(21) HDRF_RS_K(22) HDRF_RS_K(23) HDRF_RS_K(24)
#undef HDRF_RS_K
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
