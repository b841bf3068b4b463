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
// at 3.35 TB/s); the least integer work, the bit matrix applied bit-sliced
// (one 32-bit XOR per set bit-matrix entry per 32 positions), is ~1 XOR
// a byte per coefficient, several times under the byte time.
//
// Design: a thread owns 16 byte positions (4 words of 4 packed bytes).
// It loads all k shards' 16 bytes once (one 16-byte load per row when
// the row address is 16-byte aligned, otherwise five aligned words and a
// funnel shift; the alignment is the same for every thread of a row, so
// the branch never diverges), then for each output row runs Horner over
// the coefficient bits, high bit first: acc = xtime(acc) ^ XOR of the
// shards whose coefficient has that bit.  xtime is the SWAR doubling of
// four bytes in GF(2^8) mod 0x11D, ((a & 0x7f7f7f7f) << 1) ^
// (((a >> 7) & 0x01010101) * 0x1d).  The coefficients ride in the launch
// parameters as bit masks (mask[r][b] has bit j set when bit b of
// C[r, j] is), so their tests are uniform and no table sits in shared
// memory.  Rows may start at any byte (stripe_len is ceil(length / k),
// and partial sums stack survivors of odd length); the last unit of a
// row shorter than 16 bytes is loaded and stored byte by byte, and
// stores to a row that is not 16-byte aligned go out as words or bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 24;
constexpr int kMaxRows = 8;

struct RsMasks {
  uint32_t m[kMaxRows][8];   // [row][coefficient bit] -> bit j per shard
};

__device__ __forceinline__ uint32_t xtime4(uint32_t a) {
  return ((a << 1) & 0xfefefefeu) ^ (((a >> 7) & 0x01010101u) * 0x1du);
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

__device__ __forceinline__ void store16(uint8_t *p, const uint32_t v[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15u) == 0) {
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

__global__ void __launch_bounds__(kThreads)
rs_apply_kernel(const uint8_t *__restrict__ in, int64_t in_stride, int k,
                uint8_t *__restrict__ out, int64_t out_stride, int nrows,
                int64_t L, RsMasks masks) {
  const int64_t units = (L + 15) / 16;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       u < units; u += step) {
    const int64_t x0 = u * 16;
    const int n = static_cast<int>(L - x0 < 16 ? L - x0 : 16);
    uint32_t x[kMaxK][4];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k) {
        const uint8_t *p = in + j * in_stride + x0;
        if (n == 16) {
          const uint4 v = load16(p);
          x[j][0] = v.x; x[j][1] = v.y; x[j][2] = v.z; x[j][3] = v.w;
        } else {
          uint32_t t[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (i < n)
              t[i >> 2] |= static_cast<uint32_t>(p[i]) << (8 * (i & 3));
#pragma unroll
          for (int w = 0; w < 4; ++w) x[j][w] = t[w];
        }
      }
    }
    for (int r = 0; r < nrows; ++r) {
      uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int b = 7; b >= 0; --b) {
        const uint32_t mb = masks.m[r][b];
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[w] = xtime4(acc[w]);
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) {
          if (j < k && ((mb >> j) & 1u)) {
#pragma unroll
            for (int w = 0; w < 4; ++w) acc[w] ^= x[j][w];
          }
        }
      }
      uint8_t *q = out + r * out_stride + x0;
      if (n == 16) {
        store16(q, acc);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (i < n) q[i] = static_cast<uint8_t>(acc[i >> 2] >> (8 * (i & 3)));
      }
    }
  }
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
  RsMasks masks = {};
  const uint8_t *c = static_cast<const uint8_t *>(coef);
  for (int r = 0; r < nrows; ++r)
    for (int j = 0; j < k; ++j)
      for (int b = 0; b < 8; ++b)
        if ((c[r * k + j] >> b) & 1u) masks.m[r][b] |= 1u << j;
  const int64_t units = (L + 15) / 16;
  int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;
  rs_apply_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t *>(in), in_stride, k,
      static_cast<uint8_t *>(out), out_stride, nrows, L, masks);
  return static_cast<int>(cudaGetLastError());
}
