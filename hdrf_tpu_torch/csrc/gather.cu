// Chunk-lane gathers on Hopper: the write path's gather with SHA-256
// padding (`gather_pad_kernel`) and the read path's raw gather
// (`gather_raw_kernel`).
//
// gather_pad_kernel replaces the Pallas `_kernel` of
// hdrf_tpu/ops/gather_pallas.py (pallas_call at gather_pallas.py:122).  The TPU kernel DMAs whole
// 512-byte rows of the word image and realigns them with a roll pair; the
// card loads words at any index, so one thread block per lane simply
// strides over the lane's output words.  Output word j of a lane at byte
// offset `off` is the funnel shift of image words q + j and q + j + 1
// (q = off / 4), neighbouring threads reading neighbouring words.  The
// 0x80 marker, zero fill and 32-bit bit length are spliced in exactly as
// hdrf_tpu/ops/resident.py:158-193 (`sha_pad_messages`); words past the
// last real block are written as zeros without a load.  Reads past the
// end of the image return zero, so the image needs no pad words.
//
// Bound: bytes — the chunk bytes read once, the padded messages written
// once.
//
// gather_raw_kernel replaces the jitted XLA program
// hdrf_tpu/ops/reconstruct.py:46-60 (`gather_lanes_raw`, a vmapped
// dynamic_slice and funnel shift): every one of the lane's W words is the
// funnel shift of image words q + j and q + j + 1, the words past the
// chunk's length included (they are the image's next bytes, not zeros).
// Bound: bytes — the image bytes under the union of the lanes' W + 1 word
// windows read once (neighbouring chunks' windows overlap), each lane's W
// words written once.
//
// Its first version ran one 256-thread block per lane, each thread making
// two 4-byte loads (words q + j and q + j + 1, the second its
// neighbour's first) for one 4-byte store.  The read path pads a group
// to 128 lanes and most groups hold few chunks, so a launch was often
// 128 blocks — one per SM — and latency set the time.  Now the grid is
// flat over (lane, 4-word quad): W / 4 >= 64 threads a lane, so a warp
// never straddles two lanes, and even a 128-lane launch at the smallest
// bucket is 256 warps.  A thread makes one 16-byte load of the aligned
// quad holding its first window word, takes the next quad from the
// neighbouring thread by shuffle (the warp's last thread loads it), picks
// its five window words (the offset within the quad is the same for the
// whole warp) and writes its four shifted words as one 16-byte store.  A
// quad that is not wholly inside the image is loaded word by word, words
// past the image reading zero.  In byte order (`kBytes`) each word is
// byte-reversed at the store (`__byte_perm(v, 0, 0x0123)`), so the lane is
// the chunk's raw bytes and the read path needs no separate byte swap.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_pad_kernel(const uint32_t *__restrict__ words, int64_t nw,
                  const int32_t *__restrict__ offs,
                  const int32_t *__restrict__ lens, int32_t W,
                  uint32_t *__restrict__ out) {
  const int64_t lane = blockIdx.x;
  const int64_t off = offs[lane];
  const int32_t ln = lens[lane];
  const int32_t nb = (ln + 9 + 63) / 64;
  const int32_t last = nb * 16 - 1;     // word holding the bit length
  const int32_t wl = ln >> 2;           // word holding byte `ln`
  const uint32_t r8 = static_cast<uint32_t>(ln & 3) * 8u;
  const uint32_t s8 = static_cast<uint32_t>(off & 3) * 8u;
  const int64_t q0 = off >> 2;
  uint32_t *o = out + lane * static_cast<int64_t>(W);
  for (int32_t j = threadIdx.x; j < W; j += kThreads) {
    uint32_t v = 0u;
    if (j == last) {
      v = static_cast<uint32_t>(ln) * 8u;
    } else if (j <= wl) {
      const int64_t q = q0 + j;
      const uint32_t a = q < nw ? words[q] : 0u;
      uint32_t c = a;
      if (s8) {
        const uint32_t b = q + 1 < nw ? words[q + 1] : 0u;
        c = (a << s8) | (b >> (32u - s8));
      }
      if (j < wl) {
        v = c;
      } else {
        const uint32_t keep = r8 ? (0xFFFFFFFFu << (32u - r8)) : 0u;
        v = (c & keep) | (0x80u << (24u - r8));
      }
    }
    o[j] = v;
  }
}

// quad `c` of the image (words 4c - p .. 4c - p + 3 of `words`, whose
// first word lies p words past a 16-byte boundary); words outside
// [0, nw) read zero
__device__ __forceinline__ uint4 image_quad(const uint32_t *words, int64_t nw,
                                            int64_t c, int p) {
  const int64_t i0 = 4 * c - p;
  if (i0 >= 0 && i0 + 3 < nw)
    return __ldg(reinterpret_cast<const uint4 *>(words + i0));
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = (i0 + i >= 0 && i0 + i < nw) ? __ldg(words + i0 + i) : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <bool kBytes>
__global__ void __launch_bounds__(kThreads)
gather_raw_kernel(const uint32_t *__restrict__ words, int64_t nw,
                  const int32_t *__restrict__ offs, int32_t W,
                  int32_t quads_log2, int64_t total,
                  uint32_t *__restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;   // total is a multiple of 64: whole warps leave
  const int64_t lane = t >> quads_log2;
  const int64_t g = t & ((int64_t{1} << quads_log2) - 1);
  const int64_t off = offs[lane];
  const uint32_t s8 = static_cast<uint32_t>(off & 3) * 8u;
  const int p = static_cast<int>((reinterpret_cast<uintptr_t>(words) >> 2) & 3);
  const int64_t a = (off >> 2) + p + 4 * g;   // first window word, from 16 B
  const int r = static_cast<int>(a & 3);      // the same across the warp
  const uint4 q0 = image_quad(words, nw, a >> 2, p);
  uint4 q1;
  q1.x = __shfl_down_sync(0xffffffffu, q0.x, 1);
  q1.y = __shfl_down_sync(0xffffffffu, q0.y, 1);
  q1.z = __shfl_down_sync(0xffffffffu, q0.z, 1);
  q1.w = __shfl_down_sync(0xffffffffu, q0.w, 1);
  if ((threadIdx.x & 31) == 31) q1 = image_quad(words, nw, (a >> 2) + 1, p);
  uint32_t w[5];
  switch (r) {
    case 0: w[0] = q0.x; w[1] = q0.y; w[2] = q0.z; w[3] = q0.w; w[4] = q1.x;
            break;
    case 1: w[0] = q0.y; w[1] = q0.z; w[2] = q0.w; w[3] = q1.x; w[4] = q1.y;
            break;
    case 2: w[0] = q0.z; w[1] = q0.w; w[2] = q1.x; w[3] = q1.y; w[4] = q1.z;
            break;
    default: w[0] = q0.w; w[1] = q1.x; w[2] = q1.y; w[3] = q1.z; w[4] = q1.w;
  }
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = __funnelshift_l(w[i + 1], w[i], s8);   // (w_i << s8) | ...
    if (kBytes) v[i] = __byte_perm(v[i], 0, 0x0123);
  }
  *reinterpret_cast<uint4 *>(out + lane * static_cast<int64_t>(W) + 4 * g) =
      make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace

// out: L x W words, 16-byte aligned; W = bucket * 16 (a power of two
// >= 256); bytes != 0 stores each word byte-reversed (the chunk's bytes)
extern "C" int hdrf_gather_raw(const void *words, int64_t nw,
                               const void *offs, int64_t L, int32_t W,
                               int32_t bytes, void *out, void *stream) {
  if (W < 256 || (W & (W - 1)) || (reinterpret_cast<uintptr_t>(out) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  int quads_log2 = 0;
  while ((4 << quads_log2) < W) ++quads_log2;
  const int64_t total = L << quads_log2;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) /
                                                kThreads);
  const auto *w = static_cast<const uint32_t *>(words);
  const auto *o = static_cast<const int32_t *>(offs);
  auto *dst = static_cast<uint32_t *>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (bytes)
    gather_raw_kernel<true><<<blocks, kThreads, 0, s>>>(w, nw, o, W,
                                                        quads_log2, total, dst);
  else
    gather_raw_kernel<false><<<blocks, kThreads, 0, s>>>(w, nw, o, W,
                                                         quads_log2, total, dst);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hdrf_gather_pad(const void *words, int64_t nw,
                               const void *offs, const void *lens, int64_t L,
                               int32_t W, void *out, void *stream) {
  gather_pad_kernel<<<static_cast<unsigned>(L), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t *>(words), nw,
      static_cast<const int32_t *>(offs), static_cast<const int32_t *>(lens),
      W, static_cast<uint32_t *>(out));
  return static_cast<int>(cudaGetLastError());
}
