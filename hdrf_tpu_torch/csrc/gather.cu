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
// dynamic_slice and funnel shift): the same loop without the pad — every
// one of the lane's W words is the funnel shift of image words q + j and
// q + j + 1, the words past the chunk's length included (they are the
// image's next bytes, not zeros).  Bound: bytes — the image bytes under
// the union of the lanes' W + 1 word windows read once (neighbouring
// chunks' windows overlap), each lane's W words written once.

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

__global__ void __launch_bounds__(kThreads)
gather_raw_kernel(const uint32_t *__restrict__ words, int64_t nw,
                  const int32_t *__restrict__ offs, int32_t W,
                  uint32_t *__restrict__ out) {
  const int64_t lane = blockIdx.x;
  const int64_t off = offs[lane];
  const uint32_t s8 = static_cast<uint32_t>(off & 3) * 8u;
  const int64_t q0 = off >> 2;
  uint32_t *o = out + lane * static_cast<int64_t>(W);
  for (int32_t j = threadIdx.x; j < W; j += kThreads) {
    const int64_t q = q0 + j;
    const uint32_t a = q < nw ? words[q] : 0u;
    uint32_t c = a;
    if (s8) {
      const uint32_t b = q + 1 < nw ? words[q + 1] : 0u;
      c = (a << s8) | (b >> (32u - s8));
    }
    o[j] = c;
  }
}

}  // namespace

extern "C" int hdrf_gather_raw(const void *words, int64_t nw,
                               const void *offs, int64_t L, int32_t W,
                               void *out, void *stream) {
  gather_raw_kernel<<<static_cast<unsigned>(L), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t *>(words), nw,
      static_cast<const int32_t *>(offs), W, static_cast<uint32_t *>(out));
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
