// Gear candidates and min/max cut select — the port's host oracle.
//
// The port's copy of hdrf_tpu/native/src/cdc.cpp without its fused
// one-call chunker, unchanged below this note: the host cut select of
// the sharded reduction (parallel/sharded.reduce_sharded) and the
// independent candidate oracle chip_smoke.py holds the kernels to.
// Where the comments name the TPU kernel, the port's counterpart is
// hdrf_tpu_torch/csrc/cdc.cu.
//
// Content-defined chunking (Gear rolling hash) — native CPU backend.
//
// Re-designs the reference's local-maximum CDC (DataDeduplicator.java:264-307,
// window 700 B, max chunk 1 MB) as Gear-hash CDC: h = (h << 1) + G[byte], with a
// cut-point candidate wherever (h & mask) == 0. Because `h << 1` discards a byte's
// contribution after 32 shifts, the hash at position p is a pure function of the
// trailing 32 bytes — making the candidate set position-independent and therefore
// (a) content-defined under insertions/deletions and (b) computable in parallel,
// which is what lets the same algorithm run as a TPU kernel (ops/cdc.py).
//
// The boundary *selection* (enforce min/max chunk) is inherently sequential but
// touches only the sparse candidate list (~len/2^mask_bits entries).

#include <cstdint>
#include <cstring>

namespace {

// Deterministic gear function shared with the JAX implementation (ops/gear.py):
// G[b] = fmix32(b * 0x9E3779B1) (murmur3 finalizer). Chosen to be *arithmetic*
// so the TPU side computes it with 6 elementwise VPU ops instead of a 256-entry
// gather (which scalarizes on TPU); the CPU side pre-tabulates it.
uint32_t fmix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

struct GearTable {
  uint32_t g[256];
  GearTable() {
    for (int i = 0; i < 256; i++) g[i] = fmix32(uint32_t(i) * 0x9E3779B1u);
  }
};
const GearTable GT;

}  // namespace

extern "C" {

// Expose the gear table so Python/JAX builds bit-identical copies.
void hdrf_gear_table(uint32_t out[256]) { memcpy(out, GT.g, sizeof(GT.g)); }

// All candidate cut-points: p in [32, len] such that the gear hash of bytes
// [p-32, p) satisfies (h & mask) == 0. Cut-point p means "chunk may end before
// byte p". Returns the TOTAL number of candidates found (may exceed cap; only
// the first cap are written — callers detect overflow and retry with a larger
// buffer).
uint64_t hdrf_gear_candidates(const uint8_t *data, uint64_t len, uint32_t mask,
                              uint64_t *out_pos, uint64_t cap) {
  uint32_t h = 0;
  uint64_t n = 0;
  for (uint64_t i = 0; i < len; i++) {
    h = (h << 1) + GT.g[data[i]];
    if (i + 1 >= 32 && (h & mask) == 0) {
      if (n < cap) out_pos[n] = i + 1;
      n++;
    }
  }
  return n;
}

// Select chunk boundaries from a sorted candidate list, enforcing min/max chunk
// sizes. Shared by the CPU and TPU paths (the TPU kernel emits candidates; this
// resolves them). Rule per chunk starting at `start`:
//   lo = start + min_chunk, hi = min(start + max_chunk, len)
//   cut = first candidate in [lo, hi], else hi.
// Writes cut-points (exclusive chunk ends); the final cut is always `len`.
// Requires min_chunk >= 1 (guarantees progress). Returns number of cuts.
uint64_t hdrf_cdc_select(const uint64_t *cand, uint64_t ncand, uint64_t len,
                         uint64_t min_chunk, uint64_t max_chunk,
                         uint64_t *out_cuts, uint64_t cap) {
  uint64_t start = 0, n = 0, ci = 0;
  if (min_chunk == 0) min_chunk = 1;
  while (start < len && n < cap) {
    uint64_t lo = start + min_chunk;
    uint64_t hi = start + max_chunk;
    if (hi > len) hi = len;
    while (ci < ncand && cand[ci] < lo) ci++;
    uint64_t cut = (ci < ncand && cand[ci] <= hi) ? cand[ci] : hi;
    out_cuts[n++] = cut;
    start = cut;
  }
  return n;
}

}  // extern "C"
