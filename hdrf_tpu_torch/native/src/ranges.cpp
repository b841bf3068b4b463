// Byte-range gather for the dedup commit path (the port's copy of
// hdrf_tpu/native/src/ranges.cpp).
//
// Role-equivalent of the reference's storer-thread byte shuffling
// (DataDeduplicator.java:652-845 threadedStorer: per-chunk ByteBuffer
// slices copied into container buffers): one memcpy loop in place of a
// list of per-chunk memoryviews joined in Python.

#include <cstdint>
#include <cstring>

extern "C" {

// Concatenate n [starts[i], starts[i]+lens[i]) ranges of src into dst.
// Returns total bytes written.  Caller sizes dst = sum(lens).
uint64_t hdrf_gather_ranges(const uint8_t *src, uint64_t n,
                            const uint64_t *starts, const uint64_t *lens,
                            uint8_t *dst) {
  uint64_t at = 0;
  for (uint64_t i = 0; i < n; i++) {
    memcpy(dst + at, src + starts[i], lens[i]);
    at += lens[i];
  }
  return at;
}

}  // extern "C"
