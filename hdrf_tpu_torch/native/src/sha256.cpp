// SHA-256 of host byte ranges — the port's host oracle.
//
// The port's copy of hdrf_tpu/native/src/sha256.cpp, unchanged below
// this note.
//
// SHA-256 — native hashing backend.
//
// Role-equivalent of the reference's libnayuki-native-hashes.so (C/asm SHA-1/224
// reached over JNI from utilities.java:98-137). We standardize on SHA-256 for
// fingerprints (the reference used SHA-1/SHA-224; 256 matches the north-star spec)
// and expose a batch entry point so the ctypes boundary is crossed once per block,
// not once per chunk.

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

void compress(uint32_t state[8], const uint8_t *block) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++)
    w[i] = (uint32_t(block[4 * i]) << 24) | (uint32_t(block[4 * i + 1]) << 16) |
           (uint32_t(block[4 * i + 2]) << 8) | uint32_t(block[4 * i + 3]);
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + K[i] + w[i];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

void sha256_one(const uint8_t *data, uint64_t len, uint8_t out[32]) {
  uint32_t st[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  uint64_t i = 0;
  for (; i + 64 <= len; i += 64) compress(st, data + i);
  uint8_t tail[128];
  uint64_t rem = len - i;
  memcpy(tail, data + i, rem);
  tail[rem] = 0x80;
  uint64_t padlen = (rem < 56) ? 64 : 128;
  memset(tail + rem + 1, 0, padlen - rem - 1 - 8);
  uint64_t bits = len * 8;
  for (int j = 0; j < 8; j++) tail[padlen - 1 - j] = uint8_t(bits >> (8 * j));
  compress(st, tail);
  if (padlen == 128) compress(st, tail + 64);
  for (int j = 0; j < 8; j++) {
    out[4 * j] = uint8_t(st[j] >> 24);
    out[4 * j + 1] = uint8_t(st[j] >> 16);
    out[4 * j + 2] = uint8_t(st[j] >> 8);
    out[4 * j + 3] = uint8_t(st[j]);
  }
}

}  // namespace

extern "C" {

void hdrf_sha256(const uint8_t *data, uint64_t len, uint8_t out[32]) {
  sha256_one(data, len, out);
}

// Batch: hash n sub-ranges [offsets[i], offsets[i]+lengths[i]) of `data`,
// writing 32 bytes each to out + 32*i. Crosses the FFI boundary once per block —
// the reference pays a JNI crossing per chunk (utilities.java:98-103).
void hdrf_sha256_batch(const uint8_t *data, const uint64_t *offsets,
                       const uint64_t *lengths, uint64_t n, uint8_t *out) {
  for (uint64_t i = 0; i < n; i++)
    sha256_one(data + offsets[i], lengths[i], out + 32 * i);
}

}  // extern "C"
