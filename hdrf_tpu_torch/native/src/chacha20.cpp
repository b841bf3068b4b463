// ChaCha20-Poly1305 AEAD (RFC 8439), implemented from scratch.
//
// The native cipher behind the data-transfer encryption layer
// (hdrf_tpu/security.py) — the role the reference fills with SASL
// DIGEST-MD5 privacy / AES-CTR via JNI (datatransfer/sasl/,
// DataTransferSaslUtil).  Chosen over AES because it is fast in portable
// C++ (no AES-NI dependency) and the RFC ships authoritative test vectors
// (asserted in tests/test_security.py).

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t rotl(uint32_t v, int n) { return (v << n) | (v >> (32 - n)); }

inline uint32_t load32(const uint8_t *p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

inline void store32(uint8_t *p, uint32_t v) {
  p[0] = uint8_t(v); p[1] = uint8_t(v >> 8);
  p[2] = uint8_t(v >> 16); p[3] = uint8_t(v >> 24);
}

#define QR(a, b, c, d)                                        \
  a += b; d ^= a; d = rotl(d, 16);                            \
  c += d; b ^= c; b = rotl(b, 12);                            \
  a += b; d ^= a; d = rotl(d, 8);                             \
  c += d; b ^= c; b = rotl(b, 7);

void chacha20_block(const uint32_t state[16], uint8_t out[64]) {
  uint32_t x[16];
  memcpy(x, state, sizeof(x));
  for (int i = 0; i < 10; i++) {
    QR(x[0], x[4], x[8], x[12]);
    QR(x[1], x[5], x[9], x[13]);
    QR(x[2], x[6], x[10], x[14]);
    QR(x[3], x[7], x[11], x[15]);
    QR(x[0], x[5], x[10], x[15]);
    QR(x[1], x[6], x[11], x[12]);
    QR(x[2], x[7], x[8], x[13]);
    QR(x[3], x[4], x[9], x[14]);
  }
  for (int i = 0; i < 16; i++) store32(out + 4 * i, x[i] + state[i]);
}

void chacha20_init(uint32_t state[16], const uint8_t key[32],
                   const uint8_t nonce[12], uint32_t counter) {
  static const char sigma[17] = "expand 32-byte k";
  state[0] = load32(reinterpret_cast<const uint8_t *>(sigma));
  state[1] = load32(reinterpret_cast<const uint8_t *>(sigma) + 4);
  state[2] = load32(reinterpret_cast<const uint8_t *>(sigma) + 8);
  state[3] = load32(reinterpret_cast<const uint8_t *>(sigma) + 12);
  for (int i = 0; i < 8; i++) state[4 + i] = load32(key + 4 * i);
  state[12] = counter;
  state[13] = load32(nonce);
  state[14] = load32(nonce + 4);
  state[15] = load32(nonce + 8);
}

// Poly1305 (RFC 8439 §2.5), 26-bit limb implementation with a streaming
// state so the AEAD tag is computed incrementally over aad || pad || ct ||
// pad || lengths — no per-record allocation or extra ciphertext copy on the
// data hot path.
struct Poly1305 {
  uint32_t r0, r1, r2, r3, r4;
  uint32_t s1, s2, s3, s4;
  uint32_t h0 = 0, h1 = 0, h2 = 0, h3 = 0, h4 = 0;
  uint8_t key16[16];
  uint8_t carry[16];
  uint64_t carry_len = 0;

  explicit Poly1305(const uint8_t key[32]) {
    r0 = load32(key) & 0x3ffffff;
    r1 = (load32(key + 3) >> 2) & 0x3ffff03;
    r2 = (load32(key + 6) >> 4) & 0x3ffc0ff;
    r3 = (load32(key + 9) >> 6) & 0x3f03fff;
    r4 = (load32(key + 12) >> 8) & 0x00fffff;
    s1 = r1 * 5; s2 = r2 * 5; s3 = r3 * 5; s4 = r4 * 5;
    memcpy(key16, key + 16, 16);
  }

  void block(const uint8_t *b, uint32_t hibit) {
    h0 += load32(b) & 0x3ffffff;
    h1 += (load32(b + 3) >> 2) & 0x3ffffff;
    h2 += (load32(b + 6) >> 4) & 0x3ffffff;
    h3 += (load32(b + 9) >> 6) & 0x3ffffff;
    h4 += (load32(b + 12) >> 8) | hibit;

    uint64_t d0 = (uint64_t)h0 * r0 + (uint64_t)h1 * s4 + (uint64_t)h2 * s3 +
                  (uint64_t)h3 * s2 + (uint64_t)h4 * s1;
    uint64_t d1 = (uint64_t)h0 * r1 + (uint64_t)h1 * r0 + (uint64_t)h2 * s4 +
                  (uint64_t)h3 * s3 + (uint64_t)h4 * s2;
    uint64_t d2 = (uint64_t)h0 * r2 + (uint64_t)h1 * r1 + (uint64_t)h2 * r0 +
                  (uint64_t)h3 * s4 + (uint64_t)h4 * s3;
    uint64_t d3 = (uint64_t)h0 * r3 + (uint64_t)h1 * r2 + (uint64_t)h2 * r1 +
                  (uint64_t)h3 * r0 + (uint64_t)h4 * s4;
    uint64_t d4 = (uint64_t)h0 * r4 + (uint64_t)h1 * r3 + (uint64_t)h2 * r2 +
                  (uint64_t)h3 * r1 + (uint64_t)h4 * r0;

    uint64_t c = d0 >> 26; h0 = d0 & 0x3ffffff;
    d1 += c; c = d1 >> 26; h1 = d1 & 0x3ffffff;
    d2 += c; c = d2 >> 26; h2 = d2 & 0x3ffffff;
    d3 += c; c = d3 >> 26; h3 = d3 & 0x3ffffff;
    d4 += c; c = d4 >> 26; h4 = d4 & 0x3ffffff;
    h0 += uint32_t(c) * 5; c = h0 >> 26; h0 &= 0x3ffffff;
    h1 += uint32_t(c);
  }

  void update(const uint8_t *msg, uint64_t len) {
    if (carry_len) {
      while (carry_len < 16 && len) {
        carry[carry_len++] = *msg++;
        len--;
      }
      if (carry_len < 16) return;
      block(carry, 1 << 24);
      carry_len = 0;
    }
    while (len >= 16) {
      block(msg, 1 << 24);
      msg += 16;
      len -= 16;
    }
    if (len) {
      memcpy(carry, msg, len);
      carry_len = len;
    }
  }

  void final(uint8_t tag[16]);
};

void Poly1305::final(uint8_t tag[16]) {
  if (carry_len) {
    uint8_t b[16] = {0};
    memcpy(b, carry, carry_len);
    b[carry_len] = 1;
    block(b, 0);
  }
  // full carry + compare to p
  uint32_t c = h1 >> 26; h1 &= 0x3ffffff;
  h2 += c; c = h2 >> 26; h2 &= 0x3ffffff;
  h3 += c; c = h3 >> 26; h3 &= 0x3ffffff;
  h4 += c; c = h4 >> 26; h4 &= 0x3ffffff;
  h0 += c * 5; c = h0 >> 26; h0 &= 0x3ffffff;
  h1 += c;

  uint32_t g0 = h0 + 5; c = g0 >> 26; g0 &= 0x3ffffff;
  uint32_t g1 = h1 + c; c = g1 >> 26; g1 &= 0x3ffffff;
  uint32_t g2 = h2 + c; c = g2 >> 26; g2 &= 0x3ffffff;
  uint32_t g3 = h3 + c; c = g3 >> 26; g3 &= 0x3ffffff;
  uint32_t g4 = h4 + c - (1 << 26);
  uint32_t mask = (g4 >> 31) - 1;  // all-ones if h >= p
  h0 = (h0 & ~mask) | (g0 & mask);
  h1 = (h1 & ~mask) | (g1 & mask);
  h2 = (h2 & ~mask) | (g2 & mask);
  h3 = (h3 & ~mask) | (g3 & mask);
  h4 = (h4 & ~mask) | (g4 & mask);

  uint64_t f0 = ((h0) | (h1 << 26)) + (uint64_t)load32(key16);
  uint64_t f1 = ((h1 >> 6) | (h2 << 20)) + (uint64_t)load32(key16 + 4);
  uint64_t f2 = ((h2 >> 12) | (h3 << 14)) + (uint64_t)load32(key16 + 8);
  uint64_t f3 = ((h3 >> 18) | (h4 << 8)) + (uint64_t)load32(key16 + 12);
  store32(tag, uint32_t(f0)); f1 += f0 >> 32;
  store32(tag + 4, uint32_t(f1)); f2 += f1 >> 32;
  store32(tag + 8, uint32_t(f2)); f3 += f2 >> 32;
  store32(tag + 12, uint32_t(f3));
}

void poly1305_aead_tag(const uint8_t key[32], const uint8_t nonce[12],
                       const uint8_t *aad, uint64_t aad_len,
                       const uint8_t *ct, uint64_t ct_len, uint8_t tag[16]) {
  // one-time poly key = first 32 bytes of chacha block 0
  uint32_t state[16];
  uint8_t block0[64];
  chacha20_init(state, key, nonce, 0);
  chacha20_block(state, block0);
  // MAC input: aad || pad16 || ct || pad16 || le64(aad_len) || le64(ct_len)
  static const uint8_t zeros[16] = {0};
  uint8_t lens[16];
  for (int i = 0; i < 8; i++) lens[i] = uint8_t(aad_len >> (8 * i));
  for (int i = 0; i < 8; i++) lens[8 + i] = uint8_t(ct_len >> (8 * i));
  Poly1305 p(block0);
  p.update(aad, aad_len);
  p.update(zeros, (16 - (aad_len % 16)) % 16);
  p.update(ct, ct_len);
  p.update(zeros, (16 - (ct_len % 16)) % 16);
  p.update(lens, 16);
  p.final(tag);
}

}  // namespace

extern "C" {

// Raw keystream XOR (counter starts at 1 for AEAD payloads per RFC 8439).
void hdrf_chacha20_xor(const uint8_t *key, const uint8_t *nonce,
                       uint32_t counter, const uint8_t *in, uint64_t len,
                       uint8_t *out) {
  uint32_t state[16];
  chacha20_init(state, key, nonce, counter);
  uint8_t ks[64];
  uint64_t off = 0;
  while (off < len) {
    chacha20_block(state, ks);
    state[12]++;
    uint64_t n = len - off < 64 ? len - off : 64;
    for (uint64_t i = 0; i < n; i++) out[off + i] = in[off + i] ^ ks[i];
    off += n;
  }
}

// Seal: out = ciphertext(len) || tag(16).
void hdrf_aead_seal(const uint8_t *key, const uint8_t *nonce,
                    const uint8_t *aad, uint64_t aad_len, const uint8_t *pt,
                    uint64_t len, uint8_t *out) {
  hdrf_chacha20_xor(key, nonce, 1, pt, len, out);
  poly1305_aead_tag(key, nonce, aad, aad_len, out, len, out + len);
}

// Open: in = ciphertext(len) || tag(16); returns 1 on success (out = pt),
// 0 on authentication failure (out untouched).
int hdrf_aead_open(const uint8_t *key, const uint8_t *nonce,
                   const uint8_t *aad, uint64_t aad_len, const uint8_t *in,
                   uint64_t ct_len, uint8_t *out) {
  uint8_t tag[16];
  poly1305_aead_tag(key, nonce, aad, aad_len, in, ct_len, tag);
  uint8_t diff = 0;
  for (int i = 0; i < 16; i++) diff |= tag[i] ^ in[ct_len + i];
  if (diff) return 0;
  hdrf_chacha20_xor(key, nonce, 1, in, ct_len, out);
  return 1;
}

}  // extern "C"
