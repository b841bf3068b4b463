// LZ4 block-format codec, implemented from scratch.
//
// The port's copy of hdrf_tpu/native/src/lz4.cpp, unchanged below this
// note: the host half of the seal (serial encoder, segment tails, the emit
// over device match records, the packed-record unpack, the decoder).  Where
// the comments name ops/lz4_tpu.py, the port's counterpart is
// hdrf_tpu_torch/ops/lz4_device.py.
//
// Role-equivalent of the reference's JNI codec backends (snappy-java / hadoop-lzo /
// Hadoop Lz4 reached from BlockReceiver.java:822-866 and the container rollover
// compression at DataDeduplicator.java:770-781). Standard LZ4 block format:
// sequences of [token][lit-len ext*][literals][offset u16le][match-len ext*],
// minimum match 4, last sequence is literals-only.

#include <cstdint>
#include <cstring>

namespace {

constexpr int MIN_MATCH = 4;
constexpr int HASH_LOG = 16;
constexpr int LAST_LITERALS = 5;   // spec: last 5 bytes are always literals
constexpr int MFLIMIT = 12;        // spec: no match may start within last 12 bytes

inline uint32_t read32(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761u) >> (32 - HASH_LOG);
}

inline uint64_t read64(const uint8_t *p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

// First p in [p, lim) with read32(p) == read32(p - off), else nullptr.
// Word-at-a-time: one 8-byte XOR covers match starts p..p+4 (the zero-byte
// mask trick finds 4 consecutive equal bytes), ~5x fewer loads than the
// byte loop it replaces.  Caller guarantees p >= src+off and
// lim <= iend - MFLIMIT, so the 8-byte loads never pass the buffer end.
inline const uint8_t *scan_eq4(const uint8_t *p, const uint8_t *lim,
                               uint32_t off) {
  constexpr uint64_t LO7 = 0x7F7F7F7F7F7F7F7FULL;
  while (p + 5 <= lim) {
    uint64_t d = read64(p) ^ read64(p - off);
    if (d == 0) return p;
    // byte i equal <=> byte i of d zero; need 4 consecutive zero bytes.
    // EXACT per-byte zero mask: additions are confined to the low 7 bits
    // of each byte, so no cross-byte borrow can flag a non-zero byte
    // (the classic (d-0x01..)&~d&0x80.. trick is NOT per-byte exact —
    // its borrow propagates past a true zero byte and falsely flags
    // 0x01 bytes above it, which emitted corrupt matches).
    uint64_t t = (d & LO7) + LO7;
    uint64_t z = ~(t | d | LO7);                // bit 8i+7 = byte i zero
    uint64_t zb = z >> 7;                       // bit 8i   = byte i zero
    uint64_t m = zb & (zb >> 8) & (zb >> 16) & (zb >> 24);
    if (m) return p + (__builtin_ctzll(m) >> 3);
    p += 5;
  }
  for (; p < lim; p++)
    if (read32(p) == read32(p - off)) return p;
  return nullptr;
}

// Write a length with 255-run extension bytes.
inline uint8_t *write_len_ext(uint8_t *op, uint64_t len) {
  while (len >= 255) { *op++ = 255; len -= 255; }
  *op++ = uint8_t(len);
  return op;
}

}  // namespace

extern "C" {

uint64_t hdrf_lz4_compress_bound(uint64_t n) { return n + n / 255 + 16; }

// Returns compressed size, or 0 if dst is too small / input empty.
uint64_t hdrf_lz4_compress(const uint8_t *src, uint64_t srclen, uint8_t *dst,
                           uint64_t dstcap) {
  if (srclen == 0 || dstcap < hdrf_lz4_compress_bound(srclen)) return 0;
  static thread_local uint32_t table[1 << HASH_LOG];
  memset(table, 0, sizeof(table));

  const uint8_t *ip = src;
  const uint8_t *anchor = src;
  const uint8_t *iend = src + srclen;
  const uint8_t *mflimit = srclen > MFLIMIT ? iend - MFLIMIT : src;
  uint8_t *op = dst;

  if (srclen > MFLIMIT) {
    table[hash4(read32(ip))] = 0;
    ip++;
    while (ip < mflimit) {
      // Find a match via the 4-byte hash table.
      uint32_t h = hash4(read32(ip));
      const uint8_t *ref = src + table[h];
      table[h] = uint32_t(ip - src);
      if (ref >= ip || ip - ref > 65535 || read32(ref) != read32(ip)) {
        ip++;
        continue;
      }
      // Extend the match backward over pending literals.
      while (ip > anchor && ref > src && ip[-1] == ref[-1]) { ip--; ref--; }
      // Extend forward (must leave LAST_LITERALS at the tail).
      const uint8_t *matchlimit = iend - LAST_LITERALS;
      const uint8_t *mip = ip + MIN_MATCH;
      const uint8_t *mref = ref + MIN_MATCH;
      while (mip < matchlimit && *mip == *mref) { mip++; mref++; }
      uint64_t matchlen = uint64_t(mip - ip);
      uint64_t litlen = uint64_t(ip - anchor);

      // Token + literal run.
      uint8_t *token = op++;
      if (litlen >= 15) {
        *token = 0xF0;
        op = write_len_ext(op, litlen - 15);
      } else {
        *token = uint8_t(litlen << 4);
      }
      memcpy(op, anchor, litlen);
      op += litlen;
      // Offset + match length.
      uint16_t off = uint16_t(ip - ref);
      *op++ = uint8_t(off);
      *op++ = uint8_t(off >> 8);
      uint64_t mlcode = matchlen - MIN_MATCH;
      if (mlcode >= 15) {
        *token |= 0x0F;
        op = write_len_ext(op, mlcode - 15);
      } else {
        *token |= uint8_t(mlcode);
      }
      ip = mip;
      anchor = ip;
      if (ip < mflimit) table[hash4(read32(ip))] = uint32_t(ip - src);
    }
  }

  // Final literals-only sequence.
  uint64_t litlen = uint64_t(iend - anchor);
  uint8_t *token = op++;
  if (litlen >= 15) {
    *token = 0xF0;
    op = write_len_ext(op, litlen - 15);
  } else {
    *token = uint8_t(litlen << 4);
  }
  memcpy(op, anchor, litlen);
  op += litlen;
  return uint64_t(op - dst);
}

// hdrf_lz4_compress + tail-sequence report, for parallel segmented
// compression (ops/lz4_tpu._lz4_compress_parallel): segments compress
// independently and are STITCHED into one spec-valid block stream by
// merging each junction's literal tail into the next segment's first
// sequence.  The stitcher needs to know where this stream's final
// (literals-only) sequence begins and how many literals it carries —
// information only the encoder has (the block format has no end marker;
// the tail is recognized purely by reaching end-of-input).
uint64_t hdrf_lz4_compress_tail(const uint8_t *src, uint64_t srclen,
                                uint8_t *dst, uint64_t dstcap,
                                uint64_t *tail_off, uint64_t *tail_lit) {
  uint64_t n = hdrf_lz4_compress(src, srclen, dst, dstcap);
  if (n == 0) return 0;
  // Walk the sequences to the last one.  O(sequences), no byte copying;
  // done here (not in the encoder body) to keep the hot loop untouched.
  const uint8_t *p = dst;
  const uint8_t *pend = dst + n;
  const uint8_t *tok = p;
  for (;;) {
    tok = p;
    uint8_t t = *p++;
    uint64_t lit = t >> 4;
    if (lit == 15) {
      uint8_t b;
      do { b = *p++; lit += b; } while (b == 255);
    }
    p += lit;
    if (p >= pend) {          // literals reach end-of-stream: final sequence
      *tail_off = uint64_t(tok - dst);
      *tail_lit = lit;
      return n;
    }
    p += 2;                   // match offset
    if ((t & 0x0F) == 15) {
      uint8_t b;
      do { b = *p++; } while (b == 255);
    }
  }
}

// Assemble an LZ4 block from externally discovered match records.
//
// This is the host half of the TPU LZ4 path (ops/lz4_tpu.py): the device
// finds candidate matches (pos, offset, estimated length) with a sorted
// fingerprint scan; this function runs the greedy parse over those records
// and serializes standard LZ4 block format.  It re-verifies every record
// against the source bytes and extends matches exactly (forward and
// backward), so output correctness never depends on the device results —
// only the compression ratio does.
//
// recs: nrec records sorted by position ascending; pos[i] is the byte
// position, dl[i] packs (offset << 16) | est_len (offset 1..65535).
// Returns compressed size, or 0 if dst too small / input empty.
uint64_t hdrf_lz4_emit(const uint8_t *src, uint64_t srclen, const int32_t *pos,
                       const uint32_t *dl, uint64_t nrec, uint8_t *dst,
                       uint64_t dstcap) {
  if (srclen == 0 || dstcap < hdrf_lz4_compress_bound(srclen)) return 0;
  const uint8_t *iend = src + srclen;
  const uint8_t *matchlimit = iend - LAST_LITERALS;
  const uint8_t *mflimit = srclen > MFLIMIT ? iend - MFLIMIT : src;
  const uint8_t *anchor = src;
  uint8_t *op = dst;

  // Lazy parse over the record stream.  The device's estimated lengths
  // systematically undershoot whenever a nearer duplicate interrupts a
  // same-delta run (a long periodic match overlaid with RLE), so records are
  // re-verified and exactly extended here, and at each step ALL records
  // usable at the cursor (start within LAZY bytes) compete on true extended
  // end — the record whose match reaches furthest wins.  That recovers the
  // long structural match when the device's nearest-occurrence rule favored
  // a short-range RLE reference.  (On full TeraGen-density data the TpuLz4
  // front end falls back to hdrf_lz4_compress before reaching this parse —
  // the probe machinery below earns its keep on structured-but-not-flooded
  // containers and on the sparse-record grey zone.)
  //
  // Probe-offset trial: the device records carry STRUCTURAL matches (the
  // degenerate-gram filter keeps RLE interiors out of the sort), so the
  // gap between records is scanned against a tiny probe set — the last
  // emitted offset (periodic data like TeraGen re-enters its row-period
  // match after each random key) plus constants 1/2/4 (byte/word RLE,
  // which LZ4 encodes as overlapping matches).  One 4-byte compare per
  // (position, probe), resumed monotonically (probe_scan) so the whole
  // input costs O(n * nprobes).  A hit competes with the records like
  // any candidate.
  // Candidate windows: from a RECORD base, a narrow window (3) — on
  // short-match-dense text a wide window prefers later-longer matches and
  // loses the dense chain (measured 1.12x -> 1.44x of native).  From a
  // PROBE-HIT base (short RLE reference on periodic data), a wide window
  // (12) — the structural record starting a few bytes later must compete,
  // or TeraGen-style rows fragment into per-run RLE matches (measured
  // 4.57x vs 5.35x).
  constexpr uint64_t LAZY_REC = 3;
  constexpr uint64_t LAZY_PROBE = 12;
  uint64_t r = 0;
  uint32_t rep = 0, rep2 = 0;       // last two DISTINCT emitted offsets:
  // periodic row data alternates offsets (row-period rowid match vs the
  // period-minus-block filler match), and each re-entry needs its own
  // Per-probe monotone scanners (vectorized probe trial): each slot walks
  // the input once with the word-at-a-time scan_eq4, caching its next hit.
  // Slots 2-4 (constant offsets 1/2/4) never rescan ground; slots 0/1
  // restart from the anchor when their offset changes — semantically
  // identical to the global rescan-on-new-offset rule they replace (a
  // re-scan with unchanged constant offsets can find nothing new).
  struct PSlot { uint32_t off; const uint8_t *scanned; const uint8_t *hit; };
  PSlot slots[5] = {{0, src, nullptr}, {0, src, nullptr},
                    {1, src, nullptr}, {2, src, nullptr}, {4, src, nullptr}};
  while (anchor < mflimit) {
    uint64_t acur = uint64_t(anchor - src);
    // Drop records whose verified span (+ slack for under-estimation) is
    // wholly behind the cursor; keeps the candidate window short.
    while (r < nrec && uint64_t(pos[r]) + (dl[r] & 0xFFFF) + 64 < acur) r++;
    const uint8_t *rbase =
        r < nrec ? (src + pos[r] > anchor ? src + pos[r] : anchor) : mflimit;
    // Probe scan of [anchor, min(rbase+LAZY, mflimit)).
    const uint8_t *rep_hit = nullptr;
    uint32_t hit_off = 0;
    {
      if (slots[0].off != rep) {
        slots[0].off = rep; slots[0].scanned = anchor; slots[0].hit = nullptr;
      }
      if (slots[1].off != rep2) {
        slots[1].off = rep2; slots[1].scanned = anchor; slots[1].hit = nullptr;
      }
      const uint8_t *lim = rbase + LAZY_PROBE < mflimit
                               ? rbase + LAZY_PROBE : mflimit;
      for (int k = 0; k < 5; k++) {
        uint32_t off = slots[k].off;
        if (off == 0) continue;
        if (k >= 2 && (off == rep || off == rep2)) continue;  // dedup
        if (k == 1 && off == rep) continue;
        const uint8_t *start = anchor;
        if (src + off > start) start = src + off;
        if (slots[k].hit != nullptr && slots[k].hit < start) {
          // cached hit consumed/passed: unscanned ground resumes at start
          slots[k].hit = nullptr;
          slots[k].scanned = start;
        } else if (slots[k].hit == nullptr && slots[k].scanned < start) {
          slots[k].scanned = start;
        }
        if (slots[k].hit == nullptr && slots[k].scanned < lim) {
          const uint8_t *h = scan_eq4(slots[k].scanned, lim, off);
          slots[k].scanned = h ? h : lim;
          slots[k].hit = h;
        }
        if (slots[k].hit != nullptr && slots[k].hit < lim &&
            (rep_hit == nullptr || slots[k].hit < rep_hit)) {
          rep_hit = slots[k].hit;   // strict < : position ties keep the
          hit_off = off;            // lowest-k probe, as the byte loop did
        }
      }
    }
    const uint8_t *base = rep_hit && rep_hit < rbase ? rep_hit : rbase;
    const uint64_t LAZY = (rep_hit && rep_hit < rbase) ? LAZY_PROBE
                                                       : LAZY_REC;
    if (base >= mflimit) break;
    const uint8_t *bip = nullptr, *bref = nullptr, *bend = nullptr;
    for (uint64_t q = r; q < nrec && src + pos[q] <= base + LAZY; q++) {
      uint32_t off = dl[q] >> 16;
      if (off == 0) continue;
      const uint8_t *ip = src + pos[q];
      if (ip < anchor) ip = anchor;
      if (ip >= mflimit || uint64_t(ip - src) < off) continue;
      const uint8_t *ref = ip - off;
      if (read32(ip) != read32(ref)) continue;  // pad artifact / stale record
      const uint8_t *mip = ip + MIN_MATCH;
      const uint8_t *mref = ref + MIN_MATCH;
      while (mip < matchlimit && *mip == *mref) { mip++; mref++; }
      while (ip > anchor && ref > src && ip[-1] == ref[-1]) { ip--; ref--; }
      if (bend == nullptr || mip > bend || (mip == bend && ip < bip)) {
        bip = ip; bref = ref; bend = mip;
      }
    }
    if (rep_hit && rep_hit <= base + LAZY && rep_hit < mflimit) {
      const uint8_t *ip = rep_hit;
      const uint8_t *ref = ip - hit_off;
      const uint8_t *mip = ip + MIN_MATCH;
      const uint8_t *mref = ref + MIN_MATCH;
      while (mip < matchlimit && *mip == *mref) { mip++; mref++; }
      while (ip > anchor && ref > src && ip[-1] == ref[-1]) { ip--; ref--; }
      if (bend == nullptr || mip > bend || (mip == bend && ip < bip)) {
        bip = ip; bref = ref; bend = mip;
      }
    }
    if (bend == nullptr) { if (r >= nrec) break; r++; continue; }

    uint64_t matchlen = uint64_t(bend - bip);
    uint64_t litlen = uint64_t(bip - anchor);
    uint32_t offset = uint32_t(bip - bref);
    if (offset != rep) { rep2 = rep; rep = offset; }
    uint8_t *token = op++;
    if (litlen >= 15) {
      *token = 0xF0;
      op = write_len_ext(op, litlen - 15);
    } else {
      *token = uint8_t(litlen << 4);
    }
    memcpy(op, anchor, litlen);
    op += litlen;
    *op++ = uint8_t(offset);
    *op++ = uint8_t(offset >> 8);
    uint64_t mlcode = matchlen - MIN_MATCH;
    if (mlcode >= 15) {
      *token |= 0x0F;
      op = write_len_ext(op, mlcode - 15);
    } else {
      *token |= uint8_t(mlcode);
    }
    anchor = bend;
  }

  // Final literals-only sequence.
  uint64_t litlen = uint64_t(iend - anchor);
  uint8_t *token = op++;
  if (litlen >= 15) {
    *token = 0xF0;
    op = write_len_ext(op, litlen - 15);
  } else {
    *token = uint8_t(litlen << 4);
  }
  memcpy(op, anchor, litlen);
  op += litlen;
  return uint64_t(op - dst);
}

// Returns decompressed size, or 0 on malformed input / overflow.
uint64_t hdrf_lz4_decompress(const uint8_t *src, uint64_t srclen, uint8_t *dst,
                             uint64_t dstcap) {
  const uint8_t *ip = src, *iend = src + srclen;
  uint8_t *op = dst, *oend = dst + dstcap;
  while (ip < iend) {
    uint8_t token = *ip++;
    // Literals.
    uint64_t litlen = token >> 4;
    if (litlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return 0;
        b = *ip++;
        litlen += b;
      } while (b == 255);
    }
    if (uint64_t(iend - ip) < litlen || uint64_t(oend - op) < litlen) return 0;
    memcpy(op, ip, litlen);
    ip += litlen;
    op += litlen;
    if (ip == iend) break;  // last sequence has no match part
    // Match.
    if (iend - ip < 2) return 0;
    uint32_t offset = uint32_t(ip[0]) | (uint32_t(ip[1]) << 8);
    ip += 2;
    if (offset == 0 || offset > uint64_t(op - dst)) return 0;
    uint64_t matchlen = (token & 0x0F);
    if (matchlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return 0;
        b = *ip++;
        matchlen += b;
      } while (b == 255);
    }
    matchlen += MIN_MATCH;
    if (uint64_t(oend - op) < matchlen) return 0;
    const uint8_t *match = op - offset;
    // Byte-wise copy: offsets < matchlen intentionally replicate (RLE).
    for (uint64_t i = 0; i < matchlen; i++) op[i] = match[i];
    op += matchlen;
  }
  return uint64_t(op - dst);
}

// Decode the delta-encoded device record readback (ops/lz4_tpu.py packed
// layout) back into the (pos, (offset << 16) | len) records hdrf_lz4_emit
// consumes.  `row` starts at the A array (the 4-word header is consumed by
// the caller): A u32 x p3, B u32 x p3/4 (dpos low bytes, 4 per word), then
// two esc_slots-wide escape lanes (absolute entry-unit positions / lengths,
// record order).  All fields are in entry units (byte value / stride).
//
// Serial by necessity (each position is a prefix sum over deltas) but
// trivially so: one pass, ~5 loads per record.  Returns the number of
// records decoded — short of nv only when an escape lane overflowed on
// device (the caller then rescans in the full layout, or truncates if the
// device block is gone; truncation costs ratio, never correctness).
uint64_t hdrf_lz4_unpack_records(const uint32_t *row, uint64_t p3,
                                 uint64_t nv, uint64_t stride,
                                 uint64_t esc_slots, int32_t *pos_out,
                                 uint32_t *dl_out) {
  const uint32_t *A = row;
  const uint32_t *B = row + p3;
  const uint32_t *E1 = B + p3 / 4;
  const uint32_t *E2 = E1 + esc_slots;
  uint64_t e1 = 0, e2 = 0;
  uint64_t prev_u = 0;
  uint64_t i = 0;
  for (; i < nv; i++) {
    uint32_t a = A[i];
    uint32_t delta_u = a & 0x7FFF;
    uint32_t len9 = (a >> 15) & 0x1FF;
    uint32_t lo = (B[i >> 2] >> ((i & 3) * 8)) & 0xFF;
    uint32_t dp16 = ((a >> 24) << 8) | lo;
    uint64_t pos_u;
    if (dp16 == 0xFFFF) {
      if (e1 >= esc_slots) break;
      pos_u = E1[e1++];
    } else {
      pos_u = prev_u + dp16;
    }
    uint32_t len_u;
    if (len9 == 511) {
      if (e2 >= esc_slots) break;
      len_u = E2[e2++];
    } else {
      len_u = len9;
    }
    uint32_t mlen =
        len_u == 32766 ? 65535 : uint32_t(len_u * stride + MIN_MATCH);
    pos_out[i] = int32_t(pos_u * stride);
    dl_out[i] = (uint32_t(delta_u * stride) << 16) | mlen;
    prev_u = pos_u;
  }
  return i;
}

}  // extern "C"
