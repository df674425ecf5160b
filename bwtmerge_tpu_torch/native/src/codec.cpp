// Native RLE codec + hashing for the bwtmerge_tpu_torch runtime.
//
// Byte-exact with the reference encodings (support.h:160-286):
//  - ByteCode: LSB-first 7-bit varint with 0x80 continuation.
//  - Run: (c, l<=41) one byte c + 6*(l-1); l>=42 head byte c+6*41 then varint
//    of the remainder; no run crosses a 64-byte block boundary (writer splits
//    and caps the varint to the bytes remaining in the block).
//
// These are sequential byte-stream transforms; they run at memory bandwidth on
// the host while the device owns the batched rank/search compute.

#include <cstdint>

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int64_t SIGMA = 6;
constexpr int64_t MAX_RUN = 256 / SIGMA;  // 42
constexpr int64_t BLOCK = 64;
constexpr uint8_t DATA_MASK = 0x7F;
constexpr uint8_t NEXT_BYTE = 0x80;
constexpr int64_t DATA_BITS = 7;

// Matches reference bit_length (utils.h:146-151): sdsl hi(0) == 0 -> 1.
inline int64_t bit_length(uint64_t v) { return v ? 64 - __builtin_clzll(v) : 1; }

template <bool WRITE>
inline int64_t encode_impl(const uint8_t* syms, const int64_t* lens, int64_t n,
                           uint8_t* out, int64_t start_offset = 0) {
  // start_offset: global byte offset of out[0] — the 64-byte-block splitting
  // rule is position-dependent, so chunked writers must resume mid-stream.
  // out is indexed from 0; pos tracks the GLOBAL offset for the block rule.
  int64_t pos = start_offset;
  for (int64_t r = 0; r < n; r++) {
    uint8_t c = syms[r];
    int64_t length = lens[r];
    while (length > 0) {
      if (length < MAX_RUN) {
        if (WRITE) out[pos - start_offset] = static_cast<uint8_t>(c + SIGMA * (length - 1));
        pos++;
        break;
      }
      int64_t remaining = BLOCK - (pos % BLOCK);
      int64_t basic = (remaining > 1) ? MAX_RUN : MAX_RUN - 1;
      if (WRITE) out[pos - start_offset] = static_cast<uint8_t>(c + SIGMA * (basic - 1));
      pos++;
      length -= basic;
      remaining--;
      if (remaining > 0) {
        int64_t ext = length;
        if (DATA_BITS * remaining < 64 &&
            bit_length(static_cast<uint64_t>(length)) > DATA_BITS * remaining) {
          ext = (int64_t(1) << (DATA_BITS * remaining)) - 1;
        }
        uint64_t v = static_cast<uint64_t>(ext);
        while (v > DATA_MASK) {
          if (WRITE) out[pos - start_offset] = static_cast<uint8_t>((v & DATA_MASK) | NEXT_BYTE);
          pos++;
          v >>= DATA_BITS;
        }
        if (WRITE) out[pos - start_offset] = static_cast<uint8_t>(v);
        pos++;
        length -= ext;
      }
    }
  }
  return pos - start_offset;
}

}  // namespace

EXPORT int64_t rle_encode_size(const uint8_t* syms, const int64_t* lens, int64_t n) {
  return encode_impl<false>(syms, lens, n, nullptr);
}

EXPORT int64_t rle_encode(const uint8_t* syms, const int64_t* lens, int64_t n,
                          uint8_t* out) {
  return encode_impl<true>(syms, lens, n, out);
}

EXPORT int64_t rle_encode_size_at(const uint8_t* syms, const int64_t* lens,
                                  int64_t n, int64_t start_offset) {
  return encode_impl<false>(syms, lens, n, nullptr, start_offset);
}

EXPORT int64_t rle_encode_at(const uint8_t* syms, const int64_t* lens, int64_t n,
                             uint8_t* out, int64_t start_offset) {
  return encode_impl<true>(syms, lens, n, out, start_offset);
}

EXPORT int64_t rle_decode_count(const uint8_t* data, int64_t bytes) {
  int64_t i = 0, runs = 0;
  while (i < bytes) {
    uint8_t code = data[i++];
    if (code / SIGMA + 1 >= MAX_RUN) {
      while (data[i] & NEXT_BYTE) i++;
      i++;
    }
    runs++;
  }
  return runs;
}

// offsets may be null. Returns the number of runs decoded.
EXPORT int64_t rle_decode(const uint8_t* data, int64_t bytes, uint8_t* syms,
                          int64_t* lens, int64_t* offsets) {
  int64_t i = 0, r = 0;
  while (i < bytes) {
    if (offsets) offsets[r] = i;
    uint8_t code = data[i++];
    uint8_t c = code % SIGMA;
    int64_t length = code / SIGMA + 1;
    if (length >= MAX_RUN) {
      uint64_t ext = 0;
      int shift = 0;
      while (true) {
        uint8_t b = data[i++];
        ext += static_cast<uint64_t>(b & DATA_MASK) << shift;
        if (!(b & NEXT_BYTE)) break;
        shift += DATA_BITS;
      }
      length += static_cast<int64_t>(ext);
    }
    syms[r] = c;
    lens[r] = length;
    r++;
  }
  return r;
}

// FNV-1a over the decoded sequence (reference BWT::hash, bwt.cpp:538-549).
EXPORT uint64_t rle_hash_runs(const uint8_t* syms, const int64_t* lens, int64_t n) {
  uint64_t res = 0xcbf29ce484222325ULL;
  constexpr uint64_t PRIME = 0x100000001b3ULL;
  for (int64_t r = 0; r < n; r++) {
    uint64_t b = syms[r];
    for (int64_t j = 0; j < lens[r]; j++) res = (res ^ b) * PRIME;
  }
  return res;
}

EXPORT uint64_t fnv1a_bytes(const uint8_t* data, int64_t n, uint64_t seed) {
  constexpr uint64_t PRIME = 0x100000001b3ULL;
  uint64_t res = seed;
  for (int64_t i = 0; i < n; i++) res = (res ^ data[i]) * PRIME;
  return res;
}

// Block-planar 4-bit text packing — the device upload layout of
// DeviceFMIndex.build (ops/rank_torch.py): byte ((p>>5)<<4) | (p&15) holds
// position p in its low nibble when (p&16)==0, high nibble otherwise.
// Expands (syms, lens) runs straight into the caller's pre-filled buffer
// (fill = SIGMA | SIGMA<<4 beyond the text), replacing the numpy
// repeat/reshape chain that dominated fold-to-fold index rebuilds.
// Returns positions written, or -1 if the buffer is too small.
EXPORT int64_t nib4_pack(const uint8_t* syms, const int64_t* lens, int64_t n,
                         uint8_t* out, int64_t out_positions) {
  int64_t p = 0;
  for (int64_t r = 0; r < n; r++) {
    const uint8_t c = syms[r];
    int64_t end = p + lens[r];
    if (end > out_positions) return -1;
    // per-16-position spans: positions p..p|15 within one half-block are
    // CONSECUTIVE bytes of the same nibble plane — straight byte stores
    while (p < end) {
      const int64_t span_end = (p | 15) + 1 < end ? (p | 15) + 1 : end;
      uint8_t* base = out + ((p >> 5) << 4) + (p & 15);
      if (p & 16) {
        const uint8_t hi = static_cast<uint8_t>(c << 4);
        for (; p < span_end; p++) { *base = (*base & 0x0F) | hi; base++; }
      } else {
        for (; p < span_end; p++) { *base = (*base & 0xF0) | c; base++; }
      }
    }
  }
  return p;
}
