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

// The sampled sums of a block-sampled rank index (ops/rank_np.py,
// SparseRankIndex) in one pass over the runs: for b = 0..nb, starts[b] =
// the positions of runs [0, b * stride) and occ[b * sigma + c] those of
// symbol c among them, nb = max(1, ceil(n / stride)).  A symbol at or past
// sigma counts in starts only.  Returns nb, or -1 for a stride below 1 or
// a sigma outside [1, 256].
template <typename L>
int64_t run_block_sums(const uint8_t* syms, const L* lens, int64_t n,
                       int64_t stride, int64_t sigma, int64_t* starts,
                       int64_t* occ) {
  if (stride < 1 || sigma < 1 || sigma > 256) return -1;
  const int64_t nb = n > stride ? (n + stride - 1) / stride : 1;
  int64_t acc[256] = {};
  int64_t pos = 0;
  starts[0] = 0;
  for (int64_t c = 0; c < sigma; c++) occ[c] = 0;
  for (int64_t b = 0; b < nb; b++) {
    const int64_t end = (b + 1) * stride < n ? (b + 1) * stride : n;
    for (int64_t r = b * stride; r < end; r++) {
      const int64_t l = static_cast<int64_t>(lens[r]);
      pos += l;
      acc[syms[r]] += l;
    }
    starts[b + 1] = pos;
    for (int64_t c = 0; c < sigma; c++) occ[(b + 1) * sigma + c] = acc[c];
  }
  return nb;
}

EXPORT int64_t run_block_sums64(const uint8_t* syms, const int64_t* lens,
                                int64_t n, int64_t stride, int64_t sigma,
                                int64_t* starts, int64_t* occ) {
  return run_block_sums(syms, lens, n, stride, sigma, starts, occ);
}

EXPORT int64_t run_block_sums32(const uint8_t* syms, const uint32_t* lens,
                                int64_t n, int64_t stride, int64_t sigma,
                                int64_t* starts, int64_t* occ) {
  return run_block_sums(syms, lens, n, stride, sigma, starts, occ);
}

// Occurrences of each byte value in data[0, n) into counts[256]; four
// tables in turn, so that a run of one value does not chain its stores.
EXPORT void byte_counts(const uint8_t* data, int64_t n, int64_t* counts) {
  int64_t part[4][256] = {};
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    part[0][data[i]]++;
    part[1][data[i + 1]]++;
    part[2][data[i + 2]]++;
    part[3][data[i + 3]]++;
  }
  for (; i < n; i++) part[0][data[i]]++;
  for (int v = 0; v < 256; v++)
    counts[v] = part[0][v] + part[1][v] + part[2][v] + part[3][v];
}

// The rope family's codes (SGA comp<<5 | len, RopeBWT len<<3 | comp) as
// the runs that the streaming reader yields (formats/streaming_read.py),
// in one pass.  The codes are read in file chunks of `seam` bytes, and
// runs are coalesced across codes and chunks, with the reader's rule for
// zero-length codes: one inside a chunk stays a run of its own, while a
// zero-length run held at a chunk's end is dropped, and so is one at the
// end.  state = int64[3] {held symbol or -1, held length, mask of the
// symbols emitted} carries the trailing run from call to call; each call
// starts a chunk; `finish` emits the held run.  A code is read as sym =
// (code >> sym_shift) & sym_mask, len = (code >> len_shift) & len_mask.
// rope_runs_count returns the runs that rope_runs_fill would emit and
// changes nothing; rope_runs_fill writes them into syms/lens, updates
// state and, when counts is not null, adds each symbol's length into
// counts[8].  Both return -1 for a seam below 1 or a layout out of range.
namespace {

struct RopeCode {
  uint8_t sym_of[256], len_of[256];
  bool ok;
  RopeCode(int64_t sym_shift, int64_t sym_mask, int64_t len_shift,
           int64_t len_mask) {
    ok = sym_shift >= 0 && sym_shift <= 7 && sym_mask >= 0 && sym_mask <= 7 &&
         len_shift >= 0 && len_shift <= 7 && len_mask >= 0 && len_mask <= 255;
    for (int v = 0; v < 256; v++) {
      sym_of[v] = static_cast<uint8_t>((v >> (sym_shift & 7)) & sym_mask);
      len_of[v] = static_cast<uint8_t>((v >> (len_shift & 7)) & len_mask);
    }
  }
};

template <bool FILL>
int64_t rope_runs_impl(const uint8_t* codes, int64_t n, int64_t seam,
                       const RopeCode& code, int64_t finish, int64_t* state,
                       uint8_t* syms, int64_t* lens, int64_t* counts) {
  if (seam < 1 || !code.ok) return -1;
  int64_t cs = state[0], cl = state[1], seen = state[2];
  int64_t acc[8] = {};
  int64_t r = 0;
  auto emit = [&](int64_t s, int64_t l) {
    if (FILL) {
      syms[r] = static_cast<uint8_t>(s);
      lens[r] = l;
      acc[s] += l;
      seen |= int64_t(1) << s;
    }
    r++;
  };
  for (int64_t start = 0; start < n; start += seam) {
    if (cl == 0) cs = -1;  // a zero-length run held at a seam is dropped
    const int64_t end = n - start > seam ? start + seam : n;
    for (int64_t i = start; i < end; i++) {
      const int64_t s = code.sym_of[codes[i]];
      const int64_t l = code.len_of[codes[i]];
      if (s == cs) {
        cl += l;
        continue;
      }
      if (cs >= 0) emit(cs, cl);
      cs = s;
      cl = l;
    }
  }
  if (finish) {
    if (cs >= 0 && cl > 0) emit(cs, cl);
    cs = -1;
    cl = 0;
  }
  if (FILL) {
    state[0] = cs;
    state[1] = cl;
    state[2] = seen;
    if (counts)
      for (int k = 0; k < 8; k++) counts[k] += acc[k];
  }
  return r;
}

}  // namespace

EXPORT int64_t rope_runs_count(const uint8_t* codes, int64_t n, int64_t seam,
                               int64_t sym_shift, int64_t sym_mask,
                               int64_t len_shift, int64_t len_mask,
                               int64_t finish, const int64_t* state) {
  int64_t st[3] = {state[0], state[1], state[2]};
  return rope_runs_impl<false>(
      codes, n, seam, RopeCode(sym_shift, sym_mask, len_shift, len_mask),
      finish, st, nullptr, nullptr, nullptr);
}

EXPORT int64_t rope_runs_fill(const uint8_t* codes, int64_t n, int64_t seam,
                              int64_t sym_shift, int64_t sym_mask,
                              int64_t len_shift, int64_t len_mask,
                              int64_t finish, int64_t* state, uint8_t* syms,
                              int64_t* lens, int64_t* counts) {
  return rope_runs_impl<true>(
      codes, n, seam, RopeCode(sym_shift, sym_mask, len_shift, len_mask),
      finish, state, syms, lens, counts);
}
// The lengths of the runs of each symbol value, exact: out[256].  Four
// tables in turn, so that runs of one symbol two apart do not chain their
// stores.  Returns one more than the largest symbol, 0 for no runs.
EXPORT int64_t run_sym_sums(const uint8_t* syms, const int64_t* lens,
                            int64_t n, int64_t* out) {
  int64_t part[4][256] = {};
  uint8_t top = 0;
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    part[0][syms[i]] += lens[i];
    part[1][syms[i + 1]] += lens[i + 1];
    part[2][syms[i + 2]] += lens[i + 2];
    part[3][syms[i + 3]] += lens[i + 3];
  }
  for (; i < n; i++) part[0][syms[i]] += lens[i];
  for (int64_t j = 0; j < n; j++) top = syms[j] > top ? syms[j] : top;
  for (int v = 0; v < 256; v++)
    out[v] = part[0][v] + part[1][v] + part[2][v] + part[3][v];
  return n ? int64_t(top) + 1 : 0;
}
