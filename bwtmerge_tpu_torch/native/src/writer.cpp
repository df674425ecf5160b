// Streaming format-writer kernels: run chunks -> on-disk byte streams in one
// pass, writing into caller-owned persistent buffers.
//
// Rationale: the Python streaming writers (formats/streaming.py) originally
// materialized the stored-run partition plus one-hot/cumsum temporaries per
// chunk with numpy — hundreds of MB of FRESH allocations per chunk.  First
// touches of brand-new pages are far dearer than recycled pages, so those
// temporaries dominated the merge phase.  These kernels fuse partition + encode into one
// sequential pass over the chunk and write into buffers the caller allocates
// once and reuses for every chunk.
//
// Byte-exact with the reference encodings:
//  - stored-run partition + Run codec block rule: support.h:256-282 (no run
//    crosses a 64-byte block; varint capped to the bytes remaining)
//  - SGA codes comp<<5 | len, MAX_RUN 31: formats.cpp:405-417
//  - native per-block samples: the last stored run of each 64-byte block
//    carries (end text position, cumulative char counts) — the streaming
//    incrementalization of BWT::build's single scan (bwt.cpp:477-512).

#include <cstdint>

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int64_t SIGMA = 6;
constexpr int64_t MAX_RUN = 256 / SIGMA;  // 42
constexpr int64_t BLOCK = 64;
constexpr uint8_t DATA_MASK = 0x7F;
constexpr uint8_t NEXT_BYTE = 0x80;
constexpr int64_t DATA_BITS = 7;
constexpr int64_t SGA_MAX_RUN = 31;

inline int64_t bit_length(uint64_t v) { return v ? 64 - __builtin_clzll(v) : 1; }

// Walks the stored-run partition of (syms, lens) under the position-dependent
// 64-byte block rule, resuming at global byte offset *pos.  Calls
// emit(c, stored_len, global_byte_offset, byte_width) per stored run and
// write_byte(global_offset, byte) per encoded byte.  Mirrors
// codec.cpp encode_impl exactly (one stored run per head byte).
template <typename LenT, typename EmitRun, typename WriteByte>
inline bool walk_stored(const uint8_t* syms, const LenT* lens, int64_t n,
                        int64_t* pos_io, EmitRun&& emit, WriteByte&& write_byte) {
  int64_t pos = *pos_io;
  for (int64_t r = 0; r < n; r++) {
    uint8_t c = syms[r];
    int64_t length = lens[r];
    // re-coalesce adjacent same-symbol entries (int32 producers split
    // over-wide runs) so the encoded bytes stay canonical maximal-run
    while (r + 1 < n && syms[r + 1] == c) length += lens[++r];
    while (length > 0) {
      int64_t run_off = pos;
      if (length < MAX_RUN) {
        if (!write_byte(pos, static_cast<uint8_t>(c + SIGMA * (length - 1))))
          return false;
        pos++;
        if (!emit(c, length, run_off)) return false;
        break;
      }
      int64_t remaining = BLOCK - (pos % BLOCK);
      int64_t basic = (remaining > 1) ? MAX_RUN : MAX_RUN - 1;
      if (!write_byte(pos, static_cast<uint8_t>(c + SIGMA * (basic - 1))))
        return false;
      pos++;
      length -= basic;
      remaining--;
      int64_t stored_len = basic;
      if (remaining > 0) {
        int64_t ext = length;
        if (DATA_BITS * remaining < 64 &&
            bit_length(static_cast<uint64_t>(length)) > DATA_BITS * remaining) {
          ext = (int64_t(1) << (DATA_BITS * remaining)) - 1;
        }
        uint64_t v = static_cast<uint64_t>(ext);
        while (v > DATA_MASK) {
          if (!write_byte(pos, static_cast<uint8_t>((v & DATA_MASK) | NEXT_BYTE)))
            return false;
          pos++;
          v >>= DATA_BITS;
        }
        if (!write_byte(pos, static_cast<uint8_t>(v))) return false;
        pos++;
        length -= ext;
        stored_len += ext;
      }
      if (!emit(c, stored_len, run_off)) return false;
    }
  }
  *pos_io = pos;
  return true;
}

}  // namespace

// Run chunk -> SGA code bytes via the stored-run partition, resuming the
// 64-byte block rule at state[0] (global RLE byte offset, updated on success).
// Returns the number of codes written, or -2 if `cap` would be exceeded
// (state unchanged; caller grows `out` and retries).
namespace {

// TOTALS: state[1] and state[2] also add the chunk's bases and sequences
// (the lengths of all runs and of the runs of symbol 0).
template <typename LenT, bool TOTALS = false>
int64_t sga_chunk_impl(const uint8_t* syms, const LenT* lens,
                       int64_t n, int64_t* state, uint8_t* out,
                       int64_t cap) {
  int64_t pos = state[0];
  int64_t n_codes = 0;
  int64_t bases = 0, sequences = 0;
  bool ok = walk_stored(
      syms, lens, n, &pos,
      [&](uint8_t c, int64_t stored_len, int64_t) {
        if (TOTALS) {
          bases += stored_len;
          if (c == 0) sequences += stored_len;
        }
        int64_t full = (stored_len + SGA_MAX_RUN - 1) / SGA_MAX_RUN;
        if (n_codes + full > cap) return false;
        uint8_t full_code =
            static_cast<uint8_t>((c << 5) | SGA_MAX_RUN);
        for (int64_t k = 1; k < full; k++) out[n_codes++] = full_code;
        int64_t last = stored_len - (full - 1) * SGA_MAX_RUN;
        out[n_codes++] = static_cast<uint8_t>((c << 5) | last);
        return true;
      },
      [](int64_t, uint8_t) { return true; });  // bytes not materialized
  if (!ok) return -2;
  state[0] = pos;
  if (TOTALS) {
    state[1] += bases;
    state[2] += sequences;
  }
  return n_codes;
}

// Run chunk -> native RLE bytes + per-block sample rows.
//
// state: int64[8] = {rle_byte_offset, text_pos, counts[SIGMA]} — updated on
// success.  Writes the chunk's RLE bytes into rle[0..] (indexed from the
// chunk start); emits one row per 64-byte block whose LAST stored run in this
// chunk is known: blk_id[i], blk_end[i] (text position after that run),
// blk_cc[i*SIGMA..] (cumulative char counts after it).  The FINAL row is the
// chunk's trailing block, which may still be open (caller merges across
// chunks exactly as before).  Returns the number of rows, or -2 if rle_cap /
// blk_cap would be exceeded (state unchanged, caller grows and retries).
// The number of RLE bytes written is new_state[0] - old_state[0].
template <typename LenT>
int64_t native_chunk_impl(const uint8_t* syms, const LenT* lens,
                          int64_t n, int64_t* state, uint8_t* rle,
                          int64_t rle_cap, int64_t* blk_id,
                          int64_t* blk_end, int64_t* blk_cc,
                          int64_t blk_cap) {
  if (n == 0) return 0;
  const int64_t start = state[0];
  int64_t pos = start;
  int64_t text_pos = state[1];
  int64_t counts[SIGMA];
  for (int64_t c = 0; c < SIGMA; c++) counts[c] = state[2 + c];

  int64_t rows = 0;
  int64_t open_block = -1;        // block id of the pending row
  int64_t open_end = 0;
  int64_t open_cc[SIGMA];

  bool ok = walk_stored(
      syms, lens, n, &pos,
      [&](uint8_t c, int64_t stored_len, int64_t run_off) {
        int64_t block = run_off / BLOCK;
        if (block != open_block && open_block >= 0) {
          if (rows >= blk_cap) return false;
          blk_id[rows] = open_block;
          blk_end[rows] = open_end;
          for (int64_t k = 0; k < SIGMA; k++) blk_cc[rows * SIGMA + k] = open_cc[k];
          rows++;
        }
        text_pos += stored_len;
        counts[c] += stored_len;
        open_block = block;
        open_end = text_pos;
        for (int64_t k = 0; k < SIGMA; k++) open_cc[k] = counts[k];
        return true;
      },
      [&](int64_t p, uint8_t b) {
        if (p - start >= rle_cap) return false;
        rle[p - start] = b;
        return true;
      });
  if (!ok) return -2;
  // trailing (possibly open) block row
  if (open_block >= 0) {
    if (rows >= blk_cap) return -2;
    blk_id[rows] = open_block;
    blk_end[rows] = open_end;
    for (int64_t k = 0; k < SIGMA; k++) blk_cc[rows * SIGMA + k] = open_cc[k];
    rows++;
  }
  state[0] = pos;
  state[1] = text_pos;
  for (int64_t c = 0; c < SIGMA; c++) state[2 + c] = counts[c];
  return rows;
}

}  // namespace

// 64-phase transfer table for a run FRAGMENT: for each start phase p in
// [0, 64) of the global RLE byte offset, out[p] = total encoded native RLE
// bytes and out[64 + p] = total SGA codes of (syms, lens) under the
// position-dependent block rule (support.h:256-282).  The multihost fragment
// writer gathers these tiny tables and composes offset_{k+1} = offset_k +
// bytes_k(offset_k mod 64) locally, so cross-fragment byte offsets resolve
// with one collective instead of a sequential encode chain.
EXPORT int64_t fragment_phase_table(const uint8_t* syms, const int64_t* lens,
                                    int64_t n, int64_t* out) {
  for (int64_t phase = 0; phase < BLOCK; phase++) {
    int64_t pos = phase;
    int64_t n_codes = 0;
    bool ok = walk_stored(
        syms, lens, n, &pos,
        [&](uint8_t, int64_t stored_len, int64_t) {
          n_codes += (stored_len + SGA_MAX_RUN - 1) / SGA_MAX_RUN;
          return true;
        },
        [](int64_t, uint8_t) { return true; });
    if (!ok) return -1;
    out[phase] = pos - phase;
    out[BLOCK + phase] = n_codes;
  }
  return 0;
}

EXPORT int64_t sga_stream_chunk(const uint8_t* syms, const int64_t* lens,
                                int64_t n, int64_t* state, uint8_t* out,
                                int64_t cap) {
  return sga_chunk_impl<int64_t>(syms, lens, n, state, out, cap);
}

EXPORT int64_t sga_stream_chunk32(const uint8_t* syms, const int32_t* lens,
                                  int64_t n, int64_t* state, uint8_t* out,
                                  int64_t cap) {
  return sga_chunk_impl<int32_t>(syms, lens, n, state, out, cap);
}

// sga_stream_chunk that also adds the chunk's bases and sequences into
// state[1] and state[2] (state = int64[3]), on success only.
EXPORT int64_t sga_stream_chunk_totals(const uint8_t* syms,
                                       const int64_t* lens, int64_t n,
                                       int64_t* state, uint8_t* out,
                                       int64_t cap) {
  return sga_chunk_impl<int64_t, true>(syms, lens, n, state, out, cap);
}

EXPORT int64_t sga_stream_chunk_totals32(const uint8_t* syms,
                                         const int32_t* lens, int64_t n,
                                         int64_t* state, uint8_t* out,
                                         int64_t cap) {
  return sga_chunk_impl<int32_t, true>(syms, lens, n, state, out, cap);
}

EXPORT int64_t native_stream_chunk(const uint8_t* syms, const int64_t* lens,
                                   int64_t n, int64_t* state, uint8_t* rle,
                                   int64_t rle_cap, int64_t* blk_id,
                                   int64_t* blk_end, int64_t* blk_cc,
                                   int64_t blk_cap) {
  return native_chunk_impl<int64_t>(syms, lens, n, state, rle, rle_cap,
                                    blk_id, blk_end, blk_cc, blk_cap);
}

EXPORT int64_t native_stream_chunk32(const uint8_t* syms, const int32_t* lens,
                                     int64_t n, int64_t* state, uint8_t* rle,
                                     int64_t rle_cap, int64_t* blk_id,
                                     int64_t* blk_end, int64_t* blk_cc,
                                     int64_t blk_cap) {
  return native_chunk_impl<int32_t>(syms, lens, n, state, rle, rle_cap,
                                    blk_id, blk_end, blk_cc, blk_cap);
}
