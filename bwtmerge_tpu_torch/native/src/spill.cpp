// Rank-array spill codec: delta+varint encoding of sorted (value, count) runs.
//
// The byte layout matches the reference RLArray cell (support.h:505-516): each
// run is (varint of value - previous value, varint of count), with the
// ByteCode varint (LSB-first 7-bit groups, 0x80 continuation).  Spill files of
// this codec are the out-of-core representation of the rank array — the
// framework's analog of the reference's temp-file RLArrays re-merged by
// RankArray (support.h:576-638).
//
// ra_decode_chunk supports stateful streaming: callers resume from
// (byte offset, previous value) so a multi-GB spill file is consumed in
// bounded-memory chunks during the k-way merge.

#include <cstdint>

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr uint8_t DATA_MASK = 0x7F;
constexpr uint8_t NEXT_BYTE = 0x80;
constexpr int DATA_BITS = 7;

inline int64_t varint_size(uint64_t v) {
  int64_t n = 1;
  while (v > DATA_MASK) {
    v >>= DATA_BITS;
    n++;
  }
  return n;
}

inline void varint_write(uint8_t* out, int64_t& pos, uint64_t v) {
  while (v > DATA_MASK) {
    out[pos++] = static_cast<uint8_t>((v & DATA_MASK) | NEXT_BYTE);
    v >>= DATA_BITS;
  }
  out[pos++] = static_cast<uint8_t>(v);
}

inline uint64_t varint_read(const uint8_t* data, int64_t& pos) {
  uint64_t v = 0;
  int shift = 0;
  while (true) {
    uint8_t b = data[pos++];
    v += static_cast<uint64_t>(b & DATA_MASK) << shift;
    if (!(b & NEXT_BYTE)) break;
    shift += DATA_BITS;
  }
  return v;
}

}  // namespace

EXPORT int64_t ra_encode_size(const int64_t* values, const int64_t* counts,
                              int64_t n) {
  int64_t bytes = 0;
  int64_t prev = 0;
  for (int64_t i = 0; i < n; i++) {
    bytes += varint_size(static_cast<uint64_t>(values[i] - prev));
    bytes += varint_size(static_cast<uint64_t>(counts[i]));
    prev = values[i];
  }
  return bytes;
}

EXPORT int64_t ra_encode(const int64_t* values, const int64_t* counts, int64_t n,
                         uint8_t* out) {
  int64_t pos = 0;
  int64_t prev = 0;
  for (int64_t i = 0; i < n; i++) {
    varint_write(out, pos, static_cast<uint64_t>(values[i] - prev));
    varint_write(out, pos, static_cast<uint64_t>(counts[i]));
    prev = values[i];
  }
  return pos;
}

// Linear 2-way merge of two sorted-unique (value, count) run lists, summing
// counts of equal values — the hot inner op of the k-way chunk-stream merge
// (models/spill.py merge_ra_chunk_streams; reference counterpart: the
// RLArray 2-way merge constructor, support.h:434-453).  One branchy pass
// replaces two numpy searchsorted passes + scatters.  Output buffers must
// hold na + nb runs; returns the merged (deduplicated) count.
EXPORT int64_t ra_merge_pair(const int64_t* va, const int64_t* ka, int64_t na,
                             const int64_t* vb, const int64_t* kb, int64_t nb,
                             int64_t* out_v, int64_t* out_k) {
  int64_t i = 0, j = 0, m = 0;
  while (i < na && j < nb) {
    int64_t x = va[i], y = vb[j];
    if (x < y) {
      out_v[m] = x;
      out_k[m++] = ka[i++];
    } else if (y < x) {
      out_v[m] = y;
      out_k[m++] = kb[j++];
    } else {
      out_v[m] = x;
      out_k[m++] = ka[i++] + kb[j++];
    }
  }
  while (i < na) {
    out_v[m] = va[i];
    out_k[m++] = ka[i++];
  }
  while (j < nb) {
    out_v[m] = vb[j];
    out_k[m++] = kb[j++];
  }
  return m;
}

// Decode up to max_runs runs starting at state[0] = byte offset with
// state[1] = previous value.  Updates state in place; returns runs decoded.
EXPORT int64_t ra_decode_chunk(const uint8_t* data, int64_t bytes,
                               int64_t max_runs, int64_t* state,
                               int64_t* values, int64_t* counts) {
  int64_t pos = state[0];
  int64_t prev = state[1];
  int64_t r = 0;
  while (pos < bytes && r < max_runs) {
    prev += static_cast<int64_t>(varint_read(data, pos));
    values[r] = prev;
    counts[r] = static_cast<int64_t>(varint_read(data, pos));
    r++;
  }
  state[0] = pos;
  state[1] = prev;
  return r;
}
