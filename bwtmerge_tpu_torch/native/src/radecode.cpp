// Rank-array transfer-plane decode: one pass from the device's packed
// nibble / pair-code planes to dedup-summed sorted (value, count) runs.
//
// The device ships the rank array as delta/count planes plus a shared
// 2-byte escape stream and a >254-outlier table (the packing
// side); the host previously reassembled it with a chain of
// numpy passes (plane split, exception scatter, cumsum, segment-head
// dedup) while holding the GIL against the
// interleave threads.  These kernels fuse the whole reassembly into one
// sequential sweep (GIL released), with cross-chunk state so a
// windowed stream decodes incrementally — the device-transfer analog of
// the reference's RLArray chunk decode (support.h:505-516 / support.cpp),
// re-derived for the packed planes.

#include <cstdint>

#define EXPORT extern "C" __attribute__((visibility("default")))

// state layout (int64[5]): {carry, pend_v, pend_c, have_pend, esc_off}
//   carry:    running absolute a-position (sum of all deltas so far)
//   pend_*:   trailing run withheld for cross-chunk duplicate merging
//   esc_off:  running cursor into the block-global escape stream
// finish != 0 flushes the pending run after the last lane.
//
// nib: m plane bytes (delta in the low nibble, count in the high; the
// marker byte 15 = escape lane reading its (delta, count) pair from
// esc_d/esc_c at the running cursor).  exc_idx/exc_d/exc_c: n_exc
// window-RELATIVE ascending >254-outlier rows overriding their lanes
// (their escape pair is the saturation marker (255, 255)).
// out_v/out_c: capacity >= m + 1.  Returns runs written (>= 0), or -1
// when the escape stream would overrun (corrupt packed RA).
EXPORT int64_t ra_decode_nib_chunk(const uint8_t* nib, int64_t m,
                                   const uint8_t* esc_d, const uint8_t* esc_c,
                                   int64_t n_esc,
                                   const int64_t* exc_idx,
                                   const int64_t* exc_delta,
                                   const int64_t* exc_count, int64_t n_exc,
                                   int64_t* state, int32_t finish,
                                   int64_t* out_v, int64_t* out_c) {
  int64_t carry = state[0];
  int64_t pend_v = state[1];
  int64_t pend_c = state[2];
  bool have_pend = state[3] != 0;
  int64_t esc_off = state[4];
  int64_t n_out = 0;
  int64_t e = 0;
  int64_t next_exc = (e < n_exc) ? exc_idx[e] : -1;
  for (int64_t i = 0; i < m; i++) {
    uint8_t b = nib[i];
    int64_t d, c;
    if ((b & 15) == 15) {
      if (esc_off >= n_esc) return -1;  // corrupt escape stream
      d = esc_d[esc_off];
      c = esc_c[esc_off];
      esc_off++;
    } else {
      d = b & 15;
      c = b >> 4;
    }
    if (i == next_exc) {
      d = exc_delta[e];
      c = exc_count[e];
      e++;
      next_exc = (e < n_exc) ? exc_idx[e] : -1;
    }
    carry += d;
    if (have_pend && carry == pend_v) {
      pend_c += c;
    } else {
      if (have_pend) {
        out_v[n_out] = pend_v;
        out_c[n_out] = pend_c;
        n_out++;
      }
      pend_v = carry;
      pend_c = c;
      have_pend = true;
    }
  }
  if (finish && have_pend) {
    out_v[n_out] = pend_v;
    out_c[n_out] = pend_c;
    n_out++;
    have_pend = false;
  }
  state[0] = carry;
  state[1] = pend_v;
  state[2] = pend_c;
  state[3] = have_pend ? 1 : 0;
  state[4] = esc_off;
  return n_out;
}

// Pair-code (q4) plane decode: two 4-bit codes per byte (low nibble first)
// naming (delta, count) pairs in the caller-supplied 16-entry tables; code
// 15 escapes to one (delta, count) byte pair consumed in lane order from
// the block-global side stream esc_d/esc_c (the pair (255, 255) marks a
// >254 outlier overridden by its exception row, exactly as on the nibble
// plane).  Same state layout as ra_decode_nib_chunk.  q4 points at this
// window's bytes (window starts are even, so window-relative lane parity
// equals nibble parity).  Returns runs written, or -1 when the escape
// stream would overrun (corrupt packed RA; state unchanged semantics not
// guaranteed — callers abort the stream).
EXPORT int64_t ra_decode_q4_chunk(const uint8_t* q4, int64_t m,
                                  const int64_t* tab_d, const int64_t* tab_c,
                                  const uint8_t* esc_d, const uint8_t* esc_c,
                                  int64_t n_esc,
                                  const int64_t* exc_idx,
                                  const int64_t* exc_delta,
                                  const int64_t* exc_count, int64_t n_exc,
                                  int64_t* state, int32_t finish,
                                  int64_t* out_v, int64_t* out_c) {
  int64_t carry = state[0];
  int64_t pend_v = state[1];
  int64_t pend_c = state[2];
  bool have_pend = state[3] != 0;
  int64_t esc_off = state[4];
  int64_t n_out = 0;
  int64_t e = 0;
  int64_t next_exc = (e < n_exc) ? exc_idx[e] : -1;
  for (int64_t i = 0; i < m; i++) {
    uint8_t b = q4[i >> 1];
    uint8_t code = (i & 1) ? (b >> 4) : (b & 15);
    int64_t d, c;
    if (code == 15) {
      if (esc_off >= n_esc) return -1;  // corrupt escape stream
      d = esc_d[esc_off];
      c = esc_c[esc_off];
      esc_off++;
    } else {
      d = tab_d[code];
      c = tab_c[code];
    }
    if (i == next_exc) {
      d = exc_delta[e];
      c = exc_count[e];
      e++;
      next_exc = (e < n_exc) ? exc_idx[e] : -1;
    }
    carry += d;
    if (have_pend && carry == pend_v) {
      pend_c += c;
    } else {
      if (have_pend) {
        out_v[n_out] = pend_v;
        out_c[n_out] = pend_c;
        n_out++;
      }
      pend_v = carry;
      pend_c = c;
      have_pend = true;
    }
  }
  if (finish && have_pend) {
    out_v[n_out] = pend_v;
    out_c[n_out] = pend_c;
    n_out++;
    have_pend = false;
  }
  state[0] = carry;
  state[1] = pend_v;
  state[2] = pend_c;
  state[3] = have_pend ? 1 : 0;
  state[4] = esc_off;
  return n_out;
}
