// Bit planes of a record block's 32 packed symbols, by SWAR: shared by the
// table builders of walk.cu (walk_planes_build) and decode.cu
// (decode_rows_build).
//
// A record's symbol half is 8 words, 4 symbols a word, one a byte, LSB
// first: position 4w + b is byte b of word w.  Symbol bytes are 0..15, as
// every record table of the port holds them.  A pair of words (positions
// 8p .. 8p+7) is folded into one word q = lo | hi << 4, so byte i of q holds
// position 8p+i in its low nibble and 8p+4+i in its high one; the two never
// overlap, so the fold is written lo + hi * 16, one multiply-add.  Then
// q & (0x11111111 << K) holds bit K of those eight symbols at bits 8i+K and
// 8i+4+K, and one multiply by 0x01020408 >> K gathers them into the top
// byte in position order: the eight partial products fall on distinct bits,
// so nothing carries (the product equals that of ((q >> K) & 0x11111111)
// and 0x01020408 modulo 2^32, with no shift).  Three byte permutes put the
// four pairs' top bytes into one word.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The block's symbol words s0 = words 0..3, s1 = words 4..7, folded in
// pairs: q[p] = word 2p | word 2p+1 << 4.
__device__ __forceinline__ void fold_symbol_words(uint4 s0, uint4 s1,
                                                  uint32_t q[4]) {
  q[0] = s0.x + s0.y * 16u;
  q[1] = s0.z + s0.w * 16u;
  q[2] = s1.x + s1.y * 16u;
  q[3] = s1.z + s1.w * 16u;
}

// Bit plane K (0..3) of the block's 32 symbols, in position order: bit
// 8p + j of the result is bit K of the symbol at position 8p + j.
template <int K>
__device__ __forceinline__ uint32_t symbol_plane(const uint32_t q[4]) {
  static_assert(K >= 0 && K <= 3, "a symbol has four bits");
  uint32_t t[4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
    t[p] = (q[p] & (0x11111111u << K)) * (0x01020408u >> K);
  return __byte_perm(__byte_perm(t[0], t[1], 0x0073),
                     __byte_perm(t[2], t[3], 0x0073), 0x5410);
}
