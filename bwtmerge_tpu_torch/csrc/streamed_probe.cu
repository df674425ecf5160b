// Streamed-rank probe (K1): ranks over the block-fused record table for a
// batch of sorted positions q, in three forms, each writing only what its
// callers read.
//
// Replaces: bwtmerge_tpu/ops/rank_pallas.py:_kernel (:58, launched by
// _streamed_ranks_padded through pl.pallas_call).  Only the contract is
// ported: not the TPU's tile streaming and bf16 one-hot matmuls, and not
// its 16-row output (OUT_W = 16 there, a sublane pad whose rows 9-15 are
// always zero).
//
// Contract.  rec is int32[NBLK, 16]: words 0-7 hold the exclusive occ count
// of each character before the block, words 8-15 the block's 32 symbols,
// 4 per word, LSB first (word w holds positions 4w..4w+3).  q is int32[Q],
// non-decreasing.  A q outside [0, size] (the 2^31-1 sentinel of a sorted
// batch) never indexes the table and writes zeros.  For 0 <= q <= size:
//
//   full    out int32[9, Q] row-major: rows 0-7 rank(q, c) for c = 0..7,
//           row 8 the symbol at q (the pad value SIGMA when q == size).
//           Bytes a query: 4 in, 36 out.  Operations: a compare and an add
//           for each of 8 characters at each of 32 positions.  For the
//           trie's range step and ranks_all.
//   select  chars[Q] beside the keys (uint8, int8, int16, int32 or int64:
//           the caller's own dtype); out int32[Q], rank(q, clamp(c, 0, 7)).
//           Given perm (int64[Q], the permutation that sorted the keys),
//           chars are in the caller's order and read as chars[perm[i]],
//           and each rank is written to its caller's place, out[perm[i]]:
//           a sort's realign, fused into the launch.  Bytes a query: 4 in,
//           1-8 for the character, 4 out, 8 more for perm.  Operations: a
//           compare and an add at each of 32 positions.  For a -v count's
//           step (fused) and the trie's singles step on A (sorted chars).
//   lf      out int32[2, Q]: row 0 the symbol s at q, row 1 rank(q,
//           clamp(s, 0, 7)): one LF step.  Bytes a query: 4 in, 8 out;
//           operations as select.  For the trie's singles step on B.
//
// What bounds it on this card.  Each live query reads one 64-byte record,
// shared with its neighbours when they fall in the same block, so every
// form is bound by memory: by the records and, for full, by its 36 bytes
// of output a query.  The earlier kernel stored 64 bytes a query whatever
// the caller read (the TPU's 16 rows); at a -v count's keys those stores
// were most of its traffic.
//
// The fused select form also reads one character and writes one rank at
// random through perm: two 4-byte accesses a key, each a 32-byte sector of
// L2 traffic, which bound it more than its bytes do (at a -v count's keys
// about 9.5M sectors a launch).
//
// What the design does about it.  One thread per query; the record is four
// 16-byte loads.  Because the batch is sorted, neighbouring threads of a
// warp read the same or neighbouring records, so the loads coalesce: that
// is the GPU's counterpart of the TPU's table streaming.  Each form stores
// only its own rows, row-major, so consecutive threads store to
// consecutive addresses (the fused select's stores scatter by perm, in
// place of a separate gather and scatter over the whole batch).  The keys
// and perm, read once, are loaded evict-first (ld.global.cs), and so are
// the records in the fused select form, so that its characters and ranks
// keep their lines in the L2 between the random accesses.  A prefix
// count is a SWAR zero-byte test and a popcount per packed word, all in
// registers: select and lf count one character (8 tests), full all eight
// (64).  Masks come from compares and constant shifts only: a
// data-dependent shift miscompiled here under nvcc 12.8 (sm_90a).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 8;
constexpr int kFullRows = kLanes + 1;
constexpr int kThreads = 256;

// the forms and the select form's character types, as the wrapper passes
// them (bwtmerge_tpu_torch/ops/rank_streamed.py: FORMS, CHAR_TYPES)
enum Form : int { kFull = 0, kSelect = 1, kLf = 2 };
enum CharType : int { kU8 = 0, kI8 = 1, kI16 = 2, kI32 = 3, kI64 = 4 };

// 0x80 in every byte of x that is zero, 0 elsewhere.
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  uint32_t t = ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x;
  return ~t & 0x80808080u;
}

struct Record {
  int occ[kLanes];
  uint32_t words[8];
  uint32_t before[8];   // 0x80 in the bytes of the positions < q & 31
  int off;              // q & 31
};

// kEvictFirst marks the record's lines first to leave the L2 (ld.global.cs),
// so that the characters and ranks the fused select form reads and writes
// at random through the permutation stay there
template <bool kEvictFirst>
__device__ __forceinline__ Record load_record(const int4* __restrict__ rec,
                                              int qi) {
  const int4* r = rec + (int64_t)(qi >> 5) * 4;
  int4 o0, o1, w0, w1;
  if constexpr (kEvictFirst) {
    o0 = __ldcs(r); o1 = __ldcs(r + 1); w0 = __ldcs(r + 2); w1 = __ldcs(r + 3);
  } else {
    o0 = __ldg(r); o1 = __ldg(r + 1); w0 = __ldg(r + 2); w1 = __ldg(r + 3);
  }
  Record x;
  x.occ[0] = o0.x; x.occ[1] = o0.y; x.occ[2] = o0.z; x.occ[3] = o0.w;
  x.occ[4] = o1.x; x.occ[5] = o1.y; x.occ[6] = o1.z; x.occ[7] = o1.w;
  x.words[0] = (uint32_t)w0.x; x.words[1] = (uint32_t)w0.y;
  x.words[2] = (uint32_t)w0.z; x.words[3] = (uint32_t)w0.w;
  x.words[4] = (uint32_t)w1.x; x.words[5] = (uint32_t)w1.y;
  x.words[6] = (uint32_t)w1.z; x.words[7] = (uint32_t)w1.w;
  x.off = qi & 31;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    uint32_t m = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * w + b < x.off) m |= 0x80u << (8 * b);
    x.before[w] = m;
  }
  return x;
}

// the symbol at position off of the block
__device__ __forceinline__ int symbol_at(const Record& x) {
  int sym = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * w + b == x.off) sym = (x.words[w] >> (8 * b)) & 0xFF;
  return sym;
}

// rank(q, c) for c in [0, 7]; occ[c] picked by compares, so the array
// stays in registers
__device__ __forceinline__ int rank_of(const Record& x, int c) {
  int o = x.occ[0];
#pragma unroll
  for (int k = 1; k < kLanes; ++k)
    if (c == k) o = x.occ[k];
  uint32_t pat = 0x01010101u * (uint32_t)c;
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w)
    cnt += __popc(zero_bytes(x.words[w] ^ pat) & x.before[w]);
  return o + cnt;
}

template <typename T>
__device__ __forceinline__ int clamp_char(T v) {
  return v <= (T)0 ? 0 : (v >= (T)(kLanes - 1) ? kLanes - 1 : (int)v);
}

template <int kForm, typename CharT, bool kPerm>
__global__ void __launch_bounds__(kThreads)
streamed_probe_kernel(const int4* __restrict__ rec, const int* __restrict__ q,
                      int64_t n, int size, const CharT* __restrict__ chars,
                      const int64_t* __restrict__ perm,
                      int* __restrict__ out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int qi = __ldcs(q + i);
  bool live = qi >= 0 && qi <= size;
  if constexpr (kForm == kFull) {
    int res[kFullRows];
#pragma unroll
    for (int k = 0; k < kFullRows; ++k) res[k] = 0;
    if (live) {
      Record x = load_record<false>(rec, qi);
#pragma unroll
      for (int c = 0; c < kLanes; ++c) res[c] = rank_of(x, c);
      res[kLanes] = symbol_at(x);
    }
#pragma unroll
    for (int k = 0; k < kFullRows; ++k) out[k * n + i] = res[k];
  } else if constexpr (kForm == kSelect) {
    int64_t dst = i;
    if constexpr (kPerm) dst = __ldcs((const long long*)perm + i);
    int rank = 0;
    if (live) {
      Record x = load_record<kPerm>(rec, qi);
      rank = rank_of(x, clamp_char(chars[dst]));
    }
    out[dst] = rank;
  } else {
    int sym = 0, rank = 0;
    if (live) {
      Record x = load_record<false>(rec, qi);
      sym = symbol_at(x);
      rank = rank_of(x, sym < kLanes - 1 ? sym : kLanes - 1);
    }
    out[i] = sym;
    out[n + i] = rank;
  }
}

template <int kForm, typename CharT, bool kPerm>
int launch(const void* rec, const void* q, int64_t n, int size,
           const void* chars, const void* perm, void* out,
           cudaStream_t stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  streamed_probe_kernel<kForm, CharT, kPerm>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(
          (const int4*)rec, (const int*)q, n, size, (const CharT*)chars,
          (const int64_t*)perm, (int*)out);
  return (int)cudaGetLastError();
}

template <typename CharT>
int launch_select(const void* rec, const void* q, int64_t n, int size,
                  const void* chars, const void* perm, void* out,
                  cudaStream_t stream) {
  return perm ? launch<kSelect, CharT, true>(rec, q, n, size, chars, perm,
                                             out, stream)
              : launch<kSelect, CharT, false>(rec, q, n, size, chars, perm,
                                              out, stream);
}

}  // namespace

extern "C" {

// One launch of the form `form` (chars, char_type and perm are read by
// the select form only; perm may be null).  Returns cudaGetLastError()
// after the launch (0 on success), cudaErrorInvalidValue for a form or
// character type it does not know.
int streamed_probe_launch(const void* rec, const void* q, int64_t n, int size,
                          int form, const void* chars, int char_type,
                          const void* perm, void* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case kFull:
      return launch<kFull, int, false>(rec, q, n, size, nullptr, nullptr,
                                       out, s);
    case kLf:
      return launch<kLf, int, false>(rec, q, n, size, nullptr, nullptr, out,
                                     s);
    case kSelect:
      switch (char_type) {
        case kU8: return launch_select<uint8_t>(rec, q, n, size, chars, perm,
                                                out, s);
        case kI8: return launch_select<int8_t>(rec, q, n, size, chars, perm,
                                               out, s);
        case kI16: return launch_select<int16_t>(rec, q, n, size, chars,
                                                 perm, out, s);
        case kI32: return launch_select<int32_t>(rec, q, n, size, chars,
                                                 perm, out, s);
        case kI64: return launch_select<int64_t>(rec, q, n, size, chars,
                                                 perm, out, s);
      }
  }
  return (int)cudaErrorInvalidValue;
}

const char* streamed_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
