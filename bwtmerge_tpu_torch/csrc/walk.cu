// Per-read backward walk (K2) and the build of its table: every read of B
// walked through A's index, one emission per B position.
//
// Replaces: bwtmerge_tpu/ops/walk_jax.py:_walk_emit and _rank_known_char
// (an XLA lax.scan on the TPU, the merge's main-path hot loop), and
// walk_jax.py:build_cplanes for the table.
//
// The table ("wide planes").  planes is int32[NSB, 5, 8] with
// NSB = ceil(NBLK / 7): row (super-block sb, c-1) is one aligned 32-byte
// sector [occ | m0 .. m6] for the 224 positions from 224*sb on.  occ is the
// number of c before position 224*sb; bit k of m_w is set iff position
// 224*sb + 32*w + k holds c (positions past the record table hold nothing).
// walk_planes_build fills it from the record table int32[NBLK, 16] (words
// 0..7 occ before the block, words 8..15 the block's 32 symbols, 4 per
// word, LSB first).
//
// The walk's contract.  C is int32[9], the cumulative character counts.
// creads is int8[max_len, R]: row t lane r is the t-th character of read r
// counted from its end, 0 past the end.  Lane r starts at a = a_sequences;
// at row t with c = creads[t, r] in 1..5 it steps, with sb = a / 224 and
// off = a - 224*sb, to
//   a = C[c] + occ + popcount of the row's mask bits before bit off
// and emits a; otherwise it emits 2^31-1 and keeps a.  emits is
// int32[max_len * R] (row t at offset t*R); n_live (uint64, zeroed by the
// caller) receives the number of live emissions.
//
// What bounds it on this card (measured on an NVIDIA H100 80GB HBM3 at
// 700 W).  Each live step is one dependent load at a data-dependent
// address, and the memory system moves whole 32-byte sectors.  With the
// table in the L2 the walk runs at about one sector fetched per two clocks
// on each SM, whatever share of the sector it uses; with a table above the
// L2's size every miss also costs a sector of device memory.
//
// What the design does about it.  A step reads exactly one sector and may
// need any byte of it: 0.71 bytes of table per position of A, so a table
// above the L2's size misses less and the table of an index of some 60 M
// positions fits the 50 MB L2.  creads is loaded and emits are stored with
// streaming hints (evicted first).  The table is loaded plainly: an L2
// set-aside with evict_last loads, and a persisting access window over the
// table, were both slower at every size tried.  One thread per read lane
// with the walk state in a register and the loop over rows inside the
// thread; the next row's character is loaded before this row's step, so
// its latency hides behind the sector's.  creads and emits rows are
// lane-contiguous, so those accesses coalesce.  The in-sector prefix is seven predicated popcounts:
// no register is indexed by data, and the only data-dependent shift is a
// 64-bit one by at most 31.  n_live is a warp-shuffle and block reduction
// followed by one atomicAdd per block.
//
// The table's build.  One thread per (super-block, word): word 0 copies the five
// occ counts of block 7*sb, words 1..7 each turn one block's packed
// symbols into its five masks.  The eight threads of a super-block write
// the eight words of a row together, so every store fills whole sectors;
// the record table is read once (the symbol half of every record, the occ
// half of every seventh), 186 MB at 100 M positions: 0.055 ms at 3.35 TB/s.
// Taking each of a block's 32 symbol bytes out with a shift and comparing
// it five times costs some 500 instructions a block, as long as the bytes
// take.  So the masks are made by SWAR (113 SASS instructions a thread),
// and the instructions hide under the bytes: the four bit planes of a
// block's symbols come from symbol_plane (symbol_plane.cuh, shared with
// decode.cu's builder: a multiply gathers one bit of eight symbols), and
// each character's mask is an AND of the four planes or their
// complements.  What bounds it now, measured on an
// NVIDIA H100 80GB HBM3 at 700 W: 0.089 ms of device time at 100 M
// positions, which is the whole 64-byte records (200 MB) and the planes
// (71 MB) at the card's copy rate.  A read-only probe kernel
// (chip_smoke.py, record_read_probe) reads the 32-byte second half of
// every 64-byte record of a 1 GiB table in the same time as the whole
// records (0.336 against 0.335 ms, 3.2 TB/s for the whole): device memory
// moves 64 bytes for each half record read, so reading only the symbol
// halves saves no time, and the bound, which counts 32 bytes a record,
// is out of reach for this table layout.

#include <cuda_runtime.h>
#include <stdint.h>

#include "symbol_plane.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNC = 5;         // walked characters 1..5
constexpr int kSuper = 224;    // positions per table row: 7 mask words
constexpr int kWords = 7;
constexpr int kSent = 0x7FFFFFFF;

// One step of lane state a on character c: the row's sector, then occ plus
// the mask bits before bit off.
__device__ __forceinline__ int walk_step(const uint4* __restrict__ planes,
                                         const int* sC, int a, int c) {
  int sb = a / kSuper;
  int off = a - sb * kSuper;
  const uint4* row = planes + ((int64_t)sb * kNC + (c - 1)) * 2;
  uint4 lo = __ldg(row), hi = __ldg(row + 1);   // 32 bytes, one sector
  const uint32_t m[kWords] = {lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  int word = off >> 5;
  uint32_t low = (uint32_t)((1ull << (off & 31)) - 1ull);
  int count = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    uint32_t take = word > w ? 0xFFFFFFFFu : (word == w ? low : 0u);
    count += __popc(m[w] & take);
  }
  return sC[c] + (int)lo.x + count;
}

__global__ void __launch_bounds__(kThreads)
walk_emit_kernel(const uint4* __restrict__ planes, const int* __restrict__ C,
                 const int8_t* __restrict__ creads, int max_len, int64_t R,
                 int a0, int* __restrict__ emits,
                 unsigned long long* __restrict__ n_live) {
  __shared__ int sC[kNC + 1];
  __shared__ unsigned warp_live[kThreads / 32];
  if (threadIdx.x <= kNC) sC[threadIdx.x] = C[threadIdx.x];
  __syncthreads();

  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned live = 0;
  if (r < R) {
    int a = a0;
    int next = __ldcs(creads + r);
    for (int t = 0; t < max_len; ++t) {
      int c = next;
      // the next row's character is on its way while this row's step waits
      // for its sector
      if (t + 1 < max_len) next = __ldcs(creads + (int64_t)(t + 1) * R + r);
      int e = kSent;
      if (c >= 1 && c <= kNC) {
        a = walk_step(planes, sC, a, c);
        e = a;
        ++live;
      }
      __stcs(emits + (int64_t)t * R + r, e);
    }
  }

#pragma unroll
  for (int s = 16; s > 0; s >>= 1) live += __shfl_down_sync(0xFFFFFFFFu, live, s);
  if ((threadIdx.x & 31) == 0) warp_live[threadIdx.x >> 5] = live;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_live[w];
    if (total) atomicAdd(n_live, total);
  }
}

__global__ void __launch_bounds__(kThreads)
walk_planes_build_kernel(const uint4* __restrict__ rec, int64_t nblk,
                         int64_t n_sb, uint32_t* __restrict__ planes) {
  int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t sb = g >> 3;
  int slot = (int)(g & 7);
  if (sb >= n_sb) return;
  uint32_t out[kNC] = {0u, 0u, 0u, 0u, 0u};
  if (slot == 0) {
    const uint4* row = rec + sb * kWords * 4;      // block 7*sb < nblk
    uint4 o0 = __ldg(row), o1 = __ldg(row + 1);
    out[0] = o0.y; out[1] = o0.z; out[2] = o0.w; out[3] = o1.x; out[4] = o1.y;
  } else {
    int64_t blk = sb * kWords + (slot - 1);
    if (blk < nblk) {
      const uint4* row = rec + blk * 4;
      uint4 s0 = __ldg(row + 2), s1 = __ldg(row + 3);
      uint32_t q[4];
      fold_symbol_words(s0, s1, q);
      const uint32_t p0 = symbol_plane<0>(q), p1 = symbol_plane<1>(q),
                     p2 = symbol_plane<2>(q), p3 = symbol_plane<3>(q);
      const uint32_t lo = ~p2 & ~p3, hi = p2 & ~p3;   // symbols 0..3, 4..7
      out[0] = p0 & ~p1 & lo;      // 1
      out[1] = ~p0 & p1 & lo;      // 2
      out[2] = p0 & p1 & lo;       // 3
      out[3] = ~p0 & ~p1 & hi;     // 4
      out[4] = p0 & ~p1 & hi;      // 5
    }
  }
  uint32_t* dst = planes + sb * (kNC * 8) + slot;
#pragma unroll
  for (int c = 0; c < kNC; ++c) dst[c * 8] = out[c];
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 on success).

int walk_emit_launch(const void* planes, const void* C, const void* creads,
                     int max_len, int64_t R, int a0, void* emits,
                     void* n_live, void* stream) {
  if (R <= 0 || max_len <= 0) return 0;
  unsigned blocks = (unsigned)((R + kThreads - 1) / kThreads);
  walk_emit_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)planes, (const int*)C, (const int8_t*)creads, max_len, R,
      a0, (int*)emits, (unsigned long long*)n_live);
  return (int)cudaGetLastError();
}

int walk_planes_build_launch(const void* rec, int64_t nblk, void* planes,
                             int64_t n_sb, void* stream) {
  if (n_sb <= 0) return 0;
  int64_t blocks = (n_sb * 8 + kThreads - 1) / kThreads;
  walk_planes_build_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint4*)rec, nblk, n_sb, (uint32_t*)planes);
  return (int)cudaGetLastError();
}

const char* walk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
