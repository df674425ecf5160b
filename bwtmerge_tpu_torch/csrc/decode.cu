// Device read decode (K3) and the build of its table: B's reads
// recovered from its own BWT by an LF chase from each endmarker row, in the
// walk's end-aligned layout.
//
// Replaces: bwtmerge_tpu/ops/walk_jax.py:decode_creads_device and
// _decode_step (an XLA while_loop on the TPU; the k-way fold runs it once
// per piece after the first).
//
// The table ("decode rows").  rows is int32[NBLK, 8]: one aligned 32-byte
// sector per 32-position block, [occ of c = 1..5 before the block: 5 words |
// 3 bit-planes of the block's 32 symbols: 3 words]; bit j of plane k is bit
// k of the symbol at position j (symbols 0..6 take three bits).
// decode_rows_build fills it from the record table int32[NBLK, 16] (words
// 0..7 occ before the block, words 8..15 the block's 32 symbols, 4 per
// word, LSB first).
//
// The decode's contract.  C is int32[9], the cumulative character counts
// (C[1] = number of reads).  Lane r (0 <= r < n_lanes) starts at
// p = lane0 + r, alive iff p < C[1].  At row t, while the lane is alive and
// t < cap, it reads sym = BWT[p]; it writes sym to creads[t * ld + r], dies
// at sym == 0, and otherwise steps
//   p = C[sym] + occ[sym] + #{positions of p's block before p holding sym}.
// creads is int8 and zero-filled by the caller, so the rows past a lane's
// death read 0.  n_alive (uint64, zeroed by the caller) receives the number
// of lanes still alive after row cap - 1: reads longer than the cap.  The
// pad symbol 6 never lies below the BWT's size; a lane that met a symbol
// above 5 stops, so no address leaves the table.
//
// What bounds it on this card.  Each step of each lane is one dependent
// load at a random address, and the memory system moves whole 32-byte
// sectors: the decode runs at the rate of its sector traffic through the
// L2 and, in the last rows, at the latency of its longest chains.
//
// What the design does about it.  A step reads exactly one sector, of a
// table of one byte per position (the record table has two sectors per
// block), which fits the 50 MB L2 for a piece of some 40 M positions; the
// creads stores carry streaming hints so they do not evict it.  The symbol
// at p is three bit tests; the positions holding it are the AND of the
// three planes, each complemented where the symbol's bit is clear; the
// prefix is one popcount.  The bit of p's offset is formed in 64 bits: the
// only data-dependent shift, by at most 31.  One thread per read lane with
// p in a register and the loop over rows inside the thread, so the
// sequential dependency costs no launches; creads rows are lane-contiguous,
// so the stores of a warp coalesce.  n_alive is a warp-shuffle and block
// reduction followed by one atomicAdd per block.
//
// The table's build.  It reads each 64-byte record once and writes each
// 32-byte row once: 96 B a block, bound by the card's memory rate.  One
// thread a block, 256 threads a thread block; each load of a warp reads
// 32 neighbouring records and each store writes 32 neighbouring rows.  The
// three planes come by SWAR, three calls of symbol_plane (symbol_plane.cuh,
// shared with walk.cu's builder; symbols are 0..6, so the fourth plane is
// not needed): 67 SASS instructions a block and 24 registers, where the
// first version's 96 single-bit steps took 222 and 30.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W, both run at their bytes' rate: 87-94% of
// the bound in device time, the same within 0-3% at 13.5 M, 51 M and
// 2^31 - 2 positions.  Two things tried and measured slower there: 4 blocks
// a thread (consecutive: 1.7-1.9 times the time; 256 apart: 3-12% more),
// and a grid of the card's resident thread blocks striding over the table
// (6% faster at 13.5 M positions, 9% slower at 2^31 - 2).  Rows keep plain
// 16-byte stores: K3 reads them next, and at a piece's size they fit the
// 50 MB L2.  Masks come from constant shifts only.

#include <cuda_runtime.h>
#include <stdint.h>

#include "symbol_plane.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint4* __restrict__ rows, const int* __restrict__ C,
              int64_t lane0, int64_t n_lanes, int cap, int64_t ld,
              int8_t* __restrict__ creads,
              unsigned long long* __restrict__ n_alive) {
  __shared__ int sC[6];
  __shared__ unsigned warp_alive[kThreads / 32];
  if (threadIdx.x < 6) sC[threadIdx.x] = C[threadIdx.x];
  __syncthreads();

  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned alive = 0;
  if (r < n_lanes) {
    int64_t p = lane0 + r;
    bool live = p < (int64_t)sC[1];
    for (int t = 0; live && t < cap; ++t) {
      const uint4* row = rows + (p >> 5) * 2;
      uint4 lo = __ldg(row), hi = __ldg(row + 1);
      uint32_t bit = (uint32_t)(1ull << (p & 31));
      bool b0 = (hi.y & bit) != 0u, b1 = (hi.z & bit) != 0u;
      bool b2 = (hi.w & bit) != 0u;
      int sym = (b0 ? 1 : 0) | (b1 ? 2 : 0) | (b2 ? 4 : 0);
      __stcs(creads + (int64_t)t * ld + r, (int8_t)sym);
      if (sym == 0 || sym > 5) {
        live = false;
        break;
      }
      uint32_t match = (b0 ? hi.y : ~hi.y) & (b1 ? hi.z : ~hi.z)
                     & (b2 ? hi.w : ~hi.w);
      uint32_t occ = sym == 1 ? lo.x : sym == 2 ? lo.y : sym == 3 ? lo.z
                   : sym == 4 ? lo.w : hi.x;
      p = (int64_t)sC[sym] + (int64_t)occ + __popc(match & (bit - 1u));
    }
    alive = live ? 1u : 0u;
  }

#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    alive += __shfl_down_sync(0xFFFFFFFFu, alive, s);
  if ((threadIdx.x & 31) == 0) warp_alive[threadIdx.x >> 5] = alive;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_alive[w];
    if (total) atomicAdd(n_alive, total);
  }
}

// The row of one block from its record r[0..3]: occ of c = 1..5 (record
// words 1..5), then bit planes 0..2 of its symbols (record words 8..15).
__device__ __forceinline__ void decode_row(const uint4 r[4], uint4* dst) {
  uint32_t q[4];
  fold_symbol_words(r[2], r[3], q);
  dst[0] = make_uint4(r[0].y, r[0].z, r[0].w, r[1].x);
  dst[1] = make_uint4(r[1].y, symbol_plane<0>(q), symbol_plane<1>(q),
                      symbol_plane<2>(q));
}

__global__ void __launch_bounds__(kThreads)
decode_rows_build_kernel(const uint4* __restrict__ rec, int64_t nblk,
                         uint4* __restrict__ rows) {
  const int64_t blk = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= nblk) return;
  const uint4* row = rec + blk * 4;
  const uint4 r[4] = {__ldg(row), __ldg(row + 1), __ldg(row + 2),
                      __ldg(row + 3)};
  decode_row(r, rows + blk * 2);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 on success).

int decode_launch(const void* rows, const void* C, int64_t lane0,
                  int64_t n_lanes, int cap, int64_t ld, void* creads,
                  void* n_alive, void* stream) {
  if (n_lanes <= 0 || cap <= 0) return 0;
  int64_t blocks = (n_lanes + kThreads - 1) / kThreads;
  decode_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)rows, (const int*)C, lane0, n_lanes, cap, ld,
      (int8_t*)creads, (unsigned long long*)n_alive);
  return (int)cudaGetLastError();
}

int decode_rows_build_launch(const void* rec, int64_t nblk, void* rows,
                             void* stream) {
  if (nblk <= 0) return 0;
  int64_t blocks = (nblk + kThreads - 1) / kThreads;
  decode_rows_build_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint4*)rec, nblk, (uint4*)rows);
  return (int)cudaGetLastError();
}

const char* decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
