// Per-read backward walk (K2): every read of B walked through A's index,
// one emission per B position.
//
// Replaces: bwtmerge_tpu/ops/walk_jax.py:_walk_emit and _rank_known_char
// (an XLA lax.scan on the TPU, the merge's main-path hot loop).
//
// Contract.  cpl is int32[NBLK*5, 2]: row (block*5 + c-1) holds
// [occ of c before the block, 32-bit mask of the block's positions holding
// c] (bit k = position k).  C is int32[9], the cumulative character counts.
// creads is int8[max_len, R]: row t lane r is the t-th character of read r
// counted from its end, 0 past the end.  Lane r starts at a = a_sequences;
// at row t with c = creads[t, r] in 1..5 it steps
//   a = C[c] + occ + popcount(mask & ((1 << (a & 31)) - 1))
// and emits a; otherwise it emits 2^31-1 and keeps a.  emits is
// int32[max_len * R] (row t at offset t*R); n_live (uint64, zeroed by the
// caller) receives the number of live emissions.
//
// What bounds it on this card.  Each step of each lane reads one byte of
// creads, one 8-byte cplane row at a data-dependent address, and writes 4
// bytes: the dependent random 8-byte load (one 32-byte sector per lane)
// bounds it, as latency at low occupancy and as sector bandwidth at full
// occupancy.
//
// What the design does about it.  One thread per read lane with the walk
// state in a register and the loop over rows inside the thread, so the
// sequential dependency costs no launches.  creads and emits rows are
// lane-contiguous, so those accesses coalesce across a warp; only the
// cplane row load is random, and it is a single 8-byte load.  C lives in
// shared memory.  n_live is a warp-shuffle and block reduction followed by
// one atomicAdd per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNC = 5;  // walked characters 1..5
constexpr int kSent = 0x7FFFFFFF;

__global__ void __launch_bounds__(kThreads)
walk_emit_kernel(const int2* __restrict__ cpl, const int* __restrict__ C,
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
    for (int t = 0; t < max_len; ++t) {
      int c = creads[(int64_t)t * R + r];
      int e = kSent;
      if (c >= 1 && c <= kNC) {
        int2 row = __ldg(cpl + (int64_t)(a >> 5) * kNC + (c - 1));
        uint32_t low = (uint32_t)((1ull << (a & 31)) - 1ull);
        a = sC[c] + row.x + __popc((uint32_t)row.y & low);
        e = a;
        ++live;
      }
      emits[(int64_t)t * R + r] = e;
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

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int walk_emit_launch(const void* cpl, const void* C, const void* creads,
                     int max_len, int64_t R, int a0, void* emits,
                     void* n_live, void* stream) {
  if (R <= 0 || max_len <= 0) return 0;
  int64_t blocks = (R + kThreads - 1) / kThreads;
  walk_emit_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int2*)cpl, (const int*)C, (const int8_t*)creads, max_len, R, a0,
      (int*)emits, (unsigned long long*)n_live);
  return (int)cudaGetLastError();
}

const char* walk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
