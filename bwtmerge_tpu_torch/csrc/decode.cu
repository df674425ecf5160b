// Device read decode (K3): B's reads recovered from its own BWT by an LF
// chase from each endmarker row, in the walk's end-aligned layout.
//
// Replaces: bwtmerge_tpu/ops/walk_jax.py:decode_creads_device and
// _decode_step (an XLA while_loop on the TPU; the k-way fold runs it once
// per piece after the first).
//
// Contract.  rec is the index's record table int32[NBLK, 16]: words 0..7
// hold the occ counts of each character before the block, words 8..15 the
// block's 32 symbols, 4 per word, LSB first.  C is int32[9], the cumulative
// character counts (C[1] = number of reads).  Lane r (0 <= r < n_lanes)
// starts at p = lane0 + r, alive iff p < C[1].  At row t, while the lane is
// alive and t < cap, it reads sym = BWT[p]; it writes sym to
// creads[t * ld + r], dies at sym == 0, and otherwise steps
//   p = C[sym] + occ[sym] + #{positions of p's block before p holding sym}.
// creads is int8 and zero-filled by the caller, so the rows past a lane's
// death read 0.  n_alive (uint64, zeroed by the caller) receives the number
// of lanes still alive after row cap - 1: reads longer than the cap.
//
// What bounds it on this card.  Each step of each lane is one dependent
// 64-byte record load at a random address (two 32-byte sectors), a few
// dozen integer operations and one byte store: the chain of dependent
// loads, as latency at low occupancy and as sector bandwidth at full
// occupancy, the same shape as the walk (K2).
//
// What the design does about it.  One thread per read lane with p in a
// register and the loop over rows inside the thread, so the sequential
// dependency costs no launches.  The record is read as four 16-byte loads
// issued together.  The character at p and the occ of that character are
// picked by compares and selects; the in-block prefix mask is built from
// compares and constant shifts only, never a shift by a data-dependent
// amount (see ROADMAP C, P.1).  creads rows are lane-contiguous, so the
// stores of a warp coalesce.  n_alive is a warp-shuffle and block
// reduction followed by one atomicAdd per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t pick8(const uint32_t (&w)[8], int i) {
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) v = (i == k) ? w[k] : v;
  return v;
}

__device__ __forceinline__ uint32_t byte_of(uint32_t word, int k) {
  uint32_t b0 = word & 0xFFu, b1 = (word >> 8) & 0xFFu;
  uint32_t b2 = (word >> 16) & 0xFFu, b3 = word >> 24;
  return k == 0 ? b0 : k == 1 ? b1 : k == 2 ? b2 : b3;
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint4* __restrict__ rec, const int* __restrict__ C,
              int64_t lane0, int64_t n_lanes, int cap, int64_t ld,
              int8_t* __restrict__ creads,
              unsigned long long* __restrict__ n_alive) {
  __shared__ int sC[9];
  __shared__ unsigned warp_alive[kThreads / 32];
  if (threadIdx.x < 9) sC[threadIdx.x] = C[threadIdx.x];
  __syncthreads();

  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned alive = 0;
  if (r < n_lanes) {
    int64_t p = lane0 + r;
    bool live = p < (int64_t)sC[1];
    for (int t = 0; live && t < cap; ++t) {
      const uint4* row = rec + (p >> 5) * 4;
      uint4 o0 = __ldg(row), o1 = __ldg(row + 1);
      uint4 s0 = __ldg(row + 2), s1 = __ldg(row + 3);
      uint32_t w[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      uint32_t occ[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
      int off = (int)(p & 31);
      int sym = (int)byte_of(pick8(w, off >> 2), off & 3);
      creads[(int64_t)t * ld + r] = (int8_t)sym;
      if (sym == 0) {
        live = false;
        break;
      }
      uint32_t splat = (uint32_t)sym * 0x01010101u;
      int before = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        uint32_t eq = __vcmpeq4(w[k], splat);     // 0xFF per equal byte
        uint32_t mask = (off > 4 * k ? 0x000000FFu : 0u)
                      | (off > 4 * k + 1 ? 0x0000FF00u : 0u)
                      | (off > 4 * k + 2 ? 0x00FF0000u : 0u)
                      | (off > 4 * k + 3 ? 0xFF000000u : 0u);
        before += __popc(eq & mask) >> 3;
      }
      p = (int64_t)sC[sym < 8 ? sym : 8] + (int64_t)pick8(occ, sym) + before;
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

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int decode_launch(const void* rec, const void* C, int64_t lane0,
                  int64_t n_lanes, int cap, int64_t ld, void* creads,
                  void* n_alive, void* stream) {
  if (n_lanes <= 0 || cap <= 0) return 0;
  int64_t blocks = (n_lanes + kThreads - 1) / kThreads;
  decode_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)rec, (const int*)C, lane0, n_lanes, cap, ld,
      (int8_t*)creads, (unsigned long long*)n_alive);
  return (int)cudaGetLastError();
}

const char* decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
