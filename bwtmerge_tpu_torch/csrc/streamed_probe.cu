// Streamed-rank probe (K1): all 8 ranks and the symbol at q, for a batch of
// sorted positions q, over the block-fused record table.
//
// Replaces: bwtmerge_tpu/ops/rank_pallas.py:_kernel (launched by
// _streamed_ranks_padded through pl.pallas_call).  Only the contract is
// ported; the TPU's tile streaming and bf16 one-hot matmuls are not.
//
// Contract.  rec is int32[NBLK, 16]: words 0-7 hold the exclusive occ count
// of each character before the block, words 8-15 the block's 32 symbols,
// 4 per word, LSB first (word w holds positions 4w..4w+3).  q is int32[Q];
// out is int32[16, Q] row-major.  For 0 <= q <= size: rows 0-7 are
// rank(q, c) for c = 0..7, row 8 is the symbol at q (the pad value SIGMA
// when q == size), rows 9-15 are zero.  For any other q (the 2^31-1
// sentinel of a sorted batch) all 16 rows are zero and the table is never
// indexed.
//
// What bounds it on this card.  Each query reads one 64-byte record and
// writes 64 bytes of output: 128 bytes of device memory traffic and about
// 300 integer operations, so it is bound by memory, and by the latency of
// the record load when neighbouring queries fall in different records.
//
// What the design does about it.  One thread per query; the record is four
// 16-byte loads.  Because the batch is sorted, neighbouring threads of a
// warp read the same or neighbouring records, so the loads coalesce: that
// is the GPU's counterpart of the TPU's table streaming, and why the
// contract asks for sorted queries.  The per-character prefix count is a
// SWAR zero-byte test and a popcount per packed word, all in registers.
// The output is row-major so consecutive threads store to consecutive
// addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOutRows = 16;
constexpr int kLanes = 8;
constexpr int kThreads = 256;

// 0x80 in every byte of x that is zero, 0 elsewhere.
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  uint32_t t = ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x;
  return ~t & 0x80808080u;
}

__global__ void __launch_bounds__(kThreads)
streamed_probe_kernel(const int4* __restrict__ rec, const int* __restrict__ q,
                      int64_t n, int size, int* __restrict__ out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int qi = q[i];
  int res[kLanes + 1];
#pragma unroll
  for (int k = 0; k <= kLanes; ++k) res[k] = 0;

  if (qi >= 0 && qi <= size) {
    const int4* r = rec + (int64_t)(qi >> 5) * 4;
    int4 o0 = __ldg(r), o1 = __ldg(r + 1), w0 = __ldg(r + 2), w1 = __ldg(r + 3);
    int occ[kLanes] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
    uint32_t words[8] = {(uint32_t)w0.x, (uint32_t)w0.y, (uint32_t)w0.z,
                         (uint32_t)w0.w, (uint32_t)w1.x, (uint32_t)w1.y,
                         (uint32_t)w1.z, (uint32_t)w1.w};
    int off = qi & 31;
    // 0x80 in the bytes of positions < off, and the symbol at off; built
    // from compares and constant shifts only (no data-dependent shift)
    uint32_t before[8];
    int sym = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      uint32_t m = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (4 * w + b < off) m |= 0x80u << (8 * b);
        if (4 * w + b == off) sym = (words[w] >> (8 * b)) & 0xFF;
      }
      before[w] = m;
    }
#pragma unroll
    for (int c = 0; c < kLanes; ++c) {
      uint32_t pat = 0x01010101u * (uint32_t)c;
      int cnt = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w)
        cnt += __popc(zero_bytes(words[w] ^ pat) & before[w]);
      res[c] = occ[c] + cnt;
    }
    res[kLanes] = sym;
  }
#pragma unroll
  for (int k = 0; k <= kLanes; ++k) out[k * n + i] = res[k];
#pragma unroll
  for (int k = kLanes + 1; k < kOutRows; ++k) out[k * n + i] = 0;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int streamed_probe_launch(const void* rec, const void* q, int64_t n, int size,
                          void* out, void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  streamed_probe_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int4*)rec, (const int*)q, n, size, (int*)out);
  return (int)cudaGetLastError();
}

const char* streamed_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
