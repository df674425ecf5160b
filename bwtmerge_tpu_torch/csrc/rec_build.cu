// The record table's build (B3): the block-fused FM-index table that every
// index of the port is read through, derived on the device from the text
// packed to 4 bits a position.
//
// Replaces: bwtmerge_tpu/ops/rank_jax.py:_build_rec_device (the one-shot
// XLA program) and, for a slab with its running occ totals, _build_rec_slab
// with _slab_counts, which build_rec_slabbed loops over to bound the
// build's memory.  Neither is a Pallas kernel on the TPU.
//
// The contract.  nibbles is uint8[>= nblk * 16], block-planar: byte k of
// block b holds position 32b+k in its low nibble and position 32b+16+k in
// its high nibble (16-byte aligned).  base is int32[8]: zero for a whole
// index, the counts before the slab for a slab.  rec is int32[nblk, 16]:
//   rec[b, c]      = base[c] + #{positions p < 32b holding c}, c = 0..7,
//   rec[b, 8 + w]  = the symbols of positions 32b+4w .. 32b+4w+3, one byte
//                    each, least significant first (w = 0..7).
// All eight lanes count, as the plain version does: lane 6 counts the pad
// symbol of the tail block and lane 7 stays 0 for a text of symbols 0..6.
// Sums wrap in 32 bits as torch's int32 cumsum does.  tiles is scratch of
// at least ceil(nblk / 256) * 8 words.
//
// What bounds it on this card.  Bytes: the nibbles read once (16 B a block)
// and the records written once (64 B a block), 2.5 B a position, over the
// 3.35 TB/s of device memory (20 us for the 26.7 M positions of a medium
// index, 76 us for the 102 M of a large one).  The counting is some ten
// integer operations a position and lane, far under the card's rate.
//
// The design.  One thread a record block and 256 blocks a tile, in three
// launches on the caller's stream:
//   1. tile counts: each thread counts its block's 32 nibbles in each lane
//      (SWAR: xor with the lane's nibble pattern, fold each nibble's bits
//      to its lowest with constant shifts, popcount the zero nibbles), and
//      the tile's counts are a warp-shuffle and shared-memory reduction;
//   2. tile scan: one block of 1024 threads scans the tile counts in place
//      into each tile's exclusive prefix plus base (each thread a run of
//      consecutive tiles, a warp-shuffle scan of the runs' sums);
//   3. write: each tile counts its blocks again, scans them across its
//      threads (warp shuffles, then the warps' totals in shared memory),
//      adds the tile's prefix, and stages its 256 records (16 KB) in shared
//      memory so that the tile writes them as one contiguous run of 16-byte
//      stores.  The packed symbol words are the nibble words masked with
//      0x0F0F0F0F, low nibbles for words 0..3 and high for words 4..7.
// The nibbles are read twice (0.5 B a position) and the tile counts are
// 32 B a tile: some 20% above the bound's bytes.  Every mask is built from
// compares and constant shifts: a data-dependent shift miscompiled under
// nvcc 12.8 for sm_90a in another kernel of this port.  The kernel
// allocates nothing; the table is the build's only large output, so the
// build's peak is the nibbles, the table and the tile counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // record blocks a tile, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;
constexpr int kScanThreads = 1024;
constexpr int kScanWarps = kScanThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The nibbles of w equal to c.  x is zero in exactly those nibbles; after
// the two folds bit 0 of each nibble is the OR of that nibble's four bits
// (the bits a fold shifts in from the nibble above never reach bit 0).
__device__ __forceinline__ uint32_t nibbles_equal(uint32_t w, uint32_t c) {
  uint32_t x = w ^ (c * 0x11111111u);
  x |= x >> 2;
  x |= x >> 1;
  return 8u - (uint32_t)__popc(x & 0x11111111u);
}

__device__ __forceinline__ void block_counts(uint4 v, uint32_t cnt[kLanes]) {
#pragma unroll
  for (int c = 0; c < kLanes; ++c)
    cnt[c] = nibbles_equal(v.x, c) + nibbles_equal(v.y, c)
           + nibbles_equal(v.z, c) + nibbles_equal(v.w, c);
}

// Inclusive scan of each lane over the 32 threads of a warp.
__device__ __forceinline__ void warp_scan(uint32_t v[kLanes], int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
#pragma unroll
    for (int c = 0; c < kLanes; ++c) {
      uint32_t up = __shfl_up_sync(kFull, v[c], s);
      if (lane >= s) v[c] += up;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rec_tile_counts_kernel(const uint4* __restrict__ nib, int64_t nblk,
                       uint32_t* __restrict__ tiles) {
  __shared__ uint32_t part[kWarps][kLanes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t blk = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  uint32_t cnt[kLanes];
  // nibble 15 matches no lane: past the table a thread counts nothing
  block_counts(blk < nblk ? __ldg(nib + blk) : make_uint4(~0u, ~0u, ~0u, ~0u),
               cnt);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int c = 0; c < kLanes; ++c) cnt[c] += __shfl_xor_sync(kFull, cnt[c], s);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kLanes; ++c) part[warp][c] = cnt[c];
  }
  __syncthreads();
  if (threadIdx.x < kLanes) {
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w][threadIdx.x];
    tiles[(int64_t)blockIdx.x * kLanes + threadIdx.x] = sum;
  }
}

__global__ void __launch_bounds__(kScanThreads)
rec_tile_scan_kernel(uint4* __restrict__ tiles, int64_t ntiles,
                     const int* __restrict__ base) {
  __shared__ uint32_t wsum[kScanWarps][kLanes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t per = (ntiles + kScanThreads - 1) / kScanThreads;
  const int64_t t0 = (int64_t)threadIdx.x * per;
  const int64_t t1 = t0 + per < ntiles ? t0 + per : ntiles;
  uint32_t sum[kLanes] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  for (int64_t t = t0; t < t1; ++t) {
    uint4 lo = tiles[2 * t], hi = tiles[2 * t + 1];
    sum[0] += lo.x; sum[1] += lo.y; sum[2] += lo.z; sum[3] += lo.w;
    sum[4] += hi.x; sum[5] += hi.y; sum[6] += hi.z; sum[7] += hi.w;
  }
  uint32_t run[kLanes];
#pragma unroll
  for (int c = 0; c < kLanes; ++c) run[c] = sum[c];
  warp_scan(run, lane);
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kLanes; ++c) wsum[warp][c] = run[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kLanes; ++c) run[c] += (uint32_t)base[c] - sum[c];
  for (int w = 0; w < warp; ++w) {
#pragma unroll
    for (int c = 0; c < kLanes; ++c) run[c] += wsum[w][c];
  }
  for (int64_t t = t0; t < t1; ++t) {
    uint4 lo = tiles[2 * t], hi = tiles[2 * t + 1];
    tiles[2 * t] = make_uint4(run[0], run[1], run[2], run[3]);
    tiles[2 * t + 1] = make_uint4(run[4], run[5], run[6], run[7]);
    run[0] += lo.x; run[1] += lo.y; run[2] += lo.z; run[3] += lo.w;
    run[4] += hi.x; run[5] += hi.y; run[6] += hi.z; run[7] += hi.w;
  }
}

__global__ void __launch_bounds__(kThreads)
rec_write_kernel(const uint4* __restrict__ nib, int64_t nblk,
                 const uint32_t* __restrict__ tile_base,
                 uint4* __restrict__ rec) {
  __shared__ uint32_t wsum[kWarps][kLanes];
  __shared__ uint4 stage[kThreads * 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = (int64_t)blockIdx.x * kThreads;
  const int64_t blk = first + threadIdx.x;
  const uint4 v = blk < nblk ? __ldg(nib + blk)
                             : make_uint4(~0u, ~0u, ~0u, ~0u);
  uint32_t cnt[kLanes], occ[kLanes];
  block_counts(v, cnt);
#pragma unroll
  for (int c = 0; c < kLanes; ++c) occ[c] = cnt[c];
  warp_scan(occ, lane);
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kLanes; ++c) wsum[warp][c] = occ[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kLanes; ++c)
    occ[c] += __ldg(tile_base + blockIdx.x * kLanes + c) - cnt[c];
  for (int w = 0; w < warp; ++w) {
#pragma unroll
    for (int c = 0; c < kLanes; ++c) occ[c] += wsum[w][c];
  }
  const uint32_t m = 0x0F0F0F0Fu;
  uint4* mine = stage + threadIdx.x * 4;
  mine[0] = make_uint4(occ[0], occ[1], occ[2], occ[3]);
  mine[1] = make_uint4(occ[4], occ[5], occ[6], occ[7]);
  mine[2] = make_uint4(v.x & m, v.y & m, v.z & m, v.w & m);
  mine[3] = make_uint4((v.x >> 4) & m, (v.y >> 4) & m, (v.z >> 4) & m,
                       (v.w >> 4) & m);
  __syncthreads();
  const int64_t left = nblk - first;
  const int n = 4 * (left < kThreads ? (int)left : kThreads);
  uint4* out = rec + first * 4;
  for (int j = threadIdx.x; j < n; j += kThreads) out[j] = stage[j];
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue when tiles holds fewer than ceil(nblk / 256) * 8
// words.
int rec_build_launch(const void* nibbles, int64_t nblk, const void* base,
                     void* tiles, int64_t tile_words, void* rec,
                     void* stream) {
  if (nblk <= 0) return 0;
  const int64_t ntiles = (nblk + kThreads - 1) / kThreads;
  if (tile_words < ntiles * kLanes) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  rec_tile_counts_kernel<<<(unsigned)ntiles, kThreads, 0, s>>>(
      (const uint4*)nibbles, nblk, (uint32_t*)tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rec_tile_scan_kernel<<<1, kScanThreads, 0, s>>>(
      (uint4*)tiles, ntiles, (const int*)base);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rec_write_kernel<<<(unsigned)ntiles, kThreads, 0, s>>>(
      (const uint4*)nibbles, nblk, (const uint32_t*)tiles, (uint4*)rec);
  return (int)cudaGetLastError();
}

const char* rec_build_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
