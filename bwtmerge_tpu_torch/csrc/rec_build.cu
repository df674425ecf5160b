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
// its high nibble (16-byte aligned).  base is int32[8], the counts before
// the slab for a slab, or null for zero.  rec is int32[nblk, 16]:
//   rec[b, c]      = base[c] + #{positions p < 32b holding c}, c = 0..7,
//   rec[b, 8 + w]  = the symbols of positions 32b+4w .. 32b+4w+3, one byte
//                    each, least significant first (w = 0..7).
// All eight lanes count, as the plain version does: lane 6 counts the pad
// symbol of the tail block and lane 7 stays 0 for a text of symbols 0..6.
// Sums wrap in 32 bits as torch's int32 cumsum does.  tiles is scratch of
// at least ceil(nblk / 1024) * 16 + 2 words; the launch zeroes it.
//
// What bounds it on this card.  Bytes: the nibbles read once (16 B a block)
// and the records written once (64 B a block), 2.5 B a position, over the
// 3.35 TB/s of device memory (1.60 ms for the 2^31 - 2 positions of the
// layout's limit).  A build that reads the nibbles twice, counts each
// block twice at some seven instructions a lane and word, or scans the
// tiles' counts in one block of its own pays for that on top of the bytes.
//
// What the design does about it: one read of the nibbles, one count a
// block, one launch after the memset of its status words, about 265 SASS
// instructions a block (the static count over the 4 blocks of a thread),
// so that the instructions hide under the bytes.
//   - Counting by bit planes.  Constant shifts and three selects gather bit
//     t of the block's 32 nibbles into one word (plane t; bit 4i+j of it is
//     bit t of nibble i of word j, an order that counting does not need to
//     undo).  Lane c is an AND of the planes or their complements, two
//     shared, one own, and one popcount: 8 popcounts a block.
//   - Two lanes a register.  A tile is 1024 blocks (32 Ki positions), so
//     every count inside it fits 16 bits: lanes 2k and 2k+1 travel as one
//     word through the thread's serial scan of its 4 consecutive blocks, the
//     warp's shuffle scan (20 shuffles a thread) and the warps' totals.
//   - A single pass with a decoupled look-back (Merrill and Garland,
//     "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
//     2016).  A tile takes its index from an atomic counter, so it waits
//     only on tiles already running.  Warp 0 publishes the tile's aggregate
//     of each lane with a flag in one 64-bit word (flag and value are read
//     together, so no fence orders them), then looks back over four tiles
//     at a time, eight lanes each, summing aggregates until it meets an
//     inclusive prefix, and publishes its own inclusive prefix.  Each lane
//     is a scan of its own, so the lanes may stop at different tiles.  The
//     other warps wait at a barrier meanwhile, with the symbol halves of
//     their records already staged.
//   - Stores.  The tile stages its 1024 records (64 KB of dynamic shared
//     memory) and writes them as one contiguous run of 16-byte stores.  The
//     16-byte chunks are placed with an xor swizzle so that neither the
//     threads' writes of their own records nor the run's reads conflict in
//     the banks.
// What bounds it now, measured on an NVIDIA H100 80GB HBM3 at 700 W: the
// bytes.  1.95-1.98 ms at the limit, 81-82% of the bound and 90-91% of
// what the card's own device copy moves in that time.  At a medium index
// (835,126 blocks) the kernel takes 31 us of device time against 20 us of
// bytes: its 816 tiles fill 2.06 waves of the card's 396 tile slots.
// Every mask comes from compares, constant shifts and selects: a
// data-dependent shift miscompiled under nvcc 12.8 for sm_90a in another
// kernel of this port.  The kernel allocates nothing; the build's peak is
// the nibbles, the table and 64 B of status a tile.

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // threads a tile
constexpr int kPer = 4;                  // consecutive record blocks a thread
constexpr int kTile = kThreads * kPer;   // record blocks a tile
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;
constexpr int kPairs = kLanes / 2;       // two 16-bit lane counts a word
constexpr int kChunks = kTile * 4;       // 16-byte chunks of a tile's records
constexpr int kChunkShift = 4;           // log2 of the chunks a thread stages
constexpr int kSmem = kChunks * 16;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kAggregate = 1ull << 32;   // status flags
constexpr unsigned long long kInclusive = 2ull << 32;
constexpr int kMaxSpins = 1 << 22;       // polls of one status word
static_assert(kTile * 32 <= 0xFFFF, "a tile's counts must fit 16 bits");
static_assert(4 * kPer == 1 << kChunkShift, "the swizzle's thread index");

// Where the tile's 16-byte chunk n lies in shared memory: its three low
// bits xored with those of the staging thread, so that eight threads that
// store the same chunk of their records, and eight that read neighbouring
// chunks, hit eight different 16-byte bank columns.
__device__ __forceinline__ int swz(int n) {
  return n ^ ((n >> kChunkShift) & 7);
}

__device__ __forceinline__ uint32_t sel(uint32_t m, uint32_t a, uint32_t b) {
  return (a & m) | (b & ~m);
}

// Plane T: bit T of nibble i of word j at bit 4i + j.
template <int T>
__device__ __forceinline__ uint32_t plane(uint4 v) {
  const uint32_t x = v.x >> T;
  uint32_t y, z;
  if constexpr (T >= 1) y = v.y >> (T - 1); else y = v.y << 1;
  if constexpr (T >= 2) z = v.z >> (T - 2); else z = v.z << (2 - T);
  const uint32_t w = v.w << (3 - T);
  return sel(0x77777777u, sel(0x33333333u, sel(0x11111111u, x, y), z), w);
}

// The block's count of each lane c = 0..7, lanes 2k and 2k+1 in the low
// and high half of pk[k].  Nibbles 8..15 count in no lane.
__device__ __forceinline__ void block_counts(uint4 v, uint32_t pk[kPairs]) {
  const uint32_t p0 = plane<0>(v), p1 = plane<1>(v), p2 = plane<2>(v),
                 p3 = plane<3>(v);
  const uint32_t lo = ~p2 & ~p3, hi = p2 & ~p3;     // lanes 0..3, 4..7
  pk[0] = __popc(~p0 & ~p1 & lo) | (__popc(p0 & ~p1 & lo) << 16);
  pk[1] = __popc(~p0 & p1 & lo) | (__popc(p0 & p1 & lo) << 16);
  pk[2] = __popc(~p0 & ~p1 & hi) | (__popc(p0 & ~p1 & hi) << 16);
  pk[3] = __popc(~p0 & p1 & hi) | (__popc(p0 & p1 & hi) << 16);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Warp 0's part: lane c's aggregate of the tile published, the prefix of
// every tile before it found by the look-back, the inclusive prefix
// published.  Returns lane (lane & 7)'s exclusive prefix.
__device__ __forceinline__ uint32_t look_back(
    uint32_t (*warp_pk)[kPairs], int64_t tile, const int* base,
    unsigned long long* status, int lane) {
  const int c = lane & 7, d = lane >> 3;
  uint32_t agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t x = warp_pk[w][c >> 1];
    agg += (c & 1) ? x >> 16 : x & 0xFFFFu;
  }
  const uint32_t b = base ? (uint32_t)__ldg(base + c) : 0u;
  unsigned long long* mine = status + tile * kLanes + c;
  if (tile == 0) {
    if (d == 0) store_status(mine, kInclusive | (uint32_t)(b + agg));
    return b;
  }
  if (d == 0) store_status(mine, kAggregate | agg);
  // lane c of tile t, t = tile-1-d, tile-5-d, ...; the tile before the
  // first holds the base as its inclusive prefix
  uint32_t excl = 0;
  bool done = false;
  for (int64_t t = tile - 1 - d;; t -= 4) {
    unsigned long long s = kInclusive | b;
    if (!done && t >= 0) {
      // tile t is running and publishes its aggregate without waiting; a
      // word still zero after some seconds means the status was not
      // zeroed, and the launch fails rather than hang
      int spins = 0;
      do {
        s = load_status(status + t * kLanes + c);
        if (++spins > kMaxSpins) __trap();
      } while ((s >> 32) == 0);
    }
    const int inclusive = (s >> 32) == 2;
    int before = 0;             // an inclusive prefix at a nearer tile
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      const int up = __shfl_up_sync(kFull, inclusive, 8 * k);
      before |= d >= k ? up : 0;
    }
    uint32_t add = !done && !before ? (uint32_t)s : 0u;
    int found = inclusive;
    add += __shfl_xor_sync(kFull, add, 8);
    add += __shfl_xor_sync(kFull, add, 16);
    found |= __shfl_xor_sync(kFull, found, 8);
    found |= __shfl_xor_sync(kFull, found, 16);
    excl += add;
    done = done || found;
    if (__all_sync(kFull, done)) break;
  }
  if (d == 0) store_status(mine, kInclusive | (uint32_t)(excl + agg));
  return excl;
}

__global__ void __launch_bounds__(kThreads)
rec_build_kernel(const uint4* __restrict__ nib, int64_t nblk,
                 const int* __restrict__ base,
                 unsigned long long* __restrict__ status,
                 unsigned* __restrict__ next_tile, uint4* __restrict__ rec) {
  extern __shared__ uint4 stage[];                  // kChunks, swizzled
  __shared__ uint32_t warp_pk[kWarps][kPairs];
  __shared__ uint32_t tile_prefix[kLanes];
  __shared__ unsigned tile_index;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_index = atomicAdd(next_tile, 1u);
  __syncthreads();
  const int64_t tile = tile_index;
  const int64_t first = tile * kTile;
  const int64_t blk0 = first + (int64_t)threadIdx.x * kPer;

  // counts of the thread's blocks, scanned in the thread (pre: before each
  // block), then across the warp
  uint4 v[kPer];
  uint32_t pre[kPer][kPairs], run[kPairs] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    // nibble 15 counts in no lane: past the table a block counts nothing
    v[i] = blk0 + i < nblk ? __ldg(nib + blk0 + i)
                           : make_uint4(~0u, ~0u, ~0u, ~0u);
    uint32_t pk[kPairs];
    block_counts(v[i], pk);
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      pre[i][k] = run[k];
      run[k] += pk[k];
    }
  }
  uint32_t inc[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) inc[k] = run[k];
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const uint32_t up = __shfl_up_sync(kFull, inc[k], s);
      if (lane >= s) inc[k] += up;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < kPairs; ++k) warp_pk[warp][k] = inc[k];
  }
  // the packed symbol words: low nibbles for words 0..3, high for 4..7
  const uint32_t m = 0x0F0F0F0Fu;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int n = (threadIdx.x * kPer + i) * 4;
    stage[swz(n + 2)] = make_uint4(v[i].x & m, v[i].y & m, v[i].z & m,
                                   v[i].w & m);
    stage[swz(n + 3)] = make_uint4((v[i].x >> 4) & m, (v[i].y >> 4) & m,
                                   (v[i].z >> 4) & m, (v[i].w >> 4) & m);
  }
  __syncthreads();
  if (warp == 0) {
    const uint32_t excl = look_back(warp_pk, tile, base, status, lane);
    if (lane < kLanes) tile_prefix[lane] = excl;
  }
  __syncthreads();

  // the occ rows: tile prefix + the warps before + the threads before + the
  // blocks before, the last three still packed
  uint32_t ex[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) ex[k] = inc[k] - run[k];
  for (int w = 0; w < warp; ++w) {
#pragma unroll
    for (int k = 0; k < kPairs; ++k) ex[k] += warp_pk[w][k];
  }
  uint32_t pfx[kLanes];
#pragma unroll
  for (int c = 0; c < kLanes; ++c) pfx[c] = tile_prefix[c];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    uint32_t occ[kLanes];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const uint32_t x = ex[k] + pre[i][k];
      occ[2 * k] = pfx[2 * k] + (x & 0xFFFFu);
      occ[2 * k + 1] = pfx[2 * k + 1] + (x >> 16);
    }
    const int n = (threadIdx.x * kPer + i) * 4;
    stage[swz(n)] = make_uint4(occ[0], occ[1], occ[2], occ[3]);
    stage[swz(n + 1)] = make_uint4(occ[4], occ[5], occ[6], occ[7]);
  }
  __syncthreads();
  const int64_t left = nblk - first;
  const int n = 4 * (left < kTile ? (int)left : kTile);
  uint4* out = rec + first * 4;
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int j = threadIdx.x + i * kThreads;
    if (j < n) out[j] = stage[swz(j)];
  }
}

}  // namespace

extern "C" {

// Returns the first CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue when tiles holds fewer than
// ceil(nblk / 1024) * 16 + 2 words.
int rec_build_launch(const void* nibbles, int64_t nblk, const void* base,
                     void* tiles, int64_t tile_words, void* rec,
                     void* stream) {
  if (nblk <= 0) return 0;
  const int64_t ntiles = (nblk + kTile - 1) / kTile;
  const int64_t words = ntiles * 2 * kLanes + 2;
  if (tile_words < words) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // the dynamic shared memory limit is raised once a device (devices 0..63;
  // any other on every launch), not in the host time of every build
  static std::atomic<bool> raised[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !raised[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(
        rec_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised[dev].store(true, std::memory_order_relaxed);
  }
  // the tiles' status words and the tile counter start at zero
  err = cudaMemsetAsync(tiles, 0, (size_t)words * 4, s);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* status = (unsigned long long*)tiles;
  rec_build_kernel<<<(unsigned)ntiles, kThreads, kSmem, s>>>(
      (const uint4*)nibbles, nblk, (const int*)base, status,
      (unsigned*)(status + ntiles * kLanes), (uint4*)rec);
  return (int)cudaGetLastError();
}

const char* rec_build_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
