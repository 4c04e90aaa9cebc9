// Partition histograms and the stable counting rank of the shuffle dispatch.
//
// Replaces two kernels of repro/kernels/radix_hist/kernel.py:
//   radix_hist_pallas     per-block partition histograms, binned by
//                         murmur32(key) % parts or key % parts, accumulated as
//                         a one-hot x ones matmul on the MXU;
//   counting_rank_pallas  slot[i] = number of earlier rows with the same key
//                         (the position a stable sort would give row i inside
//                         its key group), from a strictly-lower-triangular
//                         matmul per block plus a running per-key total that
//                         a SEQUENTIAL grid carries in VMEM.
//
// Bound on an H100: bytes.  Both read int32 keys once and do a few integer
// operations per key.  radix_hist writes only (n / blk) x parts floats, so
// it is ~4 bytes a row; counting_rank writes a 4-byte slot per row, ~8 bytes
// a row (it reads the keys twice, so it moves ~12).  At SF 10's 60 M rows
// that is 0.07 and 0.14 ms at 3.35 TB/s.
//
// Design.  Hopper blocks run in no order, so nothing carries across them:
// the counting rank takes three launches instead of one sequential grid.
//   1. hist_kernel: the histogram of each tile of `tile` rows (the same
//      kernel body as radix_hist, unhashed, with int32 counts).  Lanes of a
//      warp that hold one key are found with __match_any_sync, and their
//      leader adds the group's size to a shared-memory counter: one shared
//      atomic per distinct key per warp.
//   2. scan_kernel: per key, an exclusive prefix sum of the tile counts in
//      tile order (one block per key, warp-shuffle scans), in place; the
//      key's total lands in `totals`.
//   3. rank_kernel: each block walks its tile in chunks of kThreads rows.  A
//      row's slot is the running count of its key before the chunk, plus the
//      counts of its key in the chunk's earlier warps (per-warp counters in
//      shared memory), plus its rank in its warp (__popc of the peers mask
//      below its lane).  Every term is a count, so the result is exact and
//      deterministic, with no atomics on the rank itself.
// A key k falls in bin (uint32)k % width everywhere, as in the Pallas
// binning and in the plain version, so even a key outside [0, parts) gives
// the same slot in the kernel and the plain version.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr unsigned kNoBin = 0xFFFFFFFFu;   // a row past the end: its own group

__device__ __forceinline__ unsigned bin_of(int32_t key, unsigned width,
                                           bool hashed) {
  const uint32_t u = static_cast<uint32_t>(key);
  return (hashed ? murmur32(u) : u) % width;
}

// Histogram of rows [b * blk, min(n, (b + 1) * blk)) for block b, written
// as out[b * width + p].  Rows past n are never read: the reference pads
// with the first key and subtracts the pad, which leaves the same counts.
template <typename Out>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const int32_t* __restrict__ keys, long long n, long long blk,
            int width, bool hashed, Out* __restrict__ out) {
  extern __shared__ int cnt[];
  for (int p = threadIdx.x; p < width; p += kThreads) cnt[p] = 0;
  __syncthreads();
  const long long start = static_cast<long long>(blockIdx.x) * blk;
  const long long end = min(n, start + blk);
  const unsigned lane = threadIdx.x & 31u;
  for (long long base = start; base < end; base += kThreads) {
    const long long r = base + threadIdx.x;
    const unsigned b = r < end ? bin_of(keys[r], width, hashed) : kNoBin;
    const unsigned peers = __match_any_sync(kFullMask, b);
    if (b != kNoBin && lane == static_cast<unsigned>(__ffs(peers) - 1))
      atomicAdd(&cnt[b], __popc(peers));
  }
  __syncthreads();
  Out* row = out + static_cast<long long>(blockIdx.x) * width;
  for (int p = threadIdx.x; p < width; p += kThreads)
    row[p] = static_cast<Out>(cnt[p]);
}

// Exclusive scan down column `blockIdx.x` of the (ntiles, width) counts, in
// tile order; the column's total goes to totals[blockIdx.x].
__global__ void __launch_bounds__(kThreads)
scan_kernel(int32_t* __restrict__ counts, long long ntiles, int width,
            int32_t* __restrict__ totals) {
  __shared__ int warp_sum[kWarps];
  __shared__ int carry_in;
  const int col = blockIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry_in = 0;
  __syncthreads();
  for (long long base = 0; base < ntiles; base += kThreads) {
    const long long t = base + threadIdx.x;
    const int v = t < ntiles ? counts[t * width + col] : 0;
    int incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= static_cast<unsigned>(d)) incl += up;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = carry_in;
    for (unsigned w = 0; w < warp; ++w) before += warp_sum[w];
    if (t < ntiles) counts[t * width + col] = before + incl - v;
    __syncthreads();                 // every thread has read carry_in
    if (threadIdx.x == kThreads - 1) carry_in = before + incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[col] = carry_in;
}

// slot[r] for the rows of tile blockIdx.x; `base` holds each key's count in
// the earlier tiles (scan_kernel's output).
__global__ void __launch_bounds__(kThreads)
rank_kernel(const int32_t* __restrict__ keys, long long n, long long tile_rows,
            int width, const int32_t* __restrict__ base,
            int32_t* __restrict__ slot) {
  extern __shared__ int smem[];
  int* run = smem;                   // (width,) running count per key
  int* wcnt = smem + width;          // (kWarps, width) this chunk, per warp
  const long long tile = blockIdx.x;
  for (int p = threadIdx.x; p < width; p += kThreads)
    run[p] = base[tile * width + p];
  for (int p = threadIdx.x; p < kWarps * width; p += kThreads) wcnt[p] = 0;
  __syncthreads();
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long start = tile * tile_rows;
  const long long end = min(n, start + tile_rows);
  for (long long chunk = start; chunk < end; chunk += kThreads) {
    const long long r = chunk + threadIdx.x;
    const bool valid = r < end;
    const unsigned b = valid ? bin_of(keys[r], width, false) : kNoBin;
    const unsigned peers = __match_any_sync(kFullMask, b);
    const bool leader = lane == static_cast<unsigned>(__ffs(peers) - 1);
    if (valid && leader) wcnt[warp * width + b] = __popc(peers);
    __syncthreads();
    if (valid) {
      int before = run[b];
      for (unsigned w = 0; w < warp; ++w) before += wcnt[w * width + b];
      slot[r] = before + __popc(peers & below);
    }
    __syncthreads();                 // every row of the chunk has read
    if (valid && leader) {
      atomicAdd(&run[b], __popc(peers));
      wcnt[warp * width + b] = 0;
    }
    __syncwarp();                    // this warp's reset before its next write
  }
}

}  // namespace

// keys (n,) int32 -> out (ceil(n / blk), parts) float32 histograms.
REPRO_EXPORT int radix_hist(const void* keys, long long n, long long blk,
                            int parts, int hashed, void* out, void* stream) {
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + blk - 1) / blk;
  hist_kernel<float><<<static_cast<unsigned>(blocks), kThreads,
                       parts * sizeof(int),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), n, blk, parts, hashed != 0,
      static_cast<float*>(out));
  return cudaGetLastError();
}

// keys (n,) int32 -> slot (n,) int32 and totals (width,) int32, where width
// is the caller's parts + 1 (the reference's reserved padding bin).  The
// caller picks the rows per tile, `tile`, and sizes `counts`, the
// (ceil(n / tile), width) int32 scratch.  The rank pass takes
// (kWarps + 1) * width ints of shared memory, so width <= 6456; the wrapper
// allows parts <= 4096.
REPRO_EXPORT int counting_rank(const void* keys, long long n, long long tile,
                               int width, void* counts, void* totals,
                               void* slot, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + tile - 1) / tile;
  const size_t rank_smem = static_cast<size_t>(kWarps + 1) * width * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(rank_smem));
  if (err != cudaSuccess) return err;
  if (tiles > 0) {
    hist_kernel<int32_t><<<static_cast<unsigned>(tiles), kThreads,
                           width * sizeof(int), s>>>(
        static_cast<const int32_t*>(keys), n, tile, width, false,
        static_cast<int32_t*>(counts));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  scan_kernel<<<width, kThreads, 0, s>>>(static_cast<int32_t*>(counts), tiles,
                                         width, static_cast<int32_t*>(totals));
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 0) return err;
  rank_kernel<<<static_cast<unsigned>(tiles), kThreads, rank_smem, s>>>(
      static_cast<const int32_t*>(keys), n, tile, width,
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(slot));
  return cudaGetLastError();
}
