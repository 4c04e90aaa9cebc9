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
// operations per key.  radix_hist writes (n / blk) x parts floats, so it
// moves n * 4 + nb * parts * 4 bytes: at SF 10's 60 M rows, parts 8 and
// blk 2048, 0.072 ms at 3.35 TB/s; counting_rank writes a 4-byte slot per
// row, 8 bytes a row.  At 15 M rows (one rank's SF 10 lineitem share at
// N = 4) the rank is 0.036 ms at 3.35 TB/s; at 1.5 M rows (SF 1) a launch
// costs more than the bytes.
//
// Design of the histogram (hist_kernel; ops.hist_plan picks the load width,
// the grid and the shared memory).  What kept the first port at 42 % of its
// bound was a chain per row: one 4-byte load, then a __match_any_sync, then a
// shared atomic by the peer group's leader, before the next load went out,
// so too few bytes were in flight; and __match_any_sync costs more as a warp
// holds more distinct bins.  Now:
//  * a persistent grid (8 blocks an SM, 32 registers a thread) walks
//    histogram blocks in chunks of 2048 rows; each thread reads its 8 keys
//    of a chunk as two 16-byte loads (lane by lane where the keys are not
//    16-byte aligned or blk % 4 != 0) and issues the next chunk's loads
//    before it counts the current one;
//  * a bin is the (murmur32-hashed) key masked where parts is a power of
//    two, else reduced by a multiply-high modulo (FastMod) in place of `%`
//    by a run-time divisor;
//  * each row is one native 32-bit atomicAdd into the block's one copy of
//    the histogram in shared memory (parts ints, up to 12288), written out
//    and reset once per histogram block.
// Measured against two other designs at every width from 8 to 4096 bins
// (PERF.md, PR 17): ballots of the bin's bits with a bin a lane (parts <=
// 32; 1.5x slower: the ballots cost more instructions than one atomic),
// and a copy per warp (a little slower to 129 bins, 2x at 4096, where
// shared memory holds fewer blocks).  A hot bin costs what a uniform spread
// does.
//
// Design of the rank.  Hopper blocks run in no order, so nothing carries
// across them.  The counting rank has two designs (ops.rank_design picks by
// width, the caller's parts + 1):
//  * single pass (width <= 32, the shuffle's N + 2 bins): decoupled
//    look-back, the scheme of CUB's onesweep radix sort; one memset of the
//    look-back words and one launch, keys read once (8 bytes a row).
//     - Tiles of 4096 rows go out by an atomic ticket, not by blockIdx, so
//       a block only ever waits on tiles that running blocks hold: no
//       deadlock on a tile that is not resident.
//     - Warp w of a tile takes 512 contiguous rows in 16 steps of 32, all 16
//       loads issued before any is used (4 bytes a lane, 128 contiguous
//       bytes a warp: a lane a row keeps the ballots in row order, and 16
//       loads in flight a thread cover the latency of device memory).  ceil(log2(width)) ballots of the
//       bin's bits give each lane the mask of its own bin's rows in the step
//       (its rank: popc below it) and lane k the mask of bin k's rows, so
//       lane k keeps bin k's running count in a register; a row's rank in
//       its warp is that count, shuffled from lane bin, plus its rank in the
//       step.  (bin, rank) waits in shared memory as 16 bits until the
//       tile's prefix is known.
//     - Warp 0 scans the warps' counts per bin and publishes the tile's
//       count of bin k as one 64-bit word (status << 32 | count).  One warp
//       per bin then looks back over the earlier tiles' words, stored bin by
//       bin, 32 tiles a step (lane j reads tile p - j; the window's counts
//       up to its nearest inclusive prefix are one warp reduction), and
//       publishes the tile's inclusive prefix.  Count and status share the
//       word, so relaxed loads and stores see a consistent pair, and no
//       fence sits on the chain.
//     - The chain of prefixes, ~32 tiles a round trip to L2, is what limits
//       a wave of tiles, so the grid is persistent (4 blocks an SM) and each
//       block keeps two tiles in flight: it ranks and publishes tile t, then
//       resolves and writes the tile it took before, whose look-back has
//       had the whole of t's loads to settle.
//     - slot = tile prefix + earlier warps' count + rank in the warp, written
//       once; the last tile writes the totals.
//  * three passes (wider): per-tile histograms, a scan per bin, then ranks.
//    1. hist_kernel: the histogram of each tile of `tile` rows (radix_hist,
//       unhashed, with int32 counts).
//    2. scan_kernel: per key, an exclusive prefix sum of the tile counts in
//       tile order (one block per key, warp-shuffle scans), in place; the
//       key's total lands in `totals`.
//    3. rank_kernel: each block walks its tile in chunks of kThreads rows.  A
//       row's slot is the running count of its key before the chunk, plus the
//       counts of its key in the chunk's earlier warps (per-warp counters in
//       shared memory), plus its rank in its warp (__popc of the peers mask
//       below its lane).
// Every term is a count, so both designs are exact and deterministic, with no
// atomics on the rank itself.  A key k falls in bin (uint32)k % width
// everywhere, as in the Pallas binning and in the plain version, so even a
// key outside [0, parts) gives the same slot in the kernel and the plain
// version.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr unsigned kNoBin = 0xFFFFFFFFu;   // a row past the end: its own group
constexpr int kOnePassItems = 16;                        // rows a thread ranks
constexpr int kOnePassTile = kThreads * kOnePassItems;   // 4096 rows a tile
constexpr int kWarpRows = 32 * kOnePassItems;            // 512 rows a warp
constexpr int kRankBits = 9;                             // rank in a warp < 512
constexpr int kOnePassWidthMax = 32;                     // one bin a lane
constexpr int kOnePassBlocks = 132 * 4;                  // 4 blocks an H100 SM
constexpr unsigned long long kAggregate = 1ull << 32;    // status of a word
constexpr unsigned long long kPrefix = 2ull << 32;
constexpr int kHistLoads = 2;                            // 16-byte loads a thread a chunk
constexpr int kHistKeys = 4 * kHistLoads;                // keys a thread a chunk
constexpr int kHistChunk = kThreads * kHistKeys;         // 2048 rows a chunk

__device__ __forceinline__ unsigned bin_of(int32_t key, unsigned width,
                                           bool hashed) {
  const uint32_t u = static_cast<uint32_t>(key);
  return (hashed ? murmur32(u) : u) % width;
}

// x % d for any 32-bit x, by a multiply-high and shifts (Granlund and
// Montgomery 1994, fig. 4.1): ~6 instructions, where `%` by a divisor known
// only at run time takes ~20.
struct FastMod {
  unsigned d, m;
  int s1, s2;
};

static FastMod make_fastmod(unsigned d) {
  int l = 0;                                  // ceil(log2 d)
  while ((1ull << l) < d) ++l;
  FastMod f;
  f.d = d;
  f.m = static_cast<unsigned>(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  f.s1 = l < 1 ? l : 1;
  f.s2 = l > 1 ? l - 1 : 0;
  return f;
}

__device__ __forceinline__ unsigned mod_of(unsigned x, const FastMod& f) {
  const unsigned t = __umulhi(f.m, x);
  return x - ((t + ((x - t) >> f.s1)) >> f.s2) * f.d;
}

// Keys of this thread's rows of the chunk at row0: rows
// row0 + 4 * (u * kThreads + threadIdx.x) + e, e < 4, one 16-byte load per u
// where `vec` (keys 16-byte aligned, row0 % 4 == 0) and all four rows are
// before `end`, else lane by lane.  A row at or past `end` reads as 0.
__device__ __forceinline__ void load_keys(const int32_t* __restrict__ keys,
                                          long long row0, long long end,
                                          bool vec, unsigned (&k)[kHistKeys]) {
#pragma unroll
  for (int u = 0; u < kHistLoads; ++u) {
    const long long r = row0 + 4ll * (u * kThreads + threadIdx.x);
    if (vec && r + 4 <= end) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(keys + r));
      k[4 * u] = v.x;
      k[4 * u + 1] = v.y;
      k[4 * u + 2] = v.z;
      k[4 * u + 3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) k[4 * u + e] = r + e < end ? __ldcs(keys + r + e) : 0;
    }
  }
}

// Count one chunk's keys of this thread into the block's histogram `hist`.
// Key s counts when WHOLE (every row of the chunk is before the end) or its
// row offset is below `lim`.  POW2: parts is a power of two, and the bin is
// a mask of the (hashed) key.
template <bool HASHED, bool WHOLE, bool POW2>
__device__ __forceinline__ void bin_chunk(const unsigned (&k)[kHistKeys], long long lim,
                                          const FastMod& mod, int* hist) {
#pragma unroll
  for (int s = 0; s < kHistKeys; ++s) {
    const unsigned h = HASHED ? murmur32(k[s]) : k[s];
    const unsigned bin = POW2 ? h & (mod.d - 1) : mod_of(h, mod);
    if (WHOLE || (s / 4) * 4 * kThreads + s % 4 < lim) atomicAdd(hist + bin, 1);
  }
}

// Per-block histograms of rows [b * blk, min(n, (b + 1) * blk)), written as
// out[b * parts + p], on a persistent grid: block i takes histogram blocks
// i, i + gridDim.x, ... in chunks of kHistChunk rows, and loads its next
// chunk into registers before it counts the current one, each row with one
// native 32-bit atomicAdd into the block's copy of the histogram in shared
// memory.  Rows past n are never read (the reference pads with the first
// key and subtracts the pad, which leaves the same counts).
template <typename Out, bool POW2>
__global__ void __launch_bounds__(kThreads, 8)
hist_kernel(const int32_t* __restrict__ keys, long long n, long long blk,
            int parts, bool hashed, bool vec, FastMod mod,
            Out* __restrict__ out) {
  extern __shared__ int hist[];            // (parts,) counts of block b
  const long long nb = (n + blk - 1) / blk;
  const long long chunks = (blk + kHistChunk - 1) / kHistChunk;   // a block's
  for (int p = threadIdx.x; p < parts; p += kThreads) hist[p] = 0;
  __syncthreads();
  long long b = blockIdx.x, c = 0;
  if (b >= nb) return;
  long long row0 = b * blk;
  long long end = min(n, min((b + 1) * blk, row0 + kHistChunk));
  unsigned cur[kHistKeys], nxt[kHistKeys];
  load_keys(keys, row0, end, vec, cur);
  for (;;) {
    long long b2 = b, c2 = c + 1;
    if (c2 == chunks) {
      c2 = 0;
      b2 = b + gridDim.x;
    }
    const bool more = b2 < nb;
    const long long row2 = b2 * blk + c2 * kHistChunk;
    const long long end2 = min(n, min((b2 + 1) * blk, row2 + kHistChunk));
    if (more) load_keys(keys, row2, end2, vec, nxt);    // in flight while counting
    // rows of this thread's keys before `end`: key s is row
    // row0 + 4 * threadIdx.x + (s / 4) * 4 * kThreads + s % 4
    const long long lim = end - row0 - 4ll * threadIdx.x;
    if (end - row0 == kHistChunk) {
      if (hashed) bin_chunk<true, true, POW2>(cur, lim, mod, hist);
      else bin_chunk<false, true, POW2>(cur, lim, mod, hist);
    } else {
      if (hashed) bin_chunk<true, false, POW2>(cur, lim, mod, hist);
      else bin_chunk<false, false, POW2>(cur, lim, mod, hist);
    }
    if (c == chunks - 1) {     // block b's last chunk: write its row, reset
      __syncthreads();
      Out* row = out + b * parts;
      for (int p = threadIdx.x; p < parts; p += kThreads) {
        row[p] = static_cast<Out>(hist[p]);
        hist[p] = 0;
      }
      __syncthreads();
    }
    if (!more) break;
    b = b2;
    c = c2;
    row0 = row2;
    end = end2;
#pragma unroll
    for (int s = 0; s < kHistKeys; ++s) cur[s] = nxt[s];
  }
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

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// Per-tile state of the single-pass rank in shared memory.
struct RankTile {
  int warp_count[kWarps][32];     // per warp, per bin: count, then rows before
  int total[32];                  // per bin: rows in the tile
  unsigned short row[kOnePassTile];  // bin << kRankBits | rank in its warp
};

// Rank the rows of tile `tile` within each warp into `st`: lane k of warp w
// ends with the count of bin k in w's rows.
template <int BITS>
__device__ __forceinline__ void rank_tile(const int32_t* __restrict__ keys, long long n,
                                          unsigned width, long long tile, RankTile& st) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long base = tile * kOnePassTile + static_cast<long long>(warp) * kWarpRows + lane;
  unsigned short* rows = st.row + warp * kWarpRows + lane;
  // lane k's bits, for the mask of bin k's rows: ones ^ flip keeps the
  // lanes whose bit j equals k's
  unsigned lane_flip[BITS];
#pragma unroll
  for (int j = 0; j < BITS; ++j) lane_flip[j] = (lane >> j) & 1u ? 0u : kFullMask;
  const bool whole = (tile + 1) * kOnePassTile <= n;   // no row past the end
  unsigned key[kOnePassItems];             // every load issued before any use
#pragma unroll
  for (int s = 0; s < kOnePassItems; ++s) {
    const long long r = base + s * 32;
    key[s] = r < n ? keys[r] : 0;
  }
  int run = 0;                 // lane k: rows of bin k in this warp's earlier steps
#pragma unroll
  for (int s = 0; s < kOnePassItems; ++s) {
    const unsigned bin = key[s] < width ? key[s] : key[s] % width;
    const unsigned valid = whole ? kFullMask : __ballot_sync(kFullMask, base + s * 32 < n);
    unsigned peers = valid, mine = valid;
#pragma unroll
    for (int j = 0; j < BITS; ++j) {
      const unsigned ones = __ballot_sync(kFullMask, (bin >> j) & 1u);
      peers &= ones ^ ((bin >> j) & 1u ? 0u : kFullMask);
      mine &= ones ^ lane_flip[j];
    }
    const int rank = __shfl_sync(kFullMask, run, static_cast<int>(bin)) +
                     __popc(peers & below);
    rows[s * 32] = static_cast<unsigned short>(bin << kRankBits | rank);
    run += __popc(mine);
  }
  st.warp_count[warp][lane] = run;
}

// Warp 0, lane k: the warps' counts of bin k scanned in warp order, and the
// tile's count published at once (tile 0: as its inclusive prefix).
__device__ __forceinline__ void publish_tile(unsigned long long* flags, long long tiles,
                                             unsigned width, long long tile, RankTile& st) {
  const unsigned lane = threadIdx.x & 31u;
  int total = 0;
  for (int v = 0; v < kWarps; ++v) {
    const int c = st.warp_count[v][lane];
    st.warp_count[v][lane] = total;
    total += c;
  }
  st.total[lane] = total;
  if (lane < width)
    store_relaxed(flags + lane * tiles + tile,
                  (tile == 0 ? kPrefix : kAggregate) | static_cast<unsigned>(total));
}

// Look back, one warp per bin: lane j reads the word of tile p - j, 32
// earlier tiles a step, until the window holds an inclusive prefix; then
// publish the tile's own.  Count and status share a word, so relaxed loads
// and stores suffice; every tile in the window took its ticket earlier and
// published its count before its block waited on anything.
__device__ __forceinline__ void resolve_tile(unsigned long long* flags, long long tiles,
                                             int width, long long tile, const RankTile& st,
                                             int* prefix, int32_t* totals) {
  const unsigned lane = threadIdx.x & 31u;
  const int warp = static_cast<int>(threadIdx.x >> 5);
  for (int k = warp; k < width; k += kWarps) {
    const unsigned long long* words = flags + k * tiles;
    int before = 0;
    if (tile > 0) {
      long long p = tile - 1;
      long long start = 0;
      for (;;) {
        const long long q = p - lane;
        const unsigned long long f = q >= 0 ? load_relaxed(words + q) : kPrefix;
        const unsigned long long status = f & ~0xFFFFFFFFull;
        if (__any_sync(kFullMask, status == 0)) {
          // trap rather than hang if an earlier tile never publishes
          if (start == 0) {
            start = clock64();
          } else if (clock64() - start > 20000000000ll) {
            __trap();
          }
          continue;
        }
        const unsigned prefixes = __ballot_sync(kFullMask, status == kPrefix);
        const unsigned first = prefixes ? __ffs(prefixes) - 1 : 31u;
        before += static_cast<int>(__reduce_add_sync(
            kFullMask, lane <= first ? static_cast<unsigned>(f & 0xFFFFFFFFull) : 0u));
        if (prefixes) break;
        p -= 32;
      }
      if (lane == 0)
        store_relaxed(flags + k * tiles + tile,
                      kPrefix | static_cast<unsigned>(before + st.total[k]));
    }
    if (lane == 0) {
      prefix[k] = before;
      if (tile == tiles - 1) totals[k] = before + st.total[k];
    }
  }
}

__device__ __forceinline__ void write_tile(long long n, long long tile, const RankTile& st,
                                           const int* prefix, int32_t* __restrict__ slot) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  const long long base = tile * kOnePassTile + static_cast<long long>(warp) * kWarpRows + lane;
  const unsigned short* rows = st.row + warp * kWarpRows + lane;
#pragma unroll
  for (int s = 0; s < kOnePassItems; ++s) {
    const long long r = base + s * 32;
    if (r < n) {
      const unsigned v = rows[s * 32];
      const unsigned bin = v >> kRankBits;
      slot[r] = prefix[bin] + st.warp_count[warp][bin] +
                static_cast<int>(v & ((1u << kRankBits) - 1u));
    }
  }
}

// Single-pass counting rank on a persistent grid.  Each block takes tiles of
// kOnePassTile rows from `ticket` and keeps two in flight: it ranks and
// publishes tile t, then resolves and writes the tile it took before, whose
// look-back has had the whole of t's loads to settle.  `flags` holds (width,
// tiles) look-back words, bin-major, zero before the launch.
template <int BITS>
__global__ void __launch_bounds__(kThreads, 4)
rank_onepass_kernel(const int32_t* __restrict__ keys, long long n, int width,
                    long long tiles, unsigned long long* __restrict__ flags,
                    unsigned* __restrict__ ticket, int32_t* __restrict__ totals,
                    int32_t* __restrict__ slot) {
  __shared__ RankTile s_tile[2];
  __shared__ int s_prefix[32];
  __shared__ long long s_next;
  const unsigned w = static_cast<unsigned>(width);
  long long pending = -1;
  int cur = 0;
  for (;;) {
    if (threadIdx.x == 0) s_next = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long t = s_next;
    const bool have = t < tiles;
    if (have) {
      rank_tile<BITS>(keys, n, w, t, s_tile[cur]);
      __syncthreads();
      if (threadIdx.x < 32) publish_tile(flags, tiles, w, t, s_tile[cur]);
    }
    if (pending >= 0) {
      resolve_tile(flags, tiles, width, pending, s_tile[cur ^ 1], s_prefix, totals);
      __syncthreads();
      write_tile(n, pending, s_tile[cur ^ 1], s_prefix, slot);
    }
    __syncthreads();
    if (!have) break;
    pending = t;
    cur ^= 1;
  }
}

}  // namespace

template <typename Out>
static cudaError_t launch_hist(const int32_t* keys, long long n, long long blk,
                               int parts, bool hashed, bool vec, int grid,
                               int smem, Out* out, cudaStream_t s) {
  const bool pow2 = (parts & (parts - 1)) == 0;
  auto kernel = pow2 ? &hist_kernel<Out, true> : &hist_kernel<Out, false>;
  if (grid < 1 || smem < static_cast<long long>(parts) * sizeof(int))
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      keys, n, blk, parts, hashed, vec, make_fastmod(parts), out);
  return cudaGetLastError();
}

// keys (n,) int32 -> out (ceil(n / blk), parts) histograms, float32 (or
// int32 where `int_out`: pass 1 of the three-pass counting rank).  The
// caller's plan (radix_hist/ops.py::hist_plan) gives `vec` (16-byte loads:
// keys 16-byte aligned and blk % 4 == 0), the persistent grid and the
// dynamic shared memory of a block.
REPRO_EXPORT int radix_hist(const void* keys, long long n, long long blk,
                            int parts, int hashed, int vec, int grid, int smem,
                            int int_out, void* out, void* stream) {
  if (n == 0) return cudaSuccess;
  if (parts < 1 || blk < 1) return cudaErrorInvalidValue;
  const auto* k = static_cast<const int32_t*>(keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int_out ? launch_hist(k, n, blk, parts, hashed != 0, vec != 0, grid,
                               smem, static_cast<int32_t*>(out), s)
                 : launch_hist(k, n, blk, parts, hashed != 0, vec != 0, grid,
                               smem, static_cast<float*>(out), s);
}

// Passes 2 and 3 of the three-pass counting rank, any width: keys (n,) int32
// -> slot (n,) int32 and totals (width,) int32, where width is the caller's
// parts + 1 (the reference's reserved padding bin).  `counts` holds pass 1,
// the (ceil(n / tile), width) int32 histograms of the keys' tiles of `tile`
// rows, unhashed (radix_hist with int_out), and is scanned in place.  The
// rank pass takes (kWarps + 1) * width ints of shared memory, so
// width <= 6456; the wrapper allows parts <= 4096.
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
  scan_kernel<<<width, kThreads, 0, s>>>(static_cast<int32_t*>(counts), tiles,
                                         width, static_cast<int32_t*>(totals));
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 0) return err;
  rank_kernel<<<static_cast<unsigned>(tiles), kThreads, rank_smem, s>>>(
      static_cast<const int32_t*>(keys), n, tile, width,
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(slot));
  return cudaGetLastError();
}

// Single-pass counting rank for width <= 32: keys (n,) int32 -> slot (n,)
// int32 and totals (width,) int32.  `flags` is scratch of
// ceil(n / 4096) * width + 1 eight-byte words (the look-back words, bin
// by bin, and the tile ticket), zeroed here on the stream before the one launch.
REPRO_EXPORT int counting_rank_onepass(const void* keys, long long n, int width,
                                       void* flags, void* totals, void* slot,
                                       void* stream) {
  if (width < 1 || width > kOnePassWidthMax) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + kOnePassTile - 1) / kOnePassTile;
  if (tiles == 0) return cudaSuccess;
  auto* words = static_cast<unsigned long long*>(flags);
  cudaError_t err = cudaMemsetAsync(
      words, 0, static_cast<size_t>(tiles * width + 1) * sizeof(*words), s);
  if (err != cudaSuccess) return err;
  // bits of a bin: the ballots a step takes
  int bits = 1;
  while ((1 << bits) < width) ++bits;
  auto* ticket = reinterpret_cast<unsigned*>(words + tiles * width);
  const auto* k = static_cast<const int32_t*>(keys);
  auto* t = static_cast<int32_t*>(totals);
  auto* sl = static_cast<int32_t*>(slot);
  const unsigned grid = static_cast<unsigned>(min(tiles, static_cast<long long>(kOnePassBlocks)));
#define REPRO_RANK(B) \
  rank_onepass_kernel<B><<<grid, kThreads, 0, s>>>(k, n, width, tiles, words, ticket, t, sl)
  switch (bits) {
    case 1: REPRO_RANK(1); break;
    case 2: REPRO_RANK(2); break;
    case 3: REPRO_RANK(3); break;
    case 4: REPRO_RANK(4); break;
    default: REPRO_RANK(5); break;
  }
#undef REPRO_RANK
  return cudaGetLastError();
}
