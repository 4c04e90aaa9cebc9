// Sortless grouped reductions: sum / count and min / max by dense group id.
//
// Replaces repro/kernels/segsum/kernel.py::segment_sum_pallas (one-hot(gid)^T
// @ values on the MXU) and ::segment_minmax_pallas (one-hot masked lane
// reduce).  The one-hot products exist only because the TPU has no atomics;
// they are not carried over.
//
// Bound on an H100: bytes.  A call reads n int32 group ids and n*C values once
// and writes G*C results, so at the main path's shapes (n = 60 M lineitem rows
// at SF 10, C = 1..5 float64) it is a pass over 0.3-2.6 GB of device memory
// at 3.35 TB/s (G 2049 x C 2 float64: 1.2 GB, 0.358 ms; a count reads only
// the ids, 0.072 ms); the arithmetic (one add or compare per value) is
// negligible.  What keeps a kernel from that bound is bytes in flight per SM
// (about 30 KB are needed to cover the latency of device memory) and, for
// float sums, the work of a fixed order.
//
// Sum and count.  ops.sum_plan fixes the geometry from the shapes alone, so
// the same shapes always reduce in the same way, whatever the card.
//  * Integers (int32 and int64 sums, int64 counts) are exact in any order, so
//    they use atomics (regime "atomic"): a persistent grid of blocks walks
//    contiguous row ranges, each lane adding its row to a copy of the tile
//    in shared memory (one copy per warp while they fit, so warps do not
//    contend).  Then one global atomic per (block, touched cell) into the
//    output, which the same C call zeroes on the stream.  Counts keep 32-bit counters (a block covers
//    < 2^31 rows); int64 sums add in two native 32-bit atomics with the low
//    word's carry (a 64-bit shared atomicAdd is a compare-and-swap loop on
//    sm_90).  A tile too large for shared memory adds straight into the
//    output.  No partial, no second pass.  (Aggregating lanes of one group
//    first with __match_any_sync costs more than it saves when a warp's ids
//    are mostly distinct: its cost grows with the distinct values.)
//  * Float sums must give the same bits on every call (later slices gate on
//    byte-identity), so there are no float atomics: the order of each cell's
//    additions is a function of the row indices, i.e. of (n, G, C, dtype).
//    A persistent grid of P blocks (P = 132 x the blocks an SM holds, a
//    constant, never read from the device) covers fixed contiguous row
//    ranges [b*chunk, (b+1)*chunk); each block reduces its range into one
//    partial, and segsum_combine adds the P partials of each cell in a fixed
//    two-level tree (kCombineRuns runs in block order, then the runs in
//    order) with one thread per (cell, run).  With P ~ 132 the partial at
//    G 2049 x C 2 float64 is 4.3 MB, not the 60 MB of one block per 32 K rows.
//     - regime "thread" (G*C <= 48: Q1's 8 groups x 5 sums, every scalar
//       aggregate): rows r0 + t + k*256 go to thread t's private slice of
//       shared memory, in row order; the block adds the slices in thread
//       order.
//     - regime "warp" (larger tiles): each warp owns a private copy of the
//       tile in shared memory; warp w takes rows r0 + (k*W + w)*32*U + u*32
//       + lane.  Lanes whose groups share one of the warp's 1024 claim words
//       take turns: each round the lowest pending lane of a word (atomicMin
//       on the lane) adds its row, so a cell's rows are added in lane order,
//       i.e. row order, and distinct words all add in the first round.  C is
//       a template parameter, and each lane loads the next U steps into
//       registers while it adds the current U (U = 16 at C <= 2, 8 above),
//       so a warp has ~10 KB in flight.  The block adds its warps' copies in
//       warp order.  Columns, then groups, are tiled so that the copies fit
//       in shared memory.
//    Where a row's values are loaded from never decides where they are added:
//    a row's slice, copy and turn come from its index alone, so values at any
//    storage offset reduce to the same bits.
//  * Ids outside [0, G) (the dead slot G, padding, garbage) are skipped: the
//    dead-slot convention of repro/kernels/segsum/ops.py.
//
// Min and max are order-free, so they use atomics: each thread folds a run of
// rows of one group in a register, then atomicMin/atomicMax into a
// shared-memory copy of the groups (global memory when G is too large), then
// one global atomic per (block, touched group).  Floats are mapped to
// integers whose signed order is the float order, so 64-bit integer atomics
// serve float64.
#include "common.cuh"

#include <climits>

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kAtomicThreads = 512;  // threads of an integer block (2 an SM)
constexpr int kPrivThreads = 256;    // threads of a "thread"-regime block
constexpr int kPrivCols = 8;         // columns of a "thread"-regime tile
constexpr int kWarpsMax = 8;         // warps (copies) of a "warp"-regime block
constexpr int kWarpCols = 4;         // columns of a "warp"-regime tile
constexpr int kCombineRuns = 8;      // first level of the combine tree
constexpr int kMinMaxThreads = 256;
constexpr size_t kMinMaxSmemMax = 96 * 1024;

enum Regime : int { kAtomic = 0, kThread = 1, kWarp = 2 };

// -- integers: atomics -------------------------------------------------------

// shared-memory accumulator: 32 bits for counts and int32 sums (which wrap
// modulo 2^32, as the int32 output does), 64 bits for int64 sums
template <typename T, bool COUNT> struct AtomicAcc { using type = unsigned long long; };
template <> struct AtomicAcc<int32_t, false> { using type = unsigned; };
template <typename T> struct AtomicAcc<T, true> { using type = unsigned; };

// steps of 32 rows a lane loads before it adds them
template <bool COUNT, int CT> struct AtomicSteps {
  static constexpr int value = COUNT ? 16 : (CT == 1 ? 8 : CT == 2 ? 4 : 2);
};

// Shared-memory adds.  A 64-bit atomicAdd on shared memory compiles to a
// compare-and-swap loop on sm_90, so it is two native 32-bit adds: the low
// word's carry out (from the value it held) goes into the high word, and
// the carries of all adders sum to the true carry.
__device__ __forceinline__ void shared_add(unsigned* p, unsigned v) { atomicAdd(p, v); }
__device__ __forceinline__ void shared_add(unsigned long long* p, unsigned long long v) {
  unsigned* w = reinterpret_cast<unsigned*>(p);
  const unsigned lo = static_cast<unsigned>(v);
  const unsigned old = atomicAdd(w, lo);
  atomicAdd(w + 1, static_cast<unsigned>(v >> 32) + (old + lo < old ? 1u : 0u));
}

__device__ __forceinline__ void global_add(long long* p, unsigned long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p), v);
}
__device__ __forceinline__ void global_add(int32_t* p, unsigned v) {
  atomicAdd(reinterpret_cast<unsigned*>(p), v);
}

// Columns [c0, c0 + CT) of the (n, ncols) values (or the row count), added
// into out (groups, ncols), which the caller zeroed.  `copies` copies of the
// (groups, CT) tile live in shared memory; 0 adds straight into `out`.
template <typename T, bool COUNT, int CT>
__global__ void __launch_bounds__(kAtomicThreads, 2)
segsum_atomic(const int32_t* __restrict__ gids, const T* __restrict__ vals,
              long long n, int ncols, int c0, int groups, long long chunk,
              int copies, T* __restrict__ out) {
  using Acc = typename AtomicAcc<T, COUNT>::type;
  constexpr int U = AtomicSteps<COUNT, CT>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* sacc = reinterpret_cast<Acc*>(smem_raw);
  const int cells = groups * CT;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < copies * cells; i += blockDim.x) sacc[i] = Acc(0);
  __syncthreads();
  Acc* mine = copies > 0 ? sacc + static_cast<size_t>(warp % copies) * cells : nullptr;
  auto add = [&](int cell, Acc x) {
    if (mine != nullptr) {
      shared_add(mine + cell, x);
    } else {
      global_add(out + static_cast<size_t>(cell / CT) * ncols + c0 + cell % CT, x);
    }
  };
  const long long r0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long r1 = min(n, r0 + chunk);
  const long long step = static_cast<long long>(nwarps) * 32 * U;
  for (long long base = r0 + static_cast<long long>(warp) * 32 * U; base < r1;
       base += step) {
    int g[U];
    Acc v[U][CT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + u * 32 + lane;
      const bool in = i < r1;
      g[u] = in ? gids[i] : -1;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        if constexpr (COUNT) {
          v[u][c] = Acc(1);
        } else {
          v[u][c] = in ? static_cast<Acc>(vals[i * ncols + c0 + c]) : Acc(0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (g[u] >= 0 && g[u] < groups) {
#pragma unroll
        for (int c = 0; c < CT; ++c) add(g[u] * CT + c, v[u][c]);
      }
    }
  }
  if (copies > 0) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      Acc s = Acc(0);
      for (int k = 0; k < copies; ++k) s += sacc[static_cast<size_t>(k) * cells + i];
      if (s != Acc(0))
        global_add(out + static_cast<size_t>(i / CT) * ncols + c0 + i % CT, s);
    }
  }
}

template <typename T, bool COUNT, int CT>
int launch_atomic(const int32_t* gids, const T* vals, long long n, int ncols,
                  int c0, int groups, int nblocks, long long chunk, int copies,
                  int smem, T* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      segsum_atomic<T, COUNT, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  segsum_atomic<T, COUNT, CT><<<nblocks, kAtomicThreads, smem, stream>>>(
      gids, vals, n, ncols, c0, groups, chunk, copies, out);
  return cudaGetLastError();
}

template <typename T>
int sum_atomic(const int32_t* gids, const T* vals, long long n, int ncols,
               int groups, int nblocks, long long chunk, int ct, int copies,
               int smem, T* out, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(groups) * ncols * sizeof(T), stream);
  if (err != cudaSuccess) return err;
  for (int c0 = 0; c0 < ncols; c0 += ct) {
    const int ctt = min(ct, ncols - c0);
    int rc;
    switch (ctt) {
      case 1: rc = launch_atomic<T, false, 1>(gids, vals, n, ncols, c0, groups, nblocks, chunk, copies, smem, out, stream); break;
      case 2: rc = launch_atomic<T, false, 2>(gids, vals, n, ncols, c0, groups, nblocks, chunk, copies, smem, out, stream); break;
      case 3: rc = launch_atomic<T, false, 3>(gids, vals, n, ncols, c0, groups, nblocks, chunk, copies, smem, out, stream); break;
      case 4: rc = launch_atomic<T, false, 4>(gids, vals, n, ncols, c0, groups, nblocks, chunk, copies, smem, out, stream); break;
      default: return cudaErrorInvalidValue;
    }
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

// -- floats: fixed order -----------------------------------------------------

// regime "thread": rows r0 + tid + k*kPrivThreads of block b go, in row
// order, to thread tid's slice of shared memory (`stride`, odd and >= the
// tile's cells, spreads the slices over the banks); the block then adds the
// slices in thread order into its partial.
template <typename T, int CT>
__global__ void __launch_bounds__(kPrivThreads)
segsum_thread(const int32_t* __restrict__ gids, const T* __restrict__ vals,
              long long n, int ncols, int c0, int groups, long long chunk,
              int stride, T* __restrict__ partial) {
  constexpr int U = 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pacc = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int cells = groups * CT;
  T* mine = pacc + tid * stride;
  for (int i = 0; i < cells; ++i) mine[i] = T(0);
  const long long r0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long r1 = min(n, r0 + chunk);
  for (long long base = r0 + tid; base < r1;
       base += static_cast<long long>(kPrivThreads) * U) {
    int cell[U];
    T v[U][CT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + static_cast<long long>(u) * kPrivThreads;
      const bool in = i < r1;
      const int g = in ? gids[i] : -1;
      cell[u] = (g >= 0 && g < groups) ? g * CT : -1;
#pragma unroll
      for (int c = 0; c < CT; ++c) v[u][c] = in ? vals[i * ncols + c0 + c] : T(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (cell[u] >= 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) mine[cell[u] + c] += v[u][c];
      }
    }
  }
  __syncthreads();
  T* dst = partial + static_cast<size_t>(blockIdx.x) * cells;
  for (int cell = tid; cell < cells; cell += kPrivThreads) {
    T s = T(0);
    for (int t = 0; t < kPrivThreads; ++t) s += pacc[t * stride + cell];
    dst[cell] = s;
  }
}

constexpr int kTagSlots = 1024;          // claim words of a warp
constexpr unsigned kNoLane = 0xFFFFFFFFu;

// The rows of one step go to the warp's copy `mine`, one row a lane (cell
// < 0: none).  Lanes whose groups share a claim word (`tag`, indexed by the
// group id modulo kTagSlots, kNoLane between steps) take turns: in each
// round the lowest pending lane of each word (atomicMin) adds its row, so
// the rows of one cell are added in lane order, i.e. row order, and lanes
// of distinct words all add in the first round.
template <typename T, int CT>
__device__ __forceinline__ void warp_add(T* mine, unsigned* tag, int cell,
                                         const T (&v)[CT], int lane) {
  bool pending = cell >= 0;
  unsigned* word = tag + ((cell / CT) & (kTagSlots - 1));
  while (__any_sync(kFullMask, pending)) {
    if (pending) atomicMin(word, static_cast<unsigned>(lane));
    __syncwarp();
    const bool won = pending && *word == static_cast<unsigned>(lane);
    __syncwarp();
    if (won) {
      *word = kNoLane;
#pragma unroll
      for (int c = 0; c < CT; ++c) mine[cell + c] += v[c];
      pending = false;
    }
    __syncwarp();
  }
}

// bytes of a block's copies, rounded up to 16; its claim words follow them
__device__ inline size_t copies_bytes(int warps, int cells, size_t item) {
  return (static_cast<size_t>(warps) * cells * item + 15) / 16 * 16;
}

template <int CT> struct WarpSteps { static constexpr int value = CT <= 2 ? 16 : 8; };

// cell of group id g in the tile [g0, g0 + gt) x CT columns, or -1
__device__ __forceinline__ int tile_cell(int g, int g0, int gt, int groups, int ct) {
  return (g >= g0 && g < g0 + gt && g < groups) ? (g - g0) * ct : -1;
}

// regime "warp": a copy of the tile per warp; each lane keeps the next U
// steps' rows in flight in registers while it adds the current U.
template <typename T, int CT>
__global__ void __launch_bounds__(kWarpsMax * 32)
segsum_warp(const int32_t* __restrict__ gids, const T* __restrict__ vals,
            long long n, int ncols, int c0, int g0, int gt, int groups,
            long long chunk, T* __restrict__ partial) {
  constexpr int U = WarpSteps<CT>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);               // nwarps * cells
  const int cells = gt * CT;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned* tags = reinterpret_cast<unsigned*>(
      smem_raw + copies_bytes(nwarps, cells, sizeof(T)));
  for (int i = threadIdx.x; i < nwarps * cells; i += blockDim.x) acc[i] = T(0);
  for (int i = threadIdx.x; i < nwarps * kTagSlots; i += blockDim.x) tags[i] = kNoLane;
  __syncthreads();
  T* mine = acc + static_cast<size_t>(warp) * cells;
  unsigned* tag = tags + warp * kTagSlots;
  const long long r0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long r1 = min(n, r0 + chunk);
  const long long step = static_cast<long long>(nwarps) * 32 * U;
  auto load = [&](long long b, int (&cl)[U], T (&vv)[U][CT]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = b + u * 32 + lane;
      const bool in = i < r1;
      cl[u] = tile_cell(in ? gids[i] : -1, g0, gt, groups, CT);
#pragma unroll
      for (int c = 0; c < CT; ++c) vv[u][c] = in ? vals[i * ncols + c0 + c] : T(0);
    }
  };
  long long base = r0 + static_cast<long long>(warp) * 32 * U;
  int cell[U];
  T v[U][CT];
  load(base, cell, v);
  for (; base < r1; base += step) {
    int next_cell[U];
    T next_v[U][CT];
    load(base + step, next_cell, next_v);
#pragma unroll
    for (int u = 0; u < U; ++u) warp_add<T, CT>(mine, tag, cell[u], v[u], lane);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cell[u] = next_cell[u];
#pragma unroll
      for (int c = 0; c < CT; ++c) v[u][c] = next_v[u][c];
    }
  }
  __syncthreads();
  T* dst = partial + static_cast<size_t>(blockIdx.x) * cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    T s = T(0);
    for (int w = 0; w < nwarps; ++w) s += acc[static_cast<size_t>(w) * cells + i];
    dst[i] = s;
  }
}

// out[g0 + g, c0 + c] for the tile's cells: the P block partials of a cell
// in a fixed tree, kCombineRuns runs of consecutive blocks (one thread each,
// block order), then the runs in order.
template <typename T>
__global__ void __launch_bounds__(32 * kCombineRuns)
segsum_combine(const T* __restrict__ partial, int nblocks, int cells, int ct,
               int g0, int c0, int ncols, T* __restrict__ out) {
  __shared__ T run_sum[kCombineRuns][32];
  const int x = threadIdx.x & 31;
  const int y = threadIdx.x >> 5;
  const int cell = blockIdx.x * 32 + x;
  const int len = (nblocks + kCombineRuns - 1) / kCombineRuns;
  T s = T(0);
  if (cell < cells) {
    const int b1 = min(nblocks, (y + 1) * len);
    for (int b = y * len; b < b1; ++b) s += partial[static_cast<size_t>(b) * cells + cell];
  }
  run_sum[y][x] = s;
  __syncthreads();
  if (y == 0 && cell < cells) {
    T t = run_sum[0][x];
    for (int r = 1; r < kCombineRuns; ++r) t += run_sum[r][x];
    const int g = cell / ct;
    out[static_cast<size_t>(g0 + g) * ncols + c0 + cell - g * ct] = t;
  }
}

template <typename T, int CT>
int launch_float_tile(int regime, const int32_t* gids, const T* vals, long long n,
                      int ncols, int c0, int g0, int gt, int groups, int nblocks,
                      long long chunk, int warps, int smem, T* partial, T* out,
                      cudaStream_t stream) {
  const int cells = gt * CT;
  cudaError_t err;
  if (regime == kThread) {
    if (g0 != 0 || gt != groups) return cudaErrorInvalidValue;
    const int stride = cells | 1;
    err = cudaFuncSetAttribute(segsum_thread<T, CT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    segsum_thread<T, CT><<<nblocks, kPrivThreads, smem, stream>>>(
        gids, vals, n, ncols, c0, groups, chunk, stride, partial);
  } else if constexpr (CT <= kWarpCols) {
    if (regime != kWarp || warps < 1 || warps > kWarpsMax) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(segsum_warp<T, CT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    segsum_warp<T, CT><<<nblocks, warps * 32, smem, stream>>>(
        gids, vals, n, ncols, c0, g0, gt, groups, chunk, partial);
  } else {
    return cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segsum_combine<T><<<(cells + 31) / 32, 32 * kCombineRuns, 0, stream>>>(
      partial, nblocks, cells, CT, g0, c0, ncols, out);
  return cudaGetLastError();
}

template <typename T>
int sum_float(int regime, const int32_t* gids, const T* vals, long long n,
              int ncols, int groups, int nblocks, long long chunk, int gt,
              int ct, int warps, int smem, T* partial, T* out,
              cudaStream_t stream) {
  if (ct < 1 || ct > kPrivCols || gt < 1) return cudaErrorInvalidValue;
  for (int g0 = 0; g0 < groups; g0 += gt) {
    const int gtt = min(gt, groups - g0);
    for (int c0 = 0; c0 < ncols; c0 += ct) {
      const int ctt = min(ct, ncols - c0);
      int rc;
#define REPRO_TILE(K)                                                            \
  launch_float_tile<T, K>(regime, gids, vals, n, ncols, c0, g0, gtt, groups,      \
                          nblocks, chunk, warps, smem, partial, out, stream)
      switch (ctt) {
        case 1: rc = REPRO_TILE(1); break;
        case 2: rc = REPRO_TILE(2); break;
        case 3: rc = REPRO_TILE(3); break;
        case 4: rc = REPRO_TILE(4); break;
        case 5: rc = REPRO_TILE(5); break;
        case 6: rc = REPRO_TILE(6); break;
        case 7: rc = REPRO_TILE(7); break;
        case 8: rc = REPRO_TILE(8); break;
        default: return cudaErrorInvalidValue;
      }
#undef REPRO_TILE
      if (rc != cudaSuccess) return rc;
    }
  }
  return cudaSuccess;
}

// -- min / max ---------------------------------------------------------------

// Order-preserving map of a value to an integer key (identity for integers;
// for floats the IEEE bits with the magnitude bits flipped when negative).
template <typename T> struct Key;
template <> struct Key<int32_t> {
  using K = int;
  __device__ static K enc(int32_t v) { return v; }
  __device__ static int32_t dec(K k) { return k; }
  __device__ static K lowest() { return INT_MIN; }
  __device__ static K highest() { return INT_MAX; }
};
template <> struct Key<long long> {
  using K = long long;
  __device__ static K enc(long long v) { return v; }
  __device__ static long long dec(K k) { return k; }
  __device__ static K lowest() { return LLONG_MIN; }
  __device__ static K highest() { return LLONG_MAX; }
};
template <> struct Key<float> {
  using K = int;
  __device__ static K enc(float v) {
    const int b = __float_as_int(v);
    return b ^ ((b >> 31) & 0x7FFFFFFF);
  }
  __device__ static float dec(K k) { return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF)); }
  __device__ static K lowest() { return enc(-__int_as_float(0x7F800000)); }
  __device__ static K highest() { return enc(__int_as_float(0x7F800000)); }
};
template <> struct Key<double> {
  using K = long long;
  __device__ static K enc(double v) {
    const long long b = __double_as_longlong(v);
    return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFFll);
  }
  __device__ static double dec(K k) {
    return __longlong_as_double(k ^ ((k >> 63) & 0x7FFFFFFFFFFFFFFFll));
  }
  __device__ static K lowest() { return enc(-__longlong_as_double(0x7FF0000000000000ll)); }
  __device__ static K highest() { return enc(__longlong_as_double(0x7FF0000000000000ll)); }
};

// identity of the reduction: +inf / dtype max for min, -inf / dtype min for max
template <typename T, bool IS_MIN>
__device__ __forceinline__ typename Key<T>::K ident() {
  return IS_MIN ? Key<T>::highest() : Key<T>::lowest();
}

template <bool IS_MIN, typename K>
__device__ __forceinline__ void atomic_fold(K* addr, K v) {
  if (IS_MIN) atomicMin(addr, v); else atomicMax(addr, v);
}

template <typename T, bool IS_MIN>
__global__ void segminmax_init(int groups, typename Key<T>::K* okey) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < groups) okey[i] = ident<T, IS_MIN>();
}

template <typename T, bool IS_MIN>
__global__ void __launch_bounds__(kMinMaxThreads)
segminmax_fold(const int32_t* __restrict__ gids, const T* __restrict__ vals,
               long long n, int ncols, int col, int groups, int use_smem,
               typename Key<T>::K* __restrict__ okey) {
  using K = typename Key<T>::K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* sacc = reinterpret_cast<K*>(smem_raw);
  const K id = ident<T, IS_MIN>();
  if (use_smem) {
    for (int i = threadIdx.x; i < groups; i += blockDim.x) sacc[i] = id;
    __syncthreads();
  }
  K* target = use_smem ? sacc : okey;
  int cur_g = -1;
  K cur = id;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int g = gids[i];
    if (g < 0 || g >= groups) continue;
    const K k = Key<T>::enc(vals[i * ncols + col]);
    if (g == cur_g) {
      cur = IS_MIN ? min(cur, k) : max(cur, k);
    } else {
      if (cur_g >= 0) atomic_fold<IS_MIN>(&target[cur_g], cur);
      cur_g = g;
      cur = k;
    }
  }
  if (cur_g >= 0) atomic_fold<IS_MIN>(&target[cur_g], cur);
  if (use_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < groups; i += blockDim.x)
      if (sacc[i] != id) atomic_fold<IS_MIN>(&okey[i], sacc[i]);
  }
}

template <typename T>
__global__ void segminmax_decode(const typename Key<T>::K* __restrict__ okey,
                                 int groups, int ncols, int col, T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < groups) out[static_cast<size_t>(i) * ncols + col] = Key<T>::dec(okey[i]);
}

template <typename T, bool IS_MIN>
int launch_minmax(const int32_t* gids, const T* vals, long long n, int ncols,
                  int groups, int nblocks, void* okey_raw, T* out,
                  cudaStream_t stream) {
  using K = typename Key<T>::K;
  K* okey = static_cast<K*>(okey_raw);
  const size_t smem_need = static_cast<size_t>(groups) * sizeof(K);
  const int use_smem = smem_need <= kMinMaxSmemMax;
  const size_t smem = use_smem ? smem_need : 0;
  cudaError_t err = cudaFuncSetAttribute(
      segminmax_fold<T, IS_MIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMinMaxSmemMax));
  if (err != cudaSuccess) return err;
  const int gblocks = (groups + 255) / 256;
  for (int col = 0; col < ncols; ++col) {
    segminmax_init<T, IS_MIN><<<gblocks, 256, 0, stream>>>(groups, okey);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    segminmax_fold<T, IS_MIN><<<nblocks, kMinMaxThreads, smem, stream>>>(
        gids, vals, n, ncols, col, groups, use_smem, okey);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    segminmax_decode<T><<<gblocks, 256, 0, stream>>>(okey, groups, ncols, col, out);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}


}  // namespace

// Grouped sum (count_mode = 0) or row count (count_mode = 1, int64, vals
// unused) of (n, ncols) row-major values into (groups, ncols), in the
// geometry of ops.sum_plan: `regime` (kAtomic for integers and counts; for
// floats kThread or kWarp), nblocks blocks of `chunk` rows each, tiles
// of gt groups x ct columns, `warps` (the per-warp copies of a float
// block, or the shared-memory copies of an integer block, 0 for none) and
// `smem` bytes of dynamic shared memory a block (its copies, and in kWarp
// the claim words after them).
// `partial` is float scratch of nblocks * gt * ct elements, unused by
// kAtomic, which zeroes `out` on the stream itself.
REPRO_EXPORT int segsum_sum(int dtype, int count_mode, int regime,
                            const void* gids, const void* vals, long long n,
                            int ncols, int groups, int nblocks, long long chunk,
                            int gt, int ct, int warps, int smem, void* partial,
                            void* out, void* stream) {
  const auto* g = static_cast<const int32_t*>(gids);
  auto st = static_cast<cudaStream_t>(stream);
  if (nblocks < 1 || chunk < 1 || smem < 0) return cudaErrorInvalidValue;
  if (regime == kAtomic) {
    if (warps < 0 || warps > kAtomicThreads / 32) return cudaErrorInvalidValue;
    if (count_mode) {
      if (chunk >= (1ll << 31)) return cudaErrorInvalidValue;  // 32-bit counters
      cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(groups) * 8, st);
      if (err != cudaSuccess) return err;
      return launch_atomic<long long, true, 1>(g, nullptr, n, 1, 0, groups, nblocks,
                                               chunk, warps, smem,
                                               static_cast<long long*>(out), st);
    }
    switch (dtype) {
      case kInt32:
        return sum_atomic<int32_t>(g, static_cast<const int32_t*>(vals), n, ncols,
                                   groups, nblocks, chunk, ct, warps, smem,
                                   static_cast<int32_t*>(out), st);
      case kInt64:
        return sum_atomic<long long>(g, static_cast<const long long*>(vals), n,
                                     ncols, groups, nblocks, chunk, ct, warps,
                                     smem, static_cast<long long*>(out), st);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (count_mode) return cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      return sum_float<float>(regime, g, static_cast<const float*>(vals), n, ncols,
                              groups, nblocks, chunk, gt, ct, warps, smem,
                              static_cast<float*>(partial),
                              static_cast<float*>(out), st);
    case kFloat64:
      return sum_float<double>(regime, g, static_cast<const double*>(vals), n, ncols,
                               groups, nblocks, chunk, gt, ct, warps, smem,
                               static_cast<double*>(partial),
                               static_cast<double*>(out), st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Grouped min (is_min = 1) or max of (n, ncols) row-major values into
// (groups, ncols); empty groups hold +inf / -inf (integers: the dtype's
// max / min).  `okey` is scratch of `groups` 8-byte words.
REPRO_EXPORT int segsum_minmax(int dtype, int is_min, const void* gids,
                               const void* vals, long long n, int ncols,
                               int groups, int nblocks, void* okey, void* out,
                               void* stream) {
  const auto* g = static_cast<const int32_t*>(gids);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_MINMAX(T)                                                            \
  (is_min ? launch_minmax<T, true>(g, static_cast<const T*>(vals), n, ncols,       \
                                   groups, nblocks, okey, static_cast<T*>(out), st) \
          : launch_minmax<T, false>(g, static_cast<const T*>(vals), n, ncols,      \
                                    groups, nblocks, okey, static_cast<T*>(out), st))
  switch (dtype) {
    case kInt32: return REPRO_MINMAX(int32_t);
    case kInt64: return REPRO_MINMAX(long long);
    case kFloat32: return REPRO_MINMAX(float);
    case kFloat64: return REPRO_MINMAX(double);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_MINMAX
}
