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
// at 3.35 TB/s; the arithmetic (one add or compare per value) is negligible.
//
// Design.
//  * sum/count must be bitwise deterministic from run to run (later slices
//    gate on byte-identity), so there are no float atomics.  Block b reduces a
//    fixed row range [b*chunk, (b+1)*chunk) into a partial in a fixed order,
//    and a second pass adds the partials of each cell in block order.  The
//    launch geometry is a function of the shapes only (ops.sum_plan), so
//    equal inputs give equal bits.  The same code sums integers (exact in any
//    order) and counts (values = 1).  Two regimes, chosen from G*C alone:
//  * small tiles (G*C <= kPrivateCells, e.g. Q1's 8 groups x 5 sums, every
//    scalar aggregate): each thread accumulates its own rows (tid,
//    tid + blockDim, ...) into a private slice of shared memory — no thread
//    waits on another — and the block adds the slices in thread order.
//  * larger tiles (Q7's 2^11 groups, Q9's 2^9): each warp owns a private
//    copy of the tile's G*C partial in shared memory and walks its own rows
//    32 at a time, kUnroll steps loaded ahead into registers.  Lanes that hit
//    the same group (__match_any_sync) take turns in lane order, i.e. row
//    order, so a cell's additions have a fixed order and no atomics are
//    needed; with random ids a step costs one or two turns.  The block then
//    adds its warps' copies in warp order.  The wrapper tiles columns, then
//    groups, so the copies fit in shared memory, and gives each block at
//    least 8*G*C rows, so zeroing and writing the partial stays small.
//  * min/max are order-free, so they use atomics: each thread folds a run of
//    rows of one group in a register, then atomicMin/atomicMax into a
//    shared-memory copy of the groups (global memory when G is too large),
//    then one global atomic per (block, touched group).  Floats are mapped to
//    integers whose signed order is the float order, so 64-bit integer
//    atomics serve float64.
//  * Ids outside [0, G) (the dead slot G, padding, garbage) are skipped: the
//    dead-slot convention of repro/kernels/segsum/ops.py.
#include "common.cuh"

#include <climits>

namespace {

constexpr int kPrivThreads = 128;  // threads of a small-tile block
constexpr int kPrivateCells = 48;  // per-thread partials up to G*C cells
constexpr int kWarpThreadsMax = 256;
constexpr int kMaxCols = 4;        // columns per launch in the warp regime
constexpr int kUnroll = 4;         // steps of 32 rows a lane loads ahead
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kMinMaxThreads = 256;
constexpr size_t kMinMaxSmemMax = 96 * 1024;

// small tiles: private per-thread partials (row stride = blockDim), then a
// thread-ordered combine.  `stride` (odd, >= cells) spreads the threads'
// slices over the shared-memory banks.
template <typename T, bool COUNT>
__global__ void __launch_bounds__(kPrivThreads)
segsum_private(const int32_t* __restrict__ gids, const T* __restrict__ vals,
               long long n, int ncols, int c0, int ct, int g0, int gt,
               int groups, long long chunk, int stride, T* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pacc = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int cells = gt * ct;
  T* mine = pacc + tid * stride;
  for (int i = 0; i < cells; ++i) mine[i] = T(0);
  const long long r0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long r1 = min(n, r0 + chunk);
#pragma unroll 4
  for (long long i = r0 + tid; i < r1; i += kPrivThreads) {
    const int g = gids[i];
    if (g < g0 || g >= g0 + gt || g >= groups) continue;
    const int cell = (g - g0) * ct;
    if (COUNT) {
      mine[cell] += T(1);
    } else {
      for (int c = 0; c < ct; ++c) mine[cell + c] += vals[i * ncols + c0 + c];
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

// larger tiles: a private partial per warp; lanes of one group take turns
template <typename T, bool COUNT>
__global__ void __launch_bounds__(kWarpThreadsMax)
segsum_warp(const int32_t* __restrict__ gids, const T* __restrict__ vals,
            long long n, int ncols, int c0, int ct, int g0, int gt,
            int groups, long long chunk, T* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);              // nwarps * cells
  const int cells = gt * ct;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < nwarps * cells; i += blockDim.x) acc[i] = T(0);
  __syncthreads();
  T* mine = acc + static_cast<size_t>(warp) * cells;
  const unsigned below = (1u << lane) - 1u;
  const long long r0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long r1 = min(n, r0 + chunk);
  const long long step = static_cast<long long>(nwarps) * 32 * kUnroll;
  for (long long base = r0 + static_cast<long long>(warp) * 32 * kUnroll;
       base < r1; base += step) {
    int cell[kUnroll];
    T v[kUnroll][kMaxCols];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * 32 + lane;
      const int g = i < r1 ? gids[i] : -1;
      const bool in = g >= g0 && g < g0 + gt && g < groups;
      cell[u] = in ? (g - g0) * ct : -1;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (COUNT) {
          v[u][c] = T(1);
        } else {
          v[u][c] = (in && c < ct) ? vals[i * ncols + c0 + c] : T(0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // rows outside the tile get a key of their own, so they wait on no one
      const unsigned peers =
          __match_any_sync(kFullMask, cell[u] >= 0 ? cell[u] : -1 - lane);
      const int rank = __popc(peers & below);
      const int turns = static_cast<int>(
          __reduce_max_sync(kFullMask, static_cast<unsigned>(__popc(peers))));
      for (int r = 0; r < turns; ++r) {
        if (rank == r && cell[u] >= 0) {
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c)
            if (c < ct) mine[cell[u] + c] += v[u][c];
        }
        __syncwarp();
      }
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

// out[g0+g, c0+c] = sum over blocks b (in block order) of partial[b, g, c]
template <typename T>
__global__ void segsum_combine(const T* __restrict__ partial, int nblocks,
                               int gt, int ct, int g0, int c0, int ncols,
                               T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= gt * ct) return;
  T s = T(0);
  for (int b = 0; b < nblocks; ++b) s += partial[static_cast<size_t>(b) * gt * ct + i];
  const int g = i / ct;
  const int c = i - g * ct;
  out[static_cast<size_t>(g0 + g) * ncols + c0 + c] = s;
}

template <typename T, bool COUNT>
int launch_sum(const int32_t* gids, const T* vals, long long n, int ncols,
               int groups, int nblocks, long long chunk, int gt, int ct,
               int warps, T* partial, T* out, cudaStream_t stream) {
  if (warps < 1 || warps * 32 > kWarpThreadsMax) return cudaErrorInvalidValue;
  for (int g0 = 0; g0 < groups; g0 += gt) {
    const int gtt = min(gt, groups - g0);
    for (int c0 = 0; c0 < ncols; c0 += ct) {
      const int ctt = min(ct, ncols - c0);
      const int cells = gtt * ctt;
      cudaError_t err;
      if (cells <= kPrivateCells) {
        const int stride = cells | 1;
        const size_t smem = static_cast<size_t>(kPrivThreads) * stride * sizeof(T);
        err = cudaFuncSetAttribute(segsum_private<T, COUNT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return err;
        segsum_private<T, COUNT><<<nblocks, kPrivThreads, smem, stream>>>(
            gids, vals, n, ncols, c0, ctt, g0, gtt, groups, chunk, stride, partial);
      } else {
        if (ctt > kMaxCols) return cudaErrorInvalidValue;
        const size_t smem = static_cast<size_t>(warps) * cells * sizeof(T);
        err = cudaFuncSetAttribute(segsum_warp<T, COUNT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return err;
        segsum_warp<T, COUNT><<<nblocks, warps * 32, smem, stream>>>(
            gids, vals, n, ncols, c0, ctt, g0, gtt, groups, chunk, partial);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      segsum_combine<T><<<(cells + 255) / 256, 256, 0, stream>>>(
          partial, nblocks, gtt, ctt, g0, c0, ncols, out);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
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
// unused) of (n, ncols) row-major values into (groups, ncols).  `partial` is
// scratch of nblocks * gt * ct elements; block b covers rows
// [b*chunk, (b+1)*chunk); a warp-regime block has `warps` warps.
REPRO_EXPORT int segsum_sum(int dtype, int count_mode, const void* gids,
                            const void* vals, long long n, int ncols,
                            int groups, int nblocks, long long chunk, int gt,
                            int ct, int warps, void* partial, void* out,
                            void* stream) {
  const auto* g = static_cast<const int32_t*>(gids);
  auto st = static_cast<cudaStream_t>(stream);
  if (count_mode) {
    return launch_sum<long long, true>(g, nullptr, n, 1, groups, nblocks, chunk,
                                       gt, 1, warps, static_cast<long long*>(partial),
                                       static_cast<long long*>(out), st);
  }
  switch (dtype) {
    case kInt32:
      return launch_sum<int32_t, false>(g, static_cast<const int32_t*>(vals), n, ncols,
                                        groups, nblocks, chunk, gt, ct, warps,
                                        static_cast<int32_t*>(partial),
                                        static_cast<int32_t*>(out), st);
    case kInt64:
      return launch_sum<long long, false>(g, static_cast<const long long*>(vals), n,
                                          ncols, groups, nblocks, chunk, gt, ct, warps,
                                          static_cast<long long*>(partial),
                                          static_cast<long long*>(out), st);
    case kFloat32:
      return launch_sum<float, false>(g, static_cast<const float*>(vals), n, ncols,
                                      groups, nblocks, chunk, gt, ct, warps,
                                      static_cast<float*>(partial),
                                      static_cast<float*>(out), st);
    case kFloat64:
      return launch_sum<double, false>(g, static_cast<const double*>(vals), n, ncols,
                                       groups, nblocks, chunk, gt, ct, warps,
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
