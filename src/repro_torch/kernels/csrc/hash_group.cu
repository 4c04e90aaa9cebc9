// Insert-or-lookup of int64 group keys into a `cap`-slot open-addressing
// dictionary (the hash-compaction group-by of Q13-shaped queries).
//
// Replaces repro/kernels/hash_group/kernel.py::hash_insert_pallas, which
// builds a write-once dictionary in VMEM across a sequential row-block grid
// and elects one writer per empty slot with a one-hot minimum — because the
// TPU has no atomics.  Hopper has them, in shared and in global memory.
//
// The dictionary (global memory, zeroed by the C call with one memset):
// keys (cap,) int64, state (cap,) int32 (0 empty, 1 being written, 2 holding
// a key), occupied (cap,) uint8 and one unresolved byte.  A slot is claimed
// with atomicCAS on its state word, so every int64 — negatives and any
// sentinel-looking value included — is a legal key.  The claimer writes the
// key and the occupied byte, then publishes state 2 with a release store; a
// reader takes the state with an acquire load (so a key it then reads is
// the published one, with no fence on the reader's side) and waits while it
// is 1 (the claimer never waits, so the wait ends).  A key looked up from
// bucket_of(key, cap) (the reference kernel's hash) for at most `rounds`
// slots either finds its slot or the row is unresolved: the kernel sets the
// unresolved byte.  The slot layout is free (kernels/hash_group/ref.py); the
// contract is the dense ranks that ops.dict_rank derives, the key set, and
// unresolved iff a valid row was not placed within `rounds` probes.
//
// Bound on an H100: bytes.  Each of the n rows reads its 8-byte key and
// 1-byte valid flag and writes a 4-byte slot; at Q13's shape at SF 10 (n =
// 1.5 M customers, cap 512) that is ~20 MB, ~6 us at 3.35 TB/s.  What a row
// must not do is touch the dictionary in global memory: with a few dozen
// distinct keys (one of them a third of Q13's rows) every row's state and
// key loads queue on the L2 lines of a few slots.
//
// Two designs, chosen by `cap` in ops.insert_design:
//  * shared (chosen up to cap 4096; it runs while 12 cap bytes fit in a
//    block's shared memory, but measured, the global design wins above
//    4096): a persistent grid of one block per resident slot, each with its
//    own dictionary of `cap` int64 keys in shared memory.  Pass 1: each row
//    of the block's chunk looks its key up there with plain shared loads,
//    claims an empty slot with a 64-bit shared atomicCAS (the empty marker
//    is INT64_MIN; a row holding that key, or one the shared table cannot
//    place within `rounds`, goes to the global dictionary itself), and
//    parks its local slot in `slot`.
//    Pass 2: the block publishes each distinct key once into the global
//    dictionary — a few dozen global probes a block instead of one a row —
//    and keeps the global slot beside the local one.  Pass 3: each row maps
//    its local slot to the global one (its chunk of `slot` is still in L2).
//  * global (larger dictionaries): one thread per row probes the global
//    dictionary directly.
#include <algorithm>
#include <climits>
#include <mutex>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;                  // rows a thread loads at once
constexpr long long kEmpty = LLONG_MIN;     // empty slot of a shared table
constexpr int kSharedBytesMax = 232448;     // an H100 block's shared memory

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

struct Dict {
  long long* keys;
  int* state;
  uint8_t* occupied;
  uint8_t* unresolved;
  int cap;
  int rounds;
};

__device__ __forceinline__ int bucket_of_key(long long k, int cap) {
  int32_t lo, hi;
  split64(k, lo, hi);
  return bucket_of(lo, hi, static_cast<uint32_t>(cap));
}

// The global slot of key k (bucket b), claiming one if it is new; -1 (and
// the unresolved byte set) when `rounds` probes find neither.
__device__ int global_insert(const Dict& d, long long k, int b) {
  int s = b;
  for (int r = 0; r < d.rounds; ++r) {
    int st = load_acquire(&d.state[s]);
    if (st == 0) {
      st = atomicCAS(&d.state[s], 0, 1);
      if (st == 0) {            // this thread owns the empty slot
        d.keys[s] = k;
        d.occupied[s] = 1;
        store_release(&d.state[s], 2);
        return s;
      }
    }
    while (st == 1) st = load_acquire(&d.state[s]);  // claimer writes the key
    if (*reinterpret_cast<const volatile long long*>(&d.keys[s]) == k)
      return s;
    if (++s == d.cap) s = 0;
  }
  *d.unresolved = 1;
  return -1;
}

// The shared-table slot of key k (bucket b), claiming one if it is new; -1
// when `rounds` probes find neither.  The key word itself is claimed, so a
// reader needs no state word and no fence.
__device__ __forceinline__ int shared_insert(long long* table, long long k,
                                             int b, int cap, int rounds) {
  int s = b;
  for (int r = 0; r < rounds; ++r) {
    long long cur = *reinterpret_cast<volatile long long*>(&table[s]);
    if (cur == k) return s;
    if (cur == kEmpty) {
      cur = static_cast<long long>(atomicCAS(
          reinterpret_cast<unsigned long long*>(&table[s]),
          static_cast<unsigned long long>(kEmpty),
          static_cast<unsigned long long>(k)));
      if (cur == kEmpty || cur == k) return s;
    }
    if (++s == cap) s = 0;
  }
  return -1;
}

__global__ void __launch_bounds__(kThreads)
hash_insert_shared_kernel(const long long* __restrict__ keys,
                          const uint8_t* __restrict__ valid, long long n,
                          long long chunk, Dict d, int32_t* __restrict__ slot) {
  extern __shared__ long long table[];                  // (cap,) keys
  int* to_global = reinterpret_cast<int*>(table + d.cap);  // (cap,) slots
  for (int s = threadIdx.x; s < d.cap; s += kThreads) table[s] = kEmpty;
  __syncthreads();
  const long long lo = static_cast<long long>(blockIdx.x) * chunk;
  const long long hi = min(n, lo + chunk);

  // pass 1: local slot s >= 0, or -2 - global slot, or -1
  for (long long i0 = lo + threadIdx.x; i0 < hi; i0 += kUnroll * kThreads) {
    long long k[kUnroll];
    uint8_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kThreads;
      k[u] = i < hi ? keys[i] : 0;
      v[u] = i < hi ? valid[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kThreads;
      if (i >= hi) break;
      int out = -1;
      if (v[u]) {
        const int b = bucket_of_key(k[u], d.cap);
        out = k[u] == kEmpty ? -1 : shared_insert(table, k[u], b, d.cap,
                                                  d.rounds);
        if (out < 0) out = -2 - global_insert(d, k[u], b);
      }
      slot[i] = out;
    }
  }
  __syncthreads();

  // pass 2: publish the block's distinct keys
  for (int s = threadIdx.x; s < d.cap; s += kThreads) {
    const long long k = table[s];
    if (k != kEmpty) to_global[s] = global_insert(d, k, bucket_of_key(k, d.cap));
  }
  __syncthreads();

  // pass 3: local slots to global ones
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const int s = slot[i];
    if (s >= 0) {
      slot[i] = to_global[s];
    } else if (s < -1) {
      slot[i] = -2 - s;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hash_insert_global_kernel(const long long* __restrict__ keys,
                          const uint8_t* __restrict__ valid, long long n,
                          Dict d, int32_t* __restrict__ slot) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  if (!valid[i]) {
    slot[i] = -1;
    return;
  }
  const long long k = keys[i];
  slot[i] = global_insert(d, k, bucket_of_key(k, d.cap));
}

// SMs of `dev` and resident blocks of the shared design a SM at `smem`
// bytes, queried once per (device, smem) and kept: the queries cost more
// host time than the kernel takes.
cudaError_t resident_blocks(int dev, int smem, int* sms, int* per_sm) {
  struct Entry { int dev, smem, sms, per_sm; };
  static std::mutex lock;
  static Entry seen[64];
  static int count = 0;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < count; ++i) {
    if (seen[i].dev == dev && seen[i].smem == smem) {
      *sms = seen[i].sms;
      *per_sm = seen[i].per_sm;
      return cudaSuccess;
    }
  }
  cudaError_t err;
  // above 48 KB of shared memory a kernel must opt in, on each device
  if ((err = cudaFuncSetAttribute(hash_insert_shared_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSharedBytesMax)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, hash_insert_shared_kernel, kThreads,
           static_cast<size_t>(smem))) != cudaSuccess)
    return err;
  if (count < 64) seen[count++] = {dev, smem, *sms, *per_sm};
  return cudaSuccess;
}

}  // namespace

// keys (n,) int64, valid (n,) uint8 -> slot (n,) int32 (-1: invalid or not
// placed).  `dict` is one buffer of 13 cap + 1 bytes, zeroed here: keys
// (cap,) int64, state (cap,) int32, occupied (cap,) uint8, unresolved
// (uint8).  design 0: shared, 1: global.
REPRO_EXPORT int hash_insert(const void* keys, const void* valid, long long n,
                             int cap, int rounds, int design, void* dict,
                             void* slot, void* stream) {
  if (cap <= 0 || rounds <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(dict);
  Dict d{reinterpret_cast<long long*>(base),
         reinterpret_cast<int*>(base + 8LL * cap),
         reinterpret_cast<uint8_t*>(base + 12LL * cap),
         reinterpret_cast<uint8_t*>(base + 13LL * cap), cap, rounds};
  cudaError_t err = cudaMemsetAsync(dict, 0, 13LL * cap + 1, st);
  if (err != cudaSuccess || n == 0) return err;
  const long long* k = static_cast<const long long*>(keys);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int32_t* out = static_cast<int32_t*>(slot);
  if (design == 1) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    hash_insert_global_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                st>>>(k, v, n, d, out);
    return cudaGetLastError();
  }
  const long long smem = 12LL * cap;        // keys and global slots
  if (design != 0 || smem > kSharedBytesMax) return cudaErrorInvalidValue;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  if ((err = resident_blocks(dev, static_cast<int>(smem), &sms, &per_sm)) !=
      cudaSuccess)
    return err;
  // one block per resident slot, each a contiguous chunk of whole warps
  long long blocks = static_cast<long long>(sms) * std::max(per_sm, 1);
  blocks = std::min(blocks, (n + kUnroll * kThreads - 1) / (kUnroll * kThreads));
  const long long chunk = ((n + blocks - 1) / blocks + 31) / 32 * 32;
  blocks = (n + chunk - 1) / chunk;
  hash_insert_shared_kernel<<<static_cast<unsigned>(blocks), kThreads,
                              static_cast<size_t>(smem), st>>>(k, v, n, chunk,
                                                               d, out);
  return cudaGetLastError();
}
