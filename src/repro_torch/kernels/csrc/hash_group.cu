// Insert-or-lookup of int64 group keys into a `cap`-slot open-addressing
// dictionary (the hash-compaction group-by of Q13-shaped queries).
//
// Replaces repro/kernels/hash_group/kernel.py::hash_insert_pallas, which
// builds a write-once dictionary in VMEM across a sequential row-block grid
// and elects one writer per empty slot with a one-hot minimum — because the
// TPU has no atomics.  Hopper has them, so this is plain atomicCAS open
// addressing.
//
// Bound on an H100: bytes.  Each of the n rows reads its 8-byte key and
// 1-byte valid flag and writes a 4-byte slot; the dictionary (cap <= 8192
// slots, 12 bytes each) stays in L2.  At the main path's shape (Q13 at SF 10:
// n = 1.5 M customers, cap 512) that is ~20 MB, a few microseconds of
// bandwidth; contention on the few hot slots is what the design must keep
// cheap.
//
// Design.  One thread per row probes linearly from bucket_of(key, cap) (the
// same hash as the reference kernel) for at most `rounds` slots.  A slot has
// a state word (0 empty, 1 being written, 2 holding a key) that is claimed
// first with atomicCAS, so every int64 — negatives and any sentinel-looking
// value included — is a legal key.  The claimer writes the key, fences, and
// publishes state 2; a thread that finds state 1 waits for the key (the
// claimer never waits, so the wait ends), then compares.  The common case —
// the key is already there — costs two plain loads and no atomic.  The slot
// layout is free (repro/kernels/hash_group/ref.py); the contract is the
// dense ranks that ops.dict_rank derives, plus unresolved iff a valid row was
// not placed within `rounds` probes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int load_state(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__global__ void __launch_bounds__(kThreads)
hash_insert_kernel(const long long* __restrict__ keys,
                   const uint8_t* __restrict__ valid, long long n, int cap,
                   int rounds, long long* dkeys, int* state,
                   int32_t* __restrict__ slot_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!valid[i]) {
    slot_out[i] = -1;
    return;
  }
  const long long k = keys[i];
  int32_t lo, hi;
  split64(k, lo, hi);
  const int b = bucket_of(lo, hi, static_cast<uint32_t>(cap));
  int out = -1;
  for (int r = 0; r < rounds; ++r) {
    const int s = (b + r) % cap;
    int st = load_state(&state[s]);
    if (st == 0) {
      st = atomicCAS(&state[s], 0, 1);
      if (st == 0) {            // this thread owns the empty slot
        dkeys[s] = k;
        __threadfence();
        atomicExch(&state[s], 2);
        out = s;
        break;
      }
    }
    while (st == 1) st = load_state(&state[s]);   // claimer is writing the key
    __threadfence();
    if (*reinterpret_cast<const volatile long long*>(&dkeys[s]) == k) {
      out = s;
      break;
    }
  }
  slot_out[i] = out;
}

}  // namespace

// keys (n,) int64, valid (n,) uint8 -> slot (n,) int32 (-1: invalid or not
// placed).  dkeys (cap,) int64 and state (cap,) int32 must be zeroed by the
// caller; on return state[s] == 2 marks an occupied slot holding dkeys[s].
REPRO_EXPORT int hash_insert(const void* keys, const void* valid, long long n,
                             int cap, int rounds, void* dkeys, void* state,
                             void* slot, void* stream) {
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  hash_insert_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<const uint8_t*>(valid), n,
      cap, rounds, static_cast<long long*>(dkeys), static_cast<int*>(state),
      static_cast<int32_t*>(slot));
  return cudaGetLastError();
}
