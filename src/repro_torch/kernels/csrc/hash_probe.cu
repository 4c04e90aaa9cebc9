// Hash-join probes of a (B, C) bucket table: build row or -1.  Two entry
// points: hash_probe64, described here, and hash_probe32, at the end.
//
// hash_probe64 replaces
// repro/kernels/hash_probe/kernel.py::hash_probe64_pallas, which holds the
// whole bucket table resident in VMEM and compares a block of probe rows
// against all C lanes of their buckets at once.
//
// Bound on an H100: bytes.  What a probe must move is its 8-byte key, its
// 4-byte result, and the occupied lanes of the bucket table (12 bytes each:
// lo, hi and row); the empty lanes hold nothing it needs.  At SF 10 that is
// 60 M probes into 15 M build keys, about 0.9 GB, or 0.27 ms at 3.35 TB/s.
// With random keys each probe's bucket lies in its own 32-byte sectors of
// the three planes, which L2 (50 MB) cannot keep across a 1.6 GB table, so
// the kernel moves scattered sectors well above that floor.
//
// Design.  One thread per probe row: split the key into its (lo, hi) planes,
// hash with the shared bucket_of and scan the bucket's lanes.  The build
// (kernels/hash_probe/ops.py) fills a bucket's lanes front to back with
// distinct keys and non-negative build rows, and marks empty lanes with
// row -1, so the scan stops at the first match or the first empty lane —
// the same answer as the reference's max over all C lanes, reading only the
// sectors of the occupied lanes (about two at the default load).  The lanes
// are loaded 4 at a time, the 12 loads of a group independent of each other
// (a lane past C reads as empty), so a probe costs one round trip to memory
// instead of a chain of dependent ones, for any C.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;        // lanes loaded together

__global__ void __launch_bounds__(kThreads)
hash_probe64_kernel(const long long* __restrict__ keys, long long n,
                    const int32_t* __restrict__ bk_lo,
                    const int32_t* __restrict__ bk_hi,
                    const int32_t* __restrict__ bvals, int buckets, int cap,
                    int32_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t lo, hi;
  split64(keys[i], lo, hi);
  const size_t base = static_cast<size_t>(bucket_of(lo, hi, static_cast<uint32_t>(buckets))) * cap;
  int32_t v = -1;
  for (int c = 0; c < cap; c += kLanes) {
    int32_t r[kLanes], l[kLanes], h[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const bool in = c + j < cap;
      r[j] = in ? __ldg(bvals + base + c + j) : -1;
      l[j] = in ? __ldg(bk_lo + base + c + j) : 0;
      h[j] = in ? __ldg(bk_hi + base + c + j) : 0;
    }
    bool done = false;
#pragma unroll
    for (int j = 0; j < kLanes && !done; ++j) {
      if (r[j] < 0) {                                 // end of the bucket
        done = true;
      } else if (l[j] == lo && h[j] == hi) {
        v = r[j];
        done = true;
      }
    }
    if (done) break;
  }
  out[i] = v;
}

// One thread per probe row: hash the int32 key with the build's murmur32,
// then compare it with all C lanes of its bucket and keep the largest
// matching build row (-1 when none), exactly the plain version's max over
// the lanes.  No early stop: the 32-bit table marks an empty lane only by
// the SENTINEL key, which is also a legal key, and a bucket's lanes lie in
// one or two 32-byte sectors per plane at the default C = 8.
__global__ void __launch_bounds__(kThreads)
hash_probe32_kernel(const int32_t* __restrict__ keys, long long n,
                    const int32_t* __restrict__ bkeys,
                    const int32_t* __restrict__ bvals, int buckets, int cap,
                    int32_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t key = keys[i];
  const size_t base = static_cast<size_t>(
      murmur32(static_cast<uint32_t>(key)) % static_cast<uint32_t>(buckets)) * cap;
  int32_t v = -1;
#pragma unroll 8
  for (int c = 0; c < cap; ++c) {
    if (__ldg(bkeys + base + c) == key) v = max(v, __ldg(bvals + base + c));
  }
  out[i] = v;
}

}  // namespace

// keys (n,) int64 vs bucket planes (buckets, cap) int32 -> out (n,) int32.
// Build rows must be non-negative: -1 marks an empty lane.
REPRO_EXPORT int hash_probe64(const void* keys, long long n, const void* bk_lo,
                              const void* bk_hi, const void* bvals, int buckets,
                              int cap, void* out, void* stream) {
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  hash_probe64_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), n, static_cast<const int32_t*>(bk_lo),
      static_cast<const int32_t*>(bk_hi), static_cast<const int32_t*>(bvals),
      buckets, cap, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

// hash_probe32 replaces repro/kernels/hash_probe/kernel.py::hash_probe_pallas,
// which holds the whole (B, C) table resident in VMEM and compares a block
// of probe keys against all C lanes of their buckets at once.
//
// Bound on an H100: bytes.  A probe reads its 4-byte key and writes its
// 4-byte row; the table's occupied lanes (key and row, 8 bytes each) are
// read once.  At SF 10 (60 M l_orderkey probes into 15 M o_orderkey) that
// is 0.6 GB, 0.18 ms at 3.35 TB/s; as with the 64-bit probe, random buckets
// scatter the table reads over sectors L2 cannot keep.
//
// keys (n,) int32 vs bucket planes (buckets, cap) int32 -> out (n,) int32.
REPRO_EXPORT int hash_probe32(const void* keys, long long n, const void* bkeys,
                              const void* bvals, int buckets, int cap,
                              void* out, void* stream) {
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  hash_probe32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), n, static_cast<const int32_t*>(bkeys),
      static_cast<const int32_t*>(bvals), buckets, cap,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}
