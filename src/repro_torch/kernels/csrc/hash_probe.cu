// Hash-join probes of a bucket table: build row or -1.  Two entry points:
// hash_probe64, described here, and hash_probe32, at the end.
//
// hash_probe64 replaces
// repro/kernels/hash_probe/kernel.py::hash_probe64_pallas, which holds the
// whole (B, C) bucket table resident in VMEM and compares a block of probe
// rows against all C lanes of their buckets at once.
//
// Bound on an H100: bytes.  What a probe must move is its 8-byte key and its
// 4-byte result; the table is read once: a 32-byte head per bucket and a
// 16-byte entry per key past a bucket's second.  At SF 10 that is 60 M
// probes into 15 M build keys (B 2^23), about 1.1 GB, or 0.33 ms at
// 3.35 TB/s.  With random keys each probe's bucket lies in its own sectors
// of a table that L2 (50 MB) cannot keep, so the kernel moves scattered
// sectors above that floor.
//
// Design.  The build (kernels/hash_probe/ops.py) gives each bucket one
// 32-byte head, aligned to a sector: its first two keys (int64), their
// rows, its key count n and where its keys 3..n start in a tail array
// of 16-byte (key, row) entries packed bucket after bucket.  A bucket's
// keys are distinct and ascending, so the first match is the reference's
// max over the lanes.  One thread per probe row: split the key into (lo,
// hi), hash with the shared bucket_of, read the head with two 16-byte
// loads of one sector, compare two keys, and only when the bucket holds
// more keys and neither matched read its tail entries, two at a time.
// At the default load (under two keys a bucket) most probes end after one
// random sector.  Packing the buckets alone (offsets, then entries) costs
// two dependent random sectors a probe; the reference's (B, C) planes of
// lo, hi and row cost three.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hash_probe64_kernel(const long long* __restrict__ keys, long long n,
                    const int4* __restrict__ heads,
                    const longlong2* __restrict__ tails, int buckets,
                    int32_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long key = keys[i];
  int32_t lo, hi;
  split64(key, lo, hi);
  const int4* head =
      heads + 2 * static_cast<size_t>(bucket_of(lo, hi, static_cast<uint32_t>(buckets)));
  const longlong2 first = __ldg(reinterpret_cast<const longlong2*>(head));
  const int4 meta = __ldg(head + 1);          // row 0, row 1, n, tail start
  int32_t v = -1;
  if (meta.z > 0 && first.x == key) {
    v = meta.x;
  } else if (meta.z > 1 && first.y == key) {
    v = meta.y;
  } else {
    const int32_t end = meta.w + meta.z - 2;
    for (int32_t e = meta.w; e < end; e += 2) {
      const bool two = e + 1 < end;
      const longlong2 r0 = __ldg(tails + e);
      const longlong2 r1 = two ? __ldg(tails + e + 1) : r0;
      if (r0.x == key) {
        v = static_cast<int32_t>(r0.y);
        break;
      }
      if (two && r1.x == key) {
        v = static_cast<int32_t>(r1.y);
        break;
      }
    }
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

// keys (n,) int64 vs a bucket table: heads (buckets, 8) int32, tails
// (R, 2) int64 (key, row) -> out (n,) int32.
REPRO_EXPORT int hash_probe64(const void* keys, long long n, const void* heads,
                              const void* tails, int buckets, void* out,
                              void* stream) {
  if (n == 0) return cudaSuccess;
  if (buckets <= 0) return cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  hash_probe64_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), n, static_cast<const int4*>(heads),
      static_cast<const longlong2*>(tails), buckets,
      static_cast<int32_t*>(out));
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
