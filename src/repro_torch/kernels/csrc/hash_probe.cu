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

// ---------------------------------------------------------------------------
// hash_probe32 (its note is at its entry point, below)

constexpr int kProbeThreads = 256;
constexpr int kInFlight = 4;        // probes a thread keeps in flight

__device__ __forceinline__ uint32_t bucket32(int32_t key, uint32_t buckets) {
  const uint32_t h = murmur32(static_cast<uint32_t>(key));
  return (buckets & (buckets - 1)) == 0 ? (h & (buckets - 1)) : h % buckets;
}

// Both designs read a lane only below its bucket's fill (`counts`, clamped
// to C; C when absent): lanes fill front to back and an empty lane holds
// row -1, so skipping it never changes the max.  One thread a probe, each
// keeping kInFlight probes in flight: their loads of a step are issued
// together.  A thread notes where a probe matched and reads that lane's row
// after the loop, all probes' at once; a further match of one probe (a key
// built twice) reads its row on the spot.

// Loop design: a key row read 16 bytes (4 lanes) at a time up to the fill,
// its first 16 bytes beside the fill count.
__global__ void __launch_bounds__(kProbeThreads)
hash_probe32_loop_kernel(const int32_t* __restrict__ keys, long long n,
                         const int4* __restrict__ bkeys,
                         const int32_t* __restrict__ bvals,
                         const int32_t* __restrict__ counts, uint32_t buckets,
                         int cap, int32_t* __restrict__ out) {
  constexpr int P = kInFlight;
  const long long first =
      static_cast<long long>(blockIdx.x) * kProbeThreads * P + threadIdx.x;
  const int row4 = cap >> 2;
  int32_t key[P], best[P], hit[P];
  size_t row[P];
  int fill[P];
  int4 q[P];
  int most = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = first + static_cast<long long>(p) * kProbeThreads;
    key[p] = i < n ? __ldg(keys + i) : 0;
    const uint32_t b = bucket32(key[p], buckets);
    row[p] = static_cast<size_t>(b) * row4;
    q[p] = i < n ? __ldg(bkeys + row[p]) : make_int4(0, 0, 0, 0);
    fill[p] = i >= n ? 0 : counts == nullptr ? cap : min(cap, __ldg(counts + b));
    most = max(most, fill[p]);
    best[p] = hit[p] = -1;
  }
  for (int c = 0; 4 * c < most; ++c) {
    if (c > 0) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        q[p] = 4 * c < fill[p] ? __ldg(bkeys + row[p] + c) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int32_t kk[4] = {q[p].x, q[p].y, q[p].z, q[p].w};
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int lane = 4 * c + l;
        if (lane < fill[p] && kk[l] == key[p]) {
          if (hit[p] < 0) {
            hit[p] = lane;
          } else {
            best[p] = max(best[p], __ldg(bvals + 4 * row[p] + lane));
          }
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int32_t v = hit[p] >= 0 ? __ldg(bvals + 4 * row[p] + hit[p]) : -1;
    best[p] = max(best[p], v);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = first + static_cast<long long>(p) * kProbeThreads;
    if (i < n) out[i] = best[p];
  }
}

// Scalar design, for a C that is not a multiple of 4 or a plane that is not
// 16-byte aligned: lanes one at a time up to the fill.
__global__ void __launch_bounds__(kProbeThreads)
hash_probe32_scalar_kernel(const int32_t* __restrict__ keys, long long n,
                           const int32_t* __restrict__ bkeys,
                           const int32_t* __restrict__ bvals,
                           const int32_t* __restrict__ counts,
                           uint32_t buckets, int cap,
                           int32_t* __restrict__ out) {
  const long long first =
      static_cast<long long>(blockIdx.x) * kProbeThreads * kInFlight + threadIdx.x;
  int32_t key[kInFlight], best[kInFlight];
  size_t base[kInFlight];
  int fill[kInFlight];
  int most = 0;
#pragma unroll
  for (int p = 0; p < kInFlight; ++p) {
    const long long i = first + static_cast<long long>(p) * kProbeThreads;
    key[p] = i < n ? __ldg(keys + i) : 0;
    const uint32_t b = bucket32(key[p], buckets);
    base[p] = static_cast<size_t>(b) * cap;
    fill[p] = i >= n ? 0 : counts == nullptr ? cap : min(cap, __ldg(counts + b));
    most = max(most, fill[p]);
    best[p] = -1;
  }
  for (int c = 0; c < most; ++c) {
#pragma unroll
    for (int p = 0; p < kInFlight; ++p) {
      if (c < fill[p] && __ldg(bkeys + base[p] + c) == key[p])
        best[p] = max(best[p], __ldg(bvals + base[p] + c));
    }
  }
#pragma unroll
  for (int p = 0; p < kInFlight; ++p) {
    const long long i = first + static_cast<long long>(p) * kProbeThreads;
    if (i < n) out[i] = best[p];
  }
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
// of probe keys against all C lanes of their buckets at once.  The (B, C)
// key and row planes are the contract here (bit-exact with the reference's
// build), so the kernel is made fast on that layout.
//
// Bound on an H100: bytes.  A probe reads its 4-byte key and writes its
// 4-byte row; the table's occupied lanes (key and row, 8 bytes each) are
// read once.  At SF 10 (60 M l_orderkey probes into 15 M o_orderkey) that
// is 0.6 GB, 0.18 ms at 3.35 TB/s.  The layout adds to that: a probe's
// bucket is random, so each distinct bucket costs its key row rounded up to
// 32-byte sectors (C = 64: 8 sectors) and a row sector.  l_orderkey is
// clustered (1-7 lines an order, in order), so neighbouring probes share a
// bucket and one request serves them.  What bounds the kernel is how many
// of those scattered reads are in flight: the one-lane-at-a-time kernel
// before this one waited on C scalar loads and then a dependent row load
// per probe.  The loop design keeps four probes' 16-byte loads in flight a
// thread, reads a bucket only up to its fill (the build's counts, from
// C = 32 on: ops.probe32_plan) and issues the matched rows' loads together.
// Measured (tools/time_hash_kernels.py): splitting a row over a group of
// threads lost at every C, eight probes a thread lost to four, and reading
// rows beside keys lost to reading the matched lane.
//
// keys (n,) int32 vs bucket planes (buckets, cap) int32, counts (buckets,)
// int32 fill counts or null -> out (n,) int32.  design 0: scalar; 1: loop,
// which needs 16-byte aligned planes and a cap that is a multiple of 4.
REPRO_EXPORT int hash_probe32(const void* keys, long long n, const void* bkeys,
                              const void* bvals, const void* counts,
                              int buckets, int cap, int design, void* out,
                              void* stream) {
  if (n == 0) return cudaSuccess;
  if (buckets <= 0 || cap <= 0) return cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(bkeys) |
                        reinterpret_cast<uintptr_t>(bvals)) % 16 == 0;
  if (design == 1 && (cap % 4 != 0 || !aligned)) return cudaErrorInvalidValue;
  const long long per_block = static_cast<long long>(kProbeThreads) * kInFlight;
  const unsigned blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* k = static_cast<const int32_t*>(keys);
  const int32_t* v = static_cast<const int32_t*>(bvals);
  const int32_t* c = static_cast<const int32_t*>(counts);
  const uint32_t nb = static_cast<uint32_t>(buckets);
  int32_t* o = static_cast<int32_t*>(out);
  if (design == 1) {
    hash_probe32_loop_kernel<<<blocks, kProbeThreads, 0, st>>>(
        k, n, static_cast<const int4*>(bkeys), v, c, nb, cap, o);
  } else if (design == 0) {
    hash_probe32_scalar_kernel<<<blocks, kProbeThreads, 0, st>>>(
        k, n, static_cast<const int32_t*>(bkeys), v, c, nb, cap, o);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
