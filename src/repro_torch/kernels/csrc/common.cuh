// Shared device helpers of the repro_torch Hopper kernels.
//
// Every source is built on its own into a shared library with a plain C
// interface (nvcc -gencode arch=compute_90a,code=sm_90a -shared), loaded from
// Python with ctypes.  An exported function launches on the stream it is
// given, allocates nothing (the Python wrapper passes outputs and scratch),
// and returns cudaGetLastError() so a refused launch is reported at once.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes shared with the Python wrappers (kernels/__init__.py::DTYPE_CODE)
enum DType : int { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };

// murmur3 fmix32: the 32-bit finalizer of repro/kernels/radix_hist/kernel.py
// (murmur32).  Bit-exact with the plain version in kernels/hash_probe/ref.py.
__device__ __forceinline__ uint32_t murmur32(uint32_t k) {
  k ^= k >> 16;
  k *= 0x85EBCA6Bu;
  k ^= k >> 13;
  k *= 0xC2B2AE35u;
  k ^= k >> 16;
  return k;
}

// Split an int64 key into the int32 planes the bucket tables store.
__device__ __forceinline__ void split64(long long k, int32_t& lo, int32_t& hi) {
  lo = static_cast<int32_t>(static_cast<uint32_t>(
      static_cast<unsigned long long>(k) & 0xFFFFFFFFull));
  hi = static_cast<int32_t>(k >> 32);
}

// Bucket of a 64-bit key (repro/kernels/hash_probe/kernel.py::bucket_of): the
// planes are combined through a second murmur round, then reduced mod
// `buckets`.  The build (plain PyTorch), the probe and the group dictionary
// all hash through this one definition or its plain twin.
__device__ __forceinline__ int32_t bucket_of(int32_t lo, int32_t hi,
                                             uint32_t buckets) {
  const uint32_t mixed = murmur32(static_cast<uint32_t>(hi)) ^
                         static_cast<uint32_t>(lo);
  return static_cast<int32_t>(murmur32(mixed) % buckets);
}

REPRO_EXPORT const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
