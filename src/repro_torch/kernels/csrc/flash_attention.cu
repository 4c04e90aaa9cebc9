// Blocked online-softmax attention (FlashAttention) with GQA and the causal
// mask, float32 arithmetic on the CUDA cores.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas,
// whose grid walks (query head, query block, kv block) in order on one
// TensorCore and keeps the query tile, the running max and sum and a float32
// accumulator resident in VMEM while key/value tiles stream through.
//
// Bound on an H100: operations.  One call does 4 * Sq * Skv * D multiply-adds
// per query head (two products), halved under the causal mask; at
// B 2, Hq 32, S 4096, D 128 that is 2.75e11 FLOP, 0.278 ms at the card's
// 989 TFLOP/s bf16 dense tensor-core rate, against 168 MB of q, k, v and o
// (0.05 ms at 3.35 TB/s).  This first kernel does its products in float32
// on the CUDA cores (67 TFLOP/s peak), which matches the reference's
// arithmetic (float32 scores, float32 accumulation) and keeps the kernel
// simple; it cannot come near the tensor-core bound.  wgmma, TMA and warp
// specialisation are later work.
//
// Design.  One block of 256 threads per (flattened query head, tile of
// BQ = 64 query rows); the blocks of the heaviest causal tiles are launched
// first.  The block stages its query tile once (scaled by 1/sqrt(D), as the
// Pallas kernel scales q) and walks the key/value tiles of BK rows in order,
// staging each in shared memory as float32: q and k transposed ([d][row]),
// so a thread reads four rows or four keys with one 16-byte load, and v row
// major.  Thread (ty, tx) of the 16 x 16 grid owns 4 query rows and BK / 16
// keys of the score tile, and 4 rows by D / 16 columns (tx + 16 j) of the
// float32 output accumulator.  Per tile: scores from shared memory in
// registers; the causal mask (query i sees key j when i >= j, top-left
// aligned) and the ragged end of the keys set a score to -1e30, as the
// reference does; the row max and row sum go through shuffles across the 16
// threads of a row; the running max and sum rescale the accumulator; P goes
// through shared memory to the P.V product.  Key tiles wholly above the
// diagonal are skipped, as kernel.py:34-36 skips them.  Query rows past Sq
// are computed on zeros and never stored, so any Sq and Skv work.  The
// result is divided by max(l, 1e-30) and rounded to q's dtype (float32 or
// bfloat16, round to nearest even).  Head sizes 32, 64, 96, 128 and 256 are
// template instances; a 256 head takes key tiles of 32 to stay within
// shared memory.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kPad = 4;          // keeps 16-byte loads aligned, spreads banks
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

template <int D> struct Tiles {
  static constexpr int BK = D > 128 ? 32 : 64;   // keys per tile
  static constexpr int CN = BK / 16;             // score columns per thread
  static constexpr int RM = kBQ / 16;            // query rows per thread
  static constexpr int DPT = D / 16;             // output columns per thread
  static constexpr int QS = kBQ + kPad;          // row stride of q^T and P^T
  static constexpr int KS = BK + kPad;           // row stride of k^T
  static constexpr int kSmemFloats = D * QS + D * KS + BK * D + BK * QS;
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int group,
                       int sq, int skv, int causal, float scale) {
  using G = Tiles<D>;
  constexpr int BK = G::BK, CN = G::CN, RM = G::RM, DPT = G::DPT;
  constexpr int QS = G::QS, KS = G::KS;
  extern __shared__ float smem[];
  float* qt = smem;                  // [D][QS]   q^T, scaled
  float* kt = qt + D * QS;           // [D][KS]   k^T
  float* vs = kt + D * KS;           // [BK][D]   v
  float* pt = vs + BK * D;           // [BK][QS]  P^T

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest tiles first
  const size_t kv_base = static_cast<size_t>(bh / group) * skv * D;
  const T* qp = q + static_cast<size_t>(bh) * sq * D;
  const T* kp = k + kv_base;
  const T* vp = v + kv_base;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qt[d * QS + r] = q0 + r < sq
        ? to_f32(qp[static_cast<size_t>(q0 + r) * D + d]) * scale : 0.f;
  }

  float m[RM], l[RM], acc[RM][DPT];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  int n_kv = (skv + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + kBQ - 1) / BK + 1);

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BK;
    __syncthreads();                  // the last tile's readers are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < skv;
      const size_t g = static_cast<size_t>(k0 + r) * D + d;
      kt[d * KS + r] = in ? to_f32(kp[g]) : 0.f;
      vs[r * D + d] = in ? to_f32(vp[g]) : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * QS + ty * RM);
      const float av[RM] = {a.x, a.y, a.z, a.w};
      float bv[CN];
      if constexpr (CN == 4) {
        const float4 b = *reinterpret_cast<const float4*>(kt + d * KS + tx * CN);
        bv[0] = b.x; bv[1] = b.y; bv[2] = b.z; bv[3] = b.w;
      } else {
        const float2 b = *reinterpret_cast<const float2*>(kt + d * KS + tx * CN);
        bv[0] = b.x; bv[1] = b.y;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty * RM + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int key = k0 + tx * CN + j;
        if (key >= skv || (causal && row < key)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_new);
        pt[(tx * CN + j) * QS + ty * RM + i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(pt + c * QS + ty * RM);
      const float pv[RM] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* op = o + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      op[static_cast<size_t>(row) * D + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int group, int sq, int skv, int causal, cudaStream_t stream) {
  static_assert(Tiles<D>::RM == 4, "rows per thread are read as one float4");
  const size_t smem = Tiles<D>::kSmemFloats * sizeof(float);
  auto kernel = flash_attention_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, sq, skv, causal,
      1.f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             int bh, int group, int sq, int skv, int causal,
             cudaStream_t stream) {
  switch (d) {
    case 32: return launch<32, T>(q, k, v, o, bh, group, sq, skv, causal, stream);
    case 64: return launch<64, T>(q, k, v, o, bh, group, sq, skv, causal, stream);
    case 96: return launch<96, T>(q, k, v, o, bh, group, sq, skv, causal, stream);
    case 128: return launch<128, T>(q, k, v, o, bh, group, sq, skv, causal, stream);
    case 256: return launch<256, T>(q, k, v, o, bh, group, sq, skv, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (bh, sq, d), k/v (bh / group, skv, d), all contiguous, one dtype (float32
// or bfloat16) -> o (bh, sq, d).  sq and skv >= 1.
REPRO_EXPORT int flash_attention(int dtype, const void* q, const void* k,
                                 const void* v, void* o, int bh, int group,
                                 int sq, int skv, int d, int causal,
                                 void* stream) {
  if (bh <= 0 || group <= 0 || bh % group || sq <= 0 || skv <= 0 ||
      (sq + kBQ - 1) / kBQ > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch<float>(d, q, k, v, o, bh, group, sq, skv, causal, s);
    case kBFloat16:
      return dispatch<__nv_bfloat16>(d, q, k, v, o, bh, group, sq, skv,
                                     causal, s);
    default: return cudaErrorInvalidValue;
  }
}
