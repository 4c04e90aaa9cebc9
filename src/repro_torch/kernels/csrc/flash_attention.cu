// Blocked online-softmax attention (FlashAttention) with GQA and the causal
// mask: two designs, chosen by dtype and head size in the Python wrapper
// (kernels/flash_attention/ops.py::design).
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas,
// whose grid walks (query head, query block, kv block) in order on one
// TensorCore and keeps the query tile, the running max and sum and a float32
// accumulator resident in VMEM while key/value tiles stream through.
//
// Bound on an H100: operations.  One call does 4 * Sq * Skv * D flops per
// query head (two products), halved under the causal mask; at B 2, Hq 32,
// S 4096, D 128 that is 2.75e11 FLOP, 0.278 ms at the card's 989 TFLOP/s
// bf16 dense tensor-core rate, against 168 MB of q, k, v and o (0.05 ms at
// 3.35 TB/s).
//
// 1. flash_attention_wgmma: bf16 at head sizes 64, 128 and 256, on the
//    tensor cores.  One block of 384 threads owns (flattened query head,
//    128 query rows): two consumer warpgroups of 64 rows each and a
//    producer warpgroup, of which one thread works.  The producer loads the
//    query tile once and keeps a 2-stage ring of key/value tiles (BK = 128
//    keys; 64 at D 256, to stay in shared memory) in flight with TMA, each
//    stage guarded by a "full" mbarrier (TMA bytes landed) and an "empty"
//    one (both consumers' products done).  Tiles arrive 128-byte swizzled,
//    in blocks of 64 columns; rows past a head's end read as zeros.  A
//    consumer computes S = Q K^T with wgmma (both operands from shared
//    memory, K stored [key][d] is already K-major), masks the accumulator
//    fragment (causal: query i sees key j when i >= j, top-left aligned;
//    keys past Skv), keeps the running max and sum of its two rows per
//    thread in float32 registers (row reductions across the 4 threads of a
//    quad), and adds P V with wgmma, P from registers as the A operand (the
//    accumulator fragment of S is laid out as the A fragment, two columns
//    per 32-bit register) and V [key][d] read MN-major (wgmma's transposed
//    B).  P enters as P_hi + P_lo, two bf16 products: P_hi = bf16(P),
//    P_lo = bf16(P - P_hi).  One rounding of P to bf16 puts outputs where
//    v cancels outside one output rounding of the float32 reference
//    (chip_smoke.py's element-wise bf16 limit); the split carries P to
//    about 16 bits.  It costs half as much tensor work again (1.5x the
//    function's flops, a 0.42 ms ceiling for this design at the shape
//    above).  Key tiles wholly above the diagonal are skipped, the
//    heaviest causal query tiles are launched first, rows past Sq are
//    never stored, and the result is divided by the row sum and rounded to
//    bf16 (round to nearest even).  setmaxnreg gives the consumers 240
//    registers a thread and the producer 24 (the accumulators of S and O
//    and the P fragments do not fit the 168 a thread of 384 starts with).
//    The TMA descriptors are encoded on the host for every call
//    (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so
//    that nothing links libcuda) and passed as __grid_constant__.
//
// 2. flash_attention (CUDA cores): float32, and bf16 at head sizes 32 and
//    96, in float32 arithmetic on the CUDA cores (67 TFLOP/s peak), the
//    reference's arithmetic (float32 scores, float32 accumulation).  One
//    block of 256 threads per (flattened query head, tile of BQ = 64 query
//    rows); the blocks of the heaviest causal tiles are launched first.
//    The block stages its query tile once (scaled by 1/sqrt(D), as the
//    Pallas kernel scales q) and walks the key/value tiles of BK rows in
//    order, staging each in shared memory as float32: q and k transposed
//    ([d][row]), so a thread reads four rows or four keys with one 16-byte
//    load, and v row major.  Thread (ty, tx) of the 16 x 16 grid owns 4
//    query rows and BK / 16 keys of the score tile, and 4 rows by D / 16
//    columns (tx + 16 j) of the float32 output accumulator.  Per tile:
//    scores from shared memory in registers; the causal mask and the
//    ragged end of the keys set a score to -1e30, as the reference does;
//    the row max and row sum go through shuffles across the 16 threads of a
//    row; the running max and sum rescale the accumulator; P goes through
//    shared memory to the P.V product.  Key tiles wholly above the diagonal
//    are skipped, as kernel.py:34-36 skips them.  Query rows past Sq are
//    computed on zeros and never stored, so any Sq and Skv work.  The
//    result is divided by max(l, 1e-30) and rounded to q's dtype.  Head
//    sizes 32, 64, 96, 128 and 256 are template instances; a 256 head takes
//    key tiles of 32 to stay within shared memory.
#include <cuda_bf16.h>

#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

// ---------------------------------------------------------------------------
// 2. flash_attention: float32 arithmetic on the CUDA cores
// ---------------------------------------------------------------------------

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


// ---------------------------------------------------------------------------
// 1. flash_attention_wgmma: bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace {

namespace tc {

using hopper::fence_regs;
using hopper::sw128_desc;

constexpr int kBM = 128;                 // query rows per block
constexpr int kConsumerThreads = 256;    // two warpgroups of 64 rows
constexpr int kThreads = kConsumerThreads + 128;  // and a producer warpgroup
// registers a thread after rebalancing: each of the SM's four sub-partitions
// holds two consumer warps and one producer warp, 2 x 240 + 24 <= 512 a lane
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kStages = 2;
constexpr int kColBytes = 128;           // one swizzled row: 64 bf16

template <int D> struct Cfg {
  static constexpr int BK = D > 128 ? 64 : 128;   // keys per tile
  static constexpr int kColBlocks = D / 64;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kTileBytes = BK * D * 2;   // one K or one V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  // + 1024 to align the base for the swizzle atoms, + 5 mbarriers
  static constexpr int kSmem = kBarOffset + 1024 + 5 * 8;
};

template <int N> struct Wgmma;
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    hopper::wgmma_ss_n64(d, a, b, scale_d);
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    hopper::wgmma_rs_n64(d, a, b);
  }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    hopper::wgmma_ss_n128(d, a, b, scale_d);
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    hopper::wgmma_rs_n128(d, a, b);
  }
};
template <> struct Wgmma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    hopper::wgmma_rs_n256(d, a, b);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Key tiles the block's 128 rows need (the same count for producer and
// consumers).
__device__ __forceinline__ int kv_tiles(int q0, int skv, int causal, int bk) {
  const int keys = causal ? min(skv, q0 + kBM) : skv;
  return (keys + bk - 1) / bk;
}

// Shared-memory addresses of one block: the query tile, the K and V stages
// (1024-byte aligned, as the swizzle atoms need) and the mbarriers.
template <int D> struct Smem {
  uint32_t q, k, v, bar;
  __device__ __forceinline__ explicit Smem(uint32_t raw) {
    const uint32_t base = (raw + 1023u) & ~1023u;
    q = base;
    k = base + Cfg<D>::kQBytes;
    v = k + kStages * Cfg<D>::kTileBytes;
    bar = base + Cfg<D>::kBarOffset;
  }
  __device__ __forceinline__ uint32_t k_tile(int s) const {
    return k + s * Cfg<D>::kTileBytes;
  }
  __device__ __forceinline__ uint32_t v_tile(int s) const {
    return v + s * Cfg<D>::kTileBytes;
  }
  __device__ __forceinline__ uint32_t q_full() const { return bar; }
  __device__ __forceinline__ uint32_t full(int s) const {
    return bar + 8u + 8u * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bar + 8u + 8u * kStages + 8u * s;
  }
};

// The producer's one thread: the query tile, then the K/V ring.
template <int D>
__device__ __forceinline__ void produce(const Smem<D>& sm, const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int bh,
                                        int kvh, int q0, int n_kv) {
  using C = Cfg<D>;
  hopper::mbar_expect_tx(sm.q_full(), C::kQBytes);
  for (int c = 0; c < C::kColBlocks; ++c)
    hopper::tma_load_3d(sm.q + c * kBM * kColBytes, tm_q, sm.q_full(), c * 64,
                        q0, bh);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages, use = j / kStages;
    if (use > 0) hopper::mbar_wait(sm.empty(s), (use - 1) & 1);
    hopper::mbar_expect_tx(sm.full(s), 2 * C::kTileBytes);
    for (int c = 0; c < C::kColBlocks; ++c) {
      hopper::tma_load_3d(sm.k_tile(s) + c * C::BK * kColBytes, tm_k,
                          sm.full(s), c * 64, j * C::BK, kvh);
      hopper::tma_load_3d(sm.v_tile(s) + c * C::BK * kColBytes, tm_v,
                          sm.full(s), c * 64, j * C::BK, kvh);
    }
  }
}

// One consumer warpgroup's view of its 64 rows: the thread's two rows
// (row0, row0 + 8) and columns (col0 + 8 j, + 1) of every accumulator.
template <int D> struct Consumer {
  static constexpr int BK = Cfg<D>::BK;
  const Smem<D>& sm;
  int wg, row0, col0, q0, sq, skv, causal;
  float scale_log2;
  float m[2] = {-INFINITY, -INFINITY};   // running max of the raw scores
  float l[2] = {0.f, 0.f};               // this thread's part of the row sum

  // Issue S = Q K^T on stage s: D / 16 steps of 16 along d; a step lies
  // inside one 128-byte swizzled row, so it advances the start address by
  // 32 bytes.  Committed as one group.
  __device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], int s) const {
    const uint32_t q_wg = sm.q + wg * 64 * kColBytes;
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      const int c = t / 4, kk = t % 4;
      Wgmma<BK>::ss(sc,
                    sw128_desc(q_wg + c * kBM * kColBytes + kk * 32, 16),
                    sw128_desc(sm.k_tile(s) + c * BK * kColBytes + kk * 32, 16),
                    t > 0);
    }
    hopper::wgmma_commit();
  }

  // Issue O += P_hi V + P_lo V on stage s: 16 keys a step, 8 keys of 128
  // bytes per 1024-byte atom, blocks of 64 d columns BK * 128 bytes apart.
  // Committed as one group.
  __device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                          const uint32_t (&p_hi)[BK / 16][4],
                                          const uint32_t (&p_lo)[BK / 16][4],
                                          int s) const {
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint64_t dv = sw128_desc(sm.v_tile(s) + kc * 16 * kColBytes,
                                     BK * kColBytes);
      Wgmma<D>::rs(acc, p_hi[kc], dv);
      Wgmma<D>::rs(acc, p_lo[kc], dv);
    }
    hopper::wgmma_commit();
  }

  // Key tile j's scores -> P in place (masked, max-subtracted,
  // exponentiated); updates the running max and sum and returns in alpha
  // the factor that rescales the accumulator.
  __device__ __forceinline__ void softmax(float (&sc)[BK / 2], int j,
                                         float (&alpha)[2]) {
    const int k0 = j * BK;
    if (k0 + BK > skv || (causal && k0 + BK - 1 > q0 + wg * 64)) {
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + 8 * jj + col0 + c;
            if (key >= skv || (causal && key > row0 + 8 * i))
              sc[4 * jj + 2 * i + c] = -INFINITY;
          }
    }
    // a row's 4 threads form a quad
    float mscaled[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
        mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * i], sc[4 * jj + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float use = mx == -INFINITY ? 0.f : mx;   // no key seen yet
      alpha[i] = exp2f((m[i] - use) * scale_log2);
      mscaled[i] = use * scale_log2;
      m[i] = mx;
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sc[4 * jj + 2 * i + c];
          x = exp2f(fmaf(x, scale_log2, -mscaled[i]));
          rowsum[i] += x;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rowsum[i];
  }
};

// P as A fragments, split into hi and lo: register r of step kc holds the
// pair p[8 kc + 2 r], p[8 kc + 2 r + 1].
template <int BK>
__device__ __forceinline__ void split_p(const float (&p)[BK / 2],
                                        uint32_t (&p_hi)[BK / 16][4],
                                        uint32_t (&p_lo)[BK / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = p[8 * kc + 2 * r], b = p[8 * kc + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
      p_hi[kc][r] = *reinterpret_cast<const uint32_t*>(&hi);
      p_lo[kc][r] = pack_bf16(a - __low2float(hi), b - __high2float(hi));
    }
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) acc[4 * jd + 2 * i + c] *= alpha[i];
}

// A consumer warpgroup: rows q0 + 64 wg .. + 63 of head bh.  Per key tile:
// S = Q K^T, the softmax on the CUDA cores, O += P V; the other consumer
// warpgroup's products run on the tensor cores meanwhile.  (Issuing tile
// j's Q K^T before tile j - 1's softmax, as FlashAttention-3 does within a
// warpgroup, measured slower on this kernel.)
template <int D>
__device__ __forceinline__ void consume(const Smem<D>& sm,
                                        __nv_bfloat16* __restrict__ o, int bh,
                                        int q0, int n_kv, int sq, int skv,
                                        int causal, float scale_log2) {
  constexpr int BK = Cfg<D>::BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Consumer<D> cs{sm, warp / 4, q0 + (warp / 4) * 64 + (warp % 4) * 16 +
                 lane / 4, 2 * (lane % 4), q0, sq, skv, causal, scale_log2};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  hopper::mbar_wait(sm.q_full(), 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    hopper::mbar_wait(sm.full(s), (j / kStages) & 1);
    float sc[BK / 2], alpha[2];
    hopper::wgmma_fence();
    cs.issue_qk(sc, s);
    hopper::wgmma_wait<0>();
    fence_regs(sc);
    cs.softmax(sc, j, alpha);
    rescale<D>(acc, alpha);
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
    split_p<BK>(sc, p_hi, p_lo);
    fence_regs(acc);
    hopper::wgmma_fence();
    cs.issue_pv(acc, p_hi, p_lo, s);
    hopper::wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(sm.empty(s));
  }

  // epilogue: the row sums across the quad, then O / l in bf16
  __nv_bfloat16* op = o + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = cs.l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = cs.row0 + 8 * i;
    if (row >= sq) continue;
    __nv_bfloat16* orow = op + static_cast<size_t>(row) * D + cs.col0;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jd) =
          __floats2bfloat162_rn(acc[4 * jd + 2 * i] * inv,
                                acc[4 * jd + 2 * i + 1] * inv);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ o, int group, int sq,
                             int skv, int causal, float scale_log2) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem<D> sm(hopper::smem_addr(smem_raw));
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;    // heaviest tiles first
  const int n_kv = kv_tiles(q0, skv, causal, Cfg<D>::BK);
  if (threadIdx.x == 0) {
    hopper::mbar_init(sm.q_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(sm.full(s), 1);
      hopper::mbar_init(sm.empty(s), kConsumerThreads / 32);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  // one branch per role, never rejoined (setmaxnreg needs it so)
  if (threadIdx.x >= kConsumerThreads) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads)
      produce<D>(sm, &tm_q, &tm_k, &tm_v, bh, bh / group, q0, n_kv);
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    consume<D>(sm, o, bh, q0, n_kv, sq, skv, causal, scale_log2);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// (heads, rows, d) bf16 -> tensor map of boxes (64 columns, box_rows rows,
// one head), 128-byte swizzled; rows past `rows` read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int heads, int rows, int d,
            int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int group, int sq, int skv, int causal, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode(&tm_q, q, bh, sq, D, kBM) ||
      !encode(&tm_k, k, bh / group, skv, D, C::BK) ||
      !encode(&tm_v, v, bh / group, skv, D, C::BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_wgmma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + kBM - 1) / kBM);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), group, sq, skv,
      causal, 1.4426950408889634f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q (bh, sq, d), k/v (bh / group, skv, d), all contiguous bf16 with 16-byte
// aligned bases, d in {64, 128, 256} -> o (bh, sq, d) bf16.  sq, skv >= 1.
REPRO_EXPORT int flash_attention_wgmma(const void* q, const void* k,
                                       const void* v, void* o, int bh,
                                       int group, int sq, int skv, int d,
                                       int causal, void* stream) {
  if (bh <= 0 || group <= 0 || bh % group || sq <= 0 || skv <= 0 ||
      (sq + tc::kBM - 1) / tc::kBM > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return tc::launch<64>(q, k, v, o, bh, group, sq, skv, causal, s);
    case 128: return tc::launch<128>(q, k, v, o, bh, group, sq, skv, causal, s);
    case 256: return tc::launch<256>(q, k, v, o, bh, group, sq, skv, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
