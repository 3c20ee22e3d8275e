// K4, K5, K6 and K4-mb: the fusion transformer's flash attention on Hopper
// (sm_90a). Non-causal (bidirectional) attention over (bh, n, d) tensors in
// fp32 or bf16, d in {32, 48, 64}; keys at or past seq_len are masked.
//
//   K4      o = softmax(q^ k^T) v and lse = logsumexp(q^ k^T), fp32 lse,
//           where q^ = (q * 1/sqrt(d)) rounded to q's type
//   K5      dq, dk, dv from one recompute of p per (key tile, q tile)
//   K6-dq   dq alone, streaming key tiles (deterministic)
//   K6-dkv  dk and dv, streaming q tiles (K5 without dq)
//   K4-mb   (q^ k^T cast to v's type) v, fp32 accumulation: K4's matrix
//           work without the softmax (the microbenchmark's kernel)
//
// Replaces muvo_tpu/ops/flash_attention.py: _flash_kernel via _flash_fwd
// (K4), _flash_bwd_fused_kernel via _flash_bwd_fused (K5),
// _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel via _flash_bwd (K6), and
// tools/pallas_smalld_microbench.py::_kernel (K4-mb). The numerics follow
// the Pallas kernels: q is scaled and rounded to its type before q k^T; p
// is cast to v's type before p v and the row sum l is taken from that cast
// p; lse = m + log(l) in fp32; masked keys score -1e30. In the backward p
// is cast to dO's type for dv, ds = p (dp - delta) to k's type for dq and
// dk, dk uses the scaled q with no further scale, and dq is scaled once at
// the end. delta = rowsum(dO * O) arrives precomputed (fp32). What the TPU
// needed and Hopper does not is left out: the 128-lane head-dim padding,
// the 512-row block multiple (these kernels mask the ragged tail
// themselves, so no caller pads), the lane-replicated statistics, and
// _FUSED_DQ_VMEM_BUDGET: K5 accumulates dq in an fp32 (bh, n, d) workspace
// in device memory with atomics, which has no length limit, and a last
// pass scales and casts it. The atomics make dq's summation order vary
// from run to run (K6 is deterministic).
//
// Bound on the card (bh 48, n 5184, d 48, bf16, the LARGE training step):
// K4 does 4 n^2 d bh = 2.5e11 flops on the tensor cores (0.25 ms at 989
// TFLOP/s) and n^2 bh = 1.3e9 exponentials on the SFUs (16 a clock per SM,
// 0.33 ms), so the exponentials bound it; K5 does 10 n^2 d bh flops and
// K6 14 n^2 d bh (s and dp twice) with one and two exps per score. In fp32
// the products run on the CUDA cores (67 TFLOP/s): TF32 would not hold
// the fp32 tolerance. Design, simple first: blocks of 8 warps over 64-row
// tiles; every tile (q^, k, v, dO, scores, p) is staged in shared memory,
// and each product of two tiles is one pass of a shared-memory GEMM whose
// fp32 result is accumulated in shared memory: in bf16 each warp runs
// mma.sync.m16n8k16 (fp32 accumulation) on a 16-row by N/2 column slice,
// in fp32 each thread accumulates a 4 x N/16 block with FMAs. The online
// softmax statistics (running max m, sum l) live in shared memory, one
// warp per 8 rows. Warp-specialised wgmma with TMA staging and the
// statistics in registers is the faster design for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 64;      // rows of every q and key tile
constexpr int kSS = kTile + 4;  // fp32 score tile stride
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__host__ __device__ constexpr bool is_f32() { return std::is_same<T, float>::value; }

// strides of the staged tiles: odd in fp32 (the scalar GEMM reads columns
// of (rows, d) tiles across threads), even in bf16 (32-bit fragment loads)
// and offset by 8 so a fragment's 8 rows fall on distinct banks
template <typename T, int D>
__host__ __device__ constexpr int tile_stride() { return is_f32<T>() ? D + 1 : D + 8; }
template <typename T>
__host__ __device__ constexpr int p_stride() { return is_f32<T>() ? kTile + 1 : kTile + 8; }
template <int D>
__host__ __device__ constexpr int acc_stride() { return D + 4; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two consecutive-k elements (k, k + 1) of row m of A, packed low first.
// A[m][k] lies at a[m * lda + k], or at a[k * lda + m] when A_T.
template <bool A_T>
__device__ __forceinline__ uint32_t frag_a(const __nv_bfloat16* a, int lda,
                                           int m, int k) {
  if (A_T) return pack2(a[k * lda + m], a[(k + 1) * lda + m]);
  return *reinterpret_cast<const uint32_t*>(a + m * lda + k);
}
// Two consecutive-k elements of column n of B. B[k][n] lies at
// b[n * ldb + k] when B_NK (a (rows, d) tile used as its transpose), else at
// b[k * ldb + n].
template <bool B_NK>
__device__ __forceinline__ uint32_t frag_b(const __nv_bfloat16* b, int ldb,
                                           int k, int n) {
  if (B_NK) return *reinterpret_cast<const uint32_t*>(b + n * ldb + k);
  return pack2(b[k * ldb + n], b[(k + 1) * ldb + n]);
}

// C[64 x N] = (accumulate ? C * row_scale : 0) + A[64 x K] B[K x N], C fp32
// in shared memory (row stride ldc), A and B staged tiles of T (layouts as
// frag_a / frag_b). row_scale (nullable) multiplies C's rows before the
// product is added (the online softmax's rescale). All threads take part;
// the caller synchronises before and after.
template <typename T, int N, int K, bool A_T, bool B_NK>
__device__ __forceinline__ void gemm(float* c, int ldc, const T* a, int lda,
                                     const T* b, int ldb, bool accumulate,
                                     const float* row_scale) {
  static_assert(N % 16 == 0 && K % 16 == 0, "tile widths are multiples of 16");
  const int tid = threadIdx.x;
  if constexpr (is_f32<T>()) {
    // each thread: rows 4 rg .. 4 rg + 3, columns cc + 16 j
    constexpr int NJ = N / 16;
    const int rg = tid >> 4, cc = tid & 15;
    float acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 4 * rg + i;
      const float s = accumulate ? (row_scale ? row_scale[m] : 1.f) : 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc[i][j] = accumulate ? c[m * ldc + cc + 16 * j] * s : 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[4], bv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 4 * rg + i;
        av[i] = A_T ? a[k * lda + m] : a[m * lda + k];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = cc + 16 * j;
        bv[j] = B_NK ? b[n * ldb + k] : b[k * ldb + n];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) c[(4 * rg + i) * ldc + cc + 16 * j] = acc[i][j];
  } else {
    // each warp: rows m0 .. m0 + 15, columns n0 .. n0 + N / 2 - 1 in
    // N / 16 mma tiles of 8 (fragment layouts of PTX's m16n8k16)
    constexpr int NJ = N / 16;
    const int lane = tid & 31, w = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int m0 = (w & 3) * 16, n0 = (w >> 2) * (N / 2);
    const int r0 = m0 + g, r1 = m0 + g + 8;
    float acc[NJ][4];
    const float s0 = accumulate ? (row_scale ? row_scale[r0] : 1.f) : 0.f;
    const float s1 = accumulate ? (row_scale ? row_scale[r1] : 1.f) : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      acc[j][0] = accumulate ? c[r0 * ldc + n] * s0 : 0.f;
      acc[j][1] = accumulate ? c[r0 * ldc + n + 1] * s0 : 0.f;
      acc[j][2] = accumulate ? c[r1 * ldc + n] * s1 : 0.f;
      acc[j][3] = accumulate ? c[r1 * ldc + n + 1] * s1 : 0.f;
    }
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      const uint32_t a0 = frag_a<A_T>(a, lda, r0, k0 + 2 * t);
      const uint32_t a1 = frag_a<A_T>(a, lda, r1, k0 + 2 * t);
      const uint32_t a2 = frag_a<A_T>(a, lda, r0, k0 + 8 + 2 * t);
      const uint32_t a3 = frag_a<A_T>(a, lda, r1, k0 + 8 + 2 * t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + 8 * j + g;
        const uint32_t b0 = frag_b<B_NK>(b, ldb, k0 + 2 * t, n);
        const uint32_t b1 = frag_b<B_NK>(b, ldb, k0 + 8 + 2 * t, n);
        mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      c[r0 * ldc + n] = acc[j][0];
      c[r0 * ldc + n + 1] = acc[j][1];
      c[r1 * ldc + n] = acc[j][2];
      c[r1 * ldc + n + 1] = acc[j][3];
    }
  }
}

// rows row0 .. row0 + 63 of a (bh, n, D) tensor into a staged tile, zero
// past n; SCALE multiplies by scale and rounds to T (q^)
template <typename T, int D, bool SCALE>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int row0, int n, float scale) {
  constexpr int TS = tile_stride<T, D>();
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int row = row0 + r;
    float v = row < n ? to_float(src[(size_t)row * D + c]) : 0.f;
    if (SCALE) v *= scale;
    dst[r * TS + c] = from_float<T>(v);
  }
}

// the scale as the Pallas kernels apply it: 1/sqrt(d) in q's type
template <typename T>
__device__ __forceinline__ float typed_scale(float scale) {
  return to_float(from_float<T>(scale));
}

template <typename T, int D>
struct FwdSmem {
  static constexpr int TS = tile_stride<T, D>(), PS = p_stride<T>(),
                       OS = acc_stride<D>();
  // fp32 buffers first, then the tiles of T (16-byte aligned offsets)
  static constexpr size_t s_off = 0;
  static constexpr size_t o_off = s_off + sizeof(float) * kTile * kSS;
  static constexpr size_t stat_off = o_off + sizeof(float) * kTile * OS;
  static constexpr size_t q_off = stat_off + sizeof(float) * 3 * kTile;
  static constexpr size_t k_off = q_off + ((sizeof(T) * kTile * TS + 15) & ~15);
  static constexpr size_t v_off = k_off + ((sizeof(T) * kTile * TS + 15) & ~15);
  static constexpr size_t p_off = v_off + ((sizeof(T) * kTile * TS + 15) & ~15);
  static constexpr size_t bytes = p_off + ((sizeof(T) * kTile * PS + 15) & ~15);
};

// K4 (SOFTMAX) and K4-mb: one block per (64-row q tile, bh).
template <typename T, int D, bool SOFTMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int n, int seq_len,
                     float scale) {
  using L = FwdSmem<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem + L::s_off);
  float* O = reinterpret_cast<float*>(smem + L::o_off);
  float* m = reinterpret_cast<float*>(smem + L::stat_off);
  float* l = m + kTile;
  float* alpha = l + kTile;
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  T* Ps = reinterpret_cast<T*>(smem + L::p_off);

  const int q0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * n * D;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  stage<T, D, true>(Qs, q + base, q0, n, typed_scale<T>(scale));
  if (tid < kTile) {
    m[tid] = kNegInf;
    l[tid] = 0.f;
  }
  const int kv_end = SOFTMAX ? seq_len : n;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage<T, D, false>(Ks, k + base, k0, n, 0.f);
    stage<T, D, false>(Vs, v + base, k0, n, 0.f);
    __syncthreads();
    gemm<T, kTile, D, false, true>(S, kSS, Qs, L::TS, Ks, L::TS, false,
                                   nullptr);
    __syncthreads();
    if (SOFTMAX) {
      // warp w: rows 8 w .. 8 w + 7; lane: keys lane, lane + 32
      for (int rr = 0; rr < 8; ++rr) {
        const int r = 8 * w + rr;
        float s0 = S[r * kSS + lane], s1 = S[r * kSS + lane + 32];
        if (k0 + lane >= seq_len) s0 = kNegInf;
        if (k0 + lane + 32 >= seq_len) s1 = kNegInf;
        const float m_prev = m[r];
        const float m_next = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
        const T p0 = from_float<T>(expf(s0 - m_next));
        const T p1 = from_float<T>(expf(s1 - m_next));
        Ps[r * L::PS + lane] = p0;
        Ps[r * L::PS + lane + 32] = p1;
        const float sum = warp_sum(to_float(p0) + to_float(p1));
        __syncwarp();
        if (lane == 0) {
          const float a = expf(m_prev - m_next);
          alpha[r] = a;
          l[r] = a * l[r] + sum;
          m[r] = m_next;
        }
      }
    } else {
      for (int i = tid; i < kTile * kTile; i += kThreads) {
        const int r = i >> 6, c = i & 63;
        Ps[r * L::PS + c] = from_float<T>(S[r * kSS + c]);
      }
    }
    __syncthreads();
    // O = alpha O + P V (K4-mb: O += P V)
    gemm<T, D, kTile, false, false>(O, L::OS, Ps, L::PS, Vs, L::TS, k0 > 0,
                                    SOFTMAX ? alpha : nullptr);
  }
  __syncthreads();
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int row = q0 + r;
    if (row < n) {
      const float val = SOFTMAX ? O[r * L::OS + c] / l[r] : O[r * L::OS + c];
      o[base + (size_t)row * D + c] = from_float<T>(val);
    }
  }
  if (SOFTMAX && tid < kTile && q0 + tid < n)
    lse[(size_t)blockIdx.y * n + q0 + tid] = m[tid] + logf(l[tid]);
}

template <typename T, int D>
struct BwdSmem {
  static constexpr int TS = tile_stride<T, D>(), PS = p_stride<T>(),
                       OS = acc_stride<D>();
  static constexpr size_t tile = (sizeof(T) * kTile * TS + 15) & ~15;
  static constexpr size_t ptile = (sizeof(T) * kTile * PS + 15) & ~15;
  static constexpr size_t s_off = 0;  // scores, then p (and K5's dq tile)
  static constexpr size_t dp_off = s_off + sizeof(float) * kTile * kSS;
  static constexpr size_t acc1_off = dp_off + sizeof(float) * kTile * kSS;
  static constexpr size_t acc2_off = acc1_off + sizeof(float) * kTile * OS;
  static constexpr size_t row_off = acc2_off + sizeof(float) * kTile * OS;
  static constexpr size_t q_off = row_off + sizeof(float) * 2 * kTile;
  static constexpr size_t do_off = q_off + tile;
  static constexpr size_t k_off = do_off + tile;
  static constexpr size_t v_off = k_off + tile;
  static constexpr size_t pc_off = v_off + tile;
  static constexpr size_t ds_off = pc_off + ptile;
  static constexpr size_t bytes = ds_off + ptile;
};

// The shared step of every backward kernel, for one (q tile, key tile)
// pair already staged: S = q^ k^T, dP = dO v^T, then p = exp(S - lse)
// (zero for masked keys and q rows past n) cast to T in Pc and
// ds = p (dP - delta) cast to T in dSc.
template <typename T, int D>
__device__ __forceinline__ void scores_and_ds(unsigned char* smem, int q0,
                                              int k0, int n, int seq_len) {
  using L = BwdSmem<T, D>;
  float* S = reinterpret_cast<float*>(smem + L::s_off);
  float* dP = reinterpret_cast<float*>(smem + L::dp_off);
  const float* lse_s = reinterpret_cast<const float*>(smem + L::row_off);
  const float* delta_s = lse_s + kTile;
  const T* Qs = reinterpret_cast<const T*>(smem + L::q_off);
  const T* dOs = reinterpret_cast<const T*>(smem + L::do_off);
  const T* Ks = reinterpret_cast<const T*>(smem + L::k_off);
  const T* Vs = reinterpret_cast<const T*>(smem + L::v_off);
  T* Pc = reinterpret_cast<T*>(smem + L::pc_off);
  T* dSc = reinterpret_cast<T*>(smem + L::ds_off);
  gemm<T, kTile, D, false, true>(S, kSS, Qs, L::TS, Ks, L::TS, false, nullptr);
  gemm<T, kTile, D, false, true>(dP, kSS, dOs, L::TS, Vs, L::TS, false,
                                 nullptr);
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i >> 6, c = i & 63;
    const bool valid = q0 + r < n && k0 + c < seq_len;
    const float p = valid ? expf(S[r * kSS + c] - lse_s[r]) : 0.f;
    const float ds = p * (dP[r * kSS + c] - delta_s[r]);
    Pc[r * L::PS + c] = from_float<T>(p);
    dSc[r * L::PS + c] = from_float<T>(ds);
  }
  __syncthreads();
}

template <typename T, int D>
__device__ __forceinline__ void stage_q_side(unsigned char* smem, const T* q,
                                             const T* dout, const float* lse,
                                             const float* delta, int q0, int n,
                                             float scale) {
  using L = BwdSmem<T, D>;
  float* lse_s = reinterpret_cast<float*>(smem + L::row_off);
  float* delta_s = lse_s + kTile;
  stage<T, D, true>(reinterpret_cast<T*>(smem + L::q_off), q, q0, n,
                    typed_scale<T>(scale));
  stage<T, D, false>(reinterpret_cast<T*>(smem + L::do_off), dout, q0, n, 0.f);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < n ? lse[row] : 0.f;
    delta_s[threadIdx.x] = row < n ? delta[row] : 0.f;
  }
}

// K5 (FUSED) and K6-dkv: one block per (64-key tile, bh), holding k, v and
// the dk, dv accumulators while it walks every q tile. K5 adds each q tile's
// share of dq, ds k, into the fp32 workspace dq_acc with atomics.
template <typename T, int D, bool FUSED>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, float* __restrict__ dq_acc, int n,
                        int seq_len, float scale) {
  using L = BwdSmem<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem + L::s_off);
  float* dK = reinterpret_cast<float*>(smem + L::acc1_off);
  float* dV = reinterpret_cast<float*>(smem + L::acc2_off);
  const T* Qs = reinterpret_cast<const T*>(smem + L::q_off);
  const T* dOs = reinterpret_cast<const T*>(smem + L::do_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  const T* Pc = reinterpret_cast<const T*>(smem + L::pc_off);
  const T* dSc = reinterpret_cast<const T*>(smem + L::ds_off);

  const int k0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const size_t base = bh * n * D;
  const int tid = threadIdx.x;
  for (int i = tid; i < kTile * L::OS; i += kThreads) dK[i] = dV[i] = 0.f;
  if (k0 < seq_len) {  // a tile of masked keys only has zero gradients
    stage<T, D, false>(Ks, k + base, k0, n, 0.f);
    stage<T, D, false>(Vs, v + base, k0, n, 0.f);
    for (int q0 = 0; q0 < n; q0 += kTile) {
      __syncthreads();  // the previous q tile is consumed
      stage_q_side<T, D>(smem, q + base, dout + base, lse + bh * n,
                         delta + bh * n, q0, n, scale);
      __syncthreads();
      scores_and_ds<T, D>(smem, q0, k0, n, seq_len);
      // dv += Pc^T dO, dk += dSc^T q^ (rows: keys)
      gemm<T, D, kTile, true, false>(dV, L::OS, Pc, L::PS, dOs, L::TS, true,
                                     nullptr);
      gemm<T, D, kTile, true, false>(dK, L::OS, dSc, L::PS, Qs, L::TS, true,
                                     nullptr);
      if (FUSED) {
        // this q tile's dq share, dSc k, through the free score buffer
        gemm<T, D, kTile, false, false>(S, kSS, dSc, L::PS, Ks, L::TS, false,
                                        nullptr);
        __syncthreads();
        for (int i = tid; i < kTile * D; i += kThreads) {
          const int r = i / D, c = i - r * D;
          if (q0 + r < n)
            atomicAdd(dq_acc + base + (size_t)(q0 + r) * D + c, S[r * kSS + c]);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int row = k0 + r;
    if (row < n) {
      dk[base + (size_t)row * D + c] = from_float<T>(dK[r * L::OS + c]);
      dv[base + (size_t)row * D + c] = from_float<T>(dV[r * L::OS + c]);
    }
  }
}

// K6-dq: one block per (64-row q tile, bh), walking the key tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int n, int seq_len, float scale) {
  using L = BwdSmem<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* dQ = reinterpret_cast<float*>(smem + L::acc1_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  const T* dSc = reinterpret_cast<const T*>(smem + L::ds_off);

  const int q0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const size_t base = bh * n * D;
  const int tid = threadIdx.x;
  stage_q_side<T, D>(smem, q + base, dout + base, lse + bh * n, delta + bh * n,
                     q0, n, scale);
  for (int k0 = 0; k0 < seq_len; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed
    stage<T, D, false>(Ks, k + base, k0, n, 0.f);
    stage<T, D, false>(Vs, v + base, k0, n, 0.f);
    __syncthreads();
    scores_and_ds<T, D>(smem, q0, k0, n, seq_len);
    gemm<T, D, kTile, false, false>(dQ, L::OS, dSc, L::PS, Ks, L::TS, k0 > 0,
                                    nullptr);
  }
  __syncthreads();
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    if (q0 + r < n)
      dq[base + (size_t)(q0 + r) * D + c] = from_float<T>(dQ[r * L::OS + c] * scale);
  }
}

// K5's last pass: dq = (dq_acc * scale) in T
template <typename T>
__global__ void flash_dq_flush_kernel(const float* __restrict__ dq_acc,
                                      T* __restrict__ dq, size_t count,
                                      float scale) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x)
    dq[i] = from_float<T>(dq_acc[i] * scale);
}

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline dim3 grid_of(int bh, int n) { return dim3((n + kTile - 1) / kTile, bh); }

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int n, int seq_len, float scale,
                bool softmax, cudaStream_t st) {
  const size_t bytes = FwdSmem<T, D>::bytes;
  auto kernel = softmax ? flash_fwd_kernel<T, D, true>
                        : flash_fwd_kernel<T, D, false>;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(bh, n), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n, seq_len, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_kv(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, float* dq_acc, int bh, int n,
                   int seq_len, float scale, cudaStream_t st) {
  const size_t bytes = BwdSmem<T, D>::bytes;
  auto kernel = dq_acc != nullptr ? flash_bwd_kv_kernel<T, D, true>
                                  : flash_bwd_kv_kernel<T, D, false>;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(bh, n), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), dq_acc, n, seq_len, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int bh, int n, int seq_len, float scale,
                   cudaStream_t st) {
  const size_t bytes = BwdSmem<T, D>::bytes;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(bh, n), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), n, seq_len, scale);
  return cudaGetLastError();
}

// K5: zero the dq workspace, the fused kernel, then dq = dq_acc * scale
template <typename T, int D>
cudaError_t bwd_fused(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, float* dq_acc, int bh,
                      int n, int seq_len, float scale, cudaStream_t st) {
  const size_t count = (size_t)bh * n * D;
  cudaError_t err = cudaMemsetAsync(dq_acc, 0, count * sizeof(float), st);
  if (err != cudaSuccess) return err;
  err = bwd_kv<T, D>(q, k, v, dout, lse, delta, dk, dv, dq_acc, bh, n,
                     seq_len, scale, st);
  if (err != cudaSuccess) return err;
  const size_t blocks = (count + 255) / 256;
  flash_dq_flush_kernel<T><<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      dq_acc, static_cast<T*>(dq), count, scale);
  return cudaGetLastError();
}

bool bad_args(int bh, int n, int d, int seq_len, int dtype) {
  return bh < 1 || bh > 65535 || n < 1 || seq_len < 1 || seq_len > n ||
         (d != 32 && d != 48 && d != 64) || (dtype != 0 && dtype != 1);
}

// dispatch on (dtype, d) to F<T, D>(args...)
#define MUVO_FLASH_DISPATCH(F, ...)                                        \
  do {                                                                     \
    if (dtype == 0) {                                                      \
      if (d == 32) return (int)F<float, 32>(__VA_ARGS__);                  \
      if (d == 48) return (int)F<float, 48>(__VA_ARGS__);                  \
      return (int)F<float, 64>(__VA_ARGS__);                               \
    }                                                                      \
    if (d == 32) return (int)F<__nv_bfloat16, 32>(__VA_ARGS__);            \
    if (d == 48) return (int)F<__nv_bfloat16, 48>(__VA_ARGS__);            \
    return (int)F<__nv_bfloat16, 64>(__VA_ARGS__);                         \
  } while (0)

}  // namespace

// K4 (softmax = 1) or K4-mb (softmax = 0, lse unused, every key counted).
// q, k, v, o: (bh, n, d) contiguous, dtype 0 = fp32, 1 = bf16; lse: (bh, n)
// fp32. scale is 1/sqrt(d).
extern "C" int muvo_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int bh, int n, int d,
                              int seq_len, float scale, int softmax, int dtype,
                              void* stream) {
  if (bad_args(bh, n, d, seq_len, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MUVO_FLASH_DISPATCH(fwd, q, k, v, o, lse, bh, n, seq_len, scale,
                      softmax != 0, st);
}

// K5: dq, dk, dv. dq_acc is an fp32 (bh, n, d) workspace, zeroed here;
// delta = rowsum(dO * O), (bh, n) fp32.
extern "C" int muvo_flash_bwd_fused(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dq, void* dk, void* dv,
                                    float* dq_acc, int bh, int n, int d,
                                    int seq_len, float scale, int dtype,
                                    void* stream) {
  if (bad_args(bh, n, d, seq_len, dtype) || dq_acc == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MUVO_FLASH_DISPATCH(bwd_fused, q, k, v, dout, lse, delta, dq, dk, dv,
                      dq_acc, bh, n, seq_len, scale, st);
}

// K6-dq: dq alone.
extern "C" int muvo_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, int bh, int n,
                                 int d, int seq_len, float scale, int dtype,
                                 void* stream) {
  if (bad_args(bh, n, d, seq_len, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MUVO_FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, bh, n, seq_len,
                      scale, st);
}

// K6-dkv: dk and dv.
extern "C" int muvo_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  int bh, int n, int d, int seq_len,
                                  float scale, int dtype, void* stream) {
  if (bad_args(bh, n, d, seq_len, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MUVO_FLASH_DISPATCH(bwd_kv, q, k, v, dout, lse, delta, dk, dv,
                      static_cast<float*>(nullptr), bh, n, seq_len, scale, st);
}

extern "C" const char* muvo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
