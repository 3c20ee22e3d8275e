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
// from run to run (K6 is deterministic: a second launch gives the same
// bits).
//
// Bound on the card (bh 48, n 5184, d 48, bf16, the LARGE training step):
// K4 does 4 n^2 d bh = 2.5e11 flops on the tensor cores (0.25 ms at 989
// TFLOP/s) and n^2 bh = 1.3e9 exponentials on the SFUs (16 a clock per SM,
// 0.31 ms), so the exponentials bound it; K5 does 10 n^2 d bh flops, K6-dq
// 6 and K6-dkv 8 (s and dp recomputed in both), each with one exponential
// per score: the products bound them (0.63, 0.38 and 0.50 ms). In fp32 the
// products run on the CUDA cores (67 TFLOP/s: 3.7 ms for K4, 5.5 for
// K6-dq): TF32 would not hold the fp32 tolerance, nor the plain version's
// bits that fp32 K5, K6-dq and K6-dkv keep.
//
// Designs. bf16 K4, K4-mb, K5, K6-dq and K6-dkv (namespace hopper) are
// warp-specialised: one producer thread keeps tiles in flight by TMA into
// a two-stage ring of shared memory with mbarriers, two consumer
// warpgroups run wgmma with the fp32 accumulators in registers, and the
// softmax (K4) or p and ds (K5, K6) are formed in registers and fed to the
// next product as its register A operand. K5 and K6-dkv are one kernel,
// flash_bwd_wgmma<D, DQ>, key-major: in K5 (DQ) both consumers put their
// halves of a q tile's dS^T into one of two shared buffers, and the q
// tiles' dq alternate between the consumers: tile t's owner, consumer
// t % 2, computes its dq over all 128 keys of the block by a third product
// and adds it to an fp32 workspace by vector atomics, one per two columns
// of a 64 x d tile, while the other consumer only arrives on a barrier and
// goes on to its next tile. No partial dq is handed over, and the
// consumers are not held in lockstep. K6-dkv (no DQ) does K5's dk and dv
// products in K5's order, so its dk and dv equal K5's bit for bit. K6-dq,
// flash_bwd_dq_wgmma<D>, is q-major on K4's skeleton and keeps dq in
// registers. What bounds them now is the serial chain inside each consumer
// (product, wait, softmax or ds, product): no elementwise work of a
// consumer overlaps its own products, and K5 adds the atomics' L2 traffic
// and the owner's wait for the other half of dS^T. fp32 K4 and K4-mb
// (namespace fp32) hold register micro-tiles of S and O on the CUDA cores,
// FMA-bound. fp32 K5 and K6-dkv are one key-major template there,
// flash_bwd_kv_f32<D, FUSED>: register micro-tiles of S, dP, dK and dV (and
// K5's dq share), each element one fmaf chain in the plain version's order,
// so dk and dv keep its bits. fp32 K6-dq, flash_bwd_q_f32<D>, is the same
// micro-tiles with the loop roles swapped: q-major, the key tiles
// streaming, dq in registers over all of them in the plain version's order
// too.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

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

// K5's last pass: dq = (dq_acc * scale) in T
template <typename T>
__global__ void flash_dq_flush_kernel(const float* __restrict__ dq_acc,
                                      T* __restrict__ dq, size_t count,
                                      float scale) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x)
    dq[i] = from_float<T>(dq_acc[i] * scale);
}

// ---------------------------------------------------------------------------
// bf16 K4, K4-mb, K5 and K6 on Hopper: TMA staging into a shared-memory ring
// fed by one producer thread, wgmma with fp32 accumulators in registers,
// the softmax in registers. Tiles are 64 bf16 (128 bytes) wide in the 128-
// byte swizzle that TMA writes and wgmma reads; the tensor maps zero-fill
// the columns past d and the rows past n of each bh, so products over the
// padded width are exact, and q k^T runs over d only (d / 16 k-steps).
// ---------------------------------------------------------------------------
namespace hopper {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 384;    // a producer warpgroup, two consumer ones
constexpr int kRowBytes = 128;   // one staged row: 64 bf16, swizzled
constexpr int kStages = 2;       // depth of the ring
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (++spins == (1u << 28)) __trap();  // a lost arrival: fail, do not hang
  } while (!done);
}
// a (64, rows, 1) box of a (d, n, bh) tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(row), "r"(bh)
      : "memory");
}
// shared-memory writes of this thread become visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
template <int R>
__device__ __forceinline__ void set_max_regs() {
  if constexpr (R < 128)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
// wgmma descriptor of a tile of 128-byte rows in the 128-byte swizzle,
// 1024-byte aligned: 8-row groups 1024 bytes apart (SBO), the leading
// offset unused (a K-major operand's k16 slice and an M/N-major operand's
// 64 columns both lie inside one swizzle atom). A K-major operand steps
// through k by 32 bytes (+2), an M/N-major one by 16 rows (+128).
__device__ __forceinline__ uint64_t desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
constexpr uint64_t kStepK = 2, kStepRows = 128;
// byte offset of element (row, col) in a swizzled tile of 128-byte rows
__device__ __forceinline__ int swz(int row, int col) {
  return row * kRowBytes + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// K4 (SOFTMAX) and K4-mb: one block per (128 q rows, bh). Consumer c owns
// q rows 64 c .. 64 c + 63: S = q^ k^T (m64n128, 128 keys a tile) and
// O += P V (m64nD, P as the register A operand) stay in registers, with
// the running max m and sum l of its two rows a thread.
struct FwdLayout {
  static constexpr int q = 0;                            // 128 rows
  static constexpr int k = q + 128 * kRowBytes;          // kStages x 128
  static constexpr int v = k + kStages * 128 * kRowBytes;
  static constexpr int bars = v + kStages * 128 * kRowBytes;
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, bool SOFTMAX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     bf16* __restrict__ o, float* __restrict__ lse, int n,
                     int seq_len, float scale) {
  using L = FwdLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  const int bh = blockIdx.y, q0 = blockIdx.x * 128;
  const int kv_end = SOFTMAX ? seq_len : n;
  const int tiles = (kv_end + 127) / 128;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    set_max_regs<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 128 * kRowBytes);
      tma_load(smem + L::q, &tm_q, q_full, q0, bh);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * 128 * kRowBytes);
        tma_load(smem + L::k + s * 128 * kRowBytes, &tm_k, &full[s], t * 128, bh);
        tma_load(smem + L::v + s * 128 * kRowBytes, &tm_v, &full[s], t * 128, bh);
      }
    }
    return;
  }
  set_max_regs<240>();
  const int c = wg - 1, lt = threadIdx.x - 128 * wg;
  const int warp = lt >> 5, lane = lt & 31, g = lane >> 2, t4 = lane & 3;
  unsigned char* qs = smem + L::q + c * 64 * kRowBytes;
  // q^ = q * scale rounded to bf16, in place, once
  mbar_wait(q_full, 0);
  {
    const float sc = __bfloat162float(__float2bfloat16(scale));
    uint32_t* p = reinterpret_cast<uint32_t*>(qs);
    for (int i = lt; i < 64 * kRowBytes / 4; i += 128) {
      const float2 f = unpack(p[i]);
      p[i] = bf16x2(f.x * sc, f.y * sc);
    }
    fence_proxy_async();
    named_sync(1 + c, 128);
  }
  const uint64_t q_desc = desc(qs);
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    float sacc[64];
    const uint64_t dk = desc(smem + L::k + s * 128 * kRowBytes);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma::wgmma_ss<128, 0, 0>(sacc, q_desc + kk * kStepK, dk + kk * kStepK, kk);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(sacc);
    uint32_t pa[8][4];  // P as eight k16 A fragments
    const int k0 = t * 128;
    if (SOFTMAX) {
      if (k0 + 128 > seq_len) {  // the last tile: mask keys past seq_len
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int key = k0 + 8 * i + 2 * t4;
          if (key >= seq_len) sacc[4 * i] = sacc[4 * i + 2] = kNegInf;
          if (key + 1 >= seq_len) sacc[4 * i + 1] = sacc[4 * i + 3] = kNegInf;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * i], sacc[4 * i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
      }
      float alpha[2], mb[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        mb[r] = mx[r] * kLog2e;
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j, r = j & 1;
          pa[kk][j] = bf16x2(ex2(fmaf(sacc[i], kLog2e, -mb[r])),
                             ex2(fmaf(sacc[i + 1], kLog2e, -mb[r])));
          const float2 p = unpack(pa[kk][j]);  // l sums the rounded p
          sum[r] += p.x + p.y;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        oacc[4 * i] *= alpha[0];
        oacc[4 * i + 1] *= alpha[0];
        oacc[4 * i + 2] *= alpha[1];
        oacc[4 * i + 3] *= alpha[1];
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = bf16x2(sacc[8 * kk + 2 * j], sacc[8 * kk + 2 * j + 1]);
    }
    const uint64_t dv = desc(smem + L::v + s * 128 * kRowBytes);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma::wgmma_rs<D, 1>(oacc, pa[kk], dv + kk * kStepRows, 1);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(oacc);
    wgmma::fence_operands(pa);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  const size_t base = (size_t)bh * n * D;
  const int row0 = q0 + 64 * c + 16 * warp + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float inv = 1.f;
    if (SOFTMAX) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      inv = 1.f / lr;
      if (t4 == 0 && row < n) lse[(size_t)bh * n + row] = m[r] + logf(lr);
    }
    if (row < n) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(o + base + (size_t)row * D + 8 * i + 2 * t4) =
            bf16x2(oacc[4 * i + 2 * r] * inv, oacc[4 * i + 2 * r + 1] * inv);
    }
  }
}

// K5 (DQ) and K6-dkv: one block per (128 keys, bh), consumer c holding keys
// 64 c .. 64 c + 63 with dk, dv in registers, walking 64-row q tiles that
// TMA streams through the ring (q^, dO; lse and delta stored by the
// producer warp). S^T = k q^T and dP^T = v dO^T (m64n64); P^T and dS^T are
// formed in registers and feed dv += P^T dO and dk += dS^T q^ as register
// A operands. With DQ, each consumer also writes its 64-key half of dS^T
// into buffer t % 2 of shared memory, and consumer t % 2 owns q tile t's
// dq: over all 128 keys, dS k (m64nD, K 128, both operands M/N-major, B
// the block's whole k tile), added to the fp32 workspace by vector atomics
// (one per two columns). Only the other consumer gives way, by named
// barriers of 256: it arrives on kDsFull + b when its half of buffer b is
// written, and before writing buffer b again two tiles later it waits on
// kDsFree + b, which the owner arrives on once its product has read the
// buffer; the owner waits on kDsFull + b alone. So buffer b always belongs
// to consumer b, and the TMA ring bounds how far the two drift apart.
// Without DQ all of that is compiled out and dk, dv come from the same
// products in the same order. The layout keeps both buffers either way:
// one block an SM (384 threads of 168 registers fill the register file),
// so the 32 KB K6-dkv leaves unused cost nothing.
struct BwdLayout {
  static constexpr int k = 0;                        // 128 keys
  static constexpr int v = k + 128 * kRowBytes;
  static constexpr int ds = v + 128 * kRowBytes;     // 2 x dS^T, 128 keys x 64 q
  static constexpr int q = ds + 2 * 128 * kRowBytes; // kStages x 64 rows
  static constexpr int dout = q + kStages * 64 * kRowBytes;
  static constexpr int stats = dout + kStages * 64 * kRowBytes;  // kStages x (lse, delta)
  static constexpr int bars = stats + kStages * 128 * 4;
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};
// named barriers of K5's dS^T buffers (b = 0, 1; barrier 0 is
// __syncthreads): kDsFull + b, both halves of buffer b written;
// kDsFree + b, the owner's product has read buffer b
constexpr int kDsFull = 5, kDsFree = 7;
// the registers of the owner's dq tile: at d 64 those of S^T, free once
// P^T and dS^T are formed and the same 32 floats a thread. With a block of
// its own, ptxas spills dk at the 168 registers a thread of 384 gets and
// serializes every wgmma of the kernel (C7512): 4.3 ms against 2.9 on an
// H100 at (48, 5184, 64)
template <int D>
__device__ __forceinline__ float (&dq_regs(float (&s)[32], float (&own)[D / 2]))[D / 2] {
  if constexpr (D == 64)
    return s;
  else
    return own;
}

template <int D, bool DQ>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, float* __restrict__ dq_acc, int n,
                     int seq_len) {
  using L = BwdLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  float* stats = reinterpret_cast<float*>(smem + L::stats);
  const int bh = blockIdx.y, k0 = blockIdx.x * 128;
  const int tiles = (n + 63) / 64;
  const bool active = k0 < seq_len;  // a tile of masked keys has zero grads
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp
      mbar_init(&empty[s], 8);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: warp 0
    set_max_regs<24>();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 32 && active) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * 128 * kRowBytes);
        tma_load(smem + L::k, &tm_k, kv_full, k0, bh);
        tma_load(smem + L::v, &tm_v, kv_full, k0, bh);
      }
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kStages, q0 = t * 64;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        float* st = stats + s * 128;
        for (int j = lane; j < 64; j += 32) {
          const bool in = q0 + j < n;
          st[j] = in ? lse[(size_t)bh * n + q0 + j] : 0.f;
          st[64 + j] = in ? delta[(size_t)bh * n + q0 + j] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * 64 * kRowBytes);
          tma_load(smem + L::q + s * 64 * kRowBytes, &tm_q, &full[s], q0, bh);
          tma_load(smem + L::dout + s * 64 * kRowBytes, &tm_do, &full[s], q0, bh);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }
  set_max_regs<240>();
  const int c = wg - 1, lt = threadIdx.x - 128 * wg;
  const int warp = lt >> 5, lane = lt & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's rows: r0, r0 + 8
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  const size_t base = (size_t)bh * n * D;
  if (active) {
    mbar_wait(kv_full, 0);
    const uint64_t dk_desc = desc(smem + L::k + c * 64 * kRowBytes);
    const uint64_t dv_desc = desc(smem + L::v + c * 64 * kRowBytes);
    [[maybe_unused]] const uint64_t k_desc = desc(smem + L::k);  // all 128 keys
    const bool masked[2] = {k0 + 64 * c + r0 >= seq_len,
                            k0 + 64 * c + r0 + 8 >= seq_len};
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kStages, q0 = t * 64;
      // DQ: tile t's dS^T goes to buffer b, and consumer b owns its dq
      [[maybe_unused]] const int b = t & 1;
      [[maybe_unused]] const bool own = b == c;
      [[maybe_unused]] unsigned char* ds_buf = smem + L::ds + b * 128 * kRowBytes;
      mbar_wait(&full[s], (t / kStages) & 1);
      const uint64_t q_desc = desc(smem + L::q + s * 64 * kRowBytes);
      const uint64_t do_desc = desc(smem + L::dout + s * 64 * kRowBytes);
      float sacc[32], dpacc[32];
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma::wgmma_ss<64, 0, 0>(sacc, dk_desc + kk * kStepK,
                                  q_desc + kk * kStepK, kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma::wgmma_ss<64, 0, 0>(dpacc, dv_desc + kk * kStepK,
                                  do_desc + kk * kStepK, kk);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_operands(sacc);
      wgmma::fence_operands(dpacc);
      const float* st = stats + s * 128;
      uint32_t pa[4][4], da[4][4];  // P^T, dS^T as k16 A fragments (k: q)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j, r = j & 1, chunk = 2 * kk + (j >> 1);
          const int col = 8 * chunk + 2 * t4;
          const float2 ls = *reinterpret_cast<const float2*>(st + col);
          const float2 dl = *reinterpret_cast<const float2*>(st + 64 + col);
          const float p0 = masked[r] ? 0.f : ex2((sacc[i] - ls.x) * kLog2e);
          const float p1 = masked[r] ? 0.f : ex2((sacc[i + 1] - ls.y) * kLog2e);
          pa[kk][j] = bf16x2(p0, p1);
          da[kk][j] = bf16x2(p0 * (dpacc[i] - dl.x), p1 * (dpacc[i + 1] - dl.y));
        }
      if constexpr (DQ) {
        // the owner's product of two tiles ago has read this buffer
        if (!own && t >= 2) named_sync(kDsFree + b, 256);
        unsigned char* my_half = ds_buf + c * 64 * kRowBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 16 * kk + 8 * (j >> 1) + 2 * t4;  // as above
            *reinterpret_cast<uint32_t*>(my_half + swz(r0 + 8 * (j & 1), col)) =
                da[kk][j];
          }
        fence_proxy_async();
        if (!own) named_arrive(kDsFull + b, 256);
      }
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma::wgmma_rs<D, 1>(dva, pa[kk], do_desc + kk * kStepRows, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma::wgmma_rs<D, 1>(dka, da[kk], q_desc + kk * kStepRows, 1);
      wgmma::commit();
      [[maybe_unused]] float dq_own[D / 2];
      [[maybe_unused]] float (&dqa)[D / 2] = dq_regs<D>(sacc, dq_own);
      if constexpr (DQ) {
        if (own) {
          // both halves are in the buffer (the barrier of 256 also orders
          // this consumer's own writes): dq of the tile over all 128 keys
          named_sync(kDsFull + b, 256);
          const uint64_t ds_desc = desc(ds_buf);
          wgmma::fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            wgmma::wgmma_ss<D, 1, 1>(dqa, ds_desc + kk * kStepRows,
                                     k_desc + kk * kStepRows, kk);
          wgmma::commit();
        }
      }
      wgmma::wait<0>();
      wgmma::fence_operands(dva);
      wgmma::fence_operands(dka);
      wgmma::fence_operands(pa);
      wgmma::fence_operands(da);
      if (lane == 0) mbar_arrive(&empty[s]);
      if constexpr (DQ) {
        if (own) {
          wgmma::fence_operands(dqa);
          // the other consumer writes this buffer again at tile t + 2
          if (t + 2 < tiles) named_arrive(kDsFree + b, 256);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = q0 + r0 + 8 * r;
            if (row < n) {
              float* dst = dq_acc + base + (size_t)row * D + 2 * t4;
#pragma unroll
              for (int i = 0; i < D / 8; ++i)
                atomicAdd(reinterpret_cast<float2*>(dst + 8 * i),
                          make_float2(dqa[4 * i + 2 * r], dqa[4 * i + 2 * r + 1]));
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + 64 * c + r0 + 8 * r;
    if (row < n) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const size_t at = base + (size_t)row * D + 8 * i + 2 * t4;
        *reinterpret_cast<uint32_t*>(dk + at) =
            bf16x2(dka[4 * i + 2 * r], dka[4 * i + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + at) =
            bf16x2(dva[4 * i + 2 * r], dva[4 * i + 2 * r + 1]);
      }
    }
  }
}

// K6-dq: one block per (128 q rows, bh), K4's skeleton. The producer loads
// q and dO for the block's rows once and streams 128-key tiles of k and v
// through the ring. Consumer c owns q rows 64 c .. 64 c + 63, forms q^ in
// shared memory as K4 does (so neither dq nor a scratch holds it), reads
// the lse and delta of its two rows a thread once, and takes each key tile
// in two halves of 64 keys: S = q^ k^T and dP = dO v^T (m64n64, both
// operands K-major), P = exp(S - lse) (zero at keys past seq_len, not
// rounded), dS = P (dP - delta) rounded to bf16 as register A fragments
// (K5's packing), and dq += dS k (m64nD, k M/N-major, as K4's O += P V
// takes v). Halves, since S and dP at m64n128 (64 + 64 accumulators a
// thread) spill at the 168 registers ptxas gives a thread of 384. The
// second half of a last tile past seq_len is computed all the same, its
// P all zero: a branch around a wgmma would serialise them. At the end dq
// = dq_acc * scale in bf16, stored from registers: no atomics and no
// workspace, and each row sums its keys in one order, so a second launch
// gives the same bits.
struct DqLayout {
  static constexpr int q = 0;                            // 128 rows of q^
  static constexpr int dout = q + 128 * kRowBytes;       // 128 rows of dO
  static constexpr int k = dout + 128 * kRowBytes;       // kStages x 128
  static constexpr int v = k + kStages * 128 * kRowBytes;
  static constexpr int bars = v + kStages * 128 * kRowBytes;
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int n, int seq_len, float scale) {
  using L = DqLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  const int bh = blockIdx.y, q0 = blockIdx.x * 128;
  const int tiles = (seq_len + 127) / 128;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    set_max_regs<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * 128 * kRowBytes);
      tma_load(smem + L::q, &tm_q, q_full, q0, bh);
      tma_load(smem + L::dout, &tm_do, q_full, q0, bh);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * 128 * kRowBytes);
        tma_load(smem + L::k + s * 128 * kRowBytes, &tm_k, &full[s], t * 128, bh);
        tma_load(smem + L::v + s * 128 * kRowBytes, &tm_v, &full[s], t * 128, bh);
      }
    }
    return;
  }
  set_max_regs<240>();
  const int c = wg - 1, lt = threadIdx.x - 128 * wg;
  const int warp = lt >> 5, lane = lt & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + 64 * c + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  float ls[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    ls[r] = row < n ? lse[(size_t)bh * n + row] : 0.f;
    dl[r] = row < n ? delta[(size_t)bh * n + row] : 0.f;
  }
  unsigned char* qs = smem + L::q + c * 64 * kRowBytes;
  // q^ = q * scale rounded to bf16, in place, once
  mbar_wait(q_full, 0);
  {
    const float sc = __bfloat162float(__float2bfloat16(scale));
    uint32_t* p = reinterpret_cast<uint32_t*>(qs);
    for (int i = lt; i < 64 * kRowBytes / 4; i += 128) {
      const float2 f = unpack(p[i]);
      p[i] = bf16x2(f.x * sc, f.y * sc);
    }
    fence_proxy_async();
    named_sync(1 + c, 128);
  }
  const uint64_t q_desc = desc(qs);
  const uint64_t do_desc = desc(smem + L::dout + c * 64 * kRowBytes);
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k0 = t * 128 + 64 * h;
      const uint64_t k_desc = desc(smem + L::k + (2 * s + h) * 64 * kRowBytes);
      const uint64_t v_desc = desc(smem + L::v + (2 * s + h) * 64 * kRowBytes);
      float sacc[32], dpacc[32];
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma::wgmma_ss<64, 0, 0>(sacc, q_desc + kk * kStepK, k_desc + kk * kStepK, kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma::wgmma_ss<64, 0, 0>(dpacc, do_desc + kk * kStepK, v_desc + kk * kStepK, kk);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_operands(sacc);
      wgmma::fence_operands(dpacc);
      const bool edge = k0 + 64 > seq_len;  // keys past seq_len in this half
      uint32_t da[4][4];  // dS as four k16 A fragments (k: keys)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j, r = j & 1;
          const int key = k0 + 16 * kk + 8 * (j >> 1) + 2 * t4;
          const bool m0 = edge && key >= seq_len, m1 = edge && key + 1 >= seq_len;
          const float p0 = m0 ? 0.f : ex2((sacc[i] - ls[r]) * kLog2e);
          const float p1 = m1 ? 0.f : ex2((sacc[i + 1] - ls[r]) * kLog2e);
          da[kk][j] = bf16x2(p0 * (dpacc[i] - dl[r]), p1 * (dpacc[i + 1] - dl[r]));
        }
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma::wgmma_rs<D, 1>(dqa, da[kk], k_desc + kk * kStepRows, 1);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_operands(dqa);
      wgmma::fence_operands(da);
    }
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  const size_t base = (size_t)bh * n * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < n) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(dq + base + (size_t)row * D + 8 * i + 2 * t4) =
            bf16x2(dqa[4 * i + 2 * r] * scale, dqa[4 * i + 2 * r + 1] * scale);
    }
  }
}

// q^ = q * scale rounded to bf16 (the scale itself in bf16), for K5's and
// K6-dkv's TMA
__global__ void scale_q_kernel(const __nv_bfloat162* __restrict__ q,
                               __nv_bfloat162* __restrict__ out, size_t pairs,
                               float scale) {
  const float sc = __bfloat162float(__float2bfloat16(scale));
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    const float2 f = __bfloat1622float2(q[i]);
    out[i] = __floats2bfloat162_rn(f.x * sc, f.y * sc);
  }
}

// the driver's cuTensorMapEncodeTiled, looked up once through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (bh, n, d) bf16 tensor as a (d, n, bh) map of (64, rows, 1) boxes in
// the 128-byte swizzle; columns past d and rows past n read as zeros
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int bh, int n, int d,
                       int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int n, int seq_len, float scale,
                bool softmax, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = tensor_map(&mq, q, bh, n, D, 128);
  if (err == cudaSuccess) err = tensor_map(&mk, k, bh, n, D, 128);
  if (err == cudaSuccess) err = tensor_map(&mv, v, bh, n, D, 128);
  if (err != cudaSuccess) return err;
  if (reinterpret_cast<uintptr_t>(o) % 4 != 0) return cudaErrorMisalignedAddress;
  auto kernel = softmax ? flash_fwd_wgmma<D, true> : flash_fwd_wgmma<D, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FwdLayout::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + 127) / 128, bh), kThreads, FwdLayout::bytes, st>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, n, seq_len, scale);
  return cudaGetLastError();
}

// K5 (DQ) and K6-dkv: q^ into q_hat, then the kernel
template <int D, bool DQ>
cudaError_t bwd_wgmma(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* q_hat, void* dk, void* dv, float* dq_acc, int bh,
                      int n, int seq_len, float scale, cudaStream_t st) {
  const size_t count = (size_t)bh * n * D;
  if (reinterpret_cast<uintptr_t>(q) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(dk) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(dv) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(dq_acc) % 8 != 0)
    return cudaErrorMisalignedAddress;
  const size_t blocks = (count / 2 + 255) / 256;
  scale_q_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      static_cast<const __nv_bfloat162*>(q), static_cast<__nv_bfloat162*>(q_hat),
      count / 2, scale);
  cudaError_t err = cudaGetLastError();
  CUtensorMap mq, mk, mv, mdo;
  if (err == cudaSuccess) err = tensor_map(&mq, q_hat, bh, n, D, 64);
  if (err == cudaSuccess) err = tensor_map(&mk, k, bh, n, D, 128);
  if (err == cudaSuccess) err = tensor_map(&mv, v, bh, n, D, 128);
  if (err == cudaSuccess) err = tensor_map(&mdo, dout, bh, n, D, 64);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_wgmma<D, DQ>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BwdLayout::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + 127) / 128, bh), kThreads, BwdLayout::bytes, st>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dq_acc, n, seq_len);
  return cudaGetLastError();
}

// K5 in bf16: zero the workspace, q^ into dq (free until the last pass),
// the kernel, then dq = dq_acc * scale
template <int D>
cudaError_t bwd_fused(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, float* dq_acc, int bh,
                      int n, int seq_len, float scale, cudaStream_t st) {
  const size_t count = (size_t)bh * n * D;
  cudaError_t err = cudaMemsetAsync(dq_acc, 0, count * sizeof(float), st);
  if (err == cudaSuccess)
    err = bwd_wgmma<D, true>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, bh,
                             n, seq_len, scale, st);
  if (err != cudaSuccess) return err;
  const size_t fblocks = (count + 255) / 256;
  flash_dq_flush_kernel<bf16><<<(int)(fblocks < 4096 ? fblocks : 4096), 256, 0, st>>>(
      dq_acc, static_cast<bf16*>(dq), count, scale);
  return cudaGetLastError();
}

// K6-dq in bf16
template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int bh, int n, int seq_len, float scale,
                   cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(dq) % 4 != 0) return cudaErrorMisalignedAddress;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = tensor_map(&mq, q, bh, n, D, 128);
  if (err == cudaSuccess) err = tensor_map(&mk, k, bh, n, D, 128);
  if (err == cudaSuccess) err = tensor_map(&mv, v, bh, n, D, 128);
  if (err == cudaSuccess) err = tensor_map(&mdo, dout, bh, n, D, 128);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_wgmma<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DqLayout::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + 127) / 128, bh), kThreads, DqLayout::bytes, st>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dq), n, seq_len, scale);
  return cudaGetLastError();
}

}  // namespace hopper

// ---------------------------------------------------------------------------
// fp32 K4 and K4-mb on the CUDA cores (wgmma has no fp32 short of TF32,
// which would break the 1e-4 tolerance). A block of 256 threads takes 128
// q rows of one bh and walks 64-key tiles; thread (ty, tx) of a 16 x 16
// grid holds an 8 x 4 micro-tile of S (rows 8 ty + i, keys 4 tx + j) and
// an 8 x D/16 one of O (columns tx + 16 c) in registers, with its rows'
// running max and partial sums; a row's 16 threads lie in one half-warp
// and reduce by shuffles. q^ is staged once, transposed; k (transposed)
// and v are double-buffered in shared memory, the next tile loaded into
// registers while this one is used. P goes through shared memory, the one
// exchange a register-tiled P V needs.
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int kRows = 128, kKeys = 64, kThreads = 256;
constexpr int kPS = kRows + 4;  // P^T rows: float4 reads, spread stores
constexpr int kKS = kKeys + 4;  // k^T rows

template <int D>
struct Layout {  // in floats
  static constexpr int q = 0;                      // q^T: D x kRows
  static constexpr int k = q + D * kRows;          // 2 x k^T: D x kKS
  static constexpr int v = k + 2 * D * kKS;        // 2 x v: kKeys x D
  static constexpr int p = v + 2 * kKeys * D;      // P^T: kKeys x kPS
  static constexpr size_t bytes = sizeof(float) * (p + kKeys * kPS);
};

template <int D, bool SOFTMAX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int n, int seq_len, float scale) {
  using L = Layout<D>;
  constexpr int F4 = D / 4;                  // float4s a row
  constexpr int PER = kKeys * F4 / kThreads;  // float4s a thread stages
  constexpr int NC = D / 16;                 // O columns a thread
  static_assert(kKeys * F4 % kThreads == 0, "whole float4s a thread");
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm + L::q;
  float* Pt = sm + L::p;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const size_t base = (size_t)bh * n * D;
  const int kv_end = SOFTMAX ? seq_len : n;
  const int tiles = (kv_end + kKeys - 1) / kKeys;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    Qt[c * kRows + r] = q0 + r < n ? q[base + (size_t)(q0 + r) * D + c] * scale : 0.f;
  }
  float4 kr[PER], vr[PER];
  auto load = [&](int t) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = tid + kThreads * j, row = idx / F4, c4 = idx - row * F4;
      const int key = t * kKeys + row;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      kr[j] = key < n ? *reinterpret_cast<const float4*>(k + base + (size_t)key * D + 4 * c4) : zero;
      vr[j] = key < n ? *reinterpret_cast<const float4*>(v + base + (size_t)key * D + 4 * c4) : zero;
    }
  };
  auto store = [&](int buf) {
    float* Kt = sm + L::k + buf * D * kKS;
    float* Vs = sm + L::v + buf * kKeys * D;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = tid + kThreads * j, row = idx / F4, c4 = idx - row * F4;
      Kt[(4 * c4) * kKS + row] = kr[j].x;
      Kt[(4 * c4 + 1) * kKS + row] = kr[j].y;
      Kt[(4 * c4 + 2) * kKS + row] = kr[j].z;
      Kt[(4 * c4 + 3) * kKS + row] = kr[j].w;
      *reinterpret_cast<float4*>(Vs + row * D + 4 * c4) = vr[j];
    }
  };
  load(0);
  store(0);
  __syncthreads();

  float oacc[8][NC], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) oacc[i][c] = 0.f;
  }
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1, k0 = t * kKeys;
    if (t + 1 < tiles) load(t + 1);
    const float* Kt = sm + L::k + buf * D * kKS;
    const float* Vs = sm + L::v + buf * kKeys * D;
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + c * kRows + 8 * ty);
      const float4 qb = *reinterpret_cast<const float4*>(Qt + c * kRows + 8 * ty + 4);
      const float4 kv = *reinterpret_cast<const float4*>(Kt + c * kKS + 4 * tx);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const float kk[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kk[j], s[i][j]);
    }
    if (SOFTMAX) {
      if (k0 + kKeys > seq_len) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + 4 * tx + j >= seq_len)
#pragma unroll
            for (int i = 0; i < 8; ++i) s[i][j] = kNegInf;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_next = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_next);
        m[i] = m_next;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_next);
          sum += s[i][j];
        }
        l[i] = alpha * l[i] + sum;
#pragma unroll
        for (int c = 0; c < NC; ++c) oacc[i][c] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* dst = Pt + (4 * tx + j) * kPS + 8 * ty;
      *reinterpret_cast<float4*>(dst) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < kKeys; ++key) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + key * kPS + 8 * ty);
      const float4 pb = *reinterpret_cast<const float4*>(Pt + key * kPS + 8 * ty + 4);
      const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[key * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) oacc[i][c] = fmaf(pv[i], vv[c], oacc[i][c]);
    }
    if (t + 1 < tiles) store(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + 8 * ty + i;
    float li = l[i];
    if (SOFTMAX) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        li += __shfl_xor_sync(0xffffffffu, li, off);
    }
    if (row < n) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        o[base + (size_t)row * D + tx + 16 * c] = SOFTMAX ? oacc[i][c] / li : oacc[i][c];
      if (SOFTMAX && tx == 0) lse[(size_t)bh * n + row] = m[i] + logf(li);
    }
  }
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int n, int seq_len, float scale,
                bool softmax, cudaStream_t st) {
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  const size_t bytes = Layout<D>::bytes;
  auto kernel = softmax ? flash_fwd_f32<D, true> : flash_fwd_f32<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + kRows - 1) / kRows, bh), kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, n, seq_len,
      scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 K5 (FUSED) and fp32 K6-dkv on the CUDA cores: one key-major
// template in the plain version's summation order. A block of 256 threads
// takes 64 keys of one bh (a key tile wholly past seq_len only writes
// zeros) and walks the 64-row q tiles in ascending order. k^T and v^T are
// staged once. The q side of a tile (q^ = q * scale, dO, lse, delta)
// arrives in registers by float4 loads while the tile before it is in use,
// and goes into the other half of a double buffer.
// Per q tile:
//   A. S = q^ k^T and dP = dO v^T: a 4 q x 4 key micro-tile of each a
//      thread (rows 16 wy + ly + 4 i, keys 32 wx + 4 lx + j), each element
//      one fmaf chain over c ascending from 0; then in registers p =
//      expf(S - lse) (0 at keys at or past seq_len and rows past n) and
//      ds = p (dP - delta), stored as float4 rows of P and dS [q][key], the
//      one exchange the register tiling needs;
//   B. dV += P^T dO and dK += dS^T q^ in registers: 4 keys x D/16 columns a
//      thread (keys 4 kg + j, columns cg + 16 m), one fmaf a q row, the
//      rows ascending;
//   C. K5 only: the tile's dq share dS k over the block's keys, 4 q rows x
//      D/16 columns a thread (rows 4 kg + i, columns cg + 16 m) from
//      float4s of dS rows and k^T rows, staged in shared memory; at the
//      start of the next tile (after the walk, for the last) each thread
//      adds D/16 float4s of it to the fp32 workspace by float4 atomics, a
//      row's float4s on consecutive threads.
// So each S, dP element is one fmaf chain over c from 0, and each dk, dv
// element one over the q rows in ascending order, carried across tiles:
// the order that cuBLAS's fp32 products in flash_bwd_plain keep from bh 2
// on (chip_smoke.py's check_k6 holds dk and dv to them bit for bit). No sum over q is split; the 81 x 48 blocks
// of the LARGE shape fill the card without it. q^ and dO rows have stride
// D + 4 floats, so A's float4 reads of 4 consecutive rows lie in distinct
// banks; k^T, v^T, P and dS rows have stride 68, so a warp's reads in A, B
// and C take no more wavefronts than their bytes need.
// The products bound it: 10 (K5) or 8 (K6-dkv) n^2 d bh flops at 67
// TFLOP/s, 9.2 and 7.4 ms at bh 48, n 5184, d 48.
// ---------------------------------------------------------------------------
constexpr int kBwdKeys = 64, kBwdRows = 64;
constexpr int kBS = kBwdKeys + 4;   // k^T, v^T, P and dS rows
constexpr int kSmemOptin = 232448;  // a block's shared memory on sm_90

template <int D, bool FUSED>
struct BwdLayout {  // in floats
  static constexpr int QS = D + 4;                      // q^ and dO rows
  static constexpr int kt = 0;                          // k^T: D x kBS
  static constexpr int vt = kt + D * kBS;               // v^T: D x kBS
  static constexpr int dq = vt + D * kBS;               // K5's dq share: kBwdRows x QS
  static constexpr int q = dq + FUSED * kBwdRows * QS;  // 2 x q^: kBwdRows x QS
  static constexpr int dout = q + 2 * kBwdRows * QS;    // 2 x dO: kBwdRows x QS
  static constexpr int lse = dout + 2 * kBwdRows * QS;  // 2 x kBwdRows
  static constexpr int delta = lse + 2 * kBwdRows;      // 2 x kBwdRows
  static constexpr int p = delta + 2 * kBwdRows;        // P: kBwdRows x kBS
  static constexpr int ds = p + kBwdRows * kBS;         // dS: kBwdRows x kBS
  static constexpr size_t bytes = sizeof(float) * (ds + kBwdRows * kBS);
};

__device__ __forceinline__ float lane4(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kv_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ dq_acc, int n,
                     int seq_len, float scale) {
  using L = BwdLayout<D, FUSED>;
  constexpr int F4 = D / 4;                      // float4s a row
  constexpr int PER = kBwdRows * F4 / kThreads;  // float4s a thread stages
  constexpr int NC = D / 16;                     // B's columns a thread
  static_assert(kBwdRows * F4 % kThreads == 0, "whole float4s a thread");
  static_assert(kBwdKeys == kBwdRows, "one row map stages k, v, q and dO");
  static_assert(L::bytes <= kSmemOptin, "a block's shared memory");
  extern __shared__ __align__(16) float sm[];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBwdKeys, bh = blockIdx.y;
  const size_t base = (size_t)bh * n * D;
  const int kg = tid >> 4, cg = tid & 15;  // B: keys 4 kg + j, columns cg + 16 m
  float dK[4][NC], dV[4][NC];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int m = 0; m < NC; ++m) dK[j][m] = dV[j][m] = 0.f;

  if (k0 < seq_len) {
    float* Kt = sm + L::kt;
    float* Vt = sm + L::vt;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = tid + kThreads * j, row = idx / F4, c4 = idx - row * F4;
      const int key = k0 + row;
      const float4 kx = key < n ? ld4(k + base + (size_t)key * D + 4 * c4) : zero;
      const float4 vx = key < n ? ld4(v + base + (size_t)key * D + 4 * c4) : zero;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Kt[(4 * c4 + e) * kBS + row] = lane4(kx, e);
        Vt[(4 * c4 + e) * kBS + row] = lane4(vx, e);
      }
    }
    // the q side of a tile: float4s of q and dO, and one row's lse
    // (threads 0-63) or delta (64-127)
    float4 qx[PER], ox[PER];
    float stat = 0.f;
    auto load = [&](int q0) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int idx = tid + kThreads * j, row = idx / F4, c4 = idx - row * F4;
        const int r = q0 + row;
        qx[j] = r < n ? ld4(q + base + (size_t)r * D + 4 * c4) : zero;
        ox[j] = r < n ? ld4(dout + base + (size_t)r * D + 4 * c4) : zero;
      }
      if (tid < 2 * kBwdRows) {
        const int r = q0 + (tid & (kBwdRows - 1));
        const float* src = tid < kBwdRows ? lse : delta;
        stat = r < n ? src[(size_t)bh * n + r] : 0.f;
      }
    };
    auto store = [&](int buf) {
      float* Q = sm + L::q + buf * kBwdRows * L::QS;
      float* O = sm + L::dout + buf * kBwdRows * L::QS;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int idx = tid + kThreads * j, row = idx / F4, c4 = idx - row * F4;
        *reinterpret_cast<float4*>(Q + row * L::QS + 4 * c4) =
            make_float4(qx[j].x * scale, qx[j].y * scale, qx[j].z * scale,
                        qx[j].w * scale);
        *reinterpret_cast<float4*>(O + row * L::QS + 4 * c4) = ox[j];
      }
      if (tid < 2 * kBwdRows)  // lse, then delta, kBwdRows x 2 each
        sm[L::lse + (tid / kBwdRows) * (L::delta - L::lse) + buf * kBwdRows +
           (tid & (kBwdRows - 1))] = stat;
    };
    // K5: tile q0's dq share, staged by C, into the workspace as float4
    // atomics, a row's float4s on consecutive threads
    float* Dq = sm + L::dq;
    auto flush = [&](int q0) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int idx = tid + kThreads * j, row = idx / F4, c4 = idx - row * F4;
        if (q0 + row < n)
          atomicAdd(reinterpret_cast<float4*>(dq_acc + base +
                                              (size_t)(q0 + row) * D + 4 * c4),
                    ld4(Dq + row * L::QS + 4 * c4));
      }
    };
    load(0);
    store(0);
    __syncthreads();

    // A: rows ra + 4 i, keys kb + j
    const int w = tid >> 5, lane = tid & 31;
    const int ra = 16 * (w >> 1) + (lane >> 3);
    const int kb = 32 * (w & 1) + 4 * (lane & 7);
    bool key_live[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) key_live[j] = k0 + kb + j < seq_len;
    float* P = sm + L::p;
    float* dS = sm + L::ds;
    const int tiles = (n + kBwdRows - 1) / kBwdRows;
    for (int t = 0; t < tiles; ++t) {
      const int buf = t & 1, q0 = t * kBwdRows;
      if (t + 1 < tiles) load(q0 + kBwdRows);
      if (FUSED && t > 0) flush(q0 - kBwdRows);
      const float* Q = sm + L::q + buf * kBwdRows * L::QS;
      const float* O = sm + L::dout + buf * kBwdRows * L::QS;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int c4 = 0; c4 < F4; ++c4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ld4(Q + (ra + 4 * i) * L::QS + 4 * c4);
#pragma unroll
        for (int e = 0; e < 4; ++e) b[e] = ld4(Kt + (4 * c4 + e) * kBS + kb);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              s[i][j] = fmaf(lane4(a[i], e), lane4(b[e], j), s[i][j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ld4(O + (ra + 4 * i) * L::QS + 4 * c4);
#pragma unroll
        for (int e = 0; e < 4; ++e) b[e] = ld4(Vt + (4 * c4 + e) * kBS + kb);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              dp[i][j] = fmaf(lane4(a[i], e), lane4(b[e], j), dp[i][j]);
      }
      const float* lse_s = sm + L::lse + buf * kBwdRows;
      const float* delta_s = sm + L::delta + buf * kBwdRows;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ra + 4 * i;
        const bool row_live = q0 + r < n;
        const float l = lse_s[r], dl = delta_s[r];
        float pr[4], dr[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pr[j] = row_live && key_live[j] ? expf(s[i][j] - l) : 0.f;
          dr[j] = pr[j] * (dp[i][j] - dl);
        }
        *reinterpret_cast<float4*>(P + r * kBS + kb) =
            make_float4(pr[0], pr[1], pr[2], pr[3]);
        *reinterpret_cast<float4*>(dS + r * kBS + kb) =
            make_float4(dr[0], dr[1], dr[2], dr[3]);
      }
      __syncthreads();
      // B: the rows in ascending order (rows past n add zeros)
#pragma unroll 8
      for (int r = 0; r < kBwdRows; ++r) {
        const float4 pv = ld4(P + r * kBS + 4 * kg);
        const float4 sv = ld4(dS + r * kBS + 4 * kg);
        float ov[NC], qv[NC];
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          ov[m] = O[r * L::QS + cg + 16 * m];
          qv[m] = Q[r * L::QS + cg + 16 * m];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int m = 0; m < NC; ++m) {
            dV[j][m] = fmaf(lane4(pv, j), ov[m], dV[j][m]);
            dK[j][m] = fmaf(lane4(sv, j), qv[m], dK[j][m]);
          }
      }
      if constexpr (FUSED) {
        // C: rows 4 kg + i, columns cg + 16 m of dS k over the block's keys
        // (dS is zero past seq_len), from float4s of dS rows and k^T rows,
        // staged in Dq for the next tile's flush
        float acc[4][NC];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int m = 0; m < NC; ++m) acc[i][m] = 0.f;
#pragma unroll 2
        for (int kc = 0; kc < kBwdKeys; kc += 4) {
          float4 a[4], b[NC];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = ld4(dS + (4 * kg + i) * kBS + kc);
#pragma unroll
          for (int m = 0; m < NC; ++m) b[m] = ld4(Kt + (cg + 16 * m) * kBS + kc);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int m = 0; m < NC; ++m)
                acc[i][m] = fmaf(lane4(a[i], e), lane4(b[m], e), acc[i][m]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int m = 0; m < NC; ++m)
            Dq[(4 * kg + i) * L::QS + cg + 16 * m] = acc[i][m];
      }
      if (t + 1 < tiles) store(buf ^ 1);
      __syncthreads();
    }
    if (FUSED) flush((tiles - 1) * kBwdRows);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + 4 * kg + j;
    if (key < n) {
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        dk[base + (size_t)key * D + cg + 16 * m] = dK[j][m];
        dv[base + (size_t)key * D + cg + 16 * m] = dV[j][m];
      }
    }
  }
}

// fp32 K5 (dq_acc given, zeroed by the caller) or K6-dkv (dq_acc null)
template <int D>
cudaError_t bwd_kv(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, float* dq_acc, int bh, int n,
                   int seq_len, float scale, cudaStream_t st) {
  for (const void* p : {q, k, v, dout, static_cast<const void*>(dq_acc)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  const bool fused = dq_acc != nullptr;
  const size_t bytes = fused ? BwdLayout<D, true>::bytes : BwdLayout<D, false>::bytes;
  auto kernel = fused ? flash_bwd_kv_f32<D, true> : flash_bwd_kv_f32<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + kBwdKeys - 1) / kBwdKeys, bh), kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), dq_acc, n,
      seq_len, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 K6-dq on the CUDA cores: q-major, in the plain version's summation
// order. A block of 256 threads takes R = kDqRows q rows of one bh and
// walks the 64-key tiles in ascending order up to the last one that holds
// a key below seq_len. q^ = q * scale and dO (rows of stride D + 4), lse
// and delta are staged once, zero past n; k^T and v^T (D x 68) are
// double-buffered, the next tile's float4s loaded into registers while
// this one is in use. Per key tile:
//   A. S = q^ k^T and dP = dO v^T: an R/16 q x 4 key micro-tile of each a
//      thread (rows ra + 4 i, keys kb + j: K5's map, R/4 rows a warp pair),
//      each element one fmaf chain over c ascending from 0; then in
//      registers p = expf(S - lse) (0 at keys at or past seq_len and rows
//      past n) and ds = p (dP - delta), stored as float4 rows of dS
//      [q][key], the one exchange the register tiling needs;
//   C. dq += dS k over the tile's 64 keys: R/16 q rows x D/16 columns a
//      thread (rows 4 kg + i % 4 + 64 (i / 4), columns cg + 16 m), from
//      float4s of dS rows and k^T rows, a float4's 4 keys in order; dq
//      stays in registers over all key tiles.
// So each S, dP element is one fmaf chain over c from 0, and each dq
// element one over the keys ascending from 0, carried across tiles: the
// order of cuBLAS's fp32 products in flash_bwd_plain from bh 2 on
// (chip_smoke.py's check_k6 holds dq to it bit for bit). dq * scale is
// stored once at the end: no atomics and no workspace, so a second launch
// gives the same bits. A warp's 32 staging items of k and v are 16 keys x
// 2 adjacent float4s: each key's 32 bytes are one sector of the load, and
// the transposed stores fall in 32 distinct banks. Two block barriers a
// key tile: dS written, and the next tile's k^T, v^T stored.
// The products bound it: 6 n^2 d bh flops at 67 TFLOP/s, 5.545 ms at bh
// 48, n 5184, d 48.
// ---------------------------------------------------------------------------
// fp32 K6-dq's plan: q rows a block, and the blocks an SM that
// __launch_bounds__ asks for. 128 rows at one block ran fastest at every
// d on an H100 (tools/torch_flash_probe.py --parts dq_plans: 64 rows at
// one or two blocks an SM, 1.0-1.3x its time; at two, ptxas spills d 48)
constexpr int kDqRows = 128, kDqBlocks = 1;

template <int D, int R>
struct DqLayout {  // in floats
  static constexpr int QS = D + 4;              // q^ and dO rows
  static constexpr int kt = 0;                  // 2 x k^T: D x kBS
  static constexpr int vt = kt + 2 * D * kBS;   // 2 x v^T: D x kBS
  static constexpr int q = vt + 2 * D * kBS;    // q^: R x QS
  static constexpr int dout = q + R * QS;       // dO: R x QS
  static constexpr int lse = dout + R * QS;     // R
  static constexpr int delta = lse + R;         // R
  static constexpr int ds = delta + R;          // dS: R x kBS
  static constexpr size_t bytes = sizeof(float) * (ds + R * kBS);
};

// the (key, float4) of a 64-key tile that k and v staging item idx covers:
// a warp's 32 items are 16 keys x 2 adjacent float4s
__device__ __forceinline__ int2 kv_item(int idx) {
  const int lane = idx & 31, wi = idx >> 5;
  return make_int2(16 * (wi & 3) + (lane & 15), 2 * (wi >> 2) + (lane >> 4));
}

template <int D>
__global__ void __launch_bounds__(kThreads, kDqBlocks)
    flash_bwd_q_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int n, int seq_len, float scale) {
  constexpr int R = kDqRows;
  using L = DqLayout<D, R>;
  constexpr int F4 = D / 4;                      // float4s a row
  constexpr int PER = kBwdKeys * F4 / kThreads;  // k, v float4s a thread stages
  constexpr int QPER = R * F4 / kThreads;        // q, dO float4s a thread stages
  constexpr int RT = R / 16;                     // A's and C's q rows a thread
  constexpr int NC = D / 16;                     // C's columns a thread
  static_assert(kBwdKeys == 64 && F4 % 2 == 0 && R % 64 == 0, "the maps");
  static_assert(R * F4 % kThreads == 0, "whole float4s a thread");
  static_assert(L::bytes <= kSmemOptin, "a block's shared memory");
  extern __shared__ __align__(16) float sm[];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * R, bh = blockIdx.y;
  const size_t base = (size_t)bh * n * D;
  float* Q = sm + L::q;
  float* O = sm + L::dout;
  float* dS = sm + L::ds;
#pragma unroll
  for (int j = 0; j < QPER; ++j) {
    const int idx = tid + kThreads * j, row = idx / F4, c4 = idx - row * F4;
    const int r = q0 + row;
    const float4 qx = r < n ? ld4(q + base + (size_t)r * D + 4 * c4) : zero;
    *reinterpret_cast<float4*>(Q + row * L::QS + 4 * c4) =
        make_float4(qx.x * scale, qx.y * scale, qx.z * scale, qx.w * scale);
    *reinterpret_cast<float4*>(O + row * L::QS + 4 * c4) =
        r < n ? ld4(dout + base + (size_t)r * D + 4 * c4) : zero;
  }
  for (int i = tid; i < 2 * R; i += kThreads) {  // lse, then delta
    const int r = q0 + i % R;
    sm[L::lse + i] = r < n ? (i < R ? lse : delta)[(size_t)bh * n + r] : 0.f;
  }
  float4 kr[PER], vr[PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int2 it = kv_item(tid + kThreads * j);
      const int key = k0 + it.x;
      kr[j] = key < n ? ld4(k + base + (size_t)key * D + 4 * it.y) : zero;
      vr[j] = key < n ? ld4(v + base + (size_t)key * D + 4 * it.y) : zero;
    }
  };
  auto store = [&](int buf) {
    float* Kt = sm + L::kt + buf * D * kBS;
    float* Vt = sm + L::vt + buf * D * kBS;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int2 it = kv_item(tid + kThreads * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Kt[(4 * it.y + e) * kBS + it.x] = lane4(kr[j], e);
        Vt[(4 * it.y + e) * kBS + it.x] = lane4(vr[j], e);
      }
    }
  };
  load(0);
  store(0);
  __syncthreads();

  // A: rows ra + 4 i, keys kb + j; C: rows 4 kg + i % 4 + 64 (i / 4),
  // columns cg + 16 m
  const int w = tid >> 5, lane = tid & 31;
  const int ra = (R / 4) * (w >> 1) + (lane >> 3);
  const int kb = 32 * (w & 1) + 4 * (lane & 7);
  const int kg = tid >> 4, cg = tid & 15;
  const float* lse_s = sm + L::lse;
  const float* delta_s = sm + L::delta;
  float acc[RT][NC];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int m = 0; m < NC; ++m) acc[i][m] = 0.f;
  const int tiles = (seq_len + kBwdKeys - 1) / kBwdKeys;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1, k0 = t * kBwdKeys;
    if (t + 1 < tiles) load(k0 + kBwdKeys);
    const float* Kt = sm + L::kt + buf * D * kBS;
    const float* Vt = sm + L::vt + buf * D * kBS;
    float s[RT][4], dp[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int c4 = 0; c4 < F4; ++c4) {
      float4 a[RT], b[4];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = ld4(Q + (ra + 4 * i) * L::QS + 4 * c4);
#pragma unroll
      for (int e = 0; e < 4; ++e) b[e] = ld4(Kt + (4 * c4 + e) * kBS + kb);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] = fmaf(lane4(a[i], e), lane4(b[e], j), s[i][j]);
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = ld4(O + (ra + 4 * i) * L::QS + 4 * c4);
#pragma unroll
      for (int e = 0; e < 4; ++e) b[e] = ld4(Vt + (4 * c4 + e) * kBS + kb);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dp[i][j] = fmaf(lane4(a[i], e), lane4(b[e], j), dp[i][j]);
    }
    bool key_live[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) key_live[j] = k0 + kb + j < seq_len;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ra + 4 * i;
      const bool row_live = q0 + r < n;
      const float l = lse_s[r], dl = delta_s[r];
      float dr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = row_live && key_live[j] ? expf(s[i][j] - l) : 0.f;
        dr[j] = p * (dp[i][j] - dl);
      }
      *reinterpret_cast<float4*>(dS + r * kBS + kb) =
          make_float4(dr[0], dr[1], dr[2], dr[3]);
    }
    __syncthreads();
#pragma unroll 2
    for (int kc = 0; kc < kBwdKeys; kc += 4) {
      float4 a[RT], b[NC];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        a[i] = ld4(dS + (4 * kg + i % 4 + 64 * (i / 4)) * kBS + kc);
#pragma unroll
      for (int m = 0; m < NC; ++m) b[m] = ld4(Kt + (cg + 16 * m) * kBS + kc);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int m = 0; m < NC; ++m)
            acc[i][m] = fmaf(lane4(a[i], e), lane4(b[m], e), acc[i][m]);
    }
    if (t + 1 < tiles) store(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + 4 * kg + i % 4 + 64 * (i / 4);
    if (row < n) {
#pragma unroll
      for (int m = 0; m < NC; ++m)
        dq[base + (size_t)row * D + cg + 16 * m] = acc[i][m] * scale;
    }
  }
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int bh, int n, int seq_len, float scale,
                   cudaStream_t st) {
  for (const void* p : {q, k, v, dout})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  constexpr int R = kDqRows;
  constexpr size_t bytes = DqLayout<D, R>::bytes;
  auto kernel = flash_bwd_q_f32<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)  // room for kDqBlocks blocks an SM
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + R - 1) / R, bh), kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), n, seq_len, scale);
  return cudaGetLastError();
}

}  // namespace fp32

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int n, int seq_len, float scale,
                bool softmax, cudaStream_t st) {
  if constexpr (is_f32<T>())
    return fp32::fwd<D>(q, k, v, o, lse, bh, n, seq_len, scale, softmax, st);
  else
    return hopper::fwd<D>(q, k, v, o, lse, bh, n, seq_len, scale, softmax, st);
}

// K6-dkv: bf16 flash_bwd_wgmma<D, false> on q^ in q_hat, fp32
// fp32::flash_bwd_kv_f32<D, false> (q_hat unused)
template <typename T, int D>
cudaError_t bwd_kv(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* q_hat, void* dk, void* dv, int bh, int n,
                   int seq_len, float scale, cudaStream_t st) {
  if constexpr (is_f32<T>())
    return fp32::bwd_kv<D>(q, k, v, dout, lse, delta, dk, dv, nullptr, bh, n,
                           seq_len, scale, st);
  else
    return hopper::bwd_wgmma<D, false>(q, k, v, dout, lse, delta, q_hat, dk,
                                       dv, nullptr, bh, n, seq_len, scale, st);
}

// K6-dq: bf16 flash_bwd_dq_wgmma<D>, fp32 fp32::flash_bwd_q_f32<D>
template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int bh, int n, int seq_len, float scale,
                   cudaStream_t st) {
  if constexpr (is_f32<T>())
    return fp32::bwd_dq<D>(q, k, v, dout, lse, delta, dq, bh, n, seq_len,
                           scale, st);
  else
    return hopper::bwd_dq<D>(q, k, v, dout, lse, delta, dq, bh, n, seq_len,
                             scale, st);
}

// K5: zero the dq workspace, the fused kernel (fp32:
// fp32::flash_bwd_kv_f32<D, true>), then dq = dq_acc * scale
template <typename T, int D>
cudaError_t bwd_fused(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, float* dq_acc, int bh,
                      int n, int seq_len, float scale, cudaStream_t st) {
  if constexpr (!is_f32<T>()) {
    return hopper::bwd_fused<D>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc,
                                bh, n, seq_len, scale, st);
  } else {
    const size_t count = (size_t)bh * n * D;
    cudaError_t err = cudaMemsetAsync(dq_acc, 0, count * sizeof(float), st);
    if (err != cudaSuccess) return err;
    err = fp32::bwd_kv<D>(q, k, v, dout, lse, delta, dk, dv, dq_acc, bh, n,
                          seq_len, scale, st);
    if (err != cudaSuccess) return err;
    const size_t blocks = (count + 255) / 256;
    flash_dq_flush_kernel<T><<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
        dq_acc, static_cast<T*>(dq), count, scale);
    return cudaGetLastError();
  }
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

// K6-dkv: dk and dv. In bf16 q_hat is a (bh, n, d) scratch that takes q^
// (16-byte aligned, for TMA); in fp32 it is unused and may be null.
extern "C" int muvo_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* q_hat, void* dk,
                                  void* dv, int bh, int n, int d, int seq_len,
                                  float scale, int dtype, void* stream) {
  if (bad_args(bh, n, d, seq_len, dtype) || (dtype == 1 && q_hat == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MUVO_FLASH_DISPATCH(bwd_kv, q, k, v, dout, lse, delta, q_hat, dk, dv, bh, n,
                      seq_len, scale, st);
}

extern "C" const char* muvo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
