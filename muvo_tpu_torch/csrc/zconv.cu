// K1, K2 and their input gradients K1-dx, K2-dx: the voxel decoder's 3x3x3
// convolutions on Hopper (sm_90a); fp32 K1, K2, K1-dx and K2-dx are in
// zconv_f32.cu.
//
//   K1     out = LeakyReLU(conv3d_same(x) + bias)
//   K2     out = LeakyReLU(conv3d_same(up2_z(x)) + bias)
//   K1-dx  dx  = conv3d_same(m(g), flip(w)^T)
//   K2-dx  dx  = up2_z^T(conv3d_same(m(g), flip(w)^T))
//
// x and out are channels-last NDHWC, (B, X, Y, Zin, C) -> (B, X, Y, Z, Cout)
// (Z = 2 Zin for K2, else Z = Zin), in fp32 or bf16; weights and bias
// arrive as fp32, weights in (kx, ky, kz, C, Cout) order (for dx the
// wrapper passes the spatially
// flipped kernel with C and Cout swapped). up2_z is the 2x linear
// z-upsample with half-pixel centres and clamped edges (torch
// align_corners=False):
//   u[2k]   = 0.25 x[max(k-1, 0)] + 0.75 x[k]
//   u[2k+1] = 0.75 x[k]           + 0.25 x[min(k+1, Zin-1)]
// m(g) is the LeakyReLU derivative applied to the cotangent g: g where the
// forward output is >= 0, slope * g elsewhere.
//
// Replaces muvo_tpu/ops/pallas_zconv.py::_zconv_pallas_raw as called by
// zconv3d_leaky_folded (K1), upzconv3d_leaky_folded (K2), _vjp_bwd's dx
// (K1-dx) and _up_vjp_bwd's dx (K2-dx). The Pallas kernel's banded
// (f+2)C x fCout weights, 128-lane z-blocks and padded-IO layouts exist for
// the TPU's (8, 128) tiles and are not carried over: the folded
// (B, X, Y, Z*C) tensor has the same bytes as NDHWC, which these kernels
// read and write directly.
//
// Bound on the card: at the decoder's shapes (C, Cout <= 32) the function
// does 27*C*2 flops per output element against ~(C + Cout) * 4 bytes of
// traffic, so in fp32 it is bound by operations (the CUDA cores' fp32 rate)
// and in bf16 by bytes. The CUDA-core zconv_kernel<T> (bf16 K1 and K1-dx
// past 64 channels, ops/zconv.py::k1_route, which no model shape reaches;
// fp32 only for tools/torch_zconv_probe.py's comparison with fp32 K1),
// simple first: one block per (b, x, y-tile) stages a haloed tile of 3
// x-rows * (ty+2) y * (Z+2) z * C in shared memory (for K1-dx applying the
// leaky mask while staging, reading the forward output and g once), keeps
// all 27*C*Cout weights in shared memory, and each thread accumulates 8
// output channels of one (y, z) voxel in fp32 registers; bias and the
// leaky slope are applied in the epilogue and the result is stored in the
// input type. The channel stride of the tile is odd, so neighbouring
// threads (neighbouring z) read distinct banks.
//
// bf16 K1, K2, K1-dx and K2-dx: zconv_tc_kernel<NP, KS, EDGES, DX>, an
// implicit GEMM on the tensor cores (wgmma) over a view of the volume with
// the same bytes, (B, X, Y, Zs, Kc) -> (B, X, Y, Zs, N), that the wrapper
// picks:
//   K2, K2-dx (EDGES): the small-z grid. K2's output (B, X, Y, 2 Zs, Cout)
//     is byte for byte (B, X, Y, Zs, 2 Cout), output channel p Cout + co
//     for big z = 2k + p, and that is a 3x3x3 SAME conv of the small-z
//     input with folded weights (ops/zconv.py::up_fold_weights) plus two
//     centre-tap terms at the first and last small slice; K2-dx is the same
//     conv structure over the masked cotangent viewed as (B, X, Y, Zs,
//     2 Cout) with the adjoint fold. The same function as the TPU kernel's
//     banded z-block weights (pallas_zconv.py::up_banded_weight,
//     up_banded_adjoint_weight) without its lane layout: neither the
//     upsampled input nor a big-z gradient exists anywhere.
//   K1, K1-dx (no edge terms): the plain view (Zs = Z, Kc = C, N = Cout),
//     or, where 8 channels would leave a k16 x n16 product mostly empty,
//     the pair view: z pairs folded into channels, (B, X, Y, Z / 2, 2 C)
//     -> (B, X, Y, Z / 2, 2 Cout), a 3x3x3 SAME conv with the weights of
//     ops/zconv.py::pair_fold_weights (the TPU kernel's banded_weight with
//     f = 2; exact for even Z, no edge terms). K1-dx is K1 on the masked
//     cotangent with the flipped, transposed kernel.
// GEMM: M = output voxels of the view in 64-row tiles (one per consumer
// warpgroup at a time), N = the view's output channels (padded to 16), K =
// 27 taps x the view's input channels (padded to 16), plus 2 x 9 edge taps
// for EDGES. The weights live in shared memory for the whole block as bf16
// in wgmma's K-major no-swizzle layout (8 x 16-byte core matrices); A comes
// from registers, gathered with ldmatrix out of a haloed bf16 x-plane (zero
// outside the volume), the row addresses making the im2col implicit. A
// block walks xs x rows with a ring of four planes, three in use and the
// next one arriving by cp.async (zero-fill for the halo), so each input
// plane is staged once per block. DX applies the leaky mask while staging
// (g and the forward output read once). The edge taps reuse the centre
// tap's A fragments with the rows that are not at the edge zeroed.
// Epilogue: bias (output channel n takes bias[n % Cb]) and LeakyReLU
// (forward), fp32 -> bf16. Bound at the decoder's shapes: bytes (about 4
// flops per byte at N = 32); the MMAs are far below the tensor cores' rate.

#include <algorithm>

#include "wgmma.cuh"
#include "zconv_common.cuh"

using muvo::from_float;
using muvo::load_voxel;
using muvo::round_up;

namespace {

constexpr int kThreads = 256;
constexpr int kCoChunk = 8;  // output channels per thread
// shared memory a block may take before the tile height is cut (keeps two
// blocks resident per SM); above it only when even ty = 1 needs more
constexpr size_t kSmemSoftCap = 100 * 1024;

struct Shape {
  int B, X, Y, Z, C, Cout;  // the staged input's z is the output's
  int ty;     // y rows per block
  int cs;     // channel stride of the staged tile (odd)
  int coutp;  // Cout rounded up to kCoChunk
};

__host__ __device__ inline size_t tile_floats(const Shape& s) {
  // rounded to 4 floats so the weight block that follows is 16-byte aligned
  return (size_t)round_up(3 * (s.ty + 2) * (s.Z + 2) * s.cs, 4);
}

inline size_t smem_bytes(const Shape& s) {
  return (tile_floats(s) + (size_t)27 * s.C * s.coutp) * sizeof(float);
}

// weights to shared memory, output channels zero-padded to coutp, and the
// haloed input tile (zero outside the volume)
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ x,
                                      const T* __restrict__ mask,
                                      float mslope,
                                      const float* __restrict__ w,
                                      float* tile, float* wsm, const Shape& s,
                                      int b, int xi, int y0) {
  const int nw = 27 * s.C * s.coutp;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int co = i % s.coutp;
    const int tap_c = i / s.coutp;
    wsm[i] = co < s.Cout ? w[(size_t)tap_c * s.Cout + co] : 0.f;
  }
  const int TYH = s.ty + 2, ZH = s.Z + 2;
  const int ntile = 3 * TYH * ZH * s.C;
  for (int i = threadIdx.x; i < ntile; i += blockDim.x) {
    const int c = i % s.C;
    int r = i / s.C;
    const int zz = r % ZH;
    r /= ZH;
    const int yy = r % TYH;
    const int dx = r / TYH;
    tile[((dx * TYH + yy) * ZH + zz) * s.cs + c] = load_voxel<T>(
        x, mask, mslope, b, xi + dx - 1, y0 + yy - 1, zz - 1, c, s.X, s.Y,
        s.Z, s.C);
  }
}

// 8 output channels (chunk cc) of the voxel (ty, z) of the tile
__device__ __forceinline__ void conv_point(const float* tile,
                                           const float* wsm, const Shape& s,
                                           int ty, int z, int cc,
                                           float acc[kCoChunk]) {
  const int TYH = s.ty + 2, ZH = s.Z + 2;
#pragma unroll
  for (int j = 0; j < kCoChunk; ++j) acc[j] = 0.f;
  for (int dx = 0; dx < 3; ++dx) {
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const float* tp = tile + ((dx * TYH + ty + dy) * ZH + z + dz) * s.cs;
        const float* wp = wsm + (size_t)((dx * 3 + dy) * 3 + dz) * s.C *
                                    s.coutp + cc * kCoChunk;
#pragma unroll 4
        for (int c = 0; c < s.C; ++c) {
          const float v = tp[c];
          const float4 w0 = *reinterpret_cast<const float4*>(wp);
          const float4 w1 = *reinterpret_cast<const float4*>(wp + 4);
          acc[0] = fmaf(v, w0.x, acc[0]);
          acc[1] = fmaf(v, w0.y, acc[1]);
          acc[2] = fmaf(v, w0.z, acc[2]);
          acc[3] = fmaf(v, w0.w, acc[3]);
          acc[4] = fmaf(v, w1.x, acc[4]);
          acc[5] = fmaf(v, w1.y, acc[5]);
          acc[6] = fmaf(v, w1.z, acc[6]);
          acc[7] = fmaf(v, w1.w, acc[7]);
          wp += s.coutp;
        }
      }
    }
  }
}

// K1 (and K1-dx: K1 on the masked cotangent, no bias, no activation)
template <typename T>
__global__ void __launch_bounds__(kThreads)
zconv_kernel(const T* __restrict__ x, const T* __restrict__ mask,
             float mslope, const float* __restrict__ w,
             const float* __restrict__ bias, T* __restrict__ out, Shape s,
             int has_act, float slope) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                  // [3][ty+2][Z+2][cs]
  float* wsm = smem + tile_floats(s);  // [27][C][coutp]
  const int y0 = blockIdx.x * s.ty;
  const int xi = blockIdx.y;
  const int b = blockIdx.z;
  stage<T>(x, mask, mslope, w, tile, wsm, s, b, xi, y0);
  __syncthreads();

  // one work item = 8 output channels of one (y, z) voxel; z fastest so a
  // warp shares its weight reads (broadcast) and stores contiguous rows
  const int nchunks = s.coutp / kCoChunk;
  const int nwork = nchunks * s.ty * s.Z;
  for (int item = threadIdx.x; item < nwork; item += blockDim.x) {
    const int z = item % s.Z;
    const int r = item / s.Z;
    const int ty = r % s.ty;
    const int cc = r / s.ty;
    const int gy = y0 + ty;
    if (gy >= s.Y) continue;
    float acc[kCoChunk];
    conv_point(tile, wsm, s, ty, z, cc, acc);
    T* o = out + ((((size_t)b * s.X + xi) * s.Y + gy) * s.Z + z) * s.Cout;
#pragma unroll
    for (int j = 0; j < kCoChunk; ++j) {
      const int co = cc * kCoChunk + j;
      if (co < s.Cout) {
        float v = acc[j] + (bias != nullptr ? bias[co] : 0.f);
        if (has_act && v < 0.f) v *= slope;
        o[co] = from_float<T>(v);
      }
    }
  }
}

// tallest y tile (<= 16, no taller than needed) under the soft cap, or
// failing that the tallest that fits the card at all; false if none fits
bool pick_ty(Shape& s) {
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return false;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return false;
  s.ty = 16;
  while (s.ty > 1 && (s.ty >= 2 * s.Y || smem_bytes(s) > kSmemSoftCap))
    s.ty /= 2;
  if (smem_bytes(s) > kSmemSoftCap) {
    for (s.ty = 16;
         s.ty > 1 && (s.ty >= 2 * s.Y || smem_bytes(s) > (size_t)optin);
         s.ty /= 2) {
    }
  }
  return smem_bytes(s) <= (size_t)optin;
}

template <typename T>
cudaError_t launch(const void* x, const void* mask, float mslope,
                   const float* w, const float* bias, void* out, Shape s,
                   int has_act, float slope, cudaStream_t stream) {
  auto kernel = zconv_kernel<T>;
  const size_t smem = smem_bytes(s);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s.Y + s.ty - 1) / s.ty, s.X, s.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mask), mslope, w, bias,
      static_cast<T*>(out), s, has_act, slope);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 K1, K2, K1-dx and K2-dx on the tensor cores (see the header)
// ---------------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;
// A block has 2 or 3 warpgroups (blockDim.x / 128), all of them computing
// and staging, and about 64 output rows (y x z) a warpgroup per x row: 2
// warpgroups and 16 x rows where two blocks fit on an SM, else 3 and 8 x
// rows, since one block of 8 warps does not hide the ldmatrix -> wgmma
// latency (K2-dx at conv2, batch 24, whose weights and planes take 150 KB:
// 1.17 ms against 1.53 with 2 warpgroups, NVIDIA H100 80GB HBM3, 700 W).
constexpr int kMaxThreads = 384;
constexpr int kPlanes = 4;  // x-plane ring: three in use, one arriving

struct TcShape {
  int B, X, Y, Zs;  // the view's grid
  int Kc, N;        // input and output channels of the views
  int Cb;           // bias period: output channel n takes bias[n % Cb]
  int ty, xs;       // y rows and x rows of a block
  int vec;          // 16-byte staging (Kc % 8 == 0, aligned tensors)
};

// taps with weights in shared memory: 27, and with the edge terms (K2,
// K2-dx) 2 x 9 more at k = 0 and k = Zs - 1
__host__ __device__ constexpr int taps(bool edges) {
  return edges ? 45 : 27;
}
__host__ __device__ inline int plane_elems(const TcShape& s, int ks) {
  return (s.ty + 2) * (s.Zs + 2) * (ks * 16 + 8);  // +8: conflict-free rows
}
inline size_t tc_smem_bytes(const TcShape& s, int ks, int np, bool edges) {
  return (size_t)taps(edges) * ks * np * 32 +
         (size_t)kPlanes * plane_elems(s, ks) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}
// shared-memory writes of this thread become visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// K-major B without swizzle: 8-row x 16-byte core matrices, the two k
// halves of a k16 step 128 bytes apart (LBO), 8-column groups 256 (SBO)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t masked_pair(uint32_t g, uint32_t m,
                                                float slope) {
  float2 gv = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&g));
  const float2 mv =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&m));
  if (mv.x < 0.f) gv.x *= slope;
  if (mv.y < 0.f) gv.y *= slope;
  return pack_bf16(gv.x, gv.y);
}

// x plane xi of the block's (ty + 2) y rows and Zs + 2 z slices into dst,
// KS * 16 channels a voxel (zero past Kc and outside the volume). DX
// applies the leaky mask (mask: the forward output; null: none).
template <int KS, bool DX>
__device__ __forceinline__ void stage_plane(bf16* dst,
                                            const bf16* __restrict__ x,
                                            const bf16* __restrict__ mask,
                                            float mslope, const TcShape& s,
                                            int b, int xi, int y0) {
  constexpr int KP = KS * 16, VS = KP + 8, CH = KP / 8;
  const int ZH = s.Zs + 2, nvox = (s.ty + 2) * ZH;
  const bool xin = xi >= 0 && xi < s.X;
  if (s.vec) {
    for (int i = threadIdx.x; i < nvox * CH; i += blockDim.x) {
      const int ch = i % CH, v = i / CH, zz = v % ZH, yy = v / ZH;
      const int gy = y0 + yy - 1, gz = zz - 1;
      const bool in = xin && gy >= 0 && gy < s.Y && gz >= 0 && gz < s.Zs &&
                      ch * 8 < s.Kc;
      const size_t off =
          in ? ((((size_t)b * s.X + xi) * s.Y + gy) * s.Zs + gz) * s.Kc +
                   ch * 8
             : 0;
      bf16* d = dst + v * VS + ch * 8;
      if (!DX) {
        cp_async16(d, x + off, in ? 16 : 0);
      } else {
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (in) {
          val = *reinterpret_cast<const uint4*>(x + off);
          if (mask != nullptr) {
            const uint4 m = *reinterpret_cast<const uint4*>(mask + off);
            val.x = masked_pair(val.x, m.x, mslope);
            val.y = masked_pair(val.y, m.y, mslope);
            val.z = masked_pair(val.z, m.z, mslope);
            val.w = masked_pair(val.w, m.w, mslope);
          }
        }
        *reinterpret_cast<uint4*>(d) = val;
      }
    }
  } else {
    for (int i = threadIdx.x; i < nvox * KP; i += blockDim.x) {
      const int c = i % KP, v = i / KP, zz = v % ZH, yy = v / ZH;
      const int gy = y0 + yy - 1, gz = zz - 1;
      float val = 0.f;
      if (xin && gy >= 0 && gy < s.Y && gz >= 0 && gz < s.Zs && c < s.Kc) {
        const size_t off =
            ((((size_t)b * s.X + xi) * s.Y + gy) * s.Zs + gz) * s.Kc + c;
        val = __bfloat162float(x[off]);
        if (DX && mask != nullptr && __bfloat162float(mask[off]) < 0.f)
          val *= mslope;
      }
      dst[v * VS + c] = __float2bfloat16(val);
    }
  }
}

// One block: output x rows x0 .. x0 + xs - 1, y rows y0 .. y0 + ty - 1, all
// Zs, all N channels, of batch b. Output rows r = (y - y0) Zs + k. EDGES:
// K2's and K2-dx's centre-tap edge terms.
template <int NP, int KS, bool EDGES, bool DX>
__global__ void __launch_bounds__(kMaxThreads, 1)
    zconv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ mask,
                    float mslope, const float* __restrict__ w,
                    const float* __restrict__ bias, bf16* __restrict__ out,
                    TcShape s, int has_act, float slope) {
  constexpr int KP = KS * 16, VS = KP + 8;
  constexpr int kBStep = NP * 32;  // bytes of B per k16 step
  constexpr int ntaps = taps(EDGES);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* planes =
      reinterpret_cast<bf16*>(tc_smem + (size_t)ntaps * KS * kBStep);
  const int ZH = s.Zs + 2, plane = plane_elems(s, KS);
  const int y0 = blockIdx.x * s.ty, x0 = blockIdx.y * s.xs, b = blockIdx.z;
  const int xend = min(x0 + s.xs, s.X);

  // B: the folded weights (taps, Kc, N) in fp32 -> bf16 K-major core
  // matrices, k16 step tap * KS + kc / 16; zero past Kc and N. A thread
  // writes one 16-byte core-matrix row: 8 k of one n (neighbouring
  // threads, neighbouring n: coalesced reads)
  for (int i = threadIdx.x; i < ntaps * (KP / 8) * NP; i += blockDim.x) {
    const int n = i % NP, k8 = (i / NP) % (KP / 8), tap = i / (NP * KP / 8);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int kc = k8 * 8 + e;
      v[e] = (kc < s.Kc && n < s.N) ? w[((size_t)tap * s.Kc + kc) * s.N + n]
                                    : 0.f;
    }
    uint4 row;
    row.x = pack_bf16(v[0], v[1]);
    row.y = pack_bf16(v[2], v[3]);
    row.z = pack_bf16(v[4], v[5]);
    row.w = pack_bf16(v[6], v[7]);
    const int step = tap * KS + (k8 >> 1);
    *reinterpret_cast<uint4*>(tc_smem + (size_t)step * kBStep +
                              ((n >> 3) * 2 + (k8 & 1)) * 128 +
                              (n & 7) * 16) = row;
  }
  fence_proxy_async();

  // plane xi lives in slot (xi - x0 + 1) % kPlanes
  for (int i = 0; i < 3; ++i)
    stage_plane<KS, DX>(planes + i * plane, x, mask, mslope, s, b, x0 - 1 + i,
                        y0);
  cp_commit();

  const int wg = threadIdx.x >> 7, nwg = blockDim.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int rows = s.ty * s.Zs, mtiles = (rows + 63) / 64;
  const uint32_t bbase = smem_u32(tc_smem), pbase = smem_u32(planes);
  for (int xo = x0; xo < xend; ++xo) {
    const int j = xo - x0;
    if (xo + 2 <= xend)
      stage_plane<KS, DX>(planes + ((j + 3) % kPlanes) * plane, x, mask,
                          mslope, s, b, xo + 2, y0);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    for (int mt = wg; mt < mtiles; mt += nwg) {
      // ldmatrix row of this lane: matrices (rows 0-7 | 8-15) x (k 0-7 |
      // 8-15) of the warp's 16 rows
      int r = mt * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      if (r >= rows) r = 0;  // a padding row: any staged voxel
      const uint32_t a_off =
          (uint32_t)(((r / s.Zs) * ZH + r % s.Zs) * VS + (lane >> 4) * 8) * 2;
      // fragment rows g and g + 8 of this thread, at a z edge or not
      const int rg = mt * 64 + warp * 16 + (lane >> 2);
      bool e0[2], e1[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rg + 8 * h, k = row % s.Zs;
        e0[h] = EDGES && row < rows && k == 0;
        e1[h] = EDGES && row < rows && k == s.Zs - 1;
      }
      float acc[NP / 2];
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
      uint32_t fa[2][KS][4], fe[2][2 * KS][4];
#pragma unroll
      for (int tap = 0; tap < 27; ++tap) {
        const int kx = tap / 9, ky = (tap / 3) % 3, kz = tap % 3;
        const int buf = tap & 1;
        if (tap >= 2) {  // the group that read this buffer is done
          wgmma::wait<1>();
          wgmma::fence_operands(fa[buf]);
          if (EDGES) wgmma::fence_operands(fe[buf]);
        }
        const uint32_t addr =
            pbase + ((xo + kx - x0) % kPlanes) * plane * 2 + a_off +
            (ky * ZH + kz) * VS * 2;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldmatrix_x4(fa[buf][ks], addr + ks * 32);
        if (EDGES && kz == 1) {
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              fe[buf][ks][q] = e0[q & 1] ? fa[buf][ks][q] : 0u;
              fe[buf][KS + ks][q] = e1[q & 1] ? fa[buf][ks][q] : 0u;
            }
        }
        wgmma::fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma::wgmma_rs<NP, 0>(
              acc, fa[buf][ks],
              kmajor_desc(bbase + (tap * KS + ks) * kBStep), 1);
        if (EDGES && kz == 1) {
          const int e = kx * 3 + ky;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            wgmma::wgmma_rs<NP, 0>(
                acc, fe[buf][ks],
                kmajor_desc(bbase + ((27 + e) * KS + ks) * kBStep), 1);
            wgmma::wgmma_rs<NP, 0>(
                acc, fe[buf][KS + ks],
                kmajor_desc(bbase + ((36 + e) * KS + ks) * kBStep), 1);
          }
        }
        wgmma::commit();
      }
      wgmma::wait<0>();
      wgmma::fence_operands(acc);
      wgmma::fence_operands(fa[0]);
      wgmma::fence_operands(fa[1]);
      if (EDGES) {
        wgmma::fence_operands(fe[0]);
        wgmma::fence_operands(fe[1]);
      }

      // epilogue: d[4i + 2h], d[4i + 2h + 1] are row rg + 8h, columns
      // 8i + 2(lane % 4) + {0, 1}
      const size_t rowbase = (((size_t)b * s.X + xo) * s.Y + y0) * s.Zs;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rg + 8 * h;
        if (row >= rows || y0 + row / s.Zs >= s.Y) continue;
        bf16* o = out + (rowbase + row) * s.N;
#pragma unroll
        for (int i = 0; i < NP / 8; ++i) {
          const int n = 8 * i + 2 * (lane & 3);
          if (n >= s.N) continue;
          float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
          if (!DX) {
            if (bias != nullptr) {
              v0 += bias[n % s.Cb];
              if (n + 1 < s.N) v1 += bias[(n + 1) % s.Cb];
            }
            if (has_act) {
              if (v0 < 0.f) v0 *= slope;
              if (v1 < 0.f) v1 *= slope;
            }
          }
          if ((s.N & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o + n) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            o[n] = __float2bfloat16(v0);
            if (n + 1 < s.N) o[n + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
    __syncthreads();  // the slot of plane xo - 1 is staged next
  }
}

template <int NP, int KS, bool EDGES, bool DX>
cudaError_t launch_tc_t(const void* x, const void* mask, float mslope,
                        const float* w, const float* bias, void* out,
                        TcShape s, int has_act, float slope,
                        cudaStream_t stream) {
  auto kernel = zconv_tc_kernel<NP, KS, EDGES, DX>;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  // the tile for nwg warpgroups: about 64 nwg rows, cut until it fits
  auto shape_for = [&](int nwg, int xs) {
    TcShape t = s;
    t.ty = std::min(s.Y, (64 * nwg + s.Zs - 1) / s.Zs);
    while (t.ty > 1 && tc_smem_bytes(t, KS, NP, EDGES) > (size_t)optin)
      --t.ty;
    t.xs = std::min(s.X, xs);
    return t;
  };
  int nwg = 2, blocks = 0;
  s = shape_for(2, 16);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, 256, tc_smem_bytes(s, KS, NP, EDGES));
  if (err != cudaSuccess) return err;
  if (blocks < 2) {
    nwg = 3;
    s = shape_for(3, 8);
  }
  const size_t smem = tc_smem_bytes(s, KS, NP, EDGES);
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  dim3 grid((s.Y + s.ty - 1) / s.ty, (s.X + s.xs - 1) / s.xs, s.B);
  kernel<<<grid, 128 * nwg, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(mask), mslope, w,
      bias, static_cast<bf16*>(out), s, has_act, slope);
  return cudaGetLastError();
}

// Kc <= 64 and N <= 64 (four k16 steps a tap, m64n64); the tile height is
// cut until the block fits the card's shared memory
template <bool EDGES, bool DX>
cudaError_t launch_tc(const void* x, const void* mask, float mslope,
                      const float* w, const float* bias, void* out, TcShape s,
                      int has_act, float slope, cudaStream_t stream) {
  const int ks = (s.Kc + 15) / 16, np = round_up(s.N, 16);
  if (ks > 4 || np > 64) return cudaErrorInvalidValue;
  s.vec = s.vec && s.Kc % 8 == 0;
#define MUVO_TC_CASE(NP_, KS_)                                            \
  if (np == NP_ && ks == KS_)                                             \
    return launch_tc_t<NP_, KS_, EDGES, DX>(x, mask, mslope, w, bias, out, \
                                            s, has_act, slope, stream);
  MUVO_TC_CASE(16, 1) MUVO_TC_CASE(16, 2) MUVO_TC_CASE(16, 3)
  MUVO_TC_CASE(16, 4) MUVO_TC_CASE(32, 1) MUVO_TC_CASE(32, 2)
  MUVO_TC_CASE(32, 3) MUVO_TC_CASE(32, 4) MUVO_TC_CASE(48, 1)
  MUVO_TC_CASE(48, 2) MUVO_TC_CASE(48, 3) MUVO_TC_CASE(48, 4)
  MUVO_TC_CASE(64, 1) MUVO_TC_CASE(64, 2) MUVO_TC_CASE(64, 3)
  MUVO_TC_CASE(64, 4)
#undef MUVO_TC_CASE
  return cudaErrorInvalidValue;
}

inline bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace tc

namespace {

bool bad_dims(int B, int X, int Y, int Z, int C, int Cout, int dtype) {
  return B <= 0 || X <= 0 || Y <= 0 || Z <= 0 || C <= 0 || Cout <= 0 ||
         B > 65535 || X > 65535 || (dtype != 0 && dtype != 1);
}

}  // namespace

// Plain C interface, called through ctypes. dtype: 0 = fp32, 1 = bf16.
// Each returns a cudaError_t; nonzero means the kernel did not launch.

// K1 on the CUDA cores: bf16 K1 past 64 channels (fp32 too, which
// tools/torch_zconv_probe.py times beside fp32 K1's own kernel). w is (kx,
// ky, kz, C, Cout) in fp32; bias may be null. Elsewhere: bf16 K1 and K2
// muvo_zconv3d_tc, fp32 K1 and K2 zconv_f32.cu's muvo_zconv3d_f32.
extern "C" int muvo_zconv3d_leaky(const void* x, const float* w,
                                  const float* bias, void* out, int B, int X,
                                  int Y, int Z, int C, int Cout, int has_act,
                                  float slope, int dtype, void* stream) {
  if (bad_dims(B, X, Y, Z, C, Cout, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape s{B, X, Y, Z, C, Cout, 16, (C % 2 == 0) ? C + 1 : C,
          round_up(Cout, kCoChunk)};
  if (!pick_ty(s)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(x, nullptr, 0.f, w, bias, out, s, has_act,
                              slope, st);
  return (int)launch<__nv_bfloat16>(x, nullptr, 0.f, w, bias, out, s,
                                    has_act, slope, st);
}

// K1-dx on the CUDA cores: bf16 K1-dx past 64 channels only. g and mask
// (the forward output; null without activation) are (B, X, Y, Z, Cg);
// w_adj is the flipped, transposed kernel (kx, ky, kz, Cg, C) in fp32; dx
// is (B, X, Y, Z, C). Refuses fp32 (zconv_f32.cu's muvo_zconv3d_dx_f32) and
// up (K2-dx: muvo_zconv3d_tc, muvo_zconv3d_dx_f32).
extern "C" int muvo_zconv3d_dx(const void* g, const void* mask, float slope,
                               const float* w_adj, void* dx, int B, int X,
                               int Y, int Z, int Cg, int C, int up, int dtype,
                               void* stream) {
  if (bad_dims(B, X, Y, Z, Cg, C, dtype) || up || dtype != 1)
    return (int)cudaErrorInvalidValue;
  Shape s{B, X, Y, Z, Cg, C, 16, (Cg % 2 == 0) ? Cg + 1 : Cg,
          round_up(C, kCoChunk)};
  if (!pick_ty(s)) return (int)cudaErrorInvalidValue;
  return (int)launch<__nv_bfloat16>(g, mask, slope, w_adj, nullptr, dx, s, 0,
                                    0.f, static_cast<cudaStream_t>(stream));
}

// bf16 K1, K2, K1-dx and K2-dx on the tensor cores (zconv_tc_kernel): the
// 3x3x3 SAME conv of x viewed as (B, X, Y, Zs, Kc) into out viewed as
// (B, X, Y, Zs, N), Kc and N at most 64. w is the view's weights
// (kx, ky, t, Kc, N) in fp32, followed for edges (K2, K2-dx) by the
// centre-tap edge terms (2, 3, 3, Kc, N): ops/zconv.py's pair_fold_weights,
// up_fold_weights or the plain kernel. dx (K1-dx, K2-dx): x is the
// cotangent, masked while staging by mask (the forward output, viewed as x;
// null without activation) with slope mslope; no bias or activation.
// Otherwise output channel n takes bias[n % Cb] (bias may be null), then
// LeakyReLU with slope when has_act.
extern "C" int muvo_zconv3d_tc(const void* x, const void* mask, float mslope,
                               const float* w, const float* bias, void* out,
                               int B, int X, int Y, int Zs, int Kc, int N,
                               int Cb, int edges, int dx, int has_act,
                               float slope, void* stream) {
  if (bad_dims(B, X, Y, Zs, Kc, N, 1) || Cb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tc::TcShape t{B, X, Y, Zs, Kc, N, Cb, 0, 0,
                tc::aligned16(x) && tc::aligned16(mask)};
  if (dx)
    return (int)(edges ? tc::launch_tc<true, true>(x, mask, mslope, w,
                                                   nullptr, out, t, 0, 0.f,
                                                   st)
                       : tc::launch_tc<false, true>(x, mask, mslope, w,
                                                    nullptr, out, t, 0, 0.f,
                                                    st));
  return (int)(edges ? tc::launch_tc<true, false>(x, nullptr, 0.f, w, bias,
                                                  out, t, has_act, slope, st)
                     : tc::launch_tc<false, false>(x, nullptr, 0.f, w, bias,
                                                   out, t, has_act, slope,
                                                   st));
}

extern "C" const char* muvo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
