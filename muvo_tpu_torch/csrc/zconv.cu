// K1, K2 and their input gradients K1-dx, K2-dx: the voxel decoder's 3x3x3
// convolutions on Hopper (sm_90a).
//
//   K1     out = LeakyReLU(conv3d_same(x) + bias)
//   K2     out = LeakyReLU(conv3d_same(up2_z(x)) + bias)
//   K1-dx  dx  = conv3d_same(m(g), flip(w)^T)
//   K2-dx  dx  = up2_z^T(conv3d_same(m(g), flip(w)^T))
//
// x and out are channels-last NDHWC, (B, X, Y, Zin, C) -> (B, X, Y, Z, Cout),
// in fp32 or bf16; weights and bias arrive as fp32, weights in
// (kx, ky, kz, C, Cout) order (for dx the wrapper passes the spatially
// flipped kernel with C and Cout swapped). up2_z is the 2x linear
// z-upsample with half-pixel centres and clamped edges (torch
// align_corners=False), see zconv_common.cuh. m(g) is the LeakyReLU
// derivative applied to the cotangent g: g where the forward output is
// >= 0, slope * g elsewhere.
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
// and in bf16 by bytes. Design, simple first: one block per (b, x, y-tile)
// stages a haloed tile of 3 x-rows * (ty+2) y * (Z+2) z * C in shared
// memory (K2 interpolates z while staging, so the upsampled tensor never
// exists in device memory; the dx kernels apply the leaky mask while
// staging, reading the forward output and g once), keeps all 27*C*Cout
// weights in shared memory, and each thread accumulates 8 output channels
// of one (y, z) voxel in fp32 registers; bias and the leaky slope are
// applied in the epilogue and the result is stored in the input type.
// K2-dx keeps the big-z dx of its tile in shared memory and contracts
// pairs of big-z slices into small z with the upsample's transposed
// weights (0.25 / 0.75, the clamped ends taking the taps that fall off)
// while writing, so the big-z dx never exists in device memory either.
// The channel stride of the tile is odd, so neighbouring threads
// (neighbouring z) read distinct banks. Implicit GEMM on wgmma with TMA
// staging is the faster design for later.

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
  int B, X, Y, Zin, Z, C, Cout;
  int ty;     // y rows per block
  int cs;     // channel stride of the staged tile (odd)
  int coutp;  // Cout rounded up to kCoChunk
  int dxup;   // K2-dx: contract the big-z result into Z / 2 small z
};

__host__ __device__ inline size_t tile_floats(const Shape& s) {
  // rounded to 4 floats so the weight block that follows is 16-byte aligned
  return (size_t)round_up(3 * (s.ty + 2) * (s.Z + 2) * s.cs, 4);
}

inline size_t smem_bytes(const Shape& s) {
  size_t floats = tile_floats(s) + (size_t)27 * s.C * s.coutp;
  if (s.dxup) floats += (size_t)s.ty * s.Z * s.coutp;  // big-z dx of the tile
  return floats * sizeof(float);
}

// weights to shared memory, output channels zero-padded to coutp, and the
// haloed input tile (zero outside the volume)
template <typename T, bool UP>
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
    tile[((dx * TYH + yy) * ZH + zz) * s.cs + c] = load_voxel<T, UP>(
        x, mask, mslope, b, xi + dx - 1, y0 + yy - 1, zz - 1, c, s.X, s.Y,
        s.Zin, s.Z, s.C);
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

// K1 and K2 (and K1-dx: K1 on the masked cotangent, no bias, no activation)
template <typename T, bool UP>
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
  stage<T, UP>(x, mask, mslope, w, tile, wsm, s, b, xi, y0);
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

// weight of big-z slice z in small-z slice k under up2_z^T (Zs small slices)
__device__ __forceinline__ float up_weight(int z, int k, int Zs) {
  const int m = z >> 1;
  float w = 0.f;
  if (z & 1) {
    if (m == k) w += 0.75f;
    if (min(m + 1, Zs - 1) == k) w += 0.25f;
  } else {
    if (max(m - 1, 0) == k) w += 0.25f;
    if (m == k) w += 0.75f;
  }
  return w;
}

// K2-dx: the big-z dx of the tile into shared memory, then up2_z^T
template <typename T>
__global__ void __launch_bounds__(kThreads)
zconv_dxup_kernel(const T* __restrict__ g, const T* __restrict__ mask,
                  float mslope, const float* __restrict__ w,
                  T* __restrict__ dx, Shape s) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;
  float* wsm = smem + tile_floats(s);
  float* dbig = wsm + (size_t)27 * s.C * s.coutp;  // [ty][Z][coutp]
  const int y0 = blockIdx.x * s.ty;
  const int xi = blockIdx.y;
  const int b = blockIdx.z;
  stage<T, false>(g, mask, mslope, w, tile, wsm, s, b, xi, y0);
  __syncthreads();

  const int nchunks = s.coutp / kCoChunk;
  const int nwork = nchunks * s.ty * s.Z;
  for (int item = threadIdx.x; item < nwork; item += blockDim.x) {
    const int z = item % s.Z;
    const int r = item / s.Z;
    const int ty = r % s.ty;
    const int cc = r / s.ty;
    float acc[kCoChunk];
    conv_point(tile, wsm, s, ty, z, cc, acc);
    float* d = dbig + ((size_t)ty * s.Z + z) * s.coutp + cc * kCoChunk;
#pragma unroll
    for (int j = 0; j < kCoChunk; ++j) d[j] = acc[j];
  }
  __syncthreads();

  // small slice k gathers big slices 2k-2 .. 2k+3 (the clamped ends add
  // the quarter taps that fall off the volume)
  const int Zs = s.Z / 2;
  const int nout = s.ty * Zs * s.Cout;
  for (int item = threadIdx.x; item < nout; item += blockDim.x) {
    const int c = item % s.Cout;
    const int r = item / s.Cout;
    const int k = r % Zs;
    const int ty = r / Zs;
    const int gy = y0 + ty;
    if (gy >= s.Y) continue;
    float v = 0.f;
    for (int z = max(2 * k - 2, 0); z <= min(2 * k + 3, s.Z - 1); ++z)
      v = fmaf(up_weight(z, k, Zs), dbig[((size_t)ty * s.Z + z) * s.coutp + c],
               v);
    dx[((((size_t)b * s.X + xi) * s.Y + gy) * Zs + k) * s.Cout + c] =
        from_float<T>(v);
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

template <typename T, bool UP>
cudaError_t launch(const void* x, const void* mask, float mslope,
                   const float* w, const float* bias, void* out, Shape s,
                   int has_act, float slope, cudaStream_t stream) {
  auto kernel = zconv_kernel<T, UP>;
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

template <typename T>
cudaError_t launch_dxup(const void* g, const void* mask, float mslope,
                        const float* w, void* dx, Shape s,
                        cudaStream_t stream) {
  auto kernel = zconv_dxup_kernel<T>;
  const size_t smem = smem_bytes(s);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s.Y + s.ty - 1) / s.ty, s.X, s.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(mask), mslope, w,
      static_cast<T*>(dx), s);
  return cudaGetLastError();
}

bool bad_dims(int B, int X, int Y, int Z, int C, int Cout, int dtype) {
  return B <= 0 || X <= 0 || Y <= 0 || Z <= 0 || C <= 0 || Cout <= 0 ||
         B > 65535 || X > 65535 || (dtype != 0 && dtype != 1);
}

}  // namespace

// Plain C interface, called through ctypes. dtype: 0 = fp32, 1 = bf16.
// Each returns a cudaError_t; nonzero means the kernel did not launch.

// K1 / K2. up: 0 = K1 (Z = Zin), 1 = K2 (Z = 2 * Zin). bias may be null.
extern "C" int muvo_zconv3d_leaky(const void* x, const float* w,
                                  const float* bias, void* out, int B, int X,
                                  int Y, int Zin, int C, int Cout, int up,
                                  int has_act, float slope, int dtype,
                                  void* stream) {
  if (bad_dims(B, X, Y, Zin, C, Cout, dtype))
    return (int)cudaErrorInvalidValue;
  Shape s{B, X, Y, Zin, up ? 2 * Zin : Zin, C, Cout, 16,
          (C % 2 == 0) ? C + 1 : C, round_up(Cout, kCoChunk), 0};
  if (!pick_ty(s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(up ? launch<float, true>(x, nullptr, 0.f, w, bias, out, s,
                                          has_act, slope, st)
                    : launch<float, false>(x, nullptr, 0.f, w, bias, out, s,
                                           has_act, slope, st));
  return (int)(up ? launch<__nv_bfloat16, true>(x, nullptr, 0.f, w, bias, out,
                                                s, has_act, slope, st)
                  : launch<__nv_bfloat16, false>(x, nullptr, 0.f, w, bias,
                                                 out, s, has_act, slope, st));
}

// K1-dx / K2-dx. g and mask (the forward output; null without activation)
// are (B, X, Y, Z, Cg); w_adj is the flipped, transposed kernel
// (kx, ky, kz, Cg, C) in fp32; dx is (B, X, Y, Z, C) for K1-dx (up 0) and
// (B, X, Y, Z / 2, C) for K2-dx (up 1, Z even).
extern "C" int muvo_zconv3d_dx(const void* g, const void* mask, float slope,
                               const float* w_adj, void* dx, int B, int X,
                               int Y, int Z, int Cg, int C, int up, int dtype,
                               void* stream) {
  if (bad_dims(B, X, Y, Z, Cg, C, dtype) || (up && Z % 2 != 0))
    return (int)cudaErrorInvalidValue;
  Shape s{B, X, Y, Z, Z, Cg, C, 16, (Cg % 2 == 0) ? Cg + 1 : Cg,
          round_up(C, kCoChunk), up};
  if (!pick_ty(s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (up)
    return (int)(dtype == 0
                     ? launch_dxup<float>(g, mask, slope, w_adj, dx, s, st)
                     : launch_dxup<__nv_bfloat16>(g, mask, slope, w_adj, dx,
                                                  s, st));
  return (int)(dtype == 0 ? launch<float, false>(g, mask, slope, w_adj,
                                                 nullptr, dx, s, 0, 0.f, st)
                          : launch<__nv_bfloat16, false>(
                                g, mask, slope, w_adj, nullptr, dx, s, 0, 0.f,
                                st));
}

extern "C" const char* muvo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
