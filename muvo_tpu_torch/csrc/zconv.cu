// K1 and K2: the voxel decoder's 3x3x3 convolutions on Hopper (sm_90a).
//
//   K1  out = LeakyReLU(conv3d_same(x) + bias)
//   K2  out = LeakyReLU(conv3d_same(up2_z(x)) + bias)
//
// x and out are channels-last NDHWC, (B, X, Y, Zin, C) -> (B, X, Y, Z, Cout),
// in fp32 or bf16; weights and bias arrive as fp32, weights in
// (kx, ky, kz, C, Cout) order. up2_z is the 2x linear z-upsample with
// half-pixel centres and clamped edges (torch align_corners=False):
//   u[2k]   = 0.25 x[max(k-1, 0)]     + 0.75 x[k]
//   u[2k+1] = 0.75 x[k]               + 0.25 x[min(k+1, Zin-1)]
//
// Replaces muvo_tpu/ops/pallas_zconv.py::_zconv_pallas_raw as called by
// zconv3d_leaky_folded (K1) and upzconv3d_leaky_folded (K2). The Pallas
// kernel's banded (f+2)C x fCout weights, 128-lane z-blocks and padded-IO
// layouts exist for the TPU's (8, 128) tiles and are not carried over: the
// folded (B, X, Y, Z*C) tensor has the same bytes as NDHWC, which this
// kernel reads and writes directly.
//
// Bound on the card: at the serving shapes (C, Cout <= 32) the function does
// 27*C*2 flops per output element against ~(C + Cout) * 4 bytes of traffic,
// so in fp32 it is bound by operations (the CUDA cores' fp32 rate) and in
// bf16 by bytes. Design, simple first: one block per (b, x, y-tile) stages a
// haloed tile of 3 x-rows * (ty+2) y * (Z+2) z * C in shared memory (K2
// interpolates z while staging, so the upsampled tensor never exists in
// device memory), keeps all 27*C*Cout weights in shared memory, and each
// thread accumulates 8 output channels of one (y, z) voxel in fp32
// registers; bias and the leaky slope are applied in the epilogue and the
// result is stored in the input type. The channel stride of the tile is
// odd, so neighbouring threads (neighbouring z) read distinct banks.
// Implicit-GEMM on wgmma with TMA staging is the faster design for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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
};

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

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ __device__ inline size_t tile_floats(const Shape& s) {
  // rounded to 4 floats so the weight block that follows is 16-byte aligned
  return (size_t)round_up(3 * (s.ty + 2) * (s.Z + 2) * s.cs, 4);
}

inline size_t smem_bytes(const Shape& s) {
  return (tile_floats(s) + (size_t)27 * s.C * s.coutp) * sizeof(float);
}

template <typename T, bool UP>
__global__ void __launch_bounds__(kThreads)
zconv_kernel(const T* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, T* __restrict__ out, Shape s,
             int has_act, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int TYH = s.ty + 2;
  const int ZH = s.Z + 2;
  float* tile = smem;                  // [3][TYH][ZH][cs]
  float* wsm = smem + tile_floats(s);  // [27][C][coutp]
  const int y0 = blockIdx.x * s.ty;
  const int xi = blockIdx.y;
  const int b = blockIdx.z;

  // weights, output channels zero-padded to coutp
  const int nw = 27 * s.C * s.coutp;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int co = i % s.coutp;
    const int tap_c = i / s.coutp;
    wsm[i] = co < s.Cout ? w[(size_t)tap_c * s.Cout + co] : 0.f;
  }

  // haloed input tile, zero outside the volume (SAME padding); K2 builds
  // the upsampled z column from the small-z input here
  const int ntile = 3 * TYH * ZH * s.C;
  for (int i = threadIdx.x; i < ntile; i += blockDim.x) {
    const int c = i % s.C;
    int r = i / s.C;
    const int zz = r % ZH;
    r /= ZH;
    const int yy = r % TYH;
    const int dx = r / TYH;
    const int gx = xi + dx - 1, gy = y0 + yy - 1, gz = zz - 1;
    float v = 0.f;
    if (gx >= 0 && gx < s.X && gy >= 0 && gy < s.Y && gz >= 0 && gz < s.Z) {
      const T* col = x + (((size_t)b * s.X + gx) * s.Y + gy) *
                             (size_t)s.Zin * s.C + c;
      if (UP) {
        const int k = gz >> 1;
        const int k2 = (gz & 1) ? min(k + 1, s.Zin - 1) : max(k - 1, 0);
        const float xk = to_float(col[(size_t)k * s.C]);
        v = k2 == k ? xk
                    : 0.75f * xk + 0.25f * to_float(col[(size_t)k2 * s.C]);
      } else {
        v = to_float(col[(size_t)gz * s.C]);
      }
    }
    tile[((dx * TYH + yy) * ZH + zz) * s.cs + c] = v;
  }
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

template <typename T, bool UP>
cudaError_t launch(const void* x, const float* w, const float* bias,
                   void* out, Shape s, int has_act, float slope,
                   cudaStream_t stream) {
  auto kernel = zconv_kernel<T, UP>;
  const size_t smem = smem_bytes(s);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s.Y + s.ty - 1) / s.ty, s.X, s.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, bias, static_cast<T*>(out), s, has_act,
      slope);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, called through ctypes. dtype: 0 = fp32, 1 = bf16.
// up: 0 = K1 (Z = Zin), 1 = K2 (Z = 2 * Zin). bias may be null. Returns a
// cudaError_t; nonzero means the kernel did not launch.
extern "C" int muvo_zconv3d_leaky(const void* x, const float* w,
                                  const float* bias, void* out, int B, int X,
                                  int Y, int Zin, int C, int Cout, int up,
                                  int has_act, float slope, int dtype,
                                  void* stream) {
  if (B <= 0 || X <= 0 || Y <= 0 || Zin <= 0 || C <= 0 || Cout <= 0 ||
      B > 65535 || X > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;

  Shape s{B, X, Y, Zin, up ? 2 * Zin : Zin, C, Cout, 16,
          (C % 2 == 0) ? C + 1 : C, round_up(Cout, kCoChunk)};
  // tallest y tile (<= 16, no taller than needed) under the soft cap, or
  // failing that the tallest that fits the card at all
  while (s.ty > 1 && (s.ty >= 2 * Y || smem_bytes(s) > kSmemSoftCap)) s.ty /= 2;
  if (smem_bytes(s) > kSmemSoftCap) {
    for (s.ty = 16;
         s.ty > 1 && (s.ty >= 2 * Y || smem_bytes(s) > (size_t)optin);
         s.ty /= 2) {
    }
  }
  if (smem_bytes(s) > (size_t)optin) return (int)cudaErrorInvalidValue;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(up ? launch<float, true>(x, w, bias, out, s, has_act, slope, st)
                    : launch<float, false>(x, w, bias, out, s, has_act, slope, st));
  return (int)(up ? launch<__nv_bfloat16, true>(x, w, bias, out, s, has_act,
                                                slope, st)
                  : launch<__nv_bfloat16, false>(x, w, bias, out, s, has_act,
                                                 slope, st));
}

extern "C" const char* muvo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
