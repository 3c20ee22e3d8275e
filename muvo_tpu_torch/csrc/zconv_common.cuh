// Helpers shared by the voxel-conv kernels (zconv.cu: K1, K2, K1-dx, K2-dx;
// zconv_dw.cu: K3). Tensors are channels-last NDHWC in fp32 or bf16; every
// kernel computes in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace muvo {

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

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// One value of the haloed input tile at (b, gx, gy, gz, c), gz on the
// kernel's z axis (Z = Zin, or Z = 2 * Zin when UP), zero outside the
// volume (SAME padding). UP interpolates z from the small-z input x (2x
// linear, half-pixel centres, clamped edges):
//   u[2k]   = 0.25 x[max(k-1, 0)] + 0.75 x[k]
//   u[2k+1] = 0.75 x[k]           + 0.25 x[min(k+1, Zin-1)]
// mask (nullable, only without UP) is the forward output of a leaky conv
// at the same position: where it is negative the value is scaled by slope,
// which is the LeakyReLU's derivative applied to a cotangent.
template <typename T, bool UP>
__device__ __forceinline__ float load_voxel(const T* __restrict__ x,
                                            const T* __restrict__ mask,
                                            float slope, int b, int gx,
                                            int gy, int gz, int c, int X,
                                            int Y, int Zin, int Z, int C) {
  if (gx < 0 || gx >= X || gy < 0 || gy >= Y || gz < 0 || gz >= Z) return 0.f;
  const size_t col = (((size_t)b * X + gx) * Y + gy) * (size_t)Zin * C + c;
  if (UP) {
    const int k = gz >> 1;
    const int k2 = (gz & 1) ? min(k + 1, Zin - 1) : max(k - 1, 0);
    const float xk = to_float(x[col + (size_t)k * C]);
    return k2 == k ? xk
                   : 0.75f * xk + 0.25f * to_float(x[col + (size_t)k2 * C]);
  }
  const size_t i = col + (size_t)gz * C;
  float v = to_float(x[i]);
  if (mask != nullptr && to_float(mask[i]) < 0.f) v *= slope;
  return v;
}

}  // namespace muvo
