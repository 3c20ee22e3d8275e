// Helpers of the voxel-conv kernels in zconv.cu (K1, K2, K1-dx, K2-dx).
// Tensors are channels-last NDHWC in fp32 or bf16; every kernel computes in
// fp32.
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

// One value of the haloed input tile at (b, gx, gy, gz, c), zero outside
// the volume (SAME padding). mask (nullable) is the forward output of a
// leaky conv at the same position: where it is negative the value is
// scaled by slope, which is the LeakyReLU's derivative applied to a
// cotangent.
template <typename T>
__device__ __forceinline__ float load_voxel(const T* __restrict__ x,
                                            const T* __restrict__ mask,
                                            float slope, int b, int gx,
                                            int gy, int gz, int c, int X,
                                            int Y, int Z, int C) {
  if (gx < 0 || gx >= X || gy < 0 || gy >= Y || gz < 0 || gz >= Z) return 0.f;
  const size_t i =
      ((((size_t)b * X + gx) * Y + gy) * (size_t)Z + gz) * (size_t)C + c;
  float v = to_float(x[i]);
  if (mask != nullptr && to_float(mask[i]) < 0.f) v *= slope;
  return v;
}

}  // namespace muvo
