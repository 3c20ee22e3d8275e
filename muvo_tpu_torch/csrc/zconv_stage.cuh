// Staging of fp32 x planes, shared by the register-tiled CUDA-core kernels
// of the voxel convs: fp32 K1, K2, K1-dx and K2-dx (zconv_f32.cu) and the
// weight gradients K3 and K3-up (zconv_dw.cu).
//
// A plane is one input x row of a block's y tile (ty + 2 y rows with the y
// halo) over the conv's z axis, z -1 .. Z padded. The staging of a plane is
// cut into items; a thread loads an item into registers (load_item) and
// stores it into the plane (store_item), so that a kernel can load the next
// plane's items ahead of a row's FMAs and store them after it.
// - UP (K2, K3-up): an item is kRun small z of one (y, c) with the two
//   neighbours the interpolation takes, stored as the 2 kRun big z of the
//   2x linear z-upsample (half-pixel centres, clamped edges):
//     u[2k]   = 0.75 x[k] + 0.25 x[k - 1]   (u[0] = x[0])
//     u[2k+1] = 0.75 x[k] + 0.25 x[k + 1]   (u[Z - 1] = x[Zin - 1])
//   so the upsampled input never exists in device memory.
// - plain (K1, K3): an item is kQuad consecutive floats of one y row of x,
//   which is Z * C contiguous floats in channels-last [z][c] order: one
//   16-byte load where the shape's ``xvec`` allows it, else kQuad scalar
//   loads. K1-dx and K2-dx stage the leaky-masked cotangent so: the same
//   floats of g and of the forward output, m(g) stored (masked_value).
// Each kernel picks the plane's layout: y row yy at yy * ys floats, and in
// it channel c at padded z zz at c * rstep + zz ([c][z], ZC false: K1 and
// K2, rstep a padded z row) or at zz * rstep + c ([z][c], ZC true: K3 and
// K3-up, rstep the padded channel count; there a plain item whose channels
// are whole float4s is stored as one). The functions take the kernel's
// shape struct, whose fields X, Y, Zin, Z, C, ys, runs and xvec they read.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace f32stage {

constexpr int kRun = 4;   // UP: small z a staging item
constexpr int kQuad = 4;  // plain: floats of a y row a staging item

// floats a staging item holds: kRun small z and their neighbours, or kQuad
template <bool UP>
constexpr int kItemFloats = UP ? kRun + 2 : kQuad;

// UP staging item i of a plane: small z k0 .. k0 + kRun - 1 of (y row yy, c)
template <class Shape>
__device__ __forceinline__ void item_of(const Shape& s, int i, int& yy,
                                        int& c, int& k0) {
  c = i % s.C;
  const int q = i / s.C;
  k0 = (q % s.runs) * kRun;
  yy = q / s.runs;
}

// UP: x[b, xi, y0 + yy - 1, k0 - 1 .. k0 + kRun (clamped), c];
// plain: floats k0 .. k0 + kQuad - 1 of the y row x[b, xi, y0 + yy - 1],
// zero past its Z * C; both zero outside the volume
template <bool UP, class Shape>
__device__ __forceinline__ void load_item(
    const float* __restrict__ x, const Shape& s, int b, int xi, int y0,
    int i, float (&v)[kItemFloats<UP>]) {
  int yy, c = 0, k0;  // UP: first small z and channel; plain: first float
  if constexpr (UP) {
    item_of(s, i, yy, c, k0);
  } else {
    yy = i / s.runs;
    k0 = (i % s.runs) * kQuad;
  }
  const int gy = y0 + yy - 1;
  if (xi < 0 || xi >= s.X || gy < 0 || gy >= s.Y) {
#pragma unroll
    for (int j = 0; j < kItemFloats<UP>; ++j) v[j] = 0.f;
    return;
  }
  const float* row =
      x + (((size_t)b * s.X + xi) * s.Y + gy) * (size_t)s.Zin * s.C;
  if constexpr (UP) {
#pragma unroll
    for (int j = 0; j < kRun + 2; ++j) {
      const int k = min(max(k0 - 1 + j, 0), s.Zin - 1);
      v[j] = __ldg(row + (size_t)k * s.C + c);
    }
  } else if (s.xvec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(row + k0));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    const int n = s.Z * s.C;
#pragma unroll
    for (int j = 0; j < kQuad; ++j) v[j] = k0 + j < n ? __ldg(row + k0 + j)
                                                      : 0.f;
  }
}

// UP: big z 2k and 2k + 1 of the item's small z k (< Zin), at padded z
// 2k + 1 and 2k + 2; plain: float f = z C + c of the y row at padded z
// z + 1; both in (yy, c)'s row of the plane
template <bool UP, bool ZC, class Shape>
__device__ __forceinline__ void store_item(
    float* plane, const Shape& s, int i, const float (&v)[kItemFloats<UP>],
    int rstep) {
  const auto at = [rstep](int c, int zz) {
    return ZC ? zz * rstep + c : c * rstep + zz;
  };
  if constexpr (UP) {
    int yy, c, k0;
    item_of(s, i, yy, c, k0);
    float* row = plane + yy * s.ys;
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
      const int k = k0 + m;
      if (k >= s.Zin) break;
      const float xk = v[m + 1];
      row[at(c, 2 * k + 1)] = k == 0 ? xk : 0.75f * xk + 0.25f * v[m];
      row[at(c, 2 * k + 2)] =
          k == s.Zin - 1 ? xk : 0.75f * xk + 0.25f * v[m + 2];
    }
  } else {
    const int yy = i / s.runs, f0 = (i % s.runs) * kQuad;
    float* row = plane + yy * s.ys;
    if constexpr (ZC) {
      if (s.C % kQuad == 0) {  // rstep == C: the y row as it is in x
        *reinterpret_cast<float4*>(row + rstep + f0) =
            make_float4(v[0], v[1], v[2], v[3]);
        return;
      }
    }
    int z = f0 / s.C, c = f0 - z * s.C;
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      if (z >= s.Z) break;  // past the y row's Z * C floats
      row[at(c, z + 1)] = v[j];
      if (++c == s.C) {
        c = 0;
        ++z;
      }
    }
  }
}

// the LeakyReLU derivative applied to a cotangent item v, given the same
// floats of the forward output o: v where o >= 0, slope * v elsewhere (as
// ops/zconv.py::leaky_mask)
__device__ __forceinline__ void masked_value(float (&v)[kQuad],
                                             const float (&o)[kQuad],
                                             float slope) {
#pragma unroll
  for (int j = 0; j < kQuad; ++j)
    if (!(o[j] >= 0.f)) v[j] *= slope;
}

// items from .. items - 1 of plane xi of tile (b, y0), load and store in
// one pass, the block's threads taking every blockDim.x-th
template <bool UP, bool ZC, class Shape>
__device__ __forceinline__ void stage_plane(float* plane,
                                            const float* __restrict__ x,
                                            const Shape& s, int b, int xi,
                                            int y0, int from, int rstep) {
  for (int i = threadIdx.x + from; i < s.items; i += blockDim.x) {
    float v[kItemFloats<UP>];
    load_item<UP>(x, s, b, xi, y0, i, v);
    store_item<UP, ZC>(plane, s, i, v, rstep);
  }
}

// the same for plain items of the cotangent g, masked by the forward output
// (null: no activation, g as it is)
template <bool ZC, class Shape>
__device__ __forceinline__ void stage_masked_plane(
    float* plane, const float* __restrict__ g, const float* __restrict__ out,
    float slope, const Shape& s, int b, int xi, int y0, int from,
    int rstep) {
  for (int i = threadIdx.x + from; i < s.items; i += blockDim.x) {
    float v[kQuad];
    load_item<false>(g, s, b, xi, y0, i, v);
    if (out != nullptr) {
      float o[kQuad];
      load_item<false>(out, s, b, xi, y0, i, o);
      masked_value(v, o, slope);
    }
    store_item<false, ZC>(plane, s, i, v, rstep);
  }
}

}  // namespace f32stage
