// fp32 K1 and K2 on Hopper's CUDA cores (sm_90a): the voxel decoder's
// 3x3x3 convs on the serving path,
//
//   K1: out = LeakyReLU(conv3d_same(x) + bias)
//   K2: out = LeakyReLU(conv3d_same(up2_z(x)) + bias)
//
// channels-last fp32: K1 x (B, X, Y, Z, C) -> out (B, X, Y, Z, Cout); K2 x
// (B, X, Y, Zin, C) -> out (B, X, Y, Z = 2 Zin, Cout); weights (kx, ky, kz,
// C, Cout) and bias in fp32. up2_z is the 2x linear z-upsample with
// half-pixel centres and clamped edges (torch align_corners=False):
//   u[2k]   = 0.75 x[k] + 0.25 x[k - 1]   (u[0] = x[0])
//   u[2k+1] = 0.75 x[k] + 0.25 x[k + 1]   (u[Z - 1] = x[Zin - 1])
// and the conv's SAME padding is zero outside the volume, at z -1 and Z.
//
// Replaces muvo_tpu/ops/pallas_zconv.py::_zconv_pallas_raw as called by
// zconv3d_leaky_folded (K1) and upzconv3d_leaky_folded (K2) in fp32. The
// TPU kernel folds z into banded z-block weights for its 128-lane tiles
// (and K2's upsample into them); here K2's upsampled tensor is
// interpolated while staging and never exists in device memory.
//
// Bound on the card: operations. 2 * 27 * C * Cout flops per output voxel
// against (C + Cout) * 4 bytes for K1 (54 flops a byte at conv3.conv2, C 8,
// Cout 8) and (C / 2 + Cout) * 4 for K2 (27,648 flops per 96 bytes at
// conv2.conv1, C 32, Cout 16), so the fp32 pipes (67 TFLOP/s) bound both at
// any batch, and the design's aim is to keep the FMA pipes fed. One
// template, conv_walk<CO, UP>, runs both; UP changes only the staging, so
// K1 and K2 share the register tile, the plane ring and the walk:
//
// - A thread owns kRZ = 4 consecutive output z x CO (4 or 8) output
//   channels of one (x, y) and keeps them in fp32 registers. For each
//   (dx, dy, c) it reads the 6 input z its window needs as two float4 (one
//   tap window of 4 outputs plus the 2-slice halo), and for each dz one
//   float4 (CO 8: two) of weights, then does 3 * 4 * CO FMAs: 48 FMAs per 5
//   shared loads at CO 4, 96 per 8 at CO 8. The 8 lanes of a quarter warp
//   are 8 consecutive z groups of one (y, c), 128 contiguous bytes, so the
//   input loads are free of bank conflicts; the lanes of a warp share one
//   channel chunk, so the weight loads are broadcasts. Sums run dx, dy, c,
//   dz in that order, with no atomics: a second launch gives the same bits.
// - The weights (27 C Cout floats: 27 KB at conv2.conv2, 55 KB at
//   conv2.conv1) stay in shared memory for the whole block, chunk-major, so
//   a thread's weights for a (dx, dy) are one run at compile-time strides.
// - A plane is one input x row of the block's ty + 2 y rows, laid out
//   [y][c][z] with the z halo (z -1 and Z .. zs - 2) zeroed once. The
//   block keeps kPlanes = 3 planes, the ones its current output row reads.
//   The next plane arrives in registers while the row computes: each thread
//   starts its share of plane x + 2's loads (kPrefetch items) before the
//   row's FMAs, and after them stores it into the slot of plane x - 1 (a
//   fourth plane would cost shared memory, and so y rows, for nothing). So
//   every input plane is read once per run of rows, not three times. The
//   items are zconv_stage.cuh's, which K3 and K3-up (zconv_dw.cu) share:
//   - K2's item is kRun small z of one (y, c), with the neighbours the
//     interpolation takes: 6 scalar loads at stride C, 8 big z stored.
//   - K1's item is kQuad = 4 consecutive floats of one y row of x, which is
//     Z * C contiguous floats in channels-last [z][c] order: one coalesced
//     16-byte load where the row allows it (``xvec``: Z * C a multiple of
//     4 and x 16-byte aligned), else 4 scalar loads, transposed into the
//     plane's [c][z] as it is stored. At both muvo.yml stages a y row is
//     512 floats, so a warp loads 512 contiguous bytes; the scattered
//     stores hit at most two lanes a bank (C 16), none at C 8.
// - Persistent blocks: block i walks rows (b, y tile, x) i * rows / grid ..
//   (i + 1) * rows / grid - 1 with x innermost, one run per (b, y tile) it
//   touches; a run stages its first three planes, then one a row.
//
// The plan (y rows a tile, CO, threads, grid, the plane layout) is made on
// the host by ops/zconv.py::f32_plan and passed in as F32Shape; a plan that
// does not add up is refused. At muvo.yml's stages: K2 conv2.conv1 ty 8,
// CO 4, 256 threads, 194 KB; conv3.conv1 ty 12, CO 4, 384 threads, 197 KB;
// K1 conv2.conv2 ty 16, CO 4, 512 threads, 152 KB; conv3.conv2 ty 16, CO 4,
// 512 threads, 124 KB; one block an SM (its registers fill the SM's file).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "zconv_stage.cuh"

namespace f32conv {

using f32stage::kItemFloats;
using f32stage::kQuad;
using f32stage::kRun;
using f32stage::load_item;
using f32stage::stage_plane;
using f32stage::store_item;

constexpr int kRZ = 4;          // output z a thread
constexpr int kPrefetch = 5;    // staging items a thread holds in registers
constexpr int kPlanes = 3;      // x planes in shared memory
constexpr int kMaxThreads = 512;

// ops/zconv.py::F32_FIELDS, in this order
struct F32Shape {
  int B, X, Y, Zin, Z, C, Cout;
  int up, xvec;                     // K2 (1) or K1 (0); K1's rows as float4
  int rz, co, coutp, nchunks, ngz;  // register tile, channel chunks, z groups
  int ty, nyt;                      // y rows a tile, tiles over Y
  int zs, ys, plane, wfloats;       // floats: a (y, c) row, a y row, a plane,
                                    // the weights
  int threads, runs, items;         // staging: items a (y, c) row (K2) or a
                                    // y row (K1), items a plane
  int rows, grid, xs;               // rows B * nyt * X over grid blocks,
                                    // at most xs a block
  int smem_bytes;
};

// the thread's kRZ x CO outputs of one row: z 4g .. 4g + 3 of y row yi,
// channels cc * CO .. cc * CO + CO - 1; slot (j + dx) % kPlanes holds the
// plane of tap dx
template <int CO>
__device__ __forceinline__ void conv_row(const float* planes,
                                         const float* wsm, const F32Shape& s,
                                         int j, int yi, int g, int cc,
                                         float (&acc)[kRZ][CO]) {
#pragma unroll
  for (int r = 0; r < kRZ; ++r)
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[r][k] = 0.f;
  const float* wchunk = wsm + (size_t)cc * 27 * s.C * CO;
#pragma unroll 1
  for (int dx = 0; dx < 3; ++dx) {
    const float* pl = planes + ((j + dx) % kPlanes) * s.plane + g * kRZ;
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy) {
      const float* ip = pl + (yi + dy) * s.ys;
      const float* wp = wchunk + (size_t)(dx * 3 + dy) * s.C * 3 * CO;
#pragma unroll 4
      for (int c = 0; c < s.C; ++c) {
        const float4 lo = *reinterpret_cast<const float4*>(ip);
        const float4 hi = *reinterpret_cast<const float4*>(ip + 4);
        const float in[kRZ + 2] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y};
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          float wv[CO];
#pragma unroll
          for (int q = 0; q < CO / 4; ++q) {
            const float4 t =
                *reinterpret_cast<const float4*>(wp + dz * CO + 4 * q);
            wv[4 * q] = t.x;
            wv[4 * q + 1] = t.y;
            wv[4 * q + 2] = t.z;
            wv[4 * q + 3] = t.w;
          }
#pragma unroll
          for (int r = 0; r < kRZ; ++r)
#pragma unroll
            for (int k = 0; k < CO; ++k)
              acc[r][k] = fmaf(in[r + dz], wv[k], acc[r][k]);
        }
        ip += s.zs;
        wp += 3 * CO;
      }
    }
  }
}

// the block's rows (see the note at the top); smem holds the weights, then
// the kPlanes planes
template <int CO, bool UP>
__device__ __forceinline__ void conv_walk(float* smem,
                                          const float* __restrict__ x,
                                          const float* __restrict__ w,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out,
                                          const F32Shape& s, int has_act,
                                          float slope) {
  float* wsm = smem;                 // [nchunks][kx ky][C][kz][CO]
  float* planes = smem + s.wfloats;  // [kPlanes][ty + 2][C][zs]

  for (int i = threadIdx.x; i < s.wfloats; i += blockDim.x) {
    const int k = i % CO;
    int r = i / CO;
    const int kz = r % 3;
    r /= 3;
    const int c = r % s.C;
    r /= s.C;
    const int kxy = r % 9, co = (r / 9) * CO + k;
    wsm[i] = co < s.Cout ? w[(((size_t)kxy * 3 + kz) * s.C + c) * s.Cout + co]
                         : 0.f;
  }
  // the z halo of every (slot, y, c) row: padded z 0 and Z + 1 .. zs - 1
  const int pad = s.zs - s.Z;
  for (int i = threadIdx.x; i < kPlanes * (s.ty + 2) * s.C * pad;
       i += blockDim.x) {
    const int p = i % pad;
    planes[(i / pad) * s.zs + (p == 0 ? 0 : s.Z + p)] = 0.f;
  }

  const int g = threadIdx.x % s.ngz;
  const int yi = (threadIdx.x / s.ngz) % s.ty;
  const int cc = threadIdx.x / (s.ngz * s.ty);
  const bool worker = cc < s.nchunks;
  float bv[CO];
#pragma unroll
  for (int k = 0; k < CO; ++k) {
    const int co = cc * CO + k;
    bv[k] = (bias != nullptr && worker && co < s.Cout) ? bias[co] : 0.f;
  }
  const bool vec_out = (s.Cout & 3) == 0 && (cc + 1) * CO <= s.Cout;

  long long r = (long long)blockIdx.x * s.rows / s.grid;
  const long long rend = (long long)(blockIdx.x + 1) * s.rows / s.grid;
  while (r < rend) {
    const int seg = (int)(r / s.X), xa = (int)(r % s.X);
    const int xb = (int)min((long long)s.X, xa + (rend - r));
    const int b = seg / s.nyt, y0 = (seg % s.nyt) * s.ty;
    __syncthreads();  // the slots are free, the halo and weights written
    for (int p = 0; p < kPlanes; ++p)
      stage_plane<UP, false>(planes + p * s.plane, x, s, b, xa - 1 + p, y0,
                             0, s.zs);
    __syncthreads();

    for (int xo = xa; xo < xb; ++xo) {
      const int j = xo - xa;
      const bool next = xo + 1 < xb;
      // plane xo + 2 into registers, ahead of the row's FMAs
      float pf[kPrefetch][kItemFloats<UP>];
      if (next) {
#pragma unroll
        for (int q = 0; q < kPrefetch; ++q) {
          const int i = threadIdx.x + q * blockDim.x;
          if (i < s.items) load_item<UP>(x, s, b, xo + 2, y0, i, pf[q]);
        }
      }
      const int gy = y0 + yi;
      if (worker && gy < s.Y) {
        float acc[kRZ][CO];
        conv_row<CO>(planes, wsm, s, j, yi, g, cc, acc);
        float* o = out + (((size_t)b * s.X + xo) * s.Y + gy) * (size_t)s.Z *
                             s.Cout + cc * CO;
#pragma unroll
        for (int rz = 0; rz < kRZ; ++rz) {
          const int z = g * kRZ + rz;
          if (z >= s.Z) break;
          float v[CO];
#pragma unroll
          for (int k = 0; k < CO; ++k) {
            v[k] = acc[rz][k] + bv[k];
            if (has_act && v[k] < 0.f) v[k] *= slope;
          }
          float* oz = o + (size_t)z * s.Cout;
          if (vec_out) {
#pragma unroll
            for (int q = 0; q < CO / 4; ++q)
              *reinterpret_cast<float4*>(oz + 4 * q) = make_float4(
                  v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
          } else {
#pragma unroll
            for (int k = 0; k < CO; ++k)
              if (cc * CO + k < s.Cout) oz[k] = v[k];
          }
        }
      }
      if (next) {
        __syncthreads();  // every thread is done with plane xo - 1's slot
        float* slot = planes + (j % kPlanes) * s.plane;
#pragma unroll
        for (int q = 0; q < kPrefetch; ++q) {
          const int i = threadIdx.x + q * blockDim.x;
          if (i < s.items) store_item<UP, false>(slot, s, i, pf[q], s.zs);
        }
        stage_plane<UP, false>(slot, x, s, b, xo + 2, y0,
                               kPrefetch * blockDim.x, s.zs);
        __syncthreads();
      }
    }
    r += xb - xa;
  }
}

// fp32 K1, named apart from K2 so that a profile tells them apart
template <int CO>
__global__ void __launch_bounds__(kMaxThreads, 1)
    zconv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out,
                     F32Shape s, int has_act, float slope) {
  extern __shared__ __align__(16) float smem[];
  conv_walk<CO, false>(smem, x, w, bias, out, s, has_act, slope);
}

// fp32 K2
template <int CO>
__global__ void __launch_bounds__(kMaxThreads, 1)
    zconv_up_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ out, F32Shape s, int has_act,
                        float slope) {
  extern __shared__ __align__(16) float smem[];
  conv_walk<CO, true>(smem, x, w, bias, out, s, has_act, slope);
}

template <int CO>
cudaError_t launch_t(const float* x, const float* w, const float* bias,
                     float* out, const F32Shape& s, int has_act, float slope,
                     cudaStream_t stream) {
  auto kernel = s.up ? zconv_up_f32_kernel<CO> : zconv_f32_kernel<CO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<s.grid, s.threads, s.smem_bytes, stream>>>(x, w, bias, out, s,
                                                      has_act, slope);
  return cudaGetLastError();
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// the plan's numbers add up to the layout the kernel indexes
bool plan_is_whole(const F32Shape& s) {
  if (s.B <= 0 || s.X <= 0 || s.Y <= 0 || s.Zin <= 0 || s.C <= 0 ||
      s.Cout <= 0 || s.ty <= 0 || s.grid <= 0 || (s.up != 0 && s.up != 1) ||
      (long long)s.Zin * s.C >= (1LL << 30))
    return false;
  const long long rows = (long long)s.B * s.nyt * s.X;
  const int runs = s.up ? ceil_div(s.Zin, kRun) : ceil_div(s.Zin * s.C, kQuad);
  const bool xvec = s.xvec == 0 ||
                    (s.xvec == 1 && !s.up && (s.Zin * s.C) % kQuad == 0);
  return s.Z == (s.up ? 2 : 1) * s.Zin && xvec && s.rz == kRZ &&
         (s.co == 4 || s.co == 8) &&
         s.coutp == ceil_div(s.Cout, s.co) * s.co &&
         s.nchunks == s.coutp / s.co && s.ngz == ceil_div(s.Z, kRZ) &&
         s.zs == s.ngz * kRZ + 4 && s.ys == s.C * s.zs &&
         s.plane == (s.ty + 2) * s.ys && s.wfloats == 27 * s.C * s.coutp &&
         s.threads % 32 == 0 && s.threads >= s.ngz * s.ty * s.nchunks &&
         s.threads <= kMaxThreads && s.runs == runs &&
         s.items == (s.ty + 2) * runs * (s.up ? s.C : 1) &&
         s.nyt == ceil_div(s.Y, s.ty) && rows == s.rows && s.grid <= s.rows &&
         (long long)s.smem_bytes ==
             4LL * (s.wfloats + (long long)kPlanes * s.plane);
}

}  // namespace f32conv

// Plain C interface, called through ctypes; each returns a cudaError_t.

extern "C" int muvo_zconv_f32_limits(int* sms, int* smem_optin) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}

// fp32 K1 (shape->up 0) or K2 (1): x (B, X, Y, Zin, C), w (kx, ky, kz, C,
// Cout), bias (Cout,) or null, out (B, X, Y, Z, Cout); LeakyReLU with slope
// when has_act.
extern "C" int muvo_zconv3d_f32(const float* x, const float* w,
                                const float* bias, float* out,
                                const f32conv::F32Shape* shape, int has_act,
                                float slope, void* stream) {
  const f32conv::F32Shape s = *shape;
  if (!f32conv::plan_is_whole(s) ||
      (s.xvec && reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s.co == 4)
    return (int)f32conv::launch_t<4>(x, w, bias, out, s, has_act, slope, st);
  return (int)f32conv::launch_t<8>(x, w, bias, out, s, has_act, slope, st);
}

extern "C" const char* muvo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
