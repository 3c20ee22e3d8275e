// fp32 K3 and K3-up on Hopper's CUDA cores (sm_90a): the weight and bias
// gradients of the voxel decoder's 3x3x3 convs (fp32 K1 and K2),
//
//   dW[kx, ky, kz, c, co] = sum over b, x, y, z of
//                           u(x)[b, x+kx-1, y+ky-1, z+kz-1, c] * m(g)[b, x, y, z, co]
//   dbias[co]             = sum over b, x, y, z of m(g)[b, x, y, z, co]
//
// u is the identity for K3 and the 2x linear z-upsample for K3-up (the
// kernel interpolates z while staging, as fp32 K2 does, so the upsampled
// input never exists in device memory), zero outside the volume (SAME
// padding). m(g) is the cotangent with the LeakyReLU derivative applied (g
// where the forward output is >= 0, slope * g elsewhere), also applied
// while staging. Inputs are fp32 channels-last NDHWC; dW (27, cp, coutp)
// and dbias (coutp) come out in fp32 from one pass. bf16 K3 and K3-up are
// the tensor-core GEMM of zconv_dw_tc.cu.
//
// Replaces muvo_tpu/ops/pallas_zconv.py::_dw_pallas (:388, pl.pallas_call
// at :505), the one-pass dW of _vjp_bwd (:707, K3) and, per z block, of
// _up_vjp_bwd (:869, K3-up), and the dbias sums beside them. The TPU kernel
// accumulates a banded dW and pulls it back through banded_weight; here
// the (3, 3, 3, C, Cout) gradient is accumulated directly.
//
// Bound on the card: operations, 2 * 27 * C * Cout flops per output voxel at
// 67 TFLOP/s (the CUDA cores), against x, g and the forward output read
// once (C + 2 Cout floats a voxel, K3-up C / 2 + 2 Cout): 2.93 ms for K3
// at conv3.conv2, batch 24, 5.89 for K3-up at conv3.conv1. The design keeps
// the FMA pipes fed, on fp32 K1's and K2's model (zconv_f32.cu):
//
// - Register tile with a sliding z window. A thread owns a unit: one (dx,
//   dy) tap pair x all three dz x 4 input channels (chunk cic) x kCo = 4
//   output channels (chunk coc), 48 fp32 accumulators held across all the
//   block's rows. It walks a run of z at one y row: x at z + 1 arrives as
//   one float4 into a 3-deep register window (x at z - 1, z, z + 1), g at z
//   as one float4, and 48 FMAs follow the 2 shared loads. The loop is
//   unrolled by 3, so the window turns without moves. 8 output channels a
//   thread (96 FMAs a 3 loads) need 224-235 registers, so 8 warps an SM;
//   on an H100 that ran 1.5-1.6x slower at all four stages (PERF.md).
// - Slices. Units are few (9 * cp / 4 * coutp / 4: 36 at conv3.conv2), so
//   ``slices`` threads (a power of two) share a unit over disjoint
//   positions: thread t takes unit t / slices and slice t % slices, and a
//   slice takes the (y row, z segment) pairs slice, slice + slices, ... of
//   each row. Sums run over the positions in a fixed order per thread
//   (rows in the walk's order, pairs, then z ascending); each (block,
//   slice) writes its partial dW to its own row of a workspace, and
//   sum_rows_kernel adds the rows in a fixed order: no atomics, a second
//   launch gives the same bits. Units beyond a block's threads take more
//   launches (``passes``) over the same rows.
// - Banks. A quarter warp's lanes are min(slices, 8) consecutive slices,
//   which at the decoder's stages are consecutive y rows at one z, times
//   8 / that many consecutive units (coc fastest, so lanes that differ only
//   in coc read the same x: a broadcast). The plan pads the plane's and the
//   cotangent's y rows (``ys``, ``gs``) to the stride in float4s at which
//   those loads meet the fewest on one bank (ops/zconv.py::bank_ways). At
//   the four stages none meet: ys 1088, 548, 1060 and 532 floats, gs 512,
//   528, 520 and 516 (conv2.conv1, conv2.conv2, conv3.conv1, conv3.conv2).
// - Planes staged once per run, through a ring. Blocks are persistent:
//   block i walks rows (b, y tile, x) i * rows / grid .. (i + 1) * rows /
//   grid - 1, x innermost. It keeps kPlanes = 3 x planes, the ones the
//   current output row reads, laid out [y][z + 1][cp] (the z halo and the
//   padded channels zeroed once), and the cotangent's ty y rows of the
//   current output row, [y][z][coutp], masked while staged. The next plane
//   (x + 2) and the next row's cotangent arrive in registers during the
//   current row's FMAs (their first kPrefetchX and kPrefetchG items a
//   thread) and are stored after them into the slot of plane x - 1 and
//   over the cotangent; the items past those are loaded and stored there.
//   The x items are zconv_stage.cuh's, shared with fp32 K1 and K2: K3's
//   are kQuad floats of a channels-last y row (one float4 where ``xvec``),
//   K3-up's kRun small z of one (y, c), interpolated while stored.
// - dbias. While the row computes, thread t adds the float4 of channels
//   4 (t % (coutp / 4)) .. of every (threads / (coutp / 4))-th staged
//   cotangent position; at the end the block sums those in a fixed order
//   into its workspace row, and sum_rows_kernel the rows.
//
// The plan (y rows a tile, slices, threads, grid, the row strides) is made
// on the host by ops/zconv.py::dw_f32_plan and passed in as DwF32Shape; a
// plan that does not add up is refused. It takes the most y rows a tile
// (ty) that is a power of two, up to 16, and fits the card's shared
// memory: the slices are a power of two too, so each takes as many (y row,
// z segment) pairs (on an H100, ty 6, 11 and 12 ran up to 1.26x slower
// than 8 and 16; PERF.md). tools/torch_zconv_probe.py times the plan
// against fewer rows. At muvo.yml's stages (batch 24; kThreads = 288
// threads, one block an SM):
//   K3-up conv2.conv1 (96x96x16 small z, 32 -> 16): ty 8, slices 1,
//     146,944 bytes
//   K3    conv2.conv2 (96x96x32, 16 -> 16):          ty 16, slices 2,
//     152,160 bytes
//   K3-up conv3.conv1 (192x192x32 small z, 16 -> 8): ty 8, slices 4,
//     143,840 bytes
//   K3    conv3.conv2 (192x192x64, 8 -> 8):          ty 16, slices 8,
//     147,936 bytes
// ptxas (sm_90a, CUDA 12.8): dw_f32_kernel<false> 151 registers, <true>
// 162, sum_rows_kernel 24; no spill.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "zconv_stage.cuh"

namespace f32dw {

using f32stage::kItemFloats;
using f32stage::kQuad;
using f32stage::kRun;
using f32stage::load_item;
using f32stage::stage_plane;
using f32stage::store_item;

constexpr int kCo = 4;          // output channels a thread
constexpr int kThreads = 288;   // most threads a block, one block an SM
constexpr int kPrefetchX = 5;   // x staging items a thread holds in registers
constexpr int kPrefetchG = 4;   // cotangent items a thread holds in registers
constexpr int kPlanes = 3;      // x planes in shared memory

// ops/zconv.py::DW_F32_FIELDS, in this order
struct DwF32Shape {
  int B, X, Y, Zin, Z, C, Cout;
  int up, xvec, gvec;             // K3-up (1) or K3 (0); float4 x, g rows
  int cp, coutp, ncic, ncoc;      // channels padded; chunks of 4, of kCo
  int nunits, nl, passes, unit0;  // units, units a launch, launches, first
  int slices;                     // threads sharing a unit
  int ty, nyt, nzs, zrun;         // y rows a tile, tiles over Y; z segments
  int ys, plane, gs, gfloats;     // floats: a plane's y row, a plane, a
                                  // cotangent y row, the cotangent rows
  int threads, runs, items;       // staging: x items a y row, a plane
  int gruns, gitems;              // cotangent items a y row, a tile
  int rows, grid, smem_bytes;     // rows B * nyt * X over grid blocks
};

// cotangent item i of output row (b, xo) of tile y0: floats f0 .. f0 + 3 of
// y row yl's Z * Cout, times slope where the forward output is negative;
// zero past Y and past the row
__device__ __forceinline__ void load_g(const float* __restrict__ g,
                                       const float* __restrict__ mask,
                                       float slope, const DwF32Shape& s,
                                       int b, int xo, int y0, int i,
                                       float (&v)[kQuad]) {
  const int yl = i / s.gruns, f0 = (i % s.gruns) * kQuad;
  const int gy = y0 + yl;
  float m[kQuad] = {0.f, 0.f, 0.f, 0.f};
  if (gy >= s.Y) {
#pragma unroll
    for (int j = 0; j < kQuad; ++j) v[j] = 0.f;
    return;
  }
  const size_t off =
      (((size_t)b * s.X + xo) * s.Y + gy) * (size_t)s.Z * s.Cout + f0;
  if (s.gvec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(g + off));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
    if (mask != nullptr) {
      const float4 o = __ldg(reinterpret_cast<const float4*>(mask + off));
      m[0] = o.x;
      m[1] = o.y;
      m[2] = o.z;
      m[3] = o.w;
    }
  } else {
    const int n = s.Z * s.Cout;
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      const bool in = f0 + j < n;
      v[j] = in ? __ldg(g + off + j) : 0.f;
      if (mask != nullptr && in) m[j] = __ldg(mask + off + j);
    }
  }
#pragma unroll
  for (int j = 0; j < kQuad; ++j)
    if (m[j] < 0.f) v[j] *= slope;
}

// float f = z Cout + co of y row yl at [yl][z][co] of the cotangent rows
__device__ __forceinline__ void store_g(float* gt, const DwF32Shape& s, int i,
                                        const float (&v)[kQuad]) {
  const int yl = i / s.gruns, f0 = (i % s.gruns) * kQuad;
  float* row = gt + yl * s.gs;
  if (s.Cout == s.coutp && s.Cout % kQuad == 0) {  // the y row as it is in g
    *reinterpret_cast<float4*>(row + f0) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  int z = f0 / s.Cout, co = f0 - z * s.Cout;
#pragma unroll
  for (int j = 0; j < kQuad; ++j) {
    if (z >= s.Z) break;  // past the y row's Z * Cout floats
    row[z * s.coutp + co] = v[j];
    if (++co == s.Cout) {
      co = 0;
      ++z;
    }
  }
}

// cotangent items from .. gitems - 1 of output row (b, xo) of tile y0
__device__ __forceinline__ void stage_g(float* gt,
                                        const float* __restrict__ g,
                                        const float* __restrict__ mask,
                                        float slope, const DwF32Shape& s,
                                        int b, int xo, int y0, int from) {
  for (int i = threadIdx.x + from; i < s.gitems; i += blockDim.x) {
    float v[kQuad];
    load_g(g, mask, slope, s, b, xo, y0, i, v);
    store_g(gt, s, i, v);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// one output z of the thread's unit: acc[dz][i][k] += x(z - 1 + dz)[i] *
// g(z)[k], x0 .. x2 the window, gp the cotangent's kCo channels at z
__device__ __forceinline__ void dw_step(float (&acc)[3][4][kCo],
                                        const float4& x0, const float4& x1,
                                        const float4& x2, const float* gp) {
  const float4 t = ld4(gp);
  const float gv[kCo] = {t.x, t.y, t.z, t.w};
  const float xs[3][4] = {{x0.x, x0.y, x0.z, x0.w},
                          {x1.x, x1.y, x1.z, x1.w},
                          {x2.x, x2.y, x2.z, x2.w}};
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < kCo; ++k)
        acc[dz][i][k] = fmaf(xs[dz][i], gv[k], acc[dz][i][k]);
}

// the thread's unit over its slice's (y row, z segment) pairs of one output
// row of tile y0; slot (j + dx) % kPlanes holds the plane of tap dx
__device__ __forceinline__ void dw_row(const float* planes, const float* gt,
                                       const DwF32Shape& s, int j, int y0,
                                       int dx, int dy, int cic, int coc,
                                       int slice, float (&acc)[3][4][kCo]) {
  const int cp = s.cp, cq = s.coutp;
  const float* xt =
      planes + ((j + dx) % kPlanes) * s.plane + dy * s.ys + cic * 4;
  const float* gr = gt + coc * kCo;
  const int pairs = s.ty * s.nzs;
#pragma unroll 1
  for (int q = slice; q < pairs; q += s.slices) {
    const int yi = q % s.ty, z0 = (q / s.ty) * s.zrun;
    const int n = min(s.zrun, s.Z - z0);
    if (y0 + yi >= s.Y || n <= 0) continue;  // a ragged tile's empty rows
    const float* xp = xt + yi * s.ys + z0 * cp;  // x at z0 - 1 (padded z0)
    const float* gp = gr + yi * s.gs + z0 * cq;
    float4 xa = ld4(xp), xb = ld4(xp + cp);
    xp += 2 * cp;
    int t = 0;
#pragma unroll 1
    for (; t + 3 <= n; t += 3) {
      const float4 xc = ld4(xp);
      dw_step(acc, xa, xb, xc, gp);
      xa = ld4(xp + cp);
      dw_step(acc, xb, xc, xa, gp + cq);
      xb = ld4(xp + 2 * cp);
      dw_step(acc, xc, xa, xb, gp + 2 * cq);
      xp += 3 * cp;
      gp += 3 * cq;
    }
    if (t < n) {
      const float4 xc = ld4(xp);
      dw_step(acc, xa, xb, xc, gp);
      if (t + 1 < n) dw_step(acc, xb, xc, ld4(xp + cp), gp + cq);
    }
  }
}

// The block's rows (see the note at the top): units unit0 .. unit0 + nl - 1
// into part's rows blockIdx.x * slices .. + slices - 1, and, when
// part_bias is not null, dbias into its row blockIdx.x.
template <bool UP>
__global__ void __launch_bounds__(kThreads, 1)
    dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ mask, float slope,
                  float* __restrict__ part, float* __restrict__ part_bias,
                  DwF32Shape s) {
  // the planes and the cotangent rows; at the end, dbias's sums a thread
  extern __shared__ __align__(16) float smem[];
  float* planes = smem;                  // [kPlanes][ty + 2][ys]
  float* gt = smem + kPlanes * s.plane;  // [ty][gs]
  const int tid = threadIdx.x;
  // halos, padded channels and row pads: staging never writes them
  for (int i = tid; i < kPlanes * s.plane + s.gfloats; i += blockDim.x)
    smem[i] = 0.f;

  const int slice = tid % s.slices, ul = tid / s.slices;
  const int u = s.unit0 + ul;
  const bool worker = ul < s.nl && u < s.nunits;
  const int coc = u % s.ncoc, cic = (u / s.ncoc) % s.ncic;
  const int tap = u / (s.ncoc * s.ncic);  // dx * 3 + dy
  const int dx = tap / 3, dy = tap % 3;
  float acc[3][4][kCo];
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < kCo; ++k) acc[dz][i][k] = 0.f;

  // dbias: thread t sums channels 4 bq .. 4 bq + 3 over positions bp, bp +
  // bstride, ... of each row's staged cotangent
  const int nq = s.coutp / 4, bstride = blockDim.x / nq;
  const int bq = tid % nq, bp = tid / nq;
  const bool bias = part_bias != nullptr && bp < bstride;
  const int npos = s.ty * s.Z;
  float4 bacc = make_float4(0.f, 0.f, 0.f, 0.f);

  long long r = (long long)blockIdx.x * s.rows / s.grid;
  const long long rend = (long long)(blockIdx.x + 1) * s.rows / s.grid;
  while (r < rend) {
    const int seg = (int)(r / s.X), xa = (int)(r % s.X);
    const int xb = (int)min((long long)s.X, xa + (rend - r));
    const int b = seg / s.nyt, y0 = (seg % s.nyt) * s.ty;
    __syncthreads();  // the slots are free, the zeros written
    for (int p = 0; p < kPlanes; ++p)
      stage_plane<UP, true>(planes + p * s.plane, x, s, b, xa - 1 + p, y0,
                            0, s.cp);
    stage_g(gt, g, mask, slope, s, b, xa, y0, 0);
    __syncthreads();

    for (int xo = xa; xo < xb; ++xo) {
      const int j = xo - xa;
      const bool next = xo + 1 < xb;
      // plane xo + 2 and row xo + 1's cotangent into registers, ahead of
      // the row's FMAs
      float px[kPrefetchX][kItemFloats<UP>];
      float pg[kPrefetchG][kQuad];
      if (next) {
#pragma unroll
        for (int q = 0; q < kPrefetchX; ++q) {
          const int i = tid + q * blockDim.x;
          if (i < s.items) load_item<UP>(x, s, b, xo + 2, y0, i, px[q]);
        }
#pragma unroll
        for (int q = 0; q < kPrefetchG; ++q) {
          const int i = tid + q * blockDim.x;
          if (i < s.gitems)
            load_g(g, mask, slope, s, b, xo + 1, y0, i, pg[q]);
        }
      }
      if (bias) {
        for (int pos = bp; pos < npos; pos += bstride) {
          const int yl = pos / s.Z, z = pos - yl * s.Z;
          const float4 t = ld4(gt + yl * s.gs + z * s.coutp + 4 * bq);
          bacc.x += t.x;
          bacc.y += t.y;
          bacc.z += t.z;
          bacc.w += t.w;
        }
      }
      if (worker) dw_row(planes, gt, s, j, y0, dx, dy, cic, coc, slice, acc);
      if (next) {
        __syncthreads();  // every thread is done with the slot and gt
        float* slot = planes + (j % kPlanes) * s.plane;
#pragma unroll
        for (int q = 0; q < kPrefetchX; ++q) {
          const int i = tid + q * blockDim.x;
          if (i < s.items) store_item<UP, true>(slot, s, i, px[q], s.cp);
        }
        stage_plane<UP, true>(slot, x, s, b, xo + 2, y0,
                              kPrefetchX * blockDim.x, s.cp);
#pragma unroll
        for (int q = 0; q < kPrefetchG; ++q) {
          const int i = tid + q * blockDim.x;
          if (i < s.gitems) store_g(gt, s, i, pg[q]);
        }
        stage_g(gt, g, mask, slope, s, b, xo + 1, y0,
                kPrefetchG * blockDim.x);
        __syncthreads();
      }
    }
    r += xb - xa;
  }

  // this (block, slice)'s partial dW: entry ((tap, dz), c, co)
  if (worker) {
    const size_t E = (size_t)27 * s.cp * s.coutp;
    float* dst = part + ((size_t)blockIdx.x * s.slices + slice) * E;
#pragma unroll
    for (int dz = 0; dz < 3; ++dz)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* o = dst + ((size_t)(tap * 3 + dz) * s.cp + cic * 4 + i) *
                             s.coutp + coc * kCo;
        *reinterpret_cast<float4*>(o) = make_float4(
            acc[dz][i][0], acc[dz][i][1], acc[dz][i][2], acc[dz][i][3]);
      }
  }
  if (part_bias != nullptr) {
    __syncthreads();  // every thread is done with the planes
    reinterpret_cast<float4*>(smem)[tid] =
        bias ? bacc : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    for (int co = tid; co < s.coutp; co += blockDim.x) {
      float v = 0.f;
      for (int p = 0; p < bstride; ++p)
        v += smem[(p * nq + co / 4) * 4 + co % 4];
      part_bias[(size_t)blockIdx.x * s.coutp + co] = v;
    }
  }
}

// out[col] = sum over rows of in[row, col], rows in a fixed order: 32
// columns per block, 8 warps taking every 8th row, then the 8 warp sums
__global__ void sum_rows_kernel(const float* __restrict__ in, int rows,
                                int cols, float* __restrict__ out) {
  __shared__ float part[8][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (col < cols)
    for (int r = threadIdx.y; r < rows; r += 8) v += in[(size_t)r * cols + col];
  part[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += part[w][threadIdx.x];
    out[col] = t;
  }
}

cudaError_t sum_rows(const float* in, int rows, int cols, float* out,
                     cudaStream_t st) {
  sum_rows_kernel<<<(cols + 31) / 32, dim3(32, 8), 0, st>>>(in, rows, cols,
                                                            out);
  return cudaGetLastError();
}

template <bool UP>
cudaError_t launch_t(const float* x, const float* g, const float* mask,
                     float slope, float* part, float* part_bias,
                     const DwF32Shape& s, cudaStream_t st) {
  auto kernel = dw_f32_kernel<UP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<s.grid, s.threads, s.smem_bytes, st>>>(x, g, mask, slope, part,
                                                  part_bias, s);
  return cudaGetLastError();
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// the plan's numbers add up to the layout the kernel indexes
bool plan_is_whole(const DwF32Shape& s) {
  if (s.B <= 0 || s.X <= 0 || s.Y <= 0 || s.Zin <= 0 || s.C <= 0 ||
      s.Cout <= 0 || s.ty <= 0 || s.grid <= 0 || s.slices <= 0 ||
      s.nl <= 0 || s.nzs <= 0 || s.zrun <= 0 || (s.up != 0 && s.up != 1) ||
      (long long)s.Zin * s.C >= (1LL << 30) ||
      2LL * s.Zin * s.Cout >= (1LL << 30))
    return false;
  const long long rows = (long long)s.B * s.nyt * s.X;
  const int runs = s.up ? ceil_div(s.Zin, kRun) : ceil_div(s.Zin * s.C, kQuad);
  const bool xvec = s.xvec == 0 ||
                    (s.xvec == 1 && !s.up && (s.Zin * s.C) % kQuad == 0);
  const bool gvec = s.gvec == 0 || (s.gvec == 1 && (s.Z * s.Cout) % 4 == 0);
  // bytes: the planes and cotangent rows, and dbias's sums at the end
  const long long tiles = 4LL * ((long long)kPlanes * s.plane + s.gfloats);
  const long long sums = 16LL * s.threads;
  return s.Z == (s.up ? 2 : 1) * s.Zin && xvec && gvec &&
         s.cp == ceil_div(s.C, 4) * 4 &&
         s.coutp == ceil_div(s.Cout, kCo) * kCo && s.ncic == s.cp / 4 &&
         s.ncoc == s.coutp / kCo && s.nunits == 9 * s.ncic * s.ncoc &&
         s.nl <= s.nunits && s.passes == ceil_div(s.nunits, s.nl) &&
         s.unit0 == 0 && s.threads % 32 == 0 &&
         s.threads >= s.nl * s.slices && s.threads <= kThreads &&
         s.coutp / 4 <= s.threads && s.nyt == ceil_div(s.Y, s.ty) &&
         s.nzs == ceil_div(s.Z, s.zrun) && s.ys % 4 == 0 &&
         s.ys >= (s.Z + 2) * s.cp && s.plane == (s.ty + 2) * s.ys &&
         s.gs % 4 == 0 && s.gs >= s.Z * s.coutp && s.gfloats == s.ty * s.gs &&
         s.runs == runs && s.items == (s.ty + 2) * runs * (s.up ? s.C : 1) &&
         s.gruns == ceil_div(s.Z * s.Cout, kQuad) &&
         s.gitems == s.ty * s.gruns && rows == s.rows && s.grid <= s.rows &&
         s.smem_bytes == (tiles > sums ? tiles : sums);
}

size_t part_rows(const DwF32Shape& s) { return (size_t)s.grid * s.slices; }

size_t entries(const DwF32Shape& s) { return (size_t)27 * s.cp * s.coutp; }

}  // namespace f32dw

// Plain C interface, called through ctypes; each returns a cudaError_t.

// Floats of workspace muvo_zconv3d_dw needs for this plan, into *floats.
extern "C" int muvo_zconv3d_dw_workspace(const f32dw::DwF32Shape* shape,
                                         size_t* floats) {
  const f32dw::DwF32Shape s = *shape;
  if (!f32dw::plan_is_whole(s)) return (int)cudaErrorInvalidValue;
  *floats = f32dw::part_rows(s) * f32dw::entries(s) +
            (size_t)s.grid * s.coutp;
  return 0;
}

// fp32 K3 (shape->up 0) or K3-up (1). x: (B, X, Y, Zin, C) (K3-up: already
// x/y-upsampled, z interpolated here); g and mask (the forward output, null
// without activation): (B, X, Y, Z, Cout). Writes dw (27, cp, coutp) and,
// when dbias is not null, dbias (coutp), both fp32 with the padded channels
// zero.
extern "C" int muvo_zconv3d_dw(const float* x, const float* g,
                               const float* mask, float slope,
                               float* workspace, float* dw, float* dbias,
                               const f32dw::DwF32Shape* shape, void* stream) {
  f32dw::DwF32Shape s = *shape;
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (!f32dw::plan_is_whole(s) || (s.xvec && misaligned(x)) ||
      (s.gvec && (misaligned(g) || (mask != nullptr && misaligned(mask)))))
    return (int)cudaErrorInvalidValue;
  const size_t E = f32dw::entries(s);
  float* part = workspace;
  float* part_bias =
      dbias != nullptr ? workspace + f32dw::part_rows(s) * E : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  // units beyond one launch take more launches over the same rows; only
  // the first sums dbias
  for (int p = 0; p < s.passes && err == cudaSuccess; ++p) {
    s.unit0 = p * s.nl;
    float* pb = p == 0 ? part_bias : nullptr;
    err = s.up ? f32dw::launch_t<true>(x, g, mask, slope, part, pb, s, st)
               : f32dw::launch_t<false>(x, g, mask, slope, part, pb, s, st);
  }
  if (err == cudaSuccess)
    err = f32dw::sum_rows(part, (int)f32dw::part_rows(s), (int)E, dw, st);
  if (err == cudaSuccess && dbias != nullptr)
    err = f32dw::sum_rows(part_bias, s.grid, s.coutp, dbias, st);
  return (int)err;
}

extern "C" const char* muvo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
