// K3: the weight and bias gradients of the voxel decoder's 3x3x3 convs
// (K1 and K2) on Hopper (sm_90a).
//
//   dW[kx, ky, kz, c, co] = sum over b, x, y, z of
//                           u(x)[b, x+kx-1, y+ky-1, z+kz-1, c] * m(g)[b, x, y, z, co]
//   dbias[co]             = sum over b, x, y, z of m(g)[b, x, y, z, co]
//
// u is the identity for K1 and the 2x linear z-upsample for K2 (UP; the
// kernel interpolates z while staging, as K2's forward does, so the
// upsampled input never exists in device memory), zero outside the volume
// (SAME padding). m(g) is the cotangent with the LeakyReLU derivative
// applied (g where the forward output is >= 0, slope * g elsewhere), also
// applied while staging: g and the forward output are each read once.
// Inputs are channels-last NDHWC in fp32 or bf16; every sum is fp32, and
// dW and dbias come out in fp32.
//
// Replaces muvo_tpu/ops/pallas_zconv.py::_dw_pallas (the one-pass dW of
// _vjp_bwd and, per block, of _up_vjp_bwd) and the XLA dbias reductions
// beside it. The TPU kernel accumulates a banded dW and pulls it back
// through the band builder; here the (3, 3, 3, C, Cout) gradient is
// accumulated directly.
//
// Bound on the card: 2 * 27 * C * Cout flops per output voxel against
// reading the input and the cotangent (and forward output) once; at the
// decoder's shapes (C, Cout <= 32) that is bound by operations in fp32 (the
// CUDA cores) and by bytes in bf16. Design, simple first: persistent blocks
// (two per SM) walk tiles of (b, x, ty rows of y); each stages a haloed
// input tile of 3 x-rows * (ty+2) y * (Z+2) z * C and the masked cotangent
// tile ty * Z * Cout in shared memory. A thread owns one or two units of
// 4 input x 8 output channels at one tap (32 fp32 accumulators each, held
// in registers across all the block's tiles); where there are fewer units
// than threads, several threads take the same unit over disjoint slices
// of the tile's positions. Each (block, slice) writes its partial dW to its
// own row of a workspace, and a second small kernel sums the rows in a
// fixed order: deterministic, no atomics, and at most 2 * 132 * 4 rows of
// 27 * C * Cout floats (about 29 MB at the widest stage). dbias falls out
// of the same pass: each thread sums one output channel over a stride of
// the staged cotangent, and the block reduces those sums in a fixed order.

#include "zconv_common.cuh"

using muvo::load_voxel;
using muvo::round_up;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxUnitsPerThread = 2;
constexpr int kBlocksPerSm = 2;
constexpr size_t kSmemSoftCap = 100 * 1024;

struct DwShape {
  int B, X, Y, Zin, Z, C, Cout;
  int ty;      // y rows per tile
  int cp;      // C rounded up to 4: the input tile's channel stride
  int gp;      // Cout rounded up to 8: the cotangent tile's channel stride
  int nyt;     // y tiles per x row
  int ntiles;  // B * X * nyt
  int nunits;  // 27 * (cp / 4) * (gp / 8)
  int unit0;   // first unit of this launch
  int nl;      // units in this launch
  int slices;  // threads sharing a unit (over disjoint positions)
  int grid;    // blocks
};

inline size_t dw_smem_floats(const DwShape& s) {
  return (size_t)3 * (s.ty + 2) * (s.Z + 2) * s.cp +
         (size_t)s.ty * s.Z * s.gp + kThreads;
}

template <typename T, bool UP, int UPT>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
          const T* __restrict__ mask, float slope, float* __restrict__ part,
          float* __restrict__ part_bias, DwShape s) {
  extern __shared__ __align__(16) float smem[];
  const int TYH = s.ty + 2, ZH = s.Z + 2;
  float* xt = smem;                                 // [3][TYH][ZH][cp]
  float* gt = xt + (size_t)3 * TYH * ZH * s.cp;     // [ty][Z][gp]
  float* red = gt + (size_t)s.ty * s.Z * s.gp;      // [kThreads]
  const int tid = threadIdx.x;
  const int npos = s.ty * s.Z;
  const int E = 27 * s.cp * s.gp;

  // this thread's units and position slice
  const int p = UPT == 1 ? tid / s.nl : 0;
  const bool active = UPT == 1 ? p < s.slices : true;
  int xoff[UPT], goff[UPT], eoff[UPT];
  bool has[UPT];
#pragma unroll
  for (int k = 0; k < UPT; ++k) {
    const int ul = UPT == 1 ? tid % s.nl : tid + k * kThreads;
    has[k] = active && ul < s.nl;
    const int u = s.unit0 + (has[k] ? ul : 0);
    const int coc = u % (s.gp / 8);
    const int r = u / (s.gp / 8);
    const int cic = r % (s.cp / 4);
    const int tap = r / (s.cp / 4);
    const int dx = tap / 9, dy = (tap / 3) % 3, dz = tap % 3;
    xoff[k] = ((dx * TYH + dy) * ZH + dz) * s.cp + cic * 4;
    goff[k] = coc * 8;
    eoff[k] = (tap * s.cp + cic * 4) * s.gp + coc * 8;
  }
  float acc[UPT][4][8];
#pragma unroll
  for (int k = 0; k < UPT; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][i][j] = 0.f;

  // dbias: thread sums channel bc over positions br, br + bR, ...
  const bool do_bias = part_bias != nullptr;
  const int bR = kThreads / s.gp;
  const int bc = tid % s.gp, br = tid / s.gp;
  float bacc = 0.f;

  for (int tile = blockIdx.x; tile < s.ntiles; tile += gridDim.x) {
    const int yt = tile % s.nyt;
    const int r = tile / s.nyt;
    const int xi = r % s.X;
    const int b = r / s.X;
    const int y0 = yt * s.ty;
    __syncthreads();  // the previous tile's reads are done
    const int nx = 3 * TYH * ZH * s.cp;
    for (int i = tid; i < nx; i += kThreads) {
      const int c = i % s.cp;
      int q = i / s.cp;
      const int zz = q % ZH;
      q /= ZH;
      const int yy = q % TYH;
      const int dx = q / TYH;
      xt[i] = c < s.C ? load_voxel<T, UP>(x, nullptr, 0.f, b, xi + dx - 1,
                                          y0 + yy - 1, zz - 1, c, s.X, s.Y,
                                          s.Zin, s.Z, s.C)
                      : 0.f;
    }
    const int ng = npos * s.gp;
    for (int i = tid; i < ng; i += kThreads) {
      const int co = i % s.gp;
      const int q = i / s.gp;
      const int z = q % s.Z;
      const int yl = q / s.Z;
      gt[i] = co < s.Cout ? load_voxel<T, false>(g, mask, slope, b, xi,
                                                 y0 + yl, z, co, s.X, s.Y,
                                                 s.Z, s.Z, s.Cout)
                          : 0.f;
    }
    __syncthreads();

    if (do_bias && br < bR)
      for (int pos = br; pos < npos; pos += bR) bacc += gt[pos * s.gp + bc];

    if (active) {
      for (int pos = p; pos < npos; pos += s.slices) {
        const int yl = pos / s.Z;
        const int z = pos - yl * s.Z;
        const int xbase = (yl * ZH + z) * s.cp;
#pragma unroll
        for (int k = 0; k < UPT; ++k) {
          if (!has[k]) continue;
          const float4 xv =
              *reinterpret_cast<const float4*>(xt + xbase + xoff[k]);
          const float* gp = gt + pos * s.gp + goff[k];
          const float4 g0 = *reinterpret_cast<const float4*>(gp);
          const float4 g1 = *reinterpret_cast<const float4*>(gp + 4);
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
          const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[k][i][j] = fmaf(xs[i], gs[j], acc[k][i][j]);
        }
      }
    }
  }

  // this (block, slice)'s partial row
  const size_t row = (size_t)blockIdx.x * s.slices + p;
#pragma unroll
  for (int k = 0; k < UPT; ++k) {
    if (!has[k]) continue;
    float* dst = part + row * E + eoff[k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[i * s.gp + j] = acc[k][i][j];
  }
  if (do_bias) {
    __syncthreads();
    red[tid] = br < bR ? bacc : 0.f;
    __syncthreads();
    if (tid < s.gp) {
      float v = 0.f;
      for (int q = 0; q < bR; ++q) v += red[q * s.gp + tid];
      part_bias[(size_t)blockIdx.x * s.gp + tid] = v;
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

// the shape and work split of a call; identical in the workspace query
// and the launch
cudaError_t plan(DwShape& s, int B, int X, int Y, int Zin, int C, int Cout,
                 int up) {
  if (B <= 0 || X <= 0 || Y <= 0 || Zin <= 0 || C <= 0 || Cout <= 0 ||
      Cout > kThreads)
    return cudaErrorInvalidValue;
  int device = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  s = DwShape{};
  s.B = B, s.X = X, s.Y = Y, s.Zin = Zin, s.Z = up ? 2 * Zin : Zin;
  s.C = C, s.Cout = Cout, s.cp = round_up(C, 4), s.gp = round_up(Cout, 8);
  s.ty = 8;
  while (s.ty > 1 && (s.ty >= 2 * Y ||
                      dw_smem_floats(s) * sizeof(float) > kSmemSoftCap))
    s.ty /= 2;
  if (dw_smem_floats(s) * sizeof(float) > (size_t)optin)
    return cudaErrorInvalidValue;
  s.nyt = (Y + s.ty - 1) / s.ty;
  s.ntiles = B * X * s.nyt;
  s.nunits = 27 * (s.cp / 4) * (s.gp / 8);
  s.grid = s.ntiles < kBlocksPerSm * sms ? s.ntiles : kBlocksPerSm * sms;
  s.slices = s.nunits < kThreads ? kThreads / s.nunits : 1;
  return cudaSuccess;
}

template <typename T, bool UP, int UPT>
cudaError_t launch_dw(const void* x, const void* g, const void* mask,
                      float slope, float* part, float* part_bias,
                      const DwShape& s, cudaStream_t st) {
  auto kernel = dw_kernel<T, UP, UPT>;
  const size_t smem = dw_smem_floats(s) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<s.grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(mask), slope, part, part_bias, s);
  return cudaGetLastError();
}

template <typename T, bool UP>
cudaError_t run(const void* x, const void* g, const void* mask, float slope,
                float* part, float* part_bias, DwShape s, cudaStream_t st) {
  // one launch when the units fit the block, else launches of
  // kMaxUnitsPerThread * kThreads units each; only the first sums dbias
  for (s.unit0 = 0; s.unit0 < s.nunits; s.unit0 += s.nl) {
    const int left = s.nunits - s.unit0;
    s.nl = left < kMaxUnitsPerThread * kThreads ? left
                                                : kMaxUnitsPerThread * kThreads;
    float* pb = s.unit0 == 0 ? part_bias : nullptr;
    cudaError_t err =
        s.nl <= kThreads
            ? launch_dw<T, UP, 1>(x, g, mask, slope, part, pb, s, st)
            : launch_dw<T, UP, 2>(x, g, mask, slope, part, pb, s, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

size_t part_rows(const DwShape& s) { return (size_t)s.grid * s.slices; }

}  // namespace

// Plain C interface, called through ctypes; each returns a cudaError_t.

// Floats of workspace muvo_zconv3d_dw needs for this shape, into *floats.
extern "C" int muvo_zconv3d_dw_workspace(int B, int X, int Y, int Zin, int C,
                                         int Cout, int up, size_t* floats) {
  DwShape s;
  cudaError_t err = plan(s, B, X, Y, Zin, C, Cout, up);
  if (err != cudaSuccess) return (int)err;
  *floats = part_rows(s) * 27 * s.cp * s.gp + (size_t)s.grid * s.gp;
  return 0;
}

// K3. x: (B, X, Y, Zin, C) (K2: already x/y-upsampled, up = 1 interpolates
// z); g and mask (the forward output, null without activation): (B, X, Y,
// Z, Cout). Writes dw (27, round_up(C, 4), round_up(Cout, 8)) and, when
// dbias is not null, dbias (round_up(Cout, 8)), both fp32 with the padded
// channels zero. dtype: 0 = fp32, 1 = bf16.
extern "C" int muvo_zconv3d_dw(const void* x, const void* g, const void* mask,
                               float slope, float* workspace, float* dw,
                               float* dbias, int B, int X, int Y, int Zin,
                               int C, int Cout, int up, int dtype,
                               void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  DwShape s;
  cudaError_t err = plan(s, B, X, Y, Zin, C, Cout, up);
  if (err != cudaSuccess) return (int)err;
  const int E = 27 * s.cp * s.gp;
  float* part = workspace;
  float* part_bias = dbias != nullptr ? workspace + part_rows(s) * E : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = up ? run<float, true>(x, g, mask, slope, part, part_bias, s, st)
             : run<float, false>(x, g, mask, slope, part, part_bias, s, st);
  else
    err = up ? run<__nv_bfloat16, true>(x, g, mask, slope, part, part_bias, s,
                                        st)
             : run<__nv_bfloat16, false>(x, g, mask, slope, part, part_bias,
                                         s, st);
  if (err != cudaSuccess) return (int)err;
  err = sum_rows(part, (int)part_rows(s), E, dw, st);
  if (err == cudaSuccess && dbias != nullptr)
    err = sum_rows(part_bias, s.grid, s.gp, dbias, st);
  return (int)err;
}

extern "C" const char* muvo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
