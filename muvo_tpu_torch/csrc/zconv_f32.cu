// fp32 K1, K2, K1-dx and K2-dx on Hopper's CUDA cores (sm_90a): the voxel
// decoder's 3x3x3 convs and their input gradients,
//
//   K1     out = LeakyReLU(conv3d_same(x) + bias)
//   K2     out = LeakyReLU(conv3d_same(up2_z(x)) + bias)
//   K1-dx  dx  = conv3d_same(m(g), flip(w)^T)
//   K2-dx  dx  = up2_z^T(conv3d_same(m(g), flip(w)^T))
//
// channels-last fp32: K1 x (B, X, Y, Z, C) -> out (B, X, Y, Z, Cout); K2 x
// (B, X, Y, Zin, C) -> out (B, X, Y, Z = 2 Zin, Cout); weights (kx, ky, kz,
// C, Cout) and bias in fp32. up2_z is the 2x linear z-upsample with
// half-pixel centres and clamped edges (torch align_corners=False):
//   u[2k]   = 0.75 x[k] + 0.25 x[k - 1]   (u[0] = x[0])
//   u[2k+1] = 0.75 x[k] + 0.25 x[k + 1]   (u[Z - 1] = x[Zin - 1])
// and the conv's SAME padding is zero outside the volume, at z -1 and Z.
// m(g) is the LeakyReLU derivative applied to the cotangent g: g where the
// forward output is >= 0, slope * g elsewhere (no mask without activation).
//
// Replaces muvo_tpu/ops/pallas_zconv.py::_zconv_pallas_raw as called by
// zconv3d_leaky_folded (K1), upzconv3d_leaky_folded (K2), _vjp_bwd's dx
// (K1-dx) and _up_vjp_bwd's dx (K2-dx) in fp32. The TPU kernel folds z
// into banded z-block weights for its 128-lane tiles (and K2's upsample,
// or its transpose, into them); here K2's upsampled tensor is interpolated
// while staging and never exists in device memory, and neither does a
// big-z gradient of K2-dx.
//
// Bound on the card: operations. 2 * 27 * C * Cout flops per output voxel
// against (C + Cout) * 4 bytes for K1 (54 flops a byte at conv3.conv2, C 8,
// Cout 8) and (C / 2 + Cout) * 4 for K2 (27,648 flops per 96 bytes at
// conv2.conv1, C 32, Cout 16); the dx kernels read g and the forward
// output and write dx, the same order. So the fp32 pipes (67 TFLOP/s) bound
// all four at any batch, and the design's aim is to keep the FMA pipes
// fed. One template, conv_walk<CO, UP, DX, EDGES>, runs them; the flavours
// change only the staging and the epilogue (and K2-dx adds a pass after
// the walk), so all share the register tile, the plane ring and the walk:
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
//   - DX (K1-dx, K2-dx): K1's item on the cotangent, loaded with the same
//     floats of the forward output (``xvec`` needs both aligned) and stored
//     as m(g); both stay in registers across the row's FMAs (8 floats an
//     item), since masking on arrival would stall the row on the loads. No
//     elementwise pass masks g first: that would be a temporary the size of
//     g (1.81 GB at conv3, batch 24) and another read and write of it.
// - Persistent blocks: block i walks rows (b, y tile, x) i * rows / grid ..
//   (i + 1) * rows / grid - 1 with x innermost, one run per (b, y tile) it
//   touches; a run stages its first three planes, then one a row.
//
// K1-dx is K1's walk on the masked cotangent with the flipped, transposed
// kernel (ops/zconv.py::_kkkcn(w, adjoint=True)): C = the forward's Cout,
// Cout = its C. K2-dx is the same walk on a view with the same bytes: g and
// the forward output (B, X, Y, 2 Zs, Cout) as (B, X, Y, Zs, 2 Cout), output
// channel p Cout + co of small slice k being big z 2k + p, and dx (B, X, Y,
// Zs, C) is a 3x3x3 SAME conv of it with the adjoint fold
// (ops/zconv.py::up_fold_weights(w, adjoint=True), main (3, 3, 3, 2 Cout,
// C), the same function as pallas_zconv.py::up_banded_adjoint_weight
// without its lane layout) plus two centre-tap edge terms, (2, 3, 3,
// 2 Cout, C): a 3x3 conv of small slices 0 and Zs - 1 into the same
// slices, which each block adds to the rows it walked once the walk is
// done (edge_pass), with the edge weights staged in the shared memory the
// walk has freed. Beside the planes there is no room for them at
// conv2.conv1 (110.6 + 73.7 KB of weights), and read from device memory
// inside the row they stalled it (measured on the card: as long as the
// walk). The pass takes 1.3 ms of K2-dx's 11.4 at conv3.conv1 and 0.9 of
// 7.0 at conv2.conv1 (batch 24, NVIDIA H100 80GB HBM3 at 700 W,
// tools/torch_zconv_probe.py --parts dx32).
// K1-dx and K2-dx take CO 4 only: CO 8's tile with the doubled prefetch
// passes the 128 registers a thread of 512 may hold (K1's CO 8 takes 125
// without the mask); ptxas gives zconv_dx_f32_kernel 113 registers and
// zconv_dxup_f32_kernel 119, no spill. Their epilogue has no bias or
// activation.
//
// The plan (y rows a tile, CO, threads, grid, the plane layout) is made on
// the host by ops/zconv.py::f32_plan and passed in as F32Shape; a plan that
// does not add up is refused. At muvo.yml's stages: K2 conv2.conv1 ty 8,
// CO 4, 256 threads, 194 KB; conv3.conv1 ty 12, CO 4, 384 threads, 197 KB;
// K1 conv2.conv2 ty 16, CO 4, 512 threads, 152 KB; conv3.conv2 ty 16, CO 4,
// 512 threads, 124 KB; one block an SM (its registers fill the SM's file).
// K1-dx and K2-dx at batch 24 (CO 4): K1-dx conv2.conv2 (16 -> 16) ty 16,
// 512 threads, 152 KB; conv3.conv2 (8 -> 8) ty 16, 512, 124 KB; K2-dx
// conv2.conv1 (view 32 -> 32, Zs 16) ty 12, 384 threads, 218 KB;
// conv3.conv1 (view 16 -> 16, Zs 32) ty 16, 512, 152 KB. The widest they
// take (the fold doubles K2-dx's weights, and CO 4 caps a y row at 512
// threads): K1-dx at z 64 and the forward's Cout 8, C 128 (the parent
// zconv_kernel<float> took 240); K1-dx at z 32 and Cout 16, C 120 (120);
// K2-dx at small z 32 and C 8, the forward's Cout 53 (the parent
// zconv_dxup_kernel<float> took 71); at small z 16 and C 32, Cout 27 (48).
// At conv2.conv1 the forward's Cout is 16.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "zconv_stage.cuh"

namespace f32conv {

using f32stage::kItemFloats;
using f32stage::kQuad;
using f32stage::kRun;
using f32stage::load_item;
using f32stage::masked_value;
using f32stage::stage_masked_plane;
using f32stage::stage_plane;
using f32stage::store_item;

constexpr int kRZ = 4;          // output z a thread
constexpr int kPrefetch = 5;    // staging items a thread holds in registers
constexpr int kPlanes = 3;      // x planes in shared memory
constexpr int kMaxThreads = 512;
constexpr int kDxCo = 4;        // K1-dx's and K2-dx's output channels a
                                // thread (their only register tile)
constexpr int kEdgeBatch = 8;   // K2-dx's edge pass: loads a thread issues
                                // before it stores them

// ops/zconv.py::F32_FIELDS, in this order
struct F32Shape {
  int B, X, Y, Zin, Z, C, Cout;
  int up, dx, edges;                // K2 staging; K1-dx / K2-dx (the masked
                                    // cotangent, no bias or activation);
                                    // K2-dx's edge terms
  int xvec;                         // plain rows (and the mask's) as float4
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

// K2-dx's centre-tap edge terms, after the block's walk: edges[q], a 3x3
// (dx, dy) conv of the masked cotangent at small slice k_q (k_0 = 0, k_1 =
// Z - 1), added to the dx the walk wrote at slice k_q (both at slice 0
// where Z = 1) of each of the block's rows, by the block itself and so in
// a fixed order. The walk is done with shared memory by then, so the edge
// weights (2, 3, 3, C, Cout), two thirds of the main ones, are staged
// there, [q][dx dy][c][coutp], and so are the two slices of the 3 x planes
// each row reads, masked, R rows at a time (R = the z groups: then they
// take at most half the walk's planes): [row][dx][y][q C + c] at an odd y
// stride, loaded c fastest (coalesced), kEdgeBatch loads a thread in
// flight. An item is one (row, chunk, y), both slices, y fastest: a warp's
// weight loads are broadcasts and its plane loads hit distinct banks.
// (Read from device memory in the walk's rows, the edge weights stalled
// them as long as the walk took, 18.43 against 10.10 ms at conv3.conv1,
// batch 24, on the H100 above; read after the walk straight from device
// memory, one y row a lane, the pass took 2.5 ms.)
template <int CO>
__device__ __forceinline__ void edge_pass(float* smem,
                                          const float* __restrict__ g,
                                          const float* __restrict__ mask,
                                          float slope,
                                          const float* __restrict__ wedge,
                                          float* __restrict__ dx,
                                          const F32Shape& s, int r0,
                                          int r1) {
  static_assert(CO == 4, "an edge item is one float4 of weights a c");
  __syncthreads();  // the walk's dx written, its planes no longer read
  float* ew = smem;                       // [2][9][C][coutp]
  const int nw = 18 * s.C * s.coutp;
  float* ep = ew + nw;                    // [R][3][ty + 2][es]
  const int es = 2 * s.C + 1;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int n = i % s.coutp, rest = i / s.coutp;
    ew[i] = n < s.Cout ? wedge[(size_t)rest * s.Cout + n] : 0.f;
  }
  const int per_row = s.nchunks * s.ty;
  const int R = max(1, min((int)blockDim.x / per_row, s.ngz));
  // the staged rows' b and their first plane's x - 1 and y0 - 1: [R][3]
  int* rows = reinterpret_cast<int*>(ep + R * 3 * (s.ty + 2) * es);
  const int seg_len = 2 * s.C, plane_len = (s.ty + 2) * seg_len;
  for (int rb = r0; rb < r1; rb += R) {
    const int nr = min(R, r1 - rb);
    __syncthreads();  // the weights written, the last rows' slices read
    if ((int)threadIdx.x < nr) {
      const int r = rb + threadIdx.x, seg = r / s.X;
      rows[3 * threadIdx.x] = seg / s.nyt;
      rows[3 * threadIdx.x + 1] = r % s.X - 1;
      rows[3 * threadIdx.x + 2] = seg % s.nyt * s.ty - 1;
    }
    __syncthreads();
    // kEdgeBatch loads a thread in flight before any is used
    const int total = nr * 3 * plane_len;
    for (int i0 = threadIdx.x; i0 < total; i0 += kEdgeBatch * blockDim.x) {
      float v[kEdgeBatch], o[kEdgeBatch];
      int at[kEdgeBatch];
#pragma unroll
      for (int u = 0; u < kEdgeBatch; ++u) {
        const int i = i0 + u * blockDim.x;
        v[u] = o[u] = 0.f;
        at[u] = -1;
        if (i >= total) continue;
        const int pl = i / plane_len, in_pl = i - pl * plane_len;
        const int yy = in_pl / seg_len, qc = in_pl - yy * seg_len;
        const int q = qc >= s.C, c = qc - q * s.C;
        const int rr = pl / 3, tx = pl - rr * 3;
        const int b = rows[3 * rr], gx = rows[3 * rr + 1] + tx;
        const int gy = rows[3 * rr + 2] + yy;
        at[u] = (pl * (s.ty + 2) + yy) * es + qc;
        if (gx >= 0 && gx < s.X && gy >= 0 && gy < s.Y) {
          const size_t off = ((((size_t)b * s.X + gx) * s.Y + gy) * s.Z +
                              (q ? s.Z - 1 : 0)) * s.C + c;
          v[u] = __ldg(g + off);
          if (mask != nullptr) o[u] = __ldg(mask + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kEdgeBatch; ++u)
        if (at[u] >= 0) ep[at[u]] = o[u] >= 0.f ? v[u] : v[u] * slope;
    }
    __syncthreads();
    if ((int)threadIdx.x >= nr * per_row) continue;
    const int yi = threadIdx.x % s.ty, cc = threadIdx.x / s.ty % s.nchunks;
    const int rr = threadIdx.x / per_row;
    const int b = rows[3 * rr], xo = rows[3 * rr + 1] + 1;
    const int gy = rows[3 * rr + 2] + 1 + yi;
    if (gy >= s.Y) continue;
    float e[2][CO];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int m = 0; m < CO; ++m) e[q][m] = 0.f;
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const float* ip =
          ep + ((rr * 3 + t / 3) * (s.ty + 2) + yi + t % 3) * es;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* wp = ew + (size_t)(q * 9 + t) * s.C * s.coutp + cc * CO;
#pragma unroll 4
        for (int c = 0; c < s.C; ++c) {
          const float v = ip[q * s.C + c];
          const float4 w4 =
              *reinterpret_cast<const float4*>(wp + (size_t)c * s.coutp);
          e[q][0] = fmaf(v, w4.x, e[q][0]);
          e[q][1] = fmaf(v, w4.y, e[q][1]);
          e[q][2] = fmaf(v, w4.z, e[q][2]);
          e[q][3] = fmaf(v, w4.w, e[q][3]);
        }
      }
    }
    float* o = dx + (((size_t)b * s.X + xo) * s.Y + gy) * (size_t)s.Z * s.Cout +
               cc * CO;
#pragma unroll
    for (int m = 0; m < CO; ++m) {
      if (cc * CO + m >= s.Cout) break;
      if (s.Z == 1) {
        o[m] += e[0][m] + e[1][m];
      } else {
        o[m] += e[0][m];
        o[(size_t)(s.Z - 1) * s.Cout + m] += e[1][m];
      }
    }
  }
}

// the block's rows (see the note at the top); smem holds the weights, then
// the kPlanes planes. DX (K1-dx, K2-dx): x is the cotangent g, masked while
// staged by the forward output ``mask`` (null: none) with ``slope``; no
// bias or activation; EDGES adds K2-dx's edge terms (edge_pass) after the
// walk.
template <int CO, bool UP, bool DX = false, bool EDGES = false>
__device__ __forceinline__ void conv_walk(
    float* smem, const float* __restrict__ x, const float* __restrict__ mask,
    const float* __restrict__ w, const float* __restrict__ wedge,
    const float* __restrict__ bias, float* __restrict__ out,
    const F32Shape& s, int has_act, float slope) {
  static_assert(!(UP && DX) && (DX || !EDGES), "K1, K2, K1-dx or K2-dx");
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
    bv[k] = (!DX && bias != nullptr && worker && co < s.Cout) ? bias[co]
                                                              : 0.f;
  }
  const bool vec_out = (s.Cout & 3) == 0 && (cc + 1) * CO <= s.Cout;
  // a plane's staging: the masked cotangent (DX) or x
  const auto stage = [&](float* plane, int b, int xi, int y0, int from) {
    if constexpr (DX)
      stage_masked_plane<false>(plane, x, mask, slope, s, b, xi, y0, from,
                                s.zs);
    else
      stage_plane<UP, false>(plane, x, s, b, xi, y0, from, s.zs);
  };

  long long r = (long long)blockIdx.x * s.rows / s.grid;
  const long long rend = (long long)(blockIdx.x + 1) * s.rows / s.grid;
  while (r < rend) {
    const int seg = (int)(r / s.X), xa = (int)(r % s.X);
    const int xb = (int)min((long long)s.X, xa + (rend - r));
    const int b = seg / s.nyt, y0 = (seg % s.nyt) * s.ty;
    __syncthreads();  // the slots are free, the halo and weights written
    for (int p = 0; p < kPlanes; ++p)
      stage(planes + p * s.plane, b, xa - 1 + p, y0, 0);
    __syncthreads();

    for (int xo = xa; xo < xb; ++xo) {
      const int j = xo - xa;
      const bool next = xo + 1 < xb;
      // plane xo + 2 into registers, ahead of the row's FMAs (DX: the
      // cotangent and the forward output, masked when stored)
      float pf[kPrefetch][kItemFloats<UP>];
      float pm[kPrefetch][DX ? kQuad : 1];
      if (next) {
#pragma unroll
        for (int q = 0; q < kPrefetch; ++q) {
          const int i = threadIdx.x + q * blockDim.x;
          if (i < s.items) {
            load_item<UP>(x, s, b, xo + 2, y0, i, pf[q]);
            if constexpr (DX)
              if (mask != nullptr)
                load_item<false>(mask, s, b, xo + 2, y0, i, pm[q]);
          }
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
            if (!DX && has_act && v[k] < 0.f) v[k] *= slope;
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
          if (i < s.items) {
            if constexpr (DX)
              if (mask != nullptr) masked_value(pf[q], pm[q], slope);
            store_item<UP, false>(slot, s, i, pf[q], s.zs);
          }
        }
        stage(slot, b, xo + 2, y0, kPrefetch * blockDim.x);
        __syncthreads();
      }
    }
    r += xb - xa;
  }
  if constexpr (EDGES)
    edge_pass<CO>(smem, x, mask, slope, wedge, out, s,
                  (int)((long long)blockIdx.x * s.rows / s.grid), (int)rend);
}

// fp32 K1, named apart from K2 so that a profile tells them apart
template <int CO>
__global__ void __launch_bounds__(kMaxThreads, 1)
    zconv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out,
                     F32Shape s, int has_act, float slope) {
  extern __shared__ __align__(16) float smem[];
  conv_walk<CO, false>(smem, x, nullptr, w, nullptr, bias, out, s, has_act,
                       slope);
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
  conv_walk<CO, true>(smem, x, nullptr, w, nullptr, bias, out, s, has_act,
                      slope);
}

// fp32 K1-dx: K1's walk on the masked cotangent (plain view)
__global__ void __launch_bounds__(kMaxThreads, 1)
    zconv_dx_f32_kernel(const float* __restrict__ g,
                        const float* __restrict__ mask, float slope,
                        const float* __restrict__ w, float* __restrict__ dx,
                        F32Shape s) {
  extern __shared__ __align__(16) float smem[];
  conv_walk<kDxCo, false, true>(smem, g, mask, w, nullptr, nullptr, dx, s, 0,
                                slope);
}

// fp32 K2-dx: the same walk on the small-z view, with the edge terms
__global__ void __launch_bounds__(kMaxThreads, 1)
    zconv_dxup_f32_kernel(const float* __restrict__ g,
                          const float* __restrict__ mask, float slope,
                          const float* __restrict__ w,
                          const float* __restrict__ wedge,
                          float* __restrict__ dx, F32Shape s) {
  extern __shared__ __align__(16) float smem[];
  conv_walk<kDxCo, false, true, true>(smem, g, mask, w, wedge, nullptr, dx,
                                      s, 0, slope);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, const F32Shape& s) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem_bytes);
}

template <int CO>
cudaError_t launch_t(const float* x, const float* w, const float* bias,
                     float* out, const F32Shape& s, int has_act, float slope,
                     cudaStream_t stream) {
  auto kernel = s.up ? zconv_up_f32_kernel<CO> : zconv_f32_kernel<CO>;
  cudaError_t err = allow_smem(kernel, s);
  if (err != cudaSuccess) return err;
  kernel<<<s.grid, s.threads, s.smem_bytes, stream>>>(x, w, bias, out, s,
                                                      has_act, slope);
  return cudaGetLastError();
}

cudaError_t launch_dx(const float* g, const float* mask, float slope,
                      const float* w, const float* wedge, float* dx,
                      const F32Shape& s, cudaStream_t stream) {
  cudaError_t err = s.edges ? allow_smem(zconv_dxup_f32_kernel, s)
                            : allow_smem(zconv_dx_f32_kernel, s);
  if (err != cudaSuccess) return err;
  if (s.edges)
    zconv_dxup_f32_kernel<<<s.grid, s.threads, s.smem_bytes, stream>>>(
        g, mask, slope, w, wedge, dx, s);
  else
    zconv_dx_f32_kernel<<<s.grid, s.threads, s.smem_bytes, stream>>>(
        g, mask, slope, w, dx, s);
  return cudaGetLastError();
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// the plan's numbers add up to the layout the kernel indexes
bool plan_is_whole(const F32Shape& s) {
  if (s.B <= 0 || s.X <= 0 || s.Y <= 0 || s.Zin <= 0 || s.C <= 0 ||
      s.Cout <= 0 || s.ty <= 0 || s.grid <= 0 || (s.up != 0 && s.up != 1) ||
      (s.dx != 0 && s.dx != 1) || (s.edges != 0 && s.edges != 1) ||
      (s.up && s.dx) || (s.edges && !s.dx) || (s.dx && s.co != kDxCo) ||
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
  if (!f32conv::plan_is_whole(s) || s.dx ||
      (s.xvec && reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s.co == 4)
    return (int)f32conv::launch_t<4>(x, w, bias, out, s, has_act, slope, st);
  return (int)f32conv::launch_t<8>(x, w, bias, out, s, has_act, slope, st);
}

// fp32 K1-dx (shape->edges 0) or K2-dx (1) on the view the plan describes:
// the cotangent g (B, X, Y, Z, C) (K2-dx: K2's (B, X, Y, 2 Z, Cout) viewed
// so, C = 2 Cout), masked by the forward output mask (the same shape; null
// without activation) with slope; w (kx, ky, kz, C, Cout) the view's
// weights (K1's flipped, transposed kernel, or up_fold_weights' adjoint
// main), wedge (2, 3, 3, C, Cout) K2-dx's edge terms (null for K1-dx); dx
// (B, X, Y, Z, Cout).
extern "C" int muvo_zconv3d_dx_f32(const float* g, const float* mask,
                                   float slope, const float* w,
                                   const float* wedge, float* dx,
                                   const f32conv::F32Shape* shape,
                                   void* stream) {
  const f32conv::F32Shape s = *shape;
  const auto misaligned = [](const float* p) {
    return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (!f32conv::plan_is_whole(s) || !s.dx ||
      (s.edges != 0) != (wedge != nullptr) ||
      (s.xvec && (misaligned(g) || misaligned(mask))))
    return (int)cudaErrorInvalidValue;
  return (int)f32conv::launch_dx(g, mask, slope, w, wedge, dx, s,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" const char* muvo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
