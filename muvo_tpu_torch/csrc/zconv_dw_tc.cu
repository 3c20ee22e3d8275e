// bf16 K3 and K3-up on the tensor cores (sm_90a): the weight and bias
// gradients of the voxel decoder's 3x3x3 convs K1 and K2 as one split-K
// GEMM over the output positions, deterministic (no atomics).
//
//   dW[kx, ky, kz, c, co] = sum over b, x, y, z of
//                           u(x)[b, x+kx-1, y+ky-1, z+kz-1, c] * m(g)[b, x, y, z, co]
//   dbias[co]             = sum over b, x, y, z of m(g)[b, x, y, z, co]
//
// u is the identity for K3 and, for K3-up (UP), the 2x linear z-upsample
// (half-pixel, edges clamped), zero outside the volume (SAME padding).
// m(g) is the cotangent with the LeakyReLU derivative applied (g where the
// forward output is >= 0, slope * g elsewhere).
//
// Replaces muvo_tpu/ops/pallas_zconv.py::_dw_pallas (the dW of _vjp_bwd
// and, per z block, of _up_vjp_bwd) and the dbias sums beside it. The TPU
// kernel accumulates a banded dW in VMEM and pulls it back through the band
// builder; here the unbanded gradient is the GEMM
//   D[(t, c), co] += A[(t, c), p] * B[p, co]
// with M = 27 taps t x C (padded to 8) plus one row of ones (its D row is
// dbias), N = Cout (padded to 8, 16, 32 or 64), and K = p, the output
// positions: 7.08 M at conv2 and 56.6 M at conv3 at batch 24.
//
// Bound on the card: bytes. x, g and the forward output are read once each
// (0.68 GB at conv2, 2.72 GB at conv3 in bf16: 0.20 and 0.81 ms at 3.35
// TB/s), against 2 * M * N * K flops that take 0.1-0.4 ms at the bf16
// tensor-core rate. So the design reads each input once, in bf16, keeps the
// products on the tensor cores, and writes no intermediate tensor:
//
// - Persistent blocks each walk a contiguous run of tiles (b, y rows
//   y0 .. y0 + ty - 1, x row xi), x innermost, and keep their fp32
//   accumulators for the whole M x N in registers across all of them
//   (m64 tiles dealt round-robin to the block's 2-4 warpgroups).
// - A is x shifted by tap t: x is staged voxel-major, channels contiguous,
//   as bf16 planes (one x row each: ty + 2 y rows x Zp + 2 z slices, zero
//   outside the volume and past C), and wgmma's A fragments come from
//   registers by ldmatrix .trans, the tap shift in each lane's row address
//   (the im2col lives in the addresses). A ring of four planes holds the
//   three that tile xi reads and the one that tile xi + 1 adds, so each x
//   plane is staged once per run. K3 stages x by cp.async (16 bytes, zero
//   fill for the halo); K3-up reads the small-z rows and interpolates z in
//   fp32 in registers, rounding once to bf16, so the upsampled input never
//   exists in device memory.
// - B is m(g), masked in registers (g and the forward output read once) and
//   written by stmatrix .trans as wgmma's K-major no-swizzle core matrices
//   (8 co x 16 bytes of positions), two buffers: tile t + 1's g and x plane
//   are staged while tile t is multiplied. Positions past the volume (y past
//   Y, z past Z up to Zp = Z rounded up to 32) are zero in B, and their x
//   reads land on zeroed staging, never on stale shared memory.
// - The product is wgmma m64nNk16 with A from registers (wgmma.cuh, N = 16,
//   32, 64; N = 8 below); a 16-position k step stays within one (x, y) row's
//   z run, and z is padded to a multiple of 32 so that the k steps go in
//   pairs, one per fragment buffer. Every warpgroup issues the same MT
//   wgmmas a step with no branch around them (m tiles past the last read
//   the row of ones and are not written): a conditional wgmma makes ptxas
//   serialize them (C7520), which cost 1.3-1.5x here.
// - Each block writes its M x N partial to its own workspace row;
//   sum_rows_kernel adds the rows in a fixed order. A second launch gives
//   the same bits.
//
// Configuration by occupancy arithmetic, no sweep: a warpgroup holds MT m64
// tiles (at most 4 for N <= 16, 2 above): MT * N / 2 fp32 accumulators and
// 2 * MT * 4 fragment registers a thread, 64 at N = 16, MT = 4 (ptxas:
// 86-128 registers). A block has 2-4 warpgroups, the (warpgroups, MT) pair
// that covers the m tiles with the fewest spare ones, two warpgroups where
// that ties, so that two 256-thread blocks share an SM; 512 threads at 128
// registers take an SM alone. Shared memory: 4 planes of (ty + 2)(Zp + 2) Cs
// bf16 and 2 B buffers of ty Zp N bf16, with ty (y rows a tile, a power of
// two up to 16) cut until two blocks fit an SM or, for 3-4 warpgroups, one:
// at batch 24, conv2.conv1 (K3-up, 14 m tiles) 4 x 4, ty 16, 229 KB;
// conv2.conv2 (K3, 7) 2 x 4, ty 8, 82 KB; conv3.conv1 (K3-up, 7) 2 x 4,
// ty 4, 84 KB; conv3.conv2 (K3, 4) 2 x 2, ty 16, 109 KB. Cs, the staged
// voxel stride, is C rounded up to 8, plus 8 where that makes an even
// number of 16-byte chunks, so the 8 rows of an ldmatrix hit 8 distinct
// bank groups. The plan is made on the host (ops/zconv.py::dw_tc_plan) and
// passed in as DwTcShape; shapes wider than one pass (more m tiles than 4
// warpgroups hold, or Cout > 64) take several passes over the positions.
//
// The fp32 weight gradient stays on zconv_dw.cu's dw_kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace tc {

typedef __nv_bfloat16 bf16;

// The plan of one call, made by ops/zconv.py::dw_tc_plan; the fields and
// their order match its DW_TC_FIELDS.
struct DwTcShape {
  int B, X, Y, Zin, Z, C, Cout;
  int cp8;         // C rounded up to 8: A rows a tap
  int cs;          // staged voxel stride in bf16 (cp8, or cp8 + 8)
  int zp, zh;      // Z rounded up to 32; zp + 2 (the staged z halo)
  int ty, nyt;     // y rows a tile; y tiles a row
  int ntiles;      // B * nyt * X
  int np;          // N of the GEMM (8, 16, 32 or 64)
  int mt;          // m64 tiles a warpgroup (1-4 for N <= 16, else 1-2)
  int mtiles;      // m64 tiles: ceil((27 cp8 + 8) / 64)
  int mt0, n0;     // first m tile and first output channel of this pass
  int nwg;         // warpgroups a block
  int grid;        // blocks
  int m_passes, n_passes;
  int xvec;        // 16-byte x staging (C % 8 == 0, x 16-byte aligned)
  int gvec;        // 4-byte g and mask loads (Cout even, 4-byte aligned)
  int plane_bytes, gbuf_bytes, smem_bytes;
};

namespace {

constexpr int kMaxWarpgroups = 4;

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
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr,
                                                  const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
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

// wgmma m64n8k16, A from registers (wgmma.cuh starts at N = 16)
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
template <int NP>
__device__ __forceinline__ void mma(float (&d)[NP / 2],
                                    const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NP == 8)
    wgmma_rs_n8(d, a, db, 1);
  else
    wgmma::wgmma_rs<NP, 0>(d, a, db, 1);
}

struct Tile {
  int b, xi, y0;
  int yt;
};
__device__ __forceinline__ Tile decode(const DwTcShape& s, int t) {
  Tile r;
  r.xi = t % s.X;
  const int q = t / s.X;
  r.yt = q % s.nyt;
  r.b = q / s.nyt;
  r.y0 = r.yt * s.ty;
  return r;
}

// x plane xp (an x row of the input; K3-up: interpolated to big z) of the
// tile's ty + 2 y rows and zp + 2 z slices into dst, cp8 channels a voxel
// at stride cs, zero outside the volume and past C
template <bool UP>
__device__ __forceinline__ void stage_plane(bf16* dst,
                                            const bf16* __restrict__ x,
                                            const DwTcShape& s, int b, int xp,
                                            int y0) {
  const int nvox = (s.ty + 2) * s.zh;
  const bool xin = xp >= 0 && xp < s.X;
  const size_t col0 = ((size_t)b * s.X + (xin ? xp : 0)) * s.Y;
  if (s.xvec) {
    const int nch = s.cp8 / 8;
    for (int i = threadIdx.x; i < nvox * nch; i += blockDim.x) {
      const int ch = i % nch, v = i / nch, zz = v % s.zh, yy = v / s.zh;
      const int gy = y0 + yy - 1, gz = zz - 1;
      const bool in = xin && gy >= 0 && gy < s.Y && gz >= 0 && gz < s.Z;
      bf16* d = dst + v * s.cs + ch * 8;
      if (!UP) {
        const size_t off =
            in ? ((col0 + gy) * s.Zin + gz) * s.C + ch * 8 : 0;
        cp_async16(d, x + off, in ? 16 : 0);
      } else {
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (in) {
          const int k = gz >> 1;
          const int k2 = (gz & 1) ? min(k + 1, s.Zin - 1) : max(k - 1, 0);
          const size_t base = (col0 + gy) * s.Zin;
          const uint4 a = *reinterpret_cast<const uint4*>(
              x + (base + k) * s.C + ch * 8);
          const uint4 c = *reinterpret_cast<const uint4*>(
              x + (base + k2) * s.C + ch * 8);
          const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
          const uint32_t* pc = reinterpret_cast<const uint32_t*>(&c);
          uint32_t* pv = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 fa = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(pa + j));
            const float2 fc = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(pc + j));
            pv[j] = pack_bf16(0.75f * fa.x + 0.25f * fc.x,
                              0.75f * fa.y + 0.25f * fc.y);
          }
        }
        *reinterpret_cast<uint4*>(d) = val;
      }
    }
  } else {
    for (int i = threadIdx.x; i < nvox * s.cp8; i += blockDim.x) {
      const int c = i % s.cp8, v = i / s.cp8, zz = v % s.zh, yy = v / s.zh;
      const int gy = y0 + yy - 1, gz = zz - 1;
      float val = 0.f;
      if (xin && gy >= 0 && gy < s.Y && gz >= 0 && gz < s.Z && c < s.C) {
        const size_t base = (col0 + gy) * s.Zin;
        if (UP) {
          const int k = gz >> 1;
          const int k2 = (gz & 1) ? min(k + 1, s.Zin - 1) : max(k - 1, 0);
          val = 0.75f * __bfloat162float(x[(base + k) * s.C + c]) +
                0.25f * __bfloat162float(x[(base + k2) * s.C + c]);
        } else {
          val = __bfloat162float(x[(base + gz) * s.C + c]);
        }
      }
      dst[v * s.cs + c] = __float2bfloat16(val);
    }
  }
}

// m(g) of the tile's ty * zp positions (zero past Y and Z) and output
// channels n0 .. n0 + NP - 1 (zero past Cout) into dst as K-major core
// matrices. Core matrix m = pg * NP / 8 + ng holds positions 8 pg ..
// 8 pg + 7 and channels 8 ng .. 8 ng + 7; it lives at k16 step pg / 2, k
// half pg % 2. One stmatrix .x4 .trans writes four: lane l supplies the
// fragment (position l / 4, channel pair l % 4) of each, and the row
// address of row l % 8 of matrix l / 8.
template <int NP>
__device__ __forceinline__ void stage_g(uint32_t dst,
                                        const bf16* __restrict__ g,
                                        const bf16* __restrict__ mask,
                                        float slope, const DwTcShape& s,
                                        int b, int xi, int y0) {
  constexpr int G = NP / 8;
  const int nmat = s.ty * s.zp / 8 * G;
  const int lane = threadIdx.x & 31;
  const size_t col0 = ((size_t)b * s.X + xi) * s.Y;
  for (int j = threadIdx.x >> 5; j * 4 < nmat; j += blockDim.x >> 5) {
    uint32_t r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = 4 * j + q;
      const int pg = m / G, ng = m % G;
      const int p = pg * 8 + (lane >> 2);
      const int yl = p / s.zp, z = p - yl * s.zp;
      const int gy = y0 + yl;
      const int co = s.n0 + ng * 8 + 2 * (lane & 3);
      float v0 = 0.f, v1 = 0.f, m0 = 0.f, m1 = 0.f;
      if (m < nmat && gy < s.Y && z < s.Z && co < s.Cout) {
        const size_t off = ((col0 + gy) * s.Z + z) * s.Cout + co;
        if (s.gvec) {
          const float2 gv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(g + off));
          v0 = gv.x, v1 = gv.y;
          if (mask != nullptr) {
            const float2 mv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(mask + off));
            m0 = mv.x, m1 = mv.y;
          }
        } else {
          v0 = __bfloat162float(g[off]);
          if (mask != nullptr) m0 = __bfloat162float(mask[off]);
          if (co + 1 < s.Cout) {
            v1 = __bfloat162float(g[off + 1]);
            if (mask != nullptr) m1 = __bfloat162float(mask[off + 1]);
          }
        }
        if (m0 < 0.f) v0 *= slope;
        if (m1 < 0.f) v1 *= slope;
      }
      r[q] = pack_bf16(v0, v1);
    }
    const int m = 4 * j + (lane >> 3);
    const int pg = m / G, ng = m % G;
    stmatrix_x4_trans(dst + (pg >> 1) * NP * 32 +
                          (ng * 2 + (pg & 1)) * 128 + (lane & 7) * 16,
                      r);
  }
}

}  // namespace

// One block: tiles blockIdx.x * ntiles / grid .. (blockIdx.x + 1) * ntiles
// / grid - 1, m tiles mt0 + wg + nwg * i of this pass, output channels n0
// .. n0 + NP - 1; writes its partial D (mtiles * 64 rows x NP, fp32) to
// workspace row blockIdx.x.
template <int NP, int MT, bool UP>
__global__ void __launch_bounds__(128 * kMaxWarpgroups, 1)
    dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                 const bf16* __restrict__ mask, float slope,
                 float* __restrict__ part, DwTcShape s) {
  extern __shared__ __align__(128) unsigned char dw_smem[];
  bf16* ones = reinterpret_cast<bf16*>(dw_smem);
  unsigned char* gbuf = dw_smem + 128;
  bf16* planes = reinterpret_cast<bf16*>(gbuf + 2 * s.gbuf_bytes);
  const uint32_t ones_u32 = smem_u32(ones), gbuf_u32 = smem_u32(gbuf);
  const uint32_t planes_u32 = smem_u32(planes);
  const int plane_elems = s.plane_bytes / 2;
  if (threadIdx.x < 8) ones[threadIdx.x] = __float2bfloat16(1.f);

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  // this lane's ldmatrix row in each of the warpgroup's MT m tiles: 8-row
  // group (tap, channel chunk) of matrix lane / 8 (rows 0-7 | 8-15 of the
  // warp's 16); groups past the 27 taps read the row of ones (the first
  // of them is dbias; the rest, and whole m tiles past the last, are
  // computed and discarded: every warpgroup issues the same wgmmas, with
  // no branch around them, which would make the compiler serialize them)
  const int nch = s.cp8 / 8;
  uint32_t aoff[MT];
  int akx[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mt = s.mt0 + wg + s.nwg * i;
    const int g8 = mt * 8 + 2 * warp + ((lane >> 3) & 1);
    const int tap = g8 / nch, ch = g8 % nch;
    if (tap < 27) {
      const int ky = (tap / 3) % 3, kz = tap % 3;
      akx[i] = tap / 9;
      aoff[i] = (uint32_t)(((ky * s.zh + kz) * s.cs + ch * 8) * 2);
    } else {
      akx[i] = -1;
      aoff[i] = 0;
    }
  }
  float acc[MT][NP / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NP / 2; ++j) acc[i][j] = 0.f;
  uint32_t fa0[MT][4], fa1[MT][4];  // A fragments of even and odd k steps

  const int t0 = (int)((long long)blockIdx.x * s.ntiles / s.grid);
  const int t1 = (int)((long long)(blockIdx.x + 1) * s.ntiles / s.grid);
  // plane xp lives in slot (xp + 1) % 4
  auto slot = [&](int xp) { return planes + ((xp + 1) & 3) * plane_elems; };
  auto stage_start = [&](const Tile& tl, int buf) {
    for (int d = -1; d <= 1; ++d)
      stage_plane<UP>(slot(tl.xi + d), x, s, tl.b, tl.xi + d, tl.y0);
    stage_g<NP>(gbuf_u32 + buf * s.gbuf_bytes, g, mask, slope, s, tl.b,
                tl.xi, tl.y0);
    cp_commit();
    cp_wait_all();
    fence_proxy_async();
    __syncthreads();
  };
  if (t0 < t1) stage_start(decode(s, t0), 0);

  for (int t = t0; t < t1; ++t) {
    const int cur = (t - t0) & 1;
    const Tile tl = decode(s, t);
    const bool has_next = t + 1 < t1;
    const Tile nx = decode(s, has_next ? t + 1 : t);
    const bool cont = has_next && nx.b == tl.b && nx.yt == tl.yt &&
                      nx.xi == tl.xi + 1;
    if (cont) {  // the next tile's new x plane and its g
      stage_plane<UP>(slot(tl.xi + 2), x, s, tl.b, tl.xi + 2, tl.y0);
      cp_commit();
      stage_g<NP>(gbuf_u32 + (cur ^ 1) * s.gbuf_bytes, g, mask, slope, s,
                  nx.b, nx.xi, nx.y0);
    }

    // the product over this tile's positions
    uint32_t abase[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      abase[i] = akx[i] < 0 ? ones_u32
                            : smem_u32(slot(tl.xi - 1 + akx[i])) + aoff[i];
    const uint32_t bbase = gbuf_u32 + cur * s.gbuf_bytes;
    const int nsteps = min(s.ty, s.Y - tl.y0) * s.zp / 16;
    // lane's position in a k step: rows of matrix lane / 8, k half lane / 16
    const int pl = (lane & 7) + ((lane >> 4) << 3);
    // one k step into fragment buffer f (fa0 for even steps, fa1 for
    // odd: indexed at compile time, so the fragments stay in registers)
    auto kstep = [&](int st, uint32_t(&f)[MT][4]) {
      wgmma::wait<1>();  // the group that read this buffer is done
      wgmma::fence_operands(f);
      const int p = st * 16 + pl;
      const int yl = p / s.zp, z = p - yl * s.zp;
      const uint32_t poff = (uint32_t)((yl * s.zh + z) * s.cs * 2);
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4_trans(f[i], abase[i] + (akx[i] < 0 ? 0 : poff));
      wgmma::fence();
      const uint64_t db = kmajor_desc(bbase + st * NP * 32);
#pragma unroll
      for (int i = 0; i < MT; ++i) mma<NP>(acc[i], f[i], db);
      wgmma::commit();
    };
    // nsteps is even: zp is a multiple of 32
    for (int st = 0; st < nsteps; st += 2) {
      kstep(st, fa0);
      kstep(st + 1, fa1);
    }
    wgmma::wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i) wgmma::fence_operands(acc[i]);
    wgmma::fence_operands(fa0);
    wgmma::fence_operands(fa1);

    cp_wait_all();
    fence_proxy_async();
    __syncthreads();  // next tile's staging is in; this tile's reads done
    if (has_next && !cont) stage_start(nx, cur ^ 1);
  }

  // this block's partial D: d[4j + 2h], d[4j + 2h + 1] are row
  // 16 warp + lane / 4 + 8h of the m tile, columns 8j + 2 (lane % 4) + {0, 1}
  const size_t rows = (size_t)s.mtiles * 64;
  float* dst = part + (size_t)blockIdx.x * rows * NP;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mt = s.mt0 + wg + s.nwg * i;
    if (mt >= s.mtiles) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = (size_t)mt * 64 + warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
        *reinterpret_cast<float2*>(dst + row * NP + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
    }
  }
}

namespace {

// out[col] = sum over rows of in[row, col], rows in a fixed order: 32
// columns per block, 8 warps taking every 8th row, then the 8 warp sums
// (zconv_dw.cu's, for the fp32 path)
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

template <int NP, int MT, bool UP>
cudaError_t launch_t(const void* x, const void* g, const void* mask,
                     float slope, float* part, float* out, DwTcShape s,
                     cudaStream_t st) {
  auto kernel = dw_tc_kernel<NP, MT, UP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem_bytes);
  if (err != cudaSuccess) return err;
  const int cols = s.mtiles * 64 * NP;
  for (int np = 0; np < s.n_passes; ++np) {
    s.n0 = np * NP;
    for (int mp = 0; mp < s.m_passes; ++mp) {
      s.mt0 = mp * s.nwg * MT;
      kernel<<<s.grid, 128 * s.nwg, s.smem_bytes, st>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(g),
          static_cast<const bf16*>(mask), slope, part, s);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    sum_rows_kernel<<<(cols + 31) / 32, dim3(32, 8), 0, st>>>(
        part, s.grid, cols, out + (size_t)np * cols);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace tc

// Plain C interface, called through ctypes; each returns a cudaError_t.

// The current device's SM count and the shared memory a block may opt in
// to, for the host's plan.
extern "C" int muvo_dw_tc_limits(int* sms, int* smem_optin) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}

// bf16 K3 (up 0) / K3-up (up 1). x: (B, X, Y, Zin, C) (K3-up: already
// x/y-upsampled; the kernel interpolates z); g and mask (the forward
// output, null without activation): (B, X, Y, Z, Cout), all bf16. part:
// grid * mtiles * 64 * np floats of workspace; out: n_passes * mtiles * 64
// * np floats, D of each pass: row t * cp8 + c, column co - n0 is
// dW[tap t][c][co]; row 27 * cp8 is dbias.
extern "C" int muvo_zconv3d_dw_tc(const void* x, const void* g,
                                  const void* mask, float slope, float* part,
                                  float* out, const tc::DwTcShape* shape,
                                  int up, void* stream) {
  const tc::DwTcShape s = *shape;
  if (s.B <= 0 || s.X <= 0 || s.Y <= 0 || s.Zin <= 0 || s.C <= 0 ||
      s.Cout <= 0 || s.grid <= 0 || s.nwg <= 0 || s.nwg > tc::kMaxWarpgroups ||
      s.Z != (up ? 2 * s.Zin : s.Zin))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MUVO_DW_TC_CASE(NP_, MT_)                                         \
  if (s.np == NP_ && s.mt == MT_)                                         \
    return (int)(up ? tc::launch_t<NP_, MT_, true>(x, g, mask, slope,     \
                                                   part, out, s, st)      \
                    : tc::launch_t<NP_, MT_, false>(x, g, mask, slope,    \
                                                    part, out, s, st));
  MUVO_DW_TC_CASE(8, 1) MUVO_DW_TC_CASE(8, 2) MUVO_DW_TC_CASE(8, 3)
  MUVO_DW_TC_CASE(8, 4) MUVO_DW_TC_CASE(16, 1) MUVO_DW_TC_CASE(16, 2)
  MUVO_DW_TC_CASE(16, 3) MUVO_DW_TC_CASE(16, 4) MUVO_DW_TC_CASE(32, 1)
  MUVO_DW_TC_CASE(32, 2) MUVO_DW_TC_CASE(64, 1) MUVO_DW_TC_CASE(64, 2)
#undef MUVO_DW_TC_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* muvo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
