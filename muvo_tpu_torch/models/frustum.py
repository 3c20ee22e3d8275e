"""Lift-Splat-Shoot frustum pooling (counterpart of
muvo_tpu/models/frustum.py).

Each image-feature pixel is lifted along D depth bins into a frustum of
points, the points are moved into the ego frame by the camera's intrinsics
and pose, and every point inside the BEV grid adds its feature, weighted
by the pixel's depth probability, to its cell. muvo_tpu sums all the
points with ``segment_sum`` and sends the invalid ones to a spare slot;
here only the points that count are selected (inside the grid and, with
SPARSE, among the pixel's top-k depth bins: the sum is the same), and
``index_add_`` adds them into the grid in fp32. On the card the adds are
atomic, so the order of the sum, and nothing else, differs from run to
run.

The geometry and the cell indices are computed in float64 and rounded to
float32 exactly where muvo_tpu's compiled graph (XLA on the CPU) rounds:
its products of three terms are chains of fused multiply-adds, its
division of the BEV z by the cell height a multiply by the reciprocal, its
``linspace`` a multiply by the reciprocal of the step count. The integer
cell of every point is then the same on the host, on the card and in
muvo_tpu, also for points within a rounding error of a cell edge. The
cells truncate toward zero (upstream's ``.long()``), so points with a
coordinate in (-1, 0) land in cell 0. The geometry stays fp32 under bf16
autocast; the pooled features are returned in ``x``'s dtype.

The module holds no state: upstream's constants are not parameters, and
the state_dict carries none of them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from muvo_tpu_torch.geometry.camera import (bev_params_to_intrinsics,
                                            intrinsics_inverse)
from muvo_tpu_torch.models.layers import resize_bilinear


def gen_dx_bx(size, scale, offsetx):
    """Cell size, first cell centre and cell count along (x, y, z) of a
    BEV grid ``size`` = (width, height) px of ``scale`` m, its centre
    ``offsetx`` px behind the ego car; one 20 m cell in z."""
    xbound = [-size[0] * scale / 2 - offsetx * scale,
              size[0] * scale / 2 - offsetx * scale, scale]
    ybound = [-size[1] * scale / 2, size[1] * scale / 2, scale]
    zbound = [-10.0, 10.0, 20.0]
    rows = [xbound, ybound, zbound]
    dx = np.array([r[2] for r in rows], np.float32)
    bx = np.array([r[0] + r[2] / 2.0 for r in rows], np.float32)
    nx = np.array([round((r[1] - r[0]) / r[2]) for r in rows], np.int64)
    return dx, bx, nx


def linspace_f32(stop: float, n: int) -> np.ndarray:
    """``jnp.linspace(0, stop, n)`` bit for bit: XLA folds ``i / (n - 1)
    * stop`` into ``(stop * (1 / (n - 1))) * i`` in float32, and the last
    point is ``stop`` itself."""
    if n == 1:
        return np.zeros(1, np.float32)
    div = np.float32(n - 1)
    step = np.float32(stop) * (np.float32(1) / div)
    out = step * np.arange(n - 1, dtype=np.float32)
    return np.append(out, np.float32(stop)).astype(np.float32)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A float64 tensor rounded to float32, kept in float64."""
    return t.float().double()


def _fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add on float64 tensors holding float32
    values: the product is exact in float64, the sum rounds once (to
    float64, then to float32: the same result except in halfway cases
    that float32 inputs of these sizes do not reach)."""
    return _f32(a * b + c)


class FrustumPooling(nn.Module):
    """Pools camera frustum features into a BEV grid.

    Args:
        size: (width, height) of the BEV grid in px
        scale: size of a BEV pixel in metres
        offsetx: ego-car forward offset from the BEV centre, px
        dbound: (min, max, step) of the depth bins
        downsample: stride of the image feature map against the image
        sparse, sparse_count: keep each pixel's top-k depth bins only
    """

    def __init__(self, size, scale, offsetx, dbound, downsample: int,
                 sparse: bool = True, sparse_count: int = 10):
        super().__init__()
        _, bx, nx = gen_dx_bx(size, scale, offsetx)
        self.nx = tuple(int(n) for n in nx)
        self._grid = (size, scale, offsetx, dbound)
        for name, value in self._constants().items():
            self.register_buffer(name, value, persistent=False)
        self._bx_z = float(bx[2])
        self.D = int(self.ds.shape[0])
        self.downsample = int(downsample)
        self.sparse = bool(sparse)
        self.sparse_count = int(sparse_count)
        self._frustums: Dict[Tuple, torch.Tensor] = {}

    def _constants(self) -> Dict[str, torch.Tensor]:
        """``bev_affine``: (scale x, offset x, scale y, offset y, z shift,
        1 / cell height) in float32 as muvo_tpu's graph holds them, stored
        in float64; ``ds``: the depth bins."""
        size, scale, offsetx, dbound = self._grid
        dx, _, _ = gen_dx_bx(size, scale, offsetx)
        bev = bev_params_to_intrinsics(size, scale, offsetx)
        affine = torch.tensor(
            [bev[0, 0], bev[0, 2], bev[1, 1], bev[1, 2],
             dx[2] / np.float32(2.0), np.float32(1) / dx[2]],
            dtype=torch.float32).double()
        ds = np.arange(dbound[0], dbound[1], dbound[2], dtype=np.float32)
        return {"bev_affine": affine, "ds": torch.from_numpy(ds)}

    def reference_init(self, generator):
        # no draws: the buffers are the grid's constants, computed again
        # (a model built on the meta device holds none yet)
        return self._constants()

    def frustum(self, fh: int, fw: int, device=None) -> torch.Tensor:
        """(D, fH, fW, 3) grid of (u, v, depth) image-plane points,
        float32."""
        key = (fh, fw, str(device))
        grid = self._frustums.get(key)
        if grid is None:
            ds = self.ds.cpu().numpy()
            xs = linspace_f32(fw * self.downsample - 1, fw)
            ys = linspace_f32(fh * self.downsample - 1, fh)
            d, v, u = np.meshgrid(ds, ys, xs, indexing="ij")
            grid = torch.from_numpy(np.stack([u, v, d], -1)).to(device)
            self._frustums[key] = grid
        return grid

    def get_geometry(self, frustum, rots, trans, intrins) -> torch.Tensor:
        """Frustum image points -> ego-frame xyz, (B, D, fH, fW, 3), as
        float32 values in a float64 tensor."""
        f = frustum.double()
        depth = f[..., 2]
        pts = (_f32(f[..., 0] * depth), _f32(f[..., 1] * depth), depth)
        r = rots.float().double()
        inv = intrinsics_inverse(intrins.float()).double()
        # combine = rots @ inv, (B, 3, 3)
        combine = _fma(r[:, :, 2, None], inv[:, None, 2, :],
                       _fma(r[:, :, 1, None], inv[:, None, 1, :],
                            _f32(r[:, :, 0, None] * inv[:, None, 0, :])))
        c = combine[:, None, None, None]  # (B, 1, 1, 1, 3, 3)
        t = trans.float().double()
        out = []
        for i in range(3):
            g = _fma(c[..., i, 2], pts[2], _fma(c[..., i, 1], pts[1],
                                               _f32(c[..., i, 0] * pts[0])))
            out.append(_f32(g + t[:, i, None, None, None]))
        return torch.stack(out, -1)

    def cells(self, fh: int, fw: int, intrinsics, pose):
        """The BEV cell of every frustum point: (flat index (z * ny + y) *
        nx + x, inside the grid), both (B, D * fH * fW), points in (D, fH,
        fW) order."""
        geom = self.get_geometry(self.frustum(fh, fw, pose.device),
                                 pose[:, :3, :3], pose[:, :3, 3], intrinsics)
        a = self.bev_affine
        gx = _fma(geom[..., 0], a[0], a[1])
        gy = _fma(geom[..., 1], a[2], a[3])
        gz = _f32(_f32(_f32(geom[..., 2] - self._bx_z) + a[4]) * a[5])
        n0, n1, n2 = self.nx
        ix, iy, iz = (g.trunc().long() for g in (gx, gy, gz))
        valid = ((ix >= 0) & (ix < n0) & (iy >= 0) & (iy < n1)
                 & (iz >= 0) & (iz < n2))
        flat = (iz * n1 + iy) * n0 + ix
        b = pose.shape[0]
        return flat.reshape(b, -1), valid.reshape(b, -1)

    def depth_mask(self, depth):
        """Top-k depth-bin mask of a (B, fH, fW, D) distribution: every bin
        at least the k-th largest, ties included."""
        if not self.sparse:
            return torch.ones_like(depth, dtype=torch.bool)
        kth = torch.topk(depth, self.sparse_count, dim=-1).values[..., -1:]
        return depth >= kth

    def forward(self, x, depth, intrinsics, pose):
        """x (B, fH, fW, C) image features, depth (B, fH, fW, D) their
        depth distribution, intrinsics (B, 3, 3), pose (B, 4, 4)
        camera -> ego. Returns (B, ny, nx, C * nz) in x's dtype."""
        b, fh, fw, c = x.shape
        n0, n1, n2 = self.nx
        n_vox = n0 * n1 * n2
        flat, valid = self.cells(fh, fw, intrinsics, pose)
        keep = valid.reshape(b, self.D, fh, fw)
        if self.sparse:
            keep = keep & self.depth_mask(depth).permute(0, 3, 1, 2)
        bi, pi = keep.reshape(b, -1).nonzero(as_tuple=True)
        d, pix = pi // (fh * fw), pi % (fh * fw)
        weight = depth.reshape(b, fh * fw, self.D)[bi, pix, d].float()
        feat = weight[:, None] * x.reshape(b, fh * fw, c)[bi, pix].float()
        pooled = torch.zeros(b * n_vox, c, dtype=torch.float32,
                             device=x.device)
        pooled = pooled.index_add(0, bi * n_vox + flat[bi, pi], feat)
        bev = pooled.reshape(b, n2, n1, n0, c).permute(0, 2, 3, 1, 4)
        return bev.reshape(b, n1, n0, n2 * c).to(x.dtype)

    def get_depth_map(self, depth):
        """Depth distribution (B, fH, fW, D) -> expected depth at the
        image's resolution, (B, fH * downsample, fW * downsample, 1)."""
        d = (self.ds.to(depth.dtype) * depth).sum(-1, keepdim=True)
        _, fh, fw, _ = d.shape
        return resize_bilinear(d, (fh * self.downsample,
                                   fw * self.downsample))
