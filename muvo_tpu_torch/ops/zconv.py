"""The voxel decoder's 3x3x3 convolutions: K1 and K2, with their plain
versions (the port of muvo_tpu/ops/pallas_zconv.py's forward).

K1 ``zconv3d_leaky``: LeakyReLU(conv3d 3x3x3 SAME stride 1 + bias).
    Replaces pallas_zconv.py::_zconv_pallas_raw via zconv3d_leaky_folded.
K2 ``upzconv3d_leaky``: LeakyReLU(conv3d(2x linear z-upsample of x) + bias),
    x already upsampled in X and Y. Replaces the same Pallas kernel via
    upzconv3d_leaky_folded; like it, the upsampled tensor never exists in
    device memory (the CUDA kernel interpolates z while staging its tile).

Tensors are channels-last NDHWC; weights are upstream's Conv3d layout
(Cout, C, 3, 3, 3). On a CPU tensor each wrapper runs its plain PyTorch
version; on a CUDA tensor it launches the hand-written kernel in
csrc/zconv.cu (route: CUDA C++ for sm_90a, plain C interface, ctypes) or
raises. What bounds the kernels and how they are built is noted in the
source. They have no backward yet: on CUDA a call that autograd would
record raises (the dx and dW kernels come with the training slice).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from muvo_tpu_torch.models.layers import to_nchw, to_nhwc

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        from muvo_tpu_torch.ops._build import load

        lib = load("zconv")
        lib.muvo_zconv3d_leaky.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.muvo_zconv3d_leaky.restype = ctypes.c_int
        lib.muvo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.muvo_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def zconv3d_leaky_plain(x, weight, bias=None, slope: Optional[float] = 0.2):
    """F.conv3d + bias + LeakyReLU on NDHWC."""
    y = F.conv3d(to_nchw(x), weight, bias, padding=1)
    if slope is not None:
        y = F.leaky_relu(y, slope)
    return to_nhwc(y).contiguous()


def upsample2x_z(x):
    """2x linear upsample of NDHWC over z only (half-pixel, edges clamped)."""
    b, X, Y, Z, C = x.shape
    return to_nhwc(F.interpolate(to_nchw(x), size=(X, Y, 2 * Z),
                                 mode="trilinear", align_corners=False))


def upzconv3d_leaky_plain(x, weight, bias=None,
                          slope: Optional[float] = 0.2):
    """F.interpolate over z, then K1's plain version."""
    return zconv3d_leaky_plain(upsample2x_z(x), weight, bias, slope)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _check(x, weight, bias):
    if x.ndim != 5:
        raise ValueError(f"x must be NDHWC (5-D), got shape {tuple(x.shape)}")
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, x.shape[-1], 3, 3, 3):
        raise ValueError(f"weight shape {tuple(weight.shape)} does not fit "
                         f"x with {x.shape[-1]} channels")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({cout},)")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise ValueError(f"{name} is {t.dtype} on {t.device}, x is "
                             f"{x.dtype} on {x.device}")


def _launch(x, weight, bias, slope, up: bool):
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NDHWC tensor")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError("the CUDA zconv kernels have no backward yet; "
                           "call them under torch.no_grad()")
    b, X, Y, zin, c = x.shape
    cout = weight.shape[0]
    z = 2 * zin if up else zin
    out = torch.empty((b, X, Y, z, cout), dtype=x.dtype, device=x.device)
    # (Cout, C, kx, ky, kz) -> (kx, ky, kz, C, Cout), fp32 for the kernel
    w = weight.detach().float().permute(2, 3, 4, 1, 0).contiguous()
    bias32 = None if bias is None else bias.detach().float().contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _library().muvo_zconv3d_leaky(
            x.data_ptr(), w.data_ptr(),
            None if bias32 is None else bias32.data_ptr(), out.data_ptr(),
            b, X, Y, zin, c, cout, int(up), int(slope is not None),
            float(slope or 0.0), _DTYPES[x.dtype], stream)
    if rc != 0:
        msg = _library().muvo_cuda_error_string(rc).decode()
        raise RuntimeError(f"zconv kernel launch failed: {msg} (error {rc})")
    return out


def zconv3d_leaky(x, weight, bias=None, slope: Optional[float] = 0.2):
    """K1: LeakyReLU_slope(conv3d_same(x) + bias); x (B, X, Y, Z, C) ->
    (B, X, Y, Z, Cout). ``slope=None`` skips the activation."""
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return zconv3d_leaky_plain(x, weight, bias, slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = _launch(x, weight, bias, slope, up=False)
    zconv3d_leaky.launches += 1
    return out


def upzconv3d_leaky(x, weight, bias=None, slope: Optional[float] = 0.2):
    """K2: LeakyReLU_slope(conv3d_same(up2_z(x)) + bias); x (B, X, Y, Zs, C)
    -> (B, X, Y, 2*Zs, Cout). x must already be upsampled in X and Y."""
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return upzconv3d_leaky_plain(x, weight, bias, slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = _launch(x, weight, bias, slope, up=True)
    upzconv3d_leaky.launches += 1
    return out


# launch counts: each wrapper adds one per kernel launch, nowhere else
zconv3d_leaky.launches = 0
upzconv3d_leaky.launches = 0
