"""The voxel decoder's 3x3x3 convolutions and their gradients, with their
plain versions (the port of muvo_tpu/ops/pallas_zconv.py).

K1 ``zconv3d_leaky``: LeakyReLU(conv3d 3x3x3 SAME stride 1 + bias).
    Replaces pallas_zconv.py::_zconv_pallas_raw via zconv3d_leaky_folded.
    In bf16 a tensor-core kernel computes it on the view ``k1_route``
    picks: the volume as it is, or with z pairs folded into channels
    (``pair_fold_weights``) where 8 channels would leave its products
    mostly empty; in fp32 a register-tiled CUDA-core kernel
    (csrc/zconv_f32.cu, planned by ``f32_plan``) walking a ring of staged
    x planes.
K2 ``upzconv3d_leaky``: LeakyReLU(conv3d(2x linear z-upsample of x) + bias),
    x already upsampled in X and Y. Replaces the same Pallas kernel via
    upzconv3d_leaky_folded; like it, the upsampled tensor never exists in
    device memory: in fp32 K1's kernel interpolates z while it stages the
    planes (``f32_plan`` with ``up``); in bf16 a tensor-core kernel
    computes on the small-z grid with the upsample folded into the weights
    (``up_fold_weights``).
K1-dx ``zconv3d_dx``: K1's input gradient, the conv of the leaky-masked
    cotangent with the flipped, transposed kernel (_vjp_bwd's dx); in bf16
    routed as K1, in fp32 K1's register-tiled walk on the masked cotangent
    (csrc/zconv_f32.cu, planned by ``f32_dx_plan``).
K2-dx ``upzconv3d_dx``: K2's input gradient, that adjoint conv over big z
    followed by the z-upsample's transpose, back to small z, in one kernel
    (_up_vjp_bwd's dx): the adjoint fold on the small-z grid
    (``up_fold_weights(adjoint=True)``), in bf16 on the tensor cores, in
    fp32 on fp32 K1-dx's walk with the fold's edge terms; the big-z
    gradient never exists.
Where the block of one of these kernels cannot hold the weights of all its
    output channels (fp32 K1, K2, K1-dx and K2-dx, bf16 K2 and K2-dx), it
    launches once for each slice of them that ``channel_slices`` gives (as
    at the default config's 256-channel voxel decoder).
K3 ``zconv3d_dw`` / ``upzconv3d_dw`` (K3-up): the weight and bias
    gradients of K1 / K2 in one pass (_dw_pallas and the dbias sums beside
    it), fp32 out: in bf16 a split-K GEMM on the tensor cores over the
    big-z positions (csrc/zconv_dw_tc.cu, planned by ``dw_tc_plan``), in
    fp32 a register-tiled CUDA-core kernel sliding a z window over a ring
    of staged x planes (csrc/zconv_dw.cu, planned by ``dw_f32_plan``).

Tensors are channels-last NDHWC; weights are upstream's Conv3d layout
(Cout, C, 3, 3, 3). On a CPU tensor each wrapper runs its plain PyTorch
version; on a CUDA tensor it launches the hand-written kernel in
csrc/zconv.cu, csrc/zconv_f32.cu, csrc/zconv_dw.cu or csrc/zconv_dw_tc.cu
(route: CUDA C++ for sm_90a, plain C interface, ctypes) or raises, and
names the kernel (and the view) it ran in its ``last_impl``. What bounds the kernels and how
they are built is noted in the sources.

Under autograd, K1 and K2 run inside ``torch.autograd.Function``s whose
backward calls the dx and dW wrappers (kernels on the card, plain versions
on the host); under bf16 autocast they take bf16 tensors. With grad off
they launch the forward kernel alone and save nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from muvo_tpu_torch.models.layers import to_nchw, to_nhwc

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_libs = {}


def _library(name: str):
    lib = _libs.get(name)
    if lib is None:
        from muvo_tpu_torch.ops._build import load

        lib = load(name)
        lib.muvo_cuda_error_string.argtypes = [_I]
        lib.muvo_cuda_error_string.restype = ctypes.c_char_p
        if name == "zconv":
            lib.muvo_zconv3d_leaky.argtypes = [
                _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                ctypes.c_float, _I, _P]
            lib.muvo_zconv3d_dx.argtypes = [
                _P, _P, ctypes.c_float, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                _I, _P]
            lib.muvo_zconv3d_tc.argtypes = [
                _P, _P, ctypes.c_float, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                _I, _I, _I, _I, ctypes.c_float, _P]
            lib.muvo_zconv3d_leaky.restype = _I
            lib.muvo_zconv3d_dx.restype = _I
            lib.muvo_zconv3d_tc.restype = _I
        elif name == "zconv_f32":
            lib.muvo_zconv_f32_limits.argtypes = [ctypes.POINTER(_I)] * 2
            lib.muvo_zconv3d_f32.argtypes = [
                _P, _P, _P, _P, ctypes.POINTER(_F32Shape), _I,
                ctypes.c_float, _P]
            lib.muvo_zconv3d_dx_f32.argtypes = [
                _P, _P, ctypes.c_float, _P, _P, _P,
                ctypes.POINTER(_F32Shape), _P]
            lib.muvo_zconv_f32_limits.restype = _I
            lib.muvo_zconv3d_f32.restype = _I
            lib.muvo_zconv3d_dx_f32.restype = _I
        elif name == "zconv_dw_tc":
            lib.muvo_dw_tc_limits.argtypes = [ctypes.POINTER(_I)] * 2
            lib.muvo_zconv3d_dw_tc.argtypes = [
                _P, _P, _P, ctypes.c_float, _P, _P,
                ctypes.POINTER(_DwTcShape), _I, _P]
            lib.muvo_dw_tc_limits.restype = _I
            lib.muvo_zconv3d_dw_tc.restype = _I
        else:
            lib.muvo_zconv3d_dw_workspace.argtypes = [
                ctypes.POINTER(_DwF32Shape), ctypes.POINTER(ctypes.c_size_t)]
            lib.muvo_zconv3d_dw.argtypes = [
                _P, _P, _P, ctypes.c_float, _P, _P, _P,
                ctypes.POINTER(_DwF32Shape), _P]
            lib.muvo_zconv3d_dw_workspace.restype = _I
            lib.muvo_zconv3d_dw.restype = _I
        _libs[name] = lib
    return lib


def _raise_if(rc: int, name: str, what: str):
    if rc != 0:
        msg = _library(name).muvo_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (error {rc})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


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


def leaky_mask(g, out, slope: Optional[float]):
    """The LeakyReLU derivative applied to the cotangent g: g where the
    forward output is >= 0, slope * g elsewhere (muvo_tpu's
    ``where(out >= 0, dout, slope * dout)``)."""
    if slope is None:
        return g
    return torch.where(out >= 0, g, g * slope)


def _conv_input_grad(gm, weight, z_in: int):
    b, X, Y, Z, _ = gm.shape
    size = (b, weight.shape[1], X, Y, z_in)
    return to_nhwc(torch.nn.grad.conv3d_input(size, weight, to_nchw(gm),
                                              padding=1))


def zconv3d_dx_plain(g, out, weight, slope: Optional[float] = 0.2):
    """K1's dx: conv3d_input on the masked cotangent."""
    gm = leaky_mask(g, out, slope)
    return _conv_input_grad(gm, weight, gm.shape[3]).contiguous()


def upzconv3d_dx_plain(g, out, weight, slope: Optional[float] = 0.2):
    """K2's dx: conv3d_input over big z, then the transpose of
    upsample2x_z, taken by autograd."""
    gm = leaky_mask(g, out, slope)
    dbig = _conv_input_grad(gm, weight, gm.shape[3])
    b, X, Y, Z, C = dbig.shape
    with torch.enable_grad():
        small = torch.zeros((b, X, Y, Z // 2, C), dtype=dbig.dtype,
                            device=dbig.device, requires_grad=True)
        (dx,) = torch.autograd.grad(upsample2x_z(small), small, dbig)
    return dx.contiguous()


# K2 on the small-z grid. Output z = 2k + p (phase p) of the conv of the
# z-upsampled input is a 3x3x3 SAME conv of the small-z input whose z tap t
# reads slice k - 1 + t, with folded weights
#   W'[kx, ky, t][c, p Cout + co] = sum_dz E[p, t, dz] w[co, c, kx, ky, dz]
# (zero padding outside the volume), plus two centre-tap (t = 1) terms that
# the clamped upsample adds at the first and last small slice (both when
# Zs = 1), applied to x[0] and x[Zs - 1]:
#   EDGE[0][p, dz] at k = 0, EDGE[1][p, dz] at k = Zs - 1.
# The same numbers as muvo_tpu/ops/pallas_zconv.py::_z_coeff_np, which
# builds them per z block for the TPU's banded weights.
UP_FOLD_E = (((0.75, 0.25, 0.0), (0.25, 0.75, 0.75), (0.0, 0.0, 0.25)),
             ((0.25, 0.0, 0.0), (0.75, 0.75, 0.25), (0.0, 0.25, 0.75)))
UP_FOLD_EDGE = (((-0.25, 0.25, 0.0), (0.25, 0.0, 0.0)),
                ((0.0, 0.0, 0.25), (0.0, 0.25, -0.25)))


@functools.lru_cache(maxsize=None)
def _fold_tables(device):
    """E and EDGE as fp32 tensors on ``device``, made once (a copy to the
    card per call would wait for the stream)."""
    return (torch.tensor(UP_FOLD_E, dtype=torch.float32, device=device),
            torch.tensor(UP_FOLD_EDGE, dtype=torch.float32, device=device))


def up_fold_weights(weight, adjoint: bool = False):
    """K2's weights folded onto the small-z grid, fp32.

    Forward: (main (3, 3, 3, C, 2 Cout), edges (2, 3, 3, C, 2 Cout)) in
    (kx, ky, t, input channel, output channel) order, output channel
    p Cout + co; the conv of x (B, X, Y, Zs, C) with ``main`` plus
    ``edges[0]`` applied (as a 3x3 conv) to slice 0 and ``edges[1]`` to
    slice Zs - 1 is K2's output viewed as (B, X, Y, Zs, 2 Cout) before bias
    and activation.

    ``adjoint``: the flipped, transposed fold, (3, 3, 3, 2 Cout, C) and
    (2, 3, 3, 2 Cout, C): the same conv structure on the masked cotangent
    viewed as (B, X, Y, Zs, 2 Cout) gives K2's input gradient."""
    w = weight.detach().float().permute(2, 3, 4, 1, 0)  # kx ky dz C Cout
    e, d = _fold_tables(w.device)
    c, cout = w.shape[3], w.shape[4]
    # fp32 under autocast too: einsum's products would come out bf16 there,
    # and the kernels read the fold as fp32
    with torch.autocast(w.device.type, enabled=False):
        main = torch.einsum("ptd,xydce->xytcpe", e, w).reshape(3, 3, 3, c,
                                                               2 * cout)
        edges = torch.einsum("qpd,xydce->qxycpe", d, w).reshape(2, 3, 3, c,
                                                                2 * cout)
    if adjoint:
        main = main.flip(0, 1, 2).transpose(-1, -2)
        edges = edges.flip(1, 2).transpose(-1, -2)
    return main.contiguous(), edges.contiguous()


# K1 on the pair grid: (B, X, Y, Z, C) viewed as (B, X, Y, Z / 2, 2 C),
# channel q C + c holding big z = 2k + q of slice k, and the output as
# (B, X, Y, Z / 2, 2 Cout), channel p Cout + co. Output z 2k + p reads input
# z 2k + p + dz - 1, which is slice k - 1 + t at q for dz = 2t + q - p - 1,
# so the pair grid's 3x3x3 SAME conv has the weights
#   W'[kx, ky, t][(q, c), (p, co)] = w[kx, ky, 2t + q - p - 1, c, co],
# zero where that dz is outside 0..2; SAME zero padding is exact for even Z
# (a pair is in or out of the volume whole). PAIR_FOLD_DZ[t][q][p] is that
# dz, 3 where there is none. The nonzero blocks are muvo_tpu's
# banded_weight(kernel, f=2) (pallas_zconv.py), the TPU kernel's z block.
PAIR_FOLD_DZ = (((3, 3), (0, 3)), ((1, 0), (2, 1)), ((3, 2), (3, 3)))


@functools.lru_cache(maxsize=None)
def _pair_index(device):
    """PAIR_FOLD_DZ flattened, on ``device``, made once."""
    return torch.tensor(PAIR_FOLD_DZ, dtype=torch.long,
                        device=device).reshape(-1)


def pair_fold_weights(w):
    """(3, 3, 3, C, Cout) weights in (kx, ky, kz, input, output channel)
    order -> the pair grid's (3, 3, 3, 2 C, 2 Cout), fp32 (see above).

    K1's weights give K1 on the pair grid; K1-dx's flipped, transposed
    weights give K1-dx there (it is a SAME conv of the masked cotangent)."""
    w = w.detach().float()
    c, cout = w.shape[3], w.shape[4]
    wz = torch.cat([w, w.new_zeros((3, 3, 1, c, cout))], 2)  # dz 3: zero
    f = wz.index_select(2, _pair_index(w.device))  # (3, 3, (t, q, p), ...)
    f = f.reshape(3, 3, 3, 2, 2, c, cout).permute(0, 1, 2, 3, 5, 4, 6)
    return f.reshape(3, 3, 3, 2 * c, 2 * cout)


class TcView(NamedTuple):
    """The volume as the bf16 tensor-core kernel computes on it: input
    (B, X, Y, zs, kc), output (B, X, Y, zs, n), the same bytes as the
    channels-last tensors."""
    name: str  # "plain", "pair" (K1, K1-dx) or "small-z" (K2, K2-dx)
    zs: int
    kc: int
    n: int


TC_MAX_CHANNELS = 64  # the kernel's Kc and N (four k16 steps, m64n64)


def k1_route(z: int, c: int, cout: int) -> Optional[TcView]:
    """The view bf16 K1 (and K1-dx, as c -> cout) runs on: the pair view
    where z is even and 8 channels would leave a k16 x n16 product mostly
    empty (c or cout below 16), the plain view otherwise; None (the
    CUDA-core zconv_kernel<bf16>) past TC_MAX_CHANNELS."""
    if z % 2 == 0 and min(c, cout) < 16 and (
            2 * max(c, cout) <= TC_MAX_CHANNELS):
        return TcView("pair", z // 2, 2 * c, 2 * cout)
    if max(c, cout) <= TC_MAX_CHANNELS:
        return TcView("plain", z, c, cout)
    return None


TC_PLANES = 4  # the kernel's ring of staged x planes (kPlanes)


def tc_smem_bytes(zs: int, kc: int, n: int, edges: bool,
                  ty: int = 1) -> int:
    """Shared memory of a zconv_tc_kernel block of ``ty`` y rows on the
    view (Zs, Kc) -> N (csrc/zconv.cu's tc_smem_bytes): the bf16 weights of
    27 taps, 45 with the small-z view's edge terms, and the plane ring."""
    ks = -(-kc // 16)
    return ((45 if edges else 27) * ks * _round_up(n, 16) * 32
            + TC_PLANES * (ty + 2) * (zs + 2) * (ks * 16 + 8) * 2)


def _smem_optin(t) -> int:
    """The shared memory a block may opt in to on t's card."""
    return _f32_limits(t.device.index or 0)[1]


K1_F32_IMPL = "f32conv::zconv_f32_kernel (csrc/zconv_f32.cu)"
K2_F32_IMPL = "f32conv::zconv_up_f32_kernel (csrc/zconv_f32.cu)"
K1_DX_F32_IMPL = "f32conv::zconv_dx_f32_kernel (csrc/zconv_f32.cu)"
K2_DX_F32_IMPL = "f32conv::zconv_dxup_f32_kernel (csrc/zconv_f32.cu)"
_F32_IMPL = {(False, False): K1_F32_IMPL, (True, False): K2_F32_IMPL,
             (False, True): K1_DX_F32_IMPL, (True, True): K2_DX_F32_IMPL}


def _impl(view: Optional[TcView], dtype, up: bool, dx: bool) -> str:
    """The name ``last_impl`` gives the kernel that ran."""
    if view is not None:
        return (f"tc::zconv_tc_kernel, {view.name} view (Zs {view.zs}, "
                f"Kc {view.kc}, N {view.n})")
    if dtype == torch.float32:
        return _F32_IMPL[(up, dx)]
    return "zconv_kernel<bf16>"


# fp32 K1, K2, K1-dx and K2-dx: f32conv::zconv_f32_kernel<CO>,
# zconv_up_f32_kernel<CO>, zconv_dx_f32_kernel and zconv_dxup_f32_kernel in
# csrc/zconv_f32.cu, register tiles of F32_RZ output z x CO output channels
# a thread over a ring of F32_PLANES x planes (K2's z-upsampled, the dx
# kernels' the masked cotangent). Their plan is made here and passed in as
# the kernels' F32Shape, whose fields are these, in this order; the
# constants are the kernels' (kRZ, kRun, kQuad, kPlanes, kMaxThreads,
# kDxCo).
F32_FIELDS = (
    "B", "X", "Y", "Zin", "Z", "C", "Cout", "up", "dx", "edges", "xvec",
    "rz", "co", "coutp", "nchunks", "ngz", "ty", "nyt", "zs", "ys", "plane",
    "wfloats", "threads", "runs", "items", "rows", "grid", "xs",
    "smem_bytes")
F32_RZ = 4
F32_RUN = 4            # K2: small z a staging item
F32_QUAD = 4           # K1: floats of a y row a staging item
F32_PLANES = 3
F32_MAX_THREADS = 512
F32_DX_CO = 4          # K1-dx's and K2-dx's only channel tile
F32_MIN_ROWS = 4       # rows a block walks at least, where there are enough
SMEM_PER_SM = 233472   # H100: 228 KB of shared memory an SM


class _F32Shape(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in F32_FIELDS]


def f32_plan(B: int, X: int, Y: int, Zin: int, C: int, Cout: int, up: bool,
             sms: int, smem_optin: int, xvec: bool = True) -> dict:
    """The split of an fp32 K1 (``up`` False) or K2 call over the card, as
    the kernel reads it (see the source note of csrc/zconv_f32.cu).

    Output z is Z = Zin (K1) or 2 Zin (K2). A thread owns F32_RZ output z x
    ``co`` output channels of one (x, y): ``ngz`` z groups, then ``ty`` y
    rows, then ``nchunks`` channel chunks make the block's ``threads``. Its
    shared memory holds the weights (``wfloats``, channels padded to
    ``coutp``) and F32_PLANES planes of (ty + 2) y rows x C channels x
    ``zs`` padded z. ``ty`` is the most y rows the threads (at most
    F32_MAX_THREADS) and ``smem_optin`` allow, or a little fewer where that
    divides Y; ``co`` 4 where a y row fits, else 8 (per launch on an H100,
    tools/torch_zconv_probe.py: 4 is 12-28% faster at K2's muvo.yml stages
    and at K1's conv2.conv2 at batch 1, within 3% of 8 at the others).
    ``rows`` = B x ``nyt`` y tiles x X are dealt to ``grid`` blocks, block i
    taking rows i * rows // grid .. (i + 1) * rows // grid - 1 (x innermost,
    at most ``xs``), as many blocks as fit the card at once but at least
    F32_MIN_ROWS rows a block. A plane's staging ``items`` are K2's runs of
    F32_RUN small z of one (y, c), K1's runs of F32_QUAD floats of one y
    row, loaded as one float4 where ``xvec`` (x 16-byte aligned) and Z x C
    allow. Raises ValueError for a shape whose block does not fit: at z 64
    and Cout 8, past C 70 (C 44 at Cout 44 and z 4)."""
    return _f32_plan(B, X, Y, Zin, C, Cout, up, sms, smem_optin, xvec=xvec)


def f32_dx_view(z: int, cg: int, c: int, up: bool):
    """(Zs, Kc, N) of the view fp32 K1-dx (``up`` False) or K2-dx computes
    on, given the cotangent's z and channels ``cg`` and dx's channels ``c``:
    the plain view (z, cg) -> c, or K2-dx's small-z view, the cotangent's
    (2 Zs, cg) as (Zs, 2 cg) -> c (the same bytes)."""
    return (z // 2, 2 * cg, c) if up else (z, cg, c)


def f32_dx_plan(B: int, X: int, Y: int, Z: int, Cg: int, C: int, up: bool,
                sms: int, smem_optin: int, xvec: bool = True) -> dict:
    """The split of an fp32 K1-dx (``up`` False) or K2-dx call over the
    card: ``f32_plan``'s walk on ``f32_dx_view``'s view of the cotangent
    (B, X, Y, Z, Cg) into dx (B, X, Y, Zs, C), with ``dx`` set (masked
    staging, no bias or activation), ``edges`` for K2-dx (its centre-tap
    edge terms, added by each block after its walk, in the shared memory
    the walk frees) and ``co`` F32_DX_CO. ``xvec``:
    the cotangent and the forward output both 16-byte aligned. Raises
    ValueError for a shape whose block does not fit (the source note of
    csrc/zconv_f32.cu gives the widest channels each takes)."""
    zs, kc, n = f32_dx_view(Z, Cg, C, up)
    return _f32_plan(B, X, Y, zs, kc, n, False, sms, smem_optin, xvec=xvec,
                     dx=True, edges=up)


def f32_smem_bytes(Z: int, C: int, coutp: int, ty: int = 1) -> int:
    """Shared memory of an fp32 K1 / K2 (/ dx) block of ``ty`` y rows at
    output z ``Z``: the weights of ``coutp`` output channels and F32_PLANES
    planes of (ty + 2) y rows x C channels x the padded z."""
    zs = -(-Z // F32_RZ) * F32_RZ + 4  # z -1 .. Z, and the last group's reads
    return 4 * (27 * C * coutp + F32_PLANES * (ty + 2) * C * zs)


def _f32_plan(B, X, Y, Zin, C, Cout, up, sms, smem_optin,
              co: Optional[int] = None, ty: Optional[int] = None,
              xvec: bool = True, dx: bool = False,
              edges: bool = False) -> dict:
    """f32_plan with ``co`` and ``ty`` forced where given, for
    tools/torch_zconv_probe.py to time the plans it did not choose; ``dx``
    and ``edges`` plan K1-dx and K2-dx on their view (f32_dx_plan)."""
    what = ("K2-dx" if edges else "K1-dx") if dx else ("K2" if up else "K1")
    if min(B, X, Y, Zin, C, Cout) <= 0:
        raise ValueError(f"empty shape {(B, X, Y, Zin, C, Cout)}")
    Z = 2 * Zin if up else Zin
    ngz = -(-Z // F32_RZ)
    zs = ngz * F32_RZ + 4  # z -1 .. Z, and the last group's reads
    ys = C * zs

    def smem(coutp, t):
        return f32_smem_bytes(Z, C, coutp, t)

    def most_rows(co_):
        coutp = _round_up(Cout, co_)
        t = min(Y, F32_MAX_THREADS // (ngz * (coutp // co_)))
        while t >= 1 and smem(coutp, t) > smem_optin:
            t -= 1
        return t

    if co is None:
        co = F32_DX_CO if dx else 4 if most_rows(4) >= 1 else 8
    if co not in ((F32_DX_CO,) if dx else (4, 8)):
        raise ValueError(f"fp32 {what} kernel: co {co} is not 4 or 8 (dx "
                         f"kernels: {F32_DX_CO})")
    t_max = most_rows(co)
    coutp = _round_up(Cout, co)
    if t_max < 1:
        raise ValueError(f"fp32 {what} kernel: z {Z} x {C} -> {Cout} "
                         f"channels needs {smem(coutp, 1)} bytes of shared "
                         f"memory and {ngz * (coutp // co)} threads a y row, "
                         f"the card allows {smem_optin} and "
                         f"{F32_MAX_THREADS}")
    if ty is None:
        ty = next((t for t in range(t_max, -(-3 * t_max // 4) - 1, -1)
                   if Y % t == 0), -(-Y // -(-Y // t_max)))
    elif not 1 <= ty <= t_max:
        raise ValueError(f"fp32 {what} kernel: ty {ty} outside 1..{t_max}")
    nchunks = coutp // co
    threads = _round_up(ty * ngz * nchunks, 32)
    nyt = -(-Y // ty)
    runs = -(-Zin // F32_RUN) if up else -(-Zin * C // F32_QUAD)
    rows = B * nyt * X
    if rows >= 2 ** 31 or Zin * C >= 2 ** 30:
        raise ValueError(f"fp32 {what} kernel: {rows} rows of {Zin * C}")
    nbytes = smem(coutp, ty)
    per_sm = max(1, min(SMEM_PER_SM // (nbytes + 1024), 2048 // threads))
    grid = max(1, min(per_sm * sms, rows // F32_MIN_ROWS))
    return dict(B=B, X=X, Y=Y, Zin=Zin, Z=Z, C=C, Cout=Cout, up=int(up),
                dx=int(dx), edges=int(edges),
                xvec=int(not up and xvec and Zin * C % F32_QUAD == 0),
                rz=F32_RZ, co=co, coutp=coutp, nchunks=nchunks, ngz=ngz,
                ty=ty, nyt=nyt, zs=zs, ys=ys, plane=(ty + 2) * ys,
                wfloats=27 * C * coutp, threads=threads, runs=runs,
                items=(ty + 2) * runs * (C if up else 1), rows=rows,
                grid=grid, xs=-(-rows // grid),
                smem_bytes=nbytes)


@functools.lru_cache(maxsize=None)
def _f32_limits(index: int):
    sms, optin = _I(), _I()
    with torch.cuda.device(index):
        rc = _library("zconv_f32").muvo_zconv_f32_limits(ctypes.byref(sms),
                                                        ctypes.byref(optin))
    _raise_if(rc, "zconv_f32", "fp32 K1 / K2")
    return sms.value, optin.value


def channel_slices(kid: str, dtype, zin: int, c: int, cout: int,
                   smem_optin: int):
    """The launches of one call of ``kid`` ("K1", "K2", "K1-dx" or
    "K2-dx") on x (B, X, Y, ``zin``, ``c``) into ``cout`` channels (the dx
    kernels: a cotangent of ``cout`` channels, at the small z ``zin`` for
    K2-dx, into dx of ``c``): slices [(lo, hi)] of its output channels,
    each launched alone. A kernel whose block holds the weights of every
    output channel it computes (fp32 K1, K2, K1-dx and K2-dx; bf16 K2 and
    K2-dx, whose folded weights have 45 taps) takes one launch where they
    all fit ``smem_optin``, else the fewest slices of a multiple of 4 (fp32)
    or 8 (bf16) channels that fit, each launch staging all of its input
    again: at the default config's conv3.conv1 (C 64 -> 32 at small z 32)
    fp32 and bf16 K2 four slices of 8, fp32 and bf16 K2-dx four of 16.
    bf16 K1 and K1-dx take one launch. Raises ValueError where the
    narrowest slice does not fit."""
    total = c if kid.endswith("-dx") else cout
    if dtype == torch.float32:  # the walk's view: its z and input channels
        z, kc = {"K1": (zin, c), "K2": (2 * zin, c), "K1-dx": (zin, cout),
                 "K2-dx": (zin, 2 * cout)}[kid]
        step = 4

        def smem(n):
            return f32_smem_bytes(z, kc, _round_up(n, step))
    elif kid in ("K2", "K2-dx"):  # the small-z view, with edge terms
        kc, per = (c, 2) if kid == "K2" else (2 * cout, 1)
        step = 8

        def smem(n):
            return tc_smem_bytes(zin, kc, per * n, True)
    else:
        return [(0, total)]
    for count in range(1, -(-total // step) + 1):
        size = -(-total // count)
        if count > 1:
            size = _round_up(size, step)
        if smem(size) <= smem_optin:
            return [(lo, min(lo + size, total))
                    for lo in range(0, total, size)]
    name = "fp32" if dtype == torch.float32 else "bf16"
    raise ValueError(f"{name} {kid} kernel: z {zin} x {c} -> {cout} "
                     f"channels needs {smem(step)} bytes of shared memory "
                     f"for {step} output channels, the card allows "
                     f"{smem_optin}")


def _launch_f32(x, w, bias32, out, slope, plan: dict):
    """fp32 K1 or K2 on ``plan`` (f32_plan of x's shape); w is (kx, ky, kz,
    C, Cout) fp32, bias32 fp32 or None."""
    with torch.cuda.device(x.device):
        rc = _library("zconv_f32").muvo_zconv3d_f32(
            x.data_ptr(), w.data_ptr(), _ptr(bias32), out.data_ptr(),
            ctypes.byref(_F32Shape(**plan)), int(slope is not None),
            float(slope or 0.0), _stream(x))
    _raise_if(rc, "zconv_f32", "K2" if plan["up"] else "K1")


def _launch_dx_f32(g, mask, slope, weight, dx, plan: dict):
    """fp32 K1-dx or K2-dx (``plan["edges"]``) on ``plan`` (f32_dx_plan
    of g's shape): the flipped, transposed kernel, or K2-dx's adjoint fold,
    main and edges (folded on the card, a few small einsums)."""
    if plan["edges"]:
        w, wedge = up_fold_weights(weight, adjoint=True)
    else:
        w, wedge = _kkkcn(weight, adjoint=True), None
    with torch.cuda.device(g.device):
        rc = _library("zconv_f32").muvo_zconv3d_dx_f32(
            g.data_ptr(), _ptr(mask), float(slope or 0.0), w.data_ptr(),
            _ptr(wedge), dx.data_ptr(), ctypes.byref(_F32Shape(**plan)),
            _stream(g))
    _raise_if(rc, "zconv_f32", "K2-dx" if plan["edges"] else "K1-dx")


def _dw_plain(xin, g, out, cout_c, slope, with_bias: bool):
    gm = leaky_mask(g, out, slope)
    dw = torch.nn.grad.conv3d_weight(to_nchw(xin), cout_c, to_nchw(gm),
                                     padding=1)
    dbias = gm.float().sum((0, 1, 2, 3)) if with_bias else None
    return dw.float(), dbias


def zconv3d_dw_plain(x, g, out, slope: Optional[float] = 0.2,
                     with_bias: bool = True):
    """K1's dW (Cout, C, 3, 3, 3) and dbias (Cout,), both fp32:
    conv3d_weight and a sum of the masked cotangent."""
    shape = (g.shape[-1], x.shape[-1], 3, 3, 3)
    return _dw_plain(x, g, out, shape, slope, with_bias)


def upzconv3d_dw_plain(x, g, out, slope: Optional[float] = 0.2,
                       with_bias: bool = True):
    """K2's dW and dbias: as K1's, on the z-upsampled input."""
    shape = (g.shape[-1], x.shape[-1], 3, 3, 3)
    return _dw_plain(upsample2x_z(x), g, out, shape, slope, with_bias)


# ---------------------------------------------------------------------------
# kernel launches
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


def _count(wrapper, dtype, impl):
    """One launch of ``wrapper``'s kernel on ``dtype`` tensors: adds one to
    its count and to its count for that type, and names the kernel run."""
    wrapper.launches += 1
    key = str(dtype).removeprefix("torch.")
    wrapper.launches_by_type[key] = wrapper.launches_by_type.get(key, 0) + 1
    wrapper.last_impl = impl


def _check_device(*tensors):
    """True for CPU tensors (plain version), False for CUDA ones (kernel)."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if dev.type == "cuda":
            if t.dtype not in _DTYPES:
                raise TypeError(f"kernel takes float32 or bfloat16, got "
                                f"{t.dtype}")
            if not t.is_contiguous():
                raise ValueError("kernel inputs must be contiguous NDHWC")
    return dev.type == "cpu"


def _kkkcn(weight, adjoint: bool = False):
    """(Cout, C, kx, ky, kz) -> (kx, ky, kz, C, Cout), fp32; ``adjoint``:
    flipped in space, C <-> Cout, (kx, ky, kz, Cout, C)."""
    w = weight.detach().float()
    if adjoint:
        return w.flip(2, 3, 4).permute(2, 3, 4, 0, 1).contiguous()
    return w.permute(2, 3, 4, 1, 0).contiguous()


def _tc_weights(weight, view: TcView, adjoint: bool):
    """The weights zconv_tc_kernel reads for ``view``, flat, fp32."""
    if view.name == "small-z":  # main then edges
        return torch.cat([t.reshape(-1) for t in
                          up_fold_weights(weight, adjoint=adjoint)])
    w = _kkkcn(weight, adjoint)
    return pair_fold_weights(w) if view.name == "pair" else w


def _launch_tc(x, mask, mslope, w, bias32, out, view: TcView, cb: int,
               dx: bool, slope, what: str):
    if w.dtype != torch.float32:  # the kernel reads the fold as fp32
        raise TypeError(f"{what}: folded weights are {w.dtype}, not fp32")
    b, X, Y = x.shape[:3]
    with torch.cuda.device(x.device):
        rc = _library("zconv").muvo_zconv3d_tc(
            x.data_ptr(), _ptr(mask), float(mslope or 0.0), w.data_ptr(),
            _ptr(bias32), out.data_ptr(), b, X, Y, view.zs, view.kc, view.n,
            cb, int(view.name == "small-z"), int(dx), int(slope is not None),
            float(slope or 0.0), _stream(x))
    _raise_if(rc, "zconv", what)


def _sliced(out, slices, launch) -> int:
    """Runs ``launch(lo, hi, part)`` for each slice [lo, hi) of out's last
    (channel) axis, ``part`` a new (..., hi - lo) tensor copied into out
    afterwards, or out itself where one slice covers it. Returns the number
    of launches."""
    if len(slices) == 1:
        launch(0, out.shape[-1], out)
        return 1
    for lo, hi in slices:
        part = torch.empty(out.shape[:-1] + (hi - lo,), dtype=out.dtype,
                           device=out.device)
        launch(lo, hi, part)
        out[..., lo:hi] = part
    return len(slices)


def _launch(x, weight, bias, slope, up: bool):
    """The forward kernel; returns the output, the kernel's name and the
    number of launches (K2 in bf16, K1 and K2 in fp32 may run on slices of
    Cout: ``channel_slices``)."""
    b, X, Y, zin, c = x.shape
    cout = weight.shape[0]
    z = 2 * zin if up else zin
    out = torch.empty((b, X, Y, z, cout), dtype=x.dtype, device=x.device)
    bias32 = None if bias is None else bias.detach().float().contiguous()
    what = "K2" if up else "K1"
    view = None
    if x.dtype == torch.bfloat16:
        view = (TcView("small-z", zin, c, 2 * cout) if up
                else k1_route(z, c, cout))
    if view is not None and up:
        views = []

        def run_tc(lo, hi, part):
            views.append(view._replace(n=2 * (hi - lo)))
            _launch_tc(x, None, None,
                       _tc_weights(weight[lo:hi], views[-1], False),
                       None if bias32 is None else bias32[lo:hi], part,
                       views[-1], hi - lo, False, slope, what)

        n = _sliced(out, channel_slices(what, x.dtype, zin, c, cout,
                                        _smem_optin(x)), run_tc)
        return out, _impl(views[-1], x.dtype, up, False), n
    if view is not None:
        _launch_tc(x, None, None, _tc_weights(weight, view, False), bias32,
                   out, view, cout, False, slope, what)
    elif x.dtype == torch.float32:
        sms, optin = _f32_limits(x.device.index or 0)
        w = _kkkcn(weight)

        def run_f32(lo, hi, part):
            w_part = w if hi - lo == cout else w[..., lo:hi].contiguous()
            _launch_f32(x, w_part, None if bias32 is None else bias32[lo:hi],
                        part, slope, f32_plan(b, X, Y, zin, c, hi - lo, up,
                                              sms, optin,
                                              xvec=x.data_ptr() % 16 == 0))

        n = _sliced(out, channel_slices(what, x.dtype, zin, c, cout, optin),
                    run_f32)
        return out, _impl(view, x.dtype, up, False), n
    else:
        w = _kkkcn(weight)
        with torch.cuda.device(x.device):
            rc = _library("zconv").muvo_zconv3d_leaky(
                x.data_ptr(), w.data_ptr(), _ptr(bias32), out.data_ptr(),
                b, X, Y, zin, c, cout, int(slope is not None),
                float(slope or 0.0), _DTYPES[x.dtype], _stream(x))
        _raise_if(rc, "zconv", what)
    return out, _impl(view, x.dtype, up, False), 1


def _forward(x, weight, bias, slope, up: bool):
    """K1 / K2 with no autograd: the plain version on the CPU, the kernel
    (counted, named in ``last_impl``) on the card."""
    _check(x, weight, bias)
    if _check_device(x, weight, bias):
        plain = upzconv3d_leaky_plain if up else zconv3d_leaky_plain
        return plain(x, weight, bias, slope)
    out, impl, launches = _launch(x, weight, bias, slope, up)
    for _ in range(launches):
        _count(upzconv3d_leaky if up else zconv3d_leaky, x.dtype, impl)
    return out


def _check_grad(g, out, weight, slope):
    if g.ndim != 5 or g.shape[-1] != weight.shape[0]:
        raise ValueError(f"cotangent shape {tuple(g.shape)} does not fit "
                         f"weight {tuple(weight.shape)}")
    if slope is not None and (out is None or out.shape != g.shape
                              or out.dtype != g.dtype):
        raise ValueError("the leaky mask needs the forward output, shaped "
                         "and typed as the cotangent")


def _dx(g, out, weight, slope, up: bool):
    _check_grad(g, out, weight, slope)
    if _check_device(g, out if slope is not None else None):
        plain = upzconv3d_dx_plain if up else zconv3d_dx_plain
        return plain(g, out, weight.to(g.dtype), slope)
    b, X, Y, z, cg = g.shape
    c = weight.shape[1]
    dx = torch.empty((b, X, Y, z // 2 if up else z, c), dtype=g.dtype,
                     device=g.device)
    mask = out if slope is not None else None
    what = "K2-dx" if up else "K1-dx"
    view, n = None, 1
    if g.dtype == torch.bfloat16:
        view = (TcView("small-z", z // 2, 2 * cg, c) if up
                else k1_route(z, cg, c))
    if view is not None and up:
        views = []

        def run_tc(lo, hi, part):
            views.append(view._replace(n=hi - lo))
            _launch_tc(g, mask, slope,
                       _tc_weights(weight[:, lo:hi], views[-1], True), None,
                       part, views[-1], hi - lo, True, None, what)

        n = _sliced(dx, channel_slices(what, g.dtype, view.zs, c, cg,
                                       _smem_optin(g)), run_tc)
        view = views[-1]
    elif view is not None:
        _launch_tc(g, mask, slope, _tc_weights(weight, view, True), None, dx,
                   view, view.n, True, None, what)
    elif g.dtype == torch.float32:
        sms, optin = _f32_limits(g.device.index or 0)
        xvec = all(t.data_ptr() % 16 == 0 for t in (g, mask) if t is not None)

        def run_f32(lo, hi, part):
            _launch_dx_f32(g, mask, slope, weight[:, lo:hi], part,
                           f32_dx_plan(b, X, Y, z, cg, hi - lo, up, sms,
                                       optin, xvec=xvec))

        n = _sliced(dx, channel_slices(what, g.dtype, z // 2 if up else z,
                                       c, cg, optin), run_f32)
    else:  # bf16 K1-dx past TC_MAX_CHANNELS
        w_adj = _kkkcn(weight, adjoint=True)
        with torch.cuda.device(g.device):
            rc = _library("zconv").muvo_zconv3d_dx(
                g.data_ptr(), _ptr(mask), float(slope or 0.0),
                w_adj.data_ptr(), dx.data_ptr(), b, X, Y, z, cg, c, 0,
                _DTYPES[g.dtype], _stream(g))
        _raise_if(rc, "zconv", what)
    for _ in range(n):
        _count(upzconv3d_dx if up else zconv3d_dx, g.dtype,
               _impl(view, g.dtype, up, True))
    return dx


def zconv3d_dx(g, out, weight, slope: Optional[float] = 0.2):
    """K1-dx: the gradient of K1's input. g and out (K1's output, for the
    leaky mask; unused when ``slope`` is None) are (B, X, Y, Z, Cout);
    returns (B, X, Y, Z, C) in g's type."""
    return _dx(g, out, weight, slope, up=False)


def upzconv3d_dx(g, out, weight, slope: Optional[float] = 0.2):
    """K2-dx: the gradient of K2's small-z input. g and out are
    (B, X, Y, 2 Zs, Cout); returns (B, X, Y, Zs, C) in g's type."""
    if g.shape[3] % 2:
        raise ValueError(f"K2's output z must be even, got {g.shape[3]}")
    return _dx(g, out, weight, slope, up=True)


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


# bf16 K3 / K3-up: tc::dw_tc_kernel in csrc/zconv_dw_tc.cu, the split-K
# GEMM D[(t, c), co] += A[(t, c), p] B[p, co] over the output positions p.
# Its plan is made here and passed in as the kernel's DwTcShape, whose
# fields are these, in this order.
DW_TC_FIELDS = (
    "B", "X", "Y", "Zin", "Z", "C", "Cout", "cp8", "cs", "zp", "zh", "ty",
    "nyt", "ntiles", "np", "mt", "mtiles", "mt0", "n0", "nwg", "grid",
    "m_passes", "n_passes", "xvec", "gvec", "plane_bytes", "gbuf_bytes",
    "smem_bytes")
DW_TC_MAX_WARPGROUPS = 4
DW_IMPL = {torch.bfloat16: "tc::dw_tc_kernel (csrc/zconv_dw_tc.cu)",
           torch.float32: "f32dw::dw_f32_kernel (csrc/zconv_dw.cu)"}


class _DwTcShape(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in DW_TC_FIELDS]


def dw_tc_plan(B: int, X: int, Y: int, Zin: int, C: int, Cout: int,
               up: bool, sms: int, smem_optin: int, xvec: bool = True,
               gvec: bool = True) -> dict:
    """The split of a bf16 K3 / K3-up call over the card, as the kernel
    reads it (see the source note of csrc/zconv_dw_tc.cu).

    GEMM rows: 27 taps x C rounded up to 8, then one row of ones (dbias),
    in m64 tiles; a warpgroup holds ``mt`` of them (at most 4 for N <= 16,
    else 2), a block ``nwg`` of 2-4 warpgroups, the pair that wastes the
    fewest tiles (then two warpgroups, so that two blocks share an SM);
    what one pass cannot hold takes more passes (also over 64-channel
    slices of Cout > 64). Positions: z rounded up to 32 (an even number of
    k16 steps), tiles of ``ty`` y rows (a power of two up to 16, cut until
    two blocks of 2 warpgroups share an SM, or one block of 3-4 fits) of
    one x row, x innermost; block i takes tiles
    i * ntiles // grid .. (i + 1) * ntiles // grid - 1. ``xvec`` and
    ``gvec`` say whether x allows 16-byte and g 4-byte loads. Raises
    ValueError for a shape whose block does not fit ``smem_optin``."""
    if min(B, X, Y, Zin, C, Cout) <= 0:
        raise ValueError(f"empty shape {(B, X, Y, Zin, C, Cout)}")
    Z = 2 * Zin if up else Zin
    cp8 = _round_up(C, 8)
    cs = cp8 if (cp8 // 8) % 2 else cp8 + 8
    zp = _round_up(Z, 32)
    np_ = next(n for n in (8, 16, 32, 64) if n >= min(Cout, 64))
    mt_max = 4 if np_ <= 16 else 2
    mtiles = -(-(27 * cp8 + 8) // 64)
    if mtiles >= DW_TC_MAX_WARPGROUPS * mt_max:
        nwg, mt = DW_TC_MAX_WARPGROUPS, mt_max
    else:
        nwg, mt = min(((w, m) for w in range(2, DW_TC_MAX_WARPGROUPS + 1)
                       for m in range(1, mt_max + 1) if w * m >= mtiles),
                      key=lambda wm: (wm[0] * wm[1], wm[0] != 2, wm[0]))
    per_sm = 2 if nwg <= 2 else 1
    cap = smem_optin // 2 - 1024 if per_sm == 2 else smem_optin

    def sizes(ty):
        plane = (ty + 2) * (zp + 2) * cs * 2
        gbuf = _round_up(ty * zp // 8 * (np_ // 8), 4) * 128
        return plane, gbuf, 128 + 2 * gbuf + 4 * plane

    ty = 16
    while ty > 1 and (ty // 2 >= Y or sizes(ty)[2] > cap):
        ty //= 2
    plane, gbuf, smem = sizes(ty)
    if smem > smem_optin:
        raise ValueError(f"bf16 dW kernel: z {Z} x {C} channels needs "
                         f"{smem} bytes of shared memory a block, the card "
                         f"allows {smem_optin}")
    nyt = -(-Y // ty)
    ntiles = B * nyt * X
    if ntiles >= 2 ** 31:
        raise ValueError(f"bf16 dW kernel: {ntiles} tiles")
    return dict(B=B, X=X, Y=Y, Zin=Zin, Z=Z, C=C, Cout=Cout, cp8=cp8, cs=cs,
                zp=zp, zh=zp + 2, ty=ty, nyt=nyt, ntiles=ntiles, np=np_,
                mt=mt, mtiles=mtiles, mt0=0, n0=0, nwg=nwg,
                grid=min(ntiles, per_sm * sms),
                m_passes=-(-mtiles // (nwg * mt)),
                n_passes=-(-Cout // np_), xvec=int(xvec and C % 8 == 0),
                gvec=int(gvec and Cout % 2 == 0), plane_bytes=plane,
                gbuf_bytes=gbuf, smem_bytes=smem)


def dw_tc_tiles(plan: dict, block: int):
    """(b, x, y0, y1) of each tile block ``block`` walks, in order: the
    kernel's tile decode (x innermost, then y tiles, then batch)."""
    n, grid = plan["ntiles"], plan["grid"]
    tiles = []
    for t in range(block * n // grid, (block + 1) * n // grid):
        q, xi = divmod(t, plan["X"])
        b, yt = divmod(q, plan["nyt"])
        y0 = yt * plan["ty"]
        tiles.append((b, xi, y0, min(y0 + plan["ty"], plan["Y"])))
    return tiles


def dw_tc_unpack(d, c: int, cout: int, with_bias: bool):
    """The kernel's D, (passes, rows, N) fp32 (row t * cp8 + c, column
    co - n0 of pass n0 / N; row 27 * cp8 is dbias), as dW (Cout, C, 3, 3,
    3) and dbias (Cout,) (None without ``with_bias``)."""
    passes, rows, n = d.shape
    d = d.permute(1, 0, 2).reshape(rows, passes * n)
    cp8 = _round_up(c, 8)
    dw = d[:27 * cp8].reshape(3, 3, 3, cp8, passes * n)[..., :c, :cout]
    db = d[27 * cp8, :cout].contiguous() if with_bias else None
    return dw.permute(4, 3, 0, 1, 2).contiguous(), db


@functools.lru_cache(maxsize=None)
def _dw_tc_limits(index: int):
    sms, optin = _I(), _I()
    with torch.cuda.device(index):
        rc = _library("zconv_dw_tc").muvo_dw_tc_limits(ctypes.byref(sms),
                                                      ctypes.byref(optin))
    _raise_if(rc, "zconv_dw_tc", "K3")
    return sms.value, optin.value


def _dw_tc(x, g, mask, slope, with_bias: bool, up: bool):
    b, X, Y, zin, c = x.shape
    cout = g.shape[-1]
    sms, optin = _dw_tc_limits(x.device.index or 0)
    plan = dw_tc_plan(
        b, X, Y, zin, c, cout, up, sms, optin,
        xvec=x.data_ptr() % 16 == 0,
        gvec=all(t.data_ptr() % 4 == 0 for t in (g, mask) if t is not None))
    rows = plan["mtiles"] * 64
    work = torch.empty(plan["grid"] * rows * plan["np"], dtype=torch.float32,
                       device=x.device)
    d = torch.empty((plan["n_passes"], rows, plan["np"]),
                    dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library("zconv_dw_tc").muvo_zconv3d_dw_tc(
            x.data_ptr(), g.data_ptr(), _ptr(mask), float(slope or 0.0),
            work.data_ptr(), d.data_ptr(), ctypes.byref(_DwTcShape(**plan)),
            int(up), _stream(x))
    _raise_if(rc, "zconv_dw_tc", "K3-up" if up else "K3")
    return dw_tc_unpack(d, c, cout, with_bias)


# fp32 K3 / K3-up: f32dw::dw_f32_kernel<UP> in csrc/zconv_dw.cu, a register
# tile of one (dx, dy) tap pair x 3 dz x 4 input x DW_F32_CO output channels
# a thread, sliding a z window over a ring of DW_F32_PLANES staged x planes.
# Its plan is made here and passed in as the kernel's DwF32Shape, whose
# fields are these, in this order; the constants are the kernel's (kCo,
# kThreads, kPrefetchX, kPrefetchG, kPlanes).
DW_F32_FIELDS = (
    "B", "X", "Y", "Zin", "Z", "C", "Cout", "up", "xvec", "gvec", "cp",
    "coutp", "ncic", "ncoc", "nunits", "nl", "passes", "unit0", "slices",
    "ty", "nyt", "nzs", "zrun", "ys", "plane", "gs", "gfloats", "threads",
    "runs", "items", "gruns", "gitems", "rows", "grid", "smem_bytes")
DW_F32_CO = 4
DW_F32_THREADS = 288
DW_F32_PREFETCH_X = 5
DW_F32_PREFETCH_G = 4
DW_F32_PLANES = 3
DW_F32_MAX_TY = 16     # y rows a tile at most
DW_F32_MIN_ROWS = 4    # rows a block walks at least, where there are enough


class _DwF32Shape(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in DW_F32_FIELDS]


def dw_f32_lanes(plan: dict):
    """What a quarter warp of the kernel loads at one z: (rows, x offsets,
    g offsets), ``rows`` consecutive y rows (its lanes' slices) and, in each,
    the distinct float4 offsets of its lanes' units (coc fastest, so lanes
    that differ only in coc read one x float4)."""
    rows = min(plan["slices"], 8)
    units = 8 // rows
    ncoc = plan["ncoc"]
    x_off = sorted({k // ncoc for k in range(units)})
    g_off = sorted({k % ncoc for k in range(units)})
    return rows, x_off, g_off


def bank_ways(stride: int, rows: int, offsets) -> int:
    """The most 16-byte loads of one quarter warp on one group of 4 banks:
    float4 offsets ``offsets`` in each of ``rows`` rows ``stride`` floats
    apart (a float4 spans 4 of the 32 banks, so 8 groups)."""
    hits = {}
    for r in range(rows):
        for o in offsets:
            slot = (r * stride // 4 + o) % 8
            hits[slot] = hits.get(slot, 0) + 1
    return max(hits.values())


def _dw_stride(floats: int, rows: int, offsets) -> int:
    """The smallest row stride (floats, a multiple of 4) of at least
    ``floats`` whose quarter-warp loads meet the fewest on one bank."""
    n = _round_up(floats, 4)
    return min(range(n, n + 32, 4),
               key=lambda st: (bank_ways(st, rows, offsets), st))


def dw_f32_plan(B: int, X: int, Y: int, Zin: int, C: int, Cout: int,
                up: bool, sms: int, smem_optin: int, xvec: bool = True,
                gvec: bool = True) -> dict:
    """The split of an fp32 K3 (``up`` False) or K3-up call over the card,
    as the kernel reads it (see the source note of csrc/zconv_dw.cu).

    Units are 9 (dx, dy) x ``ncic`` chunks of 4 input channels (C padded
    to ``cp``) x ``ncoc`` chunks of DW_F32_CO output channels (Cout padded
    to ``coutp``), unit u = (tap * ncic + cic) * ncoc + coc; a launch takes
    ``nl`` of them (at most DW_F32_THREADS; ``passes`` launches), and
    ``slices`` threads (the largest power of two that fits) share each over
    disjoint positions: thread t has unit t // slices, slice t % slices.
    Positions: tiles of ``ty`` y rows of one x row (the largest power of
    two up to DW_F32_MAX_TY and Y whose block fits ``smem_optin``: with
    slices a power of two too, the pairs below split evenly over them;
    tools/torch_zconv_probe.py times the plan against the fewer rows a
    smaller ``smem_optin`` gives), z cut into
    ``nzs`` segments of ``zrun`` so that the (y, segment) pairs are at
    least the slices; slice s takes pairs s, s + slices, ... ``rows`` = B x
    ``nyt`` x X rows are dealt to ``grid`` blocks (one an SM, at least
    DW_F32_MIN_ROWS rows each), block i taking rows i * rows // grid .. (i +
    1) * rows // grid - 1, x innermost. The plane's y rows (``ys`` floats,
    [z + 1][cp]) and the cotangent's (``gs``, [z][coutp]) are padded to the
    stride at which ``dw_f32_lanes``' loads meet the fewest on one bank.
    ``xvec`` and ``gvec`` say whether x's and g's (and the mask's) rows load
    as float4. Raises ValueError for a shape whose block does not fit."""
    what = "K3-up" if up else "K3"
    if min(B, X, Y, Zin, C, Cout) <= 0:
        raise ValueError(f"empty shape {(B, X, Y, Zin, C, Cout)}")
    Z = 2 * Zin if up else Zin
    cp, coutp = _round_up(C, 4), _round_up(Cout, DW_F32_CO)
    ncic, ncoc = cp // 4, coutp // DW_F32_CO
    nunits = 9 * ncic * ncoc
    nl = min(nunits, DW_F32_THREADS)
    slices = 1 << (DW_F32_THREADS // nl).bit_length() - 1
    threads = _round_up(nl * slices, 32)
    lanes, x_off, g_off = dw_f32_lanes(dict(slices=slices, ncoc=ncoc))
    ys = _dw_stride((Z + 2) * cp, lanes, x_off)
    gs = _dw_stride(Z * coutp, lanes, g_off)
    runs = -(-Zin // F32_RUN) if up else -(-Zin * C // F32_QUAD)
    xitems = runs * (C if up else 1)  # x items a y row
    gruns = -(-Z * Cout // F32_QUAD)

    def smem(t):  # the planes and cotangent rows; at the end, dbias's sums
        return max(4 * (DW_F32_PLANES * (t + 2) * ys + t * gs), 16 * threads)

    fits = [1 << k for k in range(DW_F32_MAX_TY.bit_length())
            if 1 << k <= Y and smem(1 << k) <= smem_optin]
    if not fits:
        raise ValueError(f"fp32 {what} kernel: z {Z} x {C} -> {Cout} "
                         f"channels needs {smem(1)} bytes of shared memory, "
                         f"the card allows {smem_optin}")
    ty = fits[-1]
    nzs = -(-slices // ty)
    zrun = -(-Z // nzs)
    nzs = -(-Z // zrun)
    nyt = -(-Y // ty)
    rows = B * nyt * X
    if rows >= 2 ** 31 or Zin * C >= 2 ** 30 or Z * Cout >= 2 ** 30:
        raise ValueError(f"fp32 {what} kernel: {rows} rows of {Zin * C}")
    return dict(B=B, X=X, Y=Y, Zin=Zin, Z=Z, C=C, Cout=Cout, up=int(up),
                xvec=int(not up and xvec and Zin * C % F32_QUAD == 0),
                gvec=int(gvec and Z * Cout % F32_QUAD == 0), cp=cp,
                coutp=coutp, ncic=ncic, ncoc=ncoc, nunits=nunits, nl=nl,
                passes=-(-nunits // nl), unit0=0, slices=slices, ty=ty,
                nyt=nyt, nzs=nzs, zrun=zrun, ys=ys, plane=(ty + 2) * ys,
                gs=gs, gfloats=ty * gs, threads=threads, runs=runs,
                items=(ty + 2) * xitems, gruns=gruns, gitems=ty * gruns,
                rows=rows, grid=max(1, min(sms, rows // DW_F32_MIN_ROWS)),
                smem_bytes=smem(ty))


def _launch_dw_f32(x, g, mask, slope, plan: dict, with_bias: bool):
    """fp32 K3 / K3-up on ``plan``: (dW (27, cp, coutp), dbias (coutp,) or
    None), fp32."""
    lib = _library("zconv_dw")
    shape = _DwF32Shape(**plan)
    floats = ctypes.c_size_t()
    what = "K3-up" if plan["up"] else "K3"
    rc = lib.muvo_zconv3d_dw_workspace(ctypes.byref(shape),
                                       ctypes.byref(floats))
    _raise_if(rc, "zconv_dw", what)
    dev = x.device
    work = torch.empty(floats.value, dtype=torch.float32, device=dev)
    dw = torch.empty((27, plan["cp"], plan["coutp"]), dtype=torch.float32,
                     device=dev)
    db = (torch.empty(plan["coutp"], dtype=torch.float32, device=dev)
          if with_bias else None)
    with torch.cuda.device(dev):
        rc = lib.muvo_zconv3d_dw(
            x.data_ptr(), g.data_ptr(), _ptr(mask), float(slope or 0.0),
            work.data_ptr(), dw.data_ptr(), _ptr(db), ctypes.byref(shape),
            _stream(x))
    _raise_if(rc, "zconv_dw", what)
    return dw, db


def _dw_f32(x, g, mask, slope, with_bias: bool, up: bool):
    b, X, Y, zin, c = x.shape
    cout = g.shape[-1]
    plan = dw_f32_plan(
        b, X, Y, zin, c, cout, up, *_f32_limits(x.device.index or 0),
        xvec=x.data_ptr() % 16 == 0,
        gvec=all(t.data_ptr() % 16 == 0 for t in (g, mask) if t is not None))
    dw, db = _launch_dw_f32(x, g, mask, slope, plan, with_bias)
    # (kx, ky, kz, C, Cout) -> upstream's (Cout, C, kx, ky, kz)
    dw = dw.reshape(3, 3, 3, plan["cp"], plan["coutp"])[..., :c, :cout]
    return (dw.permute(4, 3, 0, 1, 2).contiguous(),
            None if db is None else db[:cout].contiguous())


def _dw(x, g, out, slope, with_bias: bool, up: bool):
    if x.ndim != 5 or g.ndim != 5 or x.shape[:3] != g.shape[:3] or (
            g.shape[3] != (2 if up else 1) * x.shape[3]):
        raise ValueError(f"input {tuple(x.shape)} and cotangent "
                         f"{tuple(g.shape)} do not fit")
    if x.dtype != g.dtype:
        raise ValueError(f"input is {x.dtype}, cotangent {g.dtype}")
    if slope is not None and (out is None or out.shape != g.shape
                              or out.dtype != g.dtype):
        raise ValueError("the leaky mask needs the forward output, shaped "
                         "and typed as the cotangent")
    mask = out if slope is not None else None
    if _check_device(x, g, mask):
        plain = upzconv3d_dw_plain if up else zconv3d_dw_plain
        return plain(x, g, out, slope, with_bias)
    counted = upzconv3d_dw if up else zconv3d_dw
    if x.dtype == torch.bfloat16:
        result = _dw_tc(x, g, mask, slope, with_bias, up)
    else:
        result = _dw_f32(x, g, mask, slope, with_bias, up)
    _count(counted, x.dtype, DW_IMPL[x.dtype])
    return result


def zconv3d_dw(x, g, out, slope: Optional[float] = 0.2,
               with_bias: bool = True):
    """K3: K1's weight gradient (Cout, C, 3, 3, 3) and bias gradient
    (Cout,) (None without ``with_bias``), fp32, from its input x, the
    cotangent g and K1's output (the leaky mask)."""
    return _dw(x, g, out, slope, with_bias, up=False)


def upzconv3d_dw(x, g, out, slope: Optional[float] = 0.2,
                 with_bias: bool = True):
    """K3-up: K2's weight and bias gradients; x is K2's small-z input."""
    return _dw(x, g, out, slope, with_bias, up=True)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
class _ZConvFunction(torch.autograd.Function):
    """K1 / K2 with their backward kernels. Saves x, the weight and the
    output (the leaky mask), so a checkpointed decoder recomputes the
    forward kernel and runs each backward kernel once."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, weight, bias, slope, up):
        out = _forward(x, weight, bias, slope, up)
        ctx.save_for_backward(x, weight, out)
        ctx.slope, ctx.up, ctx.has_bias = slope, up, bias is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        x, weight, out = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _dx(g, out, weight, ctx.slope, ctx.up)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = _dw(x, g, out, ctx.slope,
                         ctx.has_bias and ctx.needs_input_grad[2], ctx.up)
            dw = dw.to(weight.dtype)
            db = None if db is None else db.to(ctx.bias_dtype)
        return dx, dw, db, None, None


def _apply(x, weight, bias, slope, up: bool):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return _ZConvFunction.apply(x, weight, bias, slope, up)
    if x.device.type == "cuda" and torch.is_autocast_enabled("cuda"):
        dtype = torch.get_autocast_dtype("cuda")
        x, weight = x.to(dtype), weight.to(dtype)
        bias = None if bias is None else bias.to(dtype)
    return _forward(x, weight, bias, slope, up)


def zconv3d_leaky(x, weight, bias=None, slope: Optional[float] = 0.2):
    """K1: LeakyReLU_slope(conv3d_same(x) + bias); x (B, X, Y, Z, C) ->
    (B, X, Y, Z, Cout). ``slope=None`` skips the activation."""
    return _apply(x, weight, bias, slope, up=False)


def upzconv3d_leaky(x, weight, bias=None, slope: Optional[float] = 0.2):
    """K2: LeakyReLU_slope(conv3d_same(up2_z(x)) + bias); x (B, X, Y, Zs, C)
    -> (B, X, Y, 2*Zs, Cout). x must already be upsampled in X and Y."""
    return _apply(x, weight, bias, slope, up=True)


# launch counts: each wrapper adds one per kernel launch, nowhere else, to
# its total and to its count for the tensors' type ("float32", "bfloat16");
# the kernel (and view) the last launch ran: _impl's names, DW_IMPL's for dW
for _wrapper in (zconv3d_leaky, upzconv3d_leaky, zconv3d_dx, upzconv3d_dx,
                 zconv3d_dw, upzconv3d_dw):
    _wrapper.launches = 0
    _wrapper.launches_by_type = {}
    _wrapper.last_impl = None
del _wrapper
