"""Flash attention for the LARGE fusion transformer (the port of
muvo_tpu/ops/flash_attention.py), with its plain versions.

K4 ``flash_fwd``: non-causal online-softmax attention, o and the fp32
    logsumexp lse. Replaces flash_attention.py::_flash_kernel via
    _flash_fwd.
K5 ``flash_bwd`` (default, ``split=False``): dq, dk, dv from one recompute
    of p per (key tile, q tile); dq accumulates in an fp32 workspace with
    atomics. In bf16 a block holds 128 keys, and each 64-row q tile's dq
    over those keys has one owner, the block's consumer warpgroup t % 2,
    which multiplies both key halves' dS (bf16, from shared memory) by k
    and adds the tile to the workspace; the other one only writes its half
    of dS and goes on. Replaces _flash_bwd_fused_kernel via
    _flash_bwd_fused.
K6 ``flash_bwd(split=True)``: K6-dq (dq alone, streaming keys) then K6-dkv
    (dk and dv, streaming queries), both deterministic. Replaces
    _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel via _flash_bwd.
K4-mb ``flash_matmul``: (q^ k^T cast to v's type) v, K4's matrix work
    without the softmax; the kernel of tools/pallas_smalld_microbench.py,
    timed by tools/torch_flash_microbench.py and on no path of the model.

q, k, v are (bh, n, d) with d in {32, 48, 64} on the card; keys at or past
``seq_len`` are masked, and no caller pads n (the kernels mask the ragged
tail). On a CPU tensor each wrapper runs its plain PyTorch version; on a
CUDA tensor it launches the hand-written kernel in csrc/flash_attention.cu
(CUDA C++ for sm_90a, plain C interface, ctypes) or raises, and names the
kernel in its ``last_impl`` ("plain" on the CPU; ``kernel_name`` gives
the name by dtype, as the source's dispatch picks). In bf16 every flash
kernel stages tiles by TMA and multiplies with wgmma (namespace hopper),
which needs the tensors' data 16-byte aligned (a misaligned view is
copied first): K4 and K4-mb are flash_fwd_wgmma, K5 and K6-dkv one
key-major kernel, flash_bwd_wgmma<D, DQ> (K6-dkv without K5's dq work,
so its dk and dv equal K5's bit for bit), on q^ = q * scale in bf16 from
scale_q_kernel (K5 writes it into dq, K6-dkv into a (bh, n, d) scratch
the wrapper allocates), and K6-dq the q-major flash_bwd_dq_wgmma<D> on
K4's skeleton (q^ formed in shared memory, dq kept in registers). fp32 K4
and K4-mb are register-tiled CUDA-core kernels (fp32::flash_fwd_f32), and
so are fp32 K5 and K6-dkv, one key-major template,
fp32::flash_bwd_kv_f32<D, FUSED>: 64 keys a block, dk and dv in registers,
each element one fmaf chain over the q rows in ascending order (the plain
version's order: their bits equal flash_bwd_plain's on the card), K5's dq
share added by float4 atomics; fp32 K6-dq is fp32::flash_bwd_q_f32<D>, the
same micro-tiles q-major (64 or 128 q rows a block, the key tiles
streaming), dq in registers over all key tiles in the plain version's
order, so its bits equal flash_bwd_plain's dq. The products bound the
backward kernels, the exponentials bound
bf16 K4; the source gives the numbers. muvo_tpu's
_FUSED_DQ_VMEM_BUDGET limits the TPU's VMEM and has no counterpart: K5's dq workspace lies in
device memory, so K5 serves every length, and ``split`` is the port's
form of muvo_tpu's MUVO_FLASH_FUSED_BWD switch, an argument and not an
environment variable.

``flash_attention(q, k, v, seq_len, bwd)`` takes muvo_tpu's (B, H, N, D)
layout and runs K4 under a ``torch.autograd.Function`` whose backward
launches K5 (``bwd="fused"``) or K6 (``bwd="split"``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30  # the score of a masked key, as muvo_tpu's _NEG_INF
HEAD_DIMS = (32, 48, 64)  # the head dims the kernels are built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_lib = None


def _library():
    global _lib
    if _lib is None:
        from muvo_tpu_torch.ops._build import load

        lib = load("flash_attention")
        lib.muvo_cuda_error_string.argtypes = [_I]
        lib.muvo_cuda_error_string.restype = ctypes.c_char_p
        lib.muvo_flash_fwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                       _I, _I, _P]
        lib.muvo_flash_bwd_fused.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,
                                             _P, _P, _I, _I, _I, _I, _F, _I,
                                             _P]
        lib.muvo_flash_bwd_dq.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                          _I, _I, _F, _I, _P]
        lib.muvo_flash_bwd_dkv.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                           _I, _I, _I, _I, _F, _I, _P]
        for fn in (lib.muvo_flash_fwd, lib.muvo_flash_bwd_fused,
                   lib.muvo_flash_bwd_dq, lib.muvo_flash_bwd_dkv):
            fn.restype = _I
        _lib = lib
    return _lib


def _count(wrapper, dtype, impl):
    """One launch of ``wrapper``'s kernel on ``dtype`` tensors: adds one to
    its count and to its count for that type, and names the kernel run."""
    wrapper.launches += 1
    key = str(dtype).removeprefix("torch.")
    wrapper.launches_by_type[key] = wrapper.launches_by_type.get(key, 0) + 1
    wrapper.last_impl = impl


def _raise_if(rc: int, what: str):
    if rc != 0:
        msg = _library().muvo_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (error {rc})")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


# the kernel each wrapper launches on the card, by type (the dispatch in
# csrc/flash_attention.cu), named as in the source, with its namespace
# where it has one
_KERNELS = {
    "K4": {torch.bfloat16: "hopper::flash_fwd_wgmma<{d}, true>",
           torch.float32: "fp32::flash_fwd_f32<{d}, true>"},
    "K4-mb": {torch.bfloat16: "hopper::flash_fwd_wgmma<{d}, false>",
              torch.float32: "fp32::flash_fwd_f32<{d}, false>"},
    "K5": {torch.bfloat16: "hopper::flash_bwd_wgmma<{d}, true>",
           torch.float32: "fp32::flash_bwd_kv_f32<{d}, true>"},
    "K6-dq": {torch.bfloat16: "hopper::flash_bwd_dq_wgmma<{d}>",
              torch.float32: "fp32::flash_bwd_q_f32<{d}>"},
    "K6-dkv": {torch.bfloat16: "hopper::flash_bwd_wgmma<{d}, false>",
               torch.float32: "fp32::flash_bwd_kv_f32<{d}, false>"},
}


def kernel_name(kid: str, dtype, d: int) -> str:
    """The kernel that flash kernel ``kid`` ("K4", "K4-mb", "K5", "K6-dq",
    "K6-dkv") runs on the card for ``dtype`` and head dim ``d``."""
    return _KERNELS[kid][dtype].format(d=d)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def softmax_scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def scaled_q(q):
    """q * 1/sqrt(d) rounded to q's type, the scale itself in q's type
    (muvo_tpu's ``q * jnp.asarray(scale, q.dtype)``)."""
    return q * torch.tensor(softmax_scale(q.shape[-1]), dtype=q.dtype)


def masked_scores(s, seq_len: Optional[int]):
    """NEG_INF at keys at or past seq_len."""
    n = s.shape[-1]
    if seq_len is None or seq_len >= n:
        return s
    keep = torch.arange(n, device=s.device) < seq_len
    return s.masked_fill(~keep, NEG_INF)


def _scores(q, k, seq_len):
    """fp32 scores of the scaled q, masked: (bh, n, n)."""
    return masked_scores(scaled_q(q).float() @ k.float().mT, seq_len)


def flash_fwd_plain(q, k, v, seq_len: Optional[int] = None):
    """K4's plain version: S materialised in fp32, p cast to v's type
    before p v and the row sum taken from the cast p. Returns (o in q's
    type, lse fp32 (bh, n))."""
    s = _scores(q, k, seq_len)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).to(v.dtype).float()
    l = p.sum(-1, keepdim=True)
    o = (p @ v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_bwd_plain(q, k, v, o, lse, do, seq_len: Optional[int] = None):
    """K5's and K6's plain version: p = exp(S - lse), delta = rowsum(dO O),
    dv = p(dO's type)^T dO, ds = p (dO v^T - delta), dq = ds(k's type) k
    scaled once, dk = ds(k's type)^T q^. Returns (dq, dk, dv) in the
    inputs' types."""
    p = torch.exp(_scores(q, k, seq_len) - lse[..., None])
    delta = (do.float() * o.float()).sum(-1)
    dv = p.to(do.dtype).float().mT @ do.float()
    ds = p * (do.float() @ v.float().mT - delta[..., None])
    ds = ds.to(k.dtype).float()
    dq = (ds @ k.float()) * softmax_scale(q.shape[-1])
    dk = ds.mT @ scaled_q(q).float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_matmul_plain(q, k, v):
    """K4-mb's plain version: (q^ k^T, fp32, cast to v's type) v in fp32,
    cast to q's type."""
    s = (scaled_q(q).float() @ k.float().mT).to(v.dtype).float()
    return (s @ v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------
def _check(*tensors, seq_len: Optional[int]):
    """Shapes, types and devices; the seq_len the kernels take. True for
    CPU tensors (plain version), False for CUDA ones (kernel)."""
    q = tensors[0]
    if q.ndim != 3:
        raise ValueError(f"flash attention takes (bh, n, d), got "
                         f"{tuple(q.shape)}")
    n = q.shape[1]
    seq_len = n if seq_len is None else int(seq_len)
    if not 1 <= seq_len <= n:
        raise ValueError(f"seq_len {seq_len} outside 1..{n}")
    dev = q.device
    for t in tensors:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"{tuple(t.shape)} {t.dtype} on {t.device} does "
                             f"not match q's {tuple(q.shape)} {q.dtype} on "
                             f"{dev}")
    if dev.type == "cpu":
        return True, seq_len
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dims {HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash kernel inputs must be contiguous (bh, n, d)")
    return False, seq_len


def _check_lse(lse, q):
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32 or (
            lse.device != q.device) or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 {tuple(q.shape[:2])} "
                         f"on {q.device}")


def _aligned(*tensors):
    """The tensors, each copied if its data does not start on 16 bytes
    (a view at an odd offset): the bf16 kernels read through TMA tensor
    maps, which need 16-byte aligned addresses."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors)


def _forward_launch(q, k, v, seq_len, softmax: bool):
    """K4 or K4-mb on the card: (o, lse)."""
    q, k, v = _aligned(q, k, v)
    bh, n, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _library().muvo_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, n, d, seq_len, softmax_scale(d), int(softmax),
            _DTYPES[q.dtype], _stream(q))
    _raise_if(rc, "K4" if softmax else "K4-mb")
    return o, lse


def flash_fwd(q, k, v, seq_len: Optional[int] = None):
    """K4: (o, lse) of softmax(q^ k^T) v over (bh, n, d), keys at or past
    ``seq_len`` masked; o in q's type, lse fp32 (bh, n)."""
    on_host, seq_len = _check(q, k, v, seq_len=seq_len)
    if on_host:
        flash_fwd.last_impl = "plain"
        return flash_fwd_plain(q, k, v, seq_len)
    out = _forward_launch(q, k, v, seq_len, softmax=True)
    _count(flash_fwd, q.dtype, kernel_name("K4", q.dtype, q.shape[-1]))
    return out


def flash_matmul(q, k, v):
    """K4-mb: (q^ k^T cast to v's type) v with fp32 accumulation, every
    key counted."""
    on_host, n = _check(q, k, v, seq_len=None)
    if on_host:
        flash_matmul.last_impl = "plain"
        return flash_matmul_plain(q, k, v)
    out, _ = _forward_launch(q, k, v, n, softmax=False)
    _count(flash_matmul, q.dtype,
           kernel_name("K4-mb", q.dtype, q.shape[-1]))
    return out


def _backward_args(q, k, v, o, lse, do, seq_len):
    """Checks; on the card also delta = rowsum(dO O), which stays one
    PyTorch reduction as in muvo_tpu, and the pointers every backward
    kernel takes."""
    on_host, seq_len = _check(q, k, v, o, do, seq_len=seq_len)
    _check_lse(lse, q)
    if on_host:
        return True, seq_len, None
    delta = (do.float() * o.float()).sum(-1)
    q, k, v, do = _aligned(q, k, v, do)
    bh, n, d = q.shape
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    tail = (bh, n, d, seq_len, softmax_scale(d), _DTYPES[q.dtype], _stream(q))
    return False, seq_len, (delta, head, tail)


def flash_bwd_dq(q, k, v, o, lse, do, seq_len: Optional[int] = None):
    """K6-dq: dq of K4 given its output o, lse and the cotangent do (in
    q's type)."""
    on_host, seq_len, args = _backward_args(q, k, v, o, lse, do, seq_len)
    if on_host:
        flash_bwd_dq.last_impl = "plain"
        return flash_bwd_plain(q, k, v, o, lse, do, seq_len)[0]
    _, head, tail = args
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _library().muvo_flash_bwd_dq(*head, dq.data_ptr(), *tail)
    _raise_if(rc, "K6-dq")
    _count(flash_bwd_dq, q.dtype,
           kernel_name("K6-dq", q.dtype, q.shape[-1]))
    return dq


def flash_bwd_dkv(q, k, v, o, lse, do, seq_len: Optional[int] = None):
    """K6-dkv: (dk, dv) of K4, inputs as flash_bwd_dq. In bf16 the kernel
    reads q^ from a scratch allocated here."""
    on_host, seq_len, args = _backward_args(q, k, v, o, lse, do, seq_len)
    if on_host:
        flash_bwd_dkv.last_impl = "plain"
        return flash_bwd_plain(q, k, v, o, lse, do, seq_len)[1:]
    _, head, tail = args
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    q_hat = torch.empty_like(q) if q.dtype == torch.bfloat16 else None
    with torch.cuda.device(q.device):
        rc = _library().muvo_flash_bwd_dkv(
            *head, None if q_hat is None else q_hat.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *tail)
    _raise_if(rc, "K6-dkv")
    _count(flash_bwd_dkv, q.dtype,
           kernel_name("K6-dkv", q.dtype, q.shape[-1]))
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, seq_len: Optional[int] = None,
              split: bool = False):
    """(dq, dk, dv) of K4, inputs as flash_bwd_dq. ``split=False``
    launches K5; ``split=True`` K6-dq, then K6-dkv."""
    if split:
        return (flash_bwd_dq(q, k, v, o, lse, do, seq_len),
                *flash_bwd_dkv(q, k, v, o, lse, do, seq_len))
    on_host, seq_len, args = _backward_args(q, k, v, o, lse, do, seq_len)
    if on_host:
        flash_bwd.last_impl = "plain"
        return flash_bwd_plain(q, k, v, o, lse, do, seq_len)
    _, head, tail = args
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    work = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _library().muvo_flash_bwd_fused(
            *head, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            work.data_ptr(), *tail)
    _raise_if(rc, "K5")
    _count(flash_bwd, q.dtype, kernel_name("K5", q.dtype, q.shape[-1]))
    return dq, dk, dv


# launch counts: each wrapper adds one per kernel launch, nowhere else, to
# its total and to its count for the tensors' type ("float32", "bfloat16");
# the kernel (or "plain") each ran last
for _wrapper in (flash_fwd, flash_bwd, flash_bwd_dq, flash_bwd_dkv,
                 flash_matmul):
    _wrapper.launches = 0
    _wrapper.launches_by_type = {}
    _wrapper.last_impl = None
del _wrapper


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
class _FlashFunction(torch.autograd.Function):
    """K4 forward saving (q, k, v, o, lse), as muvo_tpu's _flash_vjp_fwd;
    the backward launches K5 or, with ``bwd="split"``, K6."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, seq_len, bwd):
        o, lse = flash_fwd(q, k, v, seq_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.seq_len, ctx.split = seq_len, bwd == "split"
        return o

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, g.to(q.dtype).contiguous(),
                               ctx.seq_len, ctx.split)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, seq_len: Optional[int] = None,
                    bwd: str = "fused"):
    """q, k, v: (B, H, N, D) -> (B, H, N, D), muvo_tpu's signature and
    layout. Keys at or past ``seq_len`` are masked exactly; the rows past
    it are computed like any other. ``bwd``: "fused" (K5) or "split"
    (K6) for the gradient."""
    if bwd not in ("fused", "split"):
        raise ValueError(f"bwd must be 'fused' or 'split', got {bwd!r}")
    if not q.shape == k.shape == v.shape or q.ndim != 4:
        raise ValueError(f"q, k, v must share one (B, H, N, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, n, d = q.shape

    def flat(x):
        return x.reshape(b * h, n, d).contiguous()

    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _FlashFunction.apply(flat(q), flat(k), flat(v), seq_len, bwd)
    else:
        out, _ = flash_fwd(flat(q), flat(k), flat(v), seq_len)
    return out.reshape(b, h, n, d)
