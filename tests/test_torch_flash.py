"""The flash kernels' plain versions (muvo_tpu_torch/ops/flash_attention.py)
against muvo_tpu's Pallas flash kernels, on the CPU.

The same numpy inputs go through muvo_tpu's kernels (Pallas in interpret
mode, as tests/test_ops.py runs them) and the port's plain versions: K4's
(o, lse) against _flash_fwd, K5's and K6's (dq, dk, dv) against both
_flash_bwd_fused and _flash_bwd on muvo_tpu's own o and lse, and the
port's autograd Function (flash_attention, both backward schemes) against
jax.vjp of muvo_tpu's flash_attention. Shapes: (bh 2, n 300, d 48), a
ragged n inside one block, (bh 2, n 640, seq_len 600, d 32), keys
masked past seq_len across two blocks, and two at the edges of the card's
bf16 tiles: n 129 (d 48) and seq_len 128 of n 200 (d 64).
test_zero_padded_head_dim_changes_nothing holds what those kernels rely
on: zero columns past d leave every product, and so the results, as they
are.

Tolerances, norm-relative (|port - jax| / |jax|, Frobenius norms, per
output): fp32 1e-5 (summation order only); bf16 2e-2 (both sides round
q^, p and the outputs to bf16, but muvo_tpu rounds p relative to its
blocks' running maximum and the plain version to the row's).
test_checks_fail_on_a_wrong_kernel shows that each comparison fails for
a flipped key mask, a missing 1/sqrt(d) and a dq without its scale.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.ops import flash_attention as jfa
from muvo_tpu_torch.ops import flash_attention as fa

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (bh, n, d, seq_len)
SHAPES = {"n300_d48": (2, 300, 48, None), "n640_d32_seq600": (2, 640, 32, 600),
          # the bf16 kernels' tile edges: n one past a 128-row block, and
          # seq_len on a 128-key tile boundary
          "n129_d48": (2, 129, 48, None), "n200_d64_seq128": (2, 200, 64, 128)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _norm_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _np(x):
    """A torch or JAX array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_side(shape, dtype):
    """Inputs and muvo_tpu's results: the forward, both backward schemes
    on its own (o, lse), and jax.vjp of its flash_attention."""
    bh, n, d, seq_len = SHAPES[shape]
    rs = np.random.RandomState(0)
    x = {name: rs.randn(bh, n, d).astype(np.float32)
         for name in ("q", "k", "v", "do")}
    jt = DTYPES[dtype][0]
    q, k, v, do = (jnp.asarray(x[name], jt) for name in ("q", "k", "v", "do"))
    bq, bk = jfa._blocks(n)
    o, lse = jfa._flash_fwd(q, k, v, bq, bk, seq_len=seq_len)
    fused = jfa._flash_bwd_fused(q, k, v, o, lse, do, bq, bk, seq_len=seq_len)
    split = jfa._flash_bwd(q, k, v, o, lse, do, bq, bk, seq_len=seq_len)

    def attend(q4, k4, v4):
        return jfa.flash_attention(q4, k4, v4, seq_len)

    as4 = [t.reshape(1, bh, n, d) for t in (q, k, v)]
    out4, vjp = jax.vjp(attend, *as4)
    grads4 = vjp(do.reshape(1, bh, n, d))
    return {"inputs": x, "o": o, "lse": lse, "fused": fused, "split": split,
            "vjp_out": out4, "vjp_grads": grads4, "seq_len": seq_len}


def _port_inputs(side, dtype):
    tt = DTYPES[dtype][1]
    return [torch.from_numpy(side["inputs"][name]).to(tt)
            for name in ("q", "k", "v", "do")]


def _assert_close(got, want, dtype, what):
    rel = _norm_rel(_np(got), _np(want))
    assert rel <= TOL[dtype], (what, rel)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_plain_matches_pallas(shape, dtype):
    side = _jax_side(shape, dtype)
    q, k, v, _ = _port_inputs(side, dtype)
    o, lse = fa.flash_fwd_plain(q, k, v, side["seq_len"])
    assert o.dtype == DTYPES[dtype][1] and lse.dtype == torch.float32
    _assert_close(o, side["o"], dtype, "o")
    _assert_close(lse, side["lse"], dtype, "lse")


@pytest.mark.parametrize("scheme", ["fused", "split"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_backward_plain_matches_pallas(shape, dtype, scheme):
    """K5's and K6's plain version against _flash_bwd_fused (fused) and
    _flash_bwd (split), all on muvo_tpu's forward outputs."""
    side = _jax_side(shape, dtype)
    q, k, v, do = _port_inputs(side, dtype)
    o = torch.from_numpy(_np(side["o"])).to(q.dtype)
    lse = torch.from_numpy(_np(side["lse"]))
    got = fa.flash_bwd(q, k, v, o, lse, do, side["seq_len"],
                       split=scheme == "split")
    for name, g, w in zip(("dq", "dk", "dv"), got, side[scheme]):
        assert g.dtype == q.dtype
        _assert_close(g, w, dtype, name)


@pytest.mark.parametrize("bwd", ["fused", "split"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_autograd_function_matches_jax_vjp(shape, dtype, bwd):
    side = _jax_side(shape, dtype)
    bh, n, d, seq_len = SHAPES[shape]
    q, k, v, do = _port_inputs(side, dtype)
    xs = [t.reshape(1, bh, n, d).requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*xs, seq_len=seq_len, bwd=bwd)
    out.backward(do.reshape(out.shape))
    _assert_close(out, side["vjp_out"], dtype, "out")
    for name, x, w in zip(("dq", "dk", "dv"), xs, side["vjp_grads"]):
        assert x.grad.dtype == x.dtype
        _assert_close(x.grad, w, dtype, name)


def test_masked_keys_do_not_change_the_result():
    """Keys at or past seq_len change neither the output nor the other
    keys' gradients, and get none themselves."""
    rs = np.random.RandomState(1)
    q, k, v, do = (torch.from_numpy(rs.randn(2, 70, 32).astype(np.float32))
                   for _ in range(4))
    k2, v2 = k.clone(), v.clone()
    k2[:, 50:] = torch.from_numpy(rs.randn(2, 20, 32).astype(np.float32))
    v2[:, 50:] = torch.from_numpy(rs.randn(2, 20, 32).astype(np.float32))
    o, lse = fa.flash_fwd_plain(q, k, v, 50)
    o2, lse2 = fa.flash_fwd_plain(q, k2, v2, 50)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    dq, dk, dv = fa.flash_bwd_plain(q, k, v, o, lse, do, 50)
    dq2, dk2, dv2 = fa.flash_bwd_plain(q, k2, v2, o2, lse2, do, 50)
    assert torch.equal(dq, dq2)
    assert torch.equal(dk[:, :50], dk2[:, :50])
    assert not dk[:, 50:].any() and not dv[:, 50:].any()


def _flipped_mask(s, seq_len):
    n = s.shape[-1]
    if seq_len is None or seq_len >= n:
        return s
    return s.masked_fill(torch.arange(n) < seq_len, fa.NEG_INF)


@pytest.mark.parametrize("fault", ["flipped_mask", "no_softmax_scale",
                                   "dq_without_scale"])
def test_checks_fail_on_a_wrong_kernel(monkeypatch, fault):
    """The comparisons above fail for a wrong version of the kernels'
    arithmetic, in fp32 and bf16 alike."""
    for dtype in DTYPES:
        side = _jax_side("n640_d32_seq600", dtype)
        q, k, v, do = _port_inputs(side, dtype)
        o = torch.from_numpy(_np(side["o"])).to(q.dtype)
        lse = torch.from_numpy(_np(side["lse"]))
        with monkeypatch.context() as mp:
            if fault == "flipped_mask":
                mp.setattr(fa, "masked_scores", _flipped_mask)
            elif fault == "no_softmax_scale":
                mp.setattr(fa, "softmax_scale", lambda d: 1.0)
            got_o, got_lse = fa.flash_fwd_plain(q, k, v, side["seq_len"])
            dq, dk, dv = fa.flash_bwd_plain(q, k, v, o, lse, do,
                                            side["seq_len"])
        if fault == "dq_without_scale":
            dq = dq * 32 ** 0.5
            failing = [("dq", dq, side["fused"][0])]
        else:
            failing = [("o", got_o, side["o"]), ("lse", got_lse, side["lse"]),
                       ("dq", dq, side["fused"][0]),
                       ("dk", dk, side["fused"][1])]
        for name, got, want in failing:
            rel = _norm_rel(_np(got), _np(want))
            assert rel > TOL[dtype], (fault, dtype, name, rel)


@pytest.mark.parametrize("seq_len", [None, 40])
def test_bench_counts_each_flash_attention(monkeypatch, seq_len):
    """muvo_tpu_torch.bench adds 4 + 8 x bh L^2 d model FLOPs for each
    attention that takes flash (FlopCounterMode cannot see the kernels),
    L the unmasked keys, and nothing where attention takes the math path."""
    from muvo_tpu_torch import bench
    from muvo_tpu_torch.models.transformer import TransformerEncoder
    from muvo_tpu_torch.ops import attention

    model = TransformerEncoder(96, n_layers=2, n_heads=2, dim_feedforward=64)
    x = torch.randn(3, 50, 96)
    for flash, want in ((False, 0),
                        (True, 2 * 12 * 3 * 2 * (seq_len or 50) ** 2 * 48)):
        monkeypatch.setattr(attention, "uses_flash", lambda n, dev: flash)
        counts = [0]
        hooks = bench._kernel_flops_hooks(model, counts)
        try:
            model(x, seq_len)
        finally:
            for h in hooks:
                h.remove()
        assert counts[0] == want


@pytest.mark.parametrize("seq_len", [None, 40])
@pytest.mark.parametrize("part", ["forward", "backward"])
def test_zero_padded_head_dim_changes_nothing(monkeypatch, part, seq_len):
    """The bf16 kernels stage d = 48 as 64 columns, the 16 past d zero (a
    tile 128 bytes wide). The plain versions on q, k, v, dO padded so, with
    the scale of d = 48, give the unpadded results exactly in fp32: o and
    the gradients in the first 48 columns, zeros past them, the same lse.
    The backward takes o on a 1/64 grid and dO on a 1/8 grid, so that
    delta = rowsum(dO o), which the kernels take from the unpadded
    tensors, sums exactly in any order (the CPU groups 64 terms other than
    48)."""
    rs = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rs.randn(2, 70, 48).astype(np.float32))
               for _ in range(3))
    do = torch.from_numpy(rs.randint(-8, 9, (2, 70, 48)).astype(np.float32)
                          / 8)
    o, lse = fa.flash_fwd_plain(q, k, v, seq_len)
    o = torch.round(o * 64) / 64
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, seq_len)
    q64, k64, v64, do64, o64 = (torch.nn.functional.pad(t, (0, 16))
                                for t in (q, k, v, do, o))
    monkeypatch.setattr(fa, "softmax_scale", lambda d: 1.0 / 48 ** 0.5)
    if part == "forward":
        got_o, got_lse = fa.flash_fwd_plain(q64, k64, v64, seq_len)
        o, lse = fa.flash_fwd_plain(q, k, v, seq_len)
        assert torch.equal(got_o[..., :48], o)
        assert not got_o[..., 48:].any()
        assert torch.equal(got_lse, lse)
    else:
        got = fa.flash_bwd_plain(q64, k64, v64, o64, lse, do64, seq_len)
        for g, w in zip(got, want):
            assert torch.equal(g[..., :48], w)
            assert not g[..., 48:].any()
