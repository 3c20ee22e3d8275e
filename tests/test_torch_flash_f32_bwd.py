"""fp32 K5 and K6-dkv (fp32::flash_bwd_kv_f32<D, FUSED> in
muvo_tpu_torch/csrc/flash_attention.cu) on the CPU: the kernel's walk in
plain PyTorch, held against the port's plain version and muvo_tpu's Pallas
backward kernels, and the kernel's host-visible constants.

The walk: one block per 64 keys of one bh (a key tile wholly past seq_len
only writes zeros), the 64-row q tiles in ascending order (the last one
ragged, its rows past n zero), 256 threads. A: thread t's 4 q x 4 key
micro-tile of S = q^ k^T and dP = dO v^T, p = exp(S - lse) (0 at masked
keys and rows past n), ds = p (dP - delta), put into the tile's P and dS.
B: thread t's 4 keys x d/16 columns of dV += P^T dO and dK += dS^T q^, one
q row at a time, ascending. C (K5): thread t's 4 q rows x d/16 columns of
the tile's dq share dS k, staged in shared memory and added to an fp32
workspace a row's float4s at a time at the start of the next tile (the
last tile's after the walk); dq = workspace * 1/sqrt(d) at the end. The
maps below are the kernel's (``a_tile``, ``b_tile``, ``c_tile``,
``stage_item``); only the card tests (tests/test_torch_cuda.py,
marker cuda) and chip_smoke.py prove the kernel's own walk, and there its
dk and dv must equal the plain version's bit for bit.

1. The walk matches flash_bwd_plain within 1e-5 norm-relative (the same
   fp32 arithmetic; torch rounds each product where the kernel's fmaf does
   not), and muvo_tpu's _flash_bwd_fused and _flash_bwd (Pallas in
   interpret mode, on muvo_tpu's own o and lse) within 1e-4 (fp32 sums in
   other orders), at d 32, 48 and 64, n 64, 127, 129 and 300, seq_len
   inside a tile and key tiles of masked keys only; K6-dkv's walk gives
   K5's dk and dv. A walk that leaves out the ragged q tail or the key
   mask is caught.
2. The micro-tiles cover each (q row, key) of S once, each (key, column)
   of dk and dv once, and each (q row, column) of the dq share once per
   key tile; the staging items (q, dO, k, v and the dq share's flush)
   cover each float4 of a 64-row tile once.
3. BwdLayout, read from the source, fits 232,448 bytes at every d for K5
   and K6-dkv, its regions 16-byte aligned and disjoint, and a warp's
   float4 reads and stores in A, B and C take no more shared-memory
   wavefronts than their bytes need (no bank conflict).
4. On CPU tensors K5 and K6-dkv run the plain version and count no launch.
"""

import functools
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.ops import flash_attention as jfa
from muvo_tpu_torch.ops import flash_attention as fa

PLAIN_TOL, PALLAS_TOL = 1e-5, 1e-4
H100_SMEM_OPTIN = 232448  # a block's shared memory on sm_90
# (bh, n, d, seq_len): one tile; a ragged q tail; one row past two tiles;
# seq_len inside a key tile with the last key tile wholly masked; seq_len
# inside the first tile (four tiles of masked keys); a ragged tail at d 64
# with a masked tail tile
SHAPES = {"n64_d48": (1, 64, 48, None), "n127_d32": (2, 127, 32, None),
          "n129_d64": (2, 129, 64, None), "n300_d48_seq200": (2, 300, 48, 200),
          "n300_d32_seq60": (2, 300, 32, 60),
          "n129_d64_seq100": (1, 129, 64, 100)}

_SOURCE = (Path(fa.__file__).resolve().parents[1] / "csrc"
           / "flash_attention.cu").read_text()
_FP32 = _SOURCE[_SOURCE.index("namespace fp32 {"):
                _SOURCE.index("}  // namespace fp32")]


def _constant(pattern):
    m = re.search(pattern, _FP32)
    assert m, pattern
    return int(m.group(1))


THREADS = _constant(r"constexpr int kRows = \d+, kKeys = \d+, "
                    r"kThreads = (\d+);")
KEYS = _constant(r"constexpr int kBwdKeys = (\d+), kBwdRows = \d+;")
ROWS = _constant(r"constexpr int kBwdKeys = \d+, kBwdRows = (\d+);")
BS = KEYS + _constant(r"constexpr int kBS = kBwdKeys \+ (\d+);")
SMEM_OPTIN = _constant(r"constexpr int kSmemOptin = (\d+);")


def layout(d: int, fused: bool) -> dict:
    """BwdLayout<d, fused>'s members, evaluated from the source (offsets
    in floats, ``bytes``)."""
    body = re.search(r"struct BwdLayout \{(.*?)\n\};", _FP32, re.S).group(1)
    env = {"D": d, "FUSED": int(fused), "kBwdKeys": KEYS, "kBwdRows": ROWS,
           "kBS": BS}
    out = {}
    for name, expr in re.findall(
            r"static constexpr (?:int|size_t) (\w+) = ([^;]+);", body):
        out[name] = env[name] = eval(expr.replace("sizeof(float)", "4"),
                                     {}, dict(env))
    return out


# ---------------------------------------------------------------------------
# the kernel's thread maps
# ---------------------------------------------------------------------------
def a_tile(tid):
    """A: thread ``tid``'s q rows and keys of S and dP."""
    w, lane = tid >> 5, tid & 31
    ra = 16 * (w >> 1) + (lane >> 3)
    kb = 32 * (w & 1) + 4 * (lane & 7)
    return [ra + 4 * i for i in range(4)], [kb + j for j in range(4)]


def b_tile(tid, d):
    """B: thread ``tid``'s keys and columns of dK and dV."""
    kg, cg = tid >> 4, tid & 15
    return [4 * kg + j for j in range(4)], [cg + 16 * m for m in range(d // 16)]


def c_tile(tid, d):
    """C: thread ``tid``'s q rows and columns of the dq share (B's map,
    on q rows)."""
    return b_tile(tid, d)


def stage_item(tid, j, d):
    """The (row, float4) of a 64-row tile that thread ``tid`` loads or
    flushes as its ``j``-th float4 (q, dO, k, v; the dq share)."""
    idx = tid + THREADS * j
    return divmod(idx, d // 4)


@functools.lru_cache(maxsize=None)
def _maps(d):
    a = [a_tile(t) for t in range(THREADS)]
    b = [b_tile(t, d) for t in range(THREADS)]
    return (torch.tensor([r for r, _ in a]), torch.tensor([k for _, k in a]),
            torch.tensor([k for k, _ in b]), torch.tensor([c for _, c in b]))


def _flush(work_b, dq_tile, q0, n):
    """The kernel's flush of one tile's staged dq share: each thread's
    float4s of rows below n added to the workspace."""
    d = dq_tile.shape[1]
    for j in range(ROWS * d // 4 // THREADS):
        rows, c4 = zip(*(stage_item(t, j, d) for t in range(THREADS)))
        rows, c4 = torch.tensor(rows), torch.tensor(c4)
        ok = q0 + rows < n
        cols = 4 * c4[ok][:, None] + torch.arange(4)
        work_b.index_put_(((q0 + rows[ok])[:, None], cols),
                          dq_tile[rows[ok][:, None], cols], accumulate=True)


def _rows(x, r0, count, n):
    """Rows r0 .. r0 + count - 1 of a (n, ...) tensor, zero past n."""
    out = torch.zeros((count, *x.shape[1:]), dtype=x.dtype)
    hi = min(r0 + count, n)
    if hi > r0:
        out[:hi - r0] = x[r0:hi]
    return out


def kernel_walk(q, k, v, o, lse, do, seq_len=None, fused=True, fault=None):
    """fp32 K5 (``fused``: (dq, dk, dv)) or K6-dkv ((dk, dv)) as the kernel
    walks it. ``fault`` breaks the walk for test_checks_fail_on_a_wrong_walk:
    "no_tail" (the ragged last q tile left out), "no_mask" (keys at or past
    seq_len counted)."""
    bh, n, d = q.shape
    seq_len = n if seq_len is None else seq_len
    scale = torch.tensor(fa.softmax_scale(d), dtype=torch.float32)
    delta = (do * o).sum(-1)  # the wrapper's rowsum(dO O)
    a_rows, a_keys, b_keys, b_cols = _maps(d)
    c_rows, c_cols = b_keys, b_cols  # C's map is B's, on q rows
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    work = torch.zeros_like(q)
    tiles = -(-n // ROWS)
    if fault == "no_tail" and n % ROWS:
        tiles -= 1
    for b in range(bh):
        for k0 in range(0, n, KEYS):
            if k0 >= seq_len:
                continue  # the block writes zeros
            ks, vs = _rows(k[b], k0, KEYS, n), _rows(v[b], k0, KEYS, n)
            reg_k = torch.zeros((THREADS, 4, d // 16))
            reg_v = torch.zeros((THREADS, 4, d // 16))
            key_live = k0 + a_keys < (n if fault == "no_mask" else seq_len)
            for q0 in range(0, tiles * ROWS, ROWS):
                qh = _rows(q[b], q0, ROWS, n) * scale
                dos = _rows(do[b], q0, ROWS, n)
                ls, ds_ = _rows(lse[b], q0, ROWS, n), _rows(delta[b], q0, ROWS, n)
                # A: (thread, i, j) micro-tiles, sums over c
                s = torch.einsum("tic,tjc->tij", qh[a_rows], ks[a_keys])
                dp = torch.einsum("tic,tjc->tij", dos[a_rows], vs[a_keys])
                live = (q0 + a_rows < n)[:, :, None] & key_live[:, None, :]
                p = torch.where(live, torch.exp(s - ls[a_rows][:, :, None]),
                                torch.zeros(()))
                ds = p * (dp - ds_[a_rows][:, :, None])
                P = torch.zeros((ROWS, KEYS))
                dS = torch.zeros((ROWS, KEYS))
                P[a_rows[:, :, None], a_keys[:, None, :]] = p
                dS[a_rows[:, :, None], a_keys[:, None, :]] = ds
                # B: one q row at a time, ascending
                for r in range(ROWS):
                    reg_v += P[r, b_keys][:, :, None] * dos[r, b_cols][:, None, :]
                    reg_k += dS[r, b_keys][:, :, None] * qh[r, b_cols][:, None, :]
                if fused:  # C: the dq share over the block's keys, staged
                    share = torch.einsum("tik,tkm->tim", dS[c_rows],
                                         ks[:, c_cols].permute(1, 0, 2))
                    staged = torch.zeros((ROWS, d))
                    staged[c_rows[:, :, None], c_cols[:, None, :]] = share
                    _flush(work[b], staged, q0, n)
            keys, cols = torch.broadcast_tensors((k0 + b_keys)[:, :, None],
                                                 b_cols[:, None, :])
            ok = keys < n
            dk[b][keys[ok], cols[ok]] = reg_k[ok]
            dv[b][keys[ok], cols[ok]] = reg_v[ok]
    if fused:
        return work * scale, dk, dv
    return dk, dv


def _norm_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _inputs(shape):
    bh, n, d, seq_len = SHAPES[shape]
    rs = np.random.RandomState(0)
    x = {name: rs.randn(bh, n, d).astype(np.float32)
         for name in ("q", "k", "v", "do")}
    return x, seq_len


@functools.lru_cache(maxsize=None)
def _port_side(shape):
    """Inputs, the walks (K5, K6-dkv) and the plain version on the port's
    plain forward's o and lse."""
    x, seq_len = _inputs(shape)
    q, k, v, do = (torch.from_numpy(x[name])
                   for name in ("q", "k", "v", "do"))
    o, lse = fa.flash_fwd_plain(q, k, v, seq_len)
    fused = kernel_walk(q, k, v, o, lse, do, seq_len)
    split = kernel_walk(q, k, v, o, lse, do, seq_len, fused=False)
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, seq_len)
    return (q, k, v, o, lse, do, seq_len), fused, split, want


@pytest.mark.parametrize("shape", list(SHAPES))
def test_walk_matches_plain(shape):
    _, fused, split, want = _port_side(shape)
    for got, w, what in zip(fused, want, ("dq", "dk", "dv")):
        assert got.dtype == torch.float32 and got.shape == w.shape
        assert _norm_rel(_np(got), _np(w)) <= PLAIN_TOL, what
    # K6-dkv is K5 without C: the same dk and dv
    assert torch.equal(split[0], fused[1]) and torch.equal(split[1], fused[2])
    # a key tile past seq_len writes zeros
    seq_len = SHAPES[shape][3] or SHAPES[shape][1]
    assert not fused[1][:, seq_len:].any() and not fused[2][:, seq_len:].any()


@pytest.mark.parametrize("shape", list(SHAPES))
def test_walk_matches_pallas(shape):
    """The walk against muvo_tpu's _flash_bwd_fused (K5) and _flash_bwd
    (K6), Pallas in interpret mode, on the same fp32 inputs and muvo_tpu's
    own o and lse."""
    x, seq_len = _inputs(shape)
    n = SHAPES[shape][1]
    jq, jk, jv, jdo = (jnp.asarray(x[name], jnp.float32)
                       for name in ("q", "k", "v", "do"))
    bq, bk = jfa._blocks(n)
    jo, jlse = jfa._flash_fwd(jq, jk, jv, bq, bk, seq_len=seq_len)
    want_fused = jfa._flash_bwd_fused(jq, jk, jv, jo, jlse, jdo, bq, bk,
                                      seq_len=seq_len)
    want_split = jfa._flash_bwd(jq, jk, jv, jo, jlse, jdo, bq, bk,
                                seq_len=seq_len)
    q, k, v, do = (torch.from_numpy(x[name])
                   for name in ("q", "k", "v", "do"))
    o, lse = torch.from_numpy(_np(jo)), torch.from_numpy(_np(jlse))
    fused = kernel_walk(q, k, v, o, lse, do, seq_len)
    split = kernel_walk(q, k, v, o, lse, do, seq_len, fused=False)
    for got, w, what in zip(fused, want_fused, ("dq", "dk", "dv")):
        assert _norm_rel(_np(got), _np(w)) <= PALLAS_TOL, ("fused", what)
    for got, w, what in zip(split, want_split[1:], ("dk", "dv")):
        assert _norm_rel(_np(got), _np(w)) <= PALLAS_TOL, ("split", what)


@pytest.mark.parametrize("fault", ["no_tail", "no_mask"])
def test_checks_fail_on_a_wrong_walk(fault):
    """A walk that leaves out the ragged q tail, or counts the keys past
    seq_len, is caught by the plain comparison."""
    args, _, _, want = _port_side("n300_d48_seq200")
    got = kernel_walk(*args, fault=fault)
    assert max(_norm_rel(_np(g), _np(w)) for g, w in zip(got, want)) > (
        PLAIN_TOL)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_micro_tiles_cover_once(d):
    s = np.zeros((ROWS, KEYS), int)
    kv = np.zeros((KEYS, d), int)
    dq = np.zeros((ROWS, d), int)
    items = np.zeros((ROWS, d // 4), int)
    for t in range(THREADS):
        rows, keys = a_tile(t)
        for r in rows:
            for key in keys:
                s[r, key] += 1
        keys, cols = b_tile(t, d)
        for key in keys:
            for c in cols:
                kv[key, c] += 1
        rows, cols = c_tile(t, d)
        for r in rows:
            for c in cols:
                dq[r, c] += 1
        for j in range(ROWS * d // 4 // THREADS):
            items[stage_item(t, j, d)] += 1
    assert (s == 1).all() and (kv == 1).all() and (dq == 1).all()
    assert (items == 1).all() and ROWS * (d // 4) % THREADS == 0


@pytest.mark.parametrize("fused", [True, False], ids=["K5", "K6-dkv"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_layout_fits_the_card(d, fused):
    lay = layout(d, fused)
    assert SMEM_OPTIN == H100_SMEM_OPTIN
    assert lay["bytes"] <= H100_SMEM_OPTIN
    regions = [("kt", d * BS), ("vt", d * BS), ("dq", fused * ROWS * lay["QS"]),
               ("q", 2 * ROWS * lay["QS"]), ("dout", 2 * ROWS * lay["QS"]),
               ("lse", 2 * ROWS), ("delta", 2 * ROWS), ("p", ROWS * BS),
               ("ds", ROWS * BS)]
    at = 0
    for name, size in regions:  # in order, disjoint, 16-byte aligned
        assert lay[name] == at and at % 4 == 0, name
        at += size
    assert lay["bytes"] == 4 * at
    assert lay["QS"] % 4 == 0 and BS % 4 == 0  # float4 rows


def _wavefronts(words):
    """Shared-memory wavefronts of one warp access: the most distinct
    4-byte words that fall in one of the 32 banks."""
    per_bank = {}
    for w in set(words):
        per_bank.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in per_bank.values())


def _float4s(starts):
    return [s + e for s in starts for e in range(4)]


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_shared_reads_have_no_bank_conflict(d):
    """Each warp's float4 reads and stores in A, B and C take
    ceil(distinct bytes / 128) wavefronts, the least they can."""
    qs = layout(d, True)["QS"]
    for w in range(THREADS // 32):
        tids = range(32 * w, 32 * w + 32)
        accesses = []
        for i in range(4):  # A: q^ / dO rows; P, dS stores
            accesses.append(_float4s([a_tile(t)[0][i] * qs + 4 for t in tids]))
            accesses.append(_float4s([a_tile(t)[0][i] * BS + a_tile(t)[1][0]
                                      for t in tids]))
        accesses.append(_float4s([3 * BS + a_tile(t)[1][0] for t in tids]))
        accesses.append(_float4s([5 * BS + b_tile(t, d)[0][0]
                                  for t in tids]))  # B: P, dS
        accesses.append([5 * qs + b_tile(t, d)[1][1] for t in tids])
        for i in range(4):  # C: dS rows, k^T rows; the staged share
            accesses.append(_float4s([c_tile(t, d)[0][i] * BS + 8
                                      for t in tids]))
            accesses.append([c_tile(t, d)[0][i] * qs + c_tile(t, d)[1][1]
                             for t in tids])
        accesses.append(_float4s([c_tile(t, d)[1][1] * BS + 8 for t in tids]))
        for words in accesses:
            assert _wavefronts(words) == math.ceil(len(set(words)) / 32)


@pytest.mark.parametrize("split", [False, True], ids=["K5", "K6-dkv"])
def test_cpu_tensors_run_the_plain_version(split):
    (q, k, v, o, lse, do, seq_len), _, _, want = _port_side("n127_d32")
    wrapper = fa.flash_bwd_dkv if split else fa.flash_bwd
    launches = dict(wrapper.launches_by_type), wrapper.launches
    wrapper.last_impl = None
    got = (fa.flash_bwd_dkv(q, k, v, o, lse, do, seq_len) if split
           else fa.flash_bwd(q, k, v, o, lse, do, seq_len))
    assert wrapper.last_impl == "plain"
    assert (dict(wrapper.launches_by_type), wrapper.launches) == launches
    for g, w in zip(got, want[1:] if split else want):
        assert torch.equal(g, w)
