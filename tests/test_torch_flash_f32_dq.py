"""fp32 K6-dq (fp32::flash_bwd_q_f32<D> in
muvo_tpu_torch/csrc/flash_attention.cu) on the CPU: the kernel's walk in
plain PyTorch, held against the port's plain version and muvo_tpu's Pallas
backward, and the kernel's host-visible constants.

The walk: one block per R q rows of one bh (R the source's kDqRows; the
last block ragged, its rows past n zero), 256 threads, the
64-key tiles in ascending order up to the last one that holds a key below
seq_len. q^ = q * 1/sqrt(d), dO, lse and delta are staged once; k^T and
v^T a tile at a time. A: thread t's R/16 q x 4 key micro-tile of S = q^ k^T
and dP = dO v^T, p = exp(S - lse) (0 at masked keys and rows past n),
ds = p (dP - delta), put into the tile's dS. C: thread t's R/16 q rows x
d/16 columns of dq += dS k over the tile's keys, carried in registers
across the tiles; dq * 1/sqrt(d) stored once. The maps below are the
kernel's (``a_tile``, ``c_tile``, ``q_item``, ``kv_item``); only the card
tests (tests/test_torch_cuda.py, marker cuda) and chip_smoke.py prove the
kernel's own walk, and there its dq must equal the plain version's bit for
bit.

1. The walk matches flash_bwd_plain's dq within 1e-5 norm-relative (the
   same fp32 arithmetic; torch rounds each product where the kernel's fmaf
   does not) at R 64 and 128, and muvo_tpu's _flash_bwd (Pallas in
   interpret mode, on muvo_tpu's own o and lse) within 1e-4 (fp32 sums in
   other orders), at d 32, 48 and 64, n 64, 127, 129 and 300, seq_len
   inside a tile and key tiles of masked keys only. A walk that leaves out
   the ragged q tail, counts the keys past seq_len or skips a key tile is
   caught.
2. The micro-tiles cover each (q row, key) of S once and each (q row,
   column) of dq once; the staging items cover each float4 of the q side
   and of a key tile once.
3. DqLayout, read from the source, fits 232,448 bytes at every d and R the
   plan can take, its regions 16-byte aligned and disjoint, and the
   plan's blocks an SM fit the SM's shared memory; a warp's float4 reads and
   stores in A and C, and the transposed stores of k^T and v^T, take no
   more shared-memory wavefronts than their bytes need (no bank conflict).
4. On CPU tensors K6-dq runs the plain version and counts no launch.
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
H100_SMEM_SM = 233472     # an SM's shared memory (228 KB), 1 KB a block reserved
ROW_CHOICES = (64, 128)   # the q rows a block the plan may take
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
BS = KEYS + _constant(r"constexpr int kBS = kBwdKeys \+ (\d+);")
SMEM_OPTIN = _constant(r"constexpr int kSmemOptin = (\d+);")
# the plan: q rows a block, blocks an SM
PLAN = tuple(int(x) for x in re.search(
    r"constexpr int kDqRows = (\d+), kDqBlocks = (\d+);", _FP32).groups())


def layout(d: int, rows: int) -> dict:
    """DqLayout<d, rows>'s members, evaluated from the source (offsets in
    floats, ``bytes``)."""
    body = re.search(r"struct DqLayout \{(.*?)\n\};", _FP32, re.S).group(1)
    env = {"D": d, "R": rows, "kBS": BS}
    out = {}
    for name, expr in re.findall(
            r"static constexpr (?:int|size_t) (\w+) = ([^;]+);", body):
        out[name] = env[name] = eval(expr.replace("sizeof(float)", "4"),
                                     {}, dict(env))
    return out


# ---------------------------------------------------------------------------
# the kernel's thread maps
# ---------------------------------------------------------------------------
def a_tile(tid, rows):
    """A: thread ``tid``'s q rows and keys of S and dP."""
    w, lane = tid >> 5, tid & 31
    ra = rows // 4 * (w >> 1) + (lane >> 3)
    kb = 32 * (w & 1) + 4 * (lane & 7)
    return [ra + 4 * i for i in range(rows // 16)], [kb + j for j in range(4)]


def c_tile(tid, rows, d):
    """C: thread ``tid``'s q rows and columns of dq."""
    kg, cg = tid >> 4, tid & 15
    return ([4 * kg + i % 4 + 64 * (i // 4) for i in range(rows // 16)],
            [cg + 16 * m for m in range(d // 16)])


def q_item(tid, j, d):
    """The (row, float4) of the block's q rows that thread ``tid`` stages
    as its ``j``-th float4 of q and of dO."""
    return divmod(tid + THREADS * j, d // 4)


def kv_item(tid, j):
    """The (key, float4) of a key tile that thread ``tid`` stages as its
    ``j``-th float4 of k and of v: a warp's 32 items are 16 keys x 2
    adjacent float4s."""
    idx = tid + THREADS * j
    lane, wi = idx & 31, idx >> 5
    return 16 * (wi & 3) + (lane & 15), 2 * (wi >> 2) + (lane >> 4)


@functools.lru_cache(maxsize=None)
def _maps(d, rows):
    """Index tensors of the maps over all threads: A's rows (t, i) and
    keys (t, j), C's rows (t, i) and columns (t, m), and the staged
    elements of the q side and of a key tile as (row, column) pairs."""
    a = [a_tile(t, rows) for t in range(THREADS)]
    c = [c_tile(t, rows, d) for t in range(THREADS)]

    def elements(items):
        r, c4 = (torch.tensor(x) for x in zip(*items))
        return (r[:, None].expand(-1, 4).reshape(-1),
                (4 * c4[:, None] + torch.arange(4)).reshape(-1))

    q_items = [q_item(t, j, d) for t in range(THREADS)
               for j in range(rows * d // 4 // THREADS)]
    kv_items = [kv_item(t, j) for t in range(THREADS)
                for j in range(KEYS * d // 4 // THREADS)]
    return (torch.tensor([r for r, _ in a]), torch.tensor([k for _, k in a]),
            torch.tensor([r for r, _ in c]), torch.tensor([m for _, m in c]),
            elements(q_items), elements(kv_items))


def _rows(x, r0, count, n):
    """Rows r0 .. r0 + count - 1 of a (n, ...) tensor, zero past n."""
    out = torch.zeros((count, *x.shape[1:]), dtype=x.dtype)
    hi = min(r0 + count, n)
    if hi > r0:
        out[:hi - r0] = x[r0:hi]
    return out


def _staged(x, r0, count, n, items):
    """A (count, d) tile of x's rows from r0 put together item by item
    from the staging map (each element once; rows past n zero)."""
    rows, cols = items
    src = _rows(x, r0, count, n)
    out = torch.full_like(src, float("nan"))
    out[rows, cols] = src[rows, cols]
    return out


def kernel_walk(q, k, v, o, lse, do, seq_len=None, rows=None, fault=None):
    """fp32 K6-dq's dq as the kernel walks it, at ``rows`` q rows a block
    (the plan's by default). ``fault`` breaks the walk for
    test_checks_fail_on_a_wrong_walk: "no_tail" (the ragged last q block
    left out), "no_mask" (keys at or past seq_len counted), "skip_tile"
    (the second key tile left out)."""
    bh, n, d = q.shape
    seq_len = n if seq_len is None else seq_len
    rows = rows or PLAN[0]
    scale = torch.tensor(fa.softmax_scale(d), dtype=torch.float32)
    delta = (do * o).sum(-1)  # the wrapper's rowsum(dO O)
    a_rows, a_keys, c_rows, c_cols, q_items, kv_items = _maps(d, rows)
    live_end = n if fault == "no_mask" else seq_len
    tiles = -(-live_end // KEYS)
    blocks = n // rows if fault == "no_tail" else -(-n // rows)
    dq = torch.zeros_like(q)
    for b in range(bh):
        for q0 in range(0, blocks * rows, rows):
            qh = _staged(q[b], q0, rows, n, q_items) * scale
            dos = _staged(do[b], q0, rows, n, q_items)
            ls, dl = _rows(lse[b], q0, rows, n), _rows(delta[b], q0, rows, n)
            row_live = (q0 + a_rows < n)[:, :, None]
            acc = torch.zeros((THREADS, rows // 16, d // 16))
            for t in range(tiles):
                if fault == "skip_tile" and t == 1:
                    continue
                k0 = t * KEYS
                ks = _staged(k[b], k0, KEYS, n, kv_items)
                vs = _staged(v[b], k0, KEYS, n, kv_items)
                # A: (thread, i, j) micro-tiles, sums over c
                s = torch.einsum("tic,tjc->tij", qh[a_rows], ks[a_keys])
                dp = torch.einsum("tic,tjc->tij", dos[a_rows], vs[a_keys])
                live = row_live & (k0 + a_keys < live_end)[:, None, :]
                p = torch.where(live, torch.exp(s - ls[a_rows][:, :, None]),
                                torch.zeros(()))
                dS = torch.full((rows, KEYS), float("nan"))
                dS[a_rows[:, :, None], a_keys[:, None, :]] = (
                    p * (dp - dl[a_rows][:, :, None]))
                # C: the tile's 64 keys into the dq registers
                acc += torch.einsum("tik,tmk->tim", dS[c_rows],
                                    ks[:, c_cols].permute(1, 2, 0))
            out_rows, cols = torch.broadcast_tensors(
                (q0 + c_rows)[:, :, None], c_cols[:, None, :])
            ok = out_rows < n
            dq[b][out_rows[ok], cols[ok]] = acc[ok] * scale
    return dq


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
    """Inputs and the plain version's dq on the port's plain forward's o
    and lse."""
    x, seq_len = _inputs(shape)
    q, k, v, do = (torch.from_numpy(x[name])
                   for name in ("q", "k", "v", "do"))
    o, lse = fa.flash_fwd_plain(q, k, v, seq_len)
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, seq_len)[0]
    return (q, k, v, o, lse, do, seq_len), want


@pytest.mark.parametrize("rows", ROW_CHOICES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_walk_matches_plain(shape, rows):
    args, want = _port_side(shape)
    got = kernel_walk(*args, rows=rows)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert _norm_rel(_np(got), _np(want)) <= PLAIN_TOL


@pytest.mark.parametrize("shape", list(SHAPES))
def test_walk_matches_pallas(shape):
    """The walk at the plan's rows against muvo_tpu's _flash_bwd (K6),
    Pallas in interpret mode, on the same fp32 inputs and muvo_tpu's own o
    and lse."""
    x, seq_len = _inputs(shape)
    n = SHAPES[shape][1]
    jq, jk, jv, jdo = (jnp.asarray(x[name], jnp.float32)
                       for name in ("q", "k", "v", "do"))
    bq, bk = jfa._blocks(n)
    jo, jlse = jfa._flash_fwd(jq, jk, jv, bq, bk, seq_len=seq_len)
    want = jfa._flash_bwd(jq, jk, jv, jo, jlse, jdo, bq, bk,
                          seq_len=seq_len)[0]
    q, k, v, do = (torch.from_numpy(x[name])
                   for name in ("q", "k", "v", "do"))
    o, lse = torch.from_numpy(_np(jo)), torch.from_numpy(_np(jlse))
    got = kernel_walk(q, k, v, o, lse, do, seq_len)
    assert _norm_rel(_np(got), _np(want)) <= PALLAS_TOL


@pytest.mark.parametrize("fault", ["no_tail", "no_mask", "skip_tile"])
def test_checks_fail_on_a_wrong_walk(fault):
    """A walk that leaves out the ragged q tail, counts the keys past
    seq_len or skips a key tile is caught by the plain comparison."""
    args, want = _port_side("n300_d48_seq200")
    got = kernel_walk(*args, fault=fault)
    assert _norm_rel(_np(got), _np(want)) > PLAIN_TOL


@pytest.mark.parametrize("rows", ROW_CHOICES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_micro_tiles_cover_once(d, rows):
    s = np.zeros((rows, KEYS), int)
    dq = np.zeros((rows, d), int)
    q_side = np.zeros((rows, d // 4), int)
    kv = np.zeros((KEYS, d // 4), int)
    for t in range(THREADS):
        a_r, a_k = a_tile(t, rows)
        s[np.ix_(a_r, a_k)] += 1
        c_r, c_c = c_tile(t, rows, d)
        dq[np.ix_(c_r, c_c)] += 1
        for j in range(rows * d // 4 // THREADS):
            q_side[q_item(t, j, d)] += 1
        for j in range(KEYS * d // 4 // THREADS):
            kv[kv_item(t, j)] += 1
    assert (s == 1).all() and (dq == 1).all()
    assert (q_side == 1).all() and (kv == 1).all()
    assert rows * (d // 4) % THREADS == 0 and KEYS * (d // 4) % THREADS == 0


@pytest.mark.parametrize("rows", ROW_CHOICES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_layout_fits_the_card(d, rows):
    lay = layout(d, rows)
    assert SMEM_OPTIN == H100_SMEM_OPTIN
    assert lay["bytes"] <= H100_SMEM_OPTIN
    qs = lay["QS"]
    regions = [("kt", 2 * d * BS), ("vt", 2 * d * BS), ("q", rows * qs),
               ("dout", rows * qs), ("lse", rows), ("delta", rows),
               ("ds", rows * BS)]
    at = 0
    for name, size in regions:  # in order, disjoint, 16-byte aligned
        assert lay[name] == at and at % 4 == 0, name
        at += size
    assert lay["bytes"] == 4 * at
    assert qs % 4 == 0 and BS % 4 == 0  # float4 rows
    # the plan: a row count the maps take, and its blocks an SM fit
    plan_rows, blocks = PLAN
    assert plan_rows in ROW_CHOICES and blocks in (1, 2)
    assert blocks * (layout(d, plan_rows)["bytes"] + 1024) <= H100_SMEM_SM


def _wavefronts(words):
    """Shared-memory wavefronts of one warp access: the most distinct
    4-byte words that fall in one of the 32 banks."""
    per_bank = {}
    for w in set(words):
        per_bank.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in per_bank.values())


def _float4s(starts):
    return [s + e for s in starts for e in range(4)]


@pytest.mark.parametrize("rows", ROW_CHOICES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_shared_accesses_have_no_bank_conflict(d, rows):
    """Each warp's float4 reads and stores in A and C, and its transposed
    stores of k^T and v^T, take ceil(distinct bytes / 128) wavefronts, the
    least they can."""
    qs = layout(d, rows)["QS"]
    for w in range(THREADS // 32):
        tids = range(32 * w, 32 * w + 32)
        accesses = []
        for i in range(rows // 16):  # A: q^ / dO rows; dS stores
            accesses.append(_float4s([a_tile(t, rows)[0][i] * qs + 4
                                      for t in tids]))
            accesses.append(_float4s([a_tile(t, rows)[0][i] * BS
                                      + a_tile(t, rows)[1][0] for t in tids]))
        accesses.append(_float4s([3 * BS + a_tile(t, rows)[1][0]
                                  for t in tids]))  # A: k^T / v^T rows
        for i in range(rows // 16):  # C: dS rows
            accesses.append(_float4s([c_tile(t, rows, d)[0][i] * BS + 8
                                      for t in tids]))
        for m in range(d // 16):  # C: k^T rows
            accesses.append(_float4s([c_tile(t, rows, d)[1][m] * BS + 8
                                      for t in tids]))
        for j in range(KEYS * d // 4 // THREADS):  # k^T, v^T stores
            for e in range(4):
                accesses.append([(4 * kv_item(t, j)[1] + e) * BS
                                 + kv_item(t, j)[0] for t in tids])
        for words in accesses:
            assert _wavefronts(words) == math.ceil(len(set(words)) / 32)


def test_kernel_name_is_the_source_kernel():
    for d in fa.HEAD_DIMS:
        name = fa.kernel_name("K6-dq", torch.float32, d)
        assert name == f"fp32::flash_bwd_q_f32<{d}>"
    assert "void __launch_bounds__(kThreads, kDqBlocks)\n" \
           "    flash_bwd_q_f32(" in _FP32
    # the first design is gone (muvo_tpu's _flash_bwd_dq_kernel is named)
    assert not re.search(r"(?<!_)flash_bwd_dq_kernel", _SOURCE)


def test_cpu_tensors_run_the_plain_version():
    (q, k, v, o, lse, do, seq_len), want = _port_side("n127_d32")
    launches = dict(fa.flash_bwd_dq.launches_by_type), fa.flash_bwd_dq.launches
    fa.flash_bwd_dq.last_impl = None
    got = fa.flash_bwd_dq(q, k, v, o, lse, do, seq_len)
    assert fa.flash_bwd_dq.last_impl == "plain"
    assert (dict(fa.flash_bwd_dq.launches_by_type),
            fa.flash_bwd_dq.launches) == launches
    assert torch.equal(got, want)
