"""bf16 K5's dq schedule (hopper::flash_bwd_wgmma<D, true> in
muvo_tpu_torch/csrc/flash_attention.cu), written out in plain PyTorch and
held against the port's plain version and muvo_tpu's fused Pallas
backward, on the CPU; then the named-barrier protocol that the kernel's
two consumer warpgroups follow, run step by step.

The schedule: one block per 128 keys (blocks wholly past seq_len do
nothing), 64-row q tiles; consumer c holds keys 64 c .. 64 c + 63 and
writes its half of the tile's dS^T = p (dP - delta), rounded to bf16, into
buffer t % 2; consumer t % 2 owns tile t's dq and computes it alone over
all 128 keys of the block, dS k in fp32, added to an fp32 workspace; at
the end dq = workspace * 1/sqrt(d) cast to bf16. The card's own walk is
proved only by the card tests (tests/test_torch_cuda.py, marker cuda);
here its arithmetic and its ownership are.

Tolerance: 2e-2 norm-relative (|got - want| / |want|, Frobenius norms),
the bf16 tolerance of tests/test_torch_flash.py: both sides round q^, dS
and dq to bf16, and muvo_tpu rounds p relative to its blocks' running
maximum. test_checks_fail_on_a_wrong_schedule shows that the comparison
fails for an owner that sums only its own key half, and for one that
reads the other half of a stale buffer.

The protocol (kDsFull + b, kDsFree + b, barriers of 256 threads): the
non-owner of tile t, b = t % 2, waits on kDsFree + b before writing buffer
b (from t = 2 on) and arrives on kDsFull + b after writing; the owner
writes its half, waits on kDsFull + b, reads the buffer in its dq
product, and arrives on kDsFree + b once the product is done if tile
t + 2 exists. A consumer starts tile t only when both have released tile
t - 2's ring stage (two stages). test_barrier_protocol runs it at every
tile count up to 9 under random interleavings and asserts no deadlock, no
arrival left over at the end, every product reading both halves of its
own tile, and no write into a buffer a product still reads.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.ops import flash_attention as jfa
from muvo_tpu_torch.ops import flash_attention as fa

TOL = 2e-2
BLOCK_KEYS, TILE_ROWS = 128, 64
# (bh, n, d, seq_len): tests/test_torch_flash.py's SHAPES, then the edges
# of the owner schedule: a single q tile (consumer 1 owns none), a block
# whose second key half lies wholly past seq_len, and an odd tile count
# with every key live (consumer 0 owns one tile more)
SHAPES = {"n300_d48": (2, 300, 48, None), "n640_d32_seq600": (2, 640, 32, 600),
          "n129_d48": (2, 129, 48, None), "n200_d64_seq128": (2, 200, 64, 128),
          "n257_d32_seq129": (2, 257, 32, 129),
          "n64_d48_one_tile": (2, 64, 48, None),
          "n200_d64_seq60_masked_half": (2, 200, 64, 60),
          "n257_d48_odd_tiles": (2, 257, 48, None)}


def owner_schedule_dq(q, k, v, o, lse, do, seq_len=None, fault=None):
    """dq of bf16 K5 as its kernel schedules it. Returns (dq in q's type,
    {(block, tile): owner}). ``fault`` breaks the schedule for
    test_checks_fail_on_a_wrong_schedule: "own_half_only" (the owner
    multiplies only its own 64 keys), "stale_half" (the other half read
    from the buffer's previous tile)."""
    bh, n, d = q.shape
    seq_len = n if seq_len is None else seq_len
    q_hat = fa.scaled_q(q).float()
    kf, vf, dof = k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1)
    work = torch.zeros((bh, n, d), dtype=torch.float32)
    owners = {}
    tiles = -(-n // TILE_ROWS)
    for block, k0 in enumerate(range(0, seq_len, BLOCK_KEYS)):
        buffers = [None, None]  # [buffer][consumer]: its half of dS^T
        for t in range(tiles):
            rows = slice(t * TILE_ROWS, min((t + 1) * TILE_ROWS, n))
            b = owner = t % 2
            previous = buffers[b]
            buffers[b] = [None, None]
            for c in (0, 1):
                lo = min(k0 + 64 * c, n)
                hi = min(lo + 64, n)
                s = kf[:, lo:hi] @ q_hat[:, rows].mT  # S^T: (bh, keys, rows)
                p = torch.exp(s - lse[:, None, rows])
                live = (torch.arange(lo, hi) < seq_len)[None, :, None]
                p = torch.where(live, p, torch.zeros(()))
                dp = vf[:, lo:hi] @ dof[:, rows].mT
                ds = p * (dp - delta[:, None, rows])
                buffers[b][c] = (lo, hi, ds.to(torch.bfloat16).float())
            halves = list(buffers[b])
            if fault == "own_half_only":
                halves = [halves[owner]]
            elif fault == "stale_half" and previous is not None:
                lo, hi, ds = previous[1 - owner]
                halves[1 - owner] = (lo, hi, ds[..., :rows.stop - rows.start])
            # the owner's product: dS (rows, keys) k (keys, d), fp32
            for lo, hi, ds in halves:
                work[:, rows] += ds.mT @ kf[:, lo:hi]
            owners[(block, t)] = owner
    dq = (work * fa.softmax_scale(d)).to(q.dtype)
    return dq, owners


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


def _port_side(shape, fault=None):
    """The schedule and the plain version on the port's plain forward's
    o and lse: (dq, owners, plain dq)."""
    x, seq_len = _inputs(shape)
    q, k, v, do = (torch.from_numpy(x[name]).to(torch.bfloat16)
                   for name in ("q", "k", "v", "do"))
    o, lse = fa.flash_fwd_plain(q, k, v, seq_len)
    dq, owners = owner_schedule_dq(q, k, v, o, lse, do, seq_len, fault)
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, seq_len)[0]
    return dq, owners, want


@pytest.mark.parametrize("shape", list(SHAPES))
def test_schedule_matches_plain(shape):
    dq, owners, want = _port_side(shape)
    assert dq.dtype == torch.bfloat16 and dq.shape == want.shape
    assert _norm_rel(_np(dq), _np(want)) <= TOL


@pytest.mark.parametrize("shape", list(SHAPES))
def test_schedule_matches_pallas_fused(shape):
    """The schedule against muvo_tpu's _flash_bwd_fused (Pallas in
    interpret mode) on the same bf16 inputs and muvo_tpu's own o, lse."""
    x, seq_len = _inputs(shape)
    bh, n, d, _ = SHAPES[shape]
    jq, jk, jv, jdo = (jnp.asarray(x[name], jnp.bfloat16)
                       for name in ("q", "k", "v", "do"))
    bq, bk = jfa._blocks(n)
    jo, jlse = jfa._flash_fwd(jq, jk, jv, bq, bk, seq_len=seq_len)
    want = jfa._flash_bwd_fused(jq, jk, jv, jo, jlse, jdo, bq, bk,
                                seq_len=seq_len)[0]
    q, k, v, do = (torch.from_numpy(x[name]).to(torch.bfloat16)
                   for name in ("q", "k", "v", "do"))
    o = torch.from_numpy(_np(jo)).to(torch.bfloat16)
    lse = torch.from_numpy(_np(jlse))
    dq, _ = owner_schedule_dq(q, k, v, o, lse, do, seq_len)
    assert _norm_rel(_np(dq), _np(want)) <= TOL


@pytest.mark.parametrize("shape", list(SHAPES))
def test_each_tile_has_one_owner_by_parity(shape):
    """Every (active block, q tile) has exactly one owner, consumer t % 2:
    consumer 0 owns ceil(tiles / 2) tiles a block, consumer 1 the rest
    (none at a single tile); blocks wholly past seq_len own nothing."""
    bh, n, d, seq_len = SHAPES[shape]
    _, owners, _ = _port_side(shape)
    tiles = -(-n // TILE_ROWS)
    blocks = -(-(seq_len or n) // BLOCK_KEYS)
    assert sorted(owners) == [(blk, t) for blk in range(blocks)
                              for t in range(tiles)]
    for blk in range(blocks):
        mine = [owners[(blk, t)] for t in range(tiles)]
        assert mine == [t % 2 for t in range(tiles)]
        assert mine.count(0) == (tiles + 1) // 2
        assert mine.count(1) == tiles // 2


@pytest.mark.parametrize("fault", ["own_half_only", "stale_half"])
def test_checks_fail_on_a_wrong_schedule(fault):
    """A dq that drops the other consumer's half, or takes it from the
    buffer's previous tile (a missing barrier), is caught."""
    dq, _, want = _port_side("n300_d48", fault=fault)
    assert _norm_rel(_np(dq), _np(want)) > TOL


# ---------------------------------------------------------------------------
# the named-barrier protocol
# ---------------------------------------------------------------------------
FULL, FREE = 5, 7  # kDsFull, kDsFree in csrc/flash_attention.cu


def consumer_ops(c, tiles, drop=None):
    """Consumer c's steps over ``tiles`` q tiles, in the kernel's order.
    ``drop`` leaves out one kind of step ("free_sync", "full_sync") to show
    that the run catches it."""
    for t in range(tiles):
        b = t % 2
        own = b == c
        yield ("ring", t)  # mbar_wait(full[t % kStages])
        if not own and t >= 2 and drop != "free_sync":
            yield ("sync", FREE + b)
        yield ("write", b, t)
        if not own:
            yield ("arrive", FULL + b)
        if own:
            if drop != "full_sync":
                yield ("sync", FULL + b)
            yield ("read", b, t)  # the dq product starts
        if own:
            yield ("read_done", b, t)  # wait<0>
        yield ("release", t)  # mbar_arrive(empty[t % kStages])
        if own and t + 2 < tiles:
            yield ("arrive", FREE + b)


def run_protocol(tiles, seed, drop=None):
    """Runs both consumers' steps under a random interleaving with
    hardware named-barrier semantics (a barrier completes when both
    consumers have arrived, releasing the one that waits). Returns a list
    of faults, empty when the run is clean."""
    rng = random.Random(seed)
    ops = [consumer_ops(c, tiles, drop) for c in (0, 1)]
    pending = [next(ops[c], None) for c in (0, 1)]
    arrived = {}            # barrier id -> consumers arrived this generation
    waiting = {}            # consumer -> barrier id it waits on
    released = [set(), set()]  # ring stages (tiles) each has released
    halves = {0: [None, None], 1: [None, None]}  # buffer -> tile per half
    reading = {}            # buffer -> tile its product still reads
    faults = []

    def arrive(c, bar):
        got = arrived.setdefault(bar, set())
        if c in got:
            faults.append(f"consumer {c} arrived twice on barrier {bar}")
        got.add(c)
        if len(got) == 2:  # complete: release every waiter
            del arrived[bar]
            for w in [w for w, x in waiting.items() if x == bar]:
                del waiting[w]

    while any(p is not None for p in pending):
        runnable = []
        for c in (0, 1):
            op = pending[c]
            if op is None or c in waiting:
                continue
            if op[0] == "ring" and op[1] >= 2 and not all(
                    op[1] - 2 in r for r in released):
                continue
            runnable.append(c)
        if not runnable:
            faults.append(f"deadlock at {pending}")
            break
        c = rng.choice(runnable)
        op = pending[c]
        kind = op[0]
        if kind == "sync":
            arrive(c, op[1])
            if op[1] in arrived and c in arrived[op[1]]:
                waiting[c] = op[1]
        elif kind == "arrive":
            arrive(c, op[1])
        elif kind == "write":
            _, b, t = op
            if b in reading:
                faults.append(f"consumer {c} wrote buffer {b} (tile {t}) "
                              f"while tile {reading[b]}'s product reads it")
            halves[b][c] = t
        elif kind == "read":
            _, b, t = op
            if halves[b] != [t, t]:
                faults.append(f"tile {t}'s product read buffer {b} holding "
                              f"tiles {halves[b]}")
            reading[b] = t
        elif kind == "read_done":
            del reading[op[1]]
        elif kind == "release":
            released[c].add(op[1])
        pending[c] = next(ops[c], None)
    if arrived:
        faults.append(f"arrivals left over at the end: {arrived}")
    return faults


@pytest.mark.parametrize("tiles", list(range(1, 10)))
def test_barrier_protocol(tiles):
    for seed in range(40):
        assert run_protocol(tiles, seed) == [], (tiles, seed)


@pytest.mark.parametrize("drop", ["free_sync", "full_sync"])
def test_barrier_protocol_catches_a_missing_wait(drop):
    assert any(run_protocol(5, seed, drop) for seed in range(40))
