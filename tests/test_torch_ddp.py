"""The port's data-parallel training (muvo_tpu_torch/parallel/) on the CPU:
two gloo ranks, each a process of its own (tests/torch_ddp_worker.py, no
JAX), against one process at the global batch and against muvo_tpu's step
on a 2-device mesh.

tiny_test_cfg in fp32 with the voxel decoder, the LiDAR and depth label
branches on and narrow decoders (torch_ddp_worker.ddp_cfg), no
augmentation, dropout or sampling noise. Tolerances and why:
- 2 ranks against 1 process: the losses, every loss term, every parameter
  and every BatchNorm running statistic after the step, norm-relative
  within 1e-5 (TOL). These steps run in float64 (torch_ddp_worker.in_float64;
  the losses still upcast to fp32 where they say so): at this size a
  relative 1e-7 change of the parameters moves some fp32 gradient leaves
  by 1e-2 (the range view's layer4 BatchNorms over 32 values a channel,
  the voxel decoder's AdaIN), and AdamW's first update is nearly the
  gradient's sign, so in fp32 a component whose gradient is rounding
  noise moves a parameter by twice the learning rate either way. The
  one-dimensional parameters start spread around their neutral values
  (torch_ddp_worker.trainer_for), so that no leaf is only its update.
- the BatchNorm modules: outputs, input and parameter gradients and
  running statistics within 1e-5, in fp32.
- 2 ranks against muvo_tpu's 2-device mesh step: the rule of
  tests/test_torch_train_step.py (each loss term 1e-4 relative; each
  gradient leaf 2e-3 norm-relative plus 8x muvo_tpu's own one-ulp noise).
- a resumed 2-rank run against an uninterrupted one, and the two ranks
  against each other: bit for bit.
- 2-rank evaluation metrics against 1 process's: 1e-5 relative.
"""

import json
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_worker as W
from muvo_tpu.parallel.mesh import make_mesh, replicated, shard_batch
from muvo_tpu.training.trainer import WorldModelTrainer as JaxTrainer
from muvo_tpu_torch.data.synthetic import synthetic_batch
from muvo_tpu_torch.weights import state_dict_from_jax
from torch_port_common import (deterministic_jax, fp32_cfgs,
                               import_torch_dynamo, jax_trainer_and_state,
                               port_model, tiny_argv, write_recorded_run)

import_torch_dynamo()  # the one-process references step torch.optim

TOL = 1e-5
LOSS_TOL = 1e-4
NORM_TOL = 2e-3
NOISE_FACTOR = 8.0
ULP = 1e-7
RANK_TIMEOUT = 900.0  # seconds each rank process may take
STEPS, SAVE_AT = 4, 3  # the 2-rank train.main run, and its resume point
MASKED = {"masked_half": True}
ACCUMULATE = {"cfg_items": [("OPTIMIZER.ACCUMULATE_GRAD_BATCHES", 2)],
              "seeds": (1, 2)}


def _norm_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    num, den = np.linalg.norm(got - want), np.linalg.norm(want)
    if den == 0.0:
        return 0.0 if num == 0.0 else np.inf
    return num / den


def _threads():
    return max(1, torch.get_num_threads() // 2)


def _argv(drive, log_dir, **extra):
    return tiny_argv(**{"DATASET.DATAROOT": str(drive),
                        "DATASET.FILTER_BEGINNING_OF_RUN_SEC": 0.0,
                        "LOG_DIR": str(log_dir), "BATCHSIZE": 2,
                        "LOGGING_INTERVAL": 1, "PRECISION": "32",
                        "OPTIMIZER.ACCUMULATE_GRAD_BATCHES": 2,
                        "PREDICTION.N_SAMPLES": 1, **extra})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every 2-rank case in one pair of processes, and the paths they
    wrote (about 3 GB of checkpoints and states, removed afterwards)."""
    root = tmp_path_factory.mktemp("ddp")
    drive = root / "drive"
    write_recorded_run(drive / "trainval" / "train" / "Town01" / "0000", 10,
                       seed=4)
    first, second = root / "first", root / "second"
    paths = {"drive": drive, "first": first, "second": second,
             "masked": root / "masked.pt", "accumulate": root / "acc.pt"}
    cases = [
        ("batch_norm", {}),
        ("steps", {**MASKED, "save": str(paths["masked"])}),
        ("steps", {**ACCUMULATE, "save": str(paths["accumulate"])}),
        ("train_main", {"argv": _argv(drive, first, STEPS=STEPS,
                                      VAL_CHECK_INTERVAL=SAVE_AT)}),
        ("train_main", {"argv": _argv(drive, second, STEPS=STEPS,
                                      VAL_CHECK_INTERVAL=SAVE_AT),
                        "resume_from": (str(first), SAVE_AT)}),
        ("prediction", {"argv": _argv(drive, root / "eval"),
                        "log_root": str(first)}),
    ]
    results = W.run_ranks(cases, root / "ranks", timeout=RANK_TIMEOUT,
                          threads=_threads())
    names = ("batch_norm", "masked", "accumulate", "first", "resumed",
             "prediction")
    yield paths, [dict(zip(names, r)) for r in results]
    shutil.rmtree(root, ignore_errors=True)


def test_batch_norm_statistics_are_the_global_batchs(runs):
    """BatchNorm2d and MaskedBatchNorm1d (15 valid points on rank 0, 5 on
    rank 1) on two ranks equal one process on the whole batch: outputs,
    the inputs' gradients (the backward sums the ranks' shares of the
    statistics' gradients), the parameters' gradients, the running
    statistics; BatchNorm2d's recompute under frozen statistics (a
    rematerialised decoder's) gives the same output and leaves the running
    statistics alone."""
    _, ranks = runs
    want = W.case_batch_norm()
    for name in ("bn2d", "bn1d"):
        got = [r["batch_norm"][name] for r in ranks]
        one = want[name]
        assert set(got[0]) == set(one)
        for key in {"y", "x_grad", "y_frozen"} & set(one):
            both = torch.cat([g[key] for g in got])
            assert _norm_rel(both, one[key]) <= TOL, (name, key)
        for key in ("weight_grad", "bias_grad"):
            # the ranks' mean of the gradient of their sums: 1/2 the sum's
            assert torch.equal(got[0][key], got[1][key]), (name, key)
            assert _norm_rel(2 * got[0][key], one[key]) <= TOL, (name, key)
        for key in {"running", "running_after_frozen"} & set(one):
            for g, w in zip(got[0][key], one[key]):
                assert _norm_rel(g, w) <= TOL, (name, key)
    for g, w in zip(ranks[0]["batch_norm"]["bn2d"]["running_after_frozen"],
                    ranks[0]["batch_norm"]["bn2d"]["running"]):
        assert torch.equal(g, w)


def _assert_step_matches(ranks, case, saved, kwargs):
    """Every rank's losses and the model after the steps against one
    process's on the same seeded global batches."""
    one = W.case_steps(**kwargs, save=str(saved) + ".one")
    assert ranks[0][case]["hash"] == ranks[1][case]["hash"]
    assert ranks[0][case]["updates"] == one["updates"] == 1
    for r in ranks:
        for got, want in zip(r[case]["metrics"], one["metrics"]):
            assert set(got) == set(want)
            for key, w in want.items():
                assert abs(got[key] - w) <= TOL * max(abs(w), 1e-6), (
                    case, key, got[key], w)
    got, want = torch.load(saved), torch.load(str(saved) + ".one")
    for path in (saved, str(saved) + ".one"):
        os.remove(path)
    assert set(got) == set(want)
    rel = {k: _norm_rel(got[k], w) for k, w in want.items()
           if w.is_floating_point()}
    worst = max(rel, key=rel.get)
    print(f"{case}: {len(rel)} parameters and statistics, worst "
          f"{rel[worst]:.3e} ({worst})")
    assert rel[worst] <= TOL, (worst, rel[worst])
    assert any(".running_var" in k for k in rel)
    return one


def test_two_rank_step_equals_one_process_at_the_global_batch(runs):
    """One step on a batch whose halves hold different numbers of valid
    depth pixels (every pixel of the second half at 255): the masked
    depth term is a ratio of global sums. The mean of the per-rank
    losses, what each rank would log with local ratios, misses the
    global loss."""
    paths, ranks = runs
    one = _assert_step_matches(ranks, "masked", paths["masked"], MASKED)
    cfg = W.ddp_cfg()
    batch = W.global_batch(cfg, 2, 1, masked_half=True)
    per_rank = []
    for half in range(2):
        trainer = W.trainer_for(cfg)
        rows = {k: v[half:half + 1] for k, v in batch.items()}
        metrics, _ = trainer.grads(rows, stochastic=False)
        per_rank.append({k: v.item() for k, v in metrics.items()})
    for key in ("depth_1", "loss"):
        want = one["metrics"][0][key]
        local_mean = (per_rank[0][key] + per_rank[1][key]) / 2
        assert abs(local_mean - want) > 10 * TOL * abs(want), (key,
                                                               local_mean,
                                                               want)


def test_accumulation_over_two_micro_steps(runs):
    """ACCUMULATE_GRAD_BATCHES 2: each rank accumulates its own gradients
    and the applying micro-step averages them over the ranks."""
    paths, ranks = runs
    _assert_step_matches(ranks, "accumulate", paths["accumulate"],
                         ACCUMULATE)


def test_rank_zero_alone_writes_and_records_the_world_size(runs):
    paths, ranks = runs
    first = [r["first"] for r in ranks]
    assert [f["step"] for f in first] == [STEPS, STEPS]
    assert first[0]["writes"] == [SAVE_AT, STEPS] and first[1]["writes"] == []
    assert first[0]["log_dir"] == first[1]["log_dir"]
    ckpts = W.run_checkpoints(paths["first"])
    assert sorted(p.name for p in ckpts.iterdir()) == sorted(
        f"{kind}_{s}.{ext}" for s in (SAVE_AT, STEPS)
        for kind, ext in (("ckpt", "pt"), ("meta", "json")))
    with open(ckpts / f"meta_{STEPS}.json") as f:
        assert json.load(f)["metadata"]["world_size"] == 2
    with open(f"{first[0]['log_dir']}/metrics.jsonl") as f:
        steps = [r["step"] for r in map(json.loads, f) if "train_loss" in r]
    assert steps == list(range(1, STEPS + 1))  # one writer, every step


def test_resumed_two_rank_run_ends_bit_equal(runs):
    """The ranks end bit-equal to each other, and a run resumed from step
    3 (between two updates: the accumulated gradients are averaged over
    the ranks when saved) ends bit-equal to the uninterrupted one."""
    _, ranks = runs
    for key in ("hash", "acc_hash", "updates"):
        values = {r[run][key] for r in ranks for run in ("first", "resumed")}
        assert len(values) == 1, key
    assert ranks[0]["resumed"]["start"] == SAVE_AT
    assert ranks[0]["first"]["updates"] == STEPS // 2


def test_two_rank_prediction_equals_one_process(runs):
    paths, ranks = runs
    want = W.case_prediction(_argv(paths["drive"], paths["drive"] / "eval"),
                             str(paths["first"]))
    assert ranks[0]["prediction"] == ranks[1]["prediction"]
    got = ranks[0]["prediction"]
    assert set(got) == set(want)
    for part, scores in want.items():
        assert set(got[part]) == set(scores)
        for key, w in scores.items():
            assert math.isfinite(w), (part, key)
            assert abs(got[part][key] - w) <= TOL * max(abs(w), 1e-6), (
                part, key, got[part][key], w)


# ---------------------------------------------------------------------------
# against muvo_tpu's step on a 2-device mesh

def _small_cfgs():
    """muvo_tpu's and the port's tiny_test_cfg in fp32 without dropout,
    with the LiDAR and depth label branches and narrow decoders
    (torch_ddp_worker.ddp_cfg's)."""
    jcfg, pcfg = fp32_cfgs()
    for cfg in (jcfg, pcfg):
        cfg.LIDAR_SEG.ENABLED = True
        cfg.DEPTH.ENABLED = True
        cfg.MODEL.DECODER_BASE_CHANNELS = 64
    return jcfg, pcfg


def _float64(tree):
    return jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.float64), tree)


def test_two_rank_step_matches_muvo_tpus_two_device_mesh(tmp_path):
    """Both sides in float64 (muvo_tpu under jax.enable_x64, the port's
    ranks in torch_ddp_worker.in_float64): in fp32 at this size
    muvo_tpu's own 1-device and 2-device steps differ by up to 4.5e-2
    norm-relative on a gradient leaf (encoder.layer4.1.conv1.weight), the
    rounding of the batch's split amplified by BatchNorms over 32 values a
    channel, far above the one-ulp noise the rule adds."""
    mp = pytest.MonkeyPatch()
    try:
        deterministic_jax(mp)
        jcfg, pcfg = _small_cfgs()
        batch = synthetic_batch(pcfg, 2, 2, seed=3)
        _, state = jax_trainer_and_state(jcfg, batch)
        mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
        trainer = JaxTrainer(jcfg, mesh=mesh)
        with jax.enable_x64(True):
            trainer.compute_dtype = jnp.float64
            grad_fn = trainer._with_mesh(jax.jit(jax.value_and_grad(
                lambda p, s, b: trainer._loss_fn(
                    p, s, b, jax.random.PRNGKey(0), True), has_aux=True)))
            sharded = shard_batch(
                {k: jnp.asarray(v) for k, v in batch.items()}, mesh)
            stats = jax.device_put(_float64(state.batch_stats),
                                   replicated(mesh))
            (total, (losses, _)), grads = grad_fn(
                jax.device_put(_float64(state.params), replicated(mesh)),
                stats, sharded)
            want = state_dict_from_jax(jax.device_get(grads), None, pcfg)
            rs = np.random.RandomState(7)
            noise = {k: 0.0 for k in want}
            for _ in range(2):
                moved = jax.tree_util.tree_map(
                    lambda p: np.asarray(p, np.float64) * (
                        1.0 + ULP * rs.standard_normal(np.shape(p))),
                    state.params)
                other = state_dict_from_jax(jax.device_get(grad_fn(
                    jax.device_put(moved, replicated(mesh)), stats,
                    sharded)[1]), None, pcfg)
                for k, w in want.items():
                    noise[k] = max(noise[k], _norm_rel(other[k], w))
            want_losses = {"loss": float(total),
                           **{k: float(v) for k, v in losses.items()}}
    finally:
        mp.undo()
    weights = tmp_path / "weights.pt"
    torch.save(port_model(state, pcfg).state_dict(), weights)
    saved = tmp_path / "grads.pt"
    try:
        ranks = W.run_ranks(
            [("grads", {"weights": str(weights), "save": str(saved)})],
            tmp_path / "ranks", timeout=RANK_TIMEOUT, threads=_threads())
        got = torch.load(saved)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
    got_losses = ranks[0][0]
    assert ranks[1][0] == got_losses
    assert set(got_losses) == set(want_losses)
    for key, w in want_losses.items():
        assert abs(got_losses[key] - w) <= LOSS_TOL * max(abs(w), 1e-6), (
            key, got_losses[key], w)
    assert set(got) == set(want)
    rel = {k: _norm_rel(got[k].detach(), w) for k, w in want.items()}
    bad = {k: (rel[k], noise[k]) for k in rel
           if not rel[k] <= NORM_TOL + NOISE_FACTOR * noise[k]}
    print(f"gradient leaves {len(rel)}: norm-relative median "
          f"{np.median(list(rel.values())):.3e}, worst "
          f"{max(rel.values()):.3e}; noise median "
          f"{np.median(list(noise.values())):.3e}")
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1][0])[:5]
