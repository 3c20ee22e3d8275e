"""``muvo_tpu_torch.train`` and the slice as a whole against muvo_tpu, on
the CPU.

A recording (tests/torch_port_common.py:write_recorded_run) at
tiny_test_cfg's sizes: a training run of 10 frames (4 sequences of 3
frames at stride 2) and a val0 run of 8.
- One recorded batch through each package's loader (the same bits) and
  trainer: muvo_tpu's fp32 loss and gradients, deterministic and with its
  voxel kernels in Pallas interpret mode, against the port's
  ``grads(stochastic=False)`` at the same weights, within the limits of
  tests/test_torch_train_step.py: the loss 1e-4 relative; each gradient
  leaf 2e-3 norm-relative plus 8x its noise, the larger of that file's
  two estimates (muvo_tpu's change under a one-ulp change of the
  parameters; the port's fp32 step against its float64 step). On this
  drive's batch the port's own fp32 rounding is the larger one where a
  BatchNorm bias sums few values that cancel: range_view_encoder's
  layer4.0 bn2 bias rounds by 1.9e-2 (fp32 against float64, in the port
  alone), and the two packages' fp32 gradients differ there by 2.0e-2.
- Resume: ``main(device="cpu")`` with ACCUMULATE_GRAD_BATCHES 2, 5 steps
  in one run against a resume to 5 from that run's checkpoint of step 3,
  saved at its validation as a run stopped there saves it (the checkpoint
  holds one update's AdamW moments and a gradient waiting for the next;
  the resume crosses an epoch and ends between two updates): every
  parameter, buffer, AdamW moment and accumulated gradient bit-equal, the
  same logged losses.
- Checkpoints: a port checkpoint read by muvo_tpu's
  ``load_reference_weights`` and carried back by ``state_dict_from_jax``
  is the port's state_dict; an upstream-style ``model.``-prefixed ``.ckpt``
  loads through PRETRAINED.PATH.
The checkpoints of tiny_test_cfg are 0.4-1.5 GB (95.5M parameters, the
AdamW moments, the accumulated gradients), so each test removes its runs.
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

from muvo_tpu.data.dataset import CarlaDataset as JaxCarlaDataset
from muvo_tpu.data.loader import DataLoader as JaxDataLoader
from muvo_tpu.training.weight_convert import load_reference_weights
from muvo_tpu_torch.data.dataset import CarlaDataset
from muvo_tpu_torch.data.loader import DataLoader
from muvo_tpu_torch.data.synthetic import tiny_test_cfg
from muvo_tpu_torch.models.world_model import MuvoWorldModel
from muvo_tpu_torch.train import main
from muvo_tpu_torch.training.checkpoint import CheckpointManager
from muvo_tpu_torch.training.trainer import WorldModelTrainer
from muvo_tpu_torch.weights import state_dict_from_jax
from test_torch_train_step import (LOSS_TOL, NOISE_DRAWS, NOISE_FACTOR,
                                   NORM_TOL, ULP, _grad_ok, _norm_rel)
from torch_port_common import (deterministic_jax, float64_step, fp32_cfgs,
                               import_torch_dynamo, jax_trainer_and_state,
                               port_model, tiny_argv, write_recorded_run)

import_torch_dynamo()  # the train loop steps torch.optim's AdamW

SEQ = 3  # tiny_test_cfg: RECEPTIVE_FIELD 2 + FUTURE_HORIZON 1


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    root = tmp_path_factory.mktemp("drives")
    write_recorded_run(root / "trainval" / "train" / "Town01" / "0000", 10,
                       seed=4)
    write_recorded_run(root / "trainval" / "val0" / "Town01" / "0000", 8,
                       seed=5)
    return str(root)


@pytest.fixture(scope="module")
def slice_pair(recording):
    """The first recorded batch of each package's loader, and one training
    step's losses and gradients on each side at muvo_tpu's seeded weights.
    muvo_tpu's step is compiled once and run 1 + NOISE_DRAWS times."""
    mp = pytest.MonkeyPatch()
    try:
        deterministic_jax(mp)
        jcfg, pcfg = fp32_cfgs()
        for cfg in (jcfg, pcfg):
            cfg.DATASET.FILTER_BEGINNING_OF_RUN_SEC = 0.0
        batch = next(iter(DataLoader(
            CarlaDataset(pcfg, "train", SEQ, dataset_root=recording), 2,
            shuffle=False)))
        jax_batch = next(iter(JaxDataLoader(
            JaxCarlaDataset(jcfg, "train", SEQ, dataset_root=recording), 2,
            shuffle=False)))
        trainer, state = jax_trainer_and_state(jcfg, jax_batch)
        jbatch = {k: jnp.asarray(v) for k, v in jax_batch.items()}
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, s, b: trainer._loss_fn(p, s, b, jax.random.PRNGKey(0),
                                             True), has_aux=True))
        (total, (losses, _)), grads = grad_fn(state.params,
                                              state.batch_stats, jbatch)
        want_grads = state_dict_from_jax(jax.device_get(grads), None, pcfg)
        want = {"loss": float(total),
                **{k: float(v) for k, v in losses.items()}}
        rs = np.random.RandomState(7)
        noise = {k: 0.0 for k in want_grads}
        loss_noise = {k: 0.0 for k in want}
        for _ in range(NOISE_DRAWS):
            moved = jax.tree_util.tree_map(
                lambda p: (np.asarray(p) * (1.0 + ULP * rs.standard_normal(
                    np.shape(p)))).astype(np.float32), state.params)
            (m_total, (m_losses, _)), m_grads = grad_fn(
                moved, state.batch_stats, jbatch)
            other = state_dict_from_jax(jax.device_get(m_grads), None, pcfg)
            for k, w in want_grads.items():
                noise[k] = max(noise[k], _norm_rel(other[k], w))
            for k, v in {"loss": m_total, **m_losses}.items():
                loss_noise[k] = max(loss_noise[k], abs(float(v) - want[k])
                                    / max(abs(want[k]), 1e-6))
    finally:
        mp.undo()
    port = WorldModelTrainer(pcfg, device="cpu")
    port.init_state(model=port_model(state, pcfg))
    exact_losses, exact_grads = float64_step(port, batch)
    metrics, got_grads = port.grads(batch, stochastic=False)
    got = {k: v.item() for k, v in metrics.items()}
    got_grads = {k: g.detach().clone() for k, g in got_grads.items()}
    # each leaf's noise: the larger of muvo_tpu's one-ulp noise and the
    # port's own fp32 rounding (its fp32 step against its float64 step),
    # the two estimates of tests/test_torch_train_step.py
    rounding = {k: _norm_rel(g, exact_grads[k]) for k, g in got_grads.items()}
    loss_rounding = {k: abs(v - exact_losses[k]) / max(abs(exact_losses[k]),
                                                       1e-6)
                     for k, v in got.items()}
    return {"batch": batch, "jax_batch": jax_batch, "state": state,
            "cfgs": (jcfg, pcfg), "want": want, "got": got,
            "loss_noise": {k: max(loss_noise[k], loss_rounding[k])
                           for k in want},
            "want_grads": want_grads, "got_grads": got_grads,
            "noise": {k: max(noise[k], rounding[k]) for k in want_grads},
            "jax_noise": noise, "rounding": rounding}


def test_recorded_batch_is_the_same_in_both_loaders(slice_pair):
    got, want = slice_pair["batch"], slice_pair["jax_batch"]
    assert set(got) == set(want)
    assert got["image"].shape == (2, SEQ, 96, 160, 3)
    assert got["voxel"].shape == (2, SEQ, 64, 64, 64)
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_recorded_batch_losses_match(slice_pair):
    """The loss within 1e-4 relative; each term within 1e-4 plus
    NOISE_FACTOR x its noise (muvo_tpu's one-ulp change, or the port's
    fp32 rounding, the larger): sem_scal_2's ratios of sums over this
    drive's few occupied voxels move by 6e-5 under a one-ulp change of the
    parameters."""
    got, want = slice_pair["got"], slice_pair["want"]
    noise = slice_pair["loss_noise"]
    assert set(got) == set(want)
    rel = {k: abs(got[k] - w) / max(abs(w), 1e-6) for k, w in want.items()}
    print({k: (f"{rel[k]:.2e}", f"{noise[k]:.2e}") for k in want})
    assert rel["loss"] <= LOSS_TOL, (got["loss"], want["loss"])
    bad = {k: (rel[k], noise[k]) for k in want
           if not rel[k] <= LOSS_TOL + NOISE_FACTOR * noise[k]}
    assert not bad, bad


def test_recorded_batch_gradients_match(slice_pair):
    got, want = slice_pair["got_grads"], slice_pair["want_grads"]
    noise = slice_pair["noise"]
    assert set(got) == set(want)  # no leaf uncompared
    bad = {k: (_norm_rel(got[k], w), noise[k]) for k, w in want.items()
           if not _grad_ok(got[k], w, noise[k])}
    rel = {k: _norm_rel(got[k], w) for k, w in want.items()}
    print(f"gradient leaves {len(rel)}: norm-relative median "
          f"{np.median(list(rel.values())):.3e}, worst "
          f"{max(rel.values()):.3e} ({max(rel, key=rel.get)}), "
          f"{sum(r > NORM_TOL for r in rel.values())} above {NORM_TOL}; "
          f"muvo_tpu's one-ulp noise median "
          f"{np.median(list(slice_pair['jax_noise'].values())):.3e}, the "
          f"port's fp32 rounding median "
          f"{np.median(list(slice_pair['rounding'].values())):.3e}")
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1][0])[:5]


def _argv(recording, log_dir, steps, **extra):
    """The command line of a tiny_test_cfg run on ``recording``."""
    return tiny_argv(**{"DATASET.DATAROOT": recording,
                        "DATASET.FILTER_BEGINNING_OF_RUN_SEC": 0.0,
                        "LOG_DIR": log_dir, "STEPS": steps,
                        "LOGGING_INTERVAL": 1, "VAL_CHECK_INTERVAL": 3,
                        "LIMIT_VAL_BATCHES": 1,
                        "OPTIMIZER.ACCUMULATE_GRAD_BATCHES": 2, **extra})


def _records(log_dir):
    with open(f"{log_dir}/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _optimizer_state(trainer):
    """AdamW's moments and step counts, and the accumulated gradients, by
    parameter name."""
    opt = trainer.state.optimizer
    names = {p: n for n, p in trainer.state.model.named_parameters()}
    adamw = {f"{names[p]}.{k}": v for p, s in opt.adamw.state.items()
             for k, v in s.items()}
    acc = {names[p]: t for p, t in opt.acc.items()}
    return adamw, acc, (opt.mini_step, opt.updates, trainer.state.step)


def test_resumed_run_ends_bit_equal_to_an_uninterrupted_one(
        recording, slice_pair, tmp_path):
    try:
        whole = main(_argv(recording, str(tmp_path / "whole"), 5),
                     device="cpu")
        # the whole run saved at its validation at step 3, as a run that
        # stopped there would have: the resume starts from that checkpoint
        saved = CheckpointManager(f"{whole.log_dir}/checkpoints")
        assert saved.steps() == [3, 5]
        stopped = tmp_path / "stopped"
        stopped.mkdir()
        for name in ("ckpt_3.pt", "meta_3.json"):
            os.link(f"{saved.directory}/{name}", stopped / name)
        # the resumed run ends on a validation step, which saves once:
        # the end of the run does not save that step again (validation
        # leaves the trained state as it was)
        resumed = main(_argv(recording, str(tmp_path / "resumed"), 5,
                             **{"PRETRAINED.PATH": str(stopped),
                                "VAL_CHECK_INTERVAL": 5}),
                       device="cpu")
        resumed_saves = CheckpointManager(
            f"{resumed.log_dir}/checkpoints").steps()
        whole_records = _records(whole.log_dir)
        resumed_records = _records(resumed.log_dir)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
    assert (whole.start_step, whole.step) == (0, 5)
    assert (resumed.start_step, resumed.step) == (3, 5)
    assert resumed_saves == [5]
    # 4 sequences an epoch: the resume goes on with epoch 0's last batch
    # and epoch 1's first; the updates fall at steps 2 and 4, and one
    # gradient waits at step 5
    adamw, acc, counts = _optimizer_state(whole.trainer)
    got_adamw, got_acc, got_counts = _optimizer_state(resumed.trainer)
    assert counts == got_counts == (1, 2, 5)
    assert set(adamw) == set(got_adamw) and len(adamw) > 0
    assert set(acc) == set(got_acc) and len(acc) > 0
    for name, v in (*adamw.items(), *acc.items()):
        got = got_adamw.get(name, got_acc.get(name))
        assert torch.equal(got, v), name
    want_sd = whole.trainer.state.model.state_dict()
    got_sd = resumed.trainer.state.model.state_dict()
    assert set(got_sd) == set(want_sd)
    for name, v in want_sd.items():
        assert torch.equal(got_sd[name], v), name

    loss_keys = {"train_" + k for k in slice_pair["want"]}
    train = [r for r in whole_records if "train_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4, 5]
    for record in train:
        assert set(record) == loss_keys | {"step", "train_fps_per_chip",
                                           "train_lr"}
        assert all(math.isfinite(v) for v in record.values())
    resumed_train = [r for r in resumed_records if "train_loss" in r]
    assert [r["step"] for r in resumed_train] == [4, 5]
    for record, want in zip(resumed_train, train[3:]):
        assert {k: record[k] for k in loss_keys} == {
            k: want[k] for k in loss_keys}
    val = [[r for r in records if any(k.startswith("val0_") for k in r)]
           for records in (whole_records, resumed_records)]
    assert [[r["step"] for r in v] for v in val] == [[3], [5]]
    assert all(math.isfinite(v) for rs in val for r in rs for v in r.values())


def test_port_checkpoint_loads_into_muvo_tpu_and_back(slice_pair, tmp_path):
    """The port's checkpoint read by muvo_tpu's load_reference_weights and
    carried back by state_dict_from_jax is the port's state_dict."""
    jcfg, pcfg = slice_pair["cfgs"]
    state = slice_pair["state"]
    port = WorldModelTrainer(pcfg, device="cpu")
    port.init_state(seed=3)
    port.grads(slice_pair["batch"])  # moves the BatchNorm statistics
    try:
        path = CheckpointManager(str(tmp_path / "ckpt")).save(1, port.state)
        params, stats = load_reference_weights(
            path, jax.device_get(state.params), jcfg,
            stats_template=jax.device_get(state.batch_stats), strict=True)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
    got = state_dict_from_jax(params, stats, pcfg)
    want = port.state.model.state_dict()
    assert set(got) == set(want)
    for name, v in want.items():
        assert got[name].dtype == v.dtype, name
        assert torch.equal(got[name], v), name


def test_upstream_ckpt_loads_through_pretrained_path(recording, tmp_path):
    pcfg = tiny_test_cfg()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        upstream = MuvoWorldModel(pcfg).state_dict()
    path = tmp_path / "upstream.ckpt"
    torch.save({"state_dict": {"model." + k: v for k, v in upstream.items()},
                "epoch": 3}, path)
    try:
        run = main(_argv(recording, str(tmp_path / "run"), 0,
                         **{"PRETRAINED.PATH": str(path)}), device="cpu")
        with pytest.raises(FileNotFoundError, match="PRETRAINED.PATH"):
            main(_argv(recording, str(tmp_path / "bad"), 0,
                       **{"PRETRAINED.PATH": str(tmp_path / "missing.pt")}),
                 device="cpu")
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
    assert (run.start_step, run.step) == (0, 0)
    got = run.trainer.state.model.state_dict()
    assert set(got) == set(upstream)
    for name, v in upstream.items():
        assert torch.equal(got[name], v), name
