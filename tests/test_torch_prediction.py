"""``python -m muvo_tpu_torch.prediction`` and ``python -m
muvo_tpu_torch.sim_run`` on a short recorded drive, on the CPU, at
tiny_test_cfg's sizes with PREDICTION.N_SAMPLES 1.

The drive is written by muvo_tpu's DataWriter
(tests/torch_port_common.py:write_recorded_run). prediction's metrics must
be finite, under the root prediction.py's keys (``test{i}`` and
``test{i}_imagine`` for the three test samplers), and the same on a second
run (the evaluator's generators are seeded per batch and sample). sim_run
must step once for each sequence of its strided loader.
"""

import math

import pytest

from muvo_tpu_torch import prediction, sim_run
from torch_port_common import import_torch_dynamo, tiny_argv, write_recorded_run

import_torch_dynamo()  # the trainer builds torch.optim's AdamW

METRICS = {"ssim", "psnr", "chamfer_distance", "voxel_precision",
           "voxel_recall", "voxel_iou", "voxel_iou_ssc_mean"}


@pytest.fixture(scope="module")
def argv(tmp_path_factory):
    root = tmp_path_factory.mktemp("drive")
    write_recorded_run(root / "trainval" / "train" / "Town01" / "0000", 8,
                       seed=6)
    return tiny_argv(**{"DATASET.DATAROOT": str(root),
                        "DATASET.FILTER_BEGINNING_OF_RUN_SEC": 0.0,
                        "PREDICTION.N_SAMPLES": 1})


@pytest.fixture(scope="module")
def results(argv):
    return prediction.main(argv, device="cpu")


def test_prediction_metrics_are_finite_under_the_root_keys(results):
    assert set(results) == {f"test{i}{part}" for i in range(3)
                            for part in ("", "_imagine")}
    for name, scores in results.items():
        assert set(scores) == METRICS, name
        assert all(math.isfinite(v) for v in scores.values()), (name, scores)


def test_prediction_repeats_itself(argv, results):
    assert prediction.main(argv, device="cpu") == results


def test_sim_run_completes(argv):
    stats = sim_run.main(argv, device="cpu")
    assert [s["step"] for s in stats] == list(range(len(stats)))
    assert stats
    assert all(math.isfinite(s["throttle_brake"])
               and math.isfinite(s["steering"]) for s in stats)


def test_pretrained_restores_the_model_alone_for_scoring(tmp_path):
    """prediction and sim_run restore a checkpoint directory's model and
    step, and leave its optimizer state on the host: an optimizer payload
    that cannot load fails a resume's restore and not theirs."""
    import torch

    from muvo_tpu_torch.data.synthetic import tiny_test_cfg
    from muvo_tpu_torch.training.checkpoint import (CheckpointManager,
                                                    restore_pretrained)
    from muvo_tpu_torch.training.trainer import WorldModelTrainer

    trainer = WorldModelTrainer(tiny_test_cfg(), device="cpu")
    saved = trainer.init_state(seed=1)
    saved.step = 7
    path = CheckpointManager(str(tmp_path)).save(7, saved)
    payload = torch.load(path, weights_only=True)
    payload["optimizer"]["acc"] = {"no.such.parameter": torch.zeros(1)}
    torch.save(payload, path)

    state = trainer.init_state(seed=2)
    with pytest.raises(KeyError, match="unknown parameters"):
        restore_pretrained(str(tmp_path), state)
    state = trainer.init_state(seed=2)
    assert restore_pretrained(str(tmp_path), state, with_optimizer=False)
    assert state.step == 7
    assert state.optimizer.acc == {} and not state.optimizer.adamw.state
    want = saved.model.state_dict()
    for name, v in state.model.state_dict().items():
        assert torch.equal(v, want[name]), name
