"""Evaluation ("imagination") entry point of the port (counterpart of the
root prediction.py).

Restores the model of PRETRAINED.PATH (a port checkpoint directory, or a
weights file: an upstream MUVO ``.ckpt`` or a port checkpoint), runs the
test protocol (observe RECEPTIVE_FIELD frames once, imagine FUTURE_HORIZON
frames PREDICTION.N_SAMPLES times) over the three strided test samplers of
the train split with no batch cap, and prints the reconstruction and
imagination metrics as JSON under ``test{i}`` and ``test{i}_imagine``.

    python -m muvo_tpu_torch.prediction --config-file muvo_tpu_torch/configs/muvo.yml \\
        DATASET.DATAROOT /path/to/carla_dataset PRETRAINED.PATH <run dir>/checkpoints

It runs on the GPU unless ``main`` is given ``device="cpu"``. Under
``torchrun --nproc_per_node N -m muvo_tpu_torch.prediction ...`` each rank
evaluates its slice of every batch (BATCHSIZE a multiple of N), the
metrics are summed over the ranks, and rank 0 prints them; every rank
returns them.
"""

from __future__ import annotations

import json
from typing import Dict

from muvo_tpu_torch.config import get_cfg, get_parser
from muvo_tpu_torch.data.datamodule import make_test_samplers
from muvo_tpu_torch.data.dataset import make_dataset
from muvo_tpu_torch.data.loader import DataLoader
from muvo_tpu_torch.parallel import mesh
from muvo_tpu_torch.training.checkpoint import restore_pretrained
from muvo_tpu_torch.training.evaluator import Evaluator
from muvo_tpu_torch.training.trainer import WorldModelTrainer


def main(argv=None, device=None) -> Dict[str, Dict[str, float]]:
    cfg = get_cfg(get_parser().parse_args(argv))
    trainer = WorldModelTrainer(cfg, device=mesh.init_from_env(device))
    say = print if mesh.rank() == 0 else (lambda *args: None)
    say(f"device: {trainer.device}; ranks: {mesh.world_size()}")

    seq_len = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
    test_ds = make_dataset(cfg, "train", seq_len)
    samplers = make_test_samplers(len(test_ds))

    state = trainer.init_state()
    # the model and step alone: scoring needs no optimizer state
    if restore_pretrained(cfg.PRETRAINED.PATH, state, with_optimizer=False):
        say(f"Restored checkpoint from {cfg.PRETRAINED.PATH} "
            f"(step {state.step})")

    evaluator = Evaluator(trainer)
    results = {}
    for idx, sampler in enumerate(samplers):
        loader = DataLoader(test_ds, cfg.BATCHSIZE, shuffle=False,
                            sampler=sampler,
                            num_workers=min(cfg.N_WORKERS, 1))
        # the whole test loader: upstream's prediction.py runs
        # trainer.test() with no test-batch limit
        recon, imagine = evaluator.run(loader)
        results[f"test{idx}"] = recon
        results[f"test{idx}_imagine"] = imagine
        say(f"[test{idx}] recon: {recon}")
        say(f"[test{idx}] imagine: {imagine}")

    say(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
