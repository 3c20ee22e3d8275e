"""Open-loop "simulated run" entry point of the port (counterpart of the
root sim_run.py).

Drives the train split's strided loader (about 100 sequences over the
drive) through DeploymentSession.sim_forward: observe one frame each model
stride, decode, and imagine the rest of the sequence from the latent
carry, which stays on the device between calls. Prints the mean action of
every 20th step.

    python -m muvo_tpu_torch.sim_run --config-file muvo_tpu_torch/configs/muvo.yml \\
        DATASET.DATAROOT /path/to/carla_dataset PRETRAINED.PATH <run dir>/checkpoints

It runs on the GPU unless ``main`` is given ``device="cpu"``.
"""

from __future__ import annotations

import json
from typing import Dict, List

from muvo_tpu_torch.config import get_cfg, get_parser
from muvo_tpu_torch.data.dataset import make_dataset
from muvo_tpu_torch.data.loader import DataLoader
from muvo_tpu_torch.inference import DeploymentSession
from muvo_tpu_torch.training.checkpoint import restore_pretrained
from muvo_tpu_torch.training.trainer import WorldModelTrainer


def main(argv=None, device=None) -> List[Dict[str, float]]:
    cfg = get_cfg(get_parser().parse_args(argv))
    trainer = WorldModelTrainer(cfg, device=device)

    seq_len = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
    ds = make_dataset(cfg, "train", seq_len)
    loader = DataLoader(ds, cfg.BATCHSIZE, shuffle=False,
                        sampler=range(0, len(ds), max(1, len(ds) // 100)),
                        num_workers=min(cfg.N_WORKERS, 1))

    state = trainer.init_state()
    restore_pretrained(cfg.PRETRAINED.PATH, state, with_optimizer=False)
    session = DeploymentSession(state.model, cfg, device=trainer.device)
    stats = []
    for i, batch in enumerate(loader):
        out, _ = session.sim_forward(batch, is_dreaming=False)
        stats.append({"step": i,
                      "throttle_brake": out["throttle_brake"].mean().item(),
                      "steering": out["steering"].mean().item()})
        if i % 20 == 0:
            print(json.dumps(stats[-1]))
    print(f"sim_run complete: {len(stats)} model steps")
    return stats


if __name__ == "__main__":
    main()
