"""The flagship training step (counterpart of
muvo_tpu/training/flagship.py): muvo.yml at full width, 4 sequences of
RECEPTIVE_FIELD 4 + FUTURE_HORIZON 2 frames, decoder remat on, encoder
remat off, no gradient accumulation, a synthetic batch made from ``seed``
on the device. One definition for muvo_tpu_torch.bench, chip_smoke.py and
the profiler, so each describes the same step.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import torch

MUVO_YML = Path(__file__).resolve().parents[1] / "configs" / "muvo.yml"


class FlagshipStep(NamedTuple):
    cfg: object
    trainer: object
    batch: dict                 # device-resident raw batch
    generator: torch.Generator  # augmentation, dropout and sampling noise


def flagship_cfg(large: bool = False, batch_override: int = 0,
                 remat: str = ""):
    from muvo_tpu_torch.config import get_cfg

    if large:
        raise NotImplementedError("the LARGE path (stride-8 features, flash "
                                  "attention) is not ported yet")
    cfg = get_cfg()
    cfg.merge_from_file(str(MUVO_YML))
    cfg.BATCHSIZE = batch_override or 4
    cfg.MODEL.REMAT = True
    cfg.MODEL.REMAT_ENCODER = False
    cfg.OPTIMIZER.ACCUMULATE_GRAD_BATCHES = 1
    if remat:
        opts = remat.split(",")
        if opts[0] not in ("off", "voxel", "all"):
            raise ValueError(f"remat scope must be off|voxel|all, "
                             f"got {opts[0]!r}")
        cfg.MODEL.REMAT = opts[0] != "off"
        cfg.MODEL.REMAT_SCOPE = opts[0] if opts[0] != "off" else "all"
        cfg.MODEL.REMAT_ENCODER = "enc" in opts
    return cfg


def build_flagship_step(large: bool = False, batch_override: int = 0,
                        remat: str = "", device=None,
                        seed: int = 0) -> FlagshipStep:
    """The benchmark train step: config, initialised trainer, batch and
    generator. ``batch_override``: sequences (default 4); ``remat``:
    "off|voxel|all[,enc]"; ``large=True`` raises NotImplementedError."""
    from muvo_tpu_torch.data.synthetic import synthetic_batch
    from muvo_tpu_torch.training.trainer import WorldModelTrainer

    cfg = flagship_cfg(large, batch_override, remat)
    trainer = WorldModelTrainer(cfg, device=device)
    seq = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
    batch = trainer.to_device(synthetic_batch(cfg, cfg.BATCHSIZE, seq, seed))
    trainer.init_state(seed)
    generator = torch.Generator(device=trainer.device).manual_seed(seed)
    return FlagshipStep(cfg, trainer, batch, generator)
