"""The flagship training step (counterpart of
muvo_tpu/training/flagship.py): muvo.yml at full width, 4 sequences of
RECEPTIVE_FIELD 4 + FUTURE_HORIZON 2 frames, decoder remat on, encoder
remat off, no gradient accumulation, a synthetic batch made from ``seed``
on the device. ``large=True`` is the LARGE step: stride-8 features, 5,184
fusion tokens a frame through the flash kernels, 1 sequence of 6 frames.
One definition for muvo_tpu_torch.bench, chip_smoke.py and the profilers,
so each describes the same step.
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

    cfg = get_cfg()
    cfg.merge_from_file(str(MUVO_YML))
    cfg.MODEL.TRANSFORMER.LARGE = large
    cfg.BATCHSIZE = batch_override or (1 if large else 4)
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


def set_flash_bwd(model, bwd: str):
    """The flash backward of every attention layer of ``model``: "fused"
    (K5) or "split" (K6)."""
    from muvo_tpu_torch.models.transformer import SelfAttention

    if bwd not in ("fused", "split"):
        raise ValueError(f"flash_bwd must be 'fused' or 'split', got {bwd!r}")
    for module in model.modules():
        if isinstance(module, SelfAttention):
            module.flash_bwd = bwd


def build_flagship_step(large: bool = False, batch_override: int = 0,
                        remat: str = "", device=None,
                        seed: int = 0) -> FlagshipStep:
    """The benchmark train step: config, initialised trainer, batch and
    generator. ``large``: the LARGE step; ``batch_override``: sequences
    (default 4, LARGE 1); ``remat``: "off|voxel|all[,enc]". The flash
    backward is K5 unless ``set_flash_bwd`` picks K6."""
    from muvo_tpu_torch.data.synthetic import synthetic_batch
    from muvo_tpu_torch.training.trainer import WorldModelTrainer

    cfg = flagship_cfg(large, batch_override, remat)
    trainer = WorldModelTrainer(cfg, device=device)
    seq = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
    batch = trainer.to_device(synthetic_batch(cfg, cfg.BATCHSIZE, seq, seed))
    trainer.init_state(seed)
    generator = torch.Generator(device=trainer.device).manual_seed(seed)
    return FlagshipStep(cfg, trainer, batch, generator)
