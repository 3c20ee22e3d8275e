"""Training entry point of the port (counterpart of the root train.py).

Builds the config, the recorded-drive datasets and loaders, and the
trainer; restores a checkpoint where there is one; runs the train loop
with periodic logging, validation and checkpoints.

    python -m muvo_tpu_torch.train --config-file muvo_tpu_torch/configs/muvo.yml \
        DATASET.DATAROOT /path/to/carla_dataset [KEY VALUE ...]

Resume: ``PRETRAINED.PATH <run dir>/checkpoints`` restores the latest step
there (weights, optimizer, step) and goes on with the batch the stopped
run would have taken next; a ``.ckpt`` / ``.pt`` / ``.pth`` file (an
upstream MUVO Lightning checkpoint, or a port checkpoint) loads its weights
alone. Each validation logs the panels of each val loader's first batch
(training/visualise.py). It runs on the GPU unless ``main`` is given
``device="cpu"``.

Data parallel, one process a rank (parallel/mesh.py):

    torchrun --nproc_per_node N -m muvo_tpu_torch.train --config-file ... \\
        BATCHSIZE <global batch, a multiple of N> [KEY VALUE ...]

Each rank loads its slice of every global batch and runs on its card (or
the one card they share, under gloo); the gradients, the BatchNorm
statistics and the ratio loss terms are the global batch's. Rank 0 alone
writes the logs, the panels and the checkpoints; every rank restores.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import NamedTuple

import torch

from muvo_tpu_torch.config import get_cfg, get_parser
from muvo_tpu_torch.data.datamodule import make_val_samplers
from muvo_tpu_torch.data.dataset import make_dataset
from muvo_tpu_torch.data.loader import DataLoader, device_prefetch
from muvo_tpu_torch.parallel import mesh
from muvo_tpu_torch.training.checkpoint import (CheckpointManager,
                                                restore_pretrained)
from muvo_tpu_torch.training.logging import MetricsLogger, StepTimer
from muvo_tpu_torch.training.optim import make_schedule
from muvo_tpu_torch.training.trainer import WorldModelTrainer, step_generator
from muvo_tpu_torch.training.visualise import visualise_step
from muvo_tpu_torch.utils.hostmem import cap_malloc_arenas, trim_host_heap

EVAL_SEED = 42  # muvo_tpu's eval step takes the unfolded PRNGKey(42)


class TrainRun(NamedTuple):
    log_dir: str
    trainer: WorldModelTrainer
    start_step: int  # the step the run began at (restored, or 0)
    step: int        # the step it ended at


def _memdebug(step: int) -> None:
    """Host-leak triage: RSS against Python-visible ndarray bytes against
    the device's allocated bytes. Diverging RSS with flat ndarray and
    device bytes is a leak below Python."""
    import gc

    import numpy as np

    nd = sum(a.nbytes for a in gc.get_objects() if isinstance(a, np.ndarray))
    with open("/proc/self/status") as f:
        rss = [ln for ln in f if ln.startswith("VmRSS")][0].split()[1]
    dev = (torch.cuda.memory_allocated() if torch.cuda.is_available()
           else 0)
    print(f"  memdebug step {step}: rss={int(rss) / 1e6:.2f}GB "
          f"ndarrays={nd / 1e9:.2f}GB device={dev / 1e9:.2f}GB", flush=True)


def _restore(cfg, state, ckpt: CheckpointManager) -> bool:
    """Own run directory first, else PRETRAINED.PATH (restore_pretrained).
    True where a whole state was restored."""
    if ckpt.restore(state=state) is not None:
        return True
    return restore_pretrained(cfg.PRETRAINED.PATH, state)


def _say(*args) -> None:
    """print, on rank 0 only."""
    if mesh.rank() == 0:
        print(*args, flush=True)


def _validate(cfg, trainer, val_loaders, logger, step: int) -> None:
    """LIMIT_VAL_BATCHES eval steps of each val loader: the sums of their
    losses (the global batch's in a group of ranks), and the panels of
    each loader's first batch (rank 0's slice)."""
    for vi, val_loader in val_loaders:
        val_metrics = {}
        with contextlib.closing(device_prefetch(iter(val_loader),
                                                trainer.device)) as batches:
            for i, vbatch in enumerate(batches):
                if i >= cfg.LIMIT_VAL_BATCHES:
                    break
                generator = torch.Generator(
                    device=trainer.device).manual_seed(EVAL_SEED)
                out = trainer.eval_step(vbatch, generator)
                losses = mesh.mean_over_ranks(out["losses"])
                for k, v in losses.items():
                    val_metrics[k] = val_metrics.get(k, 0) + float(v)
                if i == 0 and mesh.rank() == 0:
                    _log_panels(cfg, out, logger, step, f"val{vi}")
        logger.log(step, val_metrics, prefix=f"val{vi}")


def _log_panels(cfg, out, logger, step: int, prefix: str) -> None:
    panels = visualise_step(cfg, out["pb"], out["output"],
                            out.get("output_imagine"))
    for name, image in panels.items():
        if name.startswith("video/"):
            logger.log_video(step, f"{prefix}/{name[6:]}", image)
        else:
            logger.log_image(step, f"{prefix}/{name}", image)


def main(argv=None, device=None) -> TrainRun:
    args = get_parser().parse_args(argv)
    cfg = get_cfg(args)

    # glibc arena bloat from the threaded decode workers (utils/hostmem.py):
    # cap the arenas BEFORE any loader thread spawns
    cap_malloc_arenas(2)

    device = mesh.init_from_env(device)
    run_name = mesh.broadcast_object(
        time.strftime("%d%B%Yat%H_%M_%S") + "_" + socket.gethostname()
        + "_" + cfg.TAG.replace(" ", "_").replace(",", "")[:48])
    log_dir = os.path.join(cfg.LOG_DIR, run_name)
    trainer = WorldModelTrainer(cfg, device=device)
    logger = MetricsLogger(log_dir, write=mesh.rank() == 0)
    _say(f"Logging to {log_dir}; device: {trainer.device}; "
         f"ranks: {mesh.world_size()}")

    seq_len = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
    train_ds = make_dataset(cfg, "train", seq_len)
    train_loader = DataLoader(train_ds, cfg.BATCHSIZE, shuffle=True,
                              num_workers=min(cfg.N_WORKERS, 1))
    steps_per_epoch = len(train_loader)
    if steps_per_epoch == 0:
        raise ValueError(f"the training split holds {len(train_ds)} "
                         f"sequences, fewer than a batch of {cfg.BATCHSIZE}")
    # the reference validates on all three strided val splits
    # (muvo/data/dataset.py:40-68); val splits that don't exist on disk
    # (common in small local runs) are skipped with a note
    val_datasets = []
    for i in range(3):
        try:
            val_datasets.append(make_dataset(cfg, f"val{i}", seq_len))
        except Exception as e:
            _say(f"val{i} unavailable ({e}); skipping")
            val_datasets.append(None)
    lengths = [len(ds) if ds is not None else 1 for ds in val_datasets]
    val_loaders = [
        (i, DataLoader(ds, cfg.BATCHSIZE, shuffle=False, sampler=sampler))
        for i, (ds, sampler) in enumerate(
            zip(val_datasets, make_val_samplers(lengths)))
        if ds is not None
    ]

    state = trainer.init_state()
    n_params = sum(p.numel() for p in state.model.parameters())
    _say(f"Model parameters: {n_params / 1e6:.2f}M")

    ckpt = CheckpointManager(os.path.join(log_dir, "checkpoints"))
    start_step = 0
    if _restore(cfg, state, ckpt):
        start_step = state.step
        _say(f"Resumed from step {start_step}")

    schedule = make_schedule(cfg)
    # profiler window: trace steps [3, 3 + PROFILE_STEPS) once warm, on
    # rank 0
    profile_start = 3 if cfg.PROFILE_STEPS and mesh.rank() == 0 else -1
    profile_stop = profile_start + cfg.PROFILE_STEPS
    profiler = None

    timer = StepTimer()
    step = start_step
    # each rank's frames: muvo_tpu divides by jax.device_count()
    frames_per_step = cfg.BATCHSIZE * seq_len // mesh.world_size()
    # the (seed, epoch)-deterministic shuffle lets a restored run skip to
    # the exact batch it stopped at
    epoch = start_step // steps_per_epoch
    skip = start_step % steps_per_epoch
    while step < cfg.STEPS:
        train_loader.set_epoch(epoch)
        with contextlib.closing(device_prefetch(
                train_loader.iter_from(skip), trainer.device)) as batches:
            for batch in batches:
                if step >= cfg.STEPS:
                    break
                if step == profile_start:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if trainer.device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                metrics = trainer.train_step(
                    batch, step_generator(trainer.device, step))
                step += 1
                timer.tick()
                if step == profile_stop and profiler is not None:
                    if trainer.device.type == "cuda":
                        torch.cuda.synchronize(trainer.device)
                    profiler.stop()
                    trace_dir = os.path.join(log_dir, "profile")
                    os.makedirs(trace_dir, exist_ok=True)
                    profiler.export_chrome_trace(
                        os.path.join(trace_dir, "trace.json"))
                    profiler = None
                    print(f"profiler trace saved to {trace_dir}")

                if step % cfg.LOGGING_INTERVAL == 0 or step <= 2:
                    # bound RSS: return glibc free-list pages to the OS
                    trim_host_heap()
                    scalars = {k: float(v) for k, v in metrics.items()}
                    if os.environ.get("MUVO_MEMDEBUG"):
                        _memdebug(step)
                    scalars["fps_per_chip"] = timer.frames_per_second(
                        frames_per_step)
                    scalars["lr"] = float(schedule(step))
                    logger.log(step, scalars, prefix="train")
                    _say(f"step {step}: loss={scalars['loss']:.4f} "
                         f"fps/chip={scalars['fps_per_chip']:.2f}")

                if step % cfg.VAL_CHECK_INTERVAL == 0:
                    _validate(cfg, trainer, val_loaders, logger, step)
                    ckpt.save(step, state, cfg_dict=cfg.convert_to_dict())
        epoch += 1
        skip = 0

    if ckpt.latest_step() != step:  # not saved by the last validation
        ckpt.save(step, state, cfg_dict=cfg.convert_to_dict())
    ckpt.wait()
    logger.close()
    _say(f"Training complete at step {step}.")
    return TrainRun(log_dir, trainer, start_step, step)


if __name__ == "__main__":
    main()
