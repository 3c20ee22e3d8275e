"""Training-health run: does the world model learn on structured data?

The port's counterpart of muvo_tpu's tools/health_run_r4.py. It collects
episodes from the CARLA-free kinematic env in the recorded-drive layout
(the same layout CARLA collection writes), voxelises them offline, and
scores held-out reconstruction and imagination with the evaluator. The
chance floor is measured, not guessed: the same evaluator runs on the same
held-out episodes with the random-init model (the weights ``train.main``
starts from) and with each trained checkpoint. The protocol is upstream
MUVO's test loop: encode once a batch, imagine PREDICTION.N_SAMPLES times.
A second floor needs no model: ``--constant`` scores, on the same frames,
one prediction for every frame learned from the training split (its mean
image and mean range view, every kept voxel occupied): what a model that
ignores its inputs can reach.

Phases (subcommands, so each can run as its own job):

    python -m muvo_tpu_torch.tools.health_run collect DATAROOT \\
        [--train-episodes 12 --train-steps 300 --val-episodes 3 --val-steps 200]
    python -m muvo_tpu_torch.tools.health_run voxelize DATAROOT [--workers N]
    python -m muvo_tpu_torch.tools.health_run evaluate DATAROOT \\
        [--ckpt DIR | --random-init | --constant] [--batches 16 --batch-size 2 \\
         --step S --out eval.json] [--device cpu]

Training itself is the standard entry point, on muvo.yml with the dataset
filters off (runs/health_torch/SUMMARY.md has the command):

    python -m muvo_tpu_torch.train --config-file muvo_tpu_torch/configs/muvo.yml \\
        DATASET.DATAROOT DATAROOT BATCHSIZE 2 MODEL.REMAT True \\
        MODEL.REMAT_ENCODER False STEPS 2500 OPTIMIZER.ACCUMULATE_GRAD_BATCHES 1 \\
        DATASET.FILTER_BEGINNING_OF_RUN_SEC 0.0 DATASET.FILTER_NORM_REWARD -1000.0 ...

Evaluation runs on the GPU unless given ``--device cpu``; collection and
voxelisation run on the host.
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob

from muvo_tpu_torch.training.flagship import MUVO_YML

IMAGE_HW = (600, 960)   # the CARLA camera's frame
LIDAR_POINTS = 30000    # a frame's semantic LiDAR points
TRAIN_SEED0, VAL_SEED0 = 100, 900
VOXEL_FOV = 110


def flagship_cfg(dataroot: str, cfg=None):
    """muvo.yml (or ``cfg``) on ``dataroot`` with the dataset's filters
    off: the scripted driver's episodes keep every recorded frame."""
    if cfg is None:
        from muvo_tpu_torch.config import get_cfg

        cfg = get_cfg()
        cfg.merge_from_file(str(MUVO_YML))
    cfg.DATASET.DATAROOT = dataroot
    cfg.DATASET.FILTER_BEGINNING_OF_RUN_SEC = 0.0
    cfg.DATASET.FILTER_NORM_REWARD = -1000.0
    return cfg


def _scripted_control(env, obs, rng, target_speed: float):
    """Route-following proportional driver (an untrained PPO expert sits
    below 1 m/s and trips ValeoTerminal's stuck detector at 100 steps;
    the health run needs episodes with real motion so imagination has
    dynamics to learn)."""
    import numpy as np

    _, lateral, heading_err, _ = env._route_tracking()
    speed = float(obs["speed"]["forward_speed"])
    steer = float(np.clip(1.2 * heading_err - 0.12 * lateral
                          + rng.normal(0.0, 0.01), -1.0, 1.0))
    accel = 0.4 * (target_speed - speed)
    throttle = float(np.clip(accel, 0.0, 0.75))
    brake = float(np.clip(-accel, 0.0, 0.6))
    return {"throttle": throttle, "steer": steer, "brake": brake}


def _episode(job):
    """Episode ``ep`` of ``collect``, into its run directory."""
    import numpy as np

    from muvo_tpu_torch.sim.data_writer import DataWriter
    from muvo_tpu_torch.sim.kinematic_env import KinematicDrivingEnv

    dataroot, split, ep, episodes, steps, seed0, image_hw, lidar_points = job
    rng = np.random.default_rng(seed0 + ep)
    target_speed = float(rng.uniform(3.5, 6.5))
    env = KinematicDrivingEnv(seed=seed0 + ep, episode_steps=steps,
                              image_hw=tuple(image_hw),
                              lidar_points=lidar_points)
    obs = env.reset()
    run_dir = os.path.join(dataroot, "trainval", split, "Town01",
                           f"{seed0 + ep:04d}")
    writer = DataWriter(run_dir, "hero",
                        run_info={"town": "Town01", "episode": ep})
    done = False
    while not done:
        control = _scripted_control(env, obs["hero"], rng, target_speed)
        supervision = {
            "action": np.array([control["throttle"], control["steer"],
                                control["brake"]], np.float32),
            "value": 0.0,
            "action_mu": np.array([control["throttle"] - control["brake"],
                                   control["steer"]], np.float32),
            "action_sigma": np.full(2, 0.1, np.float32),
            "speed": obs["hero"]["speed"]["forward_speed"],
        }
        obs, reward, done_d, info = env.step({"hero": control})
        writer.write(env.timestamp, obs, {"hero": supervision}, reward)
        done = done_d["hero"]
    if not writer.close(info["hero"]["terminal_debug"],
                        remove_final_steps=False):
        raise RuntimeError(f"{split} episode {ep} is not valid")
    n = env.timestamp["step"]
    print(f"collected {split} episode {ep + 1}/{episodes} "
          f"({n} steps) -> {run_dir}", flush=True)
    return run_dir


def collect(dataroot: str, split: str, episodes: int, steps: int,
            seed0: int, image_hw=IMAGE_HW, lidar_points: int = LIDAR_POINTS,
            workers: int = 1):
    """``episodes`` episodes of ``steps`` steps into
    ``dataroot/trainval/<split>/Town01/<seed>``, episode ``ep`` on env and
    driver seed ``seed0 + ep``; with ``workers`` above 1, an episode a
    process, ``workers`` at a time (spawned, so the caller's threads and
    device state stay out of them). Returns the run directories."""
    jobs = [(dataroot, split, ep, episodes, steps, seed0, image_hw,
             lidar_points) for ep in range(episodes)]
    if workers <= 1:
        return [_episode(job) for job in jobs]
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        return pool.map(_episode, jobs, chunksize=1)


def voxelize(dataroot: str, cfg, workers: int = 1):
    """Offline voxel grids for every run of both splits, at VOXEL.SIZE and
    RESOLUTION, the grid's origin at VOXEL.EV_POSITION (the alignment the
    dataset's voxel decode expects)."""
    from muvo_tpu_torch.tools.generate_voxels import (process_run,
                                                      voxel_offset_from_cfg)

    offset = voxel_offset_from_cfg(cfg.VOXEL)
    runs = sorted(glob(os.path.join(dataroot, "trainval", "*", "*", "*")))
    for i, run in enumerate(runs):
        process_run(run, fov=VOXEL_FOV, resolution=cfg.VOXEL.RESOLUTION,
                    size=list(cfg.VOXEL.SIZE), offset=offset,
                    workers=workers)
        print(f"voxelised run {i + 1}/{len(runs)}: {run}", flush=True)
    return runs


CONSTANT_LABELS = ("rgb_label_1", "range_view_label_1", "voxel_label_1")


def constant_floor(trainer, reference, loader, max_batches: int):
    """The evaluator's (reconstruction, imagination) metrics over
    ``loader``'s first ``max_batches`` batches, scored as ``Evaluator.run``
    scores them, for one prediction shared by every frame and learned from
    the first ``max_batches`` batches of ``reference`` (the training split,
    shuffled): its per-pixel mean image and mean range view, and each kept
    voxel (label not 255) marked with its most frequent occupied class.
    Only the metrics of the health config (RGB, LiDAR reconstruction,
    voxels) are scored; the model is not run."""
    import contextlib

    import torch

    from muvo_tpu_torch.data.loader import device_prefetch
    from muvo_tpu_torch.training.evaluator import MetricSuite, eval_generator

    cfg, dev = trainer.cfg, trainer.device
    n_classes = cfg.VOXEL_SEG.N_CLASSES
    if (cfg.SEMANTIC_SEG.ENABLED or cfg.LIDAR_SEG.ENABLED
            or cfg.SEMANTIC_IMAGE.ENABLED or not (
                cfg.EVAL.RGB_SUPERVISION and cfg.LIDAR_RE.ENABLED
                and cfg.VOXEL_SEG.ENABLED)):
        raise ValueError("the constant floor scores RGB, LiDAR "
                         "reconstruction and voxels, and nothing else")

    def labels(source):
        with contextlib.closing(device_prefetch(iter(source), dev)) as it, \
                torch.no_grad():
            for i, batch in enumerate(it):
                if i >= max_batches:
                    break
                pb = trainer.preprocess(trainer.to_device(batch),
                                        training=False)
                yield i, {k: pb[k] for k in CONSTANT_LABELS}

    sums, frames = {}, 0
    counts = torch.zeros(n_classes, dtype=torch.long, device=dev)
    for _, pb in labels(reference):
        for key in ("rgb_label_1", "range_view_label_1"):
            total = pb[key].flatten(0, 1).double().sum(0)
            sums[key] = sums[key] + total if key in sums else total
        frames += pb["voxel_label_1"].shape[0] * pb["voxel_label_1"].shape[1]
        voxels = pb["voxel_label_1"].long()
        counts += torch.bincount(voxels[voxels != 255], minlength=n_classes)
    mean = {key: (total / frames).float() for key, total in sums.items()}
    occupied = torch.nn.functional.one_hot(
        counts[1:].argmax() + 1, n_classes).float()

    def output(pb):
        lead = pb["voxel_label_1"].shape[:2]
        grid = pb["voxel_label_1"].shape[2:5]
        return {"rgb_1": mean["rgb_label_1"].expand(
                    *lead, *mean["rgb_label_1"].shape),
                "lidar_reconstruction_1": mean["range_view_label_1"].expand(
                    *lead, *mean["range_view_label_1"].shape),
                "voxel_1": occupied.expand(*lead, *grid, n_classes)}

    recon, imagine = MetricSuite(cfg, dev), MetricSuite(cfg, dev)
    rf = trainer.rf
    for i, pb in labels(loader):
        if trainer.imagines:
            future = {k: v[:, rf:] for k, v in pb.items()}
            for s in range(cfg.PREDICTION.N_SAMPLES):
                imagine.update(future, output(future),
                               eval_generator(dev, i, s))
        past = {k: v[:, :rf] for k, v in pb.items()}
        recon.update(past, output(past), eval_generator(dev, i))
    return recon.compute(), imagine.compute()


def evaluate(dataroot: str, ckpt_dir: str, random_init: bool, batches: int,
             out_json: str, batch_size: int = 2, accum: int = 16,
             step: int = None, cfg=None, device=None,
             constant: bool = False):
    """The evaluator's reconstruction and imagination metrics over the
    first ``batches`` batches of the val split, for checkpoint ``step``
    (default: the latest) of ``ckpt_dir`` or, with ``random_init``, the
    weights ``train.main`` starts from; with ``constant``, of
    ``constant_floor``'s one prediction for every frame, learned from
    ``batches`` shuffled batches of the train split. ``accum`` is
    accepted for the command line's sake: the restore reads the model
    alone, so no optimizer template has to match. Writes ``out_json`` and
    returns the result."""
    from muvo_tpu_torch.data.dataset import CarlaDataset
    from muvo_tpu_torch.data.loader import DataLoader
    from muvo_tpu_torch.training.checkpoint import CheckpointManager
    from muvo_tpu_torch.training.evaluator import Evaluator
    from muvo_tpu_torch.training.trainer import WorldModelTrainer

    del accum
    cfg = flagship_cfg(dataroot, cfg)
    cfg.BATCHSIZE = batch_size
    cfg.MODEL.REMAT = True
    cfg.MODEL.REMAT_ENCODER = False
    trainer = WorldModelTrainer(cfg, device=device)
    seq = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
    ds = CarlaDataset(cfg, mode="val", sequence_length=seq,
                      dataset_root=dataroot)
    print(f"val dataset: {len(ds)} sequence pointers", flush=True)
    # two decode threads, at most 2 * 2 + 2 batches in flight
    loader = DataLoader(ds, cfg.BATCHSIZE, shuffle=False, num_workers=2)

    if constant:
        reference = DataLoader(
            CarlaDataset(cfg, mode="train", sequence_length=seq,
                         dataset_root=dataroot),
            cfg.BATCHSIZE, shuffle=True, num_workers=2)
        recon, imagine = constant_floor(trainer, reference, loader, batches)
        result = {"constant": True}
    else:
        state = trainer.init_state()  # train.main's initial weights
        if not random_init:
            if not os.path.isdir(ckpt_dir):
                raise FileNotFoundError(
                    f"no checkpoint directory {ckpt_dir!r}")
            restored = CheckpointManager(ckpt_dir).restore(
                step=step, state=state, with_optimizer=False)
            if restored is None:
                raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
            print(f"restored checkpoint step {state.step}", flush=True)
        recon, imagine = Evaluator(trainer).run(loader, max_batches=batches)
        result = {"random_init": random_init, "step": int(state.step)}
    result.update(recon={k: float(v) for k, v in recon.items()},
                  imagine={k: float(v) for k, v in imagine.items()})
    with open(out_json, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="phase", required=True)

    c = sub.add_parser("collect")
    c.add_argument("dataroot")
    c.add_argument("--train-episodes", type=int, default=12)
    c.add_argument("--train-steps", type=int, default=300)
    c.add_argument("--val-episodes", type=int, default=3)
    c.add_argument("--val-steps", type=int, default=200)

    v = sub.add_parser("voxelize")
    v.add_argument("dataroot")
    v.add_argument("--workers", type=int, default=1)

    e = sub.add_parser("evaluate")
    e.add_argument("dataroot")
    e.add_argument("--ckpt", default="")
    e.add_argument("--random-init", action="store_true")
    e.add_argument("--constant", action="store_true")
    e.add_argument("--batches", type=int, default=16)
    e.add_argument("--batch-size", type=int, default=2)
    e.add_argument("--accum", type=int, default=16)
    e.add_argument("--step", type=int, default=None)
    e.add_argument("--out", default="eval.json")
    e.add_argument("--device", default=None,
                   help="cpu, or a CUDA device (default: the GPU)")

    args = ap.parse_args(argv)
    if args.phase == "collect":
        collect(args.dataroot, "train", args.train_episodes,
                args.train_steps, seed0=TRAIN_SEED0)
        collect(args.dataroot, "val", args.val_episodes, args.val_steps,
                seed0=VAL_SEED0)
    elif args.phase == "voxelize":
        voxelize(args.dataroot, flagship_cfg(args.dataroot), args.workers)
    else:
        evaluate(args.dataroot, args.ckpt, args.random_init, args.batches,
                 args.out, args.batch_size, args.accum, args.step,
                 device=args.device, constant=args.constant)


if __name__ == "__main__":
    main()
