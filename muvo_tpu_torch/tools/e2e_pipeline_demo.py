"""End-to-end pipeline demo without CARLA, at a tiny config.

The port's counterpart of muvo_tpu's tools/e2e_pipeline_demo.py:

1. collect an episode in the kinematic env with the PPO expert (untrained,
   seeded) into the port's DataWriter, in the recorded-drive layout;
2. voxelise the recorded depth and LiDAR frames offline
   (tools/generate_voxels.py);
3. train the world model on the recording for ``--steps`` steps;
4. run the evaluation protocol (observe the receptive field, imagine the
   future horizon) over 2 batches.

    python -m muvo_tpu_torch.tools.e2e_pipeline_demo [workdir] [--steps 5] \\
        [--device cpu]

It runs on the GPU unless given ``--device cpu``, and prints
``E2E PIPELINE OK`` at the end.
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from pathlib import Path

from muvo_tpu_torch.training.flagship import MUVO_YML

DEFAULT_WORKDIR = Path(__file__).resolve().parents[2] / "build" / "muvo_e2e"
VOXEL_FOV = 110


def tiny_cfg():
    """muvo.yml at the demo's sizes: 96 x 160 frames, a 64^3 voxel grid,
    narrow embeddings, RF 2 + FH 1, batch 1, every recorded frame kept."""
    from muvo_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(MUVO_YML))
    cfg.IMAGE.SIZE = (96, 160)
    cfg.IMAGE.CROP = [16, 16, 144, 80]
    cfg.ROUTE.SIZE = 32
    cfg.POINTS.CHANNELS = 64
    cfg.POINTS.HORIZON_RESOLUTION = 128
    cfg.VOXEL.SIZE = [64, 64, 64]
    cfg.MODEL.TRANSFORMER.CHANNELS = 64
    cfg.MODEL.EMBEDDING_DIM = 64
    cfg.MODEL.TRANSITION.HIDDEN_STATE_DIM = 96
    cfg.MODEL.TRANSITION.STATE_DIM = 48
    cfg.MODEL.TRANSITION.ACTION_LATENT_DIM = 16
    cfg.VOXEL_SEG.DIMENSION = 16
    cfg.RECEPTIVE_FIELD = 2
    cfg.FUTURE_HORIZON = 1
    cfg.BATCHSIZE = 1
    cfg.OPTIMIZER.ACCUMULATE_GRAD_BATCHES = 1
    cfg.DATASET.FILTER_BEGINNING_OF_RUN_SEC = 0.0
    cfg.DATASET.FILTER_NORM_REWARD = -1000.0
    return cfg


def collect(dataroot: str, n_episodes: int = 1, steps: int = 40,
            device=None):
    """``n_episodes`` episodes of the untrained PPO expert (on ``device``)
    in the kinematic env (seed 3), each into trainval/train/Town01/<ep>."""
    from muvo_tpu_torch.rl.agent import RlBirdviewAgent
    from muvo_tpu_torch.sim.data_writer import DataWriter
    from muvo_tpu_torch.sim.kinematic_env import KinematicDrivingEnv

    env = KinematicDrivingEnv(seed=3, episode_steps=steps, image_hw=(96, 160))
    agent = RlBirdviewAgent(device=device)
    for ep in range(n_episodes):
        run_dir = os.path.join(dataroot, "trainval", "train", "Town01",
                               f"{ep:04d}")
        writer = DataWriter(run_dir, "hero",
                            run_info={"town": "Town01", "episode": ep})
        obs = env.reset()
        done = False
        while not done:
            control = agent.run_step(obs["hero"], env.timestamp)
            obs, reward, done_d, info = env.step({"hero": control})
            writer.write(env.timestamp, obs,
                         {"hero": agent.supervision_dict}, reward)
            done = done_d["hero"]
        if not writer.close(info["hero"]["terminal_debug"],
                            remove_final_steps=False):
            raise RuntimeError(f"episode {ep} is not valid")
        print(f"collected episode {ep} -> {run_dir}", flush=True)
    return dataroot


def voxelize(dataroot: str, cfg):
    from muvo_tpu_torch.tools.generate_voxels import (process_run,
                                                      voxel_offset_from_cfg)

    offset = voxel_offset_from_cfg(cfg.VOXEL)
    for run in sorted(glob(os.path.join(dataroot, "trainval", "train", "*",
                                        "*"))):
        process_run(run, fov=VOXEL_FOV, resolution=cfg.VOXEL.RESOLUTION,
                    size=list(cfg.VOXEL.SIZE), offset=offset, workers=1)


def train_and_eval(dataroot: str, cfg, n_steps: int, device=None):
    """``n_steps`` train steps on the recording, then the evaluator over
    2 batches. Returns (reconstruction, imagination) metrics and the
    losses."""
    import contextlib

    from muvo_tpu_torch.data.dataset import CarlaDataset
    from muvo_tpu_torch.data.loader import DataLoader, device_prefetch
    from muvo_tpu_torch.training.evaluator import Evaluator
    from muvo_tpu_torch.training.trainer import (WorldModelTrainer,
                                                 step_generator)

    cfg.DATASET.DATAROOT = dataroot
    trainer = WorldModelTrainer(cfg, device=device)
    seq = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
    ds = CarlaDataset(cfg, mode="train", sequence_length=seq,
                      dataset_root=dataroot)
    print(f"dataset: {len(ds)} sequence pointers", flush=True)
    loader = DataLoader(ds, cfg.BATCHSIZE, shuffle=True)
    trainer.init_state()

    losses, epoch = [], 0
    while len(losses) < n_steps:
        loader.set_epoch(epoch)
        with contextlib.closing(device_prefetch(iter(loader),
                                                trainer.device)) as batches:
            for batch in batches:
                if len(losses) >= n_steps:
                    break
                metrics = trainer.train_step(
                    batch, step_generator(trainer.device, len(losses)))
                losses.append(float(metrics["loss"]))
                print(f"train step {len(losses) - 1}: "
                      f"loss={losses[-1]:.4f}", flush=True)
        epoch += 1

    recon, imagine = Evaluator(trainer).run(
        DataLoader(ds, cfg.BATCHSIZE, shuffle=False), max_batches=2)
    print("recon metrics:", {k: round(v, 4) for k, v in recon.items()})
    print("imagine metrics:", {k: round(v, 4) for k, v in imagine.items()})
    return recon, imagine, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default=str(DEFAULT_WORKDIR))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = tiny_cfg()
    os.makedirs(args.workdir, exist_ok=True)
    collect(args.workdir, device=args.device)
    voxelize(args.workdir, cfg)
    result = train_and_eval(args.workdir, cfg, args.steps, args.device)
    print("E2E PIPELINE OK", flush=True)
    return result


if __name__ == "__main__":
    main()
