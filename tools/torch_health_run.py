#!/usr/bin/env python3
"""The port's training-health run in one command, on one GPU.

    python3 tools/torch_health_run.py [--workers N]

The stages of runs/health_torch/SUMMARY.md through the port's entry
points (muvo_tpu_torch/tools/health_run.py and ``python -m
muvo_tpu_torch.train``), muvo.yml at full width and full frames:

1. collect: the scripted driver's 10 training episodes of 300 steps
   (seeds 100+) and 3 held-out episodes of 200 steps (seeds 900+) at
   600 x 960 and 30,000 LiDAR points, an episode a process on ``--workers``
   cores (default: every core this process may run on); frames a second;
2. voxelise both splits at 192 x 192 x 64 (``--workers`` processes);
   seconds a frame; then ``trainval/val0`` links to the held-out split, so
   the run's validation scores held-out episodes;
3. the two floors on 16 held-out batches of 2: ``health_run.evaluate`` on
   the random-init weights and on the constant prediction;
4. ``python -m muvo_tpu_torch.train`` with the health run's overrides
   (batch 2, ACCUMULATE_GRAD_BATCHES 1, STEPS 2500, a validation and a
   checkpoint every 500 steps, the filters off) and MUVO_MEMDEBUG=1 (the
   host's RSS at each logging step). STEPS stays 2500, so OneCycle's
   schedule up to any step is the full run's; the run is stopped once the
   step-1500 checkpoint is written, or after TRAIN_BUDGET_S seconds;
5. ``health_run.evaluate`` on the step-500, 1000 and 1500 checkpoints.

The data goes to runs/health_torch/data, the readings (the eval JSONs, the
run's metrics.jsonl, its log and ``health.json``) and the training run's
directory to build/health_torch. Both must not exist yet: the tool removes
nothing. It exits 1 when the step-1500 checkpoint was not written.
"""

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from glob import glob
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from muvo_tpu_torch.tools import health_run  # noqa: E402
from muvo_tpu_torch.training.flagship import MUVO_YML  # noqa: E402

OUT = ROOT / "build" / "health_torch"
DATA = ROOT / "runs" / "health_torch" / "data"
LOG_DIR = OUT / "logs"
TRAIN_EPISODES, TRAIN_STEPS = 10, 300
VAL_EPISODES, VAL_STEPS = 3, 200
BATCHES, BATCH_SIZE = 16, 2
STOP_STEP = 1500
EVAL_STEPS = (500, 1000, 1500)
TRAIN_BUDGET_S = 1800
TRAIN_OPTS = ("BATCHSIZE", str(BATCH_SIZE), "MODEL.REMAT", "True",
              "MODEL.REMAT_ENCODER", "False", "STEPS", "2500",
              "LOGGING_INTERVAL", "25", "VAL_CHECK_INTERVAL", "500",
              "LIMIT_VAL_BATCHES", "2", "N_WORKERS", "2",
              "OPTIMIZER.ACCUMULATE_GRAD_BATCHES", "1",
              "DATASET.FILTER_BEGINNING_OF_RUN_SEC", "0.0",
              "DATASET.FILTER_NORM_REWARD", "-1000.0")
MEMDEBUG = re.compile(r"memdebug step (\d+): rss=([\d.]+)GB "
                      r"ndarrays=([\d.]+)GB device=([\d.]+)GB")


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError:
        return "no nvidia-smi"


def say(*args):
    print(f"[{time.strftime('%H:%M:%S')}]", *args, flush=True)


def collect(workers: int):
    t0 = time.perf_counter()
    runs = {split: health_run.collect(str(DATA), split, episodes, steps,
                                      seed0, workers=workers)
            for split, episodes, steps, seed0 in (
                ("train", TRAIN_EPISODES, TRAIN_STEPS,
                 health_run.TRAIN_SEED0),
                ("val", VAL_EPISODES, VAL_STEPS, health_run.VAL_SEED0))}
    seconds = time.perf_counter() - t0
    frames = {split: sum(len(os.listdir(os.path.join(run, "image")))
                         for run in split_runs)
              for split, split_runs in runs.items()}
    return {"frames": frames, "seconds": seconds,
            "frames_per_s": sum(frames.values()) / seconds,
            "processes": workers}


def train():
    """``train.main`` in a subprocess until the STOP_STEP checkpoint is
    written or TRAIN_BUDGET_S is spent. Returns the readings."""
    cmd = [sys.executable, "-m", "muvo_tpu_torch.train", "--config-file",
           str(MUVO_YML), "DATASET.DATAROOT", str(DATA), *TRAIN_OPTS,
           "LOG_DIR", str(LOG_DIR)]
    env = dict(os.environ, MUVO_MEMDEBUG="1", PYTHONUNBUFFERED="1")
    log_path = OUT / "train.log"
    say("train:", " ".join(cmd[1:]))
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        stopped_by = None
        while proc.poll() is None:
            time.sleep(5)
            if glob(str(LOG_DIR / "*" / "checkpoints" /
                        f"meta_{STOP_STEP}.json")):
                stopped_by = f"checkpoint {STOP_STEP} written"
            elif time.perf_counter() - t0 > TRAIN_BUDGET_S:
                stopped_by = f"budget of {TRAIN_BUDGET_S} s spent"
            if stopped_by:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(120)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    seconds = time.perf_counter() - t0
    text = log_path.read_text()
    if stopped_by is None and proc.returncode != 0:
        raise RuntimeError(f"train.main exited {proc.returncode}:\n"
                           f"{text[-4000:]}")
    run_dir, = glob(str(LOG_DIR / "*"))
    shutil.copy(os.path.join(run_dir, "metrics.jsonl"),
                OUT / "metrics.jsonl")
    rss = [{"step": int(m[1]), "rss_gb": float(m[2]),
            "ndarrays_gb": float(m[3]), "device_gb": float(m[4])}
           for m in MEMDEBUG.finditer(text)]
    return {"seconds": seconds, "stopped_by": stopped_by,
            "returncode": proc.returncode, "run_dir": run_dir,
            "ckpt_steps": sorted(int(re.search(r"ckpt_(\d+)\.pt", p)[1])
                                 for p in glob(os.path.join(
                                     run_dir, "checkpoints", "ckpt_*.pt"))),
            "rss": rss}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int,
                    default=len(os.sched_getaffinity(0)))
    args = ap.parse_args()
    for path in (OUT, DATA):
        if path.exists():
            print(f"{path} exists: remove it first", file=sys.stderr)
            return 2
    OUT.mkdir(parents=True)

    result = {"nvidia_smi": nvidia_smi(), "train_opts": list(TRAIN_OPTS)}
    say("device:", result["nvidia_smi"])

    # voxelisation forks its workers before anything touches CUDA
    result["collect"] = collect(args.workers)
    say("collected:", result["collect"])
    t0 = time.perf_counter()
    health_run.voxelize(str(DATA), health_run.flagship_cfg(str(DATA)),
                        workers=args.workers)
    seconds = time.perf_counter() - t0
    result["voxelise"] = {
        "seconds": seconds, "s_per_frame_per_process":
            seconds * args.workers / sum(result["collect"]["frames"].values())}
    say("voxelised:", result["voxelise"])
    os.symlink("val", DATA / "trainval" / "val0")

    def evaluate(label, ckpt="", step=None, constant=False):
        import torch

        t0 = time.perf_counter()
        r = health_run.evaluate(str(DATA), ckpt, not ckpt, BATCHES,
                                str(OUT / f"eval_{label}.json"), BATCH_SIZE,
                                step=step, constant=constant)
        r["seconds"] = time.perf_counter() - t0
        result.setdefault("evals", {})[label] = r
        (OUT / "health.json").write_text(json.dumps(result, indent=1))
        torch.cuda.empty_cache()

    evaluate("random_init")
    evaluate("constant", constant=True)
    result["train"] = train()
    say("trained:", {k: v for k, v in result["train"].items() if k != "rss"})
    ckpts = Path(result["train"]["run_dir"]) / "checkpoints"
    for step in EVAL_STEPS:
        if step in result["train"]["ckpt_steps"]:
            evaluate(f"step{step}", str(ckpts), step)
    result["nvidia_smi_end"] = nvidia_smi()
    (OUT / "health.json").write_text(json.dumps(result, indent=1))
    say("evaluations:", json.dumps({k: {p: v[p] for p in ("recon", "imagine")}
                                    for k, v in result["evals"].items()}))
    print(result["nvidia_smi_end"], flush=True)
    if STOP_STEP not in result["train"]["ckpt_steps"]:
        print(f"the step-{STOP_STEP} checkpoint was not written "
              f"({result['train']['stopped_by']})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
