"""Training observability: scalar logging (JSONL + TensorBoard) and step
timing / throughput (frames per second per device).

An own copy of muvo_tpu/training/logging.py's scalar logging, image and
video panels and step timing: the same JSONL record, and TensorBoard only
where ``torch.utils.tensorboard`` imports. Without TensorBoard an image
panel is a PNG under ``images/``; a video panel is a TensorBoard video
where moviepy (its GIF encoder) is installed, else a film strip of its
frames logged as an image.
Reference: TensorBoardLogger + 'simple' profiler (train.py:72-75, 111).
"""

from __future__ import annotations

import importlib.util
import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    """Scalars, images and videos of a run under ``log_dir``. With
    ``write`` False (the ranks of a group other than rank 0) it writes
    nothing."""

    def __init__(self, log_dir: str, write: bool = True):
        self.log_dir = log_dir
        self.write = write
        self._jsonl = self._tb = None
        if not write:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is not installed
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir)

    def log(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        if not self.write:
            return
        record = {"step": int(step)}
        for key, value in scalars.items():
            name = f"{prefix}_{key}" if prefix else key
            value = float(value)
            record[name] = value
            if self._tb is not None:
                self._tb.add_scalar(name, value, step)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def log_image(self, step: int, name: str, image):
        """image: (H, W, 3) uint8."""
        if not self.write:
            return
        if self._tb is not None:
            self._tb.add_image(name, image, step, dataformats="HWC")
            return
        import numpy as np
        from PIL import Image

        out_dir = os.path.join(self.log_dir, "images")
        os.makedirs(out_dir, exist_ok=True)
        Image.fromarray(np.asarray(image)).save(
            os.path.join(out_dir, f"{name.replace('/', '_')}_{step}.png"))

    def log_video(self, step: int, name: str, frames, fps: int = 2):
        """frames: (T, H, W, 3) uint8."""
        if not self.write:
            return
        import numpy as np

        frames = np.asarray(frames)
        if (self._tb is not None
                and importlib.util.find_spec("moviepy") is not None):
            import torch

            video = torch.from_numpy(frames.transpose(0, 3, 1, 2)[None])
            self._tb.add_video(name, video, step, fps=fps)
            return
        self.log_image(step, f"{name}_strip",
                       np.concatenate(list(frames), axis=1))

    def close(self):
        if not self.write:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Wall-clock step timing with warmup exclusion."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._last: Optional[float] = None
        self._count = 0

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self.times.append(now - self._last)
        self._last = now

    @property
    def mean_step_time(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def frames_per_second(self, frames_per_step: int) -> float:
        st = self.mean_step_time
        return frames_per_step / st if st > 0 else 0.0
