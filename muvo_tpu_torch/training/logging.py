"""Training observability: scalar logging (JSONL + TensorBoard) and step
timing / throughput (frames per second per device).

An own copy of muvo_tpu/training/logging.py's scalar logging and step
timing: the same JSONL record, and TensorBoard only where
``torch.utils.tensorboard`` imports. Its image and video panels come with
the validation panels that use them.
Reference: TensorBoardLogger + 'simple' profiler (train.py:72-75, 111).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
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
        record = {"step": int(step)}
        for key, value in scalars.items():
            name = f"{prefix}_{key}" if prefix else key
            value = float(value)
            record[name] = value
            if self._tb is not None:
                self._tb.add_scalar(name, value, step)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self):
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
