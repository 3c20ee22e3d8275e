"""Checkpoints of a training run, with resume (counterpart of
muvo_tpu/training/checkpoint.py, on ``torch.save``).

One file a step, ``ckpt_<step>.pt``, holds
``{"state_dict": {"model." + key: tensor}, "optimizer": ..., "step": n}``:
the model's state_dict in the Lightning form that upstream MUVO writes
(its keys are upstream's, BatchNorm buffers included), the optimizer's
state (AdamW moments, the accumulation counts and accumulated gradients),
and the number of train steps taken. A ``meta_<step>.json`` sidecar
carries the git metadata, the world size of the run (its number of
ranks, as muvo_tpu writes its device count) and the config. ``load_torch_state_dict`` strips
the ``model.`` prefix, so an upstream MUVO ``.ckpt`` loads into the port's
model directly, and a port checkpoint into muvo_tpu's
``load_reference_weights``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

from muvo_tpu_torch.parallel import mesh

_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")
PREFIX = "model."


def _git_metadata(repo_dir: Optional[str] = None) -> Dict[str, str]:
    repo_dir = repo_dir or str(Path(__file__).resolve().parents[2])

    def run(cmd):
        try:
            return subprocess.run(cmd, cwd=repo_dir, capture_output=True,
                                  text=True, timeout=10).stdout.strip()
        except (OSError, subprocess.TimeoutExpired):
            return ""

    return {"git_hash": run(["git", "rev-parse", "HEAD"]),
            "git_diff": run(["git", "diff", "--stat"])}


def _to_cpu(obj):
    """``obj`` with every tensor in it detached and copied to the host."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class CheckpointManager:
    """Saves and restores a ``TrainState`` in ``directory``, keeping the
    newest ``max_to_keep`` steps."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self):
        found = (_CKPT.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, cfg_dict: Optional[Dict] = None) -> str:
        """Writes step ``step`` of ``state`` (a TrainState), then drops the
        oldest steps beyond ``max_to_keep``. Returns the file's path. In a
        group of ranks every rank calls it, the accumulated gradients are
        averaged over the ranks (so that the ranks hold the same state),
        rank 0 alone writes, and all wait for the write."""
        path = self.path(step)
        state.optimizer.average_accumulated()
        if mesh.rank() == 0:
            self._write(step, state, cfg_dict)
        mesh.barrier()
        return path

    def _write(self, step: int, state, cfg_dict: Optional[Dict]) -> None:
        payload = {
            "state_dict": {PREFIX + k: v.detach().cpu()
                           for k, v in state.model.state_dict().items()},
            "optimizer": _to_cpu(state.optimizer.state_dict()),
            "step": int(step),
        }
        path = self.path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)  # a cut save never leaves a readable half
        sidecar = {"metadata": {**_git_metadata(),
                                "world_size": mesh.world_size()}}
        if cfg_dict is not None:
            sidecar["config"] = cfg_dict
        with open(os.path.join(self.directory, f"meta_{step}.json"), "w") as f:
            json.dump(sidecar, f, indent=2, default=str)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
            meta = os.path.join(self.directory, f"meta_{old}.json")
            if os.path.isfile(meta):
                os.remove(meta)

    def restore(self, step: Optional[int] = None, state=None,
                with_optimizer: bool = True) -> Optional[Dict]:
        """The payload of ``step`` (default: the latest), with the sidecar's
        "metadata" and "config"; None if there is no checkpoint. Given a
        TrainState, loads the model (strictly), the optimizer (unless
        ``with_optimizer`` is False) and the step count into it."""
        mesh.barrier()  # no rank reads before a save in flight is written
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        payload = torch.load(self.path(step), map_location="cpu",
                             weights_only=True)
        if state is not None:
            state.model.load_state_dict(strip_prefix(payload["state_dict"]),
                                        strict=True)
            if with_optimizer:
                state.optimizer.load_state_dict(payload["optimizer"])
            state.step = int(payload["step"])
        meta = os.path.join(self.directory, f"meta_{step}.json")
        if os.path.isfile(meta):
            with open(meta) as f:
                payload.update(json.load(f))
        return payload

    def wait(self):
        """Saves are synchronous: every ``save`` has finished on return."""


def strip_prefix(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A Lightning state_dict's keys without the ``model.`` prefix."""
    return {k[len(PREFIX):] if k.startswith(PREFIX) else k: v
            for k, v in state.items()}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The model weights of a checkpoint file (an upstream MUVO Lightning
    ``.ckpt``, a port checkpoint or a bare state_dict), ``model.``
    stripped."""
    ckpt = torch.load(path, map_location="cpu")
    state = ckpt.get("state_dict", ckpt)
    return {k: v.detach() for k, v in strip_prefix(state).items()}


def restore_pretrained(path: str, state, with_optimizer: bool = True
                       ) -> bool:
    """PRETRAINED.PATH ``path`` into ``state``: a checkpoint directory (its
    latest step: the model, the step count and, unless ``with_optimizer`` is
    False, the optimizer; True), or a weights file, an upstream MUVO
    Lightning checkpoint or a port checkpoint (the model alone; False).
    False without a path."""
    if not path:
        return False
    if os.path.isdir(path):
        return CheckpointManager(path).restore(
            state=state, with_optimizer=with_optimizer) is not None
    if path.endswith((".ckpt", ".pt", ".pth")) and os.path.isfile(path):
        missing, _ = state.model.load_state_dict(load_torch_state_dict(path),
                                                 strict=False)
        if missing:
            print(f"Warning - {len(missing)} parameters not found in "
                  f"checkpoint")
        print(f"Loaded reference weights from {path}")
        return False
    raise FileNotFoundError(f"PRETRAINED.PATH {path!r} is neither a "
                            f"checkpoint directory nor a weights file")
