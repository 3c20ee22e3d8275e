"""Ranks of a torch.distributed group on the CPU for the port's
data-parallel tests (tests/test_torch_ddp.py). It imports no JAX: each
rank is a process spawned by ``torch.multiprocessing`` that imports only
this module, torch and the port.

``run_ranks`` starts WORLD processes on a free port, each joining the
gloo group through the environment ``torchrun`` would give it
(parallel/mesh.py:init_from_env), runs the named cases one after another
in each, and returns every rank's results. A rank that raises, exits
nonzero or outlives its time limit fails the call.
"""

from __future__ import annotations

import hashlib
import os
import socket
import time
import traceback
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


WORLD = 2  # ranks


def run_ranks(cases: Sequence, out_dir, timeout: float = 600.0,
              threads: int = 2) -> List[List]:
    """Runs ``cases`` ([(name, kwargs)], names of functions in CASES) in
    WORLD rank processes; [rank][case] results. Each process has
    ``timeout`` seconds from the start and ``threads`` torch threads."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    port = free_port()
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, port, list(cases), str(out), threads),
                         daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    start = time.monotonic()
    try:
        for p in procs:
            p.join(max(0.0, timeout - (time.monotonic() - start)))
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    errors = {r: (out / f"rank{r}.err").read_text()
              for r in range(WORLD) if (out / f"rank{r}.err").is_file()}
    if late or errors or any(p.exitcode for p in procs):
        raise RuntimeError(f"ranks past their {timeout} s: {late}; exit "
                           f"codes {[p.exitcode for p in procs]}; "
                           f"errors {errors}")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _rank_main(rank, port, cases, out_dir, threads):
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(WORLD),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(WORLD),
                       "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
    torch.set_num_threads(threads)
    out = Path(out_dir)
    try:
        from muvo_tpu_torch.parallel import mesh

        mesh.init_from_env("cpu")
        results = [CASES[name](**kwargs) for name, kwargs in cases]
        torch.save(results, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# shared by the ranks and the one-process references


def ddp_cfg(items=()):
    """tiny_test_cfg in fp32 with the voxel decoder and the LiDAR and depth
    label branches on and narrow decoders (DECODER_BASE_CHANNELS 64: 39M
    parameters, not 96M), then ``items`` ((dotted key, value) pairs)."""
    from muvo_tpu_torch.data.synthetic import tiny_test_cfg

    cfg = tiny_test_cfg()
    cfg.PRECISION = "32"
    cfg.LIDAR_SEG.ENABLED = True
    cfg.DEPTH.ENABLED = True
    cfg.MODEL.DECODER_BASE_CHANNELS = 64
    for key, value in items:
        node = cfg
        *path, leaf = key.split(".")
        for name in path:
            node = getattr(node, name)
        setattr(node, leaf, value)
    return cfg


def global_batch(cfg, size: int, seed: int, masked_half: bool = False):
    """The seeded global batch of ``size`` sequences; ``masked_half`` sets
    every depth pixel of its second half to the ignore index 255, so the
    halves' masked counts differ."""
    from muvo_tpu_torch.data.synthetic import synthetic_batch

    batch = synthetic_batch(cfg, size, 3, seed=seed)
    if masked_half:
        batch["depth"][size // 2:] = 255.0
    return batch


def local_rows(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """This rank's contiguous rows of a global batch (the loader's slice)."""
    from muvo_tpu_torch.parallel import mesh

    n = len(next(iter(batch.values()))) // mesh.world_size()
    r = mesh.rank()
    return {k: v[r * n:(r + 1) * n] for k, v in batch.items()}


def state_hash(module: torch.nn.Module) -> str:
    """sha256 of every parameter's and buffer's bytes, in state_dict
    order."""
    h = hashlib.sha256()
    for key, value in module.state_dict().items():
        h.update(key.encode())
        h.update(value.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def trainer_for(cfg, weights=None):
    """A host trainer on ``weights`` (a state_dict file), or on the model
    of seed 0 with every one-dimensional parameter (biases, norm
    scales) moved by 0.1 x a seeded normal draw. Most of those start at 0
    or 1, and a leaf that starts at 0 holds after one AdamW step nothing
    but its update, which for the key projection's bias (its gradient is
    0 in exact arithmetic: the softmax removes a shift shared by a query's
    logits) is Adam's answer to rounding noise."""
    from muvo_tpu_torch.models.world_model import MuvoWorldModel
    from muvo_tpu_torch.training.trainer import WorldModelTrainer

    trainer = WorldModelTrainer(cfg, device="cpu")
    if weights is not None:
        model = MuvoWorldModel(cfg)
        model.load_state_dict(torch.load(weights, weights_only=True),
                              strict=True)
        trainer.init_state(model=model)
        return trainer
    trainer.init_state(seed=0)
    rs = np.random.RandomState(0)
    with torch.no_grad():
        for p in trainer.state.model.parameters():
            if p.ndim == 1:
                p += torch.from_numpy(0.1 * rs.randn(p.numel())).to(p.dtype)
    return trainer


# ---------------------------------------------------------------------------
# the cases


def case_batch_norm(seed: int = 0):
    """BatchNorm2d and MaskedBatchNorm1d in training on this rank's rows of
    seeded global inputs: the outputs, the inputs' gradients of the global
    sum of (output x a seeded cotangent), the parameters' gradients
    averaged over the ranks, the running statistics; then, for
    BatchNorm2d (the one in rematerialised decoders), the output again
    under frozen statistics, and the running statistics after it."""
    from muvo_tpu_torch.models.layers import BatchNorm2d, frozen_batch_stats
    from muvo_tpu_torch.models.pointpillars import MaskedBatchNorm1d
    from muvo_tpu_torch.parallel import mesh

    rs = np.random.RandomState(seed)
    # far above its spread, as a range view's first conv outputs are:
    # sum(x^2) / n - mean^2 in fp32 would cancel to noise
    x2d = (50.0 + rs.randn(4, 6, 5, 7)).astype(np.float32)
    g2d = rs.randn(4, 6, 5, 7).astype(np.float32)
    x1d = (30.0 + 2.0 * rs.randn(40, 6)).astype(np.float32)
    g1d = rs.randn(40, 6).astype(np.float32)
    mask = np.zeros(40, bool)
    mask[:15] = True   # rank 0 of 2: 15 valid points
    mask[20:25] = True  # rank 1: 5
    results = {}
    for name, module, x, g, extra in (
            ("bn2d", BatchNorm2d(6), x2d, g2d, ()),
            ("bn1d", MaskedBatchNorm1d(6), x1d, g1d, (mask,))):
        torch.manual_seed(seed)
        with torch.no_grad():
            module.weight.uniform_(0.5, 1.5)
            module.bias.uniform_(-0.5, 0.5)
            module.running_mean.uniform_(-1, 1)
            module.running_var.uniform_(0.5, 1.5)
        module.train()
        rows = local_rows({"x": x, "g": g,
                           **{f"m{i}": m for i, m in enumerate(extra)}})
        xt = torch.from_numpy(rows["x"]).requires_grad_(True)
        args = [torch.from_numpy(rows[f"m{i}"]) for i in range(len(extra))]
        y = module(xt, *args)
        (y * torch.from_numpy(rows["g"])).sum().backward()
        mesh.average_gradients(module.parameters())
        results[name] = {
            "y": y.detach(), "x_grad": xt.grad,
            "weight_grad": module.weight.grad, "bias_grad": module.bias.grad,
            "running": (module.running_mean.clone(),
                        module.running_var.clone())}
        if name == "bn2d":  # a rematerialised decoder's BatchNorm
            with frozen_batch_stats():
                results[name]["y_frozen"] = module(xt.detach()).detach()
            results[name]["running_after_frozen"] = (
                module.running_mean.clone(), module.running_var.clone())
    return results


def in_float64(trainer):
    """``trainer``'s model, optimizer state and preprocessed batches in
    float64 (the losses still upcast to fp32 where they say so): the
    step's rounding far below the model's conditioning at this size, where
    a relative 1e-7 change of the parameters moves some fp32 gradient
    leaves by 1e-2."""
    trainer.state.model.double()
    preprocess = trainer.preprocess

    def to_float64(batch, **kwargs):
        return {k: v.double() if v.is_floating_point() else v
                for k, v in preprocess(batch, **kwargs).items()}

    trainer.preprocess = to_float64
    return trainer


def case_steps(save, cfg_items=(), seeds=(1,), masked_half=False):
    """train_step (no noise, in float64: in_float64) on this rank's rows of
    each seeded global batch of 2: each step's losses, and after the last
    the model's state (saved to ``save`` by rank 0) and its hash."""
    from muvo_tpu_torch.parallel import mesh

    cfg = ddp_cfg(cfg_items)
    trainer = in_float64(trainer_for(cfg))
    metrics = []
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        for seed in seeds:
            batch = local_rows(global_batch(cfg, 2, seed, masked_half))
            m = trainer.train_step(batch, stochastic=False)
            metrics.append({k: v.item() for k, v in m.items()})
    finally:
        torch.set_default_dtype(default)
    model = trainer.state.model
    if mesh.rank() == 0:
        torch.save(model.state_dict(), save)
    return {"metrics": metrics, "hash": state_hash(model),
            "updates": trainer.state.optimizer.updates}


def case_grads(weights, save):
    """The losses and the gradients averaged over the ranks of one step
    (no noise, in float64: in_float64) from ``weights`` on this rank's
    rows of a seeded global batch of 2 of 2 frames; rank 0 saves the
    gradients to ``save``."""
    from muvo_tpu_torch.data.synthetic import synthetic_batch
    from muvo_tpu_torch.parallel import mesh

    cfg = ddp_cfg()
    trainer = in_float64(trainer_for(cfg, weights))
    batch = local_rows(synthetic_batch(cfg, 2, 2, seed=3))
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        metrics, _ = trainer.grads(batch, stochastic=False)
    finally:
        torch.set_default_dtype(default)
    model = trainer.state.model
    mesh.average_gradients(model.parameters())
    if mesh.rank() == 0:
        torch.save({n: p.grad for n, p in model.named_parameters()}, save)
    return {k: v.item() for k, v in metrics.items()}


def run_checkpoints(log_root) -> Path:
    """The checkpoint directory of the one run under ``log_root``."""
    (found,) = Path(log_root).glob("*/checkpoints")
    return found


def case_train_main(argv, resume_from=None):
    """``muvo_tpu_torch.train.main`` on the host, counting this rank's
    checkpoint writes: the run's log dir, steps, writes, state hash,
    accumulated gradients' hash and optimizer update count.
    ``resume_from`` (log root, step): resume from that step of the run
    under the log root (rank 0 links its files into a directory of their
    own)."""
    from muvo_tpu_torch import train
    from muvo_tpu_torch.parallel import mesh
    from muvo_tpu_torch.training import checkpoint

    if resume_from is not None:
        root, step = resume_from
        resume = Path(root).parent / f"resume_{step}"
        if mesh.rank() == 0:
            resume.mkdir()
            for name in (f"ckpt_{step}.pt", f"meta_{step}.json"):
                os.link(run_checkpoints(root) / name, resume / name)
        mesh.barrier()
        argv = list(argv) + ["PRETRAINED.PATH", str(resume)]

    writes = []
    write = checkpoint.CheckpointManager._write

    def counted(self, step, state, cfg_dict):
        writes.append(step)
        return write(self, step, state, cfg_dict)

    checkpoint.CheckpointManager._write = counted
    try:
        run = train.main(list(argv), device="cpu")
    finally:
        checkpoint.CheckpointManager._write = write
    state = run.trainer.state
    return {"log_dir": run.log_dir, "start": run.start_step,
            "step": run.step, "writes": writes,
            "hash": state_hash(state.model),
            "acc_hash": hashlib.sha256(b"".join(
                t.numpy().tobytes() for t in state.optimizer.acc.values())
            ).hexdigest(),
            "updates": state.optimizer.updates}


def dense_samplers(n: int):
    """Three test samplers that each give a small drive's loader a batch
    or two (the released ones stride by 150 to 900 sequences)."""
    return [range(0, n, 2), range(1, n, 3), range(0, n, 4)]


def case_prediction(argv, log_root):
    """``muvo_tpu_torch.prediction.main`` on the host with dense_samplers,
    on the latest checkpoint of the run under ``log_root``."""
    from muvo_tpu_torch import prediction

    samplers = prediction.make_test_samplers
    prediction.make_test_samplers = dense_samplers
    argv = list(argv) + ["PRETRAINED.PATH", str(run_checkpoints(log_root))]
    try:
        return prediction.main(argv, device="cpu")
    finally:
        prediction.make_test_samplers = samplers


CASES = {"batch_norm": case_batch_norm, "steps": case_steps,
         "grads": case_grads, "train_main": case_train_main,
         "prediction": case_prediction}
