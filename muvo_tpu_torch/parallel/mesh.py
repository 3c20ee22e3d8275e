"""Data parallelism on torch.distributed (counterpart of
muvo_tpu/parallel/mesh.py).

muvo_tpu runs its step as one SPMD program over a ``('data', 'model')``
mesh: the global batch is sharded along 'data' and XLA inserts the
collectives, so the sharded step computes the one-device step at the
global batch. The port runs one process a rank (``torchrun``), each with
its contiguous slice of every global batch (data/loader.py), and makes the
same function explicit:

- BatchNorm takes its statistics over the global batch
  (``batch_stats_gather``, ``combine_moments``, models/layers.py,
  models/pointpillars.py);
- the loss terms that are ratios of sums over the whole batch sum their
  numerators and denominators over the ranks (``global_sum``, losses.py);
- the gradients are averaged over the ranks after the backward
  (``average_gradients``, from training/optim.py's applying step).

Not ``DistributedDataParallel``: its hooks follow one ``forward`` of the
wrapped module, while the trainer reaches the model through forward,
observe and imagine and rematerialises decoders; parameters without a
gradient must stay without one (AdamW moves a zero gradient's parameter);
and a bucketed all-reduce where the optimizer applies reduces once an
update, not once a micro-step. The price is DDP's overlap of the
all-reduce with the backward.

Gradient scaling. Let rank r of W hold the local batch B_r (equal sizes:
the loader refuses an indivisible global batch). The one-process loss at
the global batch is J = (1/W) sum_r M_r + G, where M_r is the sum of the
mean terms on B_r (cross-entropy, KL, SSIM, Chamfer: means over equal
local batches decompose) and G the global terms, each a function f of
sums S = sum_r S_r. ``global_sum``'s gradient on rank r is rank r's own
share: d f / d theta through S_r alone, and the shares of the W ranks add
up to dG/dtheta. The average over the ranks divides by W, so each global
term passes through ``global_term``, which multiplies its gradient by W
and leaves its value alone: rank r backpropagates M_r + W * G's share r,
and the mean over the ranks is (1/W) sum_r dM_r/dtheta + dG/dtheta =
dJ/dtheta. A BatchNorm's statistics are different: every rank normalises
its own outputs with them, so the gradient of a rank's statistics collects
every rank's share, and ``batch_stats_gather``'s backward sums the ranks'
gradients (the adjoint of the all-reduce). The logged losses are the mean
over the ranks of each rank's terms (``mean_over_ranks``): the mean terms'
mean, and the global terms, which every rank holds alike.

Without an initialised group (one process) every function here is the
identity of a world of size 1 and the single-process path runs as it
did, bit for bit. ``muvo_tpu/parallel/sharding.py``'s ``constrain`` and
the 'model' axis are GSPMD layout hints that do not change the function;
they have no counterpart here.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Iterable, List

import torch
import torch.distributed as dist

from muvo_tpu_torch.device import resolve_device

BUCKET_ELEMENTS = 1 << 24  # gradient elements per all-reduce (64 MiB fp32)
GROUP_TIMEOUT = timedelta(minutes=10)


def is_active() -> bool:
    """True inside an initialised group of more than one rank."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def rank() -> int:
    return dist.get_rank() if is_active() else 0


def world_size() -> int:
    return dist.get_world_size() if is_active() else 1


def rank_device(local_rank: int) -> torch.device:
    """The card of local rank ``local_rank``: ``cuda:LOCAL_RANK`` where
    every rank has its own card, else ranks share the cards round-robin
    (on one card, all of them share it)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the ranks on the host")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def backend_for(device: torch.device, local_world: int) -> str:
    """NCCL where each of the host's ``local_world`` ranks has its own card;
    gloo otherwise (NCCL refuses two ranks on one device; gloo takes
    all_reduce and broadcast on CUDA tensors, through the host) and on the
    CPU."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init_from_env(device=None) -> torch.device:
    """Joins the group that ``torchrun``'s environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and
    returns this rank's device: ``device`` where given (``"cpu"`` for
    ranks on the host), else the rank's card (``rank_device``). With no
    WORLD_SIZE above 1 there is no group: the device of
    ``resolve_device(device)``. A group that is already initialised is
    kept."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and not is_active():
        return resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    device = (rank_device(local) if device is None
              else resolve_device(device))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if is_active():
        return device
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend = backend_for(device, local_world)
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ["MASTER_PORT"]
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=int(os.environ["RANK"]), world_size=world,
                            timeout=GROUP_TIMEOUT,
                            device_id=device if backend == "nccl" else None)
    if dist.get_rank() == 0:
        why = ("a card a rank" if backend == "nccl" else
               "ranks on the host" if device.type == "cpu" else
               f"{local_world} ranks on {torch.cuda.device_count()} "
               f"card(s): NCCL refuses two ranks on one device")
        print(f"torch.distributed: {world} ranks, backend {backend} ({why})",
              flush=True)
    return device


def barrier() -> None:
    if is_active():
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank."""
    if not is_active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class _GlobalSum(torch.autograd.Function):
    """Sum over the ranks; the gradient is the rank's own share."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


class _BatchStatsSum(torch.autograd.Function):
    """Sum over the ranks; the gradient sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def global_sum(*tensors):
    """Each tensor summed over the ranks, for the loss terms that are ratios
    of sums over the global batch: one collective for all, packed in
    float64, each sum back in its tensor's dtype (a count stays an exact
    integer). The gradient on each rank is that rank's own share; pass the
    term through ``global_term``. One tensor in, one out; several in, a
    list out."""
    if not is_active():
        return tensors[0] if len(tensors) == 1 else list(tensors)
    total = _GlobalSum.apply(torch.cat(
        [t.reshape(-1).to(torch.float64) for t in tensors]))
    out, start = [], 0
    for t in tensors:
        out.append(total[start:start + t.numel()].reshape(t.shape).to(
            t.dtype))
        start += t.numel()
    return out[0] if len(tensors) == 1 else out


def global_term(loss: torch.Tensor) -> torch.Tensor:
    """A loss term made of ``global_sum``s, its value unchanged and its
    gradient multiplied by the world size (the module's docstring)."""
    if not is_active():
        return loss
    return _ScaleGrad.apply(loss, float(world_size()))


def batch_stats_gather(stats: torch.Tensor) -> torch.Tensor:
    """Every rank's BatchNorm statistics (a vector each), stacked in rank
    order into (world size, n), float64 (one all-reduce of the rows, each
    rank's own row filled in); the backward hands each rank the sum of
    every rank's gradient of its row. (1, n) in one process."""
    stats = stats.to(torch.float64)
    if not is_active():
        return stats[None]
    rows = torch.zeros((world_size(),) + stats.shape, dtype=stats.dtype,
                       device=stats.device)
    index = torch.tensor([rank()], device=stats.device)
    return _BatchStatsSum.apply(rows.index_copy(0, index, stats[None]))


def combine_moments(counts, means, m2):
    """Chan's parallel combination of per-rank (count (w, 1), mean (w, c),
    sum of squared deviations from that mean (w, c)) into the global
    mean and biased variance, free of the cancellation of sum(x^2) / n -
    mean^2 where the mean is far above the spread."""
    total = counts.sum().clamp_min(1.0)
    mean = (counts * means).sum(0) / total
    var = (m2.sum(0) + (counts * (means - mean) ** 2).sum(0)) / total
    return mean, var


def randn_slice(shape, generator, device, dtype) -> torch.Tensor:
    """``torch.randn(shape)`` for this rank's rows of the global batch: the
    draw of one process at the global batch (dim 0 times the world size)
    from ``generator``, sliced to the rank's contiguous rows. With the
    same generator on every rank (evaluation's), each sample draws the
    noise it draws in one process."""
    if not is_active():
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype)
    b = shape[0]
    full = torch.randn((b * world_size(),) + tuple(shape[1:]),
                       generator=generator, device=device, dtype=dtype)
    return full[rank() * b:(rank() + 1) * b]


def mean_over_ranks(values: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """{name: scalar tensor} averaged over the ranks (one collective)."""
    if not is_active() or not values:
        return values
    names = list(values)
    stacked = torch.stack([values[k].detach().float().reshape(())
                           for k in names])
    dist.all_reduce(stacked)
    stacked /= world_size()
    return dict(zip(names, stacked.unbind()))


def sum_over_ranks(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Accumulators (counts, sums) summed over the ranks, in place."""
    if is_active():
        for t in tensors:
            dist.all_reduce(t)
    return tensors


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Every ``.grad`` averaged over the ranks in place. Parameters without
    a gradient stay without one; all ranks must have the same ones."""
    average_([p.grad for p in params if p.grad is not None])


def average_(tensors: List[torch.Tensor]) -> None:
    """``tensors`` averaged over the ranks in place: one all-reduce a bucket
    of BUCKET_ELEMENTS, in list order. Every rank must pass as many
    (checked first: a mismatch would pair the wrong buckets and hang)."""
    if not is_active():
        return
    n = len(tensors)
    device = (tensors[0].device if tensors else torch.device(
        "cuda", torch.cuda.current_device())
        if dist.get_backend() == "nccl" else torch.device("cpu"))
    count = torch.tensor([n, -n], dtype=torch.int64, device=device)
    dist.all_reduce(count, op=dist.ReduceOp.MAX)
    if count[0].item() != n or -count[1].item() != n:
        raise RuntimeError(f"rank {rank()} holds {n} tensors to average; "
                           f"other ranks hold between {-count[1].item()} "
                           f"and {count[0].item()}")
    bucket: List[torch.Tensor] = []
    size = 0
    for i, t in enumerate(tensors):
        bucket.append(t)
        size += t.numel()
        if (size >= BUCKET_ELEMENTS or i == n - 1
                or tensors[i + 1].dtype != t.dtype):
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat)
            flat /= world_size()
            start = 0
            for b in bucket:
                b.copy_(flat[start:start + b.numel()].view_as(b))
                start += b.numel()
            bucket, size = [], 0
