"""Profile the flagship training step and say where the device time goes.

The port's counterpart of muvo_tpu's tools/profile_step.py, on
torch.profiler. It builds the flagship step (training/flagship.py: the
configuration muvo_tpu_torch.bench times), warms it up for 2 steps, traces
3 steps (host and device), writes a gzipped Chrome trace into
``trace_dir``, and sums the device's kernel, copy and set time of the
newest trace there:

- by kernel name (``summarize``: ms and launches, and the total);
- with ``--by-scope``, by model component (``summarize_by_scope``): the
  world model's submodules, named from ``named_modules()`` and joined with
  "/" (``MuvoWorldModel/voxel_decoder/conv3``), truncated to ``--depth``
  segments.

How a kernel finds its scope. While tracing, forward pre- and post-hooks
open and close a ``record_function`` range around every submodule
(``module_scopes``), and the step's phases get ranges of their own in
brackets (``phase_ranges``: ``[preprocess]``, ``[loss]`` for the losses
outside the model, ``[backward]``, ``[optimizer]``). Each device event
carries the ``correlation`` id of the runtime call that launched it; the
launch lies in nested host ranges on its thread. The innermost of them
decides: a scope claims the kernel; an autograd backward node
(``autograd::engine::evaluate_function: ...``) hands it to the forward op
that made it, and so to that op's scope; a phase takes it where no scope
does. The node carries the op's ``Sequence number`` and the profiler's id
of the op's thread (``Fwd thread id``); the forward ops carry their
sequence number and the trace's thread (their own ``Fwd thread id`` is 0),
and each thread numbers its ops on its own (the decoder's recompute runs
on the backward's thread). So each profiler thread id is matched to the
trace thread whose forward ops hold most of its nodes' sequence
numbers. What nothing claims goes
into a bucket by its trace category: ``[unattributed]`` (kernels),
``[memcpy]``, ``[memset]``. The device's own user-annotation spans
(``gpu_user_annotation``) are not counted: they would count the step
twice. The reader also takes the uncompressed trace that
``python -m muvo_tpu_torch.train`` writes with PROFILE_STEPS (which has
no scope ranges, so only the buckets).

Usage:
    python -m muvo_tpu_torch.tools.profile_step [trace_dir] [--large] \\
        [--batch=N] [--by-scope] [--depth=3] [--summarize-only] [--device=cpu]

It runs on the GPU unless given ``--device=cpu``.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import shutil
import socket
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch

DEFAULT_TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "profile_step"
WARM_STEPS, TRACED_STEPS = 2, 3
# a scope range is a module path; torch's own ranges ("ProfilerStep#3",
# "Optimizer.step#AdamW.step") have a "#"
SCOPE = re.compile(r"^[A-Za-z_][\w.]*(/[\w.]+)*$")
PHASE = re.compile(r"^\[[\w ]+\]$")
BACKWARD_NODE = "autograd::engine::evaluate_function: "
BUCKETS = {"kernel": "[unattributed]", "gpu_memcpy": "[memcpy]",
           "gpu_memset": "[memset]"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


# ---- tracing --------------------------------------------------------------
@contextlib.contextmanager
def module_scopes(model: torch.nn.Module, root: Optional[str] = None):
    """A ``record_function`` range named by its module path (``root`` /
    ``named_modules()`` name with "/" for ".") around every forward of
    every submodule of ``model``, while the context is open. The hooks
    return nothing, so the step computes what it computes without them."""
    root = root or type(model).__name__
    handles = []

    def hooks(path):
        open_ranges = []

        def pre(module, args):
            rf = torch.profiler.record_function(path)
            rf.__enter__()
            open_ranges.append(rf)

        def post(module, args, output):
            open_ranges.pop().__exit__(None, None, None)

        return pre, post

    try:
        for name, module in model.named_modules():
            path = f"{root}/{name.replace('.', '/')}" if name else root
            pre, post = hooks(path)
            handles.append(module.register_forward_pre_hook(pre))
            handles.append(module.register_forward_hook(post,
                                                         always_call=True))
        yield
    finally:
        for handle in handles:
            handle.remove()


def _ranged(fn, label: str):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def phase_ranges(trainer):
    """Bracketed ranges around the train step's phases while the context
    is open: ``[backward]`` around ``grads`` (what its inner phases leave:
    the backward pass), ``[preprocess]``, ``[loss]`` around the model and
    its losses (the scopes claim the model's part), ``[optimizer]``."""
    targets = ((trainer, "grads", "[backward]"),
               (trainer, "preprocess", "[preprocess]"),
               (trainer, "_loss", "[loss]"),
               (trainer.state.optimizer, "step", "[optimizer]"))
    saved = []
    try:
        for obj, attr, label in targets:
            own = attr in vars(obj)
            saved.append((obj, attr, own, getattr(obj, attr)))
            setattr(obj, attr, _ranged(getattr(obj, attr), label))
        yield
    finally:
        for obj, attr, own, fn in reversed(saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)


def export_gzip_trace(prof, trace_dir: str) -> str:
    """``prof``'s Chrome trace as ``<host>.<ms>.pt.trace.json.gz`` in
    ``trace_dir`` (gzip level 1: the trace of a flagship step runs to
    hundreds of MB)."""
    os.makedirs(trace_dir, exist_ok=True)
    stem = os.path.join(trace_dir, f"{socket.gethostname()}."
                                   f"{int(time.time() * 1e3)}.pt.trace.json")
    prof.export_chrome_trace(stem)
    with open(stem, "rb") as src, gzip.open(stem + ".gz", "wb",
                                            compresslevel=1) as dst:
        shutil.copyfileobj(src, dst, 1 << 24)
    os.remove(stem)
    return stem + ".gz"


def run_and_trace(trace_dir: str, large: bool = False, batch: int = 0,
                  device=None, steps: int = TRACED_STEPS):
    """The flagship step (``build_flagship_step(large, batch, device)``):
    WARM_STEPS steps, then ``steps`` steps under torch.profiler with the
    module scopes and phase ranges. Returns the trace's path and the
    FlagshipStep."""
    from torch.profiler import ProfilerActivity, profile

    from muvo_tpu_torch.training.flagship import build_flagship_step

    fs = build_flagship_step(large=large, batch_override=batch, device=device)
    trainer = fs.trainer
    dev = trainer.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(WARM_STEPS):  # builds the kernels, warms cuDNN
        trainer.train_step(fs.batch, fs.generator)
    sync()
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with module_scopes(trainer.state.model), phase_ranges(trainer):
        with profile(activities=activities) as prof:
            for _ in range(steps):
                trainer.train_step(fs.batch, fs.generator)
            sync()
    path = export_gzip_trace(prof, trace_dir)
    print("trace written to", path, flush=True)
    return path, fs


# ---- reading a trace ------------------------------------------------------
def newest_trace(trace_dir: str) -> Optional[str]:
    files = [f for f in glob.glob(os.path.join(trace_dir, "**", "*"),
                                  recursive=True)
             if f.endswith(("trace.json", "trace.json.gz"))]
    return max(files, key=os.path.getmtime) if files else None


def load_trace(trace_dir: str) -> List[Dict]:
    """The events of the newest trace under ``trace_dir`` (``*trace.json``
    or ``*trace.json.gz``); [] where there is none."""
    path = newest_trace(trace_dir)
    if path is None:
        print("no trace files found under", trace_dir)
        return []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _device_events(trace_dir: str, events=None) -> List[Dict]:
    """The device's kernel, copy and set events (not its user-annotation
    spans, which enclose them)."""
    events = load_trace(trace_dir) if events is None else events
    return [ev for ev in events
            if ev.get("ph") == "X" and ev.get("cat") in BUCKETS]


class _Frame(NamedTuple):
    start: float
    end: float
    kind: str      # "scope", "phase" or "backward"
    label: object  # the scope or phase; a backward node's (seq, fwd tid)


class _Node(NamedTuple):  # a persistent stack: snapshots cost nothing
    frame: _Frame
    parent: Optional["_Node"]


def _phase_of(name: str) -> Optional[str]:
    if PHASE.match(name):
        return name
    if name.startswith("Optimizer.step#"):
        return "[optimizer]"
    return None


def _host_frames(events):
    """Per host thread: the scope, phase and backward-node ranges (a node's
    label: its forward op's (seq, profiler thread id)); the runtime
    launches by correlation id; the forward ops with a sequence number by
    (seq, trace thread)."""
    frames = defaultdict(list)
    launches = {}
    fwd_ops = {}
    for ev in sorted((e for e in events if e.get("ph") == "X"),
                     key=lambda e: float(e.get("ts", 0))):
        cat, name = ev.get("cat", ""), ev.get("name", "")
        args = ev.get("args") or {}
        start = float(ev.get("ts", 0))
        end = start + float(ev.get("dur", 0))
        thread = (ev.get("pid"), ev.get("tid"))
        if cat == "user_annotation":
            phase = _phase_of(name)
            if phase is not None:
                frames[thread].append(_Frame(start, end, "phase", phase))
            elif SCOPE.match(name):
                frames[thread].append(_Frame(start, end, "scope", name))
        elif cat == "cpu_op" and "Sequence number" in args:
            seq = args["Sequence number"]
            if name.startswith(BACKWARD_NODE):
                frames[thread].append(_Frame(
                    start, end, "backward", (seq, args.get("Fwd thread id"))))
            elif (not re.search(r"Backward\d*$", name)
                  and (seq, thread) not in fwd_ops):
                fwd_ops[(seq, thread)] = (thread, (start + end) / 2)
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (thread, (start + end) / 2)
    return frames, launches, fwd_ops


def _forward_threads(frames, fwd_ops):
    """{profiler thread id: the trace thread whose forward ops hold the
    most sequence numbers of that id's backward nodes}."""
    seqs = defaultdict(set)
    for seq, thread in fwd_ops:
        seqs[thread].add(seq)
    wanted = defaultdict(set)
    for thread_frames in frames.values():
        for f in thread_frames:
            if f.kind == "backward":
                wanted[f.label[1]].add(f.label[0])
    return {tid: max(seqs, key=lambda th: len(want & seqs[th]))
            for tid, want in wanted.items() if seqs}


def _stacks(frames, queries):
    """The stack of ranges (innermost on top) enclosing each query,
    {query id: _Node or None}; ``queries``: [(thread, time, id)]."""
    by_thread = defaultdict(list)
    for thread, t, qid in queries:
        by_thread[thread].append((t, 1, 0.0, qid))
    out = {}
    for thread, items in by_thread.items():
        items += [(f.start, 0, -f.end, f) for f in frames.get(thread, ())]
        items.sort(key=lambda it: it[:3])
        top = None
        for t, is_query, _, item in items:
            while top is not None and top.frame.end <= t:
                top = top.parent
            if is_query:
                out[item] = top
            else:
                top = _Node(item, top)
    return out


def attribute(events) -> List[Dict]:
    """Each device event of ``events`` with the scope or bucket it counts
    under: [{"scope", "name", "ms", "cat"}]."""
    device = _device_events("", events)
    frames, launches, fwd_ops = _host_frames(events)
    fwd_thread = _forward_threads(frames, fwd_ops)
    queries = [(*launches[c], ("launch", c)) for c in
               {ev.get("args", {}).get("correlation") for ev in device}
               if c in launches]
    queries += [(thread, t, ("fwd", key))
                for key, (thread, t) in fwd_ops.items()]
    stacks = _stacks(frames, queries)

    def forward_of(label):
        key = (label[0], fwd_thread.get(label[1]))
        return ("fwd", key) if key in fwd_ops else None

    def resolve(node, depth=0):
        while node is not None:
            frame = node.frame
            if frame.kind in ("scope", "phase"):
                return frame.label
            fwd = forward_of(frame.label)
            if fwd is not None and depth < 8:
                found = resolve(stacks.get(fwd), depth + 1)
                if found is not None:
                    return found
            node = node.parent
        return None

    rows = []
    for ev in device:
        corr = (ev.get("args") or {}).get("correlation")
        scope = (resolve(stacks.get(("launch", corr)))
                 if corr in launches else None)
        rows.append({"scope": scope or BUCKETS[ev["cat"]],
                     "name": ev.get("name", ""),
                     "ms": float(ev.get("dur", 0)) / 1e3,
                     "cat": ev["cat"]})
    return rows


def truncate(scope: str, depth: int) -> str:
    return scope if scope.startswith("[") else "/".join(
        scope.split("/")[:depth])


def _print(title, durations, counts, top):
    total = sum(durations.values())
    print(f"\n{title.format(total=total, n=len(durations))}")
    for name, dur in sorted(durations.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{dur:10.3f} ms  x{counts[name]:<6} {name[:140]}")


def summarize(trace_dir: str, top: int = 40, events=None) -> Dict:
    """Device ms and launches by kernel name over the newest trace:
    {"total_ms", "ms": {name: ms}, "count": {name: n}}."""
    durations, counts = defaultdict(float), defaultdict(int)
    for ev in _device_events(trace_dir, events):
        name = ev.get("name", "")
        durations[name] += float(ev.get("dur", 0)) / 1e3
        counts[name] += 1
    _print("total traced device time: {total:.3f} ms over {n} kernel names",
           durations, counts, top)
    return {"total_ms": sum(durations.values()), "ms": dict(durations),
            "count": dict(counts)}


def summarize_by_scope(trace_dir: str, depth: int = 3, top: int = 40,
                       events=None) -> Dict:
    """Device ms and events by model scope truncated to ``depth`` "/"
    segments, the unclaimed ones by bucket: {"total_ms", "ms", "count"}."""
    events = load_trace(trace_dir) if events is None else events
    durations, counts = defaultdict(float), defaultdict(int)
    for row in attribute(events):
        key = truncate(row["scope"], depth)
        durations[key] += row["ms"]
        counts[key] += 1
    _print("total traced device time: {total:.3f} ms over {n} scopes "
           f"(depth={depth})", durations, counts, top)
    return {"total_ms": sum(durations.values()), "ms": dict(durations),
            "count": dict(counts)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    paths = [a for a in argv if not a.startswith("--")]
    trace_dir = paths[0] if paths else str(DEFAULT_TRACE_DIR)
    batch, depth, device = 0, 3, None
    for a in argv:
        if a.startswith("--batch="):
            batch = int(a.split("=")[1])
        elif a.startswith("--depth="):
            depth = int(a.split("=")[1])
        elif a.startswith("--device="):
            device = a.split("=")[1]
    if "--summarize-only" not in argv:
        run_and_trace(trace_dir, large="--large" in argv, batch=batch,
                      device=device)
    if "--by-scope" in argv:
        summarize_by_scope(trace_dir, depth=depth)
    else:
        summarize(trace_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
