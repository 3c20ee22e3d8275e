"""``muvo_tpu_torch.tools.profile_step`` on the CPU.

- A hand-written Chrome trace in torch.profiler's format: scope ranges on
  the main thread, runtime launches with ``correlation`` ids, kernels, a
  copy, backward nodes on the autograd thread whose ``Sequence number``
  leads to a forward op in a scope (where the recompute on that thread
  numbers an op alike), another whose forward op is not in the trace, the optimizer's range, a device-side user-annotation span
  and a kernel launched outside every range. ``summarize`` and
  ``summarize_by_scope`` give exact ms at depths 1-4, the by-scope total
  equals the by-name total, and the uncompressed trace that
  ``train.main`` writes reads the same as a gzipped one.
- ``main`` with ``--summarize-only`` over that trace directory.
- The scope hooks and phase ranges leave a tiny fp32 train step bit-equal
  to one without them, and a CPU profile of that step holds a scope range
  for each top-level submodule that ran.
"""

import gzip
import json
import os

import pytest
import torch

from muvo_tpu_torch.data.synthetic import synthetic_batch, tiny_test_cfg
from muvo_tpu_torch.tools import profile_step as ps
from muvo_tpu_torch.training.trainer import WorldModelTrainer
from torch_port_common import import_torch_dynamo

MAIN, AUTOGRAD, GPU = (1, 10), (1, 20), (0, 7)


def _span(thread, cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": thread[0],
            "tid": thread[1], "ts": ts, "dur": dur, "args": args}


def _launched(corr, ts, name, dur_us, cat="kernel", thread=MAIN):
    """A runtime launch at ``ts`` on ``thread`` and its device event."""
    return [_span(thread, "cuda_runtime", "cudaLaunchKernel", ts, 1,
                  correlation=corr),
            _span(GPU, cat, name, 1000 + 10 * corr, dur_us, correlation=corr)]


def _trace():
    root, dec = "MuvoWorldModel", "MuvoWorldModel/voxel_decoder"
    # a forward op carries its own thread's sequence number (its "Fwd
    # thread id" is 0), a backward node the profiler's id of that thread
    fwd = {"Sequence number": 5, "Fwd thread id": 0}
    seq = {"Sequence number": 5, "Fwd thread id": 1}
    events = [
        _span(MAIN, "user_annotation", "[preprocess]", -20, 15),
        *_launched(4, -10, "elementwise_kernel", 250),
        _span(MAIN, "user_annotation", root, 0, 100),
        _span(MAIN, "user_annotation", dec, 10, 50),
        _span(MAIN, "user_annotation", f"{dec}/conv3", 20, 30),
        _span(MAIN, "user_annotation", f"{dec}/conv3/conv1", 22, 8),
        _span(MAIN, "cpu_op", "aten::conv3d", 23, 5, **fwd),
        *_launched(1, 24, "zconv_tc_kernel<2, 3, true, false>", 2000),
        *_launched(2, 40, "sum_rows_kernel", 1000),
        _span(MAIN, "cpu_op", "aten::mul", 42, 2,
              **{"Sequence number": 7, "Fwd thread id": 0}),
        *_launched(3, 70, "gemm", 500),
        # the device's span of a scope: not counted
        _span(GPU, "gpu_user_annotation", dec, 1000, 10000),
        # the backward pass on the autograd thread
        _span(AUTOGRAD, "user_annotation", "[backward]", 190, 110),
        # the decoder's recompute on the autograd thread, whose own
        # numbering also reaches 5
        _span(AUTOGRAD, "user_annotation", f"{dec}/conv2", 192, 6),
        _span(AUTOGRAD, "cpu_op", "aten::conv3d", 193, 4, **fwd),
        *_launched(11, 194, "recompute_kernel", 250, thread=AUTOGRAD),
        _span(AUTOGRAD, "cpu_op", "autograd::engine::evaluate_function: "
              "ConvolutionBackward0", 200, 20, **seq),
        _span(AUTOGRAD, "cpu_op", "ConvolutionBackward0", 201, 18, **seq),
        *_launched(5, 205, "dgrad_engine", 3000, thread=AUTOGRAD),
        _span(AUTOGRAD, "cpu_op", "autograd::engine::evaluate_function: "
              "MulBackward0", 230, 10, **{"Sequence number": 99,
                                          "Fwd thread id": 1}),
        *_launched(6, 232, "mul_kernel", 125, thread=AUTOGRAD),
        _span(AUTOGRAD, "cpu_op", "autograd::engine::evaluate_function: "
              "MulBackward0", 250, 10, **{"Sequence number": 7,
                                          "Fwd thread id": 1}),
        *_launched(10, 252, "mul_bwd_kernel", 500, thread=AUTOGRAD),
        _span(MAIN, "user_annotation", "Optimizer.step#AdamW.step", 400, 50),
        *_launched(7, 410, "multi_tensor_apply_kernel", 1500),
        *_launched(8, 460, "Memcpy HtoD", 62.5, cat="gpu_memcpy"),
        *_launched(9, 500, "unscoped_kernel", 375),
    ]
    return events


BY_NAME = {"elementwise_kernel": 0.25,
           "zconv_tc_kernel<2, 3, true, false>": 2.0,
           "sum_rows_kernel": 1.0, "gemm": 0.5, "dgrad_engine": 3.0,
           "mul_kernel": 0.125, "multi_tensor_apply_kernel": 1.5,
           "Memcpy HtoD": 0.0625, "unscoped_kernel": 0.375,
           "mul_bwd_kernel": 0.5, "recompute_kernel": 0.25}
BUCKETS = {"[preprocess]": 0.25, "[backward]": 0.125, "[optimizer]": 1.5,
           "[memcpy]": 0.0625, "[unattributed]": 0.375}
BY_SCOPE = {
    1: {"MuvoWorldModel": 7.25},
    2: {"MuvoWorldModel/voxel_decoder": 6.75, "MuvoWorldModel": 0.5},
    3: {"MuvoWorldModel/voxel_decoder/conv3": 6.5,
        "MuvoWorldModel/voxel_decoder/conv2": 0.25, "MuvoWorldModel": 0.5},
    4: {"MuvoWorldModel/voxel_decoder/conv3/conv1": 5.0,
        "MuvoWorldModel/voxel_decoder/conv3": 1.5,
        "MuvoWorldModel/voxel_decoder/conv2": 0.25, "MuvoWorldModel": 0.5},
}


@pytest.fixture()
def trace_dir(tmp_path):
    path = tmp_path / "host.1.pt.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": _trace()}, f)
    return tmp_path


def test_summarize_sums_device_time_by_kernel_name(trace_dir):
    got = ps.summarize(str(trace_dir))
    assert got["ms"] == BY_NAME
    assert got["count"] == {name: 1 for name in BY_NAME}
    assert got["total_ms"] == sum(BY_NAME.values()) == 9.5625


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_summarize_by_scope_attributes_each_kernel(trace_dir, depth):
    got = ps.summarize_by_scope(str(trace_dir), depth=depth)
    assert got["ms"] == {**BY_SCOPE[depth], **BUCKETS}
    assert got["total_ms"] == ps.summarize(str(trace_dir))["total_ms"]


def test_backward_kernel_takes_its_forward_ops_scope(trace_dir):
    rows = {r["name"]: r["scope"] for r in ps.attribute(
        ps.load_trace(str(trace_dir)))}
    # not the recompute's op, which has the same number on another thread
    assert rows["dgrad_engine"] == "MuvoWorldModel/voxel_decoder/conv3/conv1"
    assert rows["recompute_kernel"] == "MuvoWorldModel/voxel_decoder/conv2"
    assert rows["mul_kernel"] == "[backward]"  # no forward op in the trace


def test_reads_train_mains_uncompressed_trace(tmp_path, trace_dir):
    profile = tmp_path / "run" / "profile"
    profile.mkdir(parents=True)
    (profile / "trace.json").write_text(json.dumps({"traceEvents": _trace()}))
    os.utime(profile / "trace.json", (1, 1))  # older than the gzipped one
    assert ps.newest_trace(str(tmp_path)).endswith(".gz")
    assert ps.summarize_by_scope(str(profile), depth=2)["ms"] == {
        **BY_SCOPE[2], **BUCKETS}


def test_summarize_only_prints_the_by_scope_table(trace_dir, capsys):
    assert ps.main([str(trace_dir), "--summarize-only", "--by-scope",
                    "--depth=2"]) == 0
    out = capsys.readouterr().out
    assert "total traced device time: 9.56" in out
    assert "ms over 7 scopes (depth=2)" in out
    assert "MuvoWorldModel/voxel_decoder" in out and "[optimizer]" in out
    assert ps.main([str(trace_dir), "--summarize-only"]) == 0
    assert "over 11 kernel names" in capsys.readouterr().out


# ---- the hooks on a tiny train step ---------------------------------------
def _step(scoped: bool):
    import_torch_dynamo()
    cfg = tiny_test_cfg()
    cfg.PRECISION = "32"
    trainer = WorldModelTrainer(cfg, device="cpu")
    trainer.init_state(0)
    batch = synthetic_batch(cfg, 1, cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON)
    generator = torch.Generator().manual_seed(3)
    if not scoped:
        trainer.train_step(batch, generator)
        return trainer, None, set()
    ran = set()
    children = dict(trainer.state.model.named_children())
    counting = [m.register_forward_hook(
        lambda m, a, o, name=name: ran.add(name))
        for name, m in children.items()]
    from torch.profiler import ProfilerActivity, profile
    with ps.module_scopes(trainer.state.model), ps.phase_ranges(trainer):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            trainer.train_step(batch, generator)
    for handle in counting:
        handle.remove()
    return trainer, prof, ran


@pytest.fixture(scope="module")
def steps():
    return _step(False), _step(True)


def test_scope_hooks_leave_the_step_bit_equal(steps):
    (plain, _, _), (scoped, _, _) = steps
    want = plain.state.model.state_dict()
    got = scoped.state.model.state_dict()
    assert list(got) == list(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    # the hooks and wrappers are gone afterwards
    assert "grads" not in vars(scoped) and "step" not in vars(
        scoped.state.optimizer)
    assert not any(m._forward_pre_hooks for m in scoped.state.model.modules())


def test_cpu_profile_holds_a_range_for_each_top_level_submodule(steps):
    _, (_, prof, ran) = steps
    names = {e.name for e in prof.events()}
    assert {"voxel_decoder", "range_view_encoder"} <= ran
    assert {f"MuvoWorldModel/{child}" for child in ran} <= names
    assert {"MuvoWorldModel", "[preprocess]", "[loss]", "[backward]",
            "[optimizer]"} <= names
