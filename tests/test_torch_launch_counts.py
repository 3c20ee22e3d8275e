"""Launch counts by type, and the kernels line chip_smoke.py builds from them.

Each kernel wrapper adds one to its total and to its count for the
tensors' type where it launches its kernel (``_count`` in ops/zconv.py and
ops/flash_attention.py). chip_smoke.py reads the typed counts of each main
path and reports one kernels-line entry for each (kernel, type) a path
launched, its launches by path and per train step read from those counts.
Here both run on the CPU with stand-in counts and rows: no kernel launches.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from muvo_tpu_torch.ops import flash_attention as fa
from muvo_tpu_torch.ops import zconv

WRAPPERS = (zconv.zconv3d_leaky, zconv.upzconv3d_leaky, zconv.zconv3d_dx,
            zconv.upzconv3d_dx, zconv.zconv3d_dw, zconv.upzconv3d_dw,
            fa.flash_fwd, fa.flash_bwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
            fa.flash_matmul)


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("module", [zconv, fa], ids=["zconv", "flash"])
def test_count_adds_one_to_the_total_and_to_the_type(module):
    def wrapper():
        pass

    wrapper.launches, wrapper.launches_by_type = 0, {}
    module._count(wrapper, torch.float32, "a")
    module._count(wrapper, torch.bfloat16, "b")
    module._count(wrapper, torch.float32, "c")
    assert wrapper.launches == 3
    assert wrapper.launches_by_type == {"float32": 2, "bfloat16": 1}
    assert wrapper.last_impl == "c"


@pytest.mark.parametrize("wrapper", WRAPPERS, ids=lambda f: f.__name__)
def test_every_wrapper_counts_by_type(wrapper):
    assert isinstance(wrapper.launches_by_type, dict)
    assert sum(wrapper.launches_by_type.values()) == wrapper.launches


def test_a_host_call_counts_nothing():
    x = torch.ones((1, 2, 3, 2, 4))
    w = torch.full((4, 4, 3, 3, 3), 0.01)
    counted = (zconv.upzconv3d_leaky, zconv.zconv3d_leaky)
    before = [dict(f.launches_by_type) for f in counted]
    zconv.upzconv3d_leaky(x, w, None, 0.2)
    zconv.zconv3d_leaky(x.bfloat16(), w.bfloat16(), None, 0.2)
    assert [f.launches_by_type for f in counted] == before


def _row(dtype, **extra):
    return {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
            "bound_by": "operations", "library_ms": None,
            "dtype": str(dtype).removeprefix("torch."), **extra}


def _rows(smoke):
    """Stand-ins for every row the kernel phases measure."""
    types = (torch.float32, torch.bfloat16)
    results = {(kid, stage, smoke.MAIN_BATCH, t): _row(t, stage=stage,
                                                         shape=[5, *shape])
               for kid, stage, shape, _ in smoke.SHAPES for t in types}
    backward = {(kid, stage, t): _row(t, stage=stage, input=[24, *shape])
                for fwd, stage, shape, _ in smoke.SHAPES
                for kid in smoke.BACKWARD[fwd] for t in types}
    flash = {(kid, "training", t): _row(t, case="training", bh=48, n=5184,
                                        d=48)
             for kid in ("K4", "K5", "K6-dq", "K6-dkv") for t in types}
    flash[("K4-mb", "microbench", torch.bfloat16)] = _row(
        torch.bfloat16, case="microbench", bh=16, n=5184, d=48)
    return results, backward, flash


def _paths(smoke):
    """Typed counts as the main paths give them: serving and serving_large
    in fp32, training and the microbenchmark in bf16."""
    steps = smoke.TRAIN_STEPS
    bf16 = {kid: {"bfloat16": 4 * steps}
            for kid in ("K1", "K2", "K1-dx", "K2-dx", "K3", "K3-up")}
    large = dict(bf16, K4={"bfloat16": 12 * steps},
                 K5={"bfloat16": 12 * steps})
    return {"serving": {"K1": {"float32": 8}, "K2": {"float32": 8}},
            "training": bf16,
            "serving_large": {"K1": {"float32": 8}, "K2": {"float32": 8},
                              "K4": {"float32": 24}},
            "training_large": large,
            "training_large_split": {"K6-dq": {"bfloat16": 12},
                                     "K6-dkv": {"bfloat16": 12}},
            "microbench": {"K4-mb": {"bfloat16": 7},
                           "K4": {"bfloat16": 7}}}


def test_kernels_line_has_an_entry_for_each_kernel_and_type_launched():
    smoke = _smoke()
    entries = smoke.kernel_entries(_paths(smoke), *_rows(smoke))
    by_key = {(e["id"], e["dtype"]): e for e in entries}
    assert set(by_key) == {
        ("K1", "float32"), ("K1", "bfloat16"), ("K2", "float32"),
        ("K2", "bfloat16"), ("K1-dx", "bfloat16"), ("K2-dx", "bfloat16"),
        ("K3", "bfloat16"), ("K3-up", "bfloat16"), ("K4", "float32"),
        ("K4", "bfloat16"), ("K5", "bfloat16"), ("K6-dq", "bfloat16"),
        ("K6-dkv", "bfloat16"), ("K4-mb", "bfloat16")}
    k1 = by_key[("K1", "bfloat16")]
    assert k1["launches_by_path"] == {"training": 20, "training_large": 20}
    assert k1["launches_per_train_step"] == {"muvo.yml": 4,
                                             "muvo.yml LARGE": 4}
    assert by_key[("K1", "float32")]["launches_by_path"] == {
        "serving": 8, "serving_large": 8}
    k4 = by_key[("K4", "float32")]
    assert (k4["launches"], k4["launches_by_path"]) == (
        24, {"serving_large": 24})
    assert by_key[("K4", "bfloat16")]["launches_by_path"] == {
        "training_large": 60, "microbench": 7}
    k2 = by_key[("K2", "float32")]
    assert k2["source"] == "muvo_tpu_torch/csrc/zconv_f32.cu"
    assert k2["stage"] == "conv2.conv1"
    assert by_key[("K2", "bfloat16")]["source"] == (
        "muvo_tpu_torch/csrc/zconv.cu")
    for e in entries:
        assert e["launches"] == sum(e["launches_by_path"].values()) > 0
        assert e["route"] == "cuda" and e["replaces"]


def test_kernels_line_fails_for_a_kernel_no_main_path_launched():
    smoke = _smoke()
    paths = _paths(smoke)
    del paths["microbench"]["K4-mb"]
    with pytest.raises(AssertionError, match="K4-mb"):
        smoke.kernel_entries(paths, *_rows(smoke))


H100_SMEM_OPTIN = 232448  # bytes of shared memory a block may opt in to


@pytest.mark.parametrize("yml,convs,slices,decodes", [
    ("muvo.yml", ["K2", "K1", "K2", "K1"], 1, 2),
    (None, ["K2", "K1"], 4, 2),             # the default config: 256
    ("one_frame.yml", ["K2", "K1"], 4, 1),  # no RSSM: one decode an eval
])
def test_predicted_launches_follow_the_kernel_stages(yml, convs, slices,
                                                     decodes):
    """chip_smoke.py predicts from the voxel convs that
    stylegan.kernel_stage puts on the kernels, read from the built decoder:
    conv2 and conv3 at muvo.yml's 64 feature channels, conv3 alone at the
    default config's 256; each conv's forward, dx and dW kernels once a
    step, bf16 K2 and K2-dx once a slice (four at the default config's
    conv3.conv1, on an H100), the forward ones once a decode of an eval
    step."""
    smoke = _smoke()
    cfg = smoke.config(yml)
    got = smoke.voxel_kernel_convs(cfg)
    assert [c[0] for c in got] == convs
    assert got[-1] == ("K1", "conv3.conv2", 192, 192, 64,
                       cfg.VOXEL_SEG.DIMENSION // 8,
                       cfg.VOXEL_SEG.DIMENSION // 8)
    per_step = smoke.predicted_launches(cfg, H100_SMEM_OPTIN)
    n = len(convs) // 2
    assert per_step["K1"] == per_step["K1-dx"] == per_step["K3"] == n
    assert per_step["K3-up"] == n
    assert per_step["K2"] == per_step["K2-dx"] == n * slices
    per_eval = smoke.predicted_eval_launches(cfg, H100_SMEM_OPTIN)
    assert per_eval["K1"] == n * decodes
    assert per_eval["K2"] == n * slices * decodes
    assert not any(per_eval[k] for k in ("K1-dx", "K3", "K4", "K5"))
