"""The PyTorch port stands alone: it imports nothing of JAX or muvo_tpu,
keeps its own copies of muvo_tpu's numpy-only modules (which must agree
with the originals), and never runs quietly on the CPU when a GPU was
meant.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from muvo_tpu import config as jax_config
from muvo_tpu.data import synthetic as jax_synthetic
from muvo_tpu_torch import config as port_config
from muvo_tpu_torch.data import synthetic as port_synthetic
from muvo_tpu_torch.data.synthetic import tiny_test_cfg
from muvo_tpu_torch.device import resolve_device
from muvo_tpu_torch.inference import DeploymentSession
from muvo_tpu_torch.models.world_model import MuvoWorldModel

ROOT = Path(__file__).resolve().parents[1]
MUVO_YML = "muvo_tpu_torch/configs/muvo.yml"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import muvo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(muvo_tpu_torch.__path__,
                                               "muvo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "muvo_tpu"))
print(len(names), leaked)
sys.exit(1 if leaked or not names else 0)
"""


def test_importing_every_module_loads_no_jax_and_no_muvo_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("config_file", [None, MUVO_YML])
def test_get_cfg_equals_muvo_tpu(config_file):
    opts = ["MODEL.TRANSITION.STATE_DIM", "64", "VOXEL_SEG.N_CLASSES", "3"]
    argv = (["--config-file", str(ROOT / config_file)] if config_file
            else []) + opts
    got = port_config.get_cfg(port_config.get_parser().parse_args(argv))
    want = jax_config.get_cfg(jax_config.get_parser().parse_args(argv))
    assert got.convert_to_dict() == want.convert_to_dict()
    assert got.MODEL.TRANSITION.STATE_DIM == 64
    assert port_config.get_cfg().convert_to_dict() == (
        jax_config.get_cfg().convert_to_dict())


def test_muvo_yml_is_muvo_tpus():
    assert (ROOT / MUVO_YML).read_bytes() == (
        ROOT / "muvo_tpu/configs/muvo.yml").read_bytes()


@pytest.mark.parametrize("config_file", [None, MUVO_YML])
def test_synthetic_batch_equals_muvo_tpu(config_file):
    port_cfg, cfg = tiny_test_cfg(), jax_synthetic.tiny_test_cfg()
    if config_file:
        port_cfg = port_config.get_cfg()
        port_cfg.merge_from_file(str(ROOT / config_file))
        cfg = jax_config.get_cfg()
        cfg.merge_from_file(str(ROOT / config_file))
    got = port_synthetic.synthetic_batch(port_cfg, 2, 3, seed=7)
    want = jax_synthetic.synthetic_batch(cfg, 2, 3, seed=7)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = tiny_test_cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeploymentSession(MuvoWorldModel(cfg), cfg)
