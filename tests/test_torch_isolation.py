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
from muvo_tpu import constants as jax_constants
from muvo_tpu.data import synthetic as jax_synthetic
from muvo_tpu_torch import config as port_config
from muvo_tpu_torch import constants as port_constants
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


_IMPORT_NEW = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "muvo_tpu"))
print(leaked)
sys.exit(1 if leaked else 0)
"""

# the data-parallel and PPO modules, the closed loop's and collection's
# entry points, the offline and health-run tools, and the sim/ copies
# they run on
NEW_MODULES = ("muvo_tpu_torch.parallel.mesh", "muvo_tpu_torch.rl.agent",
               "muvo_tpu_torch.rl.distributions",
               "muvo_tpu_torch.rl.networks", "muvo_tpu_torch.rl.policy",
               "muvo_tpu_torch.rl.ppo", "muvo_tpu_torch.train_rl",
               "muvo_tpu_torch.sim.reward",
               "muvo_tpu_torch.sim.kinematic_env",
               "muvo_tpu_torch.agents.muvo_agent", "muvo_tpu_torch.evaluate",
               "muvo_tpu_torch.data_collect",
               "muvo_tpu_torch.tools.generate_voxels",
               "muvo_tpu_torch.tools.preprocess_pcd",
               "muvo_tpu_torch.tools.health_run",
               "muvo_tpu_torch.tools.profile_step",
               "muvo_tpu_torch.tools.e2e_pipeline_demo",
               "muvo_tpu_torch.tools.generate_scenarios",
               "muvo_tpu_torch.sim.agents", "muvo_tpu_torch.sim.birdview",
               "muvo_tpu_torch.sim.carla_map_adapter",
               "muvo_tpu_torch.sim.data_writer", "muvo_tpu_torch.sim.env",
               "muvo_tpu_torch.sim.envs", "muvo_tpu_torch.sim.handlers",
               "muvo_tpu_torch.sim.hazard",
               "muvo_tpu_torch.sim.route_planner",
               "muvo_tpu_torch.sim.server_utils",
               "muvo_tpu_torch.sim.task_vehicle",
               "muvo_tpu_torch.sim.traffic_light",
               "muvo_tpu_torch.sim.weather")


def test_parallel_rl_and_sim_modules_load_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_NEW, *NEW_MODULES],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kinematic_env_is_muvo_tpus_but_for_its_imports():
    got = (ROOT / "muvo_tpu_torch/sim/kinematic_env.py").read_text()
    want = (ROOT / "muvo_tpu/sim/kinematic_env.py").read_text().replace(
        "from muvo_tpu.constants import", "from muvo_tpu_torch.constants import"
    ).replace("from muvo_tpu.sim.reward import",
              "from muvo_tpu_torch.sim.reward import")
    assert got == want


SIM_COPIES = sorted(
    str(f.relative_to(ROOT / "muvo_tpu"))
    for f in (ROOT / "muvo_tpu" / "sim").rglob("*.py")
    if f.relative_to(ROOT / "muvo_tpu" / "sim").as_posix() not in (
        "__init__.py", "reward.py", "kinematic_env.py"))
# the copies' differences from muvo_tpu's files beyond the package's name:
# the route planner imports networkx where it plans, not at import, since
# sim.agents (and so data.dataset_utils.preprocess_measurements) needs
# only its RoadOption and the GPU machine has no networkx; the envs
# register under the port's own gymnasium namespace.
LAZY_NETWORKX = (
    ("import numpy as np\nimport networkx as nx\n", "import numpy as np\n"),
    ("        self.resolution = resolution\n        self._graph",
     "        self.resolution = resolution\n        import networkx as nx"
     "  # only the planner needs it, not RoadOption\n\n        self._graph"),
    ("        end = self._localize(destination)\n        route = nx",
     "        end = self._localize(destination)\n        import networkx as nx"
     "\n\n        route = nx"),
)


def _without_register_envs(text):
    return text[:text.index("\n\n\n", text.index("        return all_tasks"))]


@pytest.mark.parametrize("name", SIM_COPIES)
def test_sim_copy_is_muvo_tpus_but_for_its_package(name):
    """Each sim/ copy is muvo_tpu's file with ``muvo_tpu.`` read as
    ``muvo_tpu_torch.``, but for the differences named above."""
    got = (ROOT / "muvo_tpu_torch" / name).read_text()
    want = (ROOT / "muvo_tpu" / name).read_text().replace("muvo_tpu.",
                                                          "muvo_tpu_torch.")
    if name == "sim/route_planner.py":
        for old, new in LAZY_NETWORKX:
            assert want.count(old) == 1, old
            want = want.replace(old, new)
    if name == "sim/envs.py":
        got, want = _without_register_envs(got), _without_register_envs(want)
    assert got == want


def test_envs_register_in_the_ports_namespace():
    """envs.py's one other difference: its register_envs."""
    from muvo_tpu_torch.sim import envs

    tail = (ROOT / "muvo_tpu_torch/sim/envs.py").read_text()[
        len(_without_register_envs(
            (ROOT / "muvo_tpu_torch/sim/envs.py").read_text())):]
    assert "gym.register(id=gym_id(env_id)" in tail
    assert envs.gym_id("Endless-v0") == "muvo_tpu_torch/Endless-v0"


@pytest.mark.parametrize("name", sorted(
    [str(f.relative_to(ROOT / "muvo_tpu"))
     for f in (ROOT / "muvo_tpu/sim/scenario_descriptions").rglob("*")
     if f.is_file()]
    + [str(f.relative_to(ROOT / "muvo_tpu"))
       for f in (ROOT / "muvo_tpu/configs/collect").rglob("*.yml")]))
def test_sim_data_and_collect_configs_are_muvo_tpus(name):
    assert (ROOT / "muvo_tpu_torch" / name).read_bytes() == (
        ROOT / "muvo_tpu" / name).read_bytes()


def test_ports_sim_data_is_complete():
    for sub in ("sim/scenario_descriptions", "configs/collect"):
        names = {f.relative_to(ROOT / "muvo_tpu_torch" / sub)
                 for f in (ROOT / "muvo_tpu_torch" / sub).rglob("*")
                 if f.is_file()}
        assert names == {f.relative_to(ROOT / "muvo_tpu" / sub)
                         for f in (ROOT / "muvo_tpu" / sub).rglob("*")
                         if f.is_file()}


_NO_NETWORKX = """
import sys
sys.modules["networkx"] = None  # as on a machine without it
import numpy as np
from muvo_tpu_torch.data.dataset_utils import preprocess_measurements
import muvo_tpu_torch.data_collect, muvo_tpu_torch.evaluate
import muvo_tpu_torch.sim.data_writer, muvo_tpu_torch.tools.generate_voxels
print(preprocess_measurements(np.array([2]), np.zeros(3),
                              np.array([1e-4, 0.0, 0.0]), np.zeros(7)))
"""


def test_measurements_and_entry_points_need_no_networkx():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _NO_NETWORKX], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_dataset_utils_is_muvo_tpus():
    got = (ROOT / "muvo_tpu_torch/data/dataset_utils.py").read_text()
    want = (ROOT / "muvo_tpu/data/dataset_utils.py").read_text().replace(
        "muvo_tpu.", "muvo_tpu_torch.")
    note = "An own copy of muvo_tpu/data/dataset_utils.py (a test holds it equal).\n"
    assert got == want.replace("\n\nSemantics match", "\n\n" + note
                               + "Semantics match", 1)


@pytest.mark.parametrize("name", ["CARLA_FPS", "WHEEL_BASE",
                                  "SEMANTIC_SEG_WEIGHTS",
                                  "VOXEL_SEG_WEIGHTS",
                                  "EGO_VEHICLE_DIMENSION",
                                  "BIRDVIEW_COLOURS", "VOXEL_COLOURS"])
def test_constants_equal_muvo_tpus(name):
    got, want = getattr(port_constants, name), getattr(jax_constants, name)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype


def test_label_remap_table_equals_muvo_tpus():
    assert port_constants.LABEL_MAP == jax_constants.LABEL_MAP
    got, want = (port_constants.label_remap_table(),
                 jax_constants.label_remap_table())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("copy,original", [
    ("muvo_tpu_torch/native/range_view.cpp", "muvo_tpu/native/range_view.cpp"),
    ("muvo_tpu_torch/utils/hostmem.py", "muvo_tpu/utils/hostmem.py"),
    ("muvo_tpu_torch/geometry/icp.py", "muvo_tpu/geometry/icp.py"),
    ("muvo_tpu_torch/sim/reward.py", "muvo_tpu/sim/reward.py"),
])
def test_host_sources_are_muvo_tpus(copy, original):
    assert (ROOT / copy).read_bytes() == (ROOT / original).read_bytes()


def test_visualisation_is_muvo_tpus_but_for_its_imports():
    """The panel helpers are muvo_tpu's, line for line, but for the
    constants' import and the 3-D voxel render's one rescale of the view
    (the same pixels: tests/test_torch_visualise.py)."""
    got = (ROOT / "muvo_tpu_torch/visualisation.py").read_text()
    want = (ROOT / "muvo_tpu/visualisation.py").read_text()
    one_rescale = """    # ax.voxels adds one collection a voxel and rescales the view after
    # each, over every collection so far: quadratic in the voxels. The view
    # is rescaled once, over the same data limits, after the last.
    ax.autoscale_view = lambda *args, **kwargs: None
    ax.voxels(occupancy, facecolors=facecolors, shade=False)
    del ax.autoscale_view
    ax.autoscale_view()
"""
    want = want.replace(
        "from muvo_tpu.constants import", "from muvo_tpu_torch.constants import"
    ).replace("    ax.voxels(occupancy, facecolors=facecolors, shade=False)\n",
              one_rescale)
    assert got == want


def test_native_library_builds_under_build_dir():
    from muvo_tpu_torch import native

    assert native.available()
    lib = native.library_path()
    assert lib.parent == ROOT / "build" / "muvo_tpu_torch"
    assert lib.is_file()
    assert not list((ROOT / "muvo_tpu_torch" / "native").glob("*.so"))


CONFIGS = ("muvo.yml", "test_base_1d.yml", "test_base_1d_without_voxel.yml",
           "test_base_2d.yml", "test_mobilevit_2d.yml", "one_frame.yml",
           "debug.yml")


@pytest.mark.parametrize("name", CONFIGS)
def test_muvo_yml_is_muvo_tpus(name):
    assert (ROOT / "muvo_tpu_torch/configs" / name).read_bytes() == (
        ROOT / "muvo_tpu/configs" / name).read_bytes()


def _config(name):
    cfg = port_config.get_cfg()
    cfg.merge_from_file(str(ROOT / "muvo_tpu_torch/configs" / name))
    return cfg


@pytest.mark.parametrize("name", ["test_base_1d.yml",
                                  "test_base_1d_without_voxel.yml",
                                  "test_base_2d.yml", "test_mobilevit_2d.yml"])
def test_released_eval_configs_build_a_model(name):
    cfg = _config(name)
    with torch.device("meta"):  # the full-width graph, no weights drawn
        model = MuvoWorldModel(cfg)
    assert ("voxel_decoder" in model.decoder_names) == cfg.VOXEL_SEG.ENABLED
    trunk = type(model.encoder).__name__
    assert trunk == ("MobileViTV2Features" if "mobilevit" in name
                     else "ResNetFeatures")


def test_one_frame_yml_names_what_is_not_ported():
    """one_frame.yml (the default config's MILE branch without the RSSM)
    builds, also with measurements; the port names what it still
    refuses: the transformer branch without LiDAR, which muvo_tpu cannot
    run either."""
    model = MuvoWorldModel(_config("one_frame.yml"))
    assert model.rssm is None and not model.fusion and model.lifting
    cfg = _config("one_frame.yml")
    cfg.MODEL.MEASUREMENTS.ENABLED = True
    with torch.device("meta"):
        model = MuvoWorldModel(cfg)
    assert model.measurements and model.gps_encoder[0].in_features == 4
    cfg = _config("muvo.yml")
    cfg.MODEL.LIDAR.ENABLED = False
    with pytest.raises(NotImplementedError) as raised:
        MuvoWorldModel(cfg)
    assert "without LiDAR" in str(raised.value)
    assert "muvo_tpu cannot run it either" in str(raised.value)


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
