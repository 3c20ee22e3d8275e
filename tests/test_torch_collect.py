"""The port's collection entry point (muvo_tpu_torch/data_collect.py, on
its own sim/ copies) against the root data_collect.py and muvo_tpu's sim/:
the shipped obs and suite configs, the LeaderBoard tasks built from the
shipped scenario data, one kinematic episode collected by both packages'
experts with the same weights (the dataframe and every PNG and point file
equal, the float columns within 1e-5: the two policies' fp32 forwards
round apart), the restart protocol, and which env class each package's
entry points build when both packages have registered their gymnasium
envs, in either order. Nothing needs a CARLA server.
"""

import os
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from muvo_tpu.data.dataset import CarlaDataset as JaxDataset
from muvo_tpu.data.synthetic import tiny_test_cfg as jax_tiny_cfg
from muvo_tpu.rl.agent import RlBirdviewAgent as JaxExpert
from muvo_tpu.rl.agent import process_obs
from muvo_tpu.rl.policy import PpoPolicy as JaxPolicy
from muvo_tpu.sim import data_writer as jax_data_writer
from muvo_tpu.sim import env as jax_env
from muvo_tpu.sim import envs as jax_envs
from muvo_tpu_torch import data_collect, evaluate, train_rl
from muvo_tpu_torch.data.dataset import CarlaDataset
from muvo_tpu_torch.data.synthetic import tiny_test_cfg
from muvo_tpu_torch.sim import data_writer
from muvo_tpu_torch.sim import env as port_env
from muvo_tpu_torch.sim import envs as port_envs
from muvo_tpu_torch.sim.kinematic_env import KinematicDrivingEnv

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import data_collect as jax_collect  # noqa: E402

FLOAT_TOL = 1e-5


def test_obs_configs_equal_muvo_tpus():
    assert data_collect.load_obs_configs() == jax_collect.load_obs_configs()
    assert data_collect.load_obs_configs("ego") == (
        jax_collect.load_obs_configs("ego"))


@pytest.mark.parametrize("name", ["lb_data", "lb_test"])
def test_test_suites_equal_muvo_tpus(name):
    assert data_collect.load_test_suites(name) == (
        jax_collect.load_test_suites(name))
    path = ROOT / "muvo_tpu_torch/configs/collect/test_suites" / f"{name}.yml"
    assert data_collect.load_test_suites(str(path)) == (
        jax_collect.load_test_suites(name))


@pytest.mark.parametrize("town,split", [("Town01", None), ("Town02", None),
                                        ("Town04", "train"),
                                        ("Town04", "test")])
def test_leaderboard_tasks_equal_muvo_tpus(town, split):
    """The same tasks, each read from the package's own copy of the
    scenario descriptions."""
    def relative(tasks, envs):
        for task in tasks:
            folder = Path(task.pop("description_folder"))
            task["folder"] = folder.relative_to(envs.SCENARIO_ROOT)
        return tasks

    for weather in ("new", "simple"):
        args = (town, weather) + ((split,) if split else ())
        got = relative(port_envs.LeaderboardEnv.build_all_tasks(*args),
                       port_envs)
        assert got and got == relative(
            jax_envs.LeaderboardEnv.build_all_tasks(*args), jax_envs)
    assert port_envs.SCENARIO_ROOT == str(
        ROOT / "muvo_tpu_torch/sim/scenario_descriptions")


# ---- one kinematic episode collected by both packages -------------------
def _env():
    return KinematicDrivingEnv(seed=3, episode_steps=10, image_hw=(96, 160))


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    """The same episode collected by muvo_tpu's expert and writer and by
    the port's, the port's expert loaded from a pickle of muvo_tpu's
    PpoPolicy params (root train_rl.py's --out)."""
    root = tmp_path_factory.mktemp("collect")
    obs = _env().reset()
    pi = process_obs(obs["hero"], ["control", "vel_xy"], train=False)
    policy = JaxPolicy()
    params = jax.device_get(policy.init(
        jax.random.PRNGKey(0), jnp.asarray(pi["birdview"]),
        jnp.asarray(pi["state"]), jax.random.PRNGKey(1)))
    with open(root / "ppo_params.pkl", "wb") as f:
        pickle.dump(params, f)
    experts = {"jax": JaxExpert(policy, params),
               "port": data_collect.load_expert(str(root / "ppo_params.pkl"),
                                                device="cpu")}
    writers = {"jax": jax_data_writer.DataWriter,
               "port": data_writer.DataWriter}
    collect = {"jax": jax_collect.run_episode,
               "port": data_collect.run_episode}
    out = {}
    for name in ("jax", "port"):
        run = root / name / "trainval" / "train" / "Town01" / "0000"
        writer = writers[name](str(run), "hero", run_info={"town": "Town01"})
        out[name] = (root / name, run,
                     collect[name](_env(), experts[name], writer, 15))
    return out


def _is_float(value):
    return np.asarray(value).dtype.kind == "f"


def test_collected_episode_is_muvo_tpus(drives):
    import pandas as pd

    (_, jax_run, jax_result), (_, port_run, port_result) = (drives["jax"],
                                                            drives["port"])
    assert jax_result[0] and port_result[0]  # both valid
    assert port_result[1] == jax_result[1]
    assert abs(port_result[2] - jax_result[2]) <= FLOAT_TOL
    got = pd.read_pickle(port_run / "pd_dataframe.pkl")
    want = pd.read_pickle(jax_run / "pd_dataframe.pkl")
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    assert len(want) == 10
    for column in want.columns:
        for g, w in zip(got[column], want[column]):
            if _is_float(w):
                g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
                assert g.shape == w.shape, column
                assert np.abs(g - w).max() <= FLOAT_TOL, column
            else:
                assert np.array_equal(np.asarray(g), np.asarray(w)), column
    actions = np.stack(got["action"])
    assert actions.shape == (10, 3) and np.isfinite(actions).all()
    files = sorted(p.relative_to(jax_run) for p in jax_run.rglob("*")
                   if p.is_file() and p.name != "pd_dataframe.pkl")
    assert files == sorted(p.relative_to(port_run) for p in port_run.rglob("*")
                           if p.is_file() and p.name != "pd_dataframe.pkl")
    assert sum(p.suffix == ".png" for p in files) == 40  # 4 kinds x 10
    for path in files:
        if path.suffix == ".png":
            assert (port_run / path).read_bytes() == (
                jax_run / path).read_bytes(), path
        else:  # the LiDAR frames: pickled dicts of arrays
            g = np.load(port_run / path, allow_pickle=True).item()
            w = np.load(jax_run / path, allow_pickle=True).item()
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])


def test_datasets_read_the_same_batch(drives):
    cfgs = []
    for cfg in (jax_tiny_cfg(), tiny_test_cfg()):
        cfg.VOXEL_SEG.ENABLED = False
        cfg.SEMANTIC_SEG.ENABLED = False
        cfg.DATASET.FILTER_BEGINNING_OF_RUN_SEC = 0.0
        cfg.DATASET.FILTER_NORM_REWARD = -100.0
        cfgs.append(cfg)
    want_ds = JaxDataset(cfgs[0], mode="train", sequence_length=2,
                         dataset_root=str(drives["jax"][0]))
    got_ds = CarlaDataset(cfgs[1], mode="train", sequence_length=2,
                          dataset_root=str(drives["port"][0]))
    assert len(got_ds) == len(want_ds) > 0
    for i in (0, len(want_ds) - 1):
        got, want = got_ds[i], want_ds[i]
        assert set(got) == set(want)
        assert got["image"].shape == (2, 96, 160, 3)
        for key, w in want.items():
            assert got[key].dtype == w.dtype, key
            if _is_float(w):
                np.testing.assert_allclose(got[key], w, rtol=0,
                                           atol=FLOAT_TOL, err_msg=key)
            else:
                np.testing.assert_array_equal(got[key], w, err_msg=key)


# ---- the restart protocol -----------------------------------------------
class KinematicShim(KinematicDrivingEnv):
    """A kinematic env with the suite env's task interface."""
    num_tasks = 1
    task = {"weather": "ClearNoon", "num_zombie_vehicles": 0,
            "num_zombie_walkers": 0, "route_id": 0}

    def __init__(self):
        super().__init__(seed=0, episode_steps=8, image_hw=(96, 160))
        self.unwrapped = self

    def set_task_idx(self, i):
        pass

    def close(self):
        pass


def test_restart_protocol_checkpointing(tmp_path, monkeypatch):
    """Suite-index checkpoint and the exit-code-1 restart contract
    (reference data_collect.py:292-297), as tests/test_data_collect.py
    holds muvo_tpu's: gym.make patched to a kinematic env, main run
    through all 4 lb_data suites, then once more after the last."""
    import gymnasium as gym

    calls = []

    def fake_make(env_id, **kwargs):
        calls.append((env_id, kwargs.get("carla_map")))
        return KinematicShim()

    monkeypatch.setattr(gym, "make", fake_make)
    argv = ["--dataset-root", str(tmp_path / "ds"), "--n-episodes", "4",
            "--max-steps", "12", "--work-dir", str(tmp_path)]
    rc_seen = []
    for _ in range(5):
        try:
            rc = data_collect.main(argv, device="cpu") or 0
        except SystemExit as e:
            rc = e.code
        rc_seen.append(rc)
        if rc == 0:
            break
    assert rc_seen == [1, 1, 1, 0]
    assert [c[1] for c in calls] == ["Town01", "Town03", "Town04", "Town06"]
    assert {c[0] for c in calls} == {"muvo_tpu_torch/Endless-v0"}
    assert (tmp_path / "port_2000_checkpoint.txt").read_text().strip() == "4"
    runs = sorted((tmp_path / "ds" / "trainval" / "train").glob("*/*"))
    assert [r.name for r in runs] == ["0000", "0001", "0002", "0003"]
    assert all((r / "pd_dataframe.pkl").is_file() for r in runs)
    # a finished collection returns 0 without building an env
    assert data_collect.main(argv, device="cpu") == 0 and len(calls) == 4


# ---- the gymnasium registration clash -----------------------------------
class Built(Exception):
    """Raised where an env would connect to CARLA: carries its class."""


def _entry_points(tmp_path, monkeypatch):
    """{entry point: the module of the env class it built}."""
    import evaluate as jax_evaluate
    import train_rl as jax_train_rl

    def refuse(self, *args, **kwargs):
        raise Built(type(self).__module__ + ":" + type(self).__name__)

    for module in (jax_env, port_env):
        monkeypatch.setattr(module.CarlaMultiAgentEnv, "_init_client", refuse)
    work = ["--work-dir", str(tmp_path)]
    port = {
        "muvo_tpu_torch.data_collect": lambda: data_collect.main(
            ["--dataset-root", str(tmp_path)] + work, device="cpu"),
        "muvo_tpu_torch.evaluate": lambda: evaluate.main(work, device="cpu"),
        "muvo_tpu_torch.train_rl --env carla": lambda: train_rl.main(
            ["--env", "carla"], device="cpu"),
    }
    root = {
        "data_collect.py": (jax_collect.main,
                            ["--dataset-root", str(tmp_path)] + work),
        "evaluate.py": (jax_evaluate.main, work),
        "train_rl.py --env carla": (jax_train_rl.main, ["--env", "carla"]),
    }
    built = {}
    for name, call in port.items():
        with pytest.raises(Built) as raised:
            call()
        built[name] = str(raised.value)
    for name, (main, argv) in root.items():
        monkeypatch.setattr(sys, "argv", [name.split()[0]] + argv)
        with pytest.raises(Built) as raised:
            main()
        built[name] = str(raised.value)
    return built


@pytest.mark.parametrize("order", ["muvo_tpu_first", "port_first"])
def test_each_package_builds_its_own_envs(tmp_path, monkeypatch, order):
    """Both packages register 'Endless-v0' and 'LeaderBoard-v0' suites in
    one process, in either order (a second gymnasium registration of an id
    replaces the first): the port's entry points build the port's classes,
    muvo_tpu's build muvo_tpu's."""
    import gymnasium as gym

    registry = dict(gym.registry)
    try:
        first, second = (jax_envs, port_envs) if order == "muvo_tpu_first" \
            else (port_envs, jax_envs)
        first.register_envs()
        second.register_envs()
        built = _entry_points(tmp_path, monkeypatch)
    finally:
        gym.registry.clear()
        gym.registry.update(registry)
    assert built == {
        "muvo_tpu_torch.data_collect": "muvo_tpu_torch.sim.envs:EndlessEnv",
        "muvo_tpu_torch.evaluate": "muvo_tpu_torch.sim.envs:LeaderboardEnv",
        "muvo_tpu_torch.train_rl --env carla":
            "muvo_tpu_torch.sim.envs:EndlessEnv",
        "data_collect.py": "muvo_tpu.sim.envs:EndlessEnv",
        "evaluate.py": "muvo_tpu.sim.envs:LeaderboardEnv",
        "train_rl.py --env carla": "muvo_tpu.sim.envs:EndlessEnv",
    }
    assert os.listdir(tmp_path) == []  # no env got as far as a checkpoint
