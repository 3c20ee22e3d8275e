"""The port's closed-loop evaluation entry point (muvo_tpu_torch/evaluate.py)
on the CPU: build_agent from a port checkpoint directory and from a
weights file (the upstream ``model.`` keys), the suite-index checkpoint
and exit-1 restart contract with gym.make patched to a kinematic env, and
train_rl --env carla raising the CARLA env's own ImportError. At
tests/test_evaluate.py's size: tiny_test_cfg in fp32 with one transformer
layer and 32 decoder channels (35 M parameters, 142 MB a checkpoint).
"""

import json
import sys

import numpy as np
import pytest
import torch

from muvo_tpu_torch import evaluate, train_rl
from muvo_tpu_torch.config import get_cfg, get_parser
from muvo_tpu_torch.sim.kinematic_env import KinematicDrivingEnv
from muvo_tpu_torch.training.checkpoint import CheckpointManager
from muvo_tpu_torch.training.trainer import WorldModelTrainer
from torch_port_common import import_torch_dynamo, tiny_argv

import_torch_dynamo()  # the trainer's optimizer imports it

SMALL = {"PRECISION": "32", "MODEL.TRANSFORMER.N_LAYERS": 1,
         "MODEL.TRANSFORMER.DIM_FEEDFORWARD": 64,
         "MODEL.DECODER_BASE_CHANNELS": 32}


def _cfg():
    return get_cfg(get_parser().parse_args(tiny_argv(**SMALL)))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A port checkpoint directory at step 7 and a Lightning-style weights
    file of the same model, weights from seed 3 (not build_agent's own)."""
    root = tmp_path_factory.mktemp("evaluate")
    cfg = _cfg()
    trainer = WorldModelTrainer(cfg, device="cpu")
    state = trainer.init_state(seed=3)
    CheckpointManager(str(root / "checkpoints")).save(7, state)
    weights = {k: v.clone() for k, v in state.model.state_dict().items()}
    torch.save({"state_dict": {f"model.{k}": v for k, v in weights.items()}},
               root / "upstream.ckpt")
    return cfg, root, weights


def _assert_holds(agent, weights):
    got = agent.session.model.state_dict()
    assert set(got) == set(weights)
    for key, want in weights.items():
        assert torch.equal(got[key], want), key


@pytest.mark.parametrize("ckpt", ["checkpoints", "upstream.ckpt"])
def test_build_agent_restores_the_weights(saved, ckpt):
    cfg, root, weights = saved
    agent = evaluate.build_agent(cfg, str(root / ckpt), is_dreaming=True,
                                 device="cpu")
    _assert_holds(agent, weights)
    assert agent.is_dreaming and agent.session.device == torch.device("cpu")
    env = KinematicDrivingEnv(seed=2, episode_steps=3, image_hw=(96, 160))
    stat, event = evaluate.run_episode(env, agent, max_steps=5)
    assert stat == {"score_route": stat["score_route"], "length": 3}
    assert event == {}
    assert np.isfinite(agent.supervision_dict["action"]).all()


def test_build_agent_without_a_checkpoint_is_seeded(saved):
    cfg, _, weights = saved
    a = evaluate.build_agent(cfg, "", is_dreaming=False, device="cpu")
    b = evaluate.build_agent(cfg, "", is_dreaming=False, device="cpu")
    initial = a.session.model.state_dict()
    _assert_holds(b, initial)  # the same seed, the same weights
    assert any(not torch.equal(initial[k], w) for k, w in weights.items())
    with pytest.raises(FileNotFoundError):
        evaluate.build_agent(cfg, "/nonexistent/weights", False,
                             device="cpu")


class KinematicSuiteEnv(KinematicDrivingEnv):
    """A kinematic env with the suite env's task interface: two tasks of
    one tick each."""
    num_tasks = 2

    def __init__(self):
        super().__init__(seed=0, episode_steps=1, image_hw=(96, 160))
        self.unwrapped = self
        self.tasks = []

    def set_task_idx(self, i):
        self.tasks.append(i)

    def close(self):
        pass


def test_restart_protocol_checkpointing(tmp_path, monkeypatch):
    """One lb_test suite env an invocation: each task's episode statistics
    into port_2000_eval_<suite>.json, the next suite index into
    port_2000_eval_checkpoint.txt, exit 1 while suites remain, 0 after the
    last, and 0 without an env once all are done."""
    import gymnasium as gym

    calls = []

    def fake_make(env_id, **kwargs):
        calls.append((env_id, kwargs["carla_map"],
                      kwargs["terminal_configs"]["hero"]["entry_point"]))
        return KinematicSuiteEnv()

    monkeypatch.setattr(gym, "make", fake_make)
    argv = ["--work-dir", str(tmp_path), "--max-steps", "5",
            *tiny_argv(**SMALL)]
    rc_seen = []
    for _ in range(7):
        try:
            rc = evaluate.main(argv, device="cpu") or 0
        except SystemExit as e:
            rc = e.code
        rc_seen.append(rc)
        if rc == 0:
            break
    assert rc_seen == [1, 1, 1, 1, 1, 0]
    assert [c[0] for c in calls] == ["muvo_tpu_torch/LeaderBoard-v0"] * 6
    assert {c[2] for c in calls} == {
        "muvo_tpu_torch.sim.reward:LeaderboardTerminal"}
    assert (tmp_path / "port_2000_eval_checkpoint.txt").read_text() == "6"
    for suite, (_, town, _) in enumerate(calls):
        records = json.loads(
            (tmp_path / f"port_2000_eval_{suite}.json").read_text())
        assert [(r["suite"], r["task"], r["map"], r["length"])
                for r in records] == [(suite, 0, town, 1), (suite, 1, town, 1)]
    assert evaluate.main(argv, device="cpu") == 0 and len(calls) == 6


def test_train_rl_carla_raises_the_envs_import_error(monkeypatch):
    """Without the carla package (also where tests/reference_stubs.py
    put a placeholder in its place) --env carla builds the port's
    EndlessEnv, which raises its own ImportError."""
    monkeypatch.setitem(sys.modules, "carla", None)
    with pytest.raises(ImportError,
                       match="CarlaMultiAgentEnv requires the carla package"):
        train_rl.main(["--env", "carla", "--carla-map", "Town02"],
                      device="cpu")
