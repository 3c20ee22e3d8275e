"""Shared set-up for the PyTorch port's whole-model tests: a muvo_tpu model
at tiny_test_cfg() with seeded random variables, and the port's model
carrying the same weights through muvo_tpu_torch/weights.py.

The variables' shapes come from jax.eval_shape of the model's init (no
compile, no optimizer state) and every leaf is drawn from a numpy seed:
kernels N(0, 1/fan_in), biases, BatchNorm affine parameters and statistics
spread around their neutral values, so that every carried leaf matters.
"""

import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def share_cores_among_workers():
    """Under pytest-xdist, torch's intra-op threads in each worker: the
    cores shared among the workers, at least 2. torch's default, a thread
    for each core in every worker, oversubscribes the cores as many times
    as there are workers, and its OpenMP threads spin while they wait: six
    of the port's test files took 391 s summed with the default and 276 s
    with 2 threads, in 6 workers on 8 cores. Every worker imports this
    module when it collects the port's tests."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(2, (os.cpu_count() or 1) // workers))


share_cores_among_workers()


def import_torch_dynamo():
    """Import torch._dynamo, which torch.utils.checkpoint and torch.optim
    import on first use, with tests/reference_stubs.py's placeholder
    modules set aside. The import registers custom ops whose source lookup
    (inspect.getmodule) asks every module in sys.modules for ``__file__``,
    and the placeholders raise ImportError for any attribute, so in a
    worker that has collected the reference parity tests the first
    checkpoint or optimizer step would fail."""
    stubs = {name: sys.modules.pop(name) for name in ("timm", "open3d", "carla")
             if name in sys.modules}
    try:
        import torch._dynamo  # noqa: F401
    finally:
        sys.modules.update(stubs)


def assert_same(got, want):
    """torch.testing.assert_close with its float32 defaults (rtol 1.3e-6,
    atol 1e-5), in numpy. torch.testing imports torch.distributed on first
    use, which fails in a process where tests/reference_stubs.py has put
    its stub modules into sys.modules, as every worker that collects the
    reference parity tests has."""
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1.3e-6,
                               atol=1e-5)


def close(got, want, tol: float = 1e-4):
    """max |got - want| <= tol * max(1, max |want|), with equal shapes."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def assert_norm_rel(got, want, tol: float = 1e-5):
    """|got - want| / |want| <= tol (Frobenius norms, float64), with equal
    shapes."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= tol, rel


def randn(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def to_torch(a):
    return torch.from_numpy(np.array(a))


def flax_init(module, *args, **kwargs):
    """A flax module's variables from its init, then its biases, scales
    and BatchNorm statistics moved off their neutral values (numpy seed
    1), so that every leaf a port module carries matters."""
    variables = jax.device_get(jax.jit(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs))(*args))
    rs = np.random.RandomState(1)

    def perturb(path, v):
        name = getattr(path[-1], "key", None)
        v = np.asarray(v)
        if name in ("bias", "mean"):
            return v + 0.1 * randn(rs, *v.shape)
        if name == "scale":
            return v * (1.0 + 0.1 * randn(rs, *v.shape))
        if name == "var":
            return rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(perturb, variables)


def load_entries(module, entries, variables, *extra):
    """Load a flax module's variables into the port's module through a
    muvo_tpu_torch.weights ``*_entries`` map; the module in eval mode."""
    from muvo_tpu_torch import weights

    sd = {}
    if "batch_stats" in variables:
        entries(sd, "", variables["params"], variables["batch_stats"], *extra)
    else:
        entries(sd, "", variables["params"], *extra)
    module.load_state_dict(weights.to_tensors(sd), strict=True)
    return module.eval()


def flax_apply(module, variables, *args, **kwargs):
    """module.apply, jitted: one compile is cheaper than eager op dispatch."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables,
                                                                *args)


def randomise(tree, seed: int = 0):
    rs = np.random.RandomState(seed)

    def draw(path, v):
        name = getattr(path[-1], "key", None)
        v = np.asarray(v)
        if name == "kernel":
            fan_in = max(1, int(np.prod(v.shape[:-1])))
            return (rs.randn(*v.shape) / np.sqrt(fan_in)).astype(v.dtype)
        if name in ("constant_tensor", "type_embedding"):
            return rs.randn(*v.shape).astype(v.dtype)
        if name in ("bias", "mean"):
            return (0.1 * rs.randn(*v.shape)).astype(v.dtype)
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*v.shape)).astype(v.dtype)
        if name == "var":
            return rs.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        return v

    return jax.tree_util.tree_map_with_path(draw, tree)


def jax_trainer_and_state(cfg, batch):
    """muvo_tpu trainer, and its variables (params, batch_stats) drawn from
    numpy seeds, which is all muvo_tpu's DeploymentSession reads."""
    from muvo_tpu.parallel.mesh import make_mesh
    from muvo_tpu.training.trainer import WorldModelTrainer

    trainer = WorldModelTrainer(cfg, mesh=make_mesh(n_data=1))
    pb = jax.eval_shape(lambda b: trainer.preprocess(b, training=False),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    pb = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), pb)
    shapes = jax.eval_shape(
        lambda b: trainer.model.init({"params": jax.random.PRNGKey(0)}, b,
                                     training=False,
                                     rng=jax.random.PRNGKey(0)), pb)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    state = SimpleNamespace(params=randomise(zeros["params"], 1),
                            batch_stats=randomise(zeros["batch_stats"], 2))
    return trainer, state


def fp32_cfgs():
    """(muvo_tpu's, the port's) tiny_test_cfg in fp32 without the RSSM's
    posterior dropout."""
    from muvo_tpu.data.synthetic import tiny_test_cfg as jax_tiny_cfg
    from muvo_tpu_torch.data.synthetic import tiny_test_cfg

    jcfg, pcfg = jax_tiny_cfg(), tiny_test_cfg()
    for cfg in (jcfg, pcfg):
        cfg.PRECISION = "32"
        cfg.MODEL.TRANSITION.USE_DROPOUT = False
    return jcfg, pcfg


def deterministic_jax(monkeypatch):
    """muvo_tpu with its Pallas voxel kernels (interpret mode on the CPU),
    sampling at the mean, and no augmentation or dropout: the port's
    ``stochastic=False`` (torch and JAX random streams differ)."""
    from flax import linen as flax_nn
    from muvo_tpu.models.preprocess import PreProcess
    from muvo_tpu.models.rssm import RSSM

    monkeypatch.setenv("MUVO_CONV3D", "pallas")
    monkeypatch.setattr(RSSM, "sample_from_distribution",
                        lambda self, mu, sigma, use_sample, rng: mu)
    monkeypatch.setattr(PreProcess, "augmentation",
                        lambda self, batch, rng: batch)
    monkeypatch.setattr(flax_nn, "Dropout",
                        lambda rate, deterministic=None: (lambda x: x))


def float64_step(port, batch):
    """The losses and gradients of the port trainer's step (no noise or
    dropout) in float64, on a copy of its model: ({"loss", every loss
    term}, {parameter name: gradient})."""
    import copy

    from muvo_tpu_torch.training.objectives import compute_loss, reduce_loss

    model = copy.deepcopy(port.state.model).double().train()
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        pb = port.preprocess(port.to_device(batch), training=False)
        pb = {k: v.double() if v.is_floating_point() else v
              for k, v in pb.items()}
        output, _ = model(pb, training=True, stochastic=False)
        losses = compute_loss(port.cfg, pb, output)
        total = reduce_loss(losses)
        total.backward()
    finally:
        torch.set_default_dtype(default)
    return ({"loss": total.item(), **{k: v.item() for k, v in losses.items()}},
            {n: p.grad for n, p in model.named_parameters()})


def port_model(state, port_cfg):
    """The port's MuvoWorldModel with the JAX state's weights."""
    from muvo_tpu_torch.models.world_model import MuvoWorldModel
    from muvo_tpu_torch.weights import state_dict_from_jax

    model = MuvoWorldModel(port_cfg)
    model.load_state_dict(
        state_dict_from_jax(state.params, state.batch_stats, port_cfg),
        strict=True)
    return model.eval()


def whole_graph(jcfg, pcfg, batch):
    """muvo_tpu's and the port's forward (sampling at the mean, eval mode)
    and compute_loss on the same seeded weights and batch: (port outputs,
    port losses, jax outputs, jax losses, the port's losses on jax's
    outputs)."""
    from muvo_tpu.training.objectives import compute_loss as jax_loss
    from muvo_tpu_torch.models.preprocess import PreProcess
    from muvo_tpu_torch.training.objectives import compute_loss

    mp = pytest.MonkeyPatch()
    try:
        deterministic_jax(mp)
        trainer, state = jax_trainer_and_state(jcfg, batch)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        @jax.jit
        def forward(params, batch_stats, b):
            pb = trainer.preprocess(b, training=False)
            out, _ = trainer.model.apply(
                {"params": params, "batch_stats": batch_stats}, pb,
                training=False)
            return out, jax_loss(jcfg, pb, out)

        want, want_losses = jax.device_get(
            forward(state.params, state.batch_stats, jb))
    finally:
        mp.undo()
    model = port_model(state, pcfg)
    pb = PreProcess(pcfg)({k: torch.from_numpy(v) for k, v in batch.items()},
                          training=False)
    with torch.no_grad():
        got, _ = model(pb, training=False, stochastic=False)
        losses = compute_loss(pcfg, pb, got)
        on_jax = compute_loss(pcfg, pb, {
            k: to_torch(v) for k, v in want.items() if not isinstance(v, dict)
        } | {k: {n: to_torch(t) for n, t in v.items()}
             for k, v in want.items() if isinstance(v, dict)})
    return got, losses, want, want_losses, on_jax


def assert_whole_graph(got, losses, want, want_losses, on_jax):
    keys = [k for k, v in want.items() if not isinstance(v, dict)]
    assert set(keys) <= set(got)
    for key in keys:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, (key, g.shape, w.shape)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert rel <= 1e-3, (key, rel)
    assert set(losses) == set(want_losses)
    for key, w in want_losses.items():
        w = float(w)
        # the port's terms on muvo_tpu's outputs: the same function
        assert abs(float(on_jax[key]) - w) <= 1e-5 * max(1.0, abs(w)), key
        assert abs(float(losses[key]) - w) <= 1e-4 * max(1.0, abs(w)), (
            key, float(losses[key]), w)


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def tiny_argv(**opts):
    """The command line of the port's entry points for tiny_test_cfg: its
    keys that differ from get_cfg()'s, then ``opts`` (dotted keys), each
    as ``KEY repr(value)``."""
    from muvo_tpu_torch.config import get_cfg
    from muvo_tpu_torch.data.synthetic import tiny_test_cfg

    tiny = _flat(tiny_test_cfg().convert_to_dict())
    default = _flat(get_cfg().convert_to_dict())
    argv = []
    for key, value in tiny.items():
        if value != default[key]:
            argv += [key, repr(value)]
    for key, value in opts.items():
        argv += [key, repr(value)]
    return argv


def _recorded_obs(rs, h, w, n_points):
    """One tick of CARLA-like observations for muvo_tpu's DataWriter."""
    masks = (rs.uniform(size=(15, 64, 64)) < 0.2).astype(np.uint8) * 255
    masks[-1] = rs.choice(np.array([0, 80, 170, 255], np.uint8), (64, 64))
    points = rs.uniform(-30, 30, (n_points, 3)).astype(np.float32)
    points[: n_points // 20] *= 0.05  # some inside the ego box
    depth_semantic = rs.randint(0, 255, (h, w, 4), dtype=np.uint8)
    depth_semantic[..., 3] = rs.randint(0, 23, (h, w))  # CARLA's tags
    return {"ego": {
        "central_rgb": {"data": rs.randint(0, 255, (h, w, 3), dtype=np.uint8)},
        "depth_semantic": {"data": depth_semantic},
        "gnss": {"gnss": np.zeros(3), "target_gps": np.zeros(3),
                 "imu": np.zeros(7), "command": np.array([4]),
                 "target_gps_next": np.zeros(3),
                 "command_next": np.array([4])},
        "speed": {"forward_speed": np.array([5.0])},
        "route_plan": None,
        "birdview": {"masks": masks},
        "lidar_points_semantic": {"data": {
            "points_xyz": points,
            "ObjTag": rs.randint(0, 23, n_points).astype(np.uint8),
            "ObjIdx": np.zeros(n_points, np.uint32),
            "CosAngle": np.ones(n_points, np.float32)}},
    }}


def write_recorded_run(run_dir, n_frames, seed, voxel_size=(64, 64, 64),
                       image_hw=(96, 160), n_points=500, reward=1.0):
    """A recorded drive in the CARLA dataset's on-disk layout, written by
    muvo_tpu's DataWriter (as tests/test_data_roundtrip.py does), plus the
    ``voxel_path`` column that the offline tool adds: sparse (K, 4) uint16
    rows (x, y, z, CARLA tag; 255 unlabelled) saved with np.save, as
    tools/generate_voxels.py writes them. Frames, actions, speeds and
    voxels come from ``seed``."""
    import os

    import pandas as pd

    from muvo_tpu.sim.data_writer import DataWriter

    rs = np.random.RandomState(seed)
    run_dir = str(run_dir)
    writer = DataWriter(run_dir, "ego", run_info={"town": "Town01"})
    for t in range(n_frames):
        throttle = float(rs.uniform(-0.5, 1.0))
        sup = {"ego": {
            "action": np.array([max(throttle, 0.0), rs.uniform(-1, 1),
                                max(-throttle, 0.0)], np.float32),
            "action_mu": np.zeros(2, np.float32),
            "action_sigma": np.ones(2, np.float32),
            "value": np.array([rs.uniform(-1, 1)], np.float32),
            "features": np.zeros(4, np.float32),
            "speed": np.array([rs.uniform(0, 10)], np.float32),
        }}
        writer.write({"step": t}, _recorded_obs(rs, *image_hw, n_points),
                     sup, {"ego": float(reward + rs.uniform(-0.05, 0.05))})
    assert writer.close({"traffic_rule_violated": False, "blocked": False,
                         "route_deviation": False}, remove_final_steps=True)
    df_path = os.path.join(run_dir, "pd_dataframe.pkl")
    df = pd.read_pickle(df_path)
    os.makedirs(os.path.join(run_dir, "voxel"), exist_ok=True)
    paths = []
    for t in range(len(df)):
        k = 300
        rows = np.empty((k, 4), np.uint16)
        for axis, size in enumerate(voxel_size):
            rows[:, axis] = rs.randint(0, size, k)
        rows[:, 3] = rs.choice(np.r_[np.arange(23), 255], k)
        path = os.path.join("voxel", f"voxel_{t:09d}.npy")
        np.save(os.path.join(run_dir, path), rows)
        paths.append(path)
    df["voxel_path"] = paths
    df.to_pickle(df_path)
    return df
