"""Shared set-up for the PyTorch port's whole-model tests: a muvo_tpu model
at tiny_test_cfg() with seeded random variables, and the port's model
carrying the same weights through muvo_tpu_torch/weights.py.

The variables' shapes come from jax.eval_shape of the model's init (no
compile, no optimizer state) and every leaf is drawn from a numpy seed:
kernels N(0, 1/fan_in), biases, BatchNorm affine parameters and statistics
spread around their neutral values, so that every carried leaf matters.
"""

import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np


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


def port_model(state, port_cfg):
    """The port's MuvoWorldModel with the JAX state's weights."""
    from muvo_tpu_torch.models.world_model import MuvoWorldModel
    from muvo_tpu_torch.weights import state_dict_from_jax

    model = MuvoWorldModel(port_cfg)
    model.load_state_dict(
        state_dict_from_jax(state.params, state.batch_stats, port_cfg),
        strict=True)
    return model.eval()
