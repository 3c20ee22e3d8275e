"""Shared set-up for the PyTorch port's whole-model tests: a muvo_tpu model
at tiny_test_cfg() with seeded random variables, and the port's model
carrying the same weights through muvo_tpu_torch/weights.py.

The variables' shapes come from jax.eval_shape of the model's init (no
compile, no optimizer state) and every leaf is drawn from a numpy seed:
kernels N(0, 1/fan_in), biases, BatchNorm affine parameters and statistics
spread around their neutral values, so that every carried leaf matters.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np


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


def port_model(state, port_cfg):
    """The port's MuvoWorldModel with the JAX state's weights."""
    from muvo_tpu_torch.models.world_model import MuvoWorldModel
    from muvo_tpu_torch.weights import state_dict_from_jax

    model = MuvoWorldModel(port_cfg)
    model.load_state_dict(
        state_dict_from_jax(state.params, state.batch_stats, port_cfg),
        strict=True)
    return model.eval()
