"""The port's PointPillarNet against muvo_tpu's on a +-8 m grid (80 x 80
pillars at 5 px/m), 2 frames of 1,000 padded points: some past the grid,
some padding past each frame's count, a dense patch where a pillar holds
many points (so that ReLU zeros tie inside it), and duplicated points
(whose equal features tie at the pillar maximum).

Held: the canvas in eval and in training mode, the running statistics
after the training pass (mask-weighted biased statistics, flax's
momentum-0.9 update), and the gradients of a random projection of the
canvas for every parameter and for the points themselves. jax's
segment_max and torch's scatter_reduce("amax") both split a pillar's
gradient evenly among the points that tie at its maximum; the duplicated
points show it in their gradients. fp32 on both sides, differing in
summation order: 1e-4 * max(1, max |jax|), running statistics 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from muvo_tpu.models.pointpillars import PointPillarNet as JPointPillarNet
from muvo_tpu_torch import weights
from muvo_tpu_torch.models.pointpillars import PointPillarNet
from torch_port_common import close, flax_init, load_entries, to_torch

GRID = dict(min_x=-8.0, max_x=8.0, min_y=-8.0, max_y=8.0)


def _points():
    rs = np.random.RandomState(0)
    pts = rs.uniform(-9.0, 9.0, (2, 1000, 3)).astype(np.float32)
    pts[..., 2] = rs.uniform(-2.0, 3.0, (2, 1000))
    # 300 points a frame in a 1 m square: a dozen to a pillar
    pts[:, :300, :2] = rs.uniform(2.0, 3.0, (2, 300, 2))
    pts[:, 300:350] = pts[:, :50]  # exact duplicates
    num = np.array([900, 1000], np.int32)
    pts[0, 900:] = 0.0  # padding, as the dataset writes it
    return pts, num


@pytest.fixture(scope="module")
def pair():
    pts, num = _points()
    jm = JPointPillarNet(**GRID)
    v = flax_init(jm, pts, num, train=False)
    pm = load_entries(PointPillarNet(**GRID), weights.point_pillars_entries,
                      v)
    return jm, v, pm, pts, num


def test_canvas_in_eval_mode(pair):
    jm, v, pm, pts, num = pair
    want = jax.jit(lambda v, p, n: jm.apply(v, p, n, False))(v, pts, num)
    with torch.no_grad():
        got = pm.eval()(to_torch(pts), to_torch(num))
    assert got.shape == (2, 80, 80, 32)
    close(got, want)
    # empty pillars are 0, and the dense patch fills a few
    assert 0 < (got.abs().sum(-1) > 0).float().mean() < 0.5


def test_training_pass_and_running_statistics(pair):
    jm, v, pm, pts, num = pair
    want, updated = jax.jit(lambda v, p, n: jm.apply(
        v, p, n, True, mutable=["batch_stats"]))(v, pts, num)
    fresh = PointPillarNet(**GRID)
    fresh.load_state_dict(pm.state_dict())
    with torch.no_grad():
        got = fresh.train()(to_torch(pts), to_torch(num))
    close(got, want)
    sd = {}
    weights.point_pillars_entries(sd, "", v["params"],
                                  jax.device_get(updated["batch_stats"]))
    state = fresh.state_dict()
    for key, w in weights.running_stats(weights.to_tensors(sd)).items():
        close(state[key], w.numpy(), 1e-5)


def test_gradients_with_ties_at_the_pillar_maximum(pair):
    jm, v, pm, pts, num = pair
    cot = np.random.RandomState(1).randn(2, 80, 80, 32).astype(np.float32)

    def loss(params, p):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, p, num, True,
                          mutable=["batch_stats"])
        return (out * cot).sum()

    g_params, g_points = jax.device_get(
        jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], pts))

    model = PointPillarNet(**GRID)
    model.load_state_dict(pm.state_dict())
    x = to_torch(pts.copy()).requires_grad_(True)
    (model.train()(x, to_torch(num)) * to_torch(cot)).sum().backward()

    want = {}
    weights.point_pillars_entries(want, "", g_params, weights._NoStats())
    for name, p in model.named_parameters():
        close(p.grad, want[name])
    close(x.grad, g_points)
    # the duplicated points share their pillar's gradient evenly
    np.testing.assert_allclose(x.grad[:, 300:350].numpy(),
                               x.grad[:, :50].numpy(), rtol=1e-6, atol=1e-7)
    # padding takes none
    assert not x.grad[0, 900:].abs().sum()
