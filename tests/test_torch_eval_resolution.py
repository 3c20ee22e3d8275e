"""EVAL.RESOLUTION in the port's PreProcess against muvo_tpu's: FACTOR 2
on a batch that carries ``semantic_image`` (int32) and
``image_instance_mask`` (bool), with the RGB, semantic-image and
RGB-instance label pyramids on; and where muvo_tpu stops with it.

muvo_tpu resizes the cropped image and both per-pixel labels with its
linear resize and returns the integer and boolean keys in float32; it
scales the intrinsics' first two rows and leaves ``depth`` at the crop's
size. Its decoders size their outputs from IMAGE.CROP, so the RGB loss
compares a crop-sized output with a half-sized label and fails; the
forward itself runs. The port runs the same forward and refuses the same
loss with a ValueError that names the sizes.

Tolerance: every float key within 1e-5 norm-relative (the resize's and
the bilinear pyramids' summation order; elsewhere XLA's product with a
constant's reciprocal where the port divides), the integer and boolean
keys and every dtype equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.data.synthetic import tiny_test_cfg as jax_tiny_cfg
from muvo_tpu.models.preprocess import PreProcess as JaxPreProcess
from muvo_tpu.training.objectives import compute_loss as jax_loss
from muvo_tpu_torch.data.synthetic import synthetic_batch, tiny_test_cfg
from muvo_tpu_torch.inference import DeploymentSession
from muvo_tpu_torch.models.preprocess import PreProcess
from muvo_tpu_torch.models.world_model import MuvoWorldModel
from muvo_tpu_torch.training.objectives import compute_loss
from torch_port_common import assert_norm_rel

RESIZED = ("image", "image_instance_mask", "semantic_image")


def _cfgs():
    out = []
    for make in (tiny_test_cfg, jax_tiny_cfg):
        cfg = make()
        cfg.EVAL.RESOLUTION.ENABLED = True
        cfg.EVAL.RESOLUTION.FACTOR = 2
        cfg.SEMANTIC_IMAGE.ENABLED = True
        cfg.DEPTH.ENABLED = True
        cfg.LOSSES.RGB_INSTANCE = True
        out.append(cfg)
    return out


def _batch(cfg, seed=0):
    batch = synthetic_batch(cfg, 1, 2, seed=seed)
    h, w = cfg.IMAGE.SIZE
    rs = np.random.RandomState(seed)
    batch["image_instance_mask"] = rs.uniform(size=(1, 2, h, w, 1)) < 0.3
    return batch


@pytest.fixture(scope="module")
def preprocessed():
    pcfg, jcfg = _cfgs()
    batch = _batch(pcfg)
    pre = JaxPreProcess(jcfg)
    want = jax.device_get(jax.jit(lambda b: pre(b, training=False))(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    got = PreProcess(pcfg)({k: torch.from_numpy(v) for k, v in
                            batch.items()}, training=False)
    return pcfg, batch, got, want


def test_rescale_matches_muvo_tpu(preprocessed):
    cfg, batch, got, want = preprocessed
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].numpy()
        assert g.dtype == w.dtype, (key, g.dtype, w.dtype)
        assert g.shape == w.shape, (key, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            assert_norm_rel(g, w)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_rescale_halves_the_image_and_its_labels(preprocessed):
    cfg, batch, got, _ = preprocessed
    crop_h = cfg.IMAGE.CROP[3] - cfg.IMAGE.CROP[1]
    crop_w = cfg.IMAGE.CROP[2] - cfg.IMAGE.CROP[0]
    for key in RESIZED:
        assert got[key].shape[2:4] == (crop_h // 2, crop_w // 2), key
        assert got[key].dtype == torch.float32, key  # int32 and bool in
    assert got["depth"].shape[2:4] == (crop_h, crop_w)
    k = torch.from_numpy(batch["intrinsics"]).clone()
    k[..., 0, 2] -= cfg.IMAGE.CROP[0]
    k[..., 1, 2] -= cfg.IMAGE.CROP[1]
    k[..., :2, :] *= 0.5
    np.testing.assert_array_equal(got["intrinsics"].numpy(), k.numpy())


def test_rgb_loss_stops_where_muvo_tpu_stops(preprocessed):
    """The decoders' outputs keep IMAGE.CROP's size: muvo_tpu's loss fails
    on the RGB term (incompatible shapes), the port's raises ValueError
    there; without RGB supervision both losses run."""
    cfg, batch, got, want = preprocessed
    crop = (cfg.IMAGE.CROP[3] - cfg.IMAGE.CROP[1],
            cfg.IMAGE.CROP[2] - cfg.IMAGE.CROP[0])
    output = {f"rgb_{k}": np.zeros((1, 2, crop[0] // k, crop[1] // k, 3),
                                   np.float32) for k in (1, 2, 4)}
    jcfg = _cfgs()[1]
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_loss(jcfg, {k: jnp.asarray(v) for k, v in want.items()},
                 {k: jnp.asarray(v) for k, v in output.items()})
    with pytest.raises(ValueError, match="rgb_1 is .* IMAGE.CROP"):
        compute_loss(cfg, got, {k: torch.from_numpy(v)
                                for k, v in output.items()})


def test_model_serves_the_rescaled_frames():
    """muvo.yml's branch at tiny sizes, FACTOR 2, through
    DeploymentSession on the CPU: the encoder takes the half-sized image,
    the decoders return crop-sized frames."""
    cfg = tiny_test_cfg()
    cfg.EVAL.RESOLUTION.ENABLED = True
    cfg.EVAL.RESOLUTION.FACTOR = 2
    cfg.VOXEL_SEG.ENABLED = False
    cfg.MODEL.DECODER_BASE_CHANNELS = 64
    torch.manual_seed(0)
    session = DeploymentSession(MuvoWorldModel(cfg), cfg, device="cpu")
    out = session.deployment_forward(synthetic_batch(cfg, 1, 3, seed=2),
                                     is_dreaming=False)
    assert out["rgb_1"].shape == (1, 1, 64, 128, 3)
    assert torch.isfinite(out["rgb_1"]).all()
