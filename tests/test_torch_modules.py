"""The PyTorch port's modules against muvo_tpu's, module by module, with the
JAX initialisation carried over by muvo_tpu_torch/weights.py.

Inputs come from numpy seeds and go to both sides; biases, BatchNorm affine
parameters and running statistics are randomised first so that every
mapped leaf matters. Tolerance: fp32 on both sides, differing only in
summation order, so max |port - jax| <= 1e-4 * max(1, max |jax|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.models import common as jc
from muvo_tpu.models import layers as jl
from muvo_tpu.models.backbones.resnet import ResNetFeatures as JResNet
from muvo_tpu.models.rssm import RSSM as JRSSM
from muvo_tpu.models.stylegan import ConvDecoder as JConvDecoder
from muvo_tpu.models.transformer import TransformerEncoder as JTransformer
from muvo_tpu.ops.attention import multi_head_attention as j_mha
from muvo_tpu_torch import weights
from muvo_tpu_torch.models import common as pc
from muvo_tpu_torch.models import layers as pl
from muvo_tpu_torch.models.backbones.resnet import ResNetFeatures
from muvo_tpu_torch.models.rssm import RSSM, sample_from_distribution
from muvo_tpu_torch.models.stylegan import ConvDecoder
from muvo_tpu_torch.models.transformer import TransformerEncoder
from muvo_tpu_torch.ops.attention import multi_head_attention
from torch_port_common import assert_same
from torch_port_common import close as _close
from torch_port_common import flax_apply as _apply
from torch_port_common import flax_init as _init
from torch_port_common import load_entries as _load
from torch_port_common import randn as _randn
from torch_port_common import to_torch as _t


def test_basic_block_with_hardcoded_stride2_downsample():
    x = _randn(np.random.RandomState(0), 2, 10, 12, 4)
    jm = jl.BasicBlock(8, stride=2, downsample=True)
    v = _init(jm, x)
    pm = _load(pl.BasicBlock(4, 8, 2, True), weights.basic_block_entries, v)
    _close(pm(_t(x)), _apply(jm, v, x))


def test_conv_bn():
    x = _randn(np.random.RandomState(0), 2, 6, 7, 4)
    jm = jl.ConvBN(8)
    v = _init(jm, x)
    pm = _load(pl.ConvBN(4, 8), weights.conv_bn_entries, v)
    _close(pm(_t(x)), _apply(jm, v, x))


@pytest.mark.parametrize("kernel,stride,padding,out_pad", [
    ((6, 6), (2, 2), (2, 2), (0, 0)),
    ((5, 5), (2, 2), (2, 2), (1, 1)),
    ((2, 3), (1, 1), (0, 0), (0, 0)),
])
def test_conv_transpose_torch_geometry(kernel, stride, padding, out_pad):
    x = _randn(np.random.RandomState(0), 1, 3, 4, 6)
    jm = jl.ConvTranspose2dTorch(8, kernel, stride, padding, out_pad)
    v = _init(jm, x)
    pm = pl.ConvTranspose2dTorch(6, 8, kernel, stride, padding,
                                 output_padding=out_pad)
    pm.load_state_dict(weights.to_tensors({
        "weight": weights.deconv_weight(v["params"]["kernel"]),
        "bias": v["params"]["bias"]}))
    _close(pm(_t(x)), _apply(jm, v, x))


def test_pooling_and_upsampling():
    rs = np.random.RandomState(0)
    x = _randn(rs, 2, 9, 12, 5)
    _close(pl.max_pool_torch(_t(x), 3, 2, padding=1),
           jl.max_pool_torch(x, 3, 2, padding=1))
    _close(pl.max_pool_torch(_t(x[:, :8]), 2), jl.max_pool_torch(x[:, :8], 2))
    _close(pl.adaptive_avg_pool_1x1(_t(x)), jl.adaptive_avg_pool_1x1(x))
    _close(pl.leaky_relu_torch(_t(x)), jl.leaky_relu_torch(x))
    _close(pl.leaky_relu_torch(_t(x), 0.2), jl.leaky_relu_torch(x, 0.2))
    _close(pl.upsample2x_bilinear(_t(x)), jl.upsample2x_bilinear(x))
    x5 = _randn(rs, 1, 3, 4, 5, 6)
    _close(pl.upsample2x_trilinear(_t(x5)), jl.upsample2x_trilinear(x5))
    xy = jl.upsample2x_xy_folded(x5.reshape(1, 3, 4, 30))
    _close(pl.upsample2x_xy(_t(x5)), np.asarray(xy).reshape(1, 6, 8, 5, 6))


def test_resnet18_features():
    x = _randn(np.random.RandomState(0), 1, 32, 64, 3)
    jm = JResNet(out_indices=(2, 3, 4))
    v = _init(jm, x)
    pm = _load(ResNetFeatures((2, 3, 4)), weights.resnet_entries, v)
    got, want = pm(_t(x)), _apply(jm, v, x)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close(g, w)


def test_decoder_ds():
    rs = np.random.RandomState(0)
    xs = [_randn(rs, 1, 8, 12, 8), _randn(rs, 1, 4, 6, 12),
          _randn(rs, 1, 2, 3, 20)]
    jm = jc.DecoderDS(16)
    v = _init(jm, xs)
    pm = _load(pc.DecoderDS([8, 12, 20], 16), weights.decoder_ds_entries, v)
    _close(pm([_t(x) for x in xs]), _apply(jm, v, xs))


def test_resize_bilinear_upsamples_as_jax_image_resize():
    x = _randn(np.random.RandomState(0), 2, 3, 5, 4)
    for size in ((6, 10), (7, 13), (3, 9)):
        _close(pl.resize_bilinear(_t(x), size), jl.resize_bilinear(x, size))
    with pytest.raises(ValueError):  # downsampling would need antialiasing
        pl.resize_bilinear(_t(x), (2, 5))


@pytest.mark.parametrize("odd", [False, True])
def test_decoder(odd):
    """The LARGE path's top-down FPN; odd sizes upsample by other than 2x."""
    rs = np.random.RandomState(0)
    hw = ((9, 13), (5, 7), (3, 4)) if odd else ((8, 12), (4, 6), (2, 3))
    xs = [_randn(rs, 1, *hw[0], 8), _randn(rs, 1, *hw[1], 12),
          _randn(rs, 1, *hw[2], 20)]
    jm = jc.Decoder(16)
    v = _init(jm, xs)
    pm = _load(pc.Decoder([8, 12, 20], 16), weights.decoder_entries, v)
    got = pm([_t(x) for x in xs])
    assert got.shape == (1, *hw[0], 16)
    _close(got, _apply(jm, v, xs))


def test_route_encode():
    x = _randn(np.random.RandomState(0), 2, 32, 32, 3)
    jm = jc.RouteEncode(8)
    v = _init(jm, x)
    pm = _load(pc.RouteEncode(8), weights.route_entries, v)
    _close(pm(_t(x)), _apply(jm, v, x))


def test_feature_compressor():
    x = _randn(np.random.RandomState(0), 2, 4, 8, 12)
    jm = jc.FeatureCompressor(16, strides=(2, 1))
    v = _init(jm, x)
    pm = _load(pc.FeatureCompressor(12, 16), weights.feature_compressor_entries,
               v)
    _close(pm(_t(x)), _apply(jm, v, x))


def test_policy_and_speed_encoder():
    rs = np.random.RandomState(0)
    state = _randn(rs, 3, 24)
    jm = jc.Policy(24)
    v = _init(jm, state)
    pm = _load(pc.Policy(24), weights.policy_entries, v)
    _close(pm(_t(state)), _apply(jm, v, state))

    speed = rs.uniform(0, 10, (3, 1)).astype(np.float32)
    jm = jc.SpeedEncoder(8, 5.0)
    v = _init(jm, speed)
    pm = _load(pc.SpeedEncoder(8, 5.0), weights.speed_entries, v)
    _close(pm(_t(speed)), _apply(jm, v, speed))


def test_position_embedding_sine():
    _close(pc.position_embedding_sine(3, 5, 8),
           jc.position_embedding_sine(3, 5, 8))


@pytest.mark.parametrize("seq_len", [None, 5])
def test_transformer_encoder(seq_len):
    x = _randn(np.random.RandomState(0), 2, 8, 32)
    jm = JTransformer(32, n_layers=2, n_heads=4, dim_feedforward=48)
    v = _init(jm, x)
    pm = _load(TransformerEncoder(32, 2, 4, 48), weights.transformer_entries,
               v)
    _close(pm(_t(x), seq_len), _apply(jm, v, x, seq_len=seq_len))


def test_attention_masks_keys_past_seq_len():
    """The seq_len key mask (muvo_tpu/ops/attention.py:60-62), which
    muvo_tpu's own tests never reach: same as JAX, and keys at or past
    seq_len do not change the output."""
    rs = np.random.RandomState(0)
    q, k, v = (_randn(rs, 2, 9, 16) for _ in range(3))
    got = multi_head_attention(_t(q), _t(k), _t(v), 4, seq_len=6)
    _close(got, j_mha(q, k, v, 4, use_flash=False, seq_len=6))
    k2, v2 = k.copy(), v.copy()
    k2[:, 6:] = _randn(rs, 2, 3, 16)
    v2[:, 6:] = _randn(rs, 2, 3, 16)
    again = multi_head_attention(_t(q), _t(k2), _t(v2), 4, seq_len=6)
    assert_same(again, got)
    _close(multi_head_attention(_t(q), _t(k), _t(v), 4),
           j_mha(q, k, v, 4, use_flash=False))


def test_rssm_observe_and_imagine_steps():
    rs = np.random.RandomState(0)
    emb, act = _randn(rs, 2, 3, 16), _randn(rs, 2, 3, 2)
    jm = JRSSM(embedding_dim=16, action_dim=2, hidden_state_dim=24,
               state_dim=8, action_latent_dim=4)
    v = _init(jm, emb, act)
    pm = _load(RSSM(16, 2, 24, 8, 4), weights.rssm_entries, v)
    h, s, a, e = _randn(rs, 2, 24), _randn(rs, 2, 8), act[:, 0], emb[:, 0]
    want = _apply(jm, v, h, s, a, e, use_sample=False,
                  method=JRSSM.observe_step)
    got = pm.observe_step(_t(h), _t(s), _t(a), _t(e), use_sample=False)
    for branch in ("prior", "posterior"):
        for key in ("hidden_state", "sample", "mu", "sigma"):
            _close(got[branch][key], want[branch][key])
    want = _apply(jm, v, h, s, a, use_sample=False,
                  method=JRSSM.imagine_step)
    got = pm.imagine_step(_t(h), _t(s), _t(a), use_sample=False)
    for key in ("hidden_state", "sample", "mu", "sigma"):
        _close(got[key], want[key])


def test_sampling_draws_from_the_given_generator():
    mu, sigma = torch.zeros(2, 5), torch.full((2, 5), 0.5)
    a = sample_from_distribution(mu, sigma, True,
                                 torch.Generator().manual_seed(3))
    b = sample_from_distribution(mu, sigma, True,
                                 torch.Generator().manual_seed(3))
    assert_same(a, b)
    assert not torch.equal(a, mu)
    assert torch.equal(sample_from_distribution(mu, sigma, False, None), mu)


@pytest.mark.parametrize("head", ["rgb", "lidar_re"])
def test_conv_decoder(head):
    w = _randn(np.random.RandomState(0), 2, 16)
    jm = JConvDecoder(latent_n_channels=16, out_channels=3,
                      constant_size=(1, 1), head=head, base_channels=16)
    v = _init(jm, w)
    pm = _load(ConvDecoder(16, 3, (1, 1), head, 16),
               weights.conv_decoder_entries, v, head)
    got, want = pm(_t(w)), _apply(jm, v, w)
    assert set(got) == set(want) and len(got) == 3
    for key in want:
        _close(got[key], want[key])
