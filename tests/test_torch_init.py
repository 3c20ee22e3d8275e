"""muvo_tpu's parameter initialisation in the PyTorch port
(muvo_tpu_torch/models/init.py): a freshly built port module or model
draws every leaf from the distribution its muvo_tpu counterpart draws from.

The draws cannot be bit-equal (JAX's threefry and torch's generators
differ), so each leaf is held to muvo_tpu's by its distribution. Leaf names
are the port's: muvo_tpu's variables go through muvo_tpu_torch/weights.py,
and so do two trees of the same structure that hold each muvo_tpu leaf's
rule (its standard deviation and its largest value), read here from the
leaf's name and kernel shape as flax defines them. Criteria, for every
floating leaf:

- a leaf muvo_tpu starts at one value (biases, norms, running statistics,
  ``type_embedding``, the Gaussian policy's log std) is bit-equal;
- a random leaf: the largest |w| of muvo_tpu's and of the port's is at
  most the rule's bound (lecun_normal's 2 sqrt(1 / fan_in) / 0.8796, the
  transposed convs' sqrt(1 / fan_in), up to float32 rounding; normal draws
  have none), which also holds this file's table against muvo_tpu;
- the table against muvo_tpu's draw: the standard deviation of each
  muvo_tpu leaf of at least 64 values, and of muvo_tpu's leaves of fewer
  than 1,024 values pooled (each divided by its rule's standard deviation),
  within 10% of the rule's, or within 4 / sqrt(n) where that is wider (a
  sample deviation of n values has a standard error of at most
  0.71 / sqrt(n));
- the port against the rule: the leaf's values, with further draws of its
  module's rule from other seeds where it has fewer than 1,024 values
  (ceil(1,024 / n) draws in all), have a standard deviation within 10% of
  the rule's exact one (at 1,024 values 10% is 4.5 standard errors of a
  normal draw, more of a truncated or uniform one) and a one-sample
  Kolmogorov-Smirnov statistic against the rule's exact distribution of at
  most 2.7 / sqrt(N) on their first N = min(size, 65,536) values (about
  1e-6 false alarms a leaf);
- a random leaf of at least 1,024 values: a two-sample Kolmogorov-Smirnov
  statistic against muvo_tpu's leaf of at most 2.7 sqrt(2 / n) (about 1e-6
  false alarms a leaf) on its first n = min(size, 65,536) values (a leaf's
  values are independent draws, so any n of them are a sample).

Each failure names its criterion (``bound``, ``table``, ``std``, ``ks``),
and the mutation cases hold the criteria to the faults they are for: PyTorch's
bound on small leaves, torch's fan-in of a transposed conv, a GRU's hidden
fan-in doubled.

(a) holds each module family against its flax module at small widths, (b)
the whole model at tiny_test_cfg against one jitted
``WorldModelTrainer.init_state(seed=42)``, (c) the other configurations as
whole models (slow), (d) that ``reference_init_`` sets every parameter and
buffer of each configuration and the RL policy, (e) determinism; and
(slow) that a fresh model's voxel occupancy, which sets the random-init
floor's voxel recall, is a property of the draw in both packages.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from muvo_tpu.data.synthetic import synthetic_batch
from muvo_tpu.data.synthetic import tiny_test_cfg as jax_tiny_cfg
from muvo_tpu.models import common as jc
from muvo_tpu.models import layers as jl
from muvo_tpu.models import stylegan as js
from muvo_tpu.models.backbones.mobilevit import MobileViTV2Features as JMViT
from muvo_tpu.models.backbones.resnet import ResNetFeatures as JResNet
from muvo_tpu.models.pointpillars import PointPillarNet as JPointPillarNet
from muvo_tpu.models.rssm import RSSM as JRSSM
from muvo_tpu.models.transformer import TransformerEncoder as JTransformer
from muvo_tpu.rl.policy import PpoPolicy as JPolicy
from muvo_tpu_torch import weights
from muvo_tpu_torch.data.synthetic import tiny_test_cfg
from muvo_tpu_torch.models import common as pc
from muvo_tpu_torch.models import init
from muvo_tpu_torch.models import layers as pl
from muvo_tpu_torch.models import stylegan as ps
from muvo_tpu_torch.models.backbones.mobilevit import MobileViTV2Features
from muvo_tpu_torch.models.backbones.resnet import ResNetFeatures
from muvo_tpu_torch.models.pointpillars import PointPillarNet
from muvo_tpu_torch.models.rssm import RSSM
from muvo_tpu_torch.models.transformer import TransformerEncoder
from muvo_tpu_torch.models.world_model import MuvoWorldModel
from muvo_tpu_torch.rl.policy import PpoPolicy

SEED = 42
STD_TOL, STD_MIN, KS_MIN, KS_MAX_N = 0.10, 64, 1024, 65536
# muvo_tpu's transposed convs (ConvTranspose2dTorch, SubPixelConvTranspose2d)
# in ConvDecoder: pre0-pre3 and trans_conv1-3
TRANSPOSED = re.compile(r"(^|/)(pre\d|trans_conv\d)/kernel$")


# ---------------------------------------------------------------------------
# the rules as flax defines them, on muvo_tpu's variables

def _rule(path: str, leaf, transposed) -> tuple:
    """(standard deviation, bound) of a muvo_tpu leaf's initialiser; nan
    for the constant leaves."""
    name = path.rsplit("/", 1)[-1]
    shape = np.shape(leaf)
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        if transposed(path):  # variance_scaling(1/3, fan_in, uniform)
            return math.sqrt(1 / (3 * fan_in)), math.sqrt(1 / fan_in)
        # lecun_normal: truncated to 2 sigma of the untruncated normal
        return (math.sqrt(1 / fan_in),
                2 * math.sqrt(1 / fan_in) / init.TRUNCATED_STD)
    if name == "constant_tensor":  # normal(1.0)
        return 1.0, math.inf
    if name == "embedding":  # nn.Embed: N(0, 1 / features)
        return math.sqrt(1 / shape[1]), math.inf
    return math.nan, math.nan


def _rule_trees(params, transposed):
    def fill(which):
        def leaf(path, v):
            key = "/".join(str(getattr(p, "key", p)) for p in path)
            return np.full(np.shape(v), _rule(key, v, transposed)[which])
        return jax.tree_util.tree_map_with_path(leaf, params)
    return fill(0), fill(1)


def _one_value(sd):
    """port name -> the one value of each mapped rule leaf."""
    out = {}
    for k, v in sd.items():
        v = np.asarray(v, np.float64)
        assert np.array_equal(v, np.full(v.shape, v.flat[0]), equal_nan=True), k
        out[k] = v.flat[0]
    return out


def _numpy(sd):
    return {k: np.asarray(v) for k, v in sd.items()}


def _ks_limit(n):
    return 2.7 * math.sqrt(2 / n)


def _table_tol(n):
    return max(STD_TOL, 4 / math.sqrt(n))


def _exact(sigma, bound):
    """The rule's distribution, from its standard deviation and bound."""
    if math.isinf(bound):  # normal(sigma)
        return stats.norm(0.0, sigma)
    if math.isclose(bound, math.sqrt(3) * sigma, rel_tol=1e-9):  # uniform
        return stats.uniform(-bound, 2 * bound)
    assert math.isclose(bound, 2 * sigma / init.TRUNCATED_STD, rel_tol=1e-9)
    return stats.truncnorm(-2.0, 2.0, scale=sigma / init.TRUNCATED_STD)


def _port_draws(port, key, first):
    """The port's leaf ``key`` (``first``) and, where it has fewer than
    KS_MIN values, further draws of its module's rule from other seeds
    until there are KS_MIN values."""
    draws = [first.ravel()]
    if first.size < KS_MIN:
        prefix, _, name = key.rpartition(".")
        module = port.get_submodule(prefix)
        rule = init._rule_of(module)
        for seed in range(1, math.ceil(KS_MIN / first.size)):
            gen = torch.Generator().manual_seed(10_000 + seed)
            draws.append(rule(module, gen)[name].numpy().ravel())
    return np.concatenate(draws)


def assert_same_distributions(want, port, sigma, bound):
    """The criteria of the module docstring, leaf by leaf, for muvo_tpu's
    ``want`` (port names -> arrays) and the port's module ``port``;
    returns the number of random and constant leaves checked."""
    got = _numpy(port.state_dict())
    assert set(got) == set(want), set(got) ^ set(want)
    pool, n_random, n_const = [], 0, 0
    for key in sorted(want):
        w, g = np.asarray(want[key]), np.asarray(got[key])
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if not np.issubdtype(w.dtype, np.floating):
            continue
        if w.size == 0 or np.all(w == w.flat[0]):
            np.testing.assert_array_equal(g, w, err_msg=key)
            n_const += 1
            continue
        n_random += 1
        s, b = sigma[key], bound[key]
        assert np.isfinite(s), f"{key}: random in muvo_tpu, no rule here"
        limit = b * (1 + 1e-6)
        assert np.abs(w).max() <= limit, ("bound", key, "muvo_tpu", b)
        assert np.abs(g).max() <= limit, ("bound", key, "port", b)
        if w.size >= STD_MIN:
            ratio = w.std() / s
            assert abs(ratio - 1) <= _table_tol(w.size), ("table", key, ratio)
        if w.size < KS_MIN:
            pool.append(w.ravel() / s)
        draws = _port_draws(port, key, g)[:KS_MAX_N]
        ratio = draws.std() / s
        assert abs(ratio - 1) <= STD_TOL, ("std", key, ratio)
        ks = stats.kstest(draws, _exact(s, b).cdf).statistic
        assert ks <= 2.7 / math.sqrt(draws.size), ("ks", key, ks)
        if w.size >= KS_MIN:
            n = min(w.size, KS_MAX_N)
            ks = stats.ks_2samp(w.ravel()[:n], g.ravel()[:n]).statistic
            assert ks <= _ks_limit(n), ("ks", key, "muvo_tpu", ks)
    if pool:
        w = np.concatenate(pool)
        if w.size >= STD_MIN:
            ratio = w.std()
            assert abs(ratio - 1) <= _table_tol(w.size), ("table", "pool",
                                                           ratio)
    return n_random, n_const


def _jax_init(module, *args, **kwargs):
    """A flax module's variables, as its init draws them (no change)."""
    return jax.device_get(jax.jit(
        lambda *a: module.init(jax.random.PRNGKey(SEED), *a, **kwargs))(
            *args))


def _entries_sd(entries, params, stats, extra):
    sd = {}
    if stats is None:
        entries(sd, "", params, *extra)
    else:
        entries(sd, "", params, stats, *extra)
    return sd


def _family_check(entries, variables, port, extra=(), transposed=None):
    """muvo_tpu's ``variables`` through the weights ``entries`` map (with
    their batch_stats where they have some, as load_entries passes them)
    against the port's freshly built module ``port``."""
    params = variables["params"]
    stats_tree = variables.get("batch_stats")
    sigma, bound = _rule_trees(params, transposed or TRANSPOSED.search)
    want = _numpy(_entries_sd(entries, params, stats_tree, extra))
    s_sd = _one_value(_entries_sd(entries, sigma, stats_tree, extra))
    b_sd = _one_value(_entries_sd(entries, bound, stats_tree, extra))
    n_random, _ = assert_same_distributions(want, port, s_sd, b_sd)
    return n_random


def _deconv_entries(sd, prefix, p):
    sd[prefix + "weight"] = weights.deconv_weight(p["kernel"])
    sd[prefix + "bias"] = np.asarray(p["bias"])


def _bev_down_entries(sd, prefix, p):
    for i, key in enumerate(("0", "2")):
        weights.conv_bias_entries(sd, f"{prefix}{key}.", p[f"Conv_{i}"])


def _randn(*shape):
    return np.random.RandomState(0).randn(*shape).astype(np.float32)


def _planes():
    xy, xz, yz = {}, {}, {}
    for s, (x, y, z) in {1: (8, 6, 4), 2: (4, 3, 2), 4: (2, 2, 1)}.items():
        xy[f"rgb_{s}"] = _randn(1, x, y, 8)
        xz[f"rgb_{s}"] = _randn(1, x, z, 8)
        yz[f"rgb_{s}"] = _randn(1, y, z, 8)
    return xy, xz, yz


def _points():
    pts = np.random.RandomState(0).uniform(-7.0, 7.0, (1, 500, 3))
    return pts.astype(np.float32), np.array([500], np.int32)


def _policy_family(extractor, distribution):
    birdview = np.zeros((1, 192, 192, 15), np.float32)
    jm = JPolicy(feature_extractor=extractor, distribution=distribution)
    v = _jax_init(jm, jnp.asarray(birdview), jnp.zeros((1, 6)),
                  jax.random.PRNGKey(1))
    port = init.build(lambda: PpoPolicy(extractor, distribution), SEED)
    return (lambda sd, prefix, p: sd.update(
        {k: t.numpy() for k, t in weights.ppo_state_dict_from_jax(
            p, port).items()})), v, port


# (a) the families: name -> () -> (entries, muvo_tpu variables, the port's
# module built by init.build, entries' extra arguments)
GRID = dict(min_x=-8.0, max_x=8.0, min_y=-8.0, max_y=8.0)
FAMILIES = {
    # models/layers.py (muvo_tpu/models/layers.py:19-102)
    "layers_conv_bn": lambda: (
        weights.conv_bn_entries, _jax_init(jl.ConvBN(64), _randn(1, 8, 8, 32)),
        init.build(lambda: pl.ConvBN(32, 64), SEED)),
    "layers_basic_block": lambda: (
        weights.basic_block_entries,
        _jax_init(jl.BasicBlock(64, 2, True), _randn(1, 8, 8, 32)),
        init.build(lambda: pl.BasicBlock(32, 64, 2, True), SEED)),
    "layers_conv_transpose": lambda: (
        _deconv_entries,
        _jax_init(jl.ConvTranspose2dTorch(32, (6, 6), (2, 2), (2, 2)),
                  _randn(1, 4, 4, 64)),
        init.build(lambda: pl.ConvTranspose2dTorch(64, 32, 6, 2, 2), SEED)),
    # models/backbones/resnet.py
    "resnet18": lambda: (
        weights.resnet_entries,
        _jax_init(JResNet(out_indices=(2, 3, 4)), _randn(1, 32, 64, 3)),
        init.build(lambda: ResNetFeatures((2, 3, 4)), SEED)),
    # models/backbones/mobilevit.py
    "mobilevit": lambda: (
        weights.mobilevit_entries,
        _jax_init(JMViT(out_indices=(0, 1, 2, 3, 4)), _randn(1, 64, 64, 3)),
        init.build(lambda: MobileViTV2Features((0, 1, 2, 3, 4), 3), SEED)),
    # models/common.py
    "common_decoder_ds": lambda: (
        weights.decoder_ds_entries,
        _jax_init(jc.DecoderDS(64), [_randn(1, 8, 8, 32), _randn(1, 4, 4, 48),
                                     _randn(1, 2, 2, 96)]),
        init.build(lambda: pc.DecoderDS([32, 48, 96], 64), SEED)),
    "common_decoder": lambda: (
        weights.decoder_entries,
        _jax_init(jc.Decoder(64), [_randn(1, 8, 8, 32), _randn(1, 4, 4, 48),
                                   _randn(1, 2, 2, 96)]),
        init.build(lambda: pc.Decoder([32, 48, 96], 64), SEED)),
    "common_route_encode": lambda: (
        weights.route_entries, _jax_init(jc.RouteEncode(64),
                                         _randn(1, 32, 32, 3)),
        init.build(lambda: pc.RouteEncode(64), SEED)),
    "common_feature_compressor": lambda: (
        weights.feature_compressor_entries,
        _jax_init(jc.FeatureCompressor(64), _randn(1, 4, 8, 32)),
        init.build(lambda: pc.FeatureCompressor(32, 64), SEED)),
    "common_policy": lambda: (
        weights.policy_entries, _jax_init(jc.Policy(96), _randn(1, 96)),
        init.build(lambda: pc.Policy(96), SEED)),
    "common_speed_encoder": lambda: (
        weights.speed_entries, _jax_init(jc.SpeedEncoder(64, 5.0),
                                         _randn(1, 1)),
        init.build(lambda: pc.SpeedEncoder(64, 5.0), SEED)),
    "common_command_encoder": lambda: (
        weights.command_entries,
        _jax_init(jc.CommandEncoder(64), np.zeros((1,), np.int32)),
        init.build(lambda: pc.CommandEncoder(64), SEED)),
    "common_gps_encoder": lambda: (
        weights.speed_entries, _jax_init(jc.GpsEncoder(64), _randn(1, 4)),
        init.build(lambda: pc.GpsEncoder(64), SEED)),
    "common_bev_down_sample_4": lambda: (
        _bev_down_entries, _jax_init(jc.BevDownSample4(64),
                                     _randn(1, 8, 8, 16)),
        init.build(lambda: pc.BevDownSample4(16, 64), SEED)),
    # models/rssm.py
    "rssm": lambda: (
        weights.rssm_entries,
        _jax_init(JRSSM(embedding_dim=16, action_dim=2, hidden_state_dim=96,
                        state_dim=48, action_latent_dim=16),
                  _randn(1, 2, 16), _randn(1, 2, 2)),
        init.build(lambda: RSSM(16, 2, 96, 48, 16), SEED)),
    # models/transformer.py
    "transformer": lambda: (
        weights.transformer_entries,
        _jax_init(JTransformer(64, n_layers=2, n_heads=4,
                               dim_feedforward=128), _randn(1, 8, 64)),
        init.build(lambda: TransformerEncoder(64, 2, 4, 128), SEED)),
    # models/stylegan.py
    "stylegan_conv_decoder": lambda: (
        weights.conv_decoder_entries,
        _jax_init(js.ConvDecoder(latent_n_channels=32, out_channels=3,
                                 constant_size=(1, 1), base_channels=64),
                  _randn(1, 32)),
        init.build(lambda: ps.ConvDecoder(32, 3, (1, 1), "rgb", 64), SEED),
        ("rgb",)),
    "stylegan_bev_decoder": lambda: (
        weights.style_decoder_entries,
        _jax_init(js.BevDecoder(latent_n_channels=32, semantic_n_channels=3,
                                constant_size=(1, 1), base_channels=64),
                  _randn(1, 32)),
        init.build(lambda: ps.BevDecoder(32, 3, (1, 1), 64), SEED),
        ("bev",)),
    "stylegan_voxel_decoder": lambda: (
        weights.style_decoder_entries,
        _jax_init(js.VoxelDecoder(latent_n_channels=32, semantic_n_channels=2,
                                  feature_channels=16,
                                  constant_size=(1, 1, 1)), _randn(1, 32)),
        init.build(lambda: ps.VoxelDecoder(32, 2, 16, (1, 1, 1)), SEED),
        ("voxel",)),
    "stylegan_triplane": lambda: (
        weights.triplane_entries,
        _jax_init(js.TriPlaneVoxelDecoder(3, feature_channels=16),
                  *_planes()),
        init.build(lambda: ps.TriPlaneVoxelDecoder(8, 3, 16), SEED)),
    # models/pointpillars.py
    "pointpillars": lambda: (
        weights.point_pillars_entries,
        _jax_init(JPointPillarNet(**GRID), *_points(), train=False),
        init.build(lambda: PointPillarNet(**GRID), SEED)),
    # rl/networks.py and rl/policy.py
    "rl_xtma_beta": lambda: _policy_family("xtma_cnn", "beta"),
    "rl_impala_beta": lambda: _policy_family("impala_cnn", "beta"),
    "rl_xtma_gaussian": lambda: _policy_family("xtma_cnn", "diag_gaussian"),
}


def _check_family(family):
    entries, variables, port, *extra = FAMILIES[family]()
    # the lone transposed conv's kernel sits at the top of its tree
    transposed = ((lambda path: path == "kernel")
                  if family == "layers_conv_transpose" else None)
    return _family_check(entries, variables, port,
                         extra[0] if extra else (), transposed)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_draws_muvo_tpus_distributions(family):
    assert _check_family(family) > 0


def _torch_bound_on_small_leaves(m, gen):
    # PyTorch's kaiming_uniform(a=sqrt(5)) bound, U(+-1/sqrt(fan_in)), on
    # the Dense and conv kernels of fewer than KS_MIN values
    if m.weight.numel() >= KS_MIN:
        return init._dense_or_conv(m, gen)
    return {"weight": init.uniform_fan_in(m.weight.shape,
                                          m.weight[0].numel(), gen),
            "bias": torch.zeros(m.bias.shape)}


def _torch_transposed_fan_in(m, gen):
    # torch's fan-in of a ConvTranspose2d: its output channels
    w = m.weight
    return {"weight": init.uniform_fan_in(w.shape, w.shape[1] * w[0, 0].numel(),
                                          gen),
            "bias": torch.zeros(m.bias.shape)}


def _gru_hidden_fan_in_doubled(m, gen):
    out = init._gru_cell(m, gen)
    out["weight_hh"] = init.lecun_normal(m.weight_hh.shape,
                                         2 * m.hidden_size, gen)
    return out


# fault -> (the module type it changes, the faulty rule, a family it shows in)
MUTATIONS = {
    "torch_bound_on_small_leaves": (torch.nn.Linear,
                                    _torch_bound_on_small_leaves,
                                    "common_speed_encoder"),
    "torch_transposed_fan_in": (torch.nn.ConvTranspose2d,
                                _torch_transposed_fan_in,
                                "layers_conv_transpose"),
    "gru_hidden_fan_in_doubled": (torch.nn.GRUCell,
                                  _gru_hidden_fan_in_doubled, "rssm"),
}


@pytest.mark.parametrize("fault", sorted(MUTATIONS))
def test_the_criteria_refuse_a_faulty_rule(fault, monkeypatch):
    """Each fault the rules repair, put back into one rule, fails its
    family's criteria: PyTorch's bound on the 64-value first kernel of the
    speed encoder (fan-in 1: a standard deviation of 0.577 of the rule's),
    torch's transposed-conv fan-in (1.414x), a GRU's hidden fan-in doubled
    (0.707x on a large leaf)."""
    kind, rule, family = MUTATIONS[fault]
    monkeypatch.setattr(init, "TYPE_RULES",
                        ((kind, rule),) + init.TYPE_RULES)
    with pytest.raises(AssertionError, match=r"'(bound|std|ks)'"):
        _check_family(family)


# ---------------------------------------------------------------------------
# whole models against muvo_tpu's trainer

def _jax_state(jcfg, seed=SEED):
    """One jitted muvo_tpu WorldModelTrainer.init_state(seed)."""
    from muvo_tpu.parallel.mesh import make_mesh
    from muvo_tpu.training.trainer import WorldModelTrainer

    trainer = WorldModelTrainer(jcfg, mesh=make_mesh(n_data=1))
    batch = synthetic_batch(jcfg, 1)
    state = trainer.init_state({k: jnp.asarray(v) for k, v in batch.items()},
                               seed=seed)
    return jax.device_get(state.params), jax.device_get(state.batch_stats)


def _whole_model_check(overrides=None):
    jcfg, pcfg = jax_tiny_cfg(), tiny_test_cfg()
    for cfg in (jcfg, pcfg):
        if overrides:
            cfg.merge_from_dict(overrides)
    params, batch_stats = _jax_state(jcfg)
    sigma, bound = _rule_trees(params, TRANSPOSED.search)
    want = _numpy(weights.state_dict_from_jax(params, batch_stats, pcfg))
    s_sd = _one_value(weights.state_dict_from_jax(sigma, batch_stats, pcfg))
    b_sd = _one_value(weights.state_dict_from_jax(bound, batch_stats, pcfg))
    model = init.build(lambda: MuvoWorldModel(pcfg), SEED)
    return assert_same_distributions(want, model, s_sd, b_sd)


def test_whole_model_at_tiny_test_cfg():
    """(b): every leaf of the port's fresh model at tiny_test_cfg against
    muvo_tpu's trainer's init_state(seed=42) (about 45 s in one process,
    most of it compiling muvo_tpu's init)."""
    n_random, n_const = _whole_model_check()
    assert n_random >= 150 and n_const >= 400, (n_random, n_const)


SMALL = {"VOXEL_SEG": {"ENABLED": False},
         "MODEL": {"DECODER_BASE_CHANNELS": 64}}
# (c) and (d): the other configurations, at small widths
CONFIGS = {
    "tiny": {},
    "mobilevit": {"MODEL": {"ENCODER": {"NAME": "mobilevitv2_100"},
                            "LIDAR": {"ENCODER": "mobilevitv2_100"},
                            "DECODER_BASE_CHANNELS": 64},
                  "VOXEL_SEG": {"ENABLED": False}},
    "point_pillars_heads": {
        "MODEL": {"LIDAR": {"POINT_PILLAR": {"ENABLED": True}},
                  "DECODER_BASE_CHANNELS": 64},
        "SEMANTIC_SEG": {"ENABLED": True}, "LIDAR_SEG": {"ENABLED": True},
        "SEMANTIC_IMAGE": {"ENABLED": True}, "DEPTH": {"ENABLED": True},
        "POINTS": {"N_PER_SECOND": 20000}, "VOXEL_SEG": {"ENABLED": False}},
    "transformer_bev": {"MODEL": {"TRANSFORMER": {"BEV": True},
                                  "DECODER_BASE_CHANNELS": 64},
                        "VOXEL_SEG": {"ENABLED": False}},
    "mile": {"MODEL": {"TRANSFORMER": {"ENABLED": False},
                       "DECODER_BASE_CHANNELS": 64},
             "VOXEL_SEG": {"ENABLED": False}},
    "measurements": {"MODEL": {"MEASUREMENTS": {"ENABLED": True},
                               "DECODER_BASE_CHANNELS": 64},
                     "VOXEL_SEG": {"ENABLED": False}},
    "resnet34": {"MODEL": {"TRANSFORMER": {"ENABLED": False},
                           "ENCODER": {"NAME": "resnet34"},
                           "LIDAR": {"ENCODER": "resnet34"},
                           "ROUTE": {"BACKBONE": "resnet34"},
                           "BEV": {"BACKBONE": "resnet34"},
                           "DECODER_BASE_CHANNELS": 64},
                 "VOXEL_SEG": {"ENABLED": False}},
    "large": {"MODEL": {"TRANSFORMER": {"LARGE": True},
                        "DECODER_BASE_CHANNELS": 64},
              "VOXEL_SEG": {"ENABLED": False}},
}


@pytest.mark.slow
@pytest.mark.parametrize("config", sorted(set(CONFIGS) - {"tiny"}))
def test_whole_model_in_other_configurations(config):
    """(c): MobileViTV2, PointPillars with every head, BEV lifting, the MILE
    branch (the default config's), the measurement encoders, resnet34 and
    LARGE as whole models (the tri-plane decoder, on no model path, is a
    family of (a))."""
    n_random, n_const = _whole_model_check(CONFIGS[config])
    assert n_random > 0 and n_const > 0


OCCUPANCY_SEEDS = range(8)


@pytest.mark.slow
def test_random_init_voxel_occupancy_is_a_property_of_one_draw():
    """The random-init floor's voxel recall is about the share of voxels a
    fresh model's voxel head marks occupied (class 1 of ``voxel_1``), and
    one draw of a few leaves sets that share (the heads' weights, the last
    AdaIN's style). Over OCCUPANCY_SEEDS seeds at tiny_test_cfg, on one
    synthetic batch, sampling at the mean, the share spreads over at least
    half of [0, 1] in each package (``-s`` prints them). So one seed's floor
    recall in each package compares draws, not distributions, which the
    cases above hold leaf by leaf."""
    from muvo_tpu.models.rssm import RSSM as JRSSMModule
    from muvo_tpu.parallel.mesh import make_mesh
    from muvo_tpu.training.trainer import WorldModelTrainer
    from muvo_tpu_torch.models.preprocess import PreProcess

    jcfg, pcfg = jax_tiny_cfg(), tiny_test_cfg()
    batch = synthetic_batch(jcfg, 1)
    trainer = WorldModelTrainer(jcfg, mesh=make_mesh(n_data=1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda b: trainer.preprocess(b, training=False), jb))
    mp = pytest.MonkeyPatch()
    mp.setattr(JRSSMModule, "sample_from_distribution",
               lambda self, mu, sigma, use_sample, rng: mu)
    try:
        # init_state's init, compiled once for every seed
        variables = jax.jit(lambda key: trainer.model.init(
            {"params": key}, pb, training=False, rng=jax.random.PRNGKey(0)))

        @jax.jit
        def occupied(v, b):
            out, _ = trainer.model.apply(
                v, trainer.preprocess(b, training=False), training=False)
            return (out["voxel_1"].argmax(-1) == 1).mean()

        jax_shares = [float(occupied(variables(jax.random.PRNGKey(seed)), jb))
                      for seed in OCCUPANCY_SEEDS]
    finally:
        mp.undo()
    ppb = PreProcess(pcfg)({k: torch.from_numpy(v) for k, v in batch.items()},
                           training=False)
    port_shares = []
    for seed in OCCUPANCY_SEEDS:
        model = init.build(lambda: MuvoWorldModel(pcfg), seed).eval()
        with torch.no_grad():
            out, _ = model(ppb, stochastic=False)
        port_shares.append(float((out["voxel_1"].argmax(-1) == 1).float()
                                 .mean()))
    print("occupied share by seed, muvo_tpu", np.round(jax_shares, 4),
          "port", np.round(port_shares, 4))
    for shares in (jax_shares, port_shares):
        assert max(shares) - min(shares) >= 0.5, shares


# ---------------------------------------------------------------------------
# coverage and determinism (no JAX)

def _port_cfg(config):
    cfg = tiny_test_cfg()
    cfg.merge_from_dict(CONFIGS[config])
    return cfg


def _names(model):
    return ({n for n, _ in model.named_parameters()}
            | {n for n, _ in model.named_buffers()} | set(model.state_dict()))


POLICIES = [("xtma_cnn", "beta"), ("impala_cnn", "beta"),
            ("xtma_cnn", "diag_gaussian"), ("xtma_cnn", "squashed_gaussian")]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_reference_init_sets_every_tensor_of_each_configuration(config):
    """(d): reference_init_ sets every parameter and buffer name (the
    state_dict's and the non-persistent ones), leaving none at torch's
    draw; a second pass from the same seed writes the same values."""
    cfg = _port_cfg(config)
    with torch.device("meta"):
        model = MuvoWorldModel(cfg)
    model = model.to_empty(device="cpu")
    names = init.reference_init_(model, torch.Generator().manual_seed(1))
    assert names == _names(model)
    once = {k: v.clone() for k, v in model.state_dict().items()}
    init.reference_init_(model, torch.Generator().manual_seed(1))
    for k, v in model.state_dict().items():
        assert torch.equal(v, once[k]), k


@pytest.mark.parametrize("extractor,distribution", POLICIES)
def test_reference_init_sets_every_tensor_of_the_rl_policy(extractor,
                                                           distribution):
    """(d) for the PPO expert, each feature extractor and distribution."""
    with torch.device("meta"):
        policy = PpoPolicy(extractor, distribution)
    policy = policy.to_empty(device="cpu")
    names = init.reference_init_(policy, torch.Generator().manual_seed(1))
    assert names == _names(policy)
    if distribution != "beta":
        assert torch.equal(policy.dist_sigma, torch.full((2,), -2.0))


def test_a_module_without_a_rule_is_refused():
    class Scale(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.gain = torch.nn.Parameter(torch.ones(3))

    with pytest.raises(TypeError, match="no initialiser"):
        init.reference_init_(torch.nn.Sequential(torch.nn.Linear(2, 3),
                                                 Scale()),
                             torch.Generator().manual_seed(0))


@pytest.mark.parametrize("config", ["tiny", "transformer_bev", "mile"])
def test_a_built_model_runs_as_one_constructed_and_loaded(config):
    """init.build constructs on the meta device: its model (frustum
    constants included) computes what a model constructed on the host
    with the same state_dict computes, bit for bit."""
    from muvo_tpu_torch.data.synthetic import synthetic_batch as port_batch
    from muvo_tpu_torch.models.preprocess import PreProcess

    cfg = _port_cfg(config)
    built = init.build(lambda: MuvoWorldModel(cfg), 3).eval()
    loaded = MuvoWorldModel(cfg)
    loaded.load_state_dict(built.state_dict(), strict=True)
    loaded.eval()
    batch = {k: torch.as_tensor(v) for k, v in port_batch(cfg, 1).items()}
    pb = PreProcess(cfg)(batch, training=False)
    with torch.no_grad():
        got, _ = built(pb, stochastic=False)
        want, _ = loaded(pb, stochastic=False)
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], torch.Tensor):
            assert torch.equal(got[key], want[key]), key


def test_same_seed_same_model_and_the_global_generator_untouched():
    """(e): the same seed gives a bit-equal state_dict, another seed
    another one, and building reads and moves no global random state."""
    cfg = _port_cfg("mile")
    before = torch.get_rng_state()
    a = init.build(lambda: MuvoWorldModel(cfg), 5).state_dict()
    b = init.build(lambda: MuvoWorldModel(cfg), 5).state_dict()
    c = init.build(lambda: MuvoWorldModel(cfg), 6).state_dict()
    assert torch.equal(torch.get_rng_state(), before)
    assert set(a) == set(b) == set(c)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    key = "backbone_bev.conv1.weight"
    assert not torch.equal(a[key], c[key])


def test_trainer_and_entry_points_start_from_the_rules():
    """init_state, evaluate.build_agent without a checkpoint and the
    expert without a policy build through init.build: the seed's model,
    and no global random state read."""
    from muvo_tpu_torch.evaluate import INIT_SEED
    from muvo_tpu_torch.rl.agent import RlBirdviewAgent
    from muvo_tpu_torch.training.trainer import WorldModelTrainer

    cfg = _port_cfg("mile")
    before = torch.get_rng_state()
    state = WorldModelTrainer(cfg, device="cpu").init_state(seed=INIT_SEED)
    want = init.build(lambda: MuvoWorldModel(cfg), INIT_SEED).state_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    agent = RlBirdviewAgent(device="cpu")
    want = init.build(PpoPolicy, 0).state_dict()
    for k, v in agent.policy.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert torch.equal(torch.get_rng_state(), before)
