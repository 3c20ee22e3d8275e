"""muvo_tpu parameters -> the port's state_dict (upstream MUVO's keys; for
the PPO expert, carla-roach's rl_birdview keys: ``ppo_state_dict_from_jax``).

The inverse of muvo_tpu/training/weight_convert.py's
convert_reference_state_dict, written against numpy only: conv kernels
(kx, ky, [kz], Cin, Cout) -> (Cout, Cin, kx, ky, [kz]); transposed-conv
kernels unflipped back to torch's (Cin, Cout, kh, kw); Dense kernels
transposed; BatchNorm statistics from the batch_stats tree; the decoders'
channels-last constants back to channels-first. Each ``*_entries`` helper
maps one module's sub-tree under a key prefix, so a test can carry the
weights of a single module as well as of the whole model.

A gradient tree has the params' structure and maps the same way, with
``batch_stats=None`` (no running statistics). The BatchNorm statistics
after a training step map with the params they belong to, and
``running_stats`` keeps only those entries, for comparing a step's
``batch_stats`` with the port's buffers.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from muvo_tpu_torch.models.stylegan import HEADS


def conv_weight(kernel) -> np.ndarray:
    k = np.asarray(kernel)
    nd = k.ndim
    return np.transpose(k, (nd - 1, nd - 2) + tuple(range(nd - 2)))


def deconv_weight(kernel) -> np.ndarray:
    k = np.transpose(np.asarray(kernel), (2, 3, 0, 1))
    return k[:, :, ::-1, ::-1]


def dense_entries(sd, prefix, p):
    sd[prefix + "weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[prefix + "bias"] = np.asarray(p["bias"])


class _NoStats:
    """The batch_stats of a gradient tree: every lookup gives itself, and
    batch_norm_entries writes no running statistics for it."""

    def __getitem__(self, key):
        return self


def batch_norm_entries(sd, prefix, p, s):
    sd[prefix + "weight"] = np.asarray(p["scale"])
    sd[prefix + "bias"] = np.asarray(p["bias"])
    if isinstance(s, _NoStats):
        return
    sd[prefix + "running_mean"] = np.asarray(s["mean"])
    sd[prefix + "running_var"] = np.asarray(s["var"])
    sd[prefix + "num_batches_tracked"] = np.array(0, np.int64)


def conv_bias_entries(sd, prefix, p):
    sd[prefix + "weight"] = conv_weight(p["kernel"])
    if "bias" in p:
        sd[prefix + "bias"] = np.asarray(p["bias"])


def resnet_entries(sd, prefix, p, s):
    """ResNetFeatures (timm names: conv1, bn1, layer{i}.{j}.*)."""
    sd[prefix + "conv1.weight"] = conv_weight(p["conv1"]["kernel"])
    batch_norm_entries(sd, prefix + "bn1.", p["bn1"], s["bn1"])
    for name in p:
        if not name.startswith("layer"):
            continue
        stage, block = name[len("layer"):].split("_")
        bp, bs = p[name], s[name]
        dp = f"{prefix}layer{stage}.{block}."
        for i in (1, 2):
            sd[f"{dp}conv{i}.weight"] = conv_weight(bp[f"conv{i}"]["kernel"])
            batch_norm_entries(sd, f"{dp}bn{i}.", bp[f"bn{i}"], bs[f"bn{i}"])
        if "downsample_conv" in bp:
            sd[dp + "downsample.0.weight"] = conv_weight(
                bp["downsample_conv"]["kernel"])
            batch_norm_entries(sd, dp + "downsample.1.", bp["downsample_bn"],
                               bs["downsample_bn"])


def conv_norm_act_entries(sd, prefix, p, s):
    """timm's ConvNormAct (mobilevit): conv, bn."""
    sd[prefix + "conv.weight"] = conv_weight(p["conv"]["kernel"])
    batch_norm_entries(sd, prefix + "bn.", p["bn"], s["bn"])


def pointwise_entries(sd, prefix, p):
    """A Dense on the channel axis -> timm's 1x1 Conv2d (O, I, 1, 1)."""
    sd[prefix + "weight"] = np.asarray(p["kernel"]).T[:, :, None, None]
    if "bias" in p:
        sd[prefix + "bias"] = np.asarray(p["bias"])


def group_norm_entries(sd, prefix, p):
    sd[prefix + "weight"] = np.asarray(p["scale"])
    sd[prefix + "bias"] = np.asarray(p["bias"])


def mobilevit_entries(sd, prefix, p, s):
    """MobileViTV2Features (timm names: stem.{conv,bn},
    stages.{i}.{j}.*; muvo_tpu's s{i}b{j})."""
    conv_norm_act_entries(sd, prefix + "stem.", p["stem"], s["stem"])
    for name in p:
        if name == "stem":
            continue
        stage, block = name[1:].split("b")
        bp, bs = p[name], s[name]
        dp = f"{prefix}stages.{stage}.{block}."
        if "conv1_1x1" in bp:  # inverted residual
            for part in ("conv1_1x1", "conv2_kxk", "conv3_1x1"):
                conv_norm_act_entries(sd, f"{dp}{part}.", bp[part], bs[part])
            continue
        conv_norm_act_entries(sd, dp + "conv_kxk.", bp["conv_kxk"],
                              bs["conv_kxk"])
        sd[dp + "conv_1x1.weight"] = conv_weight(bp["conv_1x1"]["kernel"])
        for layer in bp:
            if not layer.startswith("tf"):
                continue
            tp, lp = f"{dp}transformer.{layer[2:]}.", bp[layer]
            group_norm_entries(sd, tp + "norm1.", lp["norm1"])
            pointwise_entries(sd, tp + "attn.qkv_proj.",
                              lp["attn"]["qkv_proj"])
            pointwise_entries(sd, tp + "attn.out_proj.",
                              lp["attn"]["out_proj"])
            group_norm_entries(sd, tp + "norm2.", lp["norm2"])
            pointwise_entries(sd, tp + "mlp.fc1.", lp["fc1"])
            pointwise_entries(sd, tp + "mlp.fc2.", lp["fc2"])
        group_norm_entries(sd, dp + "norm.", bp["norm"])
        conv_norm_act_entries(sd, dp + "conv_proj.", bp["conv_proj"],
                              bs["conv_proj"])


def backbone_entries(sd, prefix, p, s):
    """A resnet18 or a mobilevitv2 trunk, by what its tree holds."""
    entries = mobilevit_entries if "stem" in p else resnet_entries
    entries(sd, prefix, p, s)


def point_pillars_entries(sd, prefix, p, s):
    """PointPillarNet: muvo_tpu's fc{i} / bn{i} -> upstream's
    point_net.net.{3i} (Linear) and .{3i + 1} (BatchNorm1d)."""
    for i in range(len([n for n in p if n.startswith("fc")])):
        dense_entries(sd, f"{prefix}point_net.net.{3 * i}.", p[f"fc{i}"])
        batch_norm_entries(sd, f"{prefix}point_net.net.{3 * i + 1}.",
                           p[f"bn{i}"], s[f"bn{i}"])


def conv_bn_entries(sd, prefix, p, s):
    sd[prefix + "0.weight"] = conv_weight(p["Conv_0"]["kernel"])
    batch_norm_entries(sd, prefix + "1.", p["BatchNorm_0"], s["BatchNorm_0"])


def decoder_ds_entries(sd, prefix, p, s):
    conv_bn_entries(sd, prefix + "conv1.", p["conv1"], s["conv1"])
    for name in p:
        if name.startswith("skip"):
            i = int(name[len("skip"):]) - 1
            conv_bn_entries(sd, f"{prefix}downsample_skip_convs.{i}.",
                            p[name], s[name])


def decoder_entries(sd, prefix, p, s):
    """The top-down Decoder: muvo_tpu's skip{j + 2} is upstream's
    upsample_skip_convs.{j} (DecoderDS's skip{j + 1} its
    downsample_skip_convs.{j})."""
    conv_bn_entries(sd, prefix + "conv1.", p["conv1"], s["conv1"])
    for name in p:
        if name.startswith("skip"):
            j = int(name[len("skip"):]) - 2
            conv_bn_entries(sd, f"{prefix}upsample_skip_convs.{j}.", p[name],
                            s[name])


def basic_block_entries(sd, prefix, p, s):
    for i in (1, 2):
        sd[f"{prefix}conv{i}.weight"] = conv_weight(p[f"conv{i}"]["kernel"])
        batch_norm_entries(sd, f"{prefix}bn{i}.", p[f"bn{i}"], s[f"bn{i}"])
    if "ds_conv" in p:
        sd[prefix + "downsample.0.weight"] = conv_weight(p["ds_conv"]["kernel"])
        batch_norm_entries(sd, prefix + "downsample.1.", p["ds_bn"],
                           s["ds_bn"])


def feature_compressor_entries(sd, prefix, p, s):
    basic_block_entries(sd, prefix + "0.", p["block1"], s["block1"])
    basic_block_entries(sd, prefix + "1.", p["block2"], s["block2"])


def route_entries(sd, prefix, p, s):
    resnet_entries(sd, prefix + "backbone.", p["ResNetFeatures_0"],
                   s["ResNetFeatures_0"])
    dense_entries(sd, prefix + "fc.", p["fc"])


def speed_entries(sd, prefix, p):
    dense_entries(sd, prefix + "0.", p["Dense_0"])
    dense_entries(sd, prefix + "2.", p["Dense_1"])


def command_entries(sd, prefix, p):
    """CommandEncoder: flax's Embed table (6, C) is torch's Embedding
    weight as it is."""
    sd[prefix + "0.weight"] = np.asarray(p["Embed_0"]["embedding"])
    dense_entries(sd, prefix + "1.", p["Dense_0"])
    dense_entries(sd, prefix + "3.", p["Dense_1"])


def policy_entries(sd, prefix, p):
    for i in range(4):
        dense_entries(sd, f"{prefix}fc.{2 * i}.", p[f"Dense_{i}"])


def transformer_entries(sd, prefix, p):
    for name in p:
        i = int(name[len("layer"):])
        lp, dp = p[name], f"{prefix}layers.{i}."
        sd[dp + "self_attn.in_proj_weight"] = np.asarray(
            lp["in_proj"]["kernel"]).T
        sd[dp + "self_attn.in_proj_bias"] = np.asarray(lp["in_proj"]["bias"])
        dense_entries(sd, dp + "self_attn.out_proj.", lp["out_proj"])
        dense_entries(sd, dp + "linear1.", lp["linear1"])
        dense_entries(sd, dp + "linear2.", lp["linear2"])
        for norm in ("norm1", "norm2"):
            sd[f"{dp}{norm}.weight"] = np.asarray(lp[norm]["scale"])
            sd[f"{dp}{norm}.bias"] = np.asarray(lp[norm]["bias"])


def rssm_entries(sd, prefix, p):
    dense_entries(sd, prefix + "pre_gru_net.0.", p["pre_gru"])
    for gate in ("ih", "hh"):
        g = p["recurrent_model"][gate]
        sd[f"{prefix}recurrent_model.weight_{gate}"] = np.asarray(g["kernel"]).T
        sd[f"{prefix}recurrent_model.bias_{gate}"] = np.asarray(g["bias"])
    dense_entries(sd, prefix + "posterior_action_module.0.",
                  p["posterior_action_fc"])
    dense_entries(sd, prefix + "prior_action_module.0.", p["prior_action_fc"])
    for net in ("posterior", "prior"):
        dense_entries(sd, f"{prefix}{net}.module.0.", p[f"{net}_net"]["fc1"])
        dense_entries(sd, f"{prefix}{net}.module.2.", p[f"{net}_net"]["fc2"])


def conv_instance_norm_entries(sd, prefix, p):
    conv_bias_entries(sd, prefix + "conv_act.0.", p["conv"])
    dense_entries(sd, prefix + "adaptive_norm.latent_affine.",
                  p["adain"]["latent_affine"])


def decoder_block_entries(sd, prefix, p):
    conv_instance_norm_entries(sd, prefix + "conv1.", p["conv1"])
    conv_instance_norm_entries(sd, prefix + "conv2.", p["conv2"])


def head_entries(sd, prefix, p, head):
    for k in (4, 2, 1):
        conv_bias_entries(sd, f"{prefix}head_{k}.{HEADS[head][1]}.0.",
                          p[f"head_{k}"]["head"])


def segmentation_head_entries(sd, prefix, p):
    """The BEV decoder's heads: muvo_tpu's head_k/{seg,offset,center} ->
    upstream's head_k.{segmentation,instance_offset,instance_center}_head."""
    for k in (4, 2, 1):
        for name, head in (("seg", "segmentation_head"),
                           ("offset", "instance_offset_head"),
                           ("center", "instance_center_head")):
            conv_bias_entries(sd, f"{prefix}head_{k}.{head}.0.",
                              p[f"head_{k}"][name])


def style_decoder_entries(sd, prefix, p, head):
    """The BEV (``head`` "bev") and voxel decoders: a learned constant,
    AdaIN, the first conv, the middle and conv1..3 blocks, the heads."""
    sd[prefix + "constant_tensor"] = np.moveaxis(
        np.asarray(p["constant_tensor"]), -1, 0)
    dense_entries(sd, prefix + "first_norm.latent_affine.",
                  p["first_norm"]["latent_affine"])
    conv_instance_norm_entries(sd, prefix + "first_conv.", p["first_conv"])
    for i in range(3):
        decoder_block_entries(sd, f"{prefix}middle_conv.{i}.", p[f"middle_{i}"])
    for name in ("conv1", "conv2", "conv3"):
        decoder_block_entries(sd, f"{prefix}{name}.", p[name])
    if head == "bev":
        segmentation_head_entries(sd, prefix, p)
    else:
        head_entries(sd, prefix, p, head)


def conv_decoder_entries(sd, prefix, p, head):
    dense_entries(sd, prefix + "linear.0.", p["linear"])
    for i in range(4):
        q = p[f"pre{i}"]
        sd[f"{prefix}pre_transpose_conv.{2 * i}.weight"] = deconv_weight(
            q["kernel"])
        sd[f"{prefix}pre_transpose_conv.{2 * i}.bias"] = np.asarray(q["bias"])
    for i in (1, 2, 3):
        q = p[f"trans_conv{i}"]
        sd[f"{prefix}trans_conv{i}.0.weight"] = deconv_weight(q["kernel"])
        sd[f"{prefix}trans_conv{i}.0.bias"] = np.asarray(q["bias"])
    head_entries(sd, prefix, p, head)


def voxel_decoder_scale_entries(sd, prefix, p):
    """VoxelDecoderScale: the planes' 1x1 weight convs and the classifier
    (muvo_tpu's cls1, cls2 are upstream's classifier.0, classifier.2)."""
    for plane in ("xy", "xz", "yz"):
        conv_bias_entries(sd, f"{prefix}weight_{plane}_decoder.",
                          p[f"weight_{plane}"])
    conv_bias_entries(sd, prefix + "classifier.0.", p["cls1"])
    conv_bias_entries(sd, prefix + "classifier.2.", p["cls2"])


def triplane_entries(sd, prefix, p):
    """TriPlaneVoxelDecoder: one VoxelDecoderScale a scale."""
    for scale in (1, 2, 4):
        voxel_decoder_scale_entries(sd, f"{prefix}decoder_{scale}.",
                                    p[f"decoder_{scale}"])


# (attribute / upstream prefix, head type); muvo_tpu uses the same names
CONV_DECODERS = (("rgb_decoder", "rgb"), ("lidar_re", "lidar_re"),
                 ("lidar_segmentation", "lidar_seg"),
                 ("sem_image_decoder", "sem_image"),
                 ("depth_image_decoder", "depth"))


def to_tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def state_dict_from_jax(params, batch_stats, cfg) -> Dict[str, torch.Tensor]:
    """muvo_tpu MuvoWorldModel variables (numpy-convertible trees) -> the
    port's MuvoWorldModel state_dict, for ``load_state_dict(strict=True)``.
    With ``batch_stats=None`` ``params`` may be a gradient tree: the result
    then holds one entry per parameter and no running statistics."""
    p = params
    s = batch_stats if batch_stats is not None else _NoStats()
    sd: Dict[str, np.ndarray] = {}
    m = cfg.MODEL
    fusion, large = m.TRANSFORMER.ENABLED, m.TRANSFORMER.LARGE
    # the FPNs as convert_reference_state_dict chooses them: the top-down
    # Decoder on the LARGE path, for the camera also under BEV, and every
    # one in the MILE branch; else DecoderDS
    camera_fpn = (decoder_entries if large or m.TRANSFORMER.BEV or not fusion
                  else decoder_ds_entries)
    lidar_fpn = (decoder_entries if large or not fusion
                 else decoder_ds_entries)
    backbone_entries(sd, "encoder.", p["encoder"], s["encoder"])
    camera_fpn(sd, "feat_decoder.", p["feat_decoder"], s["feat_decoder"])
    if "depth_decoder" in p:  # the frustum lifting
        decoder_entries(sd, "depth_decoder.", p["depth_decoder"],
                        s["depth_decoder"])
        conv_bias_entries(sd, "depth.", p["depth_head"])
    if "bev_down_sample_4" in p:
        for i, key in enumerate(("0", "2")):
            conv_bias_entries(sd, f"bev_down_sample_4.{key}.",
                              p["bev_down_sample_4"][f"Conv_{i}"])
    if "lidar_encoder" in p:
        lidar = ("point_pillar" if m.LIDAR.POINT_PILLAR.ENABLED
                 else "range_view")
        if lidar == "point_pillar":
            point_pillars_entries(sd, "point_pillars.", p["point_pillars"],
                                  s["point_pillars"])
        backbone_entries(sd, f"{lidar}_encoder.", p["lidar_encoder"],
                         s["lidar_encoder"])
        lidar_fpn(sd, f"{lidar}_decoder.", p["lidar_decoder"],
                  s["lidar_decoder"])
    if fusion:
        sd["type_embedding"] = np.asarray(p["type_embedding"])
        transformer_entries(sd, "transformer_encoder.", p["transformer"])
        for name in ("image_feature_conv", "lidar_feature_conv"):
            feature_compressor_entries(sd, name + ".", p[name], s[name])
        dense_entries(sd, "features_combine.", p["features_combine"])
    else:
        backbone_entries(sd, "backbone_bev.", p["backbone_bev"],
                         s["backbone_bev"])
        feature_compressor_entries(sd, "final_state_conv.",
                                   p["final_state_conv"],
                                   s["final_state_conv"])
        if "lidar_state_conv" in p:
            feature_compressor_entries(sd, "lidar_state_conv.",
                                       p["lidar_state_conv"],
                                       s["lidar_state_conv"])
            dense_entries(sd, "embedding_combine.", p["embedding_combine"])
    if m.ROUTE.ENABLED:
        route_entries(sd, "backbone_route.", p["backbone_route"],
                      s["backbone_route"])
    if "command_encoder" in p:  # MODEL.MEASUREMENTS
        command_entries(sd, "command_encoder.", p["command_encoder"])
        command_entries(sd, "command_next_encoder.", p["command_next_encoder"])
        speed_entries(sd, "gps_encoder.", p["gps_encoder"])  # same layout
    speed_entries(sd, "speed_enc.", p["speed_enc"])
    if "rssm" in p:
        rssm_entries(sd, "rssm.", p["rssm"])
    policy_entries(sd, "policy.", p["policy"])
    if "bev_decoder" in p:
        style_decoder_entries(sd, "bev_decoder.", p["bev_decoder"], "bev")
    for name, head in CONV_DECODERS:
        if name in p:
            conv_decoder_entries(sd, name + ".", p[name], head)
    if "voxel_decoder" in p:
        style_decoder_entries(sd, "voxel_decoder.", p["voxel_decoder"],
                              "voxel")
    return to_tensors(sd)


def running_stats(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The BatchNorm running statistics of a state_dict."""
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def flat_rows(kernel, flat_shape) -> np.ndarray:
    """A Dense kernel whose leading C*H*W rows read NHWC-flattened features
    (muvo_tpu's order (H, W, C)), as the Linear weight of NCHW-flattened
    ones (the port's order (C, H, W)); the trailing rows keep theirs."""
    c, h, w = flat_shape
    k = np.asarray(kernel)
    perm = np.arange(c * h * w).reshape(h, w, c).transpose(2, 0, 1).reshape(-1)
    return np.concatenate([k[perm], k[c * h * w:]], axis=0).T


def ppo_state_dict_from_jax(params, policy) -> Dict[str, torch.Tensor]:
    """muvo_tpu PpoPolicy params (numpy-convertible) -> the state_dict of
    the port's ``policy`` (rl/policy.py, built with the same feature
    extractor, distribution and birdview shape), for
    ``load_state_dict(strict=True)``. Keys are carla-roach's rl_birdview
    names: ``features_extractor.{cnn.{0,2,..,10}, state_linear.0,
    linear.{0,2}}`` for XtMaCNN (``stacks.{i}.firstconv``,
    ``stacks.{i}.blocks.{n}.conv{0,1}``, ``dense`` for ImpalaCNN),
    ``policy_head.{0,2}``, ``value_head.{0,2,4}``, ``dist_mu`` and
    ``dist_sigma``."""
    from muvo_tpu_torch.rl.networks import ImpalaCNN

    p = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}
    f, fx = p["features"], policy.features_extractor
    pre = "features_extractor."
    if isinstance(fx, ImpalaCNN):
        for i in range(len(fx.stacks)):
            conv_bias_entries(sd, f"{pre}stacks.{i}.firstconv.",
                              f[f"Conv_{i}"])
            for n in range(fx.nblock):
                block = f[f"_ImpalaResBlock_{i * fx.nblock + n}"]
                for j in range(2):
                    conv_bias_entries(
                        sd, f"{pre}stacks.{i}.blocks.{n}.conv{j}.",
                        block[f"Conv_{j}"])
        fused = [(f"{pre}dense.", f["Dense_1"])]
    else:
        for i in range(6):
            conv_bias_entries(sd, f"{pre}cnn.{2 * i}.", f[f"Conv_{i}"])
        fused = [(f"{pre}linear.0.", f["Dense_1"]),
                 (f"{pre}linear.2.", f["Dense_2"])]
    dense_entries(sd, f"{pre}state_linear.0.", f["Dense_0"])
    (first, dense), *rest = fused
    sd[first + "weight"] = flat_rows(dense["kernel"], fx.flat_shape)
    sd[first + "bias"] = np.asarray(dense["bias"])
    for prefix, dense in rest:
        dense_entries(sd, prefix, dense)
    for i in range(len(policy.policy_head) // 2):
        dense_entries(sd, f"policy_head.{2 * i}.", p[f"pi_fc{i}"])
    n_vf = len(policy.value_head) // 2
    for i in range(n_vf):
        dense_entries(sd, f"value_head.{2 * i}.", p[f"vf_fc{i}"])
    dense_entries(sd, f"value_head.{2 * n_vf}.", p["vf_out"])
    if policy.distribution == "beta":
        dense_entries(sd, "dist_mu.0.", p["dist_alpha"])
        dense_entries(sd, "dist_sigma.0.", p["dist_beta"])
    else:
        dense_entries(sd, "dist_mu.", p["dist_mu"])
        sd["dist_sigma"] = np.asarray(p["log_std"])
    return to_tensors(sd)
