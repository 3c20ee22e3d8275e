"""muvo_tpu parameters -> the port's state_dict (upstream MUVO's keys).

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


def voxel_decoder_entries(sd, prefix, p):
    sd[prefix + "constant_tensor"] = np.moveaxis(
        np.asarray(p["constant_tensor"]), -1, 0)
    dense_entries(sd, prefix + "first_norm.latent_affine.",
                  p["first_norm"]["latent_affine"])
    conv_instance_norm_entries(sd, prefix + "first_conv.", p["first_conv"])
    for i in range(3):
        decoder_block_entries(sd, f"{prefix}middle_conv.{i}.", p[f"middle_{i}"])
    for name in ("conv1", "conv2", "conv3"):
        decoder_block_entries(sd, f"{prefix}{name}.", p[name])
    head_entries(sd, prefix, p, "voxel")


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
    # the FPNs: the top-down Decoder on the LARGE path (as
    # convert_reference_state_dict chooses), else DecoderDS
    fpn = (decoder_entries if cfg.MODEL.TRANSFORMER.LARGE
           else decoder_ds_entries)
    resnet_entries(sd, "encoder.", p["encoder"], s["encoder"])
    fpn(sd, "feat_decoder.", p["feat_decoder"], s["feat_decoder"])
    resnet_entries(sd, "range_view_encoder.", p["lidar_encoder"],
                   s["lidar_encoder"])
    fpn(sd, "range_view_decoder.", p["lidar_decoder"], s["lidar_decoder"])
    sd["type_embedding"] = np.asarray(p["type_embedding"])
    transformer_entries(sd, "transformer_encoder.", p["transformer"])
    for name in ("image_feature_conv", "lidar_feature_conv"):
        feature_compressor_entries(sd, name + ".", p[name], s[name])
    if cfg.MODEL.ROUTE.ENABLED:
        route_entries(sd, "backbone_route.", p["backbone_route"],
                      s["backbone_route"])
    speed_entries(sd, "speed_enc.", p["speed_enc"])
    dense_entries(sd, "features_combine.", p["features_combine"])
    rssm_entries(sd, "rssm.", p["rssm"])
    policy_entries(sd, "policy.", p["policy"])
    for name, head in CONV_DECODERS:
        if name in p:
            conv_decoder_entries(sd, name + ".", p[name], head)
    if "voxel_decoder" in p:
        voxel_decoder_entries(sd, "voxel_decoder.", p["voxel_decoder"])
    return to_tensors(sd)


def running_stats(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The BatchNorm running statistics of a state_dict."""
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}
