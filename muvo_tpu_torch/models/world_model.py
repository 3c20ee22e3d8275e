"""MUVO world model, flagship branch (counterpart of
muvo_tpu/models/world_model.py).

Camera and LiDAR encoders with bottom-up FPNs, a post-LN transformer
fusing their tokens, route and speed encoders, the RSSM, the policy, and
the enabled decoders (the BEV decoder; the rgb, lidar_re,
lidar_segmentation, semantic-image and depth ConvDecoders; the voxel
decoder). Batch tensors are channels-last, (b, s, ...) as in muvo_tpu;
submodule names are upstream MUVO's state_dict prefixes.

``forward`` is the training and evaluation pass over a sequence (muvo_tpu's
``__call__``): encode every frame, roll the RSSM over the sequence, then the
policy and every decoder on the posterior states. MODEL.REMAT (with
REMAT_SCOPE) recomputes the decoders in the backward pass instead of
storing their activations, and MODEL.REMAT_ENCODER does the same for the
resnet encoders, through torch.utils.checkpoint; the recompute leaves the
BatchNorm running statistics alone.

MODEL.TRANSFORMER.LARGE aggregates stride-8 features with the top-down
Decoder (5,184 tokens a frame at muvo.yml's sizes), and the transformer's
attention takes the flash kernels on the card. The tokens run at their
true count: muvo_tpu pads them once to the flash block multiple because
the TPU's BlockSpec tiles cannot be ragged, and the port's kernels mask
the ragged tail themselves.

The LiDAR encoder reads the range view, or with
MODEL.LIDAR.POINT_PILLAR the PointPillars canvas of the raw points
(``point_pillars``, ``point_pillar_encoder``, ``point_pillar_decoder``, as
upstream names them). The encoders are resnet18 or mobilevitv2 trunks
(MODEL.ENCODER.NAME, MODEL.LIDAR.ENCODER). SEMANTIC_SEG adds the BEV
decoder. Branches outside the ported slices (frustum-BEV fusion, the
no-transformer MILE branch, measurements, TRANSITION.ENABLED False) raise
NotImplementedError instead of running something else.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from muvo_tpu_torch.models.backbones.resnet import build_backbone
from muvo_tpu_torch.models.common import (
    Decoder,
    DecoderDS,
    FeatureCompressor,
    Policy,
    RouteEncode,
    SpeedEncoder,
    position_embedding_sine,
)
from muvo_tpu_torch.models.layers import frozen_batch_stats
from muvo_tpu_torch.models.pointpillars import PointPillarNet
from muvo_tpu_torch.models.rssm import RSSM
from muvo_tpu_torch.models.stylegan import (BevDecoder, ConvDecoder,
                                            VoxelDecoder)
from muvo_tpu_torch.models.transformer import TransformerEncoder
from muvo_tpu_torch.utils.network import pack_sequence_dim, unpack_sequence_dim


def checkpointed(fn, *args):
    """fn(*args) under torch.utils.checkpoint when autograd records it, so
    its activations are recomputed in the backward pass; the recompute
    runs with frozen BatchNorm running statistics."""
    if not torch.is_grad_enabled():
        return fn(*args)
    calls = []

    def run(*a):
        calls.append(None)
        with frozen_batch_stats(len(calls) > 1):
            return fn(*a)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def _check_supported(cfg):
    m = cfg.MODEL
    unsupported = {
        "the MILE branch (MODEL.TRANSFORMER.ENABLED False)":
            not m.TRANSFORMER.ENABLED,
        "frustum-BEV fusion (MODEL.TRANSFORMER.BEV)": m.TRANSFORMER.BEV,
        "MODEL.LIDAR.ENABLED False": not m.LIDAR.ENABLED,
        "MODEL.MEASUREMENTS": m.MEASUREMENTS.ENABLED,
        "MODEL.TRANSITION.ENABLED False": not m.TRANSITION.ENABLED,
    }
    missing = [k for k, v in unsupported.items() if v]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")


class MuvoWorldModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        m = cfg.MODEL
        tf_c = m.TRANSFORMER.CHANNELS
        emb = m.EMBEDDING_DIM

        # ---- encoders ------------------------------------------------
        fpn = Decoder if m.TRANSFORMER.LARGE else DecoderDS
        self.encoder, enc_c = build_backbone(m.ENCODER.NAME)
        self.feat_decoder = fpn(enc_c, tf_c)
        self.point_pillar = bool(m.LIDAR.POINT_PILLAR.ENABLED)
        if self.point_pillar:
            self.point_pillars = PointPillarNet()
            self.point_pillar_encoder, lidar_c = build_backbone(
                m.LIDAR.ENCODER, in_channels=self.point_pillars.out_channels)
            self.point_pillar_decoder = fpn(lidar_c, tf_c)
        else:
            self.range_view_encoder, lidar_c = build_backbone(
                m.LIDAR.ENCODER, in_channels=4)
            self.range_view_decoder = fpn(lidar_c, tf_c)
        self.type_embedding = nn.Parameter(torch.zeros(1, 1, tf_c, 2))
        self.transformer_encoder = TransformerEncoder(
            tf_c, m.TRANSFORMER.N_LAYERS, m.TRANSFORMER.N_HEADS,
            m.TRANSFORMER.DIM_FEEDFORWARD)
        self.image_feature_conv = FeatureCompressor(tf_c, emb)
        self.lidar_feature_conv = FeatureCompressor(tf_c, emb)
        feature_n = 2 * emb
        if m.ROUTE.ENABLED:
            self.backbone_route = RouteEncode(m.ROUTE.CHANNELS,
                                              m.ROUTE.BACKBONE)
            feature_n += m.ROUTE.CHANNELS
        self.speed_enc = SpeedEncoder(m.SPEED.CHANNELS,
                                      cfg.SPEED.NORMALISATION)
        feature_n += m.SPEED.CHANNELS
        self.features_combine = nn.Linear(feature_n, emb)

        # ---- transition and policy -----------------------------------
        t = m.TRANSITION
        self.rssm = RSSM(emb, m.ACTION_DIM, t.HIDDEN_STATE_DIM, t.STATE_DIM,
                         t.ACTION_LATENT_DIM, t.USE_DROPOUT,
                         t.DROPOUT_PROBABILITY)
        state_dim = t.HIDDEN_STATE_DIM + t.STATE_DIM
        self.policy = Policy(state_dim)

        # ---- decoders: constants are target size / 64 (six 2x steps) --
        crop_h = cfg.IMAGE.CROP[3] - cfg.IMAGE.CROP[1]
        crop_w = cfg.IMAGE.CROP[2] - cfg.IMAGE.CROP[0]
        img_const = (max(1, crop_h // 64), max(1, crop_w // 64))
        lidar_const = (max(1, cfg.POINTS.CHANNELS // 64),
                       max(1, cfg.POINTS.HORIZON_RESOLUTION // 64))
        voxel_const = tuple(max(1, v // 64) for v in cfg.VOXEL.SIZE)
        bev_const = (max(1, cfg.BEV.SIZE[1] // 64),
                     max(1, cfg.BEV.SIZE[0] // 64))
        base_c = int(m.DECODER_BASE_CHANNELS)
        self.decoder_names = []
        if cfg.SEMANTIC_SEG.ENABLED:
            self.bev_decoder = BevDecoder(state_dim,
                                          cfg.SEMANTIC_SEG.N_CHANNELS,
                                          bev_const, base_c)
            self.decoder_names.append("bev_decoder")
        # (enabled, attribute = upstream prefix, out channels, constant, head)
        conv_decoders = (
            (cfg.EVAL.RGB_SUPERVISION, "rgb_decoder", 3, img_const, "rgb"),
            (cfg.LIDAR_RE.ENABLED, "lidar_re", cfg.LIDAR_RE.N_CHANNELS,
             lidar_const, "lidar_re"),
            (cfg.LIDAR_SEG.ENABLED, "lidar_segmentation",
             cfg.LIDAR_SEG.N_CLASSES, lidar_const, "lidar_seg"),
            (cfg.SEMANTIC_IMAGE.ENABLED, "sem_image_decoder",
             cfg.SEMANTIC_IMAGE.N_CLASSES, img_const, "sem_image"),
            (cfg.DEPTH.ENABLED, "depth_image_decoder", 1, img_const, "depth"),
        )
        for enabled, name, out_c, const, head in conv_decoders:
            if enabled:
                setattr(self, name, ConvDecoder(state_dim, out_c, const, head,
                                                base_c))
                self.decoder_names.append(name)
        if cfg.VOXEL_SEG.ENABLED:
            self.voxel_decoder = VoxelDecoder(
                state_dim, cfg.VOXEL_SEG.N_CLASSES, cfg.VOXEL_SEG.DIMENSION,
                voxel_const)
            self.decoder_names.append("voxel_decoder")

        scope = str(m.REMAT_SCOPE)
        if scope not in ("all", "voxel"):
            raise ValueError(f"MODEL.REMAT_SCOPE must be 'all' or 'voxel', "
                             f"got {scope!r}")
        self.remat_decoders = (
            set() if not m.REMAT else {"voxel_decoder"} if scope == "voxel"
            else set(self.decoder_names))
        self.remat_encoder = bool(m.REMAT_ENCODER)

    # ==================================================================
    def _backbone(self, module, x):
        if self.remat_encoder:
            return checkpointed(module, x)
        return module(x)

    def encode(self, batch: Dict, dropout: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-frame sensor fusion of a preprocessed batch -> (b, s, emb).
        ``dropout`` turns the transformer's dropout on (training)."""
        b, s = batch["image"].shape[:2]
        tf_c = self.cfg.MODEL.TRANSFORMER.CHANNELS
        x = self.feat_decoder(self._backbone(
            self.encoder, pack_sequence_dim(batch["image"])))
        lidar = self._lidar_features(batch)

        h_i, w_i = x.shape[1:3]
        h_l, w_l = lidar.shape[1:3]
        image_tokens = x + position_embedding_sine(
            h_i, w_i, tf_c // 2, device=x.device).to(x.dtype)
        lidar_tokens = lidar + position_embedding_sine(
            h_l, w_l, tf_c // 2, device=x.device).to(x.dtype)
        image_tokens = (image_tokens.reshape(-1, h_i * w_i, tf_c)
                        + self.type_embedding[:, :, :, 0])
        lidar_tokens = (lidar_tokens.reshape(-1, h_l * w_l, tf_c)
                        + self.type_embedding[:, :, :, 1])
        tokens = self.transformer_encoder(
            torch.cat([image_tokens, lidar_tokens], dim=1), train=dropout,
            generator=generator)
        image_out = tokens[:, :h_i * w_i].reshape(-1, h_i, w_i, tf_c)
        lidar_out = tokens[:, h_i * w_i:].reshape(-1, h_l, w_l, tf_c)

        features = [self.image_feature_conv(image_out),
                    self.lidar_feature_conv(lidar_out)]
        if self.cfg.MODEL.ROUTE.ENABLED:
            features.append(self.backbone_route(
                pack_sequence_dim(batch["route_map"])))
        features.append(self.speed_enc(pack_sequence_dim(batch["speed"])))
        embedding = self.features_combine(torch.cat(features, dim=-1))
        return unpack_sequence_dim(embedding, b, s)

    def _lidar_features(self, batch: Dict) -> torch.Tensor:
        """The LiDAR branch's FPN features: of the PointPillars canvas of
        ``points_raw`` / ``num_points``, or of the range view."""
        if self.point_pillar:
            canvas = self.point_pillars(pack_sequence_dim(batch["points_raw"]),
                                        pack_sequence_dim(batch["num_points"]))
            return self.point_pillar_decoder(self._backbone(
                self.point_pillar_encoder, canvas))
        return self.range_view_decoder(self._backbone(
            self.range_view_encoder,
            pack_sequence_dim(batch["range_view_pcd_xyzd"])))

    def encode_frame(self, batch: Dict) -> torch.Tensor:
        """Embedding of the last frame: (b, emb)."""
        return self.encode(batch)[:, -1]

    def decode_state(self, state: torch.Tensor, b: int, s: int) -> Dict:
        """Every enabled decoder on the packed state (b*s, state_dim)."""
        output: Dict = {}
        for name in self.decoder_names:
            decoder = getattr(self, name)
            out = (checkpointed(decoder, state) if name in self.remat_decoders
                   else decoder(state))
            output.update(unpack_sequence_dim(out, b, s))
        return output

    def forward(self, batch: Dict, training: bool = False,
                generator: Optional[torch.Generator] = None,
                stochastic: bool = True) -> Tuple[Dict, Dict]:
        """The reconstruction pass over a preprocessed (b, s, ...) batch
        (muvo_tpu's ``__call__``): (output, state_dict). The BatchNorm
        layers follow the module's train()/eval() mode; ``training`` turns
        on the transformer dropout and the RSSM's posterior dropout.
        ``stochastic=False`` takes the mean of every latent distribution and
        no dropout at all, for checks against another run."""
        b, s = batch["image"].shape[:2]
        noisy = training and stochastic
        embedding = self.encode(batch, noisy, generator)
        action = torch.cat([batch["throttle_brake"], batch["steering"]],
                           dim=-1).to(embedding.dtype)
        state_dict = self.rssm(embedding, action, use_sample=stochastic,
                               training=noisy, generator=generator)
        output: Dict = dict(state_dict)
        posterior = state_dict["posterior"]
        state = torch.cat([posterior["hidden_state"], posterior["sample"]],
                          dim=-1)
        packed = pack_sequence_dim(state)
        throttle_brake, steering = self.policy(packed).chunk(2, dim=-1)
        output["throttle_brake"] = unpack_sequence_dim(throttle_brake, b, s)
        output["steering"] = unpack_sequence_dim(steering, b, s)
        output.update(self.decode_state(packed, b, s))
        return output, state_dict

    def policy_forward(self, state):
        return self.policy(state)

    def observe_step(self, h_t, sample_t, action_t, embedding_t,
                     use_sample: bool = True,
                     generator: Optional[torch.Generator] = None):
        return self.rssm.observe_step(h_t, sample_t, action_t, embedding_t,
                                      use_sample, generator)

    def imagine_step(self, h_t, sample_t, action_t, use_sample: bool = True,
                     generator: Optional[torch.Generator] = None):
        return self.rssm.imagine_step(h_t, sample_t, action_t, use_sample,
                                      generator)

    # ==================================================================
    def imagine(self, batch: Dict, predict_action: bool = False,
                future_horizon: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                use_sample: bool = True) -> Dict:
        """Prior rollout from a latent state, then decoding.

        batch: hidden_state (b, C_h), sample (b, C_s) and, unless
        predict_action, throttle_brake / steering (b, T, 1).
        ``use_sample=False`` rolls the prior mean (deterministic; for
        parity tests, since torch and JAX noise streams differ).
        """
        fh = (future_horizon if future_horizon is not None
              else self.cfg.FUTURE_HORIZON)
        h, smp = batch["hidden_state"], batch["sample"]
        b = h.shape[0]
        if not predict_action:
            actions = torch.cat([batch["throttle_brake"][:, :fh],
                                 batch["steering"][:, :fh]], dim=-1)
        rolled = {"action": [], "hidden": [], "sample": [], "state": []}
        for t in range(fh):
            state = torch.cat([h, smp], dim=-1)
            action_t = self.policy(state) if predict_action else actions[:, t]
            prior = self.rssm.imagine_step(h, smp, action_t, use_sample,
                                           generator)
            h, smp = prior["hidden_state"], prior["sample"]
            rolled["action"].append(action_t)
            rolled["hidden"].append(h)
            rolled["sample"].append(smp)
            rolled["state"].append(torch.cat([h, smp], dim=-1))
        output = {k: torch.stack(v, dim=1) for k, v in rolled.items()}

        packed_state = pack_sequence_dim(output["state"])
        throttle_brake, steering = self.policy(packed_state).chunk(2, dim=-1)
        output["throttle_brake"] = unpack_sequence_dim(throttle_brake, b, fh)
        output["steering"] = unpack_sequence_dim(steering, b, fh)
        output.update(self.decode_state(packed_state, b, fh))
        return output

    def observe_and_imagine(self, batch: Dict, predict_action: bool = False,
                            future_horizon: Optional[int] = None,
                            generator: Optional[torch.Generator] = None,
                            stochastic: bool = True) -> Tuple[Dict, Dict]:
        """Posterior observation of the first RECEPTIVE_FIELD frames of a
        preprocessed batch, then the prior imagination from its last state
        (upstream mile.py:684-769): (output_observe, output_imagine).
        ``generator`` draws the observation's noise, then the
        imagination's; ``stochastic=False`` takes the mean of every latent
        distribution in both."""
        s = self.cfg.RECEPTIVE_FIELD
        past = {k: v[:, :s] for k, v in batch.items()}
        future = {k: v[:, s:] for k, v in batch.items()}
        output_observe, state_dict = self(past, training=False,
                                          generator=generator,
                                          stochastic=stochastic)
        start = imagine_inputs(*last_state(state_dict),
                               None if predict_action else future)
        output_imagine = self.imagine(start, predict_action, future_horizon,
                                      generator, stochastic)
        return output_observe, output_imagine


def last_state(state_dict: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The last posterior (hidden_state, sample) of a forward's
    ``state_dict``: where an imagination starts."""
    posterior = state_dict["posterior"]
    return posterior["hidden_state"][:, -1], posterior["sample"][:, -1]


def imagine_inputs(hidden_state: torch.Tensor, sample: torch.Tensor,
                   future: Optional[Dict] = None) -> Dict:
    """The batch of ``MuvoWorldModel.imagine``: the state it starts from
    and, where ``future`` (the frames to imagine) is given, their actions;
    without it the policy predicts them."""
    inputs = {"hidden_state": hidden_state, "sample": sample}
    if future is not None:
        inputs["throttle_brake"] = future["throttle_brake"]
        inputs["steering"] = future["steering"]
    return inputs
