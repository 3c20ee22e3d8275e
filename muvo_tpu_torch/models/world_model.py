"""MUVO world model (counterpart of muvo_tpu/models/world_model.py).

Camera and LiDAR encoders, their fusion into one embedding a frame, route
and speed encoders, the RSSM, the policy, and the enabled decoders (the
BEV decoder; the rgb, lidar_re, lidar_segmentation, semantic-image and
depth ConvDecoders; the voxel decoder). Batch tensors are channels-last,
(b, s, ...) as in muvo_tpu; submodule names are upstream MUVO's
state_dict prefixes.

Two fusion branches, as upstream's mile.py:

- MODEL.TRANSFORMER.ENABLED: the camera's and the LiDAR's FPN features
  become tokens of a post-LN transformer. MODEL.TRANSFORMER.LARGE
  aggregates stride-8 features with the top-down Decoder (5,184 tokens a
  frame at muvo.yml's sizes), and the attention takes the flash kernels
  on the card; the tokens run at their true count (muvo_tpu pads them to
  the flash block multiple because the TPU's BlockSpec tiles cannot be
  ragged; the port's kernels mask the ragged tail themselves).
  MODEL.TRANSFORMER.BEV lifts the stride-8 camera features into a BEV
  grid first (``depth_decoder``, the 1x1 ``depth`` head, FrustumPooling),
  then shrinks it 4x (``bev_down_sample_4``) unless LARGE.
- The MILE branch (TRANSFORMER.ENABLED False): the stride-8 camera
  features lifted into the BEV grid (or, with EVAL.NO_LIFTING, as they
  are), the route and speed features broadcast over it, ``backbone_bev``
  and ``final_state_conv``; with LiDAR (MODEL.LIDAR.ENABLED) the LiDAR
  features compressed by ``lidar_state_conv`` and joined by
  ``embedding_combine``.

The LiDAR encoder reads the range view, or with MODEL.LIDAR.POINT_PILLAR
the PointPillars canvas of the raw points (``point_pillars``,
``point_pillar_encoder``, ``point_pillar_decoder``, as upstream names
them). The encoders are resnet18, resnet34 or mobilevitv2 trunks
(MODEL.ENCODER.NAME, MODEL.LIDAR.ENCODER). MODEL.MEASUREMENTS adds the
route-command, next route-command and GPS encoders (``command_encoder``,
``command_next_encoder``, ``gps_encoder``), whose features join the route
and speed features in either branch. MODEL.TRANSITION.ENABLED False drops
the RSSM: the state is the embedding. The transformer branch without LiDAR
raises NotImplementedError instead of running something else: muvo_tpu
cannot run it either (its transformer branch always reads the LiDAR
features).

``forward`` is the training and evaluation pass over a sequence (muvo_tpu's
``__call__``): encode every frame, roll the RSSM over the sequence, then the
policy and every decoder on the posterior states. MODEL.REMAT (with
REMAT_SCOPE) recomputes the decoders in the backward pass instead of
storing their activations, and MODEL.REMAT_ENCODER does the same for the
resnet encoders, through torch.utils.checkpoint; the recompute leaves the
BatchNorm running statistics alone.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from muvo_tpu_torch.models.backbones.resnet import build_backbone
from muvo_tpu_torch.models.common import (
    BevDownSample4,
    CommandEncoder,
    Decoder,
    DecoderDS,
    FeatureCompressor,
    GpsEncoder,
    Policy,
    RouteEncode,
    SpeedEncoder,
    position_embedding_sine,
)
from muvo_tpu_torch.models.frustum import FrustumPooling
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
        "the transformer branch without LiDAR (MODEL.TRANSFORMER.ENABLED "
        "with MODEL.LIDAR.ENABLED False; muvo_tpu cannot run it either)":
            m.TRANSFORMER.ENABLED and not m.LIDAR.ENABLED,
    }
    missing = [k for k, v in unsupported.items() if v]
    if missing:
        raise NotImplementedError(f"not supported: {', '.join(missing)}")


class MuvoWorldModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        m = cfg.MODEL
        tf_c = m.TRANSFORMER.CHANNELS
        emb = m.EMBEDDING_DIM

        # ---- encoders ------------------------------------------------
        self.fusion = bool(m.TRANSFORMER.ENABLED)
        self.encoder, enc_c = build_backbone(m.ENCODER.NAME)
        if self.fusion:
            feat_c = tf_c
            # the transformer's FPNs: top-down on the LARGE path; the camera
            # FPN top-down also under BEV (upstream's mile.py:32-34)
            fpn = Decoder if m.TRANSFORMER.LARGE else DecoderDS
            self.feat_decoder = (Decoder if m.TRANSFORMER.BEV else fpn)(
                enc_c, tf_c)
            self.lifting = bool(m.TRANSFORMER.BEV)
        else:
            feat_c = m.ENCODER.OUT_CHANNELS
            fpn = Decoder
            self.feat_decoder = Decoder(enc_c, feat_c)
            self.lifting = not cfg.EVAL.NO_LIFTING
        bev_c = feat_c
        if self.lifting:
            ds = cfg.BEV.FEATURE_DOWNSAMPLE
            pool = cfg.BEV.FRUSTUM_POOL
            self.frustum_pooling = FrustumPooling(
                size=(cfg.BEV.SIZE[0] // ds, cfg.BEV.SIZE[1] // ds),
                scale=cfg.BEV.RESOLUTION * ds,
                offsetx=cfg.BEV.OFFSET_FORWARD / ds, dbound=pool.D_BOUND,
                downsample=8, sparse=pool.SPARSE,
                sparse_count=pool.SPARSE_COUNT)
            self.depth_decoder = Decoder(enc_c, feat_c)
            self.depth = nn.Conv2d(feat_c, self.frustum_pooling.D, 1)
            bev_c = feat_c * self.frustum_pooling.nx[2]
        self.down_sample_bev = (self.fusion and self.lifting
                                and not m.TRANSFORMER.LARGE)
        if self.down_sample_bev:
            self.bev_down_sample_4 = BevDownSample4(bev_c, tf_c)

        self.lidar = bool(m.LIDAR.ENABLED)
        self.point_pillar = self.lidar and bool(m.LIDAR.POINT_PILLAR.ENABLED)
        lidar_out_c = tf_c if self.fusion else m.LIDAR.OUT_CHANNELS
        if self.point_pillar:
            self.point_pillars = PointPillarNet()
            self.point_pillar_encoder, lidar_c = build_backbone(
                m.LIDAR.ENCODER, in_channels=self.point_pillars.out_channels)
            self.point_pillar_decoder = fpn(lidar_c, lidar_out_c)
        elif self.lidar:
            self.range_view_encoder, lidar_c = build_backbone(
                m.LIDAR.ENCODER, in_channels=4)
            self.range_view_decoder = fpn(lidar_c, lidar_out_c)
        # (modules in the order that seeds the transformer branch's weights
        # as before the other branches were ported)
        if self.fusion:
            self.type_embedding = nn.Parameter(torch.zeros(1, 1, tf_c, 2))
            self.transformer_encoder = TransformerEncoder(
                tf_c, m.TRANSFORMER.N_LAYERS, m.TRANSFORMER.N_HEADS,
                m.TRANSFORMER.DIM_FEEDFORWARD)
            self.image_feature_conv = FeatureCompressor(tf_c, emb)
            self.lidar_feature_conv = FeatureCompressor(tf_c, emb)
        if m.ROUTE.ENABLED:
            self.backbone_route = RouteEncode(m.ROUTE.CHANNELS,
                                              m.ROUTE.BACKBONE)
        self.measurements = bool(m.MEASUREMENTS.ENABLED)
        if self.measurements:
            cc = m.MEASUREMENTS.COMMAND_CHANNELS
            self.command_encoder = CommandEncoder(cc)
            self.command_next_encoder = CommandEncoder(cc)
            self.gps_encoder = GpsEncoder(m.MEASUREMENTS.GPS_CHANNELS)
        self.speed_enc = SpeedEncoder(m.SPEED.CHANNELS,
                                      cfg.SPEED.NORMALISATION)
        # the route, measurement and speed features' width
        vector_c = m.SPEED.CHANNELS + (m.ROUTE.CHANNELS if m.ROUTE.ENABLED
                                       else 0)
        if self.measurements:
            vector_c += (2 * m.MEASUREMENTS.COMMAND_CHANNELS
                         + m.MEASUREMENTS.GPS_CHANNELS)
        if self.fusion:
            self.features_combine = nn.Linear(2 * emb + vector_c, emb)
        else:
            self.backbone_bev, (trunk_c,) = build_backbone(
                m.BEV.BACKBONE, out_indices=(3,),
                in_channels=bev_c + vector_c)
            self.final_state_conv = FeatureCompressor(trunk_c, emb)
            if self.lidar:
                self.lidar_state_conv = FeatureCompressor(
                    lidar_out_c, emb, strides=(2, 2))
                self.embedding_combine = nn.Linear(2 * emb, emb)

        # ---- transition and policy -----------------------------------
        t = m.TRANSITION
        if t.ENABLED:
            self.rssm = RSSM(emb, m.ACTION_DIM, t.HIDDEN_STATE_DIM,
                             t.STATE_DIM, t.ACTION_LATENT_DIM, t.USE_DROPOUT,
                             t.DROPOUT_PROBABILITY)
            state_dim = t.HIDDEN_STATE_DIM + t.STATE_DIM
        else:
            self.rssm = None
            state_dim = emb
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

    def reference_init(self, generator):
        # the model's own tensor (the transformer branch): type_embedding
        # starts at zeros (muvo_tpu/models/world_model.py:102); every
        # submodule has its rule in models/init.py or its own module
        return {"type_embedding": torch.zeros(self.type_embedding.shape)}

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
        xs = self._backbone(self.encoder, pack_sequence_dim(batch["image"]))
        x = self.feat_decoder(xs)
        if self.lifting:
            x = self._lift(xs, x, batch)
        if self.fusion:
            if self.down_sample_bev:
                x = self.bev_down_sample_4(x)
            embedding = self._fuse_tokens(x, batch, dropout, generator)
        else:
            embedding = self._bev_embedding(x, batch)
        return unpack_sequence_dim(embedding, b, s)

    def _lift(self, xs, x, batch: Dict) -> torch.Tensor:
        """The stride-8 features ``x`` pooled into the BEV grid along the
        depth distribution of ``depth_decoder`` (a softmax over the
        frustum's depth bins)."""
        d = self.depth_decoder(xs)
        w = self.depth.weight
        depth = torch.softmax(F.linear(d, w.reshape(w.shape[0], -1),
                                       self.depth.bias), dim=-1)
        return self.frustum_pooling(
            x, depth, pack_sequence_dim(batch["intrinsics"]),
            pack_sequence_dim(batch["extrinsics"]))

    def _fuse_tokens(self, x, batch: Dict, dropout: bool,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        """The transformer branch: camera and LiDAR tokens fused, then
        compressed and joined with the route, measurement and speed
        features."""
        tf_c = self.cfg.MODEL.TRANSFORMER.CHANNELS
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
                    self.lidar_feature_conv(lidar_out),
                    *self._vector_features(batch)]
        return self.features_combine(torch.cat(features, dim=-1))

    def _vector_features(self, batch: Dict):
        """The route and the measurements (where enabled) and the speed
        features, (b*s, C) each, in muvo_tpu's order: route, route command,
        next route command, GPS, speed."""
        features = []
        if self.cfg.MODEL.ROUTE.ENABLED:
            features.append(self.backbone_route(
                pack_sequence_dim(batch["route_map"])))
        if self.measurements:
            gps = torch.cat([batch["gps_vector"], batch["gps_vector_next"]],
                            dim=-1)
            features += [
                self.command_encoder(
                    pack_sequence_dim(batch["route_command"])),
                self.command_next_encoder(
                    pack_sequence_dim(batch["route_command_next"])),
                self.gps_encoder(pack_sequence_dim(gps))]
        features.append(self.speed_enc(pack_sequence_dim(batch["speed"])))
        return features

    def _bev_embedding(self, x, batch: Dict) -> torch.Tensor:
        """The MILE branch: the route, measurement and speed features
        broadcast over the BEV features ``x``, ``backbone_bev``'s stride-16
        map compressed to the embedding, joined with the compressed LiDAR
        features."""
        n, h, w = x.shape[:3]
        features = [x] + [f[:, None, None].expand(n, h, w, f.shape[-1])
                          for f in self._vector_features(batch)]
        x = torch.cat(features, dim=-1)
        embedding = self.final_state_conv(self.backbone_bev(x)[-1])
        if self.lidar:
            lidar = self.lidar_state_conv(self._lidar_features(batch))
            embedding = self.embedding_combine(
                torch.cat([embedding, lidar], dim=-1))
        return embedding

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
        if self.rssm is None:  # MODEL.TRANSITION.ENABLED False
            state, state_dict = embedding, {}
        else:
            action = torch.cat([batch["throttle_brake"], batch["steering"]],
                               dim=-1).to(embedding.dtype)
            state_dict = self.rssm(embedding, action, use_sample=stochastic,
                                   training=noisy, generator=generator)
            posterior = state_dict["posterior"]
            state = torch.cat([posterior["hidden_state"],
                               posterior["sample"]], dim=-1)
        output: Dict = dict(state_dict)
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
        if self.rssm is None:
            raise ValueError("imagination needs the RSSM "
                             "(MODEL.TRANSITION.ENABLED)")
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
