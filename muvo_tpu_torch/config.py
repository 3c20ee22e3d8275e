"""Configuration tree for the PyTorch port (an own copy of muvo_tpu/config.py).

A lightweight yacs-style config tree: a default tree of nested nodes, YAML
merging with ``_BASE_`` file inheritance, dotted CLI overrides
(``KEY.SUBKEY value``), freezing, and round-tripping to plain dicts. The
default tree is key- and value-identical to muvo_tpu's (a test holds the
two dumps equal), so the same YAML files load in both packages.
"""

from __future__ import annotations

import argparse
import ast
import copy
import os
from typing import Any, Dict, List, Optional

import yaml

_BASE_KEY = "_BASE_"


class CfgNode(dict):
    """Nested dict with attribute access and freeze support."""

    IMMUTABLE = "__immutable__"
    NEW_ALLOWED = "__new_allowed__"

    def __init__(self, init_dict: Optional[Dict] = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        object.__setattr__(self, CfgNode.NEW_ALLOWED, False)
        for k, v in init_dict.items():
            if isinstance(v, dict):
                self[k] = CfgNode(v)
            else:
                self[k] = v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config key not found: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"Config is frozen; cannot set {name}")
        self[name] = value

    def __setitem__(self, name, value):
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"Config is frozen; cannot set {name}")
        super().__setitem__(name, value)

    # -- freeze -----------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, value: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, value)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    def set_new_allowed(self, value: bool) -> None:
        object.__setattr__(self, CfgNode.NEW_ALLOWED, value)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.set_new_allowed(value)

    # -- merge ------------------------------------------------------------
    def clone(self) -> "CfgNode":
        return CfgNode(self.convert_to_dict())

    def convert_to_dict(self) -> Dict:
        out = {}
        for k, v in self.items():
            out[k] = v.convert_to_dict() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def merge_from_dict(self, other: Dict, path: str = "") -> None:
        new_allowed = object.__getattribute__(self, CfgNode.NEW_ALLOWED)
        for k, v in other.items():
            if k == _BASE_KEY:
                continue
            full = f"{path}.{k}" if path else k
            if k not in self:
                if not new_allowed:
                    raise KeyError(f"Non-existent config key: {full}")
                self[k] = CfgNode(v) if isinstance(v, dict) else v
                continue
            if isinstance(self[k], CfgNode) and isinstance(v, dict):
                self[k].merge_from_dict(v, full)
            elif isinstance(self[k], CfgNode) != isinstance(v, dict):
                raise TypeError(f"Type mismatch for config key {full}")
            else:
                self[k] = _coerce_value(v, self[k], full)

    def merge_from_file(self, filename: str) -> None:
        merged = load_yaml_with_base(filename)
        self.merge_from_dict(merged)

    def merge_from_list(self, opts: List[str]) -> None:
        assert len(opts) % 2 == 0, f"Override list must have even length: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce_value(_parse_literal(value), node[leaf], key)


def _parse_literal(value: str) -> Any:
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce_value(new: Any, old: Any, key: str) -> Any:
    """Cast the new value to the old value's type where sensible."""
    if old is None or new is None:
        return new
    if isinstance(old, bool):
        if isinstance(new, bool):
            return new
        if isinstance(new, str):
            low = new.lower()
            if low in ("true", "yes", "1"):
                return True
            if low in ("false", "no", "0"):
                return False
        if isinstance(new, int):
            return bool(new)
        raise TypeError(f"Cannot coerce {new!r} to bool for key {key}")
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    return new


def load_yaml_with_base(filename: str) -> Dict:
    """Load a YAML file, recursively resolving ``_BASE_`` inheritance."""
    with open(filename, "r") as f:
        cfg = yaml.safe_load(f) or {}
    if _BASE_KEY in cfg:
        base_file = cfg.pop(_BASE_KEY)
        if not os.path.isabs(base_file):
            base_file = os.path.join(os.path.dirname(filename), base_file)
        base = load_yaml_with_base(base_file)
        _deep_update(base, cfg)
        return base
    return cfg


def _deep_update(base: Dict, other: Dict) -> None:
    for k, v in other.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, dict):
            _deep_update(base[k], v)
        else:
            base[k] = v


def _find_extra_keys(dict1: Dict, dict2: Dict, path: str = "") -> List[str]:
    """Keys in dict2 missing from dict1 (reference: muvo/config.py:335-349)."""
    results: List[str] = []
    for key in dict2.keys():
        new_path = f"{path}.{key}" if path else key
        if key in dict1:
            if isinstance(dict1[key], dict) and isinstance(dict2[key], dict):
                results.extend(_find_extra_keys(dict1[key], dict2[key], new_path))
        else:
            results.append(new_path)
    return sorted(results)


# ---------------------------------------------------------------------------
# Default config tree — key-compatible with reference muvo/config.py:31-323.
# ---------------------------------------------------------------------------
def _build_defaults() -> CfgNode:
    c = CfgNode()
    c.LOG_DIR = "tensorboard_logs"
    c.TAG = "default"
    c.CML_PROJECT = ""
    c.CML_TASK = ""
    c.CML_TYPE = ""
    c.CML_DATASET = ""
    c.CML_DATASET_VERSION = ""

    c.GPUS = 1  # retained for YAML compatibility
    c.PRECISION = "16-mixed"
    c.BATCHSIZE = 3
    c.STEPS = 50000
    c.N_WORKERS = 4

    c.VAL_CHECK_INTERVAL = 5000
    c.LOGGING_INTERVAL = 500
    c.LIMIT_VAL_BATCHES = 1
    c.LOG_VIDEO_INTERVAL = 5000
    # profile this many training steps (0 = off)
    c.PROFILE_STEPS = 0

    c.RECEPTIVE_FIELD = 1
    c.FUTURE_HORIZON = 1

    c.PREDICTION = CfgNode()
    c.PREDICTION.N_SAMPLES = 2

    c.OPTIMIZER = CfgNode()
    c.OPTIMIZER.LR = 1e-4
    c.OPTIMIZER.WEIGHT_DECAY = 0.01
    c.OPTIMIZER.ACCUMULATE_GRAD_BATCHES = 1
    c.OPTIMIZER.FROZEN = CfgNode()
    c.OPTIMIZER.FROZEN.ENABLED = False
    c.OPTIMIZER.FROZEN.TRAIN_LIST = []

    c.SCHEDULER = CfgNode()
    c.SCHEDULER.NAME = "OneCycleLR"
    c.SCHEDULER.PCT_START = 0.2

    c.DATASET = CfgNode()
    c.DATASET.DATAROOT = ""
    c.DATASET.VERSION = "trainval"
    # decoded-frame cache directory ("": off; "auto": <DATAROOT>/_frame_cache)
    c.DATASET.FRAME_CACHE = ""
    c.DATASET.STRIDE_SEC = 0.2
    c.DATASET.FILTER_BEGINNING_OF_RUN_SEC = 1.0
    c.DATASET.FILTER_NORM_REWARD = 0.6

    c.POINTS = CfgNode()
    c.POINTS.LIDAR_POSITION = [1.0, 0.0, 2.0]
    c.POINTS.LIDAR_ROTATION = [0.0, 0.0, 0.0]
    c.POINTS.FOV = [-30, 10]
    c.POINTS.CHANNELS = 64
    c.POINTS.N_PER_SECOND = 600000
    c.POINTS.HORIZON_RESOLUTION = 1024
    # build LiDAR range views on the device from raw padded points
    c.POINTS.DEVICE_PROJECTION = False
    c.POINTS.HISTOGRAM = CfgNode()
    c.POINTS.HISTOGRAM.RESOLUTION = 10
    c.POINTS.HISTOGRAM.HIST_MAX = 5
    c.POINTS.HISTOGRAM.X_RANGE = 384
    c.POINTS.HISTOGRAM.Y_RANGE = 384
    c.POINTS.HISTOGRAM.Z_RANGE = 128

    c.VOXEL = CfgNode()
    c.VOXEL.SIZE = [192, 192, 64]
    c.VOXEL.RESOLUTION = 0.2
    c.VOXEL.EV_POSITION = [32, 96, 12]

    c.IMAGE = CfgNode()
    c.IMAGE.SIZE = (600, 960)
    c.IMAGE.CROP = [64, 138, 896, 458]  # (left, top, right, bottom)
    c.IMAGE.FOV = 100
    c.IMAGE.CAMERA_POSITION = [1.0, 0.0, 2.0]
    c.IMAGE.CAMERA_ROTATION = [0.0, 0.0, 0.0]
    c.IMAGE.IMAGENET_MEAN = (0.485, 0.456, 0.406)
    c.IMAGE.IMAGENET_STD = (0.229, 0.224, 0.225)
    c.IMAGE.AUGMENTATION = CfgNode()
    c.IMAGE.AUGMENTATION.BLUR_PROB = 0.3
    c.IMAGE.AUGMENTATION.BLUR_WINDOW = 5
    c.IMAGE.AUGMENTATION.BLUR_STD = [0.1, 1.7]
    c.IMAGE.AUGMENTATION.SHARPEN_PROB = 0.3
    c.IMAGE.AUGMENTATION.SHARPEN_FACTOR = [1, 5]
    c.IMAGE.AUGMENTATION.COLOR_PROB = 0.3
    c.IMAGE.AUGMENTATION.COLOR_JITTER_BRIGHTNESS = 0.3
    c.IMAGE.AUGMENTATION.COLOR_JITTER_CONTRAST = 0.3
    c.IMAGE.AUGMENTATION.COLOR_JITTER_SATURATION = 0.3
    c.IMAGE.AUGMENTATION.COLOR_JITTER_HUE = 0.1

    c.BEV = CfgNode()
    c.BEV.SIZE = [192, 192]
    c.BEV.RESOLUTION = 0.2
    c.BEV.OFFSET_FORWARD = -64
    c.BEV.FEATURE_DOWNSAMPLE = 4
    c.BEV.FRUSTUM_POOL = CfgNode()
    c.BEV.FRUSTUM_POOL.D_BOUND = [1.0, 38.0, 1.0]
    c.BEV.FRUSTUM_POOL.SPARSE = True
    c.BEV.FRUSTUM_POOL.SPARSE_COUNT = 10

    c.ROUTE = CfgNode()
    c.ROUTE.SIZE = 64
    c.ROUTE.AUGMENTATION_DROPOUT = 0.025
    c.ROUTE.AUGMENTATION_END_OF_ROUTE = 0.025
    c.ROUTE.AUGMENTATION_SMALL_ROTATION = 0.025
    c.ROUTE.AUGMENTATION_LARGE_ROTATION = 0.025
    c.ROUTE.AUGMENTATION_DEGREES = 8.0
    c.ROUTE.AUGMENTATION_TRANSLATE = (0.1, 0.1)
    c.ROUTE.AUGMENTATION_SCALE = (0.95, 1.05)
    c.ROUTE.AUGMENTATION_SHEAR = (0.1, 0.1)

    c.SPEED = CfgNode()
    c.SPEED.NOISE_STD = 1.4
    c.SPEED.NORMALISATION = 5.0

    c.MODEL = CfgNode()
    c.MODEL.ACTION_DIM = 2
    c.MODEL.TRANSFORMER = CfgNode()
    c.MODEL.TRANSFORMER.CHANNELS = 256
    c.MODEL.TRANSFORMER.ENABLED = False
    c.MODEL.TRANSFORMER.BEV = False
    c.MODEL.TRANSFORMER.LARGE = False
    # Architecture knobs (reference hard-codes 6 layers / 8 heads / 2048 ff,
    # mile.py:96-101); exposed so tiny dryrun/test graphs can shrink them.
    c.MODEL.TRANSFORMER.N_LAYERS = 6
    c.MODEL.TRANSFORMER.N_HEADS = 8
    c.MODEL.TRANSFORMER.DIM_FEEDFORWARD = 2048
    c.MODEL.ENCODER = CfgNode()
    c.MODEL.ENCODER.NAME = "resnet18"
    c.MODEL.ENCODER.OUT_CHANNELS = 64
    c.MODEL.BEV = CfgNode()
    c.MODEL.BEV.BACKBONE = "resnet18"
    c.MODEL.BEV.CHANNELS = 64
    c.MODEL.LIDAR = CfgNode()
    c.MODEL.LIDAR.ENABLED = True
    c.MODEL.LIDAR.MULTI_VIEW = False
    c.MODEL.LIDAR.ENCODER = "resnet18"
    c.MODEL.LIDAR.OUT_CHANNELS = 64
    c.MODEL.LIDAR.BACKBONE = "resnet18"
    c.MODEL.LIDAR.POINT_PILLAR = CfgNode()
    c.MODEL.LIDAR.POINT_PILLAR.ENABLED = False
    c.MODEL.SPEED = CfgNode()
    c.MODEL.SPEED.CHANNELS = 16
    c.MODEL.ROUTE = CfgNode()
    c.MODEL.ROUTE.ENABLED = True
    c.MODEL.ROUTE.BACKBONE = "resnet18"
    c.MODEL.ROUTE.CHANNELS = 16
    c.MODEL.MEASUREMENTS = CfgNode()
    c.MODEL.MEASUREMENTS.ENABLED = False
    c.MODEL.MEASUREMENTS.COMMAND_CHANNELS = 8
    c.MODEL.MEASUREMENTS.GPS_CHANNELS = 16
    c.MODEL.EMBEDDING_DIM = 512
    # StyleGAN decoder trunk width (upstream hard-codes 512); exposed so
    # tiny test graphs can shrink it.
    c.MODEL.DECODER_BASE_CHANNELS = 512
    c.MODEL.REMAT = False
    # Which decoders REMAT covers: "all", or "voxel" to remat only the
    # voxel decoder (the HBM-dominant one) while rgb/lidar/bev store their
    # activations — saves their forward recompute in the backward pass.
    c.MODEL.REMAT_SCOPE = "all"
    # Also rematerialise the image/lidar encoder backbones (frees their
    # feature maps from HBM at the cost of a second forward in backward).
    c.MODEL.REMAT_ENCODER = False
    c.MODEL.TRANSITION = CfgNode()
    c.MODEL.TRANSITION.ENABLED = True
    c.MODEL.TRANSITION.HIDDEN_STATE_DIM = 1024
    c.MODEL.TRANSITION.STATE_DIM = 512
    c.MODEL.TRANSITION.ACTION_LATENT_DIM = 64
    c.MODEL.TRANSITION.USE_DROPOUT = True
    c.MODEL.TRANSITION.DROPOUT_PROBABILITY = 0.15
    # Present in reference YAMLs (2D branch); accepted for compatibility.
    c.MODEL.TRANSFORMER_TRANSITION = CfgNode()
    c.MODEL.TRANSFORMER_TRANSITION.ENABLED = False
    c.MODEL.POLICY = CfgNode()
    c.MODEL.REWARD = CfgNode()
    c.MODEL.REWARD.ENABLED = False

    c.SEMANTIC_SEG = CfgNode()
    c.SEMANTIC_SEG.ENABLED = True
    c.SEMANTIC_SEG.N_CHANNELS = 8
    c.SEMANTIC_SEG.USE_TOP_K = True
    c.SEMANTIC_SEG.TOP_K_RATIO = 0.25
    c.SEMANTIC_SEG.USE_WEIGHTS = True

    c.INSTANCE_SEG = CfgNode()
    c.INSTANCE_SEG.CENTER_LABEL_SIGMA_PX = 4
    c.INSTANCE_SEG.IGNORE_INDEX = 255
    c.INSTANCE_SEG.CENTER_LOSS_WEIGHT = 200.0
    c.INSTANCE_SEG.OFFSET_LOSS_WEIGHT = 0.1

    c.VOXEL_SEG = CfgNode()
    c.VOXEL_SEG.ENABLED = True
    c.VOXEL_SEG.DIMENSION = 256
    c.VOXEL_SEG.N_CLASSES = 9
    c.VOXEL_SEG.USE_TOP_K = False
    c.VOXEL_SEG.TOP_K_RATIO = 0.5
    c.VOXEL_SEG.USE_WEIGHTS = True

    c.LIDAR_RE = CfgNode()
    c.LIDAR_RE.ENABLED = True
    c.LIDAR_RE.N_CHANNELS = 4
    c.LIDAR_RE.SCALE = 50.0

    c.LIDAR_SEG = CfgNode()
    c.LIDAR_SEG.ENABLED = True
    c.LIDAR_SEG.N_CLASSES = 9
    c.LIDAR_SEG.USE_TOP_K = True
    c.LIDAR_SEG.TOP_K_RATIO = 0.5
    c.LIDAR_SEG.USE_WEIGHTS = True

    c.SEMANTIC_IMAGE = CfgNode()
    c.SEMANTIC_IMAGE.ENABLED = False
    c.SEMANTIC_IMAGE.N_CLASSES = 9
    c.SEMANTIC_IMAGE.USE_TOP_K = False
    c.SEMANTIC_IMAGE.TOP_K_RATIO = 0.5
    c.SEMANTIC_IMAGE.USE_WEIGHTS = True

    c.DEPTH = CfgNode()
    c.DEPTH.ENABLED = False
    c.DEPTH.N_CHANNELS = 1

    c.LOSSES = CfgNode()
    c.LOSSES.WEIGHT_ACTION = 1.0
    c.LOSSES.WEIGHT_SEGMENTATION = 0.1
    c.LOSSES.WEIGHT_INSTANCE = 0.1
    c.LOSSES.WEIGHT_REWARD = 0.1
    c.LOSSES.WEIGHT_PROBABILISTIC = 1e-3
    c.LOSSES.KL_BALANCING_ALPHA = 0.75
    c.LOSSES.WEIGHT_LIDAR_RE = 0.1
    c.LOSSES.WEIGHT_LIDAR_SEG = 0.1
    c.LOSSES.WEIGHT_SEM_IMAGE = 0.1
    c.LOSSES.WEIGHT_DEPTH = 0.1
    c.LOSSES.WEIGHT_VOXEL = 0.1
    c.LOSSES.RGB_INSTANCE = False
    c.LOSSES.SSIM = False
    # Present in reference YAMLs (2D branch); accepted for compatibility.
    c.LOSSES.PERCEPTUAL = CfgNode()
    c.LOSSES.PERCEPTUAL.ENABLED = False
    c.LOSSES.PERCEPTUAL.MODEL = "resnet18"

    c.PRETRAINED = CfgNode()
    c.PRETRAINED.PATH = ""
    c.PRETRAINED.CML_MODEL = ""

    c.EVAL = CfgNode()
    c.EVAL.MASK_VIEW = False
    c.EVAL.RGB_SUPERVISION = False
    c.EVAL.CHECKPOINT_PATH = ""
    c.EVAL.NO_LIFTING = False
    c.EVAL.DATASET_REDUCTION = False
    c.EVAL.DATASET_REDUCTION_FACTOR = 1
    c.EVAL.RESOLUTION = CfgNode()
    c.EVAL.RESOLUTION.ENABLED = False
    c.EVAL.RESOLUTION.FACTOR = 1

    c.SAMPLER = CfgNode()
    c.SAMPLER.ENABLED = False
    c.SAMPLER.WITH_ACCELERATION = False
    c.SAMPLER.WITH_STEERING = False
    c.SAMPLER.N_BINS = 5
    c.SAMPLER.WITH_ROUTE_COMMAND = False
    c.SAMPLER.COMMAND_WEIGHTS = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]

    return c


_C = _build_defaults()


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="MUVO world model (PyTorch port)")
    parser.add_argument("--config-file", default="", metavar="FILE", help="path to config file")
    parser.add_argument(
        "opts", help="Modify config options from the command line", default=None,
        nargs=argparse.REMAINDER,
    )
    return parser


def get_cfg(args=None, cfg_dict: Optional[Dict] = None) -> CfgNode:
    """Defaults <- cfg_dict <- config file <- CLI opts, then freeze.

    Mirrors reference muvo/config.py:352-369 including the lenient extra-key
    path when merging a raw dict (e.g. re-hydrating checkpoint hparams).
    """
    cfg = _C.clone()

    if cfg_dict is not None:
        extra_keys = _find_extra_keys(cfg, cfg_dict)
        if extra_keys:
            print(f"Warning - cfg_dict has keys not in the default config: {extra_keys}")
            cfg.set_new_allowed(True)
        cfg.merge_from_dict(cfg_dict)
        cfg.set_new_allowed(False)

    if args is not None:
        if args.config_file:
            cfg.merge_from_file(args.config_file)
        if args.opts:
            cfg.merge_from_list(args.opts)
        cfg.freeze()
    return cfg


def convert_to_dict(cfg: CfgNode) -> Dict:
    return cfg.convert_to_dict()
