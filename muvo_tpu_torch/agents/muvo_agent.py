"""Closed-loop world-model driving agent (counterpart of
muvo_tpu/agents/muvo_agent.py).

Converts live observations (the CARLA env's, or the kinematic env's with
the same contract) into the model's input frames on the host, keeps the
latent state on the device across ticks through DeploymentSession, and
maps the policy head's (acceleration, steering) output to a vehicle
control. ``is_dreaming`` drives from imagination between observation
strides, as the reference's online_deployment mode does. It runs on the
GPU unless ``device="cpu"``.
"""

from __future__ import annotations

from collections import deque
from typing import Dict

import numpy as np
import torch

from muvo_tpu_torch.geometry.camera import calculate_geometry_from_config
from muvo_tpu_torch.geometry.range_view import RangeProjector
from muvo_tpu_torch.inference import DeploymentSession


class MuvoAgent:
    """Drives from the world model: obs -> frame -> latent update -> action."""

    def __init__(self, cfg, model, is_dreaming: bool = False, device=None):
        self.cfg = cfg
        self.session = DeploymentSession(model, cfg, device=device)
        self.is_dreaming = is_dreaming
        self._frames: deque = deque(maxlen=2)
        self._prev_action = np.zeros(2, np.float32)
        self._intrinsics, self._extrinsics = calculate_geometry_from_config(cfg)
        self._projector = RangeProjector(
            cfg.POINTS.CHANNELS, cfg.POINTS.HORIZON_RESOLUTION,
            cfg.POINTS.FOV[0], cfg.POINTS.FOV[1], cfg.POINTS.LIDAR_POSITION,
        )
        self.supervision_dict: Dict = {}

    # ------------------------------------------------------------------
    def _obs_to_frame(self, obs: Dict) -> Dict[str, np.ndarray]:
        import cv2

        cfg = self.cfg
        h, w = cfg.IMAGE.SIZE
        rgb = obs["central_rgb"]["data"]
        if rgb.shape[:2] != (h, w):
            rgb = cv2.resize(rgb, (w, h), interpolation=cv2.INTER_LINEAR)

        # route map: the planned-route channel of the birdview render
        r = cfg.ROUTE.SIZE * 3
        masks = obs["birdview"]["masks"]
        if masks.ndim == 3 and masks.shape[0] < masks.shape[-1]:
            route_layer = masks[1]
        else:
            route_layer = masks[..., 1]
        route = cv2.resize(route_layer.astype(np.uint8), (r, r),
                           interpolation=cv2.INTER_NEAREST)
        route_map = np.repeat(route[..., None], 3, axis=-1)

        speed = np.asarray(
            obs["speed"]["forward_speed"], np.float32).reshape(1)

        frame = {
            "image": rgb.astype(np.uint8),
            "route_map": route_map.astype(np.uint8),
            "speed": speed,
            "intrinsics": self._intrinsics.astype(np.float32),
            "extrinsics": self._extrinsics.astype(np.float32),
            "throttle_brake": self._prev_action[:1].copy(),
            "steering": self._prev_action[1:].copy(),
        }

        if cfg.MODEL.LIDAR.ENABLED and "lidar_points_semantic" in obs:
            pc = obs["lidar_points_semantic"]["data"]
            points = np.asarray(pc["points_xyz"], np.float32)
            sem = np.asarray(pc.get("ObjTag",
                                    np.zeros(len(points), np.uint8)))
            rd, rxyz, rsem = self._projector.project(points, sem)
            if cfg.LIDAR_RE.ENABLED:
                frame["range_view_pcd_xyzd"] = np.concatenate(
                    [rxyz, rd[..., None]], axis=-1).astype(np.float32)
            if cfg.LIDAR_SEG.ENABLED:
                frame["range_view_pcd_seg"] = rsem[..., None].astype(np.int32)
        return frame

    def _batch(self) -> Dict[str, torch.Tensor]:
        """The last two frames stacked on the host, (1, 2, ...) each,
        moved once to the session's device."""
        device = self.session.device
        return {k: torch.from_numpy(
                    np.stack([f[k] for f in self._frames])[None]).to(device)
                for k in self._frames[-1]}

    # ------------------------------------------------------------------
    def run_step(self, obs: Dict, timestamp=None):
        frame = self._obs_to_frame(obs)
        self._frames.append(frame)
        while len(self._frames) < 2:
            self._frames.append(frame)

        out = self.session.deployment_forward(self._batch(), self.is_dreaming)
        acc = out["throttle_brake"].reshape(-1)[0].item()
        steer = out["steering"].reshape(-1)[0].item()
        throttle = max(acc, 0.0)
        brake = max(-acc, 0.0)
        steer = float(np.clip(steer, -1.0, 1.0))
        self._prev_action = np.array([acc, steer], np.float32)

        self.supervision_dict = {
            "action": np.array([throttle, steer, brake], np.float32),
            "action_mu": np.array([acc, steer], np.float32),
            "action_sigma": np.zeros(2, np.float32),
            "value": 0.0,
            "features": np.zeros(4, np.float32),
            "speed": obs.get("speed", {}).get("forward_speed"),
        }
        try:
            import carla

            control = carla.VehicleControl(
                throttle=throttle, steer=steer, brake=brake)
        except ImportError:
            control = {"throttle": throttle, "steer": steer, "brake": brake}
        return control

    def reset(self, log_file_path: str = ""):
        self.session.reset()
        self._frames.clear()
        self._prev_action = np.zeros(2, np.float32)
