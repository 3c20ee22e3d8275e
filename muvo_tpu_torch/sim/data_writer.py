"""Episode recorder: buffers per-tick observations to a temp dir, applies
episode-validity filtering on close, and materialises the reference dataset
folder layout (image/, birdview/, routemap/, points_semantic/,
depth_semantic/ + pd_dataframe.pkl).

Counterpart of reference utils/saving_utils.py (DataWriter): traffic-rule
violations trim the last 300 steps, blocked episodes trim 600, route
deviation invalidates the episode; episodes shorter than 300 steps after
trimming are dropped.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np

from muvo_tpu_torch.data.dataset_utils import (
    binary_to_integer,
    preprocess_birdview_and_routemap,
)

WEATHER_KEYS = [
    "cloudiness", "fog_density", "fog_distance", "fog_falloff",
    "precipitation", "precipitation_deposits", "sun_altitude_angle",
    "sun_azimuth_angle", "wetness", "wind_intensity",
]

MIN_VALID_STEPS = 300
TRIM_TRAFFIC_VIOLATION = 300
TRIM_BLOCKED = 600


class DataWriter:
    def __init__(self, dir_path: str, ev_id: str, run_info: Optional[Dict] = None,
                 save_birdview_label: bool = False):
        self._dir_path = dir_path
        self._ev_id = ev_id
        self.run_info = run_info or {}
        self.save_birdview_label = save_birdview_label
        os.makedirs(dir_path, exist_ok=True)
        self._tmp_dir = tempfile.mkdtemp(dir=dir_path)
        self._data_list: List[str] = []

    # ------------------------------------------------------------------
    def write(self, timestamp: Dict, obs: Dict, supervision: Dict,
              reward: Dict, control_diff=None, weather: Optional[Dict] = None):
        obs_ev = obs[self._ev_id]
        sup_ev = dict(supervision[self._ev_id])
        sup_ev["reward"] = reward[self._ev_id]

        record = {
            "step": timestamp.get("step", len(self._data_list)),
            "obs": {
                "central_rgb": obs_ev.get("central_rgb"),
                "left_rgb": obs_ev.get("left_rgb"),
                "right_rgb": obs_ev.get("right_rgb"),
                "depth_semantic": obs_ev.get("depth_semantic"),
                "gnss": obs_ev.get("gnss", {}),
                "speed": obs_ev.get("speed"),
                "route_plan": obs_ev.get("route_plan"),
                # prefer the label render when requested, but fall back to
                # the training birdview for envs that don't produce it
                # (e.g. the CARLA-free kinematic env)
                "birdview": ((obs_ev.get("birdview_label")
                              or obs_ev.get("birdview"))
                             if self.save_birdview_label
                             else obs_ev.get("birdview")),
                "point_cloud_semantic": obs_ev.get("lidar_points_semantic"),
            },
            "supervision": sup_ev,
            "reward": reward[self._ev_id],
            "control_diff": None if control_diff is None
            else control_diff.get(self._ev_id),
            "weather": weather or {},
        }
        tmp = tempfile.NamedTemporaryFile(dir=self._tmp_dir, delete=False)
        np.save(tmp, record)
        tmp.close()
        self._data_list.append(tmp.name)

    # ------------------------------------------------------------------
    def close(self, terminal_debug: Dict, remove_final_steps: bool,
              last_value=None) -> bool:
        valid = True
        if remove_final_steps:
            if terminal_debug.get("traffic_rule_violated"):
                trim = min(TRIM_TRAFFIC_VIOLATION, len(self._data_list))
                del self._data_list[-trim:]
                valid = len(self._data_list) >= MIN_VALID_STEPS
            if terminal_debug.get("blocked"):
                trim = min(TRIM_BLOCKED, len(self._data_list))
                del self._data_list[-trim:]
                valid = len(self._data_list) >= MIN_VALID_STEPS
        if terminal_debug.get("route_deviation"):
            valid = False

        if valid:
            self.save_files()
        self._data_list.clear()
        shutil.rmtree(self._tmp_dir, ignore_errors=True)
        return valid

    # ------------------------------------------------------------------
    def save_files(self):
        from PIL import Image
        import pandas as pd

        for sub in ("image", "depth_semantic", "birdview", "routemap",
                    "points_semantic"):
            os.makedirs(os.path.join(self._dir_path, sub), exist_ok=True)

        rows: Dict[str, list] = {}

        def add(key, value):
            rows.setdefault(key, []).append(value)

        for i, name in enumerate(self._data_list):
            data = np.load(name, allow_pickle=True).item()
            os.remove(name)
            obs = data["obs"]
            sup = data["supervision"]

            for k, v in sup.items():
                add(k, v)
            if "action_mu" not in sup:
                for k in ("action_mu", "action_sigma", "value", "features"):
                    add(k, np.zeros(1))
            for k, v in (obs.get("gnss") or {}).items():
                add(k, v)
            for k in WEATHER_KEYS:
                add(k, data["weather"].get(k, 0.0))
            for k, v in self.run_info.items():
                add(k, v)

            masks = obs["birdview"]["masks"]
            birdview, route_map = preprocess_birdview_and_routemap(masks)
            n_bits, h, w = birdview.shape
            packed = binary_to_integer(
                birdview.reshape(n_bits, -1).T, n_bits
            ).reshape(h, w)

            image_path = os.path.join("image", f"image_{i:09d}.png")
            birdview_path = os.path.join("birdview", f"birdview_{i:09d}.png")
            routemap_path = os.path.join("routemap", f"routemap_{i:09d}.png")
            add("image_path", image_path)
            add("birdview_path", birdview_path)
            add("routemap_path", routemap_path)
            add("n_classes", n_bits)

            Image.fromarray(obs["central_rgb"]["data"]).save(
                os.path.join(self._dir_path, image_path))
            Image.fromarray(packed.astype(np.int32), mode="I").save(
                os.path.join(self._dir_path, birdview_path))
            Image.fromarray(route_map, mode="L").save(
                os.path.join(self._dir_path, routemap_path))

            if obs.get("depth_semantic") is not None:
                p = os.path.join("depth_semantic", f"depth_semantic_{i:09d}.png")
                Image.fromarray(obs["depth_semantic"]["data"]).save(
                    os.path.join(self._dir_path, p))
                add("depth_semantic_path", p)

            if obs.get("point_cloud_semantic") is not None:
                p = os.path.join("points_semantic",
                                 f"points_semantic_{i:09d}.npy")
                np.save(os.path.join(self._dir_path, p),
                        obs["point_cloud_semantic"]["data"])
                add("points_semantic_path", p)

        pd.DataFrame(rows).to_pickle(
            os.path.join(self._dir_path, "pd_dataframe.pkl"))
