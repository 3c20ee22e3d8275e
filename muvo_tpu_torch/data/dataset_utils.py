"""Bird's-eye-view bit-packing and label helpers.

An own copy of muvo_tpu/data/dataset_utils.py (a test holds it equal).
Semantics match reference muvo/data/dataset_utils.py:10-128 (numpy-only; no
CARLA dependency in the training path).
"""

from __future__ import annotations

import numpy as np


def binary_to_integer(binary_array: np.ndarray, n_bits: int) -> np.ndarray:
    """(n, n_bits) {0,1} -> (n,) int32 bitfield."""
    return (binary_array @ (2 ** np.arange(n_bits, dtype=binary_array.dtype))).astype(
        np.int32
    )


def integer_to_binary(integer_array: np.ndarray, n_bits: int) -> np.ndarray:
    """(n,) int -> (n, n_bits) float32 {0,1}."""
    return ((integer_array[:, None] & (1 << np.arange(n_bits))) > 0).astype(np.float32)


def calculate_birdview_labels(birdview: np.ndarray, n_classes: int,
                              has_time_dimension: bool = False) -> np.ndarray:
    """Collapse a (C, H, W) binary mask stack into a (H, W) label map.

    When a pixel holds several classes the *highest* class index wins
    (traffic lights override road), achieved by argmax over the reversed
    channel order.
    """
    axis = 1 if has_time_dimension else 0
    flipped = np.flip(birdview, axis=axis)
    label = np.argmax(flipped, axis=axis)
    return (n_classes - 1) - label


def preprocess_birdview_and_routemap(birdview: np.ndarray):
    """CARLA chauffeurnet masks -> (9-channel one-hot stack, route map).

    birdview: (C, H, W) or (T, C, H, W) uint8 with values in {0..255}.
    Output channels: [background, road, lane-markings, vehicle, pedestrian,
    green light, yellow light, red light+stop].
    """
    ROUTE_MAP_INDEX = 1
    relevant_indices = [0, 2, 6, 10]

    birdview = np.asarray(birdview)
    has_time = birdview.ndim == 4
    if not has_time:
        birdview = birdview[None]

    light_stop = birdview[:, -1:]
    green = (light_stop == 80).astype(np.float32)
    yellow = (light_stop == 170).astype(np.float32)
    red_stop = (light_stop == 255).astype(np.float32)

    remaining = (birdview[:, relevant_indices] > 0).astype(np.float32)

    processed = np.concatenate([remaining, green, yellow, red_stop], axis=1)
    background = (processed.sum(axis=1, keepdims=True) == 0).astype(np.float32)
    processed = np.concatenate([background, processed], axis=1)

    route_map = np.where(birdview[:, ROUTE_MAP_INDEX] > 0, 255, 0).astype(np.uint8)

    if not has_time:
        processed, route_map = processed[0], route_map[0]
    return processed, route_map


def calculate_instance_mask(semantics: np.ndarray, vehicle_idx: int,
                            pedestrian_idx: int) -> np.ndarray:
    return ((semantics == vehicle_idx) | (semantics == pedestrian_idx)).astype(bool)


def preprocess_measurements(route_command, ego_gps, target_gps, imu):
    """Route command id + GPS vector toward the next target, in the ego frame.

    (reference: muvo/data/dataset_utils.py:62-80)
    """
    from muvo_tpu_torch.sim.agents import gps_to_location, vec_global_to_ref

    route_command = np.array(route_command, copy=True)
    route_command[route_command < 0] = 4
    route_command = np.int64(np.ravel(route_command)[0]) - 1

    compass = 0.0 if np.isnan(imu[-1]) else imu[-1]
    target_vec = gps_to_location(target_gps) - gps_to_location(ego_gps)
    loc_in_ev = vec_global_to_ref(target_vec, np.rad2deg(compass) - 90.0)
    gps_vector = np.array([loc_in_ev[0], loc_in_ev[1]], dtype=np.float32)
    return route_command, gps_vector
