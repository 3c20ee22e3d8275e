"""Constants of the port (own copy of muvo_tpu/constants.py's, which a test
holds equal)."""

import numpy as np

CARLA_FPS = 10
WHEEL_BASE = 2.8711279296875  # metres (the kinematic env's bicycle)

# torchvision ImageNet statistics (the defaults of cfg.IMAGE.IMAGENET_*)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# colours of the BEV classes and of the voxel labels in the panels
BIRDVIEW_COLOURS = np.array(
    [
        [255, 255, 255],  # Background
        [225, 225, 225],  # Road
        [160, 160, 160],  # Lane marking
        [0, 83, 138],     # Vehicle
        [127, 255, 212],  # Pedestrian
        [50, 205, 50],    # Green light
        [255, 215, 0],    # Yellow light
        [220, 20, 60],    # Red light and stop sign
    ],
    dtype=np.uint8,
)
VOXEL_COLOURS = np.array(
    [
        [255, 255, 255],  # Background
        [115, 115, 115],  # Occupancy
    ],
    dtype=np.uint8,
)

# class weights of the segmentation losses: sqrt of inverse class frequency
SEMANTIC_SEG_WEIGHTS = np.array([1.0, 1.0, 1.0, 2.0, 3.0, 1.0, 1.0, 1.0])
VOXEL_SEG_WEIGHTS = np.array([1.0, 1.0, 1.0, 1.5, 2.0, 3.0, 1.0, 1.0, 1.0])

# ego-vehicle bounding box (length, width, height) in metres
EGO_VEHICLE_DIMENSION = [4.902, 2.128, 1.511]

# CARLA semantic tag -> training label (binary occupancy; Sky -> background)
LABEL_MAP = {
    0: 0, 1: 1, 2: 1, 3: 1, 4: 1, 5: 1, 6: 1, 7: 1, 8: 1, 9: 1, 10: 1,
    11: 1, 12: 1, 13: 0, 14: 1, 15: 1, 16: 1, 17: 1, 18: 1, 19: 1, 20: 1,
    21: 1, 22: 1,
}


def label_remap_table() -> np.ndarray:
    """uint8 lookup table applying LABEL_MAP (unknown tags -> max value)."""
    remap = np.full((max(LABEL_MAP.keys()) + 1,), max(LABEL_MAP.values()),
                    dtype=np.uint8)
    remap[list(LABEL_MAP.keys())] = list(LABEL_MAP.values())
    return remap
