"""Constants of the port (own copy of muvo_tpu/constants.py's, which a test
holds equal)."""

import numpy as np

CARLA_FPS = 10

# torchvision ImageNet statistics (the defaults of cfg.IMAGE.IMAGENET_*)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# class weights of the segmentation losses: sqrt of inverse class frequency
SEMANTIC_SEG_WEIGHTS = np.array([1.0, 1.0, 1.0, 2.0, 3.0, 1.0, 1.0, 1.0])
VOXEL_SEG_WEIGHTS = np.array([1.0, 1.0, 1.0, 1.5, 2.0, 3.0, 1.0, 1.0, 1.0])
