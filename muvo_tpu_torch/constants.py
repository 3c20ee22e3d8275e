"""Constants the serving path needs (own copy of muvo_tpu/constants.py's)."""

CARLA_FPS = 10

# torchvision ImageNet statistics (the defaults of cfg.IMAGE.IMAGENET_*)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
