"""Offline dataset tools of the port, run as ``python -m
muvo_tpu_torch.tools.<name>``: voxelisation and LiDAR preprocessing."""
