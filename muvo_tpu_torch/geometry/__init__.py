"""Host geometry of the input pipeline (numpy): camera intrinsics and
extrinsics, the LiDAR range-view projection, voxel grids; and the ICP
registration of the validation panels' trajectories."""
