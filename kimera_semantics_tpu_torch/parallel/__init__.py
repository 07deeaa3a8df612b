"""Spatial sharding of the voxel grid (sharding.py) and its multi-process
pipeline (multihost.py), on torch.distributed."""
