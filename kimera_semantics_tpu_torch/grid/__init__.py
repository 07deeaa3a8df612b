"""Block hash table and voxel grid state (kimera_semantics_tpu/grid)."""
