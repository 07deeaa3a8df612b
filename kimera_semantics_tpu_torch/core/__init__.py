"""Geometry, camera and color primitives (kimera_semantics_tpu/core)."""
