"""Synthetic world and renderer (kimera_semantics_tpu/sim)."""
