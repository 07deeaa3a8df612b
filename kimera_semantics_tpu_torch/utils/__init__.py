"""Timing and invariant checks (kimera_semantics_tpu/utils)."""
