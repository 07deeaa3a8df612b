"""Integrators (kimera_semantics_tpu/models)."""
