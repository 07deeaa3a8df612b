"""Per-frame operations and the CUDA kernel wrappers (kimera_semantics_tpu/ops)."""
