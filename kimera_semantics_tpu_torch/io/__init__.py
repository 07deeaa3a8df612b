"""Frame providers (kimera_semantics_tpu/io)."""
