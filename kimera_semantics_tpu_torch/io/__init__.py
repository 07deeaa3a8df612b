"""Frame providers, prefetch and map/mesh I/O (kimera_semantics_tpu/io)."""
