"""The serving pipeline, its presets, live mesh output and the CLI
(kimera_semantics_tpu/server)."""
