"""The benchmark harness of kimera_semantics_tpu_torch (see run.py)."""
