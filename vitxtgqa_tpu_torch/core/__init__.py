"""Config, registry, flags and metric smoothing of the port (copies of vitxtgqa_tpu/core)."""
