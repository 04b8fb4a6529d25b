"""Host-side metrics of the port (copies of vitxtgqa_tpu/metrics)."""
