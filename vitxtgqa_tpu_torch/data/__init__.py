"""Datasets, processors and the loader of the port (copies of vitxtgqa_tpu/data)."""
