"""Run logging: timestamped file + stdout + JSONL scalar stream (the port's
copy of vitxtgqa_tpu/utils/logger.py).

(reference: pythia/utils/logger.py:15-141.)  tensorboardX is replaced by a
plain JSONL scalar log (save_dir/scalars.jsonl) that any dashboard can
tail.  The JAX logger also attaches TensorBoard where the package exists;
the port does not (its import pulls TensorFlow into the trainer).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict


class Logger:
    def __init__(self, save_dir: str = "./save", name: str = "vitxtgqa_tpu_torch",
                 level: str = "info", should_log: bool = True):
        self.save_dir = save_dir
        self.should_log = should_log
        os.makedirs(save_dir, exist_ok=True)
        timestamp = time.strftime("%Y-%m-%dT%H:%M:%S")
        self.log_file = os.path.join(save_dir, f"{name}_{timestamp}.log")
        self.scalar_file = os.path.join(save_dir, "scalars.jsonl")

        self._logger = logging.getLogger(name)
        self._logger.setLevel(getattr(logging, level.upper(), logging.INFO))
        self._logger.handlers.clear()
        self._logger.propagate = False
        fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
        if should_log:
            fh = logging.FileHandler(self.log_file)
            fh.setFormatter(fmt)
            self._logger.addHandler(fh)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        self._logger.addHandler(sh)

    def write(self, message: Any, level: str = "info"):
        getattr(self._logger, level, self._logger.info)(str(message))

    def add_scalars(self, scalars: Dict[str, float], step: int):
        if not self.should_log:
            return
        record = {"step": int(step), **{k: float(v) for k, v in scalars.items()}}
        with open(self.scalar_file, "a") as f:
            f.write(json.dumps(record) + "\n")

    def add_histograms_for_params(self, params: Any, step: int):
        """Per-parameter histograms (reference: logger.py:133-141
        add_histogram_for_model) as a compact 10-bin summary per parameter
        in save_dir/histograms.jsonl.  `params` is a nested mapping of
        arrays (the trainer passes its state_dict as numpy); names are the
        /-joined paths."""
        if not self.should_log:
            return
        import numpy as np

        flat: Dict[str, Any] = {}

        def walk(node, prefix=""):
            if isinstance(node, dict) or hasattr(node, "items"):
                for k, v in node.items():
                    walk(v, f"{prefix}/{k}" if prefix else k)
            else:
                flat[prefix] = np.asarray(node)

        walk(params)
        hist_file = os.path.join(self.save_dir, "histograms.jsonl")
        with open(hist_file, "a") as f:
            for name, arr in flat.items():
                counts, edges = np.histogram(
                    arr.astype("float32").ravel(), bins=10
                )
                f.write(json.dumps({
                    "step": int(step), "param": name,
                    "mean": float(arr.mean()), "std": float(arr.std()),
                    "counts": counts.tolist(),
                    "edges": [float(e) for e in edges],
                }) + "\n")
