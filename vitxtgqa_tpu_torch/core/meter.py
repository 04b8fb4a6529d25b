"""Windowed metric smoothing (reference: pythia/common/meter.py:8-93);
the port's copy of vitxtgqa_tpu/core/meter.py."""

from __future__ import annotations

from collections import deque
from typing import Dict


class SmoothedValue:
    """Track a series and expose median/avg over a window + global average."""

    def __init__(self, window_size: int = 20):
        self.window_size = window_size
        self.reset()

    def reset(self):
        self.deque = deque(maxlen=self.window_size)
        self.series = []
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        value = float(value)
        self.deque.append(value)
        self.series.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        vals = sorted(self.deque)
        n = len(vals)
        if n == 0:
            return 0.0
        mid = n // 2
        return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    def get_latest(self) -> float:
        return self.series[-1] if self.series else 0.0


class Meter:
    def __init__(self, delimiter: str = ", "):
        self.meters: Dict[str, SmoothedValue] = {}
        self.delimiter = delimiter

    def update(self, update_dict: Dict[str, float]):
        for k, v in update_dict.items():
            self.meters.setdefault(k, SmoothedValue()).update(float(v))

    def get_scalar_dict(self) -> Dict[str, float]:
        return {k: v.get_latest() for k, v in self.meters.items()}

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __getitem__(self, key):
        return self.meters[key]

    def __contains__(self, key):
        return key in self.meters

    def get_log_string(self) -> str:
        out = []
        for name, meter in self.meters.items():
            if "train" in name:
                out.append(f"{name}: {meter.median:.4f} ({meter.global_avg:.4f})")
            else:
                out.append(f"{name}: {meter.global_avg:.4f}")
        return self.delimiter.join(out)
