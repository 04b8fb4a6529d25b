"""Wall-clock timer with hh:mm:ss formatting (reference: pythia/utils/timer.py);
the port's copy of vitxtgqa_tpu/utils/timer.py."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.start = time.time() * 1000

    def get_current(self) -> str:
        return self.get_time_hhmmss(None)

    def reset(self):
        self.start = time.time() * 1000

    def get_time_since_start(self) -> float:
        """Milliseconds since construction/reset."""
        return time.time() * 1000 - self.start

    def get_time_hhmmss(self, gap: float = None) -> str:
        """Format `gap` ms (or time since start) as HH:MM:SS."""
        ms = self.get_time_since_start() if gap is None else gap
        seconds = int(ms / 1000)
        h, rem = divmod(seconds, 3600)
        m, s = divmod(rem, 60)
        return f"{h:02d}:{m:02d}:{s:02d}"
