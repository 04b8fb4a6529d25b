"""Early stopping on a monitored validation metric
(reference: pythia/utils/early_stopping.py:40-82); the port's copy of
vitxtgqa_tpu/training/early_stopping.py."""

from __future__ import annotations

from typing import Optional


class EarlyStopping:
    def __init__(
        self,
        monitored_metric: str = "total_loss",
        patience: int = 4000,
        minimize: bool = True,
        should_stop: bool = True,
    ):
        self.monitored_metric = monitored_metric
        self.patience = patience
        self.minimize = minimize
        self.enabled = should_stop
        self.best_value: Optional[float] = None
        self.best_iteration = 0
        self.activated = False

    def improved(self, value: float) -> bool:
        if self.best_value is None:
            return True
        return value < self.best_value if self.minimize else value > self.best_value

    def __call__(self, value: float, iteration: int) -> bool:
        """Record `value`; returns True when training should stop."""
        if self.improved(value):
            self.best_value = float(value)
            self.best_iteration = iteration
            return False
        if not self.enabled:
            return False
        if iteration - self.best_iteration > self.patience:
            self.activated = True
            return True
        return False

    def is_best(self, value: float) -> bool:
        return self.improved(value)

    def init_from_meta(self, meta: dict) -> None:
        """Restore best-so-far bookkeeping from checkpoint metadata so a
        resumed run's patience window continues where it left off
        (reference: early_stopping.py:87-92 init_from_checkpoint via
        checkpoint.py:126)."""
        if meta.get("best_iteration") is not None:
            self.best_iteration = int(meta["best_iteration"])
        if meta.get("best_metric_value") is not None:
            self.best_value = float(meta["best_metric_value"])

    def get_info(self):
        return {
            "best_iteration": self.best_iteration,
            f"best_{self.monitored_metric}": self.best_value,
        }
