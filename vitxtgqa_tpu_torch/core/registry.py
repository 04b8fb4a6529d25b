"""The port's name->class registry.

A copy of vitxtgqa_tpu/core/registry.py with an instance of its own, so
that nothing registered in the JAX package is seen here (a process that
imports both cannot cross them).  Same string keys as the MMF-style
registry of the reference (pythia/common/registry.py:25-338), so the
reference YAML configs remain valid; a later registration under a name
replaces an earlier one.  Registration happens through the import
manifest ``vitxtgqa_tpu_torch.run.setup_imports``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """Name-keyed class maps plus a dotted-path state store."""

    _KINDS = (
        "model",
        "processor",
        "loss",
        "metric",
        "builder",
        "trainer",
        "optimizer",
        "scheduler",
    )

    def __init__(self) -> None:
        self._maps: Dict[str, Dict[str, Any]] = {k: {} for k in self._KINDS}
        self._state: Dict[str, Any] = {}

    # -- class registration ------------------------------------------------
    def _register(self, kind: str, name: str, cls: Any) -> Any:
        self._maps[kind][name] = cls
        return cls

    def _make_decorator(self, kind: str, name: str) -> Callable[[Any], Any]:
        def deco(cls: Any) -> Any:
            return self._register(kind, name, cls)

        return deco

    def register_model(self, name: str):
        return self._make_decorator("model", name)

    def register_processor(self, name: str):
        return self._make_decorator("processor", name)

    def register_loss(self, name: str):
        return self._make_decorator("loss", name)

    def register_metric(self, name: str):
        return self._make_decorator("metric", name)

    def register_builder(self, name: str):
        return self._make_decorator("builder", name)

    def register_trainer(self, name: str):
        return self._make_decorator("trainer", name)

    def register_optimizer(self, name: str):
        return self._make_decorator("optimizer", name)

    def register_scheduler(self, name: str):
        return self._make_decorator("scheduler", name)

    def _get_class(self, kind: str, name: str) -> Any:
        try:
            return self._maps[kind][name]
        except KeyError:
            known = sorted(self._maps[kind])
            raise KeyError(
                f"No {kind} registered under {name!r}; known: {known}"
            ) from None

    def get_model_class(self, name: str) -> Any:
        return self._get_class("model", name)

    def get_processor_class(self, name: str) -> Any:
        return self._get_class("processor", name)

    def get_loss_class(self, name: str) -> Any:
        return self._get_class("loss", name)

    def get_metric_class(self, name: str) -> Any:
        return self._get_class("metric", name)

    def get_builder_class(self, name: str) -> Any:
        return self._get_class("builder", name)

    def get_trainer_class(self, name: str) -> Any:
        return self._get_class("trainer", name)

    def list(self, kind: str) -> list:
        return sorted(self._maps[kind])

    # -- dotted-path state store -------------------------------------------
    # The reference stores hierarchical state ("config", "<ds>_text_vocab_size",
    # "losses.<ds>.<type>", ...) in the registry; we keep a flat dict with
    # dotted keys which covers every access pattern the framework uses.
    def register(self, key: str, value: Any) -> None:
        self._state[key] = value

    def get(self, key: str, default: Any = None, no_warning: bool = True) -> Any:
        return self._state.get(key, default)

    def unregister(self, key: str) -> Optional[Any]:
        return self._state.pop(key, None)

    def clear_state(self) -> None:
        self._state.clear()


registry = Registry()
