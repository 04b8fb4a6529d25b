"""Layered YAML configuration with includes, overrides and freezing.

The port's copy of vitxtgqa_tpu/core/config.py (a test holds the two
equal on the repo's configs); its defaults are the port's copies under
vitxtgqa_tpu_torch/defaults/configs.

Mirrors the reference config semantics (pythia/utils/configuration.py:96-347)
so the public `configs/*.yml` schema keeps working:

  base defaults -> `includes:` (recursive) -> experiment yaml
    -> --config_override JSON -> dotted `opts` -> typed flag overrides
    -> consistency fixups -> freeze

Implementation: a single immutable attr-dict
(`ConfigNode`) built once, no demjson (plain json), include paths resolved
against an explicit search-path list instead of a package-root heuristic.
"""

from __future__ import annotations

import ast
import collections
import json
import os
from typing import Any, Dict, Iterable, List, Optional

import yaml


class ConfigNode(collections.OrderedDict):
    """Dict with attribute access; immutable once frozen."""

    IMMUTABLE = "__is_frozen"

    def __init__(self, init: Optional[Dict[str, Any]] = None):
        super().__init__()
        object.__setattr__(self, ConfigNode.IMMUTABLE, False)
        if init:
            for k, v in init.items():
                self[k] = _wrap(v)

    # attribute-style access ------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        if key.startswith("__"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, ConfigNode.IMMUTABLE):
            raise AttributeError(
                f"ConfigNode is frozen; cannot set {key!r}"
            )
        self[key] = _wrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, ConfigNode.IMMUTABLE):
            raise AttributeError(
                f"ConfigNode is frozen; cannot set {key!r}"
            )
        super().__setitem__(key, _wrap(value))

    # freezing --------------------------------------------------------------
    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, ConfigNode.IMMUTABLE, True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
            elif isinstance(v, list):
                for item in v:
                    if isinstance(item, ConfigNode):
                        item.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, ConfigNode.IMMUTABLE, False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
            elif isinstance(v, list):
                for item in v:
                    if isinstance(item, ConfigNode):
                        item.defrost()
        return self

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            if isinstance(v, ConfigNode):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [
                    i.to_dict() if isinstance(i, ConfigNode) else i for i in v
                ]
            else:
                out[k] = v
        return out

    def get(self, key, default=None):  # keep dict.get semantics
        return super().get(key, default)


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return value
    if isinstance(value, dict):
        return ConfigNode(value)
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def nested_merge(base: Dict[str, Any], update: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge `update` into `base` (update wins)."""
    for key, val in update.items():
        if (
            key in base
            and isinstance(base[key], dict)
            and isinstance(val, dict)
        ):
            nested_merge(base[key], val)
        else:
            base[key] = val
    return base


# ---------------------------------------------------------------------------
# YAML loading with includes
# ---------------------------------------------------------------------------

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULTS_DIR = os.path.join(_PKG_DIR, "defaults", "configs")

# Accept the reference repo's include prefix so its experiment YAMLs parse
# unmodified (reference: configs/t2s_abinet.yml:1-2 includes
# "common/defaults/configs/datasets/videoqa/vtextgqa.yml").
_REFERENCE_INCLUDE_PREFIX = "common/defaults/configs/"


def _resolve_include(path: str, search_dirs: Iterable[str]) -> str:
    if os.path.isabs(path) and os.path.exists(path):
        return path
    candidates: List[str] = []
    if path.startswith(_REFERENCE_INCLUDE_PREFIX):
        candidates.append(
            os.path.join(DEFAULTS_DIR, path[len(_REFERENCE_INCLUDE_PREFIX):])
        )
    for d in search_dirs:
        candidates.append(os.path.join(d, path))
    candidates.append(os.path.join(DEFAULTS_DIR, path))
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(
        f"Cannot resolve include {path!r}; tried {candidates}"
    )


def load_yaml_with_includes(
    path: str, search_dirs: Optional[List[str]] = None
) -> Dict[str, Any]:
    """Load a YAML file, recursively merging its `includes:` list first."""
    search_dirs = list(search_dirs or [])
    with open(path, "r", encoding="utf-8") as f:
        mapping = yaml.safe_load(f) or {}
    if not isinstance(mapping, dict):
        raise ValueError(f"Top level of {path} must be a mapping")

    includes = mapping.pop("includes", [])
    if not isinstance(includes, list):
        raise ValueError(f"`includes:` in {path} must be a list")

    base: Dict[str, Any] = {}
    child_dirs = [os.path.dirname(os.path.abspath(path))] + search_dirs
    for inc in includes:
        inc_path = _resolve_include(inc, child_dirs)
        nested_merge(base, load_yaml_with_includes(inc_path, search_dirs))
    nested_merge(base, mapping)
    return base


# ---------------------------------------------------------------------------
# Overrides
# ---------------------------------------------------------------------------

def decode_value(value: Any) -> Any:
    """Interpret a CLI string as a Python literal when possible.

    Matches reference `Configuration._decode_value`
    (pythia/utils/configuration.py:227-241): literal_eval with
    "None"/"True"/"False" handling, else keep the raw string.
    """
    if not isinstance(value, str):
        return value
    if value == "None":
        return None
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def apply_dotted_overrides(config: Dict[str, Any], opts: Optional[List[str]]) -> None:
    """Apply `a.b.c value` pair overrides (reference: configuration.py:193-225).

    Accepts both ["key", "value", ...] pair style and ["key=value", ...].
    """
    if not opts:
        return
    # mixed "key=value" and "key value" styles are both accepted
    pairs = []
    i = 0
    while i < len(opts):
        if "=" in opts[i]:
            pairs.append(tuple(opts[i].split("=", 1)))
            i += 1
        else:
            if i + 1 >= len(opts):
                raise ValueError(f"opts must be key/value pairs, got {opts}")
            pairs.append((opts[i], opts[i + 1]))
            i += 2

    for key, raw in pairs:
        node = config
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise KeyError(f"Cannot descend into non-dict at {p!r} of {key!r}")
        node[parts[-1]] = decode_value(raw)


def apply_json_override(config: Dict[str, Any], blob: Optional[str]) -> None:
    """Apply a JSON-string override (reference used demjson; we use json)."""
    if not blob:
        return
    nested_merge(config, json.loads(blob))


def update_key_everywhere(config: Dict[str, Any], key: str, value: Any) -> bool:
    """Set `key` at any depth where it already exists.

    Matches reference `Configuration._update_key` (configuration.py:243-256):
    typed argparse flags override every same-named key in the tree.
    """
    found = False
    if key in config:
        config[key] = value
        found = True
    for v in config.values():
        if isinstance(v, dict):
            found = update_key_everywhere(v, key, value) or found
    return found


# ---------------------------------------------------------------------------
# Configuration facade
# ---------------------------------------------------------------------------

class Configuration:
    """Build the frozen config for a run.

    Layering (reference: pythia/utils/configuration.py:96-347):
      defaults/base.yml -> experiment yaml (with includes) ->
      --config_override JSON -> dotted opts -> args attribute overrides ->
      consistency fixups -> freeze.
    """

    def __init__(self, config_path: str, search_dirs: Optional[List[str]] = None):
        self.config_path = config_path
        base_path = os.path.join(DEFAULTS_DIR, "base.yml")
        self._dict: Dict[str, Any] = {}
        if os.path.exists(base_path):
            self._dict = load_yaml_with_includes(base_path, search_dirs)
        user = load_yaml_with_includes(config_path, search_dirs)
        nested_merge(self._dict, user)
        self.config: Optional[ConfigNode] = None

    def override_with_cmd_config(self, blob: Optional[str]) -> None:
        apply_json_override(self._dict, blob)

    def override_with_cmd_opts(self, opts: Optional[List[str]]) -> None:
        apply_dotted_overrides(self._dict, opts)

    def update_with_args(self, args: Any, extra_args_only: bool = False) -> None:
        """Fold argparse namespace values into any matching key in the tree."""
        # identity flags only ever live at the top level; deep-updating them
        # would clobber unrelated same-named keys (e.g. the mesh `model` axis)
        top_level_only = ("model", "datasets", "tasks")
        for key, value in vars(args).items():
            if key in ("opts", "config_override", "config"):
                continue
            if value is None:
                continue
            if key in top_level_only:
                self._dict[key] = value
            else:
                update_key_everywhere(self._dict, key, value)

    def _update_specific(self) -> None:
        tp = self._dict.setdefault("training_parameters", {})
        seed = tp.get("seed", None)
        if seed is not None and int(seed) == -1:
            import random

            tp["seed"] = random.randint(1, 1_000_000)
        # the torch-era `device: cuda` default and `auto` both mean the
        # card (training/trainer.options_from_config); normalised as the
        # JAX package normalises it, so the two configs stay equal
        if tp.get("device") == "cuda":
            tp["device"] = "auto"

    def freeze(self) -> ConfigNode:
        self._update_specific()
        self.config = ConfigNode(self._dict).freeze()
        return self.config


def build_config(
    config_path: str,
    opts: Optional[List[str]] = None,
    config_override: Optional[str] = None,
    args: Any = None,
    search_dirs: Optional[List[str]] = None,
) -> ConfigNode:
    c = Configuration(config_path, search_dirs=search_dirs)
    c.override_with_cmd_config(config_override)
    c.override_with_cmd_opts(opts)
    if args is not None:
        c.update_with_args(args)
    return c.freeze()
