"""Optimizer construction: Adam, Adamax or SGD (with momentum) with the
warmup / step-decay learning-rate multiplier, torch-style global-norm
clipping, and per-module learning-rate scales as parameter groups.

Counterpart of vitxtgqa_tpu/training/optim.py (reference semantics:
pythia/utils/general.py lr_lambda_update and clip_gradients,
pythia/utils/build_utils.py, the parameter groups of pythia/models/t2s.py):
  * the multiplier warms up linearly from ``warmup_factor`` over
    ``warmup_iterations`` (inclusive), then is ``lr_ratio ** #(lr_steps <=
    step)``;
  * clipping scales by ``min(1, max_norm / (norm + 1e-6))``, which is
    ``torch.nn.utils.clip_grad_norm_``;
  * the config's ``optimizer_attributes.type``: ``Adam`` / ``AdamW``
    (``torch.optim.Adam``: the JAX chain routes both to ``optax.adam``),
    ``Adamax`` (``torch.optim.Adamax``: its infinity norm is
    max(b2 * u, |g| + eps), eps inside the max, as optax's
    ``update_infinity_moment``) and ``SGD`` (``torch.optim.SGD`` with the
    config's ``momentum``: its buffer starts at the first gradient and
    takes no dampening, as optax's ``trace``; momentum 0 is plain SGD, as
    ``optax.sgd(momentum=None)``).  Each ``weight_decay`` is the L2-coupled
    decay the JAX chain reproduces with ``add_decayed_weights``;
  * a module's scale multiplies its group's learning rate (the JAX chain
    scales the post-optimizer update, which is the same for all three).  A scale that
    names no module raises, as ``assert_scales_resolve`` does.
The schedule is read at the optimizer's own count of applied updates, as
optax reads its ``count``: a step skipped by the NaN tripwire does not
advance it.

Data parallelism (``group``, a parallel/mesh.DataGroup): ``clip()`` sums
the float32 master gradients over the ranks in one all-reduce before it
takes the norm, so every rank clips, steps Adam and writes back the same
values.  The reduction runs once, after the backward (overlapping it with
the backward, as DDP's bucket hooks do, is not done).

Mixed precision: where the model holds a parameter in bfloat16 (the
transformer stacks in bf16, Options' default on the card), the optimizer
keeps a float32 master copy, steps that, and writes it back rounded; the
JAX model keeps float32 parameters and casts them to its compute dtype.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from vitxtgqa_tpu_torch.parallel.collectives import all_reduce_flat_

# configs/t2s_abinet.yml optimizer_attributes and training_parameters
PRODUCTION_OPTIMIZER = {"type": "Adam", "params": {"lr": 1e-4, "eps": 1e-8, "weight_decay": 0}}
PRODUCTION_TRAINING = {
    "clip_gradients": True, "max_grad_l2_norm": 0.25, "lr_scheduler": True,
    "lr_steps": [10000, 20000], "lr_ratio": 0.1, "use_warmup": True,
    "warmup_factor": 0.2, "warmup_iterations": 1000, "max_iterations": 24000,
    "batch_size": 48,
}

# the JAX model's top-level parameter subtrees that carry a learning-rate
# scale, and the port's module that holds the same parameters
MODULE_PREFIXES = {"text_bert": "text_bert.", "mmt": "mmt.encoder."}


def _get(node: Any, key: str, default=None):
    if isinstance(node, dict):
        return node.get(key, default)
    return getattr(node, key, default)


def lr_multiplier(step: int, use_warmup: bool, warmup_factor: float, warmup_iterations: int,
                  lr_steps: Sequence[int], lr_ratio: float) -> float:
    """The reference's lr_lambda_update at ``step``."""
    if use_warmup and warmup_iterations > 0 and step <= warmup_iterations:
        alpha = min(step, warmup_iterations) / float(warmup_iterations)
        return warmup_factor * (1.0 - alpha) + alpha
    return lr_ratio ** sum(step >= s for s in lr_steps)


def module_lr_scales(model_config: Any) -> Dict[str, float]:
    """{JAX top-level module: scale}: text_bert's only when it was
    initialised from bert-base (reference t2s.py:47-59), mmt's always,
    dropped where it is 1."""
    scales = {}
    text_scale = _get(model_config, "lr_scale_text_bert")
    if text_scale is not None and bool(_get(model_config, "text_bert_init_from_bert_base", True)):
        scales["text_bert"] = float(text_scale)
    mmt_scale = _get(model_config, "lr_scale_mmt")
    if mmt_scale is not None and float(mmt_scale) != 1.0:
        scales["mmt"] = float(mmt_scale)
    return scales


def param_groups(model: nn.Module, scales: Dict[str, float]) -> List[Dict[str, Any]]:
    """[{"params": [...], "lr_scale": s}], one group per scale and one for
    the rest; raises where a scale lands on nothing."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    groups, taken = [], set()
    for key, scale in scales.items():
        prefix = MODULE_PREFIXES.get(key)
        members = [(n, p) for n, p in named if prefix is not None and n.startswith(prefix)]
        if not members:
            raise ValueError(
                f"lr scale {key!r} matches no module of the model (known: "
                f"{sorted(MODULE_PREFIXES)}); the configured scaling would not apply")
        taken.update(n for n, _ in members)
        groups.append({"params": [p for _, p in members], "lr_scale": scale})
    groups.append({"params": [p for n, p in named if n not in taken], "lr_scale": 1.0})
    return [g for g in groups if g["params"]]


# optimizer_attributes.type (lower case) -> the torch optimizer
KINDS = {"adam": torch.optim.Adam, "adamw": torch.optim.Adam, "adamax": torch.optim.Adamax,
         "sgd": torch.optim.SGD}


class Optimizer:
    """Clip, schedule and the update (Adam by default; ``kind``: a key of
    KINDS) over a model's parameters (float32 master copies where a
    parameter is not float32): ``clip()`` takes the parameters' ``.grad``
    (summed over the ranks of ``group``), then ``apply()`` updates, or
    ``zero_grad()`` drops the gradients without an update."""

    def __init__(self, model: nn.Module, lr: float, eps: float = 1e-8, weight_decay: float = 0.0,
                 scales: Optional[Dict[str, float]] = None, max_grad_norm: Optional[float] = None,
                 schedule=lambda count: 1.0, group: Optional[Any] = None, kind: str = "adam",
                 momentum: float = 0.0):
        self.group = group
        self.base_lr = float(lr)
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.pairs = []  # (model parameter, the tensor Adam steps)
        adam_groups = []
        for g in param_groups(model, scales or {}):
            masters = []
            for p in g["params"]:
                m = p if p.dtype == torch.float32 else p.detach().float().clone()
                self.pairs.append((p, m))
                masters.append(m)
            adam_groups.append({"params": masters, "lr_scale": g["lr_scale"], "lr": self.base_lr})
        if kind not in KINDS:
            raise ValueError(f"optimizer {kind!r}: the port has {sorted(KINDS)}")
        extra = dict(momentum=momentum) if kind == "sgd" else dict(eps=eps)
        self.inner = KINDS[kind](adam_groups, lr=self.base_lr, weight_decay=weight_decay,
                                 **extra)

    def _master_grads(self) -> List[torch.Tensor]:
        """Every master copy gets a float32 gradient; a parameter the loss
        did not reach gets zeros, as optax sees it (its Adam moments still
        decay)."""
        grads = []
        for p, m in self.pairs:
            g = p.grad
            if g is None:
                g = torch.zeros_like(m)
            elif m is not p:
                g = g.float()
            m.grad = g
            grads.append(g)
        return grads

    def clip(self, extra: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        """Move the gradients onto the master copies (on a data axis, sum
        them over the ranks, with the float32 tensors ``extra`` in the same
        all-reduce) and clip them in place; returns their global L2 norm
        before clipping (float32, on the device, no sync)."""
        grads = self._master_grads()
        if self.group is not None:
            all_reduce_flat_(grads + list(extra), self.group.group)
        if self.max_grad_norm:
            return torch.nn.utils.clip_grad_norm_([m for _, m in self.pairs], self.max_grad_norm)
        return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))

    def apply(self) -> None:
        """One update from the clipped gradients at the scheduled learning
        rate; the master copies are written back to the model."""
        mult = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = self.base_lr * mult * group["lr_scale"]
        self.inner.step()
        with torch.no_grad():
            for p, m in self.pairs:
                if m is not p:
                    p.copy_(m)
        self.count += 1
        self.zero_grad()

    def zero_grad(self) -> None:
        """Drop the gradients (after an update, or instead of one)."""
        for p, m in self.pairs:
            p.grad = None
            m.grad = None

    def state_dict(self) -> Dict[str, Any]:
        """The count of applied updates, the optimizer's state (Adam's or
        Adamax's moments, SGD's momentum buffers; under the key "adam") and
        the float32 master copies (None where the parameter is its own
        master)."""
        return {"count": self.count, "adam": self.inner.state_dict(),
                "masters": [None if m is p else m.detach().clone() for p, m in self.pairs]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore ``state_dict()``'s output over the same parameters; the
        model's own parameters are restored from its state_dict."""
        if len(state["masters"]) != len(self.pairs):
            raise ValueError(f"optimizer state for {len(state['masters'])} parameters, "
                             f"this optimizer has {len(self.pairs)}")
        self.count = int(state["count"])
        with torch.no_grad():
            for (p, m), saved in zip(self.pairs, state["masters"]):
                if (saved is None) != (m is p):
                    raise ValueError("optimizer state of another parameter dtype layout")
                if saved is not None:
                    m.copy_(saved)
        self.inner.load_state_dict(state["adam"])


def build_optimizer(model: nn.Module, optimizer_attributes: Any = None,
                    training_parameters: Any = None, model_config: Any = None,
                    group: Optional[Any] = None) -> Optimizer:
    """The port's build_optimizer: the config's Adam, Adamax or SGD; the
    production config's by default; its gradients summed over the ranks of
    ``group`` (a DataGroup) where given."""
    oa = PRODUCTION_OPTIMIZER if optimizer_attributes is None else optimizer_attributes
    tp = PRODUCTION_TRAINING if training_parameters is None else training_parameters
    kind = str(_get(oa, "type", "Adam") or "Adam").lower()
    params = _get(oa, "params", {}) or {}
    lr_steps = list(_get(tp, "lr_steps", []) or []) if _get(tp, "lr_scheduler", False) else []
    warm = (bool(_get(tp, "use_warmup", False)), float(_get(tp, "warmup_factor", 0.2)),
            int(_get(tp, "warmup_iterations", 1000)))
    ratio = float(_get(tp, "lr_ratio", 0.1))
    max_norm = _get(tp, "max_grad_l2_norm", None) if _get(tp, "clip_gradients", False) else None
    return Optimizer(
        model, lr=float(_get(params, "lr", 1e-4)), eps=float(_get(params, "eps", 1e-8)),
        weight_decay=float(_get(params, "weight_decay", 0.0) or 0.0),
        scales=module_lr_scales(model_config) if model_config is not None else None,
        max_grad_norm=float(max_norm) if max_norm else None,
        schedule=lambda count: lr_multiplier(count, *warm, lr_steps, ratio), group=group,
        kind=kind, momentum=float(_get(params, "momentum", 0.0) or 0.0),
    )
