"""The loss registry of the JAX package, each loss as a (numerator,
denominator) pair, and their weighted sum.

Counterpart of vitxtgqa_tpu/losses.py (reference semantics:
pythia/modules/losses.py):
  * pos_bce_loss / bce_loss: masked BCE-with-logits over the decode-step
    score matrix (``pos_scores`` / ``scores``), over the active-step count;
  * InfoNCE: cosine(ref, pos) against cosine(ref, neg) over the
    row-normalised, flattened score matrices, divided by tau = 0.1, cross
    entropy to index 0, over the row count;
  * logit_bce (the legacy image-VQA models' loss): BCE-with-logits of
    ``scores`` against ``targets`` summed over the answer space, over the
    row count (JAX: the mean times the target width);
  * bce: BCE on probability scores, the same reduction;
  * bce_kl_combined: ``weight_softmax`` x KL(normalised targets ||
    softmax(scores)) + logit_bce's sum, over the row count;
  * multi: its ``params`` list of sub-losses, each weighted; its pair is
    the sub-losses' pairs stacked (numerators weighted), its value the sum
    of their ratios.
Each loss function returns its (numerator, denominator) on the rows it is
given, scalars or, for multi, 1-d tensors of the same length.  ``Losses``
takes the config's ``losses`` list ({type, weight, params}) and returns
{"<dataset>/<type>": weight * sum(numerator / max(denominator, 1))};
``terms`` gives the pairs themselves, for reductions on the host
(validation).

On the ranks of a data axis (``Losses(..., group=DataGroup)``) the
denominators (the active-step count, the row count) are summed over the
ranks in one all-reduce, so each loss is the rank's share of the global
batch's: the shares, and their gradients, sum over the ranks to the
one-process loss on the global batch and its gradient; a mean of the
ranks' own ratios would not.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from vitxtgqa_tpu_torch.parallel.collectives import all_reduce


def _bce_with_logits(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross entropy with logits."""
    return scores.clamp_min(0) - scores * targets + torch.log1p(torch.exp(-scores.abs()))


def _rows(x: torch.Tensor) -> torch.Tensor:
    # the count made on the device: no host-to-device copy in the step
    return torch.full((), float(x.shape[0]), device=x.device)


def _masked_bce(scores, targets, loss_mask) -> Tuple[torch.Tensor, torch.Tensor]:
    losses = _bce_with_logits(scores.float(), targets.float())
    mask = loss_mask.float()
    return (losses * mask[..., None]).sum(), mask.sum()


def pos_bce_loss(batch, model_output, **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked BCE sum, active-step count) of the pos variant's scores."""
    return _masked_bce(model_output["pos_scores"], batch["targets"], batch["train_loss_mask"])


def bce_loss(batch, model_output, **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked BCE sum, active-step count) of ``scores``."""
    return _masked_bce(model_output["scores"], batch["targets"], batch["train_loss_mask"])


def logit_bce(batch, model_output, **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BCE-with-logits sum, row count): the mean times the target width
    (MMF's LogitBinaryCrossEntropy, the legacy models' loss)."""
    scores = model_output["scores"].float()
    return _bce_with_logits(scores, batch["targets"].float()).sum(), _rows(scores)


def bce(batch, model_output, **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BCE sum on probability scores, row count) (reference:
    losses.py:176-197, the mean times the target width)."""
    scores, targets = model_output["scores"].float(), batch["targets"].float()
    eps = 1e-12
    losses = -(targets * torch.log(scores.clamp_min(eps))
               + (1.0 - targets) * torch.log((1.0 - scores).clamp_min(eps)))
    return losses.sum(), _rows(scores)


def bce_kl_combined(batch, model_output, weight_softmax: float = 1.0,
                    **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight_softmax x the KL sum + the BCE-with-logits sum, row count)
    (reference: losses.py:270-297): the targets normalised to a
    distribution (a zero row over 1e-6), KL against log_softmax(scores)
    with 0 log 0 = 0."""
    pred, target = model_output["scores"].float(), batch["targets"].float()
    tar_sum = target.sum(dim=1, keepdim=True)
    tar = target / torch.where(tar_sum == 0, torch.full_like(tar_sum, 1.0e-06), tar_sum)
    log_y = torch.where(tar == 0, torch.zeros_like(tar), torch.log(torch.where(
        tar == 0, torch.ones_like(tar), tar)))
    kl = (tar * (log_y - F.log_softmax(pred, dim=1))).sum()
    return weight_softmax * kl + _bce_with_logits(pred, target).sum(), _rows(pred)


def _cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    num = (a * b).sum(dim=-1)
    return num / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(eps)


def info_nce(batch, model_output, temperature: float = 0.1,
             **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the rows' -log p(ref ~ pos), row count)."""
    def flat_norm(x):
        x = x.float()
        x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return x.reshape(x.shape[0], -1)

    q, p, n = (flat_norm(model_output[k]) for k in ("ref_scores", "pos_scores", "neg_scores"))
    logits = torch.stack([_cosine(q, p), _cosine(q, n)], dim=1) / temperature
    rows = -F.log_softmax(logits, dim=1)[:, 0]
    return rows.sum(), _rows(rows)


def _field(entry: Any, key: str, default=None):
    if isinstance(entry, dict):
        return entry.get(key, default)
    return getattr(entry, key, default)


def _entry(entry: Any) -> Tuple[str, float, dict]:
    """(type, weight, params) of a loss config entry; a list of params (the
    multi loss's sub-losses) becomes {"params": [...]}, as in JAX."""
    params = _field(entry, "params", {}) or {}
    if isinstance(params, (list, tuple)) or (not hasattr(params, "items")
                                            and hasattr(params, "__iter__")):
        params = {"params": list(params)}
    return (str(_field(entry, "type")), float(_field(entry, "weight", 1.0) or 1.0),
            dict(params))


def multi(batch, model_output, params: List[Any] = (), **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sub-losses' pairs stacked, each numerator times its weight
    (reference: losses.py:210-266): the value is their ratios' sum."""
    nums, dens = [], []
    for sub in params:
        name, weight, sub_params = _entry(sub)
        if name not in LOSSES or name == "multi":
            raise ValueError(f"multi: sub-loss {name!r} (the port has {sorted(LOSSES)})")
        num, den = LOSSES[name](batch, model_output, **sub_params)
        nums.append(weight * num.reshape(-1).float())
        dens.append(den.reshape(-1).float())
    return torch.cat(nums), torch.cat(dens)


# each loss as (numerator, denominator): its value is
# sum(numerator / max(denominator, 1))
LOSSES: Dict[str, Callable] = {
    "pos_bce_loss": pos_bce_loss, "bce_loss": bce_loss, "InfoNCE": info_nce,
    "logit_bce": logit_bce, "bce": bce, "bce_kl_combined": bce_kl_combined, "multi": multi}


class Losses:
    """Config-driven weighted loss collection (the JAX ``Losses``); with a
    ``group`` (parallel/mesh.DataGroup) each loss is the rank's share of the
    global batch's."""

    def __init__(self, loss_configs: List[Any], dataset_name: str = "vtextgqa",
                 group: Optional[Any] = None):
        self.entries: List[Tuple[str, float, Callable, dict]] = []
        for entry in loss_configs:
            name, weight, params = _entry(entry)
            if name not in LOSSES:
                raise ValueError(f"loss {name!r} is not in the registry (the port has "
                                 f"{sorted(LOSSES)})")
            self.entries.append((name, weight, LOSSES[name], params))
        self.dataset_name = dataset_name
        self.group = group

    def terms(self, batch, model_output) -> Dict[str, Tuple[float, torch.Tensor, torch.Tensor]]:
        """{"<dataset>/<type>": (weight, numerator, denominator)} of this
        process's rows."""
        return {f"{self.dataset_name}/{name}": (weight, *fn(batch, model_output, **params))
                for name, weight, fn, params in self.entries}

    def zero_terms(self) -> Dict[str, Tuple[float, List[float], List[float]]]:
        """The host terms of no rows: zero numerators and denominators, as
        many as each loss has."""
        return {f"{self.dataset_name}/{name}": (weight, [0.0] * n, [0.0] * n)
                for name, weight, _, params in self.entries
                for n in [len(params.get("params", ())) if name == "multi" else 1]}

    def __call__(self, batch, model_output) -> Dict[str, torch.Tensor]:
        terms = self.terms(batch, model_output)
        dens = [den.float().reshape(-1) for _, _, den in terms.values()]
        flat = torch.cat(dens)
        if self.group is not None:
            flat = all_reduce(flat, self.group.group)
        dens = flat.split([d.numel() for d in dens])
        return {k: weight * (num.reshape(-1) / den.clamp_min(1.0)).sum()
                for (k, (weight, num, _)), den in zip(terms.items(), dens)}

    def total(self, batch, model_output):
        """(sum of the weighted losses, the dict of each)."""
        vals = self(batch, model_output)
        return sum(vals.values()), vals
