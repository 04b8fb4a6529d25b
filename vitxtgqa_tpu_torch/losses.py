"""The two losses of the production T2S config, and their weighted sum.

Counterpart of vitxtgqa_tpu/losses.py (reference semantics:
pythia/modules/losses.py):
  * pos_bce_loss: masked BCE-with-logits over the decode-step score
    matrix of the pos variant, normalised by the active-step count;
  * InfoNCE: cosine(ref, pos) against cosine(ref, neg) over the
    row-normalised, flattened score matrices, divided by tau = 0.1, cross
    entropy to index 0.
Each loss function returns its (numerator, denominator) on the rows it is
given.  ``Losses`` takes the config's ``losses`` list ({type, weight,
params}) and returns {"<dataset>/<type>": weight * numerator /
max(denominator, 1)}; ``terms`` gives the pairs themselves, for reductions
on the host (validation).  The rest of the JAX registry (bce_loss,
logit_bce, bce, bce_kl_combined, multi) is not ported.

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


def pos_bce_loss(batch, model_output, **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked BCE sum, active-step count) of the pos variant's scores."""
    losses = _bce_with_logits(model_output["pos_scores"].float(), batch["targets"].float())
    mask = batch["train_loss_mask"].float()
    return (losses * mask[..., None]).sum(), mask.sum()


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
    # the count made on the device: no host-to-device copy in the step
    return rows.sum(), torch.full((), float(rows.shape[0]), device=rows.device)


# each loss as (numerator, denominator): its value is numerator / max(denominator, 1)
LOSSES: Dict[str, Callable] = {"pos_bce_loss": pos_bce_loss, "InfoNCE": info_nce}


def _field(entry: Any, key: str, default=None):
    if isinstance(entry, dict):
        return entry.get(key, default)
    return getattr(entry, key, default)


class Losses:
    """Config-driven weighted loss collection (the JAX ``Losses``); with a
    ``group`` (parallel/mesh.DataGroup) each loss is the rank's share of the
    global batch's."""

    def __init__(self, loss_configs: List[Any], dataset_name: str = "vtextgqa",
                 group: Optional[Any] = None):
        self.entries: List[Tuple[str, float, Callable, dict]] = []
        for entry in loss_configs:
            name = _field(entry, "type")
            if name not in LOSSES:
                raise ValueError(f"loss {name!r} is not ported (the port has {sorted(LOSSES)})")
            weight = float(_field(entry, "weight", 1.0) or 1.0)
            params = dict(_field(entry, "params", {}) or {})
            self.entries.append((name, weight, LOSSES[name], params))
        self.dataset_name = dataset_name
        self.group = group

    def terms(self, batch, model_output) -> Dict[str, Tuple[float, torch.Tensor, torch.Tensor]]:
        """{"<dataset>/<type>": (weight, numerator, denominator)} of this
        process's rows."""
        return {f"{self.dataset_name}/{name}": (weight, *fn(batch, model_output, **params))
                for name, weight, fn, params in self.entries}

    def __call__(self, batch, model_output) -> Dict[str, torch.Tensor]:
        terms = self.terms(batch, model_output)
        dens = torch.stack([den.float() for _, _, den in terms.values()])
        if self.group is not None:
            dens = all_reduce(dens, self.group.group)
        return {k: weight * num / den.clamp_min(1.0)
                for (k, (weight, num, _)), den in zip(terms.items(), dens)}

    def total(self, batch, model_output):
        """(sum of the weighted losses, the dict of each)."""
        vals = self(batch, model_output)
        return sum(vals.values()), vals
