"""One T2S training step: forward, losses, backward, the NaN tripwire,
clipping and the Adam update.

Counterpart of the step body of vitxtgqa_tpu/training/trainer.py
(``train_step``) and bench.py's ``_run_train_bench``.  The full trainer
(data loading, checkpoints, early stopping) is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.training.optim import Optimizer


def step_generators(seed: int, step: int, device) -> Tuple[torch.Generator, torch.Generator]:
    """(dropout, gumbel) generators of one step, a function of (seed,
    step) as the JAX trainer's ``fold_in(rng, step)`` keys are."""
    s = np.random.SeedSequence([int(seed), int(step) % 2**32]).generate_state(2)
    return tuple(torch.Generator(device=device).manual_seed(int(x)) for x in s)


def train_step(model, losses: Losses, optimizer: Optimizer, batch: Dict[str, torch.Tensor],
               generators: Tuple[torch.Generator, Any]) -> Dict[str, Any]:
    """``generators``: (dropout generator, gumbel generator or the two
    noise tensors).  A non-finite loss or gradient norm skips the update
    (the JAX trainer's NaN tripwire), which costs one host sync a step.
    Returns the loss, each weighted loss, the gradient norm before clipping
    and whether the update was applied."""
    dropout_gen, gumbel = generators
    out = model(batch, gumbel, train=True, dropout_gen=dropout_gen)
    total, parts = losses.total(batch, out)
    total.backward()
    norm = optimizer.clip()
    applied = bool(torch.isfinite(total) & torch.isfinite(norm))
    if applied:
        optimizer.apply()
    else:
        optimizer.zero_grad()
    return {"loss": total.detach(), "losses": {k: v.detach() for k, v in parts.items()},
            "grad_norm": norm, "applied": applied}
