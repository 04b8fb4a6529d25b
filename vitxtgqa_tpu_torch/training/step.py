"""One T2S training step: forward, losses, backward, the NaN tripwire,
clipping and the Adam update.

Counterpart of the step body of vitxtgqa_tpu/training/trainer.py
(``train_step``) and bench.py's ``_run_train_bench``; training/trainer.py
runs it once per iteration.

On the ranks of a data axis (the optimizer's ``group``): the gumbel draws
are the one-process draws at the global batch's shape, each rank taking
its rows (ops/gumbel.RankRows); the dropout streams fold in the rank, so
that no two ranks draw the same masks for their different rows (JAX draws
one mask over the global batch); the losses are the rank's shares
(losses.py), and the step's losses ride the gradients' all-reduce, so the
NaN tripwire decides on the global loss and norm on every rank alike and
the returned loss is the global one.  The group is the mesh's data group:
every model, sp and pp rank of one data row replicates that row's rows,
so they take the same rows and draw the same dropout and gumbel numbers
(the generators fold in the data coordinate, never the world rank); a
tensor-parallel rank's kernels draw their heads' part of the whole
layer's masks.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.ops.gumbel import RankRows
from vitxtgqa_tpu_torch.training.optim import Optimizer


def step_generators(seed: int, step: int, device,
                    group: Optional[Any] = None) -> Tuple[torch.Generator, Any]:
    """(dropout, gumbel) generators of one step, a function of (seed,
    step) as the JAX trainer's ``fold_in(rng, step)`` keys are.  On a data
    axis (``group``, the mesh's DataGroup) the dropout generator also folds
    in the data coordinate, and the gumbel draws come from a RankRows over
    the step's generator."""
    s = np.random.SeedSequence([int(seed), int(step) % 2**32]).generate_state(2)
    drop, gumbel = (torch.Generator(device=device).manual_seed(int(x)) for x in s)
    if group is None:
        return drop, gumbel
    rank_seed = np.random.SeedSequence([int(s[0]), group.rank]).generate_state(1)[0]
    return (torch.Generator(device=device).manual_seed(int(rank_seed)),
            RankRows(gumbel, group.rank, group.size))


def train_step(model, losses: Losses, optimizer: Optimizer, batch: Dict[str, torch.Tensor],
               generators: Tuple[torch.Generator, Any]) -> Dict[str, Any]:
    """``generators``: (dropout generator, gumbel generator, noise source
    or the two noise tensors).  A non-finite loss or gradient norm skips the
    update (the JAX trainer's NaN tripwire), which costs one host sync a
    step.  Returns the loss, each weighted loss, the gradient norm before
    clipping (on a data axis: the global ones), whether the update was
    applied and the forward's outputs (detached)."""
    dropout_gen, gumbel = generators
    out = model(batch, gumbel, train=True, dropout_gen=dropout_gen)
    total, parts = losses.total(batch, out)
    total.backward()
    # the losses ride the gradients' all-reduce on a data axis
    seen = torch.stack([total.detach()] + [v.detach() for v in parts.values()]).float()
    norm = optimizer.clip(extra=[seen])
    total, parts = seen[0], dict(zip(parts, seen[1:]))
    applied = bool(torch.isfinite(total) & torch.isfinite(norm))
    if applied:
        optimizer.apply()
    else:
        optimizer.zero_grad()
    return {"loss": total.detach(), "losses": {k: v.detach() for k, v in parts.items()},
            "grad_norm": norm, "applied": applied,
            "out": {k: v.detach() if torch.is_tensor(v) else v for k, v in out.items()}}
