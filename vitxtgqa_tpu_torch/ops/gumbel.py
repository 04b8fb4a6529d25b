"""Gumbel-softmax and static-shape hard top-k utilities.

Counterpart of vitxtgqa_tpu/ops/gumbel.py.  The gumbel noise is passed in,
or drawn from a given ``torch.Generator``, so a test can feed both
frameworks the same numbers.  Top-k breaks ties by the lower index, as
``jax.lax.top_k`` does: a stable sort, not ``torch.topk`` (whose tie order
is unspecified — and the grounding's bottom-k is dominated by -10000 ties).

``sample`` is the draw of the selector baselines (models/transtr.py,
models/mist.py): from a ``torch.Generator``, or from a callable source
``(shape, kind) -> array`` that a test fills with another framework's
numbers.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

# a generator, or a callable (shape, kind) -> array, kind "gumbel",
# "normal" or "uniform"
NoiseSource = Union[torch.Generator, Callable[[Tuple[int, ...], str], object]]


def sample_gumbel(shape, generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """Standard Gumbel noise, float32: -log(E) with E ~ Exp(1)."""
    e = torch.empty(shape, device=device, dtype=torch.float32)
    e.exponential_(generator=generator)
    return -torch.log(e)


def sample(source: NoiseSource, shape, kind: str = "gumbel", device=None) -> torch.Tensor:
    """float32 noise of ``shape``: standard Gumbel, standard normal or
    uniform on [0, 1) (``kind``) drawn from a generator, or what a callable
    source returns for (shape, kind)."""
    shape = tuple(int(s) for s in shape)
    if not isinstance(source, torch.Generator):
        if source is None:
            raise ValueError(f"a {kind} draw of {shape} needs a torch.Generator or a noise source")
        return torch.as_tensor(source(shape, kind), dtype=torch.float32, device=device)
    if kind == "gumbel":
        return sample_gumbel(shape, source, device=device)
    x = torch.empty(shape, device=device, dtype=torch.float32)
    if kind == "normal":
        return x.normal_(generator=source)
    if kind == "uniform":
        return x.uniform_(generator=source)
    raise ValueError(f"unknown noise kind {kind!r}")


def gumbel_softmax(logits: torch.Tensor, noise: torch.Tensor, tau: float = 1.0,
                   dim: int = -1) -> torch.Tensor:
    """Hard straight-through Gumbel-softmax: forward one-hot, soft
    gradients.  The forward value is ``y_hard + y_soft - y_soft`` in that
    order, as in the JAX version."""
    y_soft = torch.softmax((logits + noise.to(logits.dtype)) / tau, dim=dim)
    index = y_soft.argmax(dim=dim, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(dim, index, 1.0)
    return y_hard + y_soft - y_soft.detach()


def _topk_idx(scores: torch.Tensor, k: int, largest: bool) -> torch.Tensor:
    return torch.sort(scores, dim=-1, descending=largest, stable=True).indices[..., :k]


def topk_mask(scores: torch.Tensor, k: int, largest: bool = True) -> torch.Tensor:
    """0/1 mask of the k best entries along the last dim (ties by index)."""
    idx = _topk_idx(scores, k, largest)
    return torch.zeros_like(scores).scatter_(-1, idx, 1.0)


def topk_indices_sorted(scores: torch.Tensor, k: int, largest: bool = True) -> torch.Tensor:
    """Indices of the k best entries, in ascending index order."""
    return torch.sort(_topk_idx(scores, k, largest), dim=-1).values
