"""Gumbel-softmax and static-shape hard top-k utilities.

Counterpart of vitxtgqa_tpu/ops/gumbel.py.  The gumbel noise is passed in,
or drawn from a given ``torch.Generator``, so a test can feed both
frameworks the same numbers.  Top-k breaks ties by the lower index, as
``jax.lax.top_k`` does: a stable sort, not ``torch.topk`` (whose tie order
is unspecified — and the grounding's bottom-k is dominated by -10000 ties).

``sample`` is the draw of the selector baselines (models/transtr.py,
models/mist.py): from a ``torch.Generator``, or from a callable source
``(shape, kind) -> array`` that a test fills with another framework's
numbers.  ``RankRows`` is the source of a rank of the data axis: it draws at
the global batch's shape and hands the rank its rows.
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


class RankRows:
    """The noise source of rank ``rank`` of a data axis of ``size`` ranks:
    each draw is made at the global batch's shape (the leading dimension
    times ``size``) from ``source``, which every rank holds alike (a
    generator seeded alike, or a callable), and the rank takes its rows of
    it, ``rank::size`` (data/loader.py's layout).  So every rank draws what
    one process draws for the global batch."""

    def __init__(self, source: NoiseSource, rank: int, size: int):
        self.source, self.rank, self.size = source, rank, size

    def __call__(self, shape, kind: str):
        shape = tuple(int(s) for s in shape)
        device = self.source.device if isinstance(self.source, torch.Generator) else None
        full = sample(self.source, (shape[0] * self.size,) + shape[1:], kind, device)
        return full[self.rank::self.size].contiguous()


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
