"""Differentiable top-k operators of TranSTR.

Counterpart of vitxtgqa_tpu/ops/diff_topk.py (reference:
pythia/modules/transtr_module/topk.py):

  * hard_topk_indicator — one-hot columns of the top-k (the eval path);
  * perturbed_topk — the expected top-k indicator over noise-perturbed
    scores, with the estimator gradient E[onehot · noise] / (nS · sigma)
    (``PerturbedTopK``; JAX ``_ptk_bwd``).  The noise is passed in, or
    drawn from a ``torch.Generator`` (ops/gumbel.sample), so a test can
    feed both frameworks the same numbers.  JAX regenerates the noise from
    its key in the backward; the backward needs the noise only where a
    sample picked, so the port saves the picks and the noise there ([B,
    nS, k]), not the [B, nS, L] draw;
  * sinkhorn_topk — the entropy-regularised optimal-transport soft top-k,
    differentiated through its unrolled iterations;
  * sine_position_embedding — DETR's 1-D sine embedding over a mask.

Top-k breaks ties by the lower index, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vitxtgqa_tpu_torch.ops.gumbel import NoiseSource, _topk_idx, sample


def _top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim, descending,
    ties to the lower index (argmax for k = 1 keeps no [.., L] index
    tensor alive)."""
    if k == 1:
        return x.argmax(dim=-1, keepdim=True)
    return _topk_idx(x, k, largest=True)


def hard_topk_indicator(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L] scores -> [B, L, k]: column j the one-hot of the j-th
    largest entry."""
    idx = _top_indices(x, k)
    return F.one_hot(idx, x.shape[-1]).to(x.dtype).transpose(1, 2)


class PerturbedTopK(torch.autograd.Function):
    """[B, L] scores, [B, nS, L] noise -> [B, L, k]: the mean over the nS
    samples of the one-hot columns of each perturbed sample's top-k, its
    indices in ascending order (JAX _perturbed_indicator)."""

    @staticmethod
    def forward(ctx, x, noise, k: int, sigma: float):
        b, n_s, l = noise.shape
        perturbed = x[:, None, :] + noise * sigma
        idx = torch.sort(_top_indices(perturbed, k), dim=-1).values  # [B, nS, k]
        del perturbed
        counts = x.new_zeros((b, k, l)).scatter_add_(
            -1, idx.transpose(1, 2), x.new_ones((b, k, n_s)))
        ctx.cfg = (n_s, sigma, l)
        ctx.save_for_backward(idx, noise.gather(-1, idx))
        return (counts / n_s).transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        n_s, sigma, l = ctx.cfg
        idx, picked = ctx.saved_tensors
        b, _, k = idx.shape
        # E[onehot · noise] (JAX einsum("bnkd,bnd->bkd")) / nS / sigma
        expected = picked.new_zeros((b, k, l)).scatter_add_(
            -1, idx.transpose(1, 2), picked.transpose(1, 2)) / n_s / sigma
        return (g.transpose(1, 2) * expected).sum(dim=1), None, None, None


def perturbed_topk(x: torch.Tensor, noise, k: int, num_samples: int = 500,
                   sigma: float = 0.05) -> torch.Tensor:
    """[B, L] -> [B, L, k] expected top-k indicator (the training path).
    ``noise``: the [B, num_samples, L] standard-normal draw, or a
    NoiseSource to draw it from."""
    if not torch.is_tensor(noise):
        noise = sample(noise, (x.shape[0], num_samples, x.shape[1]), "normal", x.device)
    return PerturbedTopK.apply(x, noise.to(x.dtype), k, sigma)


def _sinkhorn_iterations(C, mu, nu, epsilon: float, max_iter: int):
    """The transport plan Gamma by Sinkhorn scaling (topk.py:16-33)."""
    G = torch.exp(-C / epsilon)
    v = torch.ones((C.shape[0], 1, C.shape[2]), dtype=C.dtype, device=C.device) / C.shape[2]
    for _ in range(max_iter):
        u = mu / (G * v).sum(-1, keepdim=True)
        v = nu / (G * u).sum(-2, keepdim=True)
    u = mu / (G * v).sum(-1, keepdim=True)
    return u * G * v


def sinkhorn_topk(scores: torch.Tensor, k: int, epsilon: float = 0.1,
                  max_iter: int = 200) -> torch.Tensor:
    """[B, n] scores -> [B, n, k] soft selection: the mass each score,
    normalised to [0, 1], sends to the anchor 1 of the costs to {0, 1}
    under marginals ((n - k) / n, k / n), times n, in each of k columns
    (topk.py:123-166)."""
    n = scores.shape[1]
    smin = scores.min(dim=-1, keepdim=True).values
    smax = scores.max(dim=-1, keepdim=True).values
    s = (scores - smin) / torch.clamp_min(smax - smin, 1e-12)
    anchors = torch.tensor([0.0, 1.0], dtype=s.dtype, device=s.device)
    C = (s[:, :, None] - anchors[None, None, :]).abs()
    mu = torch.full((1, n, 1), 1.0 / n, dtype=s.dtype, device=s.device)
    nu = torch.tensor([(n - k) / n, k / n], dtype=s.dtype, device=s.device).reshape(1, 1, 2)
    gamma = _sinkhorn_iterations(C, mu, nu, epsilon, max_iter)
    a = gamma[:, :, 1:] * n
    return a.repeat_interleave(k, dim=-1) / k * k


def sine_position_embedding(mask: torch.Tensor, num_pos_feats: int,
                            temperature: float = 10000.0, normalize: bool = True) -> torch.Tensor:
    """[B, L] validity mask -> [B, L, num_pos_feats] float32: sin / cos of
    the (normalised) cumulative positions, interleaved
    (transtr_module/position_encoding.py:12-49)."""
    x_embed = torch.cumsum(mask.float(), dim=1)
    if normalize:
        x_embed = x_embed / (x_embed[:, -1:] + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = torch.pow(torch.tensor(temperature, dtype=torch.float32, device=mask.device),
                      2 * torch.floor(dim_t / 2) / num_pos_feats)
    pos = x_embed[:, :, None] / dim_t[None, None, :]
    return torch.stack([torch.sin(pos[:, :, 0::2]), torch.cos(pos[:, :, 1::2])],
                       dim=3).reshape(mask.shape[0], mask.shape[1], num_pos_feats)
