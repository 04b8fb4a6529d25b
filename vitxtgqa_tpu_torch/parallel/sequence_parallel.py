"""Sequence-parallel attention.

Counterpart of vitxtgqa_tpu/parallel/sequence_parallel.py.  The JAX
package shards the sequence over a mesh ``sp`` axis inside a shard_map:
each device computes its L / sp query rows against all-gathered keys and
values.  The port runs one process per rank, and every rank holds the
whole batch, so keys and values are already whole on every rank: each rank
slices its own query rows [r * L / sp, (r + 1) * L / sp), attends them to
the full keys with row_offset = r * L / sp, and all-gathers the output
rows back to [B, H, L, D].  That is one collective per attention, and it
equals JAX's gather-K/V formulation.  With a MaskSpec and >= MIN_KV keys
a rank's rows go through the split-head flash kernel with its row offset
(ops/flash_attention.flash_attention, #10); otherwise through
mha_reference over the rank's rows of the bias (a MaskSpec's from
masks.local_rows_bias, -1e4 fill), as JAX does off the TPU.

Gradients (SPAttentionFn): every rank computes the same loss, so every
rank holds the same cotangent of the gathered output.  A rank takes its
own rows of it, runs the backward of its rows (the #10 backward kernel, or
autograd through the plain rows), all-gathers dQ, and all-reduces its f32
partial dK / dV (what shard_map's psum delivers in JAX) before the cast to
k / v's dtype.  torch.distributed.nn's differentiable all_gather would sum
the replicated cotangents and scale the gradients by sp; the backward is
written by hand instead.

SP is a capability, not a speedup, at the T2S joint sequence of 1,152 rows
(the JAX package says as much).
"""

from __future__ import annotations

import math

import torch

from vitxtgqa_tpu_torch.ops import flash_attention as FA
from vitxtgqa_tpu_torch.ops.attention import MIN_KV
from vitxtgqa_tpu_torch.ops.masks import MaskSpec, local_rows_bias
from vitxtgqa_tpu_torch.parallel import collectives as C
from vitxtgqa_tpu_torch.parallel.mesh import SPGroup


def _attend(q, k, v, bias, prob_dtype: torch.dtype) -> torch.Tensor:
    """ops/attention.mha_reference without dropout, its f32 result before
    the final cast: f32 scores plus the bias, the probabilities rounded to
    ``prob_dtype``, f32 accumulation (differentiable)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(prob_dtype)
    return torch.matmul(probs.float(), v.float())


def _gather_rows(x: torch.Tensor, sp: SPGroup) -> torch.Tensor:
    """[B, H, rows, D] of every rank -> [B, H, sp * rows, D] (a view of a
    [B, L, H, D] buffer)."""
    return C.all_gather(x.transpose(1, 2), sp.group, dim=1).transpose(1, 2)


def _reduce_heads(x: torch.Tensor, sp: SPGroup) -> torch.Tensor:
    """The sum over the ranks of a [B, H, L, D] partial."""
    return C.all_reduce(x.transpose(1, 2), sp.group).transpose(1, 2)


class SPAttentionFn(torch.autograd.Function):
    """Sequence-parallel attention of q / k / v [B, H, L, D] (the whole
    sequence on every rank) as one autograd node; see the module
    docstring.  ``bias``: None, a key-row [B, 1, 1, L] or per-row [B, 1, L,
    L] additive bias, or a MaskSpec; ``plain`` runs the plain versions on
    any device."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sp: SPGroup, plain: bool):
        l = q.shape[2]
        rows = l // sp.size
        r0 = sp.rank * rows
        q_s = q[:, :, r0:r0 + rows]
        flash = isinstance(bias, MaskSpec) and k.shape[2] >= MIN_KV
        ctx.cfg = (sp, plain, flash, r0, rows)
        if flash:
            key_mask = bias.key_mask.float().contiguous()
            fwd = FA.flash_attention_plain if plain else FA.flash_attention
            need_lse = any(ctx.needs_input_grad[:3])
            res = fwd(q_s, k, v, key_mask, bias.dec_len, r0, return_lse=need_lse)
            out_s, lse = res if need_lse else (res, None)
            ctx.dec_len = bias.dec_len
            ctx.save_for_backward(q_s, k, v, key_mask, out_s, lse)
        else:
            if isinstance(bias, MaskSpec):
                bias = local_rows_bias(bias.key_mask.float(), bias.dec_len, r0, rows)
            elif bias is not None and bias.shape[2] != 1:
                bias = bias[:, :, r0:r0 + rows]
            out_s = _attend(q_s, k, v, bias, v.dtype).to(v.dtype)
            ctx.save_for_backward(q_s, k, v, bias)
        return _gather_rows(out_s, sp)

    @staticmethod
    def backward(ctx, g):
        sp, plain, flash, r0, rows = ctx.cfg
        # this rank's rows of the cotangent, in the [B, rows, H, D] layout
        g_s = g[:, :, r0:r0 + rows].transpose(1, 2).contiguous().transpose(1, 2)
        if flash:
            q_s, k, v, key_mask, out_s, lse = ctx.saved_tensors
            bwd = FA.flash_attention_bwd_plain if plain else FA.flash_attention_bwd
            dq_s, dk, dv = bwd(q_s, k, v, key_mask, out_s, lse, g_s.to(out_s.dtype), ctx.dec_len,
                               r0)
        else:
            q_s, k, v, bias = ctx.saved_tensors
            leaves = [t.detach().float().requires_grad_() for t in (q_s, k, v)]
            with torch.enable_grad():
                out = _attend(*leaves, bias, v.dtype)
                dq_s, dk, dv = torch.autograd.grad(out, leaves, g_s.float())
        dq = _gather_rows(dq_s.to(q_s.dtype), sp)
        dk, dv = (_reduce_heads(t, sp).to(k.dtype) for t in (dk, dv))
        return dq, dk, dv, None, None, None


def sp_attention(q, k, v, bias, sp: SPGroup, plain: bool = False) -> torch.Tensor:
    """Attention of q / k / v [B, H, L, D] with the query rows split over
    the ranks of ``sp`` (L divisible by sp.size); returns [B, H, L, D] on
    every rank.  ``bias``: None | [B, 1, 1, L] | [B, 1, L, L] | MaskSpec."""
    if q.shape[2] % sp.size or q.shape[2] != k.shape[2]:
        raise ValueError(f"sp_attention: {q.shape[2]} query rows against {k.shape[2]} keys "
                         f"over {sp.size} ranks")
    return SPAttentionFn.apply(q, k, v, bias, sp, plain)
