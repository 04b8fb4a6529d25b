"""Temporal + spatial grounding indicators (T2S-QA's core mechanism).

Counterpart of vitxtgqa_tpu/models/grounding.py, with the same static-shape
index plumbing.  The two gumbel draws (temporal, then spatial) are
injectable: ``GroundingModule.forward`` takes a ``torch.Generator`` to draw
them from, or the two noise tensors themselves ([B, 2, F] and [B, 2, N]);
a grounding that needs one draw only (the ablations of
models/t2s_ablations.py) takes its own from either (``draw_noise``).
Grounding computes in float32, as the JAX module does (its Dense layers
carry no compute dtype).  ``QuestionPooling`` is the question pooling that
the post-hoc heads (models/posthoc.py, models/t5vitevqa.py) share.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from vitxtgqa_tpu_torch.models.common import Linear
from vitxtgqa_tpu_torch.ops.gumbel import (
    gumbel_softmax,
    sample_gumbel,
    topk_indices_sorted,
    topk_mask,
)

Gumbel = Union[torch.Generator, Tuple[torch.Tensor, torch.Tensor]]
TEMPORAL, SPATIAL = 0, 1  # the draws of a Gumbel pair


def draw_noise(gumbel: Gumbel, which: int, shape, device) -> torch.Tensor:
    """The ``which`` draw (TEMPORAL [B, 2, F] or SPATIAL [B, 2, N]): taken
    from the pair, or drawn from the generator."""
    if isinstance(gumbel, torch.Generator):
        return sample_gumbel(shape, gumbel, device=device)
    return gumbel[which]


def attention_score(q_global, feats, mask):
    """Masked, renormalised attention of the pooled question over features:
    q_global [B, 1, D], feats [B, L, D], mask [B, L] -> [B, L], -10000 on
    masked slots."""
    attn = torch.einsum("bqd,bld->bl", q_global.float(), feats.float())
    attn = torch.softmax(attn, dim=-1) * mask
    attn = attn / (attn.sum(dim=-1, keepdim=True) + 1e-12)
    return torch.where(mask == 0, torch.full_like(attn, -10000.0), attn)


def _gumbel_pos_neg(noise, score, mask, tau: float = 1.0):
    """Hard pos/neg split of two identical score heads by gumbel noise
    [B, 2, L]; both masks zeroed on invalid slots."""
    hard = gumbel_softmax(torch.stack([score, score], dim=1), noise, tau=tau, dim=1)
    return hard[:, 0, :] * mask, hard[:, 1, :] * mask


def _masked(score, sel):
    return torch.where(sel == 0, torch.full_like(score, -10000.0), score * sel)


def temporal_grounding(noise, q_global, frame_feat, frame_mask, frame_id,
                       topk: int, tau: float = 1.0):
    """Returns (ground_frame [B, topk], pos_topk_mask [B, F], neg_topk_mask
    [B, F], pos_idx [B, topk], neg_idx [B, topk])."""
    score = attention_score(q_global, frame_feat, frame_mask)
    pos_mask, neg_mask = _gumbel_pos_neg(noise, score, frame_mask, tau)
    pos_score = _masked(score, pos_mask)
    neg_score = _masked(score, neg_mask)
    pos_topk = topk_mask(pos_score, topk, largest=True)
    neg_topk = topk_mask(neg_score, topk, largest=False)
    idx = topk_indices_sorted(pos_score, topk, largest=True)
    neg_idx = topk_indices_sorted(neg_score, topk, largest=False)
    ground_frame = torch.gather(frame_id, 1, idx)
    return ground_frame, pos_topk, neg_topk, idx, neg_idx


def frames_to_ocr_mask(ground_frame, temporal_id):
    """Grounded frame ids -> OCR-slot mask by temporal-id equality; frame
    id 0 (padding) maps to frame 1."""
    t1 = torch.where(ground_frame == 0, torch.ones_like(ground_frame), ground_frame)
    eq = temporal_id[:, None, :] == t1[:, :, None]
    return eq.any(dim=1).float()


def spatial_grounding(noise, q_global, ocr_feat, ocr_box, new_ocr_mask,
                      frame_num: int, ocr_frame_num: int, ocr_topk: int,
                      tau: float = 1.0):
    """Returns (ground_ocr_box [B, F*ocr_topk, 4], pos_topk_mask [B, N],
    neg_topk_mask [B, N], pos_idx [B, F*ocr_topk], neg_idx).  As in the
    reference, the pos mask is not re-multiplied by the validity mask, the
    neg mask is, and top-k is taken in every frame."""
    b, n, _ = ocr_feat.shape
    score = attention_score(q_global, ocr_feat, new_ocr_mask)
    pos_mask, neg_mask = _gumbel_pos_neg(noise, score, new_ocr_mask, tau)
    pos_grid = _masked(score, pos_mask).reshape(b, frame_num, ocr_frame_num)
    neg_grid = _masked(score, neg_mask).reshape(b, frame_num, ocr_frame_num)
    pos_topk = topk_mask(pos_grid, ocr_topk, largest=True).reshape(b, n)
    neg_topk = topk_mask(neg_grid, ocr_topk, largest=False).reshape(b, n) * new_ocr_mask
    frame_base = torch.arange(frame_num, device=ocr_feat.device)[None, :, None] * ocr_frame_num
    flat = (frame_base + topk_indices_sorted(pos_grid, ocr_topk, largest=True)).reshape(b, -1)
    flat_n = (frame_base + topk_indices_sorted(neg_grid, ocr_topk, largest=False)).reshape(b, -1)
    ground_box = torch.gather(ocr_box, 1, flat[..., None].expand(b, flat.shape[1], ocr_box.shape[2]))
    return ground_box, pos_topk, neg_topk, flat, flat_n


class QuestionPooling(nn.Module):
    """Self-attention pooling of the question rows (JAX pool_question)."""

    def __init__(self, in_dim: int, hidden_size: int):
        super().__init__()
        self.q_linear = Linear(in_dim, hidden_size)
        self.self_attn = Linear(hidden_size, 1)

    def pool_question(self, q_feat, q_mask):
        """[B, T, D], [B, T] -> q_global [B, 1, hidden] float32."""
        q_proj = self.q_linear(q_feat)
        attn = torch.softmax(self.self_attn(q_proj)[..., 0], dim=-1) * q_mask
        attn = attn / (attn.sum(dim=-1, keepdim=True) + 1e-12)
        return torch.einsum("bl,bld->bd", attn, q_proj)[:, None, :]


class GroundingModule(QuestionPooling):
    """Question pooling, then temporal and spatial grounding."""

    def __init__(self, in_dim: int, hidden_size: int, frame_topk: int, ocr_topk: int,
                 frame_num: int, ocr_frame_num: int, tau: float = 1.0):
        super().__init__(in_dim, hidden_size)
        self.frame_topk = frame_topk
        self.ocr_topk = ocr_topk
        self.frame_num = frame_num
        self.ocr_frame_num = ocr_frame_num
        self.tau = tau

    def forward(self, q_feat, q_mask, frame_feat, frame_mask, frame_id, ocr_feat,
                ocr_mask, ocr_box, temporal_id, gumbel: Gumbel):
        q_global = self.pool_question(q_feat, q_mask)
        b, f, n = frame_feat.shape[0], frame_feat.shape[1], ocr_feat.shape[1]
        noise_t = draw_noise(gumbel, TEMPORAL, (b, 2, f), q_global.device)
        noise_s = draw_noise(gumbel, SPATIAL, (b, 2, n), q_global.device)
        ground_frame, pos_f, neg_f, pos_f_idx, neg_f_idx = temporal_grounding(
            noise_t, q_global, frame_feat, frame_mask, frame_id, self.frame_topk, self.tau,
        )
        new_ocr_mask = frames_to_ocr_mask(ground_frame, temporal_id)
        ground_box, pos_o, neg_o, pos_o_idx, neg_o_idx = spatial_grounding(
            noise_s, q_global, ocr_feat, ocr_box, new_ocr_mask, self.frame_num,
            self.ocr_frame_num, self.ocr_topk, self.tau,
        )
        return {
            "ground_frame": ground_frame,
            "ground_bbox": ground_box,
            "pos_obj_mask": pos_f * frame_mask,
            "neg_obj_mask": neg_f * frame_mask,
            "pos_ocr_mask": pos_o,
            "neg_ocr_mask": neg_o,
            "pos_obj_idx": pos_f_idx,
            "pos_ocr_idx": pos_o_idx,
            "neg_obj_idx": neg_f_idx,
            "neg_ocr_idx": neg_o_idx,
        }
