"""T2S ablation variants: without temporal grounding (``t2s_wo_tg``) and
without spatial grounding (``t2s_wo_sg``).

Counterpart of vitxtgqa_tpu/models/t2s_ablations.py (reference:
pythia/models/t2s_wo_tg.py, t2s_wo_sg.py).  Both keep the T2S body and swap
its grounding (``T2S.GROUNDING_CLS``):

  t2s_wo_tg: no temporal indicator.  The candidate set is every real
    frame's OCR slots; the spatial indicator runs with o_topk =
    min(frame_topk * ocr_topk, ocr_frame_num), which selects every slot of
    a frame as the reference's over-long top-k slice does.  The "grounded
    frames" are the first frame_topk frame grid indices holding a grounded
    OCR slot, padded with -1; the frame masks' scatter wraps the -1 to the
    last frame (JAX ``.at[b, -1].set``, the reference's quirk), which
    torch's scatter does not do by itself.  Its ground_frame keeps the
    grid indices, -1 included.  It returns no gather lists, so compact
    serving and compact full-eval take the full paths.
  t2s_wo_sg: no spatial indicator.  Every OCR slot of the grounded frames
    is kept (the frame-expansion mask), the negatives are its complement.
    Its pos gather lists: the temporal top-k's frame positions and the
    first frame_topk * ocr_frame_num slots of the expansion mask, -1-padded
    where ground ids collapse (a padding frame's id 0 maps onto frame 1);
    the compact decode clamps the gathers and sends the -1 entries' copy
    scores to a trash slot (``COMPACT_IDX_MAY_PAD``).  No neg list: a
    complement does not compact, so compact full-eval runs in full.

The grounding takes one gumbel draw each: wo_tg the spatial one ([B, 2,
N]), wo_sg the temporal one ([B, 2, F]), from a generator or from the
(temporal, spatial) pair.
"""

from __future__ import annotations

import torch

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.models.grounding import (
    SPATIAL,
    TEMPORAL,
    Gumbel,
    GroundingModule,
    draw_noise,
    frames_to_ocr_mask,
    spatial_grounding,
    temporal_grounding,
)
from vitxtgqa_tpu_torch.models.t2s import T2S


def _first_k_true_indices(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first k true entries of each row of ``mask`` [B, n],
    in ascending order, -1 padded."""
    n = mask.shape[1]
    cols = torch.arange(n, device=mask.device)
    order = torch.argsort(torch.where(mask, cols, n + cols), dim=-1)[:, :k]
    counts = mask.sum(dim=-1, keepdim=True)
    return torch.where(torch.arange(k, device=mask.device)[None, :] < counts, order,
                       torch.full_like(order, -1))


def _scatter_ones(idx: torch.Tensor, n: int) -> torch.Tensor:
    """A [B, n] float32 mask with ones at ``idx`` [B, k]; an index of -1
    marks the last column (JAX's negative-index wrap)."""
    wrapped = torch.where(idx < 0, idx + n, idx)
    return torch.zeros((idx.shape[0], n), device=idx.device).scatter_(1, wrapped, 1.0)


class GroundingWithoutTemporal(GroundingModule):
    """Spatial-only grounding (reference: t2s_wo_tg.py:461-540)."""

    def forward(self, q_feat, q_mask, frame_feat, frame_mask, frame_id, ocr_feat,
                ocr_mask, ocr_box, temporal_id, gumbel: Gumbel):
        q_global = self.pool_question(q_feat, q_mask)
        b, n = ocr_feat.shape[:2]
        f, k = self.frame_num, self.ocr_frame_num
        # the candidate set: every real frame's OCR slots
        t1 = torch.where(frame_id == 0, torch.ones_like(frame_id), frame_id)
        new_ocr_mask = frames_to_ocr_mask(t1, temporal_id)
        noise_s = draw_noise(gumbel, SPATIAL, (b, 2, n), q_global.device)
        eff_topk = min(self.frame_topk * self.ocr_topk, k)
        ground_box, pos_o, neg_o, _, _ = spatial_grounding(
            noise_s, q_global, ocr_feat, ocr_box, new_ocr_mask, f, k, eff_topk, self.tau)
        ground_ocr_mask = pos_o * ocr_mask
        neg_ocr_mask = neg_o * ocr_mask
        # frames holding a grounded OCR slot -> the first frame_topk grid
        # indices, -1 padded
        ground_frame_idx = _first_k_true_indices(
            (ground_ocr_mask.reshape(b, f, k) != 0).any(-1), self.frame_topk)
        neg_frame_idx = _first_k_true_indices(
            (neg_ocr_mask.reshape(b, f, k) != 0).any(-1), self.frame_topk)
        return {
            "ground_frame": ground_frame_idx,
            "ground_bbox": ground_box,
            "pos_obj_mask": _scatter_ones(ground_frame_idx, f),
            "neg_obj_mask": _scatter_ones(neg_frame_idx, f),
            "pos_ocr_mask": ground_ocr_mask,
            "neg_ocr_mask": neg_ocr_mask,
        }


class GroundingWithoutSpatial(GroundingModule):
    """Temporal-only grounding (reference: t2s_wo_sg.py:461-520)."""

    def forward(self, q_feat, q_mask, frame_feat, frame_mask, frame_id, ocr_feat,
                ocr_mask, ocr_box, temporal_id, gumbel: Gumbel):
        q_global = self.pool_question(q_feat, q_mask)
        b, f = frame_feat.shape[:2]
        noise_t = draw_noise(gumbel, TEMPORAL, (b, 2, f), q_global.device)
        ground_frame, pos_f, neg_f, pos_f_idx, _ = temporal_grounding(
            noise_t, q_global, frame_feat, frame_mask, frame_id, self.frame_topk, self.tau)
        new_ocr_mask = frames_to_ocr_mask(ground_frame, temporal_id)
        # boxes of every slot of the grounded frames, in ascending slot order
        # (masked_select); the -1 padding reads slot 0 and is zeroed
        slots = _first_k_true_indices(new_ocr_mask > 0, self.frame_topk * self.ocr_frame_num)
        ground_box = torch.gather(
            ocr_box, 1, slots.clamp_min(0)[..., None].expand(-1, -1, ocr_box.shape[2])
        ) * (slots >= 0)[..., None]
        return {
            "ground_frame": ground_frame,
            "ground_bbox": ground_box,
            "pos_obj_mask": pos_f * frame_mask,
            "neg_obj_mask": neg_f * frame_mask,
            "pos_ocr_mask": new_ocr_mask,
            "neg_ocr_mask": 1.0 - new_ocr_mask,
            # the compact gather lists (T2S._compact_decode): the frame
            # positions of the temporal top-k, and the slots above
            "pos_obj_idx": pos_f_idx,
            "pos_ocr_idx": slots,
        }


@registry.register_model("t2s_wo_tg")
class T2SWithoutTemporalGrounding(T2S):
    GROUNDING_CLS = GroundingWithoutTemporal


@registry.register_model("t2s_wo_sg")
class T2SWithoutSpatialGrounding(T2S):
    GROUNDING_CLS = GroundingWithoutSpatial
    # pos_ocr_idx may be -1-padded: the trash-slot scatter in the decode
    COMPACT_IDX_MAY_PAD = True
