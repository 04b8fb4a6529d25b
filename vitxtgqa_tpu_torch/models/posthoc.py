"""Post-hoc middle-frame attention: the grounding of the M4C baseline.

Counterpart of vitxtgqa_tpu/models/posthoc.py (reference:
pythia/models/m4c.py:334-422).  The grounded frame is the dataset's
middle frame (which the reference's sequential overwrites resolve to the
last sampled frame); the OCR grounding is a question-attention top-k
within that frame, with no gumbel noise.  The decoder sees the middle
frame's OCR slots only.

``middel_frame_idx - 1`` is the middle frame's grid position.  An index of
0 gives -1, which JAX's gathers wrap to the last frame; torch's gather
does not wrap (and on the card an out-of-range index is a device-side
assert), so the -1 is mapped to the last frame explicitly.
"""

from __future__ import annotations

import torch

from vitxtgqa_tpu_torch.models.grounding import QuestionPooling, attention_score
from vitxtgqa_tpu_torch.ops.gumbel import topk_indices_sorted


class PostHocAttention(QuestionPooling):
    def __init__(self, in_dim: int, hidden_size: int, frame_topk: int, ocr_topk: int,
                 frame_num: int, ocr_frame_num: int):
        super().__init__(in_dim, hidden_size)
        self.frame_topk = frame_topk
        self.ocr_topk = ocr_topk
        self.frame_num = frame_num
        self.ocr_frame_num = ocr_frame_num

    def forward(self, q_feat, q_mask, ocr_feat, ocr_mask, ocr_box, temporal_id,
                middel_frame_id, middel_frame_idx):
        """Returns ground_frame (the middle frame id [B, 1]), ground_bbox
        [B, ocr_topk, 4] (the middle frame's top-k boxes in ascending slot
        order, zero on invalid slots), obj_mask [B, 1] (ones) and ocr_mask
        [B, N] (the middle frame's valid slots)."""
        b, n, _ = ocr_feat.shape
        f, k = self.frame_num, self.ocr_frame_num
        # the OCR slots of the middle frame (reference: m4c.py:366-381)
        new_ocr_mask = (temporal_id[:, None, :] == middel_frame_id[:, :, None]).any(1).float()
        # question attention over every slot, top-k in each frame, the middle
        # frame's boxes (reference: m4c.py:384-405)
        q_global = self.pool_question(q_feat, q_mask)
        grid = attention_score(q_global, ocr_feat, ocr_mask).reshape(b, f, k)
        mf = middel_frame_idx[:, 0].long() - 1
        mf = torch.where(mf < 0, mf + f, mf)
        idx_grid = topk_indices_sorted(grid, self.ocr_topk, largest=True)  # [B, F, topk]
        mid_idx = torch.gather(idx_grid, 1, mf[:, None, None].expand(-1, 1, self.ocr_topk))[:, 0]
        flat = mf[:, None] * k + mid_idx
        ground_box = torch.gather(ocr_box, 1, flat[..., None].expand(-1, -1, ocr_box.shape[2]))
        ground_box = ground_box * torch.gather(ocr_mask, 1, flat)[..., None]
        return {
            "ground_frame": middel_frame_id,
            "ground_bbox": ground_box,
            "obj_mask": torch.ones((b, 1), device=ocr_feat.device),
            "ocr_mask": new_ocr_mask * ocr_mask,
        }
