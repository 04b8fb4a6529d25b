"""T5-ViteVQA baseline: the full-video encoding with global post-hoc OCR
attention.

Counterpart of vitxtgqa_tpu/models/t5vitevqa.py (reference:
pythia/models/t5vitevqa.py).  T2S's modality streams (every frame with its
frame-id embedding; the OCR slots with their temporal and track ids) with
no QTV and no predicted mask: the decoder sees the unrestricted masks, one
MMT pass over the 1,152-row joint sequence at production width.  The
grounding is a question-attention top-(frame_topk * ocr_topk) over all OCR
slots in ascending slot order (``GlobalPostHoc``), and ground_frame is the
whole sampled frame-id list.  ``decode_recompute`` swaps the cached decode
for the recompute oracle.
"""

from __future__ import annotations

from typing import Any

import torch

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.models.base import JointQAModel
from vitxtgqa_tpu_torch.models.common import TextEncoder, TransformerConfig, cfg_get
from vitxtgqa_tpu_torch.models.grounding import QuestionPooling, attention_score
from vitxtgqa_tpu_torch.ops.gumbel import topk_indices_sorted
from vitxtgqa_tpu_torch.options import Options


class GlobalPostHoc(QuestionPooling):
    """Global question-attention top-k over every OCR slot (reference:
    t5vitevqa.py:346-422)."""

    def __init__(self, in_dim: int, hidden_size: int, frame_topk: int, ocr_topk: int):
        super().__init__(in_dim, hidden_size)
        self.frame_topk = frame_topk
        self.ocr_topk = ocr_topk

    def forward(self, q_feat, q_mask, ocr_feat, ocr_mask, ocr_box):
        """-> ground_box [B, frame_topk * ocr_topk, 4], zero on invalid slots."""
        score = attention_score(self.pool_question(q_feat, q_mask), ocr_feat, ocr_mask)
        idx = topk_indices_sorted(score, self.frame_topk * self.ocr_topk, largest=True)
        ground_box = torch.gather(ocr_box, 1, idx[..., None].expand(-1, -1, ocr_box.shape[2]))
        return ground_box * torch.gather(ocr_mask, 1, idx)[..., None]


@registry.register_model("t5vitevqa")
class T5ViteVQA(JointQAModel):
    def __init__(self, config: Any, num_final_outputs: int, bos_idx: int = 2,
                 opts: Options = Options(), decode_recompute: bool = False):
        super().__init__()
        self.opts = opts
        self.decode_recompute = bool(decode_recompute)
        self.bos_idx = int(bos_idx)
        c = config
        mmt_cfg = TransformerConfig.from_config(cfg_get(c, "mmt"))
        text_cfg = TransformerConfig.from_config(cfg_get(c, "text_bert"))
        hidden = mmt_cfg.hidden_size
        g = cfg_get(c, "grounding")
        with torch.device(opts.device):
            self.text_bert = TextEncoder(text_cfg, opts)
            self._add_frame_stream(c, hidden)
            self._add_ocr_stream(c, hidden)
            self.PostHoc = GlobalPostHoc(in_dim=text_cfg.hidden_size,
                                         hidden_size=int(cfg_get(g, "hidden_size")),
                                         frame_topk=int(cfg_get(g, "frame_topk")),
                                         ocr_topk=int(cfg_get(g, "ocr_topk")))
            self._add_decoder(c, mmt_cfg, num_final_outputs, opts)
        self._cast_to_compute_dtype()

    def _streams(self, batch, train: bool, gen, gumbel=None):
        txt, txt_mask = self._text_stream(batch, train, gen)
        obj, ocr = self._frame_stream(batch, gen), self._ocr_stream(batch, gen)
        ocr_mask = batch["ocr_mask"].float()
        ground_box = self.PostHoc(txt, txt_mask, ocr, ocr_mask,
                                  batch["ocr_bbox_coordinates"].to(self.opts.dtype))
        out = {"ground_frame": batch["frame_id"], "ground_box": ground_box,
               "frame_topk": self.PostHoc.frame_topk, "ocr_topk": self.PostHoc.ocr_topk}
        return txt, txt_mask, obj, batch["frame_mask"].float(), ocr, ocr_mask, out
