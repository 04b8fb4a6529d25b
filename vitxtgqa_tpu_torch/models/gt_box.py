"""GT-box oracle: the answer head with ground-truth grounding injected.

Counterpart of vitxtgqa_tpu/models/gt_box.py (reference:
pythia/models/gt_box.py and datasets/videoqa/gt_box_clipocr/).  T2S's frame
stream; the OCR stream built from the annotation grid of
data/gt_box_dataset.py (context features over the annotated OCR tokens,
their temporal and track ids, the annotated boxes); no QTV (commented out
in the reference, gt_box.py:298-299) and no predicted grounding: the
annotated frames' and OCR slots' masks go into the decoder, and the
outputs carry the annotations (ground_box: the eval-aligned
``eval_box_list`` where the batch has it).  One pass, pos_scores only, over
the 1,152-row joint sequence at production width.

Registered as ``gt_box`` and as ``T2S_human``, the model block's key in
the reference's configs/gt_box_clipocr.yml.
"""

from __future__ import annotations

from typing import Any

import torch

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.models.base import JointQAModel
from vitxtgqa_tpu_torch.models.common import TextEncoder, TransformerConfig, cfg_get
from vitxtgqa_tpu_torch.options import Options


@registry.register_model("gt_box")
@registry.register_model("T2S_human")
class GTBox(JointQAModel):
    # the grounding sizes of its outputs: every frame, every slot of one
    FRAME_TOPK, OCR_TOPK = 64, 15

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
        with torch.device(opts.device):
            self.text_bert = TextEncoder(text_cfg, opts)
            self._add_frame_stream(c, hidden)
            self._add_ocr_stream(c, hidden)
            self._add_decoder(c, mmt_cfg, num_final_outputs, opts)
        self._cast_to_compute_dtype()

    def _streams(self, batch, train: bool, gen):
        txt, txt_mask = self._text_stream(batch, train, gen)
        obj = self._frame_stream(batch, gen)
        # the OCR stream over the annotation grid (reference: gt_box.py:255-292)
        ocr = self._ocr_stream(batch, gen, ids=("ocr_temporal_id", "ocr_track_id"),
                               box="ocr_bbox_list")
        out = {"ground_frame": batch["frame_list"],
               "ground_box": batch.get("eval_box_list", batch["ocr_bbox_list"]),
               "frame_topk": self.FRAME_TOPK, "ocr_topk": self.OCR_TOPK}
        # the annotations as the decoder's masks (reference: gt_box.py:475-487)
        return (txt, txt_mask, obj, batch["frame_mask_embedding"].float(), ocr,
                batch["ocr_mask_embedding"].float(), out)
