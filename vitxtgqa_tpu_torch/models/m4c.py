"""M4C baseline: the multimodal transformer with the pointer decoder and
post-hoc grounding.

Counterpart of vitxtgqa_tpu/models/m4c.py (reference:
pythia/models/m4c.py:29-310).  Against T2S: the object stream is the one
l2-normalised middle-frame ViT feature, the OCR stream FastText + PHOC +
box (no temporal or track ids), there is no QTV and no contrastive
variant: one MMT pass, pos_scores only, whose decoder sees the middle
frame's OCR slots (models/posthoc.py).  At production width the joint
sequence is 20 question rows + 1 + 960 OCR rows, 1,024 with the 12 decoder
slots (T2S: 1,152).  ``decode_recompute`` swaps the cached decode for the
recompute oracle.  The input projections take config ``obj.mmt_in_dim`` /
``ocr.mmt_in_dim`` features (configs/m4c_abinet.yml: 1,024 and 904); the
JAX Dense layers infer theirs.

Parameter names are the reference's torch state-dict names (``PostHoc.*``
for the post-hoc head): utils/convert.from_jax_params maps the JAX
parameters onto them.
"""

from __future__ import annotations

from typing import Any

import torch

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.models.base import JointQAModel, l2_normalize
from vitxtgqa_tpu_torch.models.common import TextEncoder, TransformerConfig, cfg_get
from vitxtgqa_tpu_torch.models.posthoc import PostHocAttention
from vitxtgqa_tpu_torch.ops.dropout import dropout
from vitxtgqa_tpu_torch.options import Options


@registry.register_model("m4c")
class M4C(JointQAModel):
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
            self._add_frame_stream(c, hidden, frame_embed=False)
            self._add_ocr_stream(c, hidden, ocr_ids=False)
            self.PostHoc = PostHocAttention(
                in_dim=text_cfg.hidden_size,
                hidden_size=int(cfg_get(g, "hidden_size")),
                frame_topk=int(cfg_get(g, "frame_topk")),
                ocr_topk=int(cfg_get(g, "ocr_topk")),
                frame_num=int(cfg_get(g, "frame_num")),
                ocr_frame_num=int(cfg_get(g, "ocr_frame_num")),
            )
            self._add_decoder(c, mmt_cfg, num_final_outputs, opts)
        self._cast_to_compute_dtype()

    def _streams(self, batch, train: bool, gen):
        txt, txt_mask = self._text_stream(batch, train, gen)
        # the middle frame's feature (reference: m4c.py:185-210)
        mid = l2_normalize(batch["mid_img_feat"].to(self.opts.dtype))
        obj = dropout(self.obj_feat_layer_norm(self.linear_obj_feat_to_mmt_in(mid)),
                      self.obj_dropout, gen)
        ocr = self._ocr_stream(batch, gen, ids=None)
        ph = self.PostHoc(txt, txt_mask, ocr, batch["ocr_mask"].float(),
                          batch["ocr_bbox_coordinates"].to(self.opts.dtype), batch["temporal_id"],
                          batch["middel_frame_id"], batch["middel_frame_idx"])
        out = {"ground_frame": ph["ground_frame"], "ground_box": ph["ground_bbox"],
               "frame_topk": self.PostHoc.frame_topk, "ocr_topk": self.PostHoc.ocr_topk}
        return txt, txt_mask, obj, ph["obj_mask"], ocr, ph["ocr_mask"], out

