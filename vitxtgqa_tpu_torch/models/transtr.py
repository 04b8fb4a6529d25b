"""TranSTR baseline: a DETR-decoder hierarchy with a differentiable top-k.

Counterpart of vitxtgqa_tpu/models/transtr.py (reference:
pythia/models/transtr.py:349-530 + modules/transtr_module/).  The frame
and OCR selections run through cross-attention DETR decoders
(models/detr.py) whose head-averaged attention over the question feeds a
perturbed top-k (training: 500 noise samples, ops/diff_topk.py) or a hard
top-k (eval); the selected frames and OCR slots fuse in a frame-OCR
decoder, whose kf rows are the MMT's object stream.  The answering MMT has
no question rows (the question reaches it only through the selector):
[kf fused frames | OCR | pad | decoder slots], at production width 1 + 960
+ 51 pad + 12 = 1,024 rows, of which an encoder row sees the fused frame
and the kf * ko grounded OCR slots.  Single (pos) variant;
``decode_recompute`` swaps the cached decode for the recompute oracle.

The selector (``VideoQAmodel``, the reference's attribute name) computes
in float32 under a bf16 compute dtype, as the JAX one does (its Dense
layers carry no dtype): a hit is an indicator of exactly 1.0, a mean of
500 one-hots that bf16 would round from 499/500.  Its frame-OCR output
enters the MMT in the compute dtype (the port's kernels take bf16 rows;
JAX's XLA route widens the joint sequence to float32 there).

Deviation kept from the JAX model: the reference recovers the grounded
OCR indices with a nonzero and front padding that misaligns rows
(transtr.py:476-482); here each row takes its first top-k hits,
0-padded (``_first_k_true``).  A training indicator seldom reaches 1.0,
so the padded 0 grounds each grounded frame's first OCR slot.

Parameter names are the reference's torch state-dict names, which
vitxtgqa_tpu's convert_transtr reads; utils/convert.from_jax_family_params
is its inverse.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.models.base import JointQAModel
from vitxtgqa_tpu_torch.models.common import TextEncoder, TransformerConfig, cfg_get
from vitxtgqa_tpu_torch.models.detr import DetrDecoder, FeatureResizer
from vitxtgqa_tpu_torch.ops.diff_topk import (
    _top_indices,
    hard_topk_indicator,
    perturbed_topk,
    sine_position_embedding,
)
from vitxtgqa_tpu_torch.options import Options


def _first_k_true(mask: torch.Tensor, k: int) -> torch.Tensor:
    """The first k true indices of each row of ``mask`` [B, n], 0-padded."""
    n = mask.shape[1]
    cols = torch.arange(n, device=mask.device)
    order = torch.argsort(torch.where(mask, cols, n + cols), dim=-1)[:, :k]
    counts = mask.sum(dim=-1, keepdim=True)
    return torch.where(torch.arange(k, device=mask.device)[None, :] < counts, order,
                       torch.zeros_like(order))


class TranSTRSelector(nn.Module):
    """Hierarchical frame -> OCR selection (reference: transtr.py:349-530).
    Its dropout rates are the reference's hard-coded ones by default (0.1
    in the DETR layers, 0.2 in the resizer), which the config's
    ``grounding.dropout_prob`` / ``resize_dropout_prob`` override."""

    def __init__(self, hidden_size: int, frame_topk: int, ocr_topk: int, ocr_frame_num: int,
                 num_heads: int = 8, num_layers: int = 2, dropout_rate: float = 0.1,
                 resize_dropout: float = 0.2):
        super().__init__()
        d = hidden_size
        self.frame_topk, self.ocr_topk, self.ocr_frame_num = frame_topk, ocr_topk, ocr_frame_num
        self.ocr_resize = FeatureResizer(d, d, resize_dropout)
        self.frame_decoder = DetrDecoder(d, num_heads, num_layers, dropout_rate=dropout_rate)
        self.ocr_decoder = DetrDecoder(d, num_heads, num_layers, dropout_rate=dropout_rate)
        self.fo_decoder = DetrDecoder(d, num_heads, num_layers, dropout_rate=dropout_rate)

    def _indicator(self, att, k: int, train: bool, gumbel):
        """[N, Lk, Lq] head-averaged weights -> [N, Lk, k] indicator, summed
        over the question keys."""
        n, lk = att.shape[:2]
        flat = att.reshape(n, -1)
        ind = perturbed_topk(flat, gumbel, k) if train else hard_topk_indicator(flat, k)
        return ind.reshape(n, lk, -1, k).sum(dim=2)

    def forward(self, q_feat, q_mask, frame_feat, ocr_feat, ocr_mask, ocr_box, train: bool,
                gumbel=None, gen=None):
        """Returns obj [B, kf, D] float32, obj_mask, ocr_mask [B, F * O]
        (the grounded slots), ground_frame [B, kf] (frame grid index + 1)
        and ground_bbox [B, kf * ko, 4]."""
        b, f, d = frame_feat.shape
        o, kf, ko = self.ocr_frame_num, self.frame_topk, self.ocr_topk
        dt, dev = frame_feat.dtype, frame_feat.device

        # the frame decoder over the question (reference: transtr.py:424-430)
        qpos = sine_position_embedding(torch.ones((b, f), device=dev), d).to(dt)
        frame_local, frame_att = self.frame_decoder(frame_feat, q_feat, q_mask, qpos, gen)
        idx_frame = self._indicator(frame_att, kf, train, gumbel)  # [B, F, kf]
        # the grounded frames: grid indices + 1 (reference: transtr.py:434-440)
        ground_frame = _top_indices(idx_frame.max(dim=2).values, kf) + 1
        frame_local = torch.einsum("bfd,bfk->bkd", frame_local, idx_frame).to(dt)

        # the soft frame-selected OCR grid through the per-frame OCR decoder
        grid = ocr_feat.reshape(b, f, o, d).float()
        sel = torch.einsum("bfod,bfk->bkod", grid, idx_frame).to(ocr_feat.dtype)
        sel = self.ocr_resize(sel, gen).reshape(b * kf, o, d)
        ocr_local, ocr_att = self.ocr_decoder(sel, q_feat.repeat_interleave(kf, dim=0),
                                              q_mask.repeat_interleave(kf, dim=0), None, gen)
        idx_ocr = self._indicator(ocr_att, ko, train, gumbel)  # [B*kf, O, ko]
        ocr_sel = torch.einsum("bod,bok->bkd", ocr_local, idx_ocr).to(ocr_feat.dtype)

        # the grounded OCR slots: the exact 1.0 indicators, the first ko of
        # each selected frame
        hits = idx_ocr.max(dim=-1).values == 1.0
        ground_ocr = _first_k_true(hits, ko).reshape(b, kf, ko)
        flat = ((ground_frame[:, :, None] - 1) * o + ground_ocr).reshape(b, -1)
        mask = torch.zeros((b, f * o), device=dev).scatter_(1, flat, 1.0) * ocr_mask
        slots = _first_k_true(mask > 0, kf * ko)
        valid = torch.arange(kf * ko, device=dev)[None, :] < (mask > 0).sum(-1, keepdim=True)
        ground_box = torch.gather(ocr_box, 1, slots[..., None].expand(-1, -1, ocr_box.shape[2]))

        # the hierarchy fusion (reference: transtr.py:508-519)
        frame_ocr, _ = self.fo_decoder(frame_local, ocr_sel.reshape(b, kf * ko, d), None, None,
                                       gen)
        return {"obj": frame_ocr, "obj_mask": torch.ones((b, kf), device=dev), "ocr_mask": mask,
                "ground_frame": ground_frame, "ground_bbox": ground_box * valid[..., None]}


@registry.register_model("transtr")
class TranSTR(JointQAModel):
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
            self.VideoQAmodel = TranSTRSelector(
                hidden_size=int(cfg_get(g, "hidden_size")),
                frame_topk=int(cfg_get(g, "frame_topk")),
                ocr_topk=int(cfg_get(g, "ocr_topk")),
                ocr_frame_num=int(cfg_get(g, "ocr_frame_num")),
                dropout_rate=float(cfg_get(g, "dropout_prob", 0.1)),
                resize_dropout=float(cfg_get(g, "resize_dropout_prob", 0.2)),
            )
            self._add_decoder(c, mmt_cfg, num_final_outputs, opts)
        self._cast_to_compute_dtype()

    def _streams(self, batch, train: bool, gen, gumbel=None):
        """The selector over the question and both streams; the MMT's
        streams: no question rows, the fused frames, every OCR slot (the
        grounded ones allowed).  ``gumbel``: the perturbed top-k's noise
        source (training only; the eval top-k draws none)."""
        dt = self.opts.dtype
        txt, txt_mask = self._text_stream(batch, train, gen)
        obj, ocr = self._frame_stream(batch, gen), self._ocr_stream(batch, gen)
        sel = self.VideoQAmodel(txt, txt_mask, obj, ocr, batch["ocr_mask"].float(),
                                batch["ocr_bbox_coordinates"].to(dt), train, gumbel, gen)
        out = {"ground_frame": sel["ground_frame"], "ground_box": sel["ground_bbox"],
               "frame_topk": self.VideoQAmodel.frame_topk,
               "ocr_topk": self.VideoQAmodel.ocr_topk}
        return (txt[:, :0], txt_mask[:, :0], sel["obj"].to(dt), sel["obj_mask"], ocr,
                sel["ocr_mask"], out)
