"""MIST baseline: iterative segment-then-region gumbel selection (ISTA).

Counterpart of vitxtgqa_tpu/models/mist.py (reference:
pythia/models/mist.py + modules/mist_module/mist_module.py).  The question
pooled by self-attention drives two stacked ISTA rounds, each a gumbel
segment Selector over the frames, then a region Selector over the picked
frames' OCR slots; the last round's masks drive the shared MMT (single pos
variant) over [question | every frame | every OCR slot | pad | decoder
slots], 20 + 64 + 960 + 12 -> 1,152 rows at production width, as T2S's.
``decode_recompute`` swaps the cached decode for the recompute oracle.

Kept from the reference, as the JAX model keeps them:
  * a Selector draws gumbel noise over its *softmaxed* scores, with
    replacement, in eval too: a frame picked twice holds 2.0 in the frame
    mask.  The port's MMT, on every path, takes a mask entry > 0 as one
    allowed key (ops/masks.py, the kernels), as the JAX package's Pallas
    kernels do; the JAX XLA bias gives such a frame +10000 (ROADMAP.md §3);
  * ground_frame holds the 0-based selection indices, not frame ids
    (mist.py:612);
  * the OCR mask is padded at random to exactly MIST_OCR_MASK_ONES ones
    (fewer where the grid is smaller), by uniform tie-break noise
    (``_pad_noise``, a seam for tests).

A forward draws, in this order, per ISTA round: frame_topk gumbel draws of
[B, F] (the segment selector), frame_topk of [B * frame_topk, O] (the
region selector), one uniform [B, F * O] (the padding), from the
``gumbel`` generator or noise source (ops/gumbel.sample).  The
``VideoQAmodel`` children (the question pooling, the selectors) compute in
float32 under a bf16 compute dtype, as the JAX ones do: ``mask * 1e6 +
noise`` must keep the noise's order.  Their only path to the loss is the
MMT's key mask, which passes no gradient, so they receive none (neither
do the JAX package's kernels pass one, pallas_attention.py:598).

Dead weight of the reference that is not re-created: the CLIP tower, the
DistilBERT transformers and the ISTA projections (mist.py:452-456,
mist_module.py:587-604).  Parameter names are the reference's
(``VideoQAmodel.self_attn``, ``VideoQAmodel.ISTA.{i}.{seg,reg}_selector.*``),
which vitxtgqa_tpu's convert_mist reads.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.models.base import JointQAModel, Wrap, l2_normalize
from vitxtgqa_tpu_torch.models.common import LayerNorm, Linear, TextEncoder, TransformerConfig, \
    cfg_get
from vitxtgqa_tpu_torch.ops.gumbel import gumbel_softmax, sample, topk_mask
from vitxtgqa_tpu_torch.options import Options

MIST_OCR_MASK_ONES = 25  # the pad target (reference: mist_module.py:575)


def _pad_noise(gumbel, shape, device) -> torch.Tensor:
    """The uniform tie-break noise of the OCR mask's random padding
    (reference: mist_module.py:570-585 pads with torch.randperm slots)."""
    return sample(gumbel, shape, "uniform", device)


class Selector(nn.Module):
    """Gumbel-categorical top-k selection with replacement (reference:
    mist_module.py:389-467)."""

    def __init__(self, topk: int, q_dim: int, k_dim: int, dim: int):
        super().__init__()
        self.topk = topk
        self.linear_Q, self.norm_Q = Linear(q_dim, dim), LayerNorm(dim, eps=1e-12)
        self.linear_K, self.norm_K = Linear(k_dim, dim), LayerNorm(dim, eps=1e-12)

    def forward(self, q, keys, values, gumbel):
        """q [B, 1, Dq], keys [B, L, Dk], values [B, L, ...] -> (the picked
        values [B, topk, ...], their indices [B, topk], the picks' one-hots
        summed [B, L] float32, 2.0 where a key was picked twice)."""
        b, l = keys.shape[:2]
        qp = self.norm_Q(self.linear_Q(q[:, 0, :]))
        kp = self.norm_K(self.linear_K(keys))
        probs = torch.softmax(torch.einsum("bld,bd->bl", kp, qp), dim=-1)
        flat_v = values.reshape(b, l, -1).float()
        picks, idxs = [], []
        acc = torch.zeros((b, l), device=keys.device)
        for _ in range(self.topk):
            # the reference's quirk: gumbel over the softmax probabilities
            onehot = gumbel_softmax(probs, sample(gumbel, probs.shape, "gumbel", keys.device))
            idxs.append(onehot.argmax(dim=-1))
            picks.append(torch.einsum("bl,blf->bf", onehot, flat_v).to(values.dtype))
            acc = acc + onehot
        selected = torch.stack(picks, dim=1).reshape((b, self.topk) + tuple(values.shape[2:]))
        return selected, torch.stack(idxs, dim=1), acc


class ISTA(nn.Module):
    """One segment -> region selection round (reference:
    mist_module.py:470-604)."""

    def __init__(self, frame_topk: int, ocr_topk: int, frame_num: int, ocr_frame_num: int,
                 q_dim: int, d_model: int):
        super().__init__()
        self.frame_topk, self.frame_num, self.ocr_frame_num = frame_topk, frame_num, ocr_frame_num
        self.seg_selector = Selector(frame_topk, q_dim, d_model, d_model)
        self.reg_selector = Selector(ocr_topk, q_dim, d_model, d_model)

    def forward(self, q_global, seg_feat, video_o, gumbel):
        """-> (ground_frame_idx [B, frame_topk], the frame mask [B, F], the
        OCR mask [B, F * O] with exactly min(25, F * O) ones)."""
        b, k = q_global.shape[0], self.ocr_frame_num
        sel_frames, frame_idx, frame_mask = self.seg_selector(q_global, seg_feat, video_o, gumbel)
        flat = sel_frames.reshape(b * self.frame_topk, k, -1)
        _, ocr_idx, _ = self.reg_selector(q_global.repeat_interleave(self.frame_topk, dim=0),
                                          flat, flat, gumbel)
        global_idx = (ocr_idx.reshape(b, self.frame_topk, -1)
                      + frame_idx[:, :, None] * k).reshape(b, -1)
        mask = torch.zeros((b, self.frame_num * k), device=q_global.device)
        mask = mask.scatter_(1, global_idx, 1.0)
        noise = _pad_noise(gumbel, mask.shape, mask.device)
        return frame_idx, frame_mask, topk_mask(mask * 1e6 + noise,
                                                min(MIST_OCR_MASK_ONES, mask.shape[1]))


@registry.register_model("mist")
class MIST(JointQAModel):
    NUM_ISTA = 2

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
        self.frame_topk, self.ocr_topk = int(cfg_get(g, "frame_topk")), int(cfg_get(g, "ocr_topk"))
        with torch.device(opts.device):
            self.text_bert = TextEncoder(text_cfg, opts)
            self._add_frame_stream(c, hidden)
            self._add_ocr_stream(c, hidden)
            self.VideoQAmodel = Wrap(
                self_attn=Linear(text_cfg.hidden_size, 1),  # the question pooling
                ISTA=nn.ModuleList([
                    ISTA(self.frame_topk, self.ocr_topk, int(cfg_get(g, "frame_num")),
                         int(cfg_get(g, "ocr_frame_num")), text_cfg.hidden_size, hidden)
                    for _ in range(self.NUM_ISTA)]))
            self._add_decoder(c, mmt_cfg, num_final_outputs, opts)
        self._cast_to_compute_dtype()

    def _streams(self, batch, train: bool, gen, gumbel=None):
        """The question pooling and the ISTA rounds; the MMT's streams with
        the last round's frame mask and OCR mask (also the pointer's)."""
        txt, txt_mask = self._text_stream(batch, train, gen)
        obj, ocr = self._frame_stream(batch, gen), self._ocr_stream(batch, gen)
        b, f, d = obj.shape
        k = ocr.shape[1] // f

        # the pooled question (reference: mist.py:502-509)
        attn = torch.softmax(self.VideoQAmodel.self_attn(txt)[..., 0], dim=-1) * txt_mask
        attn = attn / (attn.sum(dim=-1, keepdim=True) + 1e-12)
        q_global = torch.einsum("bl,bld->bd", attn, txt.float()).to(txt.dtype)[:, None, :]
        seg_feat, video_o = l2_normalize(obj), ocr.reshape(b, f, k, d)
        # the rounds in turn; only the last one's outputs reach the decoder
        # (the reference's loop overwrites them, mist.py:595-597)
        for ista in self.VideoQAmodel.ISTA:
            frame_idx, frame_mask, ocr_mask = ista(q_global, seg_feat, video_o, gumbel)

        # the grounded boxes: the masked slots in ascending order
        n = f * k
        cols = torch.arange(n, device=obj.device)
        slots = torch.argsort(torch.where(ocr_mask > 0, cols, n + cols),
                              dim=-1)[:, :min(MIST_OCR_MASK_ONES, n)]
        box = batch["ocr_bbox_coordinates"].to(self.opts.dtype)
        ground_box = torch.gather(box, 1, slots[..., None].expand(-1, -1, box.shape[2]))
        valid = torch.gather(batch["ocr_mask"].float(), 1, slots)
        out = {"ground_frame": frame_idx, "ground_box": ground_box * valid[..., None],
               "frame_topk": self.frame_topk, "ocr_topk": self.ocr_topk}
        return txt, txt_mask, obj, frame_mask, ocr, ocr_mask, out
