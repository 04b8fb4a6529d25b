"""T2S-QA (temporal-to-spatial grounding TextVideoQA): serving, full-eval
and the training forward.

Counterpart of vitxtgqa_tpu/models/t2s.py:
  - serving (``inference_only``): modality projections, text BERT, the QTV
    joint transformer with its tanh residual (whose buffer the decode
    reuses), grounding, then the MMT prefix encode and a KV-cached greedy
    decode of the pos variant;
  - full-eval (``inference_only=False``, ``train=False``): the same pos
    decode, then one teacher-forced ``_mmt_full`` at 2B over [ref; neg] on
    the decoded tokens shifted behind BOS;
  - training (``train=True``, ``train_variant_scan``): the dropouts of the
    config, QTV over the 1152-row joint sequence, grounding with its
    straight-through gumbel split, and three teacher-forced ``_mmt_full``
    passes (ref, pos, neg) at batch B, a Python loop where JAX scans.
Options.compact_serving (configs/t2s_serving.yml) runs the serving decode,
and full-eval's pos decode and neg pass, on the rows the grounding keeps
(``_compact_decode``); the ref pass stays full.  Options.compact_train does
the same for the training forward's pos and neg passes
(``_compact_train_scores``).  ``decode_recompute``
swaps the cached decode for the reference's loop (``_recompute_decode``: the
full MMT at every step), the parity oracle: serving decodes the pos variant
with it, full-eval the three variants stacked at 3B with the pos argmax
feeding all three, and neither reuses the QTV buffer nor compacts.
``GROUNDING_CLS`` is the hook of the ablations (models/t2s_ablations.py);
the compact paths run only where the grounding returns the gather lists
they need (``_compact_ok``).

What runs where on CUDA (every serving configuration of the JAX package):
  - QTV and the MMT encode: the flash kernel where the keys reach 256 (the
    full 1152-row sequence, and the compact 384); the fused block where the
    rows reach 2048 (full: batch >= 2; compact MMT: batch >= 6), or under
    Options.w8a8 the W8A8 block there (its tanh residual added after it);
  - int8 cache, batch <= Options.fused_decode_max_batch (default 2), not
    W8A8: per step the single-kernel decode step and the fused epilogue,
    or under compact serving the step kernel and the epilogue in PyTorch;
  - int8 cache above the cap, under W8A8, or Options(fused_decode=False):
    per-layer decode through the int8 decode-attention kernel;
  - bf16 cache (kv_cache_int8=False), any batch: per-layer decode through
    the bf16 decode-attention kernel.
  - full-eval's teacher-forced pass: flash with its dec_len = 12 causal tail
    and the fused block (2B x 1152 rows; compact: B x 1152 and B x 384);
  - training: per flash-route layer (QTV, MMT) the flash forward and
    backward kernels with in-kernel dropout, per layer (text BERT included)
    the block_train forward and backward kernels.
On CPU tensors every kernel op runs its plain version and the decode takes
the per-layer path, as JAX does off the TPU; Options(plain=True) runs the
plain versions on the card along the same branches.

Parameter names are the reference's torch state-dict names (text_bert.*,
TransLayer.encoder.layer.i.*, mmt.encoder.*, mmt.prev_pred_embeddings.*,
Grounding_Module.*, ocr_ptr_net.*, classifier.module.*), so
utils/convert.from_jax_params and vitxtgqa_tpu's convert_t2s_like are
inverses and released reference checkpoints load as they are.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.models.base import JointQAModel, Wrap
from vitxtgqa_tpu_torch.models.common import (
    TextEncoder,
    TransformerConfig,
    TransformerEncoder,
    cfg_get,
)
from vitxtgqa_tpu_torch.models.grounding import GroundingModule
from vitxtgqa_tpu_torch.ops.masks import MaskSpec
from vitxtgqa_tpu_torch.options import Options

# 5050 fixed-vocabulary answers + 960 OCR copy slots (bench.py)
PRODUCTION_NUM_FINAL_OUTPUTS = 5050 + 960


def t2s_production_config() -> Dict[str, Any]:
    """model_attributes.t2s of configs/t2s_abinet.yml, as Python (the card's
    machine may lack PyYAML).  Sections the YAML leaves to BERT defaults
    (text_bert widths, heads, FFN) take TransformerConfig's defaults."""
    return {
        "text_bert": {"num_hidden_layers": 3},
        "obj": {"mmt_in_dim": 1074, "dropout_prob": 0.1},
        "ocr": {"mmt_in_dim": 1004, "dropout_prob": 0.1},
        "translayers": {"hidden_size": 768, "num_hidden_layers": 2},
        "grounding": {
            "frame_topk": 5, "ocr_topk": 5, "max_ocr_num": 960,
            "frame_num": 64, "ocr_frame_num": 15, "hidden_size": 768,
        },
        "encoder": {"hidden_size": 768, "num_hidden_layers": 2},
        "mmt": {"hidden_size": 768, "num_hidden_layers": 3},
        "classifier": {
            "type": "linear", "ocr_max_num": 960,
            "ocr_ptr_net": {"hidden_size": 768, "query_key_size": 768},
            "params": {},
        },
        "lr_scale_text_bert": 0.1,
        "lr_scale_mmt": 1.0,
        "text_bert_init_from_bert_base": True,
        "losses": [{"type": "pos_bce_loss", "weight": 1.0}, {"type": "InfoNCE", "weight": 1000}],
    }


# bert-large-uncased's published widths (its config.json): hidden 1,024, 16
# heads of 64, FFN 4,096, LayerNorm eps 1e-12
BERT_LARGE = {"hidden_size": 1024, "num_attention_heads": 16, "intermediate_size": 4096,
              "layer_norm_eps": 1e-12}


def t2s_bert_large_config() -> Dict[str, Any]:
    """t2s_production_config with every transformer stack at
    bert-large-uncased's widths (BERT_LARGE): the same T2S, depths (3 / 2 /
    3 text-BERT / QTV / MMT) and sequence (20 + 64 + 960, joint 1,152),
    with the grounding's and the pointer net's widths at the stacks'
    1,024."""
    return _with_widths(BERT_LARGE)


# microsoft/MiniLM-L12-H384-uncased's published widths (its config.json,
# which sentence-transformers/all-MiniLM-L6-v2 shares): hidden 384, 12 heads
# of 32, FFN 1,536, LayerNorm eps 1e-12
MINILM_L12_H384 = {"hidden_size": 384, "num_attention_heads": 12, "intermediate_size": 1536,
                   "layer_norm_eps": 1e-12}


def _with_widths(widths: Dict[str, Any]) -> Dict[str, Any]:
    """t2s_production_config with every transformer stack at ``widths`` and
    the grounding's and the pointer net's widths at its hidden width."""
    cfg = t2s_production_config()
    for stack in ("text_bert", "translayers", "encoder", "mmt"):
        cfg[stack] = {**cfg[stack], **widths}
    d = widths["hidden_size"]
    cfg["grounding"] = {**cfg["grounding"], "hidden_size": d}
    cfg["classifier"] = {**cfg["classifier"],
                         "ocr_ptr_net": {"hidden_size": d, "query_key_size": d}}
    return cfg


def t2s_minilm_config() -> Dict[str, Any]:
    """t2s_production_config with every transformer stack at
    MiniLM-L12-H384's widths (MINILM_L12_H384: 12 heads of 32): the same
    T2S, depths (3 / 2 / 3) and sequence (20 + 64 + 960, joint 1,152),
    the grounding's and the pointer net's widths at 384."""
    return _with_widths(MINILM_L12_H384)


@registry.register_model("t2s")
class T2S(JointQAModel):
    # the grounding mechanism; the ablations swap it (models/t2s_ablations.py)
    GROUNDING_CLS = GroundingModule
    # whether the grounding's compact gather lists can be -1-padded (only the
    # wo_sg ablation's can); selects the trash-slot scatter
    COMPACT_IDX_MAY_PAD = False

    def __init__(self, config: Any, num_final_outputs: int, bos_idx: int = 2,
                 opts: Options = Options(), inference_only: bool = True,
                 decode_recompute: bool = False):
        super().__init__()
        self.opts = opts
        self.decode_recompute = bool(decode_recompute)
        self.inference_only = inference_only
        self.bos_idx = int(bos_idx)
        c = config
        mmt_cfg = TransformerConfig.from_config(cfg_get(c, "mmt"))
        text_cfg = TransformerConfig.from_config(cfg_get(c, "text_bert"))
        trans_cfg = TransformerConfig.from_config(cfg_get(c, "translayers"))
        hidden = mmt_cfg.hidden_size
        g = cfg_get(c, "grounding")

        with torch.device(opts.device):
            self.text_bert = TextEncoder(text_cfg, opts)
            # obj (frame) stream: ViT feature + frame-id embedding -> hidden
            self._add_frame_stream(c, hidden)
            # ocr stream: fasttext + phoc + temporal-id + track-id, and bbox
            self._add_ocr_stream(c, hidden)
            # QTV cross-modal pre-fusion
            self.TransLayer = Wrap(encoder=TransformerEncoder(trans_cfg, opts))
            self.Grounding_Module = self.GROUNDING_CLS(
                in_dim=trans_cfg.hidden_size,
                hidden_size=int(cfg_get(g, "hidden_size")),
                frame_topk=int(cfg_get(g, "frame_topk")),
                ocr_topk=int(cfg_get(g, "ocr_topk")),
                frame_num=int(cfg_get(g, "frame_num")),
                ocr_frame_num=int(cfg_get(g, "ocr_frame_num")),
            )
            self._add_decoder(c, mmt_cfg, num_final_outputs, opts)
        self._cast_to_compute_dtype()

    # ---- modality encodings ------------------------------------------------
    def _encode_modalities(self, batch, train: bool = False, gen=None):
        txt_emb, txt_mask = self._text_stream(batch, train, gen)
        obj_in, ocr_in = self._frame_stream(batch, gen), self._ocr_stream(batch, gen)
        return (txt_emb, txt_mask, obj_in, batch["frame_mask"].float(), ocr_in,
                batch["ocr_mask"].float())

    def _apply_qtv(self, txt_emb, txt_mask, obj_in, obj_mask, ocr_in, ocr_mask,
                   dec_len: int, train: bool = False, gen=None):
        """Joint self-attention with the tanh residual back to each stream.
        Returns (txt, obj, ocr, joint): the updated streams and the buffer
        [B, round_up(l0 + dec_len, 128), D] they are slices of — the
        decode's unified-cache geometry, so the decode takes it as is."""
        l0 = txt_emb.shape[1] + obj_in.shape[1] + ocr_in.shape[1]
        pad = (-(l0 + dec_len)) % self.LANE + dec_len
        mask = F.pad(torch.cat([txt_mask, obj_mask, ocr_mask], dim=1), (0, pad))
        x = torch.cat(
            [txt_emb, obj_in, ocr_in, txt_emb.new_zeros((txt_emb.shape[0], pad, txt_emb.shape[2]))],
            dim=1,
        )
        joint = self.TransLayer.encoder(x, MaskSpec(key_mask=mask), tanh_residual_base=x,
                                        train=train, gen=gen)
        lt, lo = txt_emb.shape[1], obj_in.shape[1]
        return joint[:, :lt], joint[:, lt: lt + lo], joint[:, lt + lo: l0], joint

    @staticmethod
    def _take_rows(x, idx):
        """x [B, L, D] rows at idx [B, K] -> [B, K, D]."""
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    def _compact_decode(self, txt_emb, txt_mask, obj_in, ocr_in, g, dec_len: int):
        """Grounding-compacted serving decode (JAX t2s.py:_compact_decode):
        the MMT prefill and decode run on [txt | top-k frames | top-k OCR
        slots per frame] (345 rows, 384 with the decoder slots, at
        production width) instead of the full masked sequence.  The kept
        rows attend to the same keys either way, so their outputs are the
        full path's; copy scores of never-kept OCR slots are -1e4."""
        oi, ci = g["pos_obj_idx"].long(), g["pos_ocr_idx"].long()
        oi_s, ci_s = oi.clamp_min(0), ci.clamp_min(0)
        obj_mask_c = torch.gather(g["pos_obj_mask"], 1, oi_s) * (oi >= 0)
        ocr_mask_c = torch.gather(g["pos_ocr_mask"], 1, ci_s) * (ci >= 0)
        enc_mask_c = torch.cat([txt_mask, obj_mask_c, ocr_mask_c], dim=1)
        return self._greedy_decode(
            txt_emb, self._take_rows(obj_in, oi_s), self._take_rows(ocr_in, ci_s), enc_mask_c,
            ocr_mask_c, dec_len, embed_ocr=ocr_in,
            dynamic_scatter=(ci, ocr_in.shape[1], self.COMPACT_IDX_MAY_PAD))

    # ---- forward (JointQAModel.forward) ---------------------------------------
    # ``gumbel`` is a torch.Generator for the grounding's draws, or the two
    # noise tensors ([B, 2, F], [B, 2, N]).  Returns pos_scores [B, S, V + N]
    # float32 (and with train=True or inference_only=False also ref_scores
    # and neg_scores), ground_frame [B, topk], ground_box [B, F * ocr_topk,
    # 4] and the two top-k sizes.
    def _grounding(self, batch, txt_emb, txt_mask, obj_in, obj_mask, ocr_in, ocr_mask, gumbel):
        g = self.Grounding_Module(
            txt_emb, txt_mask, obj_in, obj_mask, batch["frame_id"], ocr_in, ocr_mask,
            batch["ocr_bbox_coordinates"].to(self.opts.dtype), batch["temporal_id"], gumbel,
        )
        common = {
            "ground_frame": g["ground_frame"],
            "ground_box": g["ground_bbox"],
            "frame_topk": self.Grounding_Module.frame_topk,
            "ocr_topk": self.Grounding_Module.ocr_topk,
        }
        return g, common

    def _forward_train(self, batch, gumbel, gen):
        """The training forward of the production step (JAX t2s.py:357-390,
        train_variant_scan): ref, pos and neg teacher-forced passes at
        batch B, each with its own dropout draws; under
        Options.compact_train, where the grounding gives both gather lists,
        pos and neg on the rows it keeps (_compact_train_scores)."""
        txt_emb, txt_mask, obj_in, obj_mask, ocr_in, ocr_mask = self._encode_modalities(
            batch, train=True, gen=gen)
        txt_emb, obj_in, ocr_in, _ = self._apply_qtv(
            txt_emb, txt_mask, obj_in, obj_mask, ocr_in, ocr_mask, 0, train=True, gen=gen)
        g, common = self._grounding(batch, txt_emb, txt_mask, obj_in, obj_mask, ocr_in,
                                    ocr_mask, gumbel)
        prev = batch["train_prev_inds"]
        if self.opts.compact_train and "pos_ocr_idx" in g and "neg_ocr_idx" in g:
            return {**self._compact_train_scores(txt_emb, txt_mask, obj_in, obj_mask, ocr_in,
                                                 ocr_mask, g, prev, gen), **common}
        scores = {}
        for name, obj_m, ocr_m in (("ref", obj_mask, ocr_mask),
                                   ("pos", g["pos_obj_mask"], g["pos_ocr_mask"]),
                                   ("neg", g["neg_obj_mask"], g["neg_ocr_mask"])):
            enc_mask = torch.cat([txt_mask, obj_m, ocr_m], dim=1)
            scores[f"{name}_scores"] = self._mmt_full(txt_emb, obj_in, ocr_in, enc_mask, ocr_m,
                                                      prev, train=True, gen=gen)
        return {**scores, **common}

    def _compact_train_scores(self, txt_emb, txt_mask, obj_in, obj_mask, ocr_in, ocr_mask, g,
                              prev, gen):
        """Compact training (JAX t2s.py:303-355, set_compact_train): the ref
        pass over the full sequence, then the pos and neg passes on the rows
        their grounding keeps ([question | kept frames | kept OCR slots],
        384 rows with the decoder slots at production width), each on its
        gather lists.  The kept rows attend to the same keys either way, so
        their scores are the full pass's; the copy scores of the slots a
        pass never keeps take the ref pass's (``ref_fill``), detached under
        compact_train True and with their gradient under "live".  The mask
        values are gathered from the gumbel hard masks, so the
        straight-through gradient reaches the grounding through the
        attention bias and the pointer's raw-mask add, as in the full
        pass's kept entries."""
        enc_mask = torch.cat([txt_mask, obj_mask, ocr_mask], dim=1)
        ref = self._mmt_full(txt_emb, obj_in, ocr_in, enc_mask, ocr_mask, prev, train=True,
                             gen=gen)
        n_ocr = ocr_in.shape[1]
        ref_fill = ref[..., -n_ocr:]
        if self.opts.compact_train != "live":
            ref_fill = ref_fill.detach()
        scores = {"ref_scores": ref}
        for pfx in ("pos", "neg"):
            oi, ci = g[f"{pfx}_obj_idx"].long(), g[f"{pfx}_ocr_idx"].long()
            obj_m = torch.gather(g[f"{pfx}_obj_mask"], 1, oi)
            ocr_m = torch.gather(g[f"{pfx}_ocr_mask"], 1, ci)
            scores[f"{pfx}_scores"] = self._mmt_full(
                txt_emb, self._take_rows(obj_in, oi), self._take_rows(ocr_in, ci),
                torch.cat([txt_mask, obj_m, ocr_m], dim=1), ocr_m, prev, train=True, gen=gen,
                embed_ocr=ocr_in, dynamic_scatter=(ci, n_ocr, False, ref_fill))
        return scores

    def _forward_eval(self, batch, gumbel):
        txt_emb, txt_mask, obj_in, obj_mask, ocr_in, ocr_mask = self._encode_modalities(batch)
        dec_len = batch["train_prev_inds"].shape[1]
        # the cached decodes reuse the QTV buffer in the cache's geometry;
        # the recompute oracle builds its own sequences (JAX t2s.py:252)
        txt_emb, obj_in, ocr_in, joint = self._apply_qtv(
            txt_emb, txt_mask, obj_in, obj_mask, ocr_in, ocr_mask,
            0 if self.decode_recompute else dec_len
        )
        g, common = self._grounding(batch, txt_emb, txt_mask, obj_in, obj_mask, ocr_in,
                                    ocr_mask, gumbel)
        if self.decode_recompute:
            return {**self._recompute_variants(txt_emb, txt_mask, obj_in, obj_mask, ocr_in,
                                               ocr_mask, g, dec_len), **common}
        compact = self._compact_ok(g, full_eval=not self.inference_only)
        if compact:
            pos = self._compact_decode(txt_emb, txt_mask, obj_in, ocr_in, g, dec_len)
        else:
            enc_mask = torch.cat([txt_mask, g["pos_obj_mask"], g["pos_ocr_mask"]], dim=1)
            pos = self._greedy_decode(txt_emb, obj_in, ocr_in, enc_mask, g["pos_ocr_mask"],
                                      dec_len, joint=joint)
        if self.inference_only:
            return {"pos_scores": pos, **common}
        # full-eval (JAX t2s.py:392-478): ref and neg teacher-forced on the
        # pos decode's tokens behind BOS
        b = pos.shape[0]
        chosen = pos.argmax(dim=-1)
        prev = torch.cat([torch.full((b, 1), self.bos_idx, dtype=chosen.dtype,
                                     device=chosen.device), chosen[:, :-1]], dim=1)
        if compact:
            # ref over the full sequence at batch B; neg on its kept rows,
            # its copy scores scattered back to the full width
            ref = self._mmt_full(txt_emb, obj_in, ocr_in,
                                 torch.cat([txt_mask, obj_mask, ocr_mask], dim=1), ocr_mask, prev)
            oi, ci = g["neg_obj_idx"].long(), g["neg_ocr_idx"].long()
            ocr_mask_n = torch.gather(g["neg_ocr_mask"], 1, ci)
            enc_mask_n = torch.cat([txt_mask, torch.gather(g["neg_obj_mask"], 1, oi),
                                    ocr_mask_n], dim=1)
            neg = self._mmt_full(txt_emb, self._take_rows(obj_in, oi), self._take_rows(ocr_in, ci),
                                 enc_mask_n, ocr_mask_n, prev, embed_ocr=ocr_in,
                                 dynamic_scatter=(ci, ocr_in.shape[1], False))
            return {"ref_scores": ref, "pos_scores": pos, "neg_scores": neg, **common}
        tile2 = lambda t: torch.cat([t, t], dim=0)
        ocr_masks2 = torch.cat([ocr_mask, g["neg_ocr_mask"]], dim=0)
        enc_mask2 = torch.cat([tile2(txt_mask), torch.cat([obj_mask, g["neg_obj_mask"]], dim=0),
                               ocr_masks2], dim=1)
        scores2 = self._mmt_full(tile2(txt_emb), tile2(obj_in), tile2(ocr_in), enc_mask2,
                                 ocr_masks2, tile2(prev))
        return {"ref_scores": scores2[:b], "pos_scores": pos, "neg_scores": scores2[b:],
                **common}

    def _compact_ok(self, g, full_eval: bool) -> bool:
        """Whether the decode runs on the grounding-kept rows (JAX
        t2s.py:275-279 and 410-415): compact serving on, the cached decode,
        and the grounding's gather lists, pos and in full-eval neg too.  The
        wo_tg ablation returns no list (the full decode), wo_sg no neg list
        (a full full-eval)."""
        return (self.opts.compact_serving and not self.decode_recompute and "pos_ocr_idx" in g
                and (not full_eval or "neg_ocr_idx" in g))

    def _recompute_variants(self, txt_emb, txt_mask, obj_in, obj_mask, ocr_in, ocr_mask, g,
                            dec_len: int):
        """The recompute oracle's scores (JAX t2s.py:292-296, 480-503):
        serving decodes the pos variant alone; full-eval the [ref; pos;
        neg] variants stacked at 3B, the pos argmax feeding all three (the
        reference's loop, t2s.py:315-354)."""
        if self.inference_only:
            enc_mask = torch.cat([txt_mask, g["pos_obj_mask"], g["pos_ocr_mask"]], dim=1)
            return {"pos_scores": self._recompute_decode(txt_emb, obj_in, ocr_in, enc_mask,
                                                         g["pos_ocr_mask"], dec_len)}
        tile3 = lambda t: torch.cat([t, t, t], dim=0)
        ocr_masks = torch.cat([ocr_mask, g["pos_ocr_mask"], g["neg_ocr_mask"]], dim=0)
        enc_mask3 = torch.cat([tile3(txt_mask), torch.cat(
            [obj_mask, g["pos_obj_mask"], g["neg_obj_mask"]], dim=0), ocr_masks], dim=1)
        scores3 = self._recompute_decode(tile3(txt_emb), tile3(obj_in), tile3(ocr_in), enc_mask3,
                                         ocr_masks, dec_len, n_variants=3, argmax_variant=1)
        ref, pos, neg = scores3.chunk(3, dim=0)
        return {"ref_scores": ref, "pos_scores": pos, "neg_scores": neg}
