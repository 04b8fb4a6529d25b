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
(``_compact_decode``); the ref pass stays full.  The recompute decode is not
ported and raises NotImplementedError naming its ROADMAP.md item.

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

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vitxtgqa_tpu_torch.models.base import JointQAModel, project_features
from vitxtgqa_tpu_torch.models.common import (
    FixedVocabClassifier,
    LayerNorm,
    Linear,
    OcrPtrNet,
    PrevPredEmbeddings,
    TextEncoder,
    TransformerConfig,
    TransformerEncoder,
    cfg_get,
)
from vitxtgqa_tpu_torch.models.grounding import Gumbel, GroundingModule
from vitxtgqa_tpu_torch.ops.dropout import dropout
from vitxtgqa_tpu_torch.ops.masks import MaskSpec, length_mask
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


class _Wrap(nn.Module):
    """Named container that reproduces the reference's module nesting."""

    def __init__(self, **modules: nn.Module):
        super().__init__()
        for name, mod in modules.items():
            self.add_module(name, mod)


class T2S(JointQAModel):
    # whether the grounding's compact gather lists can be -1-padded (only the
    # JAX wo_sg ablation's can); selects the trash-slot scatter
    COMPACT_IDX_MAY_PAD = False

    def __init__(self, config: Any, num_final_outputs: int, bos_idx: int = 2,
                 opts: Options = Options(), inference_only: bool = True,
                 decode_recompute: bool = False):
        super().__init__()
        if decode_recompute:
            raise NotImplementedError(
                "the recompute decode oracle (_recompute_decode) is ROADMAP.md queue 1 item 2"
            )
        self.opts = opts
        self.inference_only = inference_only
        self.bos_idx = int(bos_idx)
        c = config
        self.obj_dropout = float(cfg_get(cfg_get(c, "obj"), "dropout_prob") or 0.0)
        self.ocr_dropout = float(cfg_get(cfg_get(c, "ocr"), "dropout_prob") or 0.0)
        mmt_cfg = TransformerConfig.from_config(cfg_get(c, "mmt"))
        text_cfg = TransformerConfig.from_config(cfg_get(c, "text_bert"))
        trans_cfg = TransformerConfig.from_config(cfg_get(c, "translayers"))
        hidden = mmt_cfg.hidden_size
        g = cfg_get(c, "grounding")
        ptr = cfg_get(cfg_get(c, "classifier"), "ocr_ptr_net")
        ocr_max = int(cfg_get(cfg_get(c, "classifier"), "ocr_max_num"))

        with torch.device(opts.device):
            self.text_bert = TextEncoder(text_cfg, opts)
            # obj (frame) stream: ViT feature + frame-id embedding -> hidden
            self.frame_embeddings = nn.Embedding(4000, 50)
            self.linear_obj_feat_to_mmt_in = Linear(int(cfg_get(cfg_get(c, "obj"), "mmt_in_dim")), hidden)
            self.obj_feat_layer_norm = LayerNorm(hidden, eps=1e-12)
            # ocr stream: fasttext + phoc + temporal-id + track-id, and bbox
            self.temporal_position_embeddings = nn.Embedding(4000, 50)
            self.track_position_embeddings = nn.Embedding(4000, 50)
            self.linear_ocr_feat_to_mmt_in = Linear(int(cfg_get(cfg_get(c, "ocr"), "mmt_in_dim")), hidden)
            self.linear_ocr_bbox_to_mmt_in = Linear(4, hidden)
            self.ocr_feat_layer_norm = LayerNorm(hidden, eps=1e-12)
            self.ocr_bbox_layer_norm = LayerNorm(hidden, eps=1e-12)
            # QTV cross-modal pre-fusion
            self.TransLayer = _Wrap(encoder=TransformerEncoder(trans_cfg, opts))
            self.Grounding_Module = GroundingModule(
                in_dim=trans_cfg.hidden_size,
                hidden_size=int(cfg_get(g, "hidden_size")),
                frame_topk=int(cfg_get(g, "frame_topk")),
                ocr_topk=int(cfg_get(g, "ocr_topk")),
                frame_num=int(cfg_get(g, "frame_num")),
                ocr_frame_num=int(cfg_get(g, "ocr_frame_num")),
            )
            self.mmt = _Wrap(
                encoder=TransformerEncoder(mmt_cfg, opts),
                prev_pred_embeddings=PrevPredEmbeddings(mmt_cfg),
            )
            self.classifier = FixedVocabClassifier(num_final_outputs - ocr_max, hidden)
            self.ocr_ptr_net = OcrPtrNet(int(cfg_get(ptr, "hidden_size")),
                                         int(cfg_get(ptr, "query_key_size")), plain=opts.plain)
        # the transformer stacks and the input projections compute in the
        # compute dtype; grounding, the pointer net and the classifier stay
        # float32 (as in the JAX model)
        for name, mod in self.named_children():
            if name not in ("Grounding_Module", "ocr_ptr_net", "classifier"):
                mod.to(opts.dtype)

    def init_weights(self, seed: int) -> "T2S":
        """BERT-style random init from a seeded generator on the model's
        device: N(0, 0.02) matrices and embeddings, zero biases, unit
        LayerNorm scales."""
        gen = torch.Generator(device=self.opts.device).manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
                elif isinstance(mod, (nn.Linear, nn.Embedding)):
                    w = torch.empty(mod.weight.shape, device=mod.weight.device)
                    mod.weight.copy_(w.normal_(0.0, 0.02, generator=gen))
                    if getattr(mod, "bias", None) is not None:
                        mod.bias.zero_()
        return self

    # ---- modality encodings ------------------------------------------------
    def _encode_modalities(self, batch, train: bool = False, gen=None):
        dt = self.opts.dtype
        txt_mask = length_mask(batch["text_len"], batch["text"].shape[1])
        txt_emb = self.text_bert(batch["text"], txt_mask, train=train, gen=gen)
        obj_lin = project_features(
            self.linear_obj_feat_to_mmt_in,
            [batch["video_feat"].to(dt), self.frame_embeddings(batch["frame_id"])],
            [True, False],
        )
        obj_in = dropout(self.obj_feat_layer_norm(obj_lin), self.obj_dropout, gen)
        obj_mask = batch["frame_mask"].float()
        ocr_lin = project_features(
            self.linear_ocr_feat_to_mmt_in,
            [batch["context_feature_0"].to(dt), batch["context_feature_1"].to(dt),
             self.temporal_position_embeddings(batch["temporal_id"]),
             self.track_position_embeddings(batch["track_id"])],
            [True, True, False, False],
        )
        bbox = batch["ocr_bbox_coordinates"].to(dt)
        ocr_in = self.ocr_feat_layer_norm(ocr_lin) + self.ocr_bbox_layer_norm(
            self.linear_ocr_bbox_to_mmt_in(bbox)
        )
        ocr_in = dropout(ocr_in, self.ocr_dropout, gen)
        ocr_mask = batch["ocr_mask"].float()
        return txt_emb, txt_mask, obj_in, obj_mask, ocr_in, ocr_mask

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

    # ---- forward -------------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor], gumbel: Gumbel,
                train: bool = False, dropout_gen: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """``gumbel`` is a torch.Generator for the two grounding draws, or
        the two noise tensors ([B, 2, F], [B, 2, N]); ``dropout_gen`` the
        training dropout generator on the model's device (None: no
        dropout).  Returns pos_scores [B, S, V + N] float32 (and with
        train=True or inference_only=False also ref_scores and
        neg_scores), ground_frame [B, topk], ground_box [B, F * ocr_topk, 4]
        and the two top-k sizes."""
        if train:
            return self._forward_train(batch, gumbel, dropout_gen)
        with torch.no_grad():
            return self._forward_eval(batch, gumbel)

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
        batch B, each with its own dropout draws."""
        txt_emb, txt_mask, obj_in, obj_mask, ocr_in, ocr_mask = self._encode_modalities(
            batch, train=True, gen=gen)
        txt_emb, obj_in, ocr_in, _ = self._apply_qtv(
            txt_emb, txt_mask, obj_in, obj_mask, ocr_in, ocr_mask, 0, train=True, gen=gen)
        g, common = self._grounding(batch, txt_emb, txt_mask, obj_in, obj_mask, ocr_in,
                                    ocr_mask, gumbel)
        prev = batch["train_prev_inds"]
        scores = {}
        for name, obj_m, ocr_m in (("ref", obj_mask, ocr_mask),
                                   ("pos", g["pos_obj_mask"], g["pos_ocr_mask"]),
                                   ("neg", g["neg_obj_mask"], g["neg_ocr_mask"])):
            enc_mask = torch.cat([txt_mask, obj_m, ocr_m], dim=1)
            scores[f"{name}_scores"] = self._mmt_full(txt_emb, obj_in, ocr_in, enc_mask, ocr_m,
                                                      prev, train=True, gen=gen)
        return {**scores, **common}

    def _forward_eval(self, batch, gumbel):
        txt_emb, txt_mask, obj_in, obj_mask, ocr_in, ocr_mask = self._encode_modalities(batch)
        dec_len = batch["train_prev_inds"].shape[1]
        txt_emb, obj_in, ocr_in, joint = self._apply_qtv(
            txt_emb, txt_mask, obj_in, obj_mask, ocr_in, ocr_mask, dec_len
        )
        g, common = self._grounding(batch, txt_emb, txt_mask, obj_in, obj_mask, ocr_in,
                                    ocr_mask, gumbel)
        compact = self.opts.compact_serving
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
