"""Joint-transformer + pointer-decode harness.

Counterpart of vitxtgqa_tpu/models/base.py: the teacher-forced prefix-LM
pass ``_mmt_full`` (training and the full-eval ref/neg scores), and the
serving decode: encode once over the lane-aligned joint sequence, then a
KV-cached greedy decode.  With the int8 cache on CUDA at batch <=
Options.fused_decode_max_batch each step is the single-kernel decode step
plus the fused epilogue (ops/decode_step.py), as the JAX serving branch
runs them on a TPU — or, under compact serving, the step kernel and the
per-step epilogue in PyTorch (JAX's step_fused); otherwise each step runs
the per-layer decode over the int8 or bf16 cache.  Both passes take the
compact hooks (``embed_ocr``, ``dynamic_scatter``) of compact serving and
compact full-eval.  ``_recompute_decode`` is the reference-style greedy
decode that reruns ``_mmt_full`` at every step, the parity oracle of the
cached decode.  The multi-variant cached decode and the post-scan compact
epilogue are not ported (ROADMAP.md queue 1).

The zoo's models share the rest of their assembly here: the modality
streams (``_add_frame_stream`` / ``_frame_stream``, ``_add_ocr_stream`` /
``_ocr_stream``), the decoder heads (``_add_decoder``), the seeded init,
and for the single-variant models (M4C, T5-ViteVQA, GT-box) the one
forward ``_single_pass``: teacher-forced in training, the greedy decode (or
the recompute oracle) in eval.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from vitxtgqa_tpu_torch.models.common import (
    FixedVocabClassifier,
    LayerNorm,
    Linear,
    OcrPtrNet,
    PrevPredEmbeddings,
    TransformerEncoder,
    cfg_get,
    derived_weights,
)
from vitxtgqa_tpu_torch.ops import decode_step as DS
from vitxtgqa_tpu_torch.ops.dropout import dropout
from vitxtgqa_tpu_torch.ops.masks import DecodeStepSpec, MaskSpec, joint_mask_spec, length_mask

PAD_BIAS = -1e30  # classifier pad lanes: the greedy argmax never picks them


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize equivalent: x / max(||x||, eps), in x's dtype."""
    norm = torch.sqrt(torch.sum(x.square(), dim=dim, keepdim=True))
    return x / torch.clamp_min(norm, eps)


def project_features(dense: nn.Module, parts, normalize) -> torch.Tensor:
    """``dense(concat([l2_normalize(p) if n else p, ...], -1))`` — the
    modality input projection, in the naive concat form the JAX package
    measured fastest."""
    cat = torch.cat([l2_normalize(p) if n else p for p, n in zip(parts, normalize)], dim=-1)
    return dense(cat)


class Wrap(nn.Module):
    """Named container that reproduces the reference's module nesting."""

    def __init__(self, **modules: nn.Module):
        super().__init__()
        for name, mod in modules.items():
            self.add_module(name, mod)


class JointQAModel(nn.Module):
    """Base for models that own ``mmt`` (``.encoder`` and
    ``.prev_pred_embeddings``), ``classifier``, ``ocr_ptr_net``, ``opts``
    and ``bos_idx``."""

    # joint sequences are padded so that enc + dec is a multiple of 128,
    # which keeps the cache slots and write_offset equal to the JAX ones
    LANE = 128
    # children that stay float32 under a bf16 compute dtype (the JAX
    # models' Dense layers without a dtype: grounding, pointer, classifier)
    FLOAT32_CHILDREN = ("Grounding_Module", "PostHoc", "ocr_ptr_net", "classifier")

    # ---- assembly (call inside ``torch.device(opts.device)``) ---------------
    def _add_frame_stream(self, c, hidden: int, frame_embed: bool = True):
        """The obj stream's modules: the frame-id embedding (not M4C's), the
        projection of config ``obj.mmt_in_dim`` features and its LayerNorm."""
        obj = cfg_get(c, "obj")
        self.obj_dropout = float(cfg_get(obj, "dropout_prob") or 0.0)
        if frame_embed:
            self.frame_embeddings = nn.Embedding(4000, 50)
        self.linear_obj_feat_to_mmt_in = Linear(int(cfg_get(obj, "mmt_in_dim")), hidden)
        self.obj_feat_layer_norm = LayerNorm(hidden, eps=1e-12)

    def _add_ocr_stream(self, c, hidden: int, ocr_ids: bool = True):
        """The OCR stream's modules: the temporal- and track-id embeddings
        (not M4C's), the projections of config ``ocr.mmt_in_dim`` features
        and of the boxes, and their LayerNorms."""
        ocr = cfg_get(c, "ocr")
        self.ocr_dropout = float(cfg_get(ocr, "dropout_prob") or 0.0)
        if ocr_ids:
            self.temporal_position_embeddings = nn.Embedding(4000, 50)
            self.track_position_embeddings = nn.Embedding(4000, 50)
        self.linear_ocr_feat_to_mmt_in = Linear(int(cfg_get(ocr, "mmt_in_dim")), hidden)
        self.linear_ocr_bbox_to_mmt_in = Linear(4, hidden)
        self.ocr_feat_layer_norm = LayerNorm(hidden, eps=1e-12)
        self.ocr_bbox_layer_norm = LayerNorm(hidden, eps=1e-12)

    def _add_decoder(self, c, mmt_cfg, num_final_outputs: int, opts):
        """The MMT with its decoder-slot embeddings, the fixed-vocabulary
        classifier and the OCR pointer net."""
        ptr = cfg_get(cfg_get(c, "classifier"), "ocr_ptr_net")
        ocr_max = int(cfg_get(cfg_get(c, "classifier"), "ocr_max_num"))
        self.mmt = Wrap(encoder=TransformerEncoder(mmt_cfg, opts),
                        prev_pred_embeddings=PrevPredEmbeddings(mmt_cfg))
        self.classifier = FixedVocabClassifier(num_final_outputs - ocr_max, mmt_cfg.hidden_size)
        self.ocr_ptr_net = OcrPtrNet(int(cfg_get(ptr, "hidden_size")),
                                     int(cfg_get(ptr, "query_key_size")), plain=opts.plain)

    def _cast_to_compute_dtype(self):
        """The transformer stacks and the input projections compute in the
        compute dtype; FLOAT32_CHILDREN stay float32 (as in the JAX models)."""
        for name, mod in self.named_children():
            if name not in self.FLOAT32_CHILDREN:
                mod.to(self.opts.dtype)

    def init_weights(self, seed: int) -> "JointQAModel":
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

    # ---- modality streams ----------------------------------------------------
    def _text_stream(self, batch, train: bool = False, gen=None):
        txt_mask = length_mask(batch["text_len"], batch["text"].shape[1])
        return self.text_bert(batch["text"], txt_mask, train=train, gen=gen), txt_mask

    def _frame_stream(self, batch, gen=None):
        """Every sampled frame: its l2-normalised feature with its frame-id
        embedding, projected and LayerNormed (dropout with ``gen``)."""
        obj_lin = project_features(
            self.linear_obj_feat_to_mmt_in,
            [batch["video_feat"].to(self.opts.dtype), self.frame_embeddings(batch["frame_id"])],
            [True, False],
        )
        return dropout(self.obj_feat_layer_norm(obj_lin), self.obj_dropout, gen)

    def _ocr_stream(self, batch, gen=None, ids=("temporal_id", "track_id"),
                    box: str = "ocr_bbox_coordinates"):
        """The OCR slots: l2-normalised FastText and PHOC features (with the
        embeddings of the ``ids`` fields, None for none), projected and
        LayerNormed, plus the LayerNormed projection of the ``box`` field."""
        dt = self.opts.dtype
        parts = [batch["context_feature_0"].to(dt), batch["context_feature_1"].to(dt)]
        if ids is not None:
            parts += [self.temporal_position_embeddings(batch[ids[0]]),
                      self.track_position_embeddings(batch[ids[1]])]
        ocr_lin = project_features(self.linear_ocr_feat_to_mmt_in, parts,
                                   [True, True, False, False][:len(parts)])
        ocr_in = self.ocr_feat_layer_norm(ocr_lin) + self.ocr_bbox_layer_norm(
            self.linear_ocr_bbox_to_mmt_in(batch[box].to(dt)))
        return dropout(ocr_in, self.ocr_dropout, gen)

    # ---- forward -------------------------------------------------------------
    def forward(self, batch, gumbel=None, train: bool = False, dropout_gen=None):
        """``gumbel``: a torch.Generator for the grounding's draws, or the
        noise tensors (T2S and its ablations; the other models draw none);
        ``dropout_gen`` the training dropout generator on the model's
        device (None: no dropout).  Eval runs under no_grad."""
        if train:
            return self._forward_train(batch, gumbel, dropout_gen)
        with torch.no_grad():
            return self._forward_eval(batch, gumbel)

    def _forward_train(self, batch, gumbel, gen):
        return self._single_pass(batch, True, gen)

    def _forward_eval(self, batch, gumbel):
        return self._single_pass(batch, False, None)

    def _single_pass(self, batch, train: bool, gen=None):
        """The single-variant models' forward (JAX m4c.py / t5vitevqa.py /
        gt_box.py ``__call__``): ``_streams`` gives the three streams, their
        masks (the OCR mask is also the pointer's) and the grounding
        outputs; training runs one teacher-forced pass, eval the greedy
        decode (the recompute oracle under ``decode_recompute``).  Returns
        pos_scores float32 [B, S, V + N] and the grounding outputs."""
        txt, txt_mask, obj, obj_mask, ocr, ocr_mask, out = self._streams(batch, train, gen)
        enc_mask = torch.cat([txt_mask, obj_mask, ocr_mask], dim=1)
        if train:
            scores = self._mmt_full(txt, obj, ocr, enc_mask, ocr_mask, batch["train_prev_inds"],
                                    train=True, gen=gen)
        else:
            decode = self._recompute_decode if self.decode_recompute else self._greedy_decode
            scores = decode(txt, obj, ocr, enc_mask, ocr_mask, batch["train_prev_inds"].shape[1])
        return {"pos_scores": scores, **out}

    def _scores(self, dec_out, ocr_out, ocr_mask):
        fixed = self.classifier(dec_out)
        dynamic = self.ocr_ptr_net(dec_out, ocr_out, ocr_mask)
        return torch.cat([fixed, dynamic], dim=-1)

    def _enc_row_pad(self, l_enc: int, dec_len: int) -> int:
        return (-(l_enc + dec_len)) % self.LANE

    @staticmethod
    def _scatter_dynamic(dynamic, idx, full_n: int, may_pad: bool):
        """Scatter compact-row copy scores [B, S, n_compact] back to the full
        OCR width [B, S, full_n]; never-kept slots hold -1e4 (the compact
        deviation from the reference's raw 0/1 pointer mask).  ``may_pad``:
        -1 entries of a padded gather list write into a trash slot that is
        sliced away (JAX base.py:_scatter_dynamic without ``fill``, which
        only compact training uses)."""
        b, s, n = dynamic.shape
        idx_b = idx.long()[:, None, :].expand(b, s, n)
        if may_pad:
            safe = torch.where(idx_b < 0, torch.full_like(idx_b, full_n), idx_b)
            full = dynamic.new_full((b, s, full_n + 1), -1e4)
            return full.scatter(-1, safe, dynamic)[..., :full_n]
        return dynamic.new_full((b, s, full_n), -1e4).scatter(-1, idx_b, dynamic)

    def _mmt_full(self, txt, obj, ocr, enc_mask, ocr_masks, prev_inds, train: bool = False,
                  gen=None, embed_ocr=None, dynamic_scatter=None):
        """One teacher-forced prefix-LM pass over [txt | obj | ocr | pad |
        decoder slots of prev_inds] (JAX base.py:_mmt_full); returns float32
        scores [B, S, V + N].  Compact hooks, as in _greedy_decode: ``ocr``
        may be grounding-gathered rows, ``embed_ocr`` the full OCR stream
        for the copy tables, ``dynamic_scatter`` (idx, full_n, may_pad)."""
        dec_len = prev_inds.shape[1]
        ppe = self.mmt.prev_pred_embeddings
        ans_tbl, ocr_tbl = ppe.tables(self.classifier.table(),
                                      ocr if embed_ocr is None else embed_ocr)
        dec_emb = ppe.embed(ans_tbl, ocr_tbl, prev_inds, gen=gen)
        l0 = txt.shape[1] + obj.shape[1] + ocr.shape[1]
        pad = self._enc_row_pad(l0, dec_len)
        zeros = txt.new_zeros((txt.shape[0], pad, txt.shape[2]))
        x = torch.cat([txt, obj, ocr, zeros, dec_emb.to(txt.dtype)], dim=1)
        spec = joint_mask_spec(F.pad(enc_mask.float(), (0, pad)), dec_len)
        h = self.mmt.encoder(x, spec, train=train, gen=gen)
        n_ocr = ocr.shape[1]
        dec_out, ocr_out = h[:, -dec_len:], h[:, l0 - n_ocr: l0]
        if dynamic_scatter is None:
            return self._scores(dec_out, ocr_out, ocr_masks)
        dynamic = self._scatter_dynamic(self.ocr_ptr_net(dec_out, ocr_out, ocr_masks),
                                        *dynamic_scatter)
        return torch.cat([self.classifier(dec_out), dynamic], dim=-1)

    def _greedy_decode(self, txt, obj, ocr, enc_mask, ocr_masks, dec_len: int,
                       joint=None, embed_ocr=None, dynamic_scatter=None):
        """Encode once, then a KV-cached greedy decode; returns float32
        scores [B, dec_len, V + N].

        ``joint``, when given, is the lane-aligned [txt | obj | ocr | pad +
        dec rows] sequence (the QTV residual buffer); rows past l0 may hold
        any finite values — they are masked everywhere and the decoder
        overwrites their cache slots.

        Compact serving (JAX base.py:_greedy_decode's hooks): ``ocr`` may be
        grounding-gathered OCR rows; ``embed_ocr`` is then the full OCR
        stream for the copy tables (token ids index the full copy space),
        and ``dynamic_scatter`` (idx [B, n_compact], full_n, may_pad)
        scatters each step's copy scores back to the full width, in the
        step, before its argmax.  With it the fused decode runs the step
        kernel with the per-step epilogue in PyTorch (JAX's step_fused),
        since the fused epilogue keeps the scores compact-width."""
        b = txt.shape[0]
        l0 = txt.shape[1] + obj.shape[1] + ocr.shape[1]
        pad = self._enc_row_pad(l0, dec_len)
        if joint is not None and joint.shape[1] == l0 + pad + dec_len:
            x = joint
        else:
            zeros = txt.new_zeros((b, pad + dec_len, txt.shape[2]))
            x = torch.cat([txt, obj, ocr, zeros], dim=1)
        key_mask_full = F.pad(enc_mask.float(), (0, pad + dec_len))
        write_offset = l0 + pad

        encoder = self.mmt.encoder
        enc_h, cache = encoder.encode_with_cache(x, MaskSpec(key_mask=key_mask_full))
        n_ocr = ocr.shape[1]
        ocr_out = enc_h[:, l0 - n_ocr: l0]
        if self.opts.kv_cache_int8:
            # the separate quantize pass, as JAX keeps it (the flash kernel's
            # emission, encode_with_cache(quantize=True), measured slower on
            # the v5e)
            cache = encoder.quantize_cache(cache)
        ppe = self.mmt.prev_pred_embeddings
        ans_tbl, ocr_tbl = ppe.tables(self.classifier.table(),
                                      ocr if embed_ocr is None else embed_ocr)
        ptr_keys = self.ocr_ptr_net.keys(ocr_out)
        fused = encoder.fused_decode_ok(x)
        if fused and dynamic_scatter is None:
            return self._fused_greedy_decode(cache, key_mask_full, write_offset, ans_tbl,
                                             ocr_tbl, ptr_keys, ocr_masks, dec_len)

        def finish_step(y_t):
            fixed = self.classifier(y_t)
            dynamic = self.ocr_ptr_net.scores_from_keys(y_t, ptr_keys, ocr_masks)
            if dynamic_scatter is not None:
                dynamic = self._scatter_dynamic(dynamic, *dynamic_scatter)
            return torch.cat([fixed, dynamic], dim=-1)[:, 0, :]

        if fused:  # step_fused (base.py:417-433): the step kernel, then finish_step
            stacks, kv8, kvsc, buffers = encoder.fused_decode_prep(cache)
        prev = torch.full((b,), self.bos_idx, dtype=torch.long, device=txt.device)
        steps = []
        for t in range(dec_len):
            dec_emb_t = ppe.embed(ans_tbl, ocr_tbl, prev[:, None], position_offset=t)
            if fused:
                y_t, kv8, kvsc = encoder.fused_decode_step_apply(
                    stacks, dec_emb_t, kv8, kvsc, t, key_mask_full, write_offset, buffers)
            else:
                spec = DecodeStepSpec(key_mask=key_mask_full, step=t, write_offset=write_offset)
                y_t, cache = encoder.decode_step(dec_emb_t, cache, t, spec, write_offset)
            scores_t = finish_step(y_t)
            prev = scores_t.argmax(dim=-1)
            steps.append(scores_t)
        return torch.stack(steps, dim=1).float()

    def _fused_greedy_decode(self, cache, key_mask, write_offset: int, ans_tbl, ocr_tbl,
                             ptr_keys, ocr_masks, dec_len: int):
        """The serving form of the JAX fused branch (base.py:342-415): per
        step one fused_decode_step launch, two row commits and one
        fused_epilogue launch.  The padded classifier, the padded answer
        table and the LayerNormed (position, type) rows are built once per
        set of weights (derived_weights), the step-0 embedding and the
        epilogue's scratch once per forward; the pad lanes are sliced out
        once after the loop.  Returns float32 scores [B, dec_len, V + N]."""
        encoder = self.mmt.encoder
        ppe = self.mmt.prev_pred_embeddings
        stacks, kv8, kvsc, buffers = encoder.fused_decode_prep(cache)
        v_fix = self.classifier.module.weight.shape[0]
        v_p = -(-v_fix // self.LANE) * self.LANE

        def tables():
            w_c, b_c = self.classifier.module.weight, self.classifier.module.bias
            pos_e = ppe.position_embeddings.weight[:dec_len]
            type_e = ppe.token_type_embeddings.weight[:2]
            emb_rows = ppe.emb_layer_norm(pos_e[:, None, :] + type_e[None, :, :])
            return (F.pad(w_c.detach().float(), (0, 0, 0, v_p - v_fix)),
                    F.pad(b_c.detach().float(), (0, v_p - v_fix), value=PAD_BIAS),
                    F.pad(ans_tbl, (0, 0, 0, v_p - v_fix)),
                    emb_rows.reshape(2 * dec_len, -1).float())

        params = [*self.classifier.parameters(), *ppe.parameters()]
        cls_w, cls_b, ans_pad, emb_rows = derived_weights(
            self, f"epilogue_tables_{dec_len}", params, tables)
        ptr = self.ocr_ptr_net.query
        qk = ptr.weight.shape[0]
        bos = torch.full((kv8.shape[1], 1), self.bos_idx, dtype=torch.long,
                         device=kv8.device)
        demb = ppe.embed(ans_tbl, ocr_tbl, bos, position_offset=0)
        epilogue = DS.fused_epilogue_plain
        if kv8.is_cuda and not self.opts.plain:  # one scratch for every step's launch
            epilogue = functools.partial(DS.fused_epilogue, buffers=DS.epilogue_buffers(
                kv8.shape[1], qk, kv8.device))
        mask = ocr_masks.float().contiguous()
        steps = []
        for t in range(dec_len):
            y_t, kv8, kvsc = encoder.fused_decode_step_apply(
                stacks, demb, kv8, kvsc, t, key_mask, write_offset, buffers)
            scores_pad, _tok, demb = epilogue(
                y_t, cls_w, cls_b, ptr.weight, ptr.bias, ptr_keys, mask, ans_pad, ocr_tbl,
                emb_rows, t, v_fix, 1.0 / qk ** 0.5, dec_len)
            steps.append(scores_pad[:, 0])
        s = torch.stack(steps, dim=1)
        return torch.cat([s[..., :v_fix], s[..., v_p:]], dim=-1).float()

    def _recompute_decode(self, txt, obj, ocr, enc_mask, ocr_masks, dec_len: int,
                          n_variants: int = 1, argmax_variant: int = 0):
        """Reference-style greedy decode (JAX base.py:_recompute_decode): the
        full teacher-forced ``_mmt_full`` pass at every one of the
        ``dec_len`` steps on the tokens chosen so far; the parity oracle of
        the cached decode.  The batch holds ``n_variants`` mask variants
        stacked along it, and the argmax of variant ``argmax_variant``
        feeds all of them.  Returns the last pass's float32 scores [B,
        dec_len, V + N]."""
        b = txt.shape[0] // n_variants
        lo = argmax_variant * b
        prev = torch.zeros((txt.shape[0], dec_len), dtype=torch.long, device=txt.device)
        prev[:, 0] = self.bos_idx
        scores = None
        for _ in range(dec_len):
            scores = self._mmt_full(txt, obj, ocr, enc_mask, ocr_masks, prev)
            chosen = scores[lo: lo + b].argmax(dim=-1).repeat(n_variants, 1)
            prev = torch.cat([prev[:, :1], chosen[:, :-1]], dim=1)
        return scores
