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
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from vitxtgqa_tpu_torch.models.common import derived_weights
from vitxtgqa_tpu_torch.ops import decode_step as DS
from vitxtgqa_tpu_torch.ops.masks import DecodeStepSpec, MaskSpec, joint_mask_spec

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


class JointQAModel(nn.Module):
    """Base for models that own ``mmt`` (``.encoder`` and
    ``.prev_pred_embeddings``), ``classifier``, ``ocr_ptr_net``, ``opts``
    and ``bos_idx``."""

    # joint sequences are padded so that enc + dec is a multiple of 128,
    # which keeps the cache slots and write_offset equal to the JAX ones
    LANE = 128

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
