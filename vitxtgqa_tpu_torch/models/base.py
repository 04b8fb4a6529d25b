"""Joint-transformer + pointer-decode harness.

Counterpart of vitxtgqa_tpu/models/base.py, serving branch only: encode
once over the lane-aligned joint sequence, then a KV-cached greedy decode
with the per-layer decode (no fused-decode kernels yet, and no compact
geometry).  The multi-variant and teacher-forced paths belong to the
full-eval and training slices (ROADMAP.md queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vitxtgqa_tpu_torch.ops.masks import DecodeStepSpec, MaskSpec


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

    def _greedy_decode(self, txt, obj, ocr, enc_mask, ocr_masks, dec_len: int,
                       joint=None):
        """Encode once, then a KV-cached greedy decode; returns float32
        scores [B, dec_len, V + N].

        ``joint``, when given, is the lane-aligned [txt | obj | ocr | pad +
        dec rows] sequence (the QTV residual buffer); rows past l0 may hold
        any finite values — they are masked everywhere and the decoder
        overwrites their cache slots."""
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
            cache = encoder.quantize_cache(cache)
        ppe = self.mmt.prev_pred_embeddings
        ans_tbl, ocr_tbl = ppe.tables(self.classifier.table(), ocr)
        ptr_keys = self.ocr_ptr_net.keys(ocr_out)

        prev = torch.full((b,), self.bos_idx, dtype=torch.long, device=txt.device)
        steps = []
        for t in range(dec_len):
            dec_emb_t = ppe.embed(ans_tbl, ocr_tbl, prev[:, None], position_offset=t)
            spec = DecodeStepSpec(key_mask=key_mask_full, step=t, write_offset=write_offset)
            y_t, cache = encoder.decode_step(dec_emb_t, cache, t, spec, write_offset)
            fixed = self.classifier(y_t)
            dynamic = self.ocr_ptr_net.scores_from_keys(y_t, ptr_keys, ocr_masks)
            scores_t = torch.cat([fixed, dynamic], dim=-1)[:, 0, :]
            prev = scores_t.argmax(dim=-1)
            steps.append(scores_t)
        return torch.stack(steps, dim=1).float()
