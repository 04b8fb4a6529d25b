"""The legacy Pythia attention family.

Counterpart of vitxtgqa_tpu/models/attention_legacy.py (reference:
pythia/modules/attention.py): ConcatenationAttention (:37),
ProjectAttention (:58), DoubleProjectAttention (:88), TopDownAttention
with its location masking (:110) and the config-dispatch AttentionLayer
(:8).  Plain PyTorch (no kernel of the JAX package lies under them).

Like the JAX modules, TopDownAttention's transform is a plain linear (the
reference's weight_norm(dim=None) there is a training re-parametrisation
the JAX package collapses), and its combine layer takes the combine
params' hidden width alone (dropout 0).  Softmaxes run in float32.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from vitxtgqa_tpu_torch.models.common import Linear
from vitxtgqa_tpu_torch.models.layers import GatedTanh, ModalCombineLayer, softmax
from vitxtgqa_tpu_torch.ops.dropout import dropout


class ConcatenationAttention(nn.Module):
    """concat(img, q) -> GatedTanh -> linear -> softmax over locations."""

    def __init__(self, image_dim: int, question_dim: int, hidden_size: int):
        super().__init__()
        self.fa = GatedTanh(image_dim + question_dim, hidden_size)
        self.lc = Linear(hidden_size, 1)

    def forward(self, image_feat, question_embedding, gen=None):
        b, num_loc, _ = image_feat.shape
        q = question_embedding[:, None, :].expand(b, num_loc, question_embedding.shape[-1])
        raw = self.lc(self.fa(torch.cat([image_feat, q], dim=2)))
        return softmax(raw, 1).expand(image_feat.shape)


class ProjectAttention(nn.Module):
    """GatedTanh(img) * GatedTanh(q) -> dropout -> linear -> softmax."""

    def __init__(self, image_dim: int, question_dim: int, hidden_size: int,
                 dropout: float = 0.2):
        super().__init__()
        self.fa_image = GatedTanh(image_dim, hidden_size)
        self.fa_txt = GatedTanh(question_dim, hidden_size)
        self.lc = Linear(hidden_size, 1)
        self.dropout = float(dropout)

    def raw_att(self, image_feat, question_embedding, gen=None):
        joint = self.fa_image(image_feat) * self.fa_txt(question_embedding)[:, None, :]
        return self.lc(dropout(joint, self.dropout, gen))

    def forward(self, image_feat, question_embedding, gen=None):
        raw = self.raw_att(image_feat, question_embedding, gen)
        return softmax(raw, 1).expand(image_feat.shape)


class DoubleProjectAttention(nn.Module):
    """Sum of two ProjectAttention raw scores -> softmax."""

    def __init__(self, image_dim: int, question_dim: int, hidden_size: int,
                 dropout: float = 0.2):
        super().__init__()
        self.att1 = ProjectAttention(image_dim, question_dim, hidden_size, dropout)
        self.att2 = ProjectAttention(image_dim, question_dim, hidden_size, dropout)

    def forward(self, image_feat, question_embedding, gen=None):
        raw = (self.att1.raw_att(image_feat, question_embedding, gen)
               + self.att2.raw_att(image_feat, question_embedding, gen))
        return softmax(raw, 1).expand(image_feat.shape)


def mask_attentions(attention: torch.Tensor, image_locs: torch.Tensor) -> torch.Tensor:
    """Zero the attention at locations >= the sample's location count
    (reference: attention.py:118-132)."""
    num_loc = attention.shape[1]
    loc_idx = torch.arange(num_loc, device=attention.device, dtype=attention.dtype)[None, :]
    mask = loc_idx >= image_locs.to(attention.dtype)[:, None]
    return attention.masked_fill(mask[:, :, None], 0.0)


class TopDownAttention(nn.Module):
    """Combine -> transform -> normalise, with the renormalised location
    masking (reference: attention.py:110-158)."""

    EPS = 1.0e-08

    def __init__(self, combine_type: str, image_dim: int, question_dim: int,
                 combine_params: Any, transform_out_dim: int, normalization: str = "softmax"):
        super().__init__()
        self.combine = ModalCombineLayer(combine_type, image_dim, question_dim,
                                         int(dict(combine_params)["hidden_dim"]))
        self.transform = Linear(self.combine.out_dim, transform_out_dim)
        self.normalization = normalization.lower()
        if self.normalization not in ("softmax", "sigmoid"):
            raise NotImplementedError(normalization)

    def forward(self, image_feat, question_embedding, image_locs=None, gen=None):
        raw = self.transform(self.combine(image_feat, question_embedding, gen=gen))
        if self.normalization == "softmax":
            attention = softmax(raw, 1)
            if image_locs is not None:
                masked = mask_attentions(attention, image_locs)
                s = masked.sum(dim=1, keepdim=True)
                s = s + (s == 0).to(s.dtype) + self.EPS
                attention = masked / s
        else:
            attention = torch.sigmoid(raw)
            if image_locs is not None:
                attention = mask_attentions(attention, image_locs)
        return attention


class AttentionLayer(nn.Module):
    """Config-dispatch wrapper (reference: attention.py:8-35): the top-down
    path of the legacy Pythia models."""

    def __init__(self, image_dim: int, question_dim: int, modal_combine: Any, transform: Any,
                 normalization: str = "softmax"):
        super().__init__()
        combine, transform = dict(modal_combine), dict(transform)
        self.module = TopDownAttention(
            combine["type"], image_dim, question_dim, combine.get("params", {}),
            int(dict(transform.get("params", {}) or {}).get("out_dim", 1)), normalization)

    def forward(self, image_feat, question_embedding, image_locs=None, gen=None):
        return self.module(image_feat, question_embedding, image_locs, gen)
