"""DETR-style transformer decoder stack of TranSTR's selector.

Counterpart of vitxtgqa_tpu/models/detr.py (reference:
pythia/modules/transtr_module/multimodal_transformer.py and attention.py):
post-LN layers with a relu FFN of 2,048, whose cross-attention returns its
weights averaged over the heads for the top-k sorters.  The attention is
plain PyTorch (``torch.matmul`` and softmax in float32, keys masked with
-inf), as the JAX module computes it with einsum outside any kernel: 8
heads at width 768 are 96 wide, which the port's attention kernels do not
take.  The LayerNorms keep flax's default eps of 1e-6 (the resizer's is
1e-12).

Parameter names are the reference's (``layers.{i}.self_attn.q_lin``,
``layers.{i}.multihead_attn.*``, ``norm1``-``norm3``, ``linear1`` /
``linear2``, the stack's ``norm``; the resizer's ``fc`` and
``layer_norm``), which utils/torch_convert.convert_transtr reads.  Every
dropout draws its mask from the training generator ``gen`` (none: no
dropout).
"""

from __future__ import annotations

import torch
from torch import nn

from vitxtgqa_tpu_torch.models.common import LayerNorm, Linear
from vitxtgqa_tpu_torch.ops.dropout import dropout

DETR_LN_EPS = 1e-6  # flax nn.LayerNorm's default


class DetrAttention(nn.Module):
    """Multi-head attention that can return its head-averaged weights;
    ``key_mask`` [B, Lk] is 1 on valid keys."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.1):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout_rate
        self.q_lin, self.k_lin = Linear(dim, dim), Linear(dim, dim)
        self.v_lin, self.out_lin = Linear(dim, dim), Linear(dim, dim)

    def _split(self, x):
        b, l, d = x.shape
        return x.reshape(b, l, self.num_heads, d // self.num_heads).transpose(1, 2)

    def forward(self, query, key, value, key_mask=None, gen=None, return_weights: bool = False):
        q, k, v = self._split(self.q_lin(query)), self._split(self.k_lin(key)), \
            self._split(self.v_lin(value))
        scale = torch.tensor(q.shape[-1], dtype=q.dtype, device=q.device).sqrt()
        scores = torch.matmul(q / scale, k.transpose(-1, -2)).float()
        if key_mask is not None:
            scores = torch.where(key_mask[:, None, None, :] > 0, scores,
                                 torch.full_like(scores, float("-inf")))
        weights = dropout(torch.softmax(scores, dim=-1), self.dropout, gen)
        ctx = torch.matmul(weights.to(v.dtype), v)
        b, h, l, dh = ctx.shape
        out = self.out_lin(ctx.transpose(1, 2).reshape(b, l, h * dh))
        return (out, weights.mean(dim=1)) if return_weights else out


class DetrDecoderLayer(nn.Module):
    """Post-LN decoder layer: the queries' self-attention, the
    cross-attention (its weights returned), the FFN
    (multimodal_transformer.py:119-172)."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int = 2048, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout = dropout_rate
        self.self_attn = DetrAttention(dim, num_heads, dropout_rate)
        self.multihead_attn = DetrAttention(dim, num_heads, dropout_rate)
        self.linear1, self.linear2 = Linear(dim, ffn_dim), Linear(ffn_dim, dim)
        self.norm1 = LayerNorm(dim, eps=DETR_LN_EPS)
        self.norm2 = LayerNorm(dim, eps=DETR_LN_EPS)
        self.norm3 = LayerNorm(dim, eps=DETR_LN_EPS)

    def forward(self, tgt, memory, memory_key_mask=None, query_pos=None, gen=None):
        drop = lambda x: dropout(x, self.dropout, gen)
        qk = tgt if query_pos is None else tgt + query_pos
        tgt = self.norm1(tgt + drop(self.self_attn(qk, qk, tgt, gen=gen)))
        q = tgt if query_pos is None else tgt + query_pos
        ca, weights = self.multihead_attn(q, memory, memory, memory_key_mask, gen=gen,
                                          return_weights=True)
        tgt = self.norm2(tgt + drop(ca))
        ffn = self.linear2(drop(torch.relu(self.linear1(tgt))))
        return self.norm3(tgt + drop(ffn)), weights


class DetrDecoder(nn.Module):
    """The layer stack and a final LayerNorm; returns (output, the last
    layer's cross-attention weights [B, Lq, Lk])."""

    def __init__(self, dim: int, num_heads: int, num_layers: int, ffn_dim: int = 2048,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList([DetrDecoderLayer(dim, num_heads, ffn_dim, dropout_rate)
                                     for _ in range(num_layers)])
        self.norm = LayerNorm(dim, eps=DETR_LN_EPS)

    def forward(self, tgt, memory, memory_key_mask=None, query_pos=None, gen=None):
        weights = None
        for layer in self.layers:
            tgt, weights = layer(tgt, memory, memory_key_mask, query_pos, gen)
        return self.norm(tgt), weights


class FeatureResizer(nn.Module):
    """Linear, LayerNorm (eps 1e-12), dropout
    (multimodal_transformer.py:180-199)."""

    def __init__(self, in_dim: int, out_dim: int, dropout_rate: float = 0.2):
        super().__init__()
        self.dropout = dropout_rate
        self.fc = Linear(in_dim, out_dim)
        self.layer_norm = LayerNorm(out_dim, eps=1e-12)

    def forward(self, x, gen=None):
        return dropout(self.layer_norm(self.fc(x)), self.dropout, gen)
