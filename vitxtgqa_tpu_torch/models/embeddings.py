"""The legacy Pythia text and image embeddings.

Counterpart of vitxtgqa_tpu/models/embeddings.py (reference:
pythia/modules/embeddings.py:16-242): VocabEmbedding, the stacked LSTM /
GRU, BiLSTMTextEmbedding, PreExtractedEmbedding (host-side npy lookup),
AttentionTextEmbedding (LSTM + two conv1d attention maps) and
ImageEmbedding (top-down attention pooling).  Plain PyTorch.

The recurrences are flax's cells (``nn.OptimizedLSTMCell`` /
``nn.GRUCell`` inside ``nn.RNN``) with their gates stacked in torch's
order, LSTM (i, f, g, o) and GRU (r, z, n), and the biases the cells have:
per layer ``weight_ih_l{k}`` [G*H, in] and ``weight_hh_l{k}`` [G*H, H]
(``_reverse`` for the backward direction), then an LSTM's ``bias_l{k}``
[4H] (flax's hidden-gate biases; its input gates have none) or a GRU's
``bias_ih_l{k}`` [3H] (the input gates') and ``bias_hn_l{k}`` [H] (the
hidden candidate's, inside the reset product; its hidden r / z gates have
none).  The whole padded sequence runs, with no packing, and the backward
direction runs reversed with its outputs kept in the input order (flax's
``reverse=True, keep_order=True``); BiLSTMTextEmbedding takes ``out[:,
-1]``, over the padding (a reference quirk that stays).  The loop over the
steps is written out: the input products of all steps in one matmul, then
one hidden product a step.  Dropout between layers draws from the
forward's generator.

Dtypes are the JAX modules': float32 parameters, an input in the compute
dtype promoted at each product, and the pooled outputs cast back to their
input's dtype where the JAX modules cast them.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vitxtgqa_tpu_torch.models.attention_legacy import AttentionLayer
from vitxtgqa_tpu_torch.models.layers import softmax
from vitxtgqa_tpu_torch.ops.dropout import dropout

GATES = {"LSTM": 4, "GRU": 3}


class VocabEmbedding(nn.Embedding):
    """Embedding table sized from a vocab, optionally initialised from its
    vectors (reference: :49-55)."""

    def __init__(self, embedding_dim: int, vocab_size: int, pretrained=None):
        super().__init__(vocab_size, embedding_dim)
        if pretrained is not None:
            with torch.no_grad():
                self.weight.copy_(torch.as_tensor(np.asarray(pretrained, np.float32)))

    def forward(self, x, gen=None):
        return super().forward(x)


def lstm_step(gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor, w_hh: torch.Tensor):
    """One LSTM step from the step's input products ``gx`` [B, 4H] (the
    gate biases added): (h, c)."""
    gates = gx + F.linear(h, w_hh)
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def gru_step(gx: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor, b_hn: torch.Tensor):
    """One GRU step from the step's input products ``gx`` [B, 3H] (the
    input gates' biases added): h."""
    hr, hz, hn = F.linear(h, w_hh).chunk(3, dim=-1)
    xr, xz, xn = gx.chunk(3, dim=-1)
    r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * (hn + b_hn))
    return (1.0 - z) * n + z * h


class StackedRNN(nn.Module):
    """``num_layers`` of LSTM or GRU, optionally bidirectional; returns the
    output sequence [B, T, H or 2H] (the JAX ``_StackedRNN``)."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 1, rnn_type: str = "GRU",
                 bidirectional: bool = False, dropout: float = 0.0):
        super().__init__()
        if rnn_type not in GATES:
            raise ValueError(f"rnn_type {rnn_type!r}: LSTM or GRU")
        self.hidden_dim, self.num_layers, self.rnn_type = hidden_dim, num_layers, rnn_type
        self.bidirectional, self.dropout = bidirectional, float(dropout)
        gh = GATES[rnn_type] * hidden_dim
        biases = {"LSTM": {"bias": gh}, "GRU": {"bias_ih": gh, "bias_hn": hidden_dim}}[rnn_type]
        for layer in range(num_layers):
            d_in = in_dim if layer == 0 else hidden_dim * (2 if bidirectional else 1)
            for sfx in self.suffixes(layer):
                self.register_parameter(f"weight_ih{sfx}", nn.Parameter(torch.empty(gh, d_in)))
                self.register_parameter(f"weight_hh{sfx}",
                                        nn.Parameter(torch.empty(gh, hidden_dim)))
                for name, size in biases.items():
                    self.register_parameter(f"{name}{sfx}", nn.Parameter(torch.zeros(size)))

    def suffixes(self, layer: int):
        return [f"_l{layer}"] + ([f"_l{layer}_reverse"] if self.bidirectional else [])

    def direction(self, x: torch.Tensor, sfx: str, reverse: bool) -> torch.Tensor:
        w_ih, w_hh = getattr(self, f"weight_ih{sfx}"), getattr(self, f"weight_hh{sfx}")
        lstm = self.rnn_type == "LSTM"
        b_in = getattr(self, f"bias{sfx}" if lstm else f"bias_ih{sfx}")
        gx = F.linear(x.to(w_ih.dtype), w_ih, b_in)  # [B, T, G*H]
        h = torch.zeros(x.shape[0], self.hidden_dim, device=x.device, dtype=w_ih.dtype)
        c = torch.zeros_like(h)
        outs = [None] * x.shape[1]
        for s in (range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])):
            if lstm:
                h, c = lstm_step(gx[:, s], h, c, w_hh)
            else:
                h = gru_step(gx[:, s], h, w_hh, getattr(self, f"bias_hn{sfx}"))
            outs[s] = h
        return torch.stack(outs, dim=1)

    def forward(self, x: torch.Tensor, gen=None) -> torch.Tensor:
        out = x
        for layer in range(self.num_layers):
            out = torch.cat([self.direction(out, sfx, reverse=sfx.endswith("_reverse"))
                             for sfx in self.suffixes(layer)], dim=-1)
            if layer < self.num_layers - 1:
                out = dropout(out, self.dropout, gen)
        return out


class BiLSTMTextEmbedding(nn.Module):
    """RNN over embedded tokens; returns the last step's output (reference:
    :58-98; both of the reference's branches as its bidirectional one, the
    only one it can run)."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 1, dropout: float = 0.0,
                 bidirectional: bool = False, rnn_type: str = "GRU"):
        super().__init__()
        self.recurrent_encoder = StackedRNN(in_dim, hidden_dim, num_layers, rnn_type,
                                            bidirectional, dropout)
        self.out_dim = hidden_dim * (2 if bidirectional else 1)

    def forward(self, x, gen=None):
        return self.recurrent_encoder(x, gen)[:, -1]

    def forward_all(self, x, gen=None):
        return self.recurrent_encoder(x, gen)


class PreExtractedEmbedding:
    """Host-side per-question-id npy lookup with caching (reference:
    :101-116); data plumbing, not a module."""

    def __init__(self, out_dim: int, base_path: str):
        self.text_out_dim = out_dim
        self.base_path = base_path
        self._load = lru_cache(maxsize=5000)(self._load_uncached)

    def _load_uncached(self, qid: int) -> np.ndarray:
        return np.load(os.path.join(self.base_path, f"{qid}.npy"))

    def __call__(self, qids) -> np.ndarray:
        return np.stack([self._load(int(q)) for q in np.asarray(qids)], 0)


class AttentionTextEmbedding(nn.Module):
    """LSTM -> two 1-D convs -> softmax over T -> weighted-sum glimpses
    (reference: :119-178).  Output [B, conv2_out * hidden_dim]."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 1, dropout: float = 0.0,
                 conv1_out: int = 512, conv2_out: int = 2, kernel_size: int = 1,
                 padding: int = 0, bidirectional: bool = False):
        super().__init__()
        per_dir = hidden_dim // 2 if bidirectional else hidden_dim
        self.recurrent_unit = StackedRNN(in_dim, per_dir, num_layers, "LSTM", bidirectional)
        width = per_dir * (2 if bidirectional else 1)
        self.conv1 = nn.Conv1d(width, conv1_out, kernel_size, padding=padding)
        self.conv2 = nn.Conv1d(conv1_out, conv2_out, kernel_size, padding=padding)
        self.dropout = float(dropout)
        self.out_dim = conv2_out * width

    def forward(self, x, gen=None):
        b = x.shape[0]
        lstm_drop = dropout(self.recurrent_unit(x, gen), self.dropout, gen)  # [B, T, H]
        h = F.relu(self.conv1(lstm_drop.transpose(1, 2)))
        attn = softmax(self.conv2(h), 2)  # [B, conv2_out, T], over T
        return torch.einsum("bgt,bth->bgh", attn, lstm_drop).to(x.dtype).reshape(b, -1)


class ImageEmbedding(nn.Module):
    """Attention-pooled image features (reference: :181-222); ``order_dim``:
    the width of the order vectors appended to the features before the
    pooling (LoRRA's context)."""

    def __init__(self, image_dim: int, question_dim: int, modal_combine: Any, transform: Any,
                 normalization: str = "softmax", order_dim: int = 0):
        super().__init__()
        self.image_attention_model = AttentionLayer(image_dim, question_dim, modal_combine,
                                                    transform, normalization)
        n_att = self.image_attention_model.module.transform.out_features
        self.out_dim = n_att * (image_dim + order_dim)

    def forward(self, image_feat, question_embedding, image_locs=None, order_vectors=None,
                gen=None):
        attention = self.image_attention_model(image_feat, question_embedding, image_locs, gen)
        if order_vectors is not None:
            image_feat = torch.cat([image_feat, order_vectors], dim=-1)
        dt = torch.promote_types(attention.dtype, image_feat.dtype)
        pooled = torch.einsum("bka,bkd->bad", attention.to(dt), image_feat.to(dt))
        pooled = pooled.to(image_feat.dtype)
        return pooled.reshape(pooled.shape[0], -1), attention


def text_embedding(emb_type: str, in_dim: int, **kwargs):
    """TextEmbedding dispatch (reference: :16-46); ``in_dim`` is the width
    of the embedded tokens the recurrent types read."""
    if emb_type == "identity":
        return None
    if emb_type in ("vocab", "torch"):
        return VocabEmbedding(int(kwargs["embedding_dim"]), int(kwargs["vocab_size"]),
                              kwargs.get("pretrained") if emb_type == "vocab" else None)
    if emb_type == "preextracted":
        return PreExtractedEmbedding(kwargs["out_dim"], kwargs["base_path"])
    if emb_type == "bilstm":
        return BiLSTMTextEmbedding(
            in_dim, int(kwargs["hidden_dim"]), int(kwargs.get("num_layers", 1)),
            float(kwargs.get("dropout", 0.0)), bool(kwargs.get("bidirectional", False)),
            str(kwargs.get("rnn_type", "GRU")))
    if emb_type == "attention":
        return AttentionTextEmbedding(
            in_dim, int(kwargs["hidden_dim"]), int(kwargs.get("num_layers", 1)),
            float(kwargs.get("dropout", 0.0)), int(kwargs["conv1_out"]),
            int(kwargs["conv2_out"]), int(kwargs["kernel_size"]), int(kwargs["padding"]),
            bool(kwargs.get("bidirectional", False)))
    raise NotImplementedError(f"Unknown question embedding {emb_type!r}")
