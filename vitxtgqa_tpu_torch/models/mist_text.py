"""MIST's auxiliary modules: the DistilBERT-style fusion transformer, the
embedding helpers, EncoderVid and the language-model wrappers.

Counterpart of vitxtgqa_tpu/models/mist_text.py (reference:
pythia/modules/mist_module/mist_module.py:13-388, EncoderVid.py:18-67,
language_model.py:7-103).  The reference instantiates them and leaves them
out of its live forward; they are here for the components' parity and as
building blocks.

Parameter names are the reference's torch names (HF DistilBERT's
``layer.{i}.attention.q_lin``, ``sa_layer_norm``, ``ffn.lin1``, ...;
EncoderVid's ``bbox_conv.{0,1,3,4}`` and ``tohid.0``), so its state dicts
load with ``load_state_dict``; utils/convert.from_jax_mist_text_params maps
the JAX modules' variables onto them.

What runs where: the fusion transformer, the embeddings, EncoderVid and
SentenceMaxpool are plain PyTorch (the JAX modules reach no TPU kernel) on
the ``device`` they are built on, the card unless the caller asks for the
CPU; MistBert and AModel run the port's TextEncoder (models/common.py), so
on the card its kernels where its gates hold.  Dropout draws from a
``gen`` (flax nn.Dropout semantics, ops/dropout.dropout); without one it
is off.  The fusion transformer's blocks are post-LN (the LayerNorm after
the residual add, eps 1e-12); a key of ``mask == 0`` scores -inf, so a
query row whose keys are all masked gives NaN, as in the JAX module.
EncoderVid's BatchNorm takes flax's update in training (momentum 0.9 on
the running mean and the BIASED batch variance; torch's BatchNorm2d would
take the unbiased one).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vitxtgqa_tpu_torch.models.common import Linear, TextEncoder, TransformerConfig
from vitxtgqa_tpu_torch.ops import dropout as D
from vitxtgqa_tpu_torch.options import Options


def sinusoidal_embeddings(n_pos: int, dim: int) -> np.ndarray:
    """Interleaved sin / cos table (reference: mist_module.py:13-24)."""
    pos_enc = np.array([[pos / np.power(10000, 2 * (j // 2) / dim) for j in range(dim)]
                        for pos in range(n_pos)])
    out = np.zeros((n_pos, dim), np.float32)
    out[:, 0::2] = np.sin(pos_enc[:, 0::2])
    out[:, 1::2] = np.cos(pos_enc[:, 1::2])
    return out


@dataclasses.dataclass(frozen=True)
class DistilConfig:
    """The DistilBertConfig fields the fusion transformer reads."""

    dim: int = 768
    n_heads: int = 12
    n_layers: int = 2
    hidden_dim: int = 3072
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation: str = "gelu"


class DistilSelfAttention(nn.Module):
    """Separate Q / K / V projections; keys of ``mask == 0`` score -inf
    (reference: mist_module.py:27-105)."""

    def __init__(self, cfg: DistilConfig):
        super().__init__()
        self.cfg = cfg
        self.q_lin, self.k_lin = nn.Linear(cfg.dim, cfg.dim), nn.Linear(cfg.dim, cfg.dim)
        self.v_lin, self.out_lin = nn.Linear(cfg.dim, cfg.dim), nn.Linear(cfg.dim, cfg.dim)

    def forward(self, query, key, value, mask, gen=None):
        c = self.cfg
        hd = c.dim // c.n_heads
        heads = lambda t: t.reshape(t.shape[0], t.shape[1], c.n_heads, hd).transpose(1, 2)
        q = heads(self.q_lin(query)) / hd ** 0.5
        k, v = heads(self.k_lin(key)), heads(self.v_lin(value))
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        neg = torch.where(mask[:, None, None, :] == 0, -torch.inf, 0.0)
        weights = D.dropout(torch.softmax(scores + neg, dim=-1).to(v.dtype),
                            c.attention_dropout, gen)
        ctx = torch.einsum("bhqk,bhkd->bhqd", weights.float(), v.float()).to(query.dtype)
        return self.out_lin(ctx.transpose(1, 2).reshape(ctx.shape[0], -1, c.dim))


class DistilFFN(nn.Module):
    def __init__(self, cfg: DistilConfig):
        super().__init__()
        self.cfg = cfg
        self.lin1, self.lin2 = nn.Linear(cfg.dim, cfg.hidden_dim), nn.Linear(cfg.hidden_dim, cfg.dim)

    def forward(self, x, gen=None):
        h = self.lin1(x)
        h = F.gelu(h) if self.cfg.activation == "gelu" else F.relu(h)
        return D.dropout(self.lin2(h), self.cfg.dropout, gen)


class DistilTransformerBlock(nn.Module):
    """Post-LN self-attention block (reference: mist_module.py:127-181)."""

    def __init__(self, cfg: DistilConfig):
        super().__init__()
        self.attention = DistilSelfAttention(cfg)
        self.sa_layer_norm = nn.LayerNorm(cfg.dim, eps=1e-12)
        self.ffn = DistilFFN(cfg)
        self.output_layer_norm = nn.LayerNorm(cfg.dim, eps=1e-12)

    def forward(self, x, attn_mask, gen=None):
        x = self.sa_layer_norm(self.attention(x, x, x, attn_mask, gen) + x)
        return self.output_layer_norm(self.ffn(x, gen) + x)


class DistilTransformer(nn.Module):
    """A stack of post-LN blocks (reference: mist_module.py:184-266)."""

    def __init__(self, cfg: DistilConfig = DistilConfig(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        with torch.device(device):
            self.layer = nn.ModuleList([DistilTransformerBlock(cfg) for _ in range(cfg.n_layers)])

    def forward(self, x, attn_mask=None, gen=None):
        """x [B, L, dim]; attn_mask [B, L] (1 a live key; default all)."""
        if attn_mask is None:
            attn_mask = torch.ones(x.shape[:2], device=x.device)
        for blk in self.layer:
            x = blk(x, attn_mask, gen)
        return x


def _table(n: int, d: int, sinusoidal: bool) -> nn.Embedding:
    """An nn.Embedding of n rows, the sinusoidal table where asked (its
    other init is torch's; a checkpoint overwrites either)."""
    emb = nn.Embedding(n, d)
    if sinusoidal:
        with torch.no_grad():
            emb.weight.copy_(torch.from_numpy(sinusoidal_embeddings(n, d)))
    return emb


class FusionEmbeddings(nn.Module):
    """Position + binary modality embeddings over a [language | vision]
    joint sequence, then LayerNorm (reference: mist_module.py:269-311)."""

    def __init__(self, d_model: int, language_len: int, vision_len: int, dropout: float = 0.1,
                 sinusoidal_pos_embds: bool = False, device="cuda"):
        super().__init__()
        self.language_len, self.vision_len, self.dropout = language_len, vision_len, dropout
        with torch.device(device):
            self.position_embeddings = _table(language_len + vision_len, d_model,
                                              sinusoidal_pos_embds)
            self.modality_embedding = nn.Embedding(2, d_model)
            self.LayerNorm = nn.LayerNorm(d_model, eps=1e-12)

    def forward(self, embeddings, gen=None):
        seq = embeddings.shape[1]
        dev = embeddings.device
        modality = (torch.arange(self.language_len + self.vision_len, device=dev)
                    >= self.language_len).long()[:seq]
        x = (embeddings + self.position_embeddings.weight[:seq].to(embeddings.dtype)
             + self.modality_embedding(modality).to(embeddings.dtype))
        return D.dropout(self.LayerNorm(x), self.dropout, gen)


class PositionEmbeddings(nn.Module):
    """The position table looked up by frame; [B, F, D] or [B, F, R, D]
    inputs (reference: mist_module.py:314-340)."""

    def __init__(self, d_model: int, max_position_embeddings: int,
                 sinusoidal_pos_embds: bool = False, device="cuda"):
        super().__init__()
        with torch.device(device):
            self.position_embeddings = _table(max_position_embeddings, d_model,
                                              sinusoidal_pos_embds)

    def forward(self, embeddings):
        numf = embeddings.shape[1]
        pos = self.position_embeddings.weight[:numf].to(embeddings.dtype)
        if embeddings.ndim == 4:
            pos = pos[:, None, :]
        return pos.expand(embeddings.shape[:-1] + pos.shape[-1:])


class TokenTypeEmbeddings(nn.Module):
    """A named modality's type embedding (reference: mist_module.py:366-388)."""

    TYPE2ID = {"object": 0, "segment": 1, "question": 2}

    def __init__(self, d_model: int, token_type_num: int = 3, device="cuda"):
        super().__init__()
        with torch.device(device):
            self.modality_embedding = nn.Embedding(token_type_num, d_model)

    def forward(self, embeddings, token_type: str):
        row = self.modality_embedding.weight[self.TYPE2ID[token_type]].to(embeddings.dtype)
        return row.expand(embeddings.shape[0], embeddings.shape[1], -1)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with flax's training update: the running mean and the
    biased batch variance taken with momentum 0.9 (torch's 0.1 on the new
    value is the same weight, but torch takes the unbiased variance).  The
    batch normalises by its own biased statistics in training, by the
    running ones otherwise."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x, train: bool = False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        dims = (0, 2, 3)
        mean = x.float().mean(dims)
        var = (x.float() - mean[None, :, None, None]).square().mean(dims)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked += 1
        y = (x - mean[None, :, None, None]) * torch.rsqrt(var + self.eps)[None, :, None, None]
        return y * self.weight[None, :, None, None] + self.bias[None, :, None, None]


class EncoderVid(nn.Module):
    """Per-region box-geometry encoder (reference: EncoderVid.py:18-67):
    1x1 convolutions and BatchNorm over the [B, bbox_dim, clips x frames,
    regions] layout, then a Linear + ELU over [features | positions]."""

    def __init__(self, feat_dim: int, bbox_dim: int, feat_hidden: int, pos_hidden: int,
                 input_dropout_p: float = 0.3, device="cuda"):
        super().__init__()
        self.feat_dim, self.bbox_dim = feat_dim, bbox_dim
        self.input_dropout_p = input_dropout_p  # kept, unused: as the JAX module
        with torch.device(device):
            self.bbox_conv = nn.Sequential(
                nn.Conv2d(bbox_dim, pos_hidden, 1), FlaxBatchNorm2d(pos_hidden), nn.ReLU(),
                nn.Conv2d(pos_hidden, pos_hidden, 1), FlaxBatchNorm2d(pos_hidden), nn.ReLU())
            self.tohid = nn.Sequential(nn.Linear(feat_dim + pos_hidden, feat_hidden), nn.ELU())

    def forward(self, video_o, train: bool = False):
        """video_o [B, numc, numf, numr, feat + bbox (+ rest)] -> [B, numc *
        numf, numr, feat_hidden]; ``train``: the BatchNorms on the batch's
        statistics, their running ones updated (flax's
        ``use_running_average=False``)."""
        b, numc, numf, numr, _ = video_o.shape
        x = video_o.reshape(b, numc * numf, numr, -1)
        roi_feat = x[..., :self.feat_dim]
        pos = x[..., self.feat_dim:self.feat_dim + self.bbox_dim].permute(0, 3, 1, 2)
        conv1, bn1, _, conv2, bn2, _ = self.bbox_conv
        pos = F.relu(bn1(conv1(pos), train))
        pos = F.relu(bn2(conv2(pos), train)).permute(0, 2, 3, 1)
        return self.tohid(torch.cat([roi_feat, pos], dim=-1))


class SentenceMaxpool(nn.Module):
    """Linear, max over the tokens, ReLU (reference: language_model.py:42-56)."""

    def __init__(self, word_dimension: int, output_dim: int, relu: bool = True, device="cuda"):
        super().__init__()
        self.relu = relu
        with torch.device(device):
            self.fc = nn.Linear(word_dimension, output_dim)

    def forward(self, x):
        x = self.fc(x).amax(dim=1)
        return F.relu(x) if self.relu else x


class MistBert(nn.Module):
    """The BERT wrapper: the tokens > 0 as the attention mask, every
    token's output (reference: language_model.py:7-39; its DistilBert
    variant is the same forward on DISTILBERT_BASE)."""

    def __init__(self, cfg: TransformerConfig, opts: Options = Options()):
        super().__init__()
        with torch.device(opts.device):
            self.bert = TextEncoder(cfg, opts)
        self.bert.to(opts.dtype)

    def forward(self, tokens, gen=None):
        """tokens [B, L] -> [B, L, hidden] in the compute dtype."""
        return self.bert(tokens, (tokens > 0).float(), train=gen is not None, gen=gen)


# DistilBERT-base's geometry for the DistilBert variant
DISTILBERT_BASE = TransformerConfig(num_hidden_layers=6, vocab_size=30522)


class AModel(nn.Module):
    """The answer embedder: the BERT's first token -> Linear (reference:
    language_model.py:59-80); [B, L] or [B, n_answers, L] tokens.  The
    Linear is float32 (the JAX Dense's parameters)."""

    def __init__(self, out_dim: int = 512, bert_cfg: Optional[TransformerConfig] = None,
                 opts: Options = Options()):
        super().__init__()
        cfg = bert_cfg or TransformerConfig(num_hidden_layers=12)
        self.bert = MistBert(cfg, opts)
        with torch.device(opts.device):
            self.linear_text = Linear(cfg.hidden_size, out_dim)

    def forward(self, answer, gen=None):
        if answer.ndim == 3:
            bs, nans, lans = answer.shape
            emb = self.bert(answer.reshape(bs * nans, lans), gen)[:, 0].reshape(bs, nans, -1)
        else:
            emb = self.bert(answer, gen)[:, 0]
        return self.linear_text(emb)
