"""The legacy image-VQA layer library.

Counterpart of vitxtgqa_tpu/models/layers.py (reference:
pythia/modules/layers.py:9-593): GatedTanh, the weight-normed linears, the
logit and weight-norm classifiers, the modal-combine layers (element
multiply, MFH), FCNet, BCNet and BiAttention.  Plain PyTorch: the JAX
modules run as XLA outside any Pallas kernel, so no kernel of the port lies
under them.

Weight norm is the JAX package's: ``w = g * v / max(||v||_F, 1e-12)`` with
one scalar ``g`` and the Frobenius norm of the whole ``v`` (torch's
``weight_norm(dim=None)``), for every weight-normed linear and for BCNet's
``h_mat``.  Parameter names follow the JAX modules (``v``, ``g``, ``b``;
``fc0``, ``fa_image``, ``h_mat_v``, ...) with torch's layouts: ``v`` is
[out, in] like a Linear weight (utils/convert.py transposes the flax [in,
out]).

Dtypes are the JAX modules': the parameters are float32, an input in the
compute dtype (bf16 features) is promoted to float32 at each product, as
jnp promotes ``x @ w``, and BCNet casts its bilinear logits back to its
input's dtype where the JAX module does.

Modules take their input widths at construction (the flax modules infer
them); each module builds only the sublayers its forward uses, so that
the state dict holds the parameters the JAX tree holds.  Dropout draws
from the forward's generator (ops/dropout.dropout: a no-op without one),
softmaxes run in float32.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vitxtgqa_tpu_torch.models.common import Linear
from vitxtgqa_tpu_torch.ops.dropout import dropout

WN_EPS = 1e-12


def wn_weight(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * v / max(||v||_F, 1e-12)."""
    return v / torch.linalg.vector_norm(v).clamp_min(WN_EPS) * g


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Softmax in float32, returned in x's dtype."""
    return torch.softmax(x.float(), dim=dim).to(x.dtype)


class WNDense(nn.Module):
    """Weight-normalised linear (torch weight_norm(nn.Linear, dim=None))."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.v = nn.Parameter(torch.empty(out_dim, in_dim))
        self.g = nn.Parameter(torch.ones(()))
        self.b = nn.Parameter(torch.zeros(out_dim))

    def weight(self) -> torch.Tensor:
        return wn_weight(self.v, self.g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.v.dtype), self.weight(), self.b)


class ReLUWithWeightNormFC(WNDense):
    """Weight-normalised linear + ReLU (reference: layers.py:78-88)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(super().forward(x))


class GatedTanh(nn.Module):
    """y = tanh(fc(x)) * sigmoid(gate_fc(x)) (reference: layers.py:51-75)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc = Linear(in_dim, out_dim)
        self.gate_fc = Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.fc(x)) * torch.sigmoid(self.gate_fc(x))


class LogitClassifier(nn.Module):
    """Two-branch logit head over ReLU-weight-norm projections (reference:
    layers.py:110-138).  ``text_only``: the text branch alone, which is
    all that pythia_question_only builds and runs."""

    def __init__(self, in_dim: int, out_dim: int, text_hidden: int, img_hidden: int,
                 text_only: bool = False):
        super().__init__()
        self.f_o_text = ReLUWithWeightNormFC(in_dim, text_hidden)
        self.linear_text = Linear(text_hidden, out_dim)
        if not text_only:
            self.f_o_image = ReLUWithWeightNormFC(in_dim, img_hidden)
            self.linear_image = Linear(img_hidden, out_dim)

    def text(self, joint: torch.Tensor) -> torch.Tensor:
        return self.linear_text(self.f_o_text(joint))

    def forward(self, joint: torch.Tensor, gen=None) -> torch.Tensor:
        return self.text(joint) + self.linear_image(self.f_o_image(joint))


class WeightNormClassifier(nn.Module):
    """wn-fc -> relu -> dropout -> wn-fc (reference: layers.py:141-155)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, dropout: float = 0.5):
        super().__init__()
        self.fc1 = ReLUWithWeightNormFC(in_dim, hidden_dim)
        self.fc2 = WNDense(hidden_dim, out_dim)
        self.dropout = float(dropout)

    def forward(self, x: torch.Tensor, gen=None) -> torch.Tensor:
        return self.fc2(dropout(self.fc1(x), self.dropout, gen))


class ClassifierLayer(nn.Module):
    """Type-dispatched classifier (reference: layers.py:91-109)."""

    def __init__(self, classifier_type: str, in_dim: int, out_dim: int, params: Any = None,
                 text_only: bool = False):
        super().__init__()
        p = dict(params or {})
        self.classifier_type = classifier_type
        if classifier_type == "linear":
            self.module = Linear(in_dim, out_dim)
        elif classifier_type == "logit":
            self.module = LogitClassifier(in_dim, out_dim,
                                          int(p.get("text_hidden_dim", in_dim)),
                                          int(p.get("img_hidden_dim", in_dim)), text_only)
        elif classifier_type == "weight_norm":
            self.module = WeightNormClassifier(in_dim, int(p.get("hidden_dim", in_dim)),
                                               out_dim, float(p.get("dropout", 0.5)))
        else:
            raise ValueError(f"unknown classifier type {classifier_type!r}")

    def forward(self, x: torch.Tensor, gen=None) -> torch.Tensor:
        if self.classifier_type == "linear":
            return self.module(x)
        return self.module(x, gen)


class NonLinearElementMultiply(nn.Module):
    """ReLU-weight-norm projections multiplied elementwise, with an optional
    context stream concatenated on the location axis (reference:
    layers.py:288-320).  A width of None leaves that projection out: the
    Pythia ablations use one of fa_image / fa_txt alone."""

    def __init__(self, image_dim: Optional[int], question_dim: Optional[int], hidden_dim: int,
                 context_dim: Optional[int] = None, dropout: float = 0.0):
        super().__init__()
        if image_dim is not None:
            self.fa_image = ReLUWithWeightNormFC(image_dim, hidden_dim)
        if question_dim is not None:
            self.fa_txt = ReLUWithWeightNormFC(question_dim, hidden_dim)
        if context_dim is not None:
            self.fa_context = ReLUWithWeightNormFC(context_dim, hidden_dim)
        self.dropout = float(dropout)
        self.hidden_dim = hidden_dim

    def forward(self, image_feat, question_embedding, context_embedding=None, gen=None):
        i = self.fa_image(image_feat)
        q = self.fa_txt(question_embedding)
        if image_feat.dim() == 3 and question_embedding.dim() == 2:
            q = q[:, None, :]
        joint = i * q
        if context_embedding is not None:
            joint = torch.cat([joint, self.fa_context(context_embedding) * q], dim=1)
        return dropout(joint, self.dropout, gen)


class MFH(nn.Module):
    """Multi-modal factorised high-order pooling (reference:
    layers.py:205-285): two MFB blocks chained, outputs concatenated."""

    def __init__(self, image_dim: int, question_dim: int, hidden_dim: int, pool_size: int = 2,
                 order: int = 2, dropout: float = 0.1):
        super().__init__()
        self.hidden_dim, self.pool_size, self.order = hidden_dim, pool_size, order
        self.dropout = float(dropout)
        for o in range(order):
            self.add_module(f"img_{o}", Linear(image_dim, hidden_dim * pool_size))
            self.add_module(f"q_{o}", Linear(question_dim, hidden_dim * pool_size))

    def forward(self, image_feat, question_embedding, gen=None):
        outs, exp_prev = [], None
        for o in range(self.order):
            i = getattr(self, f"img_{o}")(image_feat)
            q = getattr(self, f"q_{o}")(question_embedding)
            if image_feat.dim() == 3 and q.dim() == 2:
                q = q[:, None, :]
            z = i * q
            if exp_prev is not None:
                z = z * exp_prev
            exp_prev = z
            z = dropout(z, self.dropout, gen)
            z = z.reshape(*z.shape[:-1], self.hidden_dim, self.pool_size).sum(-1)
            # signed sqrt + l2 norm
            z = torch.sign(z) * torch.sqrt(z.abs() + 1e-12)
            z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-12)
            outs.append(z)
        return torch.cat(outs, dim=-1)


class ModalCombineLayer(nn.Module):
    """Type-dispatched fusion (reference: layers.py:165-184)."""

    def __init__(self, combine_type: str, image_dim: Optional[int],
                 question_dim: Optional[int], hidden_dim: int, dropout: float = 0.0,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.combine_type = combine_type
        if combine_type == "non_linear_element_multiply":
            self.module = NonLinearElementMultiply(image_dim, question_dim, hidden_dim,
                                                   context_dim, dropout)
        elif combine_type == "MFH":
            self.module = MFH(image_dim, question_dim, hidden_dim)
        else:
            raise ValueError(f"unknown combine type {combine_type!r}")
        self.out_dim = hidden_dim * (2 if combine_type == "MFH" else 1)

    def forward(self, image_feat, question_embedding, context_embedding=None, gen=None):
        if self.combine_type == "MFH":
            return self.module(image_feat, question_embedding, gen)
        return self.module(image_feat, question_embedding, context_embedding, gen)


class FCNet(nn.Module):
    """Weight-norm MLP (reference: layers.py:529-560): per layer, dropout
    where > 0, weight_norm(Linear, dim=None), the activation.  ``dims`` is
    [in, hidden..., out]."""

    def __init__(self, dims: Sequence[int], act: str = "relu", dropout: float = 0.0):
        super().__init__()
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"fc{i}", WNDense(a, b))
        self.n = len(dims) - 1
        self.act = getattr(F, act.lower()) if act else None
        self.dropout = float(dropout)

    def forward(self, x: torch.Tensor, gen=None) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(dropout(x, self.dropout, gen))
            if self.act is not None:
                x = self.act(x)
        return x


class BCNet(nn.Module):
    """Bilinear connect network (reference: layers.py:456-526): k-factor
    weight-norm projections of v and q, then the broadcast-Hadamard glimpse
    logits (h_out <= 32, BiAttention) or, in ``forward_with_weights``, the
    weighted bilinear fusion with the AvgPool(k) * k folding (a sum over the
    k consecutive factors).  ``hmat_weight_norm``: h_mat = g * v / ||v||_F
    (BiAttention's weight_norm(BCNet, name='h_mat', dim=None))."""

    def __init__(self, v_dim: int, q_dim: int, h_dim: int, h_out: Optional[int] = None,
                 k: int = 3, act: str = "relu", dropout=(0.2, 0.5),
                 hmat_weight_norm: bool = False):
        super().__init__()
        hk = h_dim * k
        self.h_dim, self.h_out, self.k = h_dim, h_out, k
        self.hmat_weight_norm = hmat_weight_norm
        self.v_net = FCNet((v_dim, hk), act=act, dropout=dropout[0])
        self.q_net = FCNet((q_dim, hk), act=act, dropout=dropout[0])
        self.dropout = float(dropout[1])
        if h_out is not None:
            assert h_out <= 32, "h_out > c uses h_net (not needed here)"
            if hmat_weight_norm:
                self.h_mat_v = nn.Parameter(torch.empty(1, h_out, 1, hk))
                self.h_mat_g = nn.Parameter(torch.ones(()))
            else:
                self.h_mat = nn.Parameter(torch.empty(1, h_out, 1, hk))
            self.h_bias = nn.Parameter(torch.empty(1, h_out, 1, 1))

    def _h_mat(self) -> torch.Tensor:
        if self.hmat_weight_norm:
            return wn_weight(self.h_mat_v, self.h_mat_g)
        return self.h_mat

    def forward(self, v, q, gen=None):
        """Glimpse logits [B, h_out, K, T]."""
        v_ = dropout(self.v_net(v, gen), self.dropout, gen)  # [B, K, hk]
        q_ = self.q_net(q, gen)  # [B, T, hk]
        h_ = v_[:, None] * self._h_mat()  # [B, h_out, K, hk]
        return torch.einsum("bgkh,bth->bgkt", h_, q_).to(v.dtype) + self.h_bias

    def forward_with_weights(self, v, q, w, gen=None):
        """[B, h_dim]: v_net(v)^T w q_net(q), its k factors summed."""
        v_ = self.v_net(v, gen)  # [B, K, hk]
        q_ = self.q_net(q, gen)  # [B, T, hk]
        logits = torch.einsum("bkh,bkt,bth->bh", v_, w.to(v_.dtype), q_).to(v.dtype)
        if self.k > 1:
            logits = logits.reshape(logits.shape[0], self.h_dim, self.k).sum(-1)
        return logits


class BiAttention(nn.Module):
    """Bilinear co-attention (reference: layers.py:564-593): glimpse logits
    from a weight-normed BCNet, -inf where the visual row is all zero,
    softmax over the flattened K x T grid.  Returns (p [B, glimpses, K, T],
    logits)."""

    def __init__(self, v_dim: int, q_dim: int, hidden_dim: int, glimpses: int = 2,
                 dropout=(0.2, 0.5)):
        super().__init__()
        self.glimpses = glimpses
        self.logits_net = BCNet(v_dim, q_dim, hidden_dim, h_out=glimpses, k=3, dropout=dropout,
                                hmat_weight_norm=True)

    def forward(self, v, q, v_mask: bool = True, gen=None):
        b, v_num, q_num = v.shape[0], v.shape[1], q.shape[1]
        logits = self.logits_net(v, q, gen)  # [B, G, K, T]
        if v_mask:
            empty = v.abs().sum(2) == 0  # [B, K]
            logits = logits.masked_fill(empty[:, None, :, None], float("-inf"))
        p = softmax(logits.reshape(b, self.glimpses, v_num * q_num), 2)
        return p.reshape(b, self.glimpses, v_num, q_num), logits
