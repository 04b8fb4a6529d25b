"""The legacy Pythia / MMF image-VQA models: pythia and its question-only /
image-only ablations, LoRRA, BAN and top-down bottom-up.

Counterpart of vitxtgqa_tpu/models/legacy_vqa.py (reference:
pythia/models/pythia.py:16-352, lorra.py:9-62, ban.py:12-97,
top_down_bottom_up.py:15-64), registered under the same keys and composed
of the port's copies of the module library (models/layers.py,
attention_legacy.py, embeddings.py, encoders.py).  No kernel of the port
lies on their forward (the JAX models run as XLA outside any Pallas
kernel): ``KERNEL_FREE`` tells the trainer so, which lets them run in
float32 on the card as well as in the config's bf16.

Config: the reference MMF section schema (``text_embeddings``,
``image_feature_embeddings``, ``image_text_modal_combine``, ``classifier``;
BAN's ``text_embedding`` / ``bilinear_attention``), or, where a section is
absent, the one the JAX models synthesize from ``vocab_size`` /
``embed_dim`` / ``hidden_dim`` with MMF's defaults.

Batches: text [B, T] int, image_feature_0 [B, K, Dv] (image_feature_1,
... and image_info_0_max_features where present), LoRRA's
context_feature_0 [B, N, Dc] and order_vectors [B, N, N].  Output
{"scores": [B, num_final_outputs]} in float32.  The flax modules infer
their input widths on the first call; these take them from ``example``, a
batch of the model's data (the trainer passes one sample), and build only
the modules their forward runs, so that ``utils/convert.
from_jax_family_params`` fills the whole state dict from the JAX tree.

The compute dtype (``opts.dtype``) means what the JAX models'
``compute_dtype`` means: the parameters stay float32, and only the image
and context features are cast to it; each product then promotes its
operands to float32, as jnp does, and the few casts of the JAX modules
back to an input's dtype are kept (ImageEmbedding's pooled features,
BCNet's logits, the fc7 encoder's product).  So bf16 rounds the features
and a few intermediates, and the rest runs in float32.

The JAX package's documented quirks stay: the question-only / image-only
ablations apply the word embedding and then zero the text embedding
(pythia.py:307-310, 333-336), and top-down bottom-up is built as the
evident TDBU head (its reference class cannot be constructed).

The seeded init (``init_weights``) draws from one generator on the model's
device: N(0, 1 / fan_in) matrices, embeddings and recurrent weights, zero
biases and BCNet's ``h_mat`` / ``h_bias`` from N(0, 1), as flax's
initialisers scale them; each weight-norm scale ``g`` starts at 1, as the
JAX models' do; a pretrained encoder (the fc7 finetune head) keeps its
pickled weights.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
from torch import nn

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.models.attention_legacy import AttentionLayer
from vitxtgqa_tpu_torch.models.common import cfg_get
from vitxtgqa_tpu_torch.models.embeddings import (
    BiLSTMTextEmbedding,
    ImageEmbedding,
    text_embedding,
)
from vitxtgqa_tpu_torch.models.encoders import build_image_encoder
from vitxtgqa_tpu_torch.models.layers import (
    BCNet,
    BiAttention,
    ClassifierLayer,
    FCNet,
    ModalCombineLayer,
    ReLUWithWeightNormFC,
    WeightNormClassifier,
)
from vitxtgqa_tpu_torch.ops.dropout import dropout
from vitxtgqa_tpu_torch.options import Options

# text embedding types a model can run: the others (vocab, torch,
# preextracted) take token ids where the JAX models hand them embedded
# tokens, and fail there too
RUNNABLE_TEXT = ("attention", "bilstm")


def _plain(node):
    if hasattr(node, "items"):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


def _text_emb_cfgs(config, hidden: int, embed: int) -> List[Dict[str, Any]]:
    """config.text_embeddings, or MMF pythia.yml's default attention
    embedding (hidden_dim x conv2_out = 2 glimpses)."""
    cfgs = _plain(cfg_get(config, "text_embeddings", None))
    if cfgs:
        return cfgs
    return [{"type": "attention", "params": {
        "hidden_dim": hidden, "embedding_dim": embed, "num_layers": 1, "dropout": 0.0,
        "conv1_out": 512, "conv2_out": 2, "kernel_size": 1, "padding": 0}}]


def _feat_emb_cfgs(config, key: str, hidden: int) -> List[Dict[str, Any]]:
    """config.<attr>_feature_embeddings, or MMF pythia.yml's default single
    top-down attention embedding."""
    cfgs = _plain(cfg_get(config, key, None))
    if cfgs:
        return cfgs
    return [{"modal_combine": {"type": "non_linear_element_multiply",
                               "params": {"dropout": 0.0, "hidden_dim": hidden}},
             "normalization": "softmax",
             "transform": {"type": "linear", "params": {"out_dim": 1}}}]


def _width(example, key: str) -> int:
    return int(example[key].shape[-1])


class _LegacyBase(nn.Module):
    KERNEL_FREE = True

    def __init__(self, config: Any, num_final_outputs: int, bos_idx: int = 2,
                 opts: Options = Options(), example: Dict[str, Any] = None):
        super().__init__()
        if example is None:
            raise ValueError(f"{type(self).__name__} takes its input widths from an example "
                             "batch of its data (example=...)")
        self.config, self.opts = config, opts
        self.num_final_outputs = int(num_final_outputs)
        with torch.device(opts.device):
            self._build(example)

    def _dims(self):
        c = self.config
        return (int(cfg_get(c, "vocab_size", 30522)), int(cfg_get(c, "embed_dim", 300)),
                int(cfg_get(c, "hidden_dim", 1024)))

    def _add_encoders(self, example, attr: str) -> List[int]:
        """The encoders of ``{attr}_feature_0``, ``_1``, ... (config
        ``{attr}_feature_encodings``; absent: ``default``, the identity),
        registered as ``{attr}_feature_encoders_{i}``; returns the encoded
        widths (reference pythia.py:65-80 + modules/encoders.py:12-28)."""
        enc_cfgs = _plain(cfg_get(self.config, f"{attr}_feature_encodings", None)) or []
        data_dir = str(cfg_get(self.config, "model_data_dir", "") or "")
        widths, i = [], 0
        while f"{attr}_feature_{i}" in example:
            width = _width(example, f"{attr}_feature_{i}")
            if i < len(enc_cfgs):
                params = dict(enc_cfgs[i].get("params", {}) or {})
                params.setdefault("model_data_dir", data_dir)
                enc, width = build_image_encoder(str(enc_cfgs[i]["type"]), width, **params)
                self.add_module(f"{attr}_feature_encoders_{i}", enc)
            widths.append(width)
            i += 1
        return widths

    def _features(self, batch, attr: str = "image") -> List[torch.Tensor]:
        """``{attr}_feature_{i}`` in the compute dtype, each through its
        encoder (the reference's process_feature_embedding loop,
        pythia.py:250-270)."""
        feats, i = [], 0
        while f"{attr}_feature_{i}" in batch:
            feat = batch[f"{attr}_feature_{i}"].to(self.opts.dtype)
            enc = getattr(self, f"{attr}_feature_encoders_{i}", None)
            feats.append(enc(feat) if enc is not None else feat)
            i += 1
        return feats

    def _text_embeddings(self, example, prefix: str, identity_ok: bool) -> int:
        """The config's text embeddings over the embedded tokens, registered
        as ``{prefix}_{i}``; returns the concatenated width."""
        vocab, embed, hidden = self._dims()
        self.te_cfgs = _text_emb_cfgs(self.config, hidden, embed)
        width = 0
        for i, tc in enumerate(self.te_cfgs):
            if tc["type"] == "identity" and identity_ok:
                width += example["text"].shape[-1] * embed
                continue
            if tc["type"] not in RUNNABLE_TEXT:
                raise NotImplementedError(
                    f"text embedding {tc['type']!r} in {type(self).__name__}: the model runs "
                    f"{RUNNABLE_TEXT}{' and identity' if identity_ok else ''} (the JAX model "
                    "fails on the others too)")
            mod = text_embedding(tc["type"], embed, **tc.get("params", {}))
            self.add_module(f"{prefix}_{i}", mod)
            width += mod.out_dim
        self.text_prefix = prefix
        return width

    def _text(self, x, gen):
        parts = []
        for i, tc in enumerate(self.te_cfgs):
            mod = getattr(self, f"{self.text_prefix}_{i}", None)
            parts.append(x.reshape(x.shape[0], -1) if mod is None else mod(x, gen))
        return torch.cat(parts, dim=1)

    def init_weights(self, seed: int) -> "_LegacyBase":
        gen = torch.Generator(device=self.opts.device).manual_seed(int(seed))
        pretrained = {f"{n}.{p}" for n, m in self.named_modules()
                      if getattr(m, "PRETRAINED", False) for p, _ in m.named_parameters()}
        params = dict(self.named_parameters())
        with torch.no_grad():
            for name, p in params.items():
                leaf = name.rsplit(".", 1)[-1]
                if name in pretrained:
                    continue
                if leaf in ("g", "h_mat_g"):
                    p.fill_(1.0)
                elif leaf in ("h_mat", "h_mat_v", "h_bias"):
                    p.copy_(torch.empty(p.shape, device=p.device).normal_(0.0, 1.0,
                                                                          generator=gen))
                elif p.dim() < 2:
                    p.zero_()
                else:
                    fan_in = math.prod(p.shape[1:])
                    p.copy_(torch.empty(p.shape, device=p.device).normal_(
                        0.0, 1.0 / math.sqrt(fan_in), generator=gen))
        return self


class Pythia(_LegacyBase):
    """Word embedding -> attention text embeddings -> per-feature top-down
    image embeddings -> modal combine -> logit classifier (reference:
    pythia.py:16-300)."""

    # "full" | "question_only" | "image_only" (pythia.py:301-352)
    MODE = "full"

    def _build(self, example):
        vocab, embed, hidden = self._dims()
        self.word_embedding = nn.Embedding(vocab, embed)
        text_dim = self._text_embeddings(example, "text_embeddings", identity_ok=True)
        image_dim = None
        if self.MODE != "question_only":
            fe_cfgs = _feat_emb_cfgs(self.config, "image_feature_embeddings", hidden)
            self.fe_count = len(fe_cfgs)
            image_dim = 0
            for fi, width in enumerate(self._add_encoders(example, "image")):
                for ei, fe in enumerate(fe_cfgs):
                    emb = ImageEmbedding(width, text_dim, fe["modal_combine"], fe["transform"],
                                         fe.get("normalization", "softmax"))
                    self.add_module(f"image_feature_embeddings_list_{fi}_{ei}", emb)
                    image_dim += emb.out_dim
        context_dim = self._build_context(example, text_dim)
        cc = _plain(cfg_get(self.config, "image_text_modal_combine", None)) or {
            "type": "non_linear_element_multiply",
            "params": {"dropout": 0.0, "hidden_dim": hidden}}
        if self.MODE != "full" and cc["type"] != "non_linear_element_multiply":
            raise NotImplementedError(f"{self.MODE} runs fa_txt / fa_image of the element "
                                      f"multiply combine, not {cc['type']!r}")
        self.image_text_multi_modal_combine_layer = ModalCombineLayer(
            cc["type"], None if self.MODE == "question_only" else image_dim,
            None if self.MODE == "image_only" else text_dim, int(cc["params"]["hidden_dim"]),
            float(cc["params"].get("dropout", 0.0)), context_dim)
        out_dim = self.image_text_multi_modal_combine_layer.out_dim
        in_dim = 2 * out_dim if context_dim is not None else out_dim
        cl = _plain(cfg_get(self.config, "classifier", None)) or {
            "type": str(cfg_get(self.config, "classifier_type", "logit")), "params": {}}
        if self.MODE == "question_only" and cl["type"] != "logit":
            raise NotImplementedError("question_only runs the logit classifier's text branch")
        p = dict(cl.get("params", {}) or {})
        p.setdefault("text_hidden_dim", in_dim)
        p.setdefault("img_hidden_dim", in_dim)
        self.classifier = ClassifierLayer(cl["type"], in_dim, self.num_final_outputs, p,
                                          text_only=self.MODE == "question_only")

    def _build_context(self, example, text_dim: int):
        return None

    def forward(self, batch, gumbel=None, train: bool = False, dropout_gen=None):
        gen = dropout_gen if train else None
        text_total = self._text(self.word_embedding(batch["text"]), gen)
        if self.MODE != "full":
            # reference quirk: both ablations zero the text embedding
            text_total = torch.zeros_like(text_total)
        combine = self.image_text_multi_modal_combine_layer.module
        if self.MODE == "question_only":
            # pythia.py:301-326: no image pass, the logit classifier's text
            # branch over dropout(fa_txt(zeroed text))
            joint = dropout(combine.fa_txt(text_total), combine.dropout, gen)
            return {"scores": self.classifier.module.text(joint).float()}
        locs = batch.get("image_info_0_max_features")
        parts = []
        for fi, feat in enumerate(self._features(batch, "image")):
            for ei in range(self.fe_count):
                emb = getattr(self, f"image_feature_embeddings_list_{fi}_{ei}")
                parts.append(emb(feat, text_total, locs if fi == 0 else None, gen=gen)[0])
        image_total = torch.cat(parts, dim=1)
        if self.MODE == "image_only":
            # pythia.py:329-352: dropout(fa_image(image)), the full classifier
            joint = dropout(combine.fa_image(image_total), combine.dropout, gen)
        else:
            joint = self._combine(batch, image_total, text_total, gen)
        return {"scores": self.classifier(joint, gen).float()}

    def _combine(self, batch, image_total, text_total, gen):
        return self.image_text_multi_modal_combine_layer(image_total, text_total, gen=gen)


@registry.register_model("pythia")
class PythiaModel(Pythia):
    pass


@registry.register_model("pythia_question_only")
class PythiaQuestionOnly(Pythia):
    MODE = "question_only"


@registry.register_model("pythia_image_only")
class PythiaImageOnly(Pythia):
    MODE = "image_only"


@registry.register_model("lorra")
class LoRRA(Pythia):
    """Pythia + the OCR context stream through the same top-down attention
    (its order vectors appended to the context features), combined into a
    doubled joint embedding (reference: lorra.py:9-62)."""

    def _build_context(self, example, text_dim: int):
        _, _, hidden = self._dims()
        ce_cfgs = _feat_emb_cfgs(self.config, "context_feature_embeddings", hidden)
        self.ce_count = len(ce_cfgs)
        order_dim = _width(example, "order_vectors") if "order_vectors" in example else 0
        context_dim = 0
        for fi, width in enumerate(self._add_encoders(example, "context")):
            for ei, fe in enumerate(ce_cfgs):
                emb = ImageEmbedding(width, text_dim, fe["modal_combine"], fe["transform"],
                                     fe.get("normalization", "softmax"), order_dim)
                self.add_module(f"context_feature_embeddings_list_{fi}_{ei}", emb)
                context_dim += emb.out_dim
        return context_dim

    def _combine(self, batch, image_total, text_total, gen):
        order = batch.get("order_vectors")
        parts = []
        for fi, feat in enumerate(self._features(batch, "context")):
            for ei in range(self.ce_count):
                emb = getattr(self, f"context_feature_embeddings_list_{fi}_{ei}")
                parts.append(emb(feat, text_total, None, order_vectors=order, gen=gen)[0])
        return self.image_text_multi_modal_combine_layer(
            image_total, text_total, torch.cat(parts, dim=1), gen=gen)


@registry.register_model("ban")
class BAN(_LegacyBase):
    """Bilinear attention network (reference: ban.py:12-97): BiAttention
    glimpse maps -> per-glimpse BCNet.forward_with_weights fusion -> FCNet
    question refinement -> weight-norm classifier over the summed question
    states."""

    def _build(self, example):
        vocab, embed, hidden = self._dims()
        te = _plain(cfg_get(self.config, "text_embedding", None)) or {
            "num_hidden": hidden, "emb_size": embed, "num_layers": 1, "dropout": 0.0,
            "bidirectional": False, "rnn_type": "GRU"}
        ba = _plain(cfg_get(self.config, "bilinear_attention", None)) or {
            "gamma": int(cfg_get(self.config, "glimpses", 2)), "bc_net": {"k": 1},
            "fc_net": {"activation": "relu", "dropout": 0.0}}
        num_hidden, self.gamma = int(te["num_hidden"]), int(ba["gamma"])
        v_dim = _width(example, "image_feature_0")
        self.word_embedding = nn.Embedding(vocab, embed)
        self.q_emb = BiLSTMTextEmbedding(
            embed, num_hidden, int(te.get("num_layers", 1)), float(te.get("dropout", 0.0)),
            bool(te.get("bidirectional", False)), str(te.get("rnn_type", "GRU")))
        q_dim = self.q_emb.out_dim
        self.v_att = BiAttention(v_dim, q_dim, num_hidden, self.gamma)
        fc = ba.get("fc_net", {}) or {}
        bc_k = int((ba.get("bc_net", {}) or {}).get("k", 1))
        for g in range(self.gamma):
            self.add_module(f"b_net_{g}", BCNet(v_dim, q_dim, num_hidden, None, k=bc_k))
            self.add_module(f"q_prj_{g}", FCNet((num_hidden, num_hidden),
                                                act=str(fc.get("activation", "relu")),
                                                dropout=float(fc.get("dropout", 0.0))))
        cl = _plain(cfg_get(self.config, "classifier", None)) or {"dropout": 0.5}
        self.classifier = WeightNormClassifier(q_dim, num_hidden * 2, self.num_final_outputs,
                                               float(cl.get("dropout", 0.5)))

    def forward(self, batch, gumbel=None, train: bool = False, dropout_gen=None):
        gen = dropout_gen if train else None
        v = batch["image_feature_0"].to(self.opts.dtype)
        q_emb = self.q_emb.forward_all(self.word_embedding(batch["text"]), gen)
        att, _ = self.v_att(v, q_emb, gen=gen)
        for g in range(self.gamma):
            b_emb = getattr(self, f"b_net_{g}").forward_with_weights(v, q_emb, att[:, g], gen)
            q_emb = getattr(self, f"q_prj_{g}")(b_emb[:, None, :], gen) + q_emb
        return {"scores": self.classifier(q_emb.sum(dim=1), gen).float()}


@registry.register_model("top_down_bottom_up")
class TopDownBottomUp(_LegacyBase):
    """The classic TDBU VQA head, built from the same pieces as the JAX
    model (its reference class cannot be constructed,
    top_down_bottom_up.py:14-30): text embeddings -> attention-pooled
    image -> ReLUWithWeightNormFC(text) * ReLUWithWeightNormFC(image) ->
    weight-norm classifier."""

    def _build(self, example):
        vocab, embed, hidden = self._dims()
        self.word_embedding = nn.Embedding(vocab, embed)
        text_dim = self._text_embeddings(example, "text_embedding_models", identity_ok=False)
        v_dim = _width(example, "image_feature_0")
        fe = _feat_emb_cfgs(self.config, "image_feature_embeddings", hidden)[0]
        self.image_attention_model = AttentionLayer(v_dim, text_dim, fe["modal_combine"],
                                                    fe["transform"],
                                                    fe.get("normalization", "softmax"))
        self.non_linear_text = ReLUWithWeightNormFC(text_dim, hidden)
        self.non_linear_image = ReLUWithWeightNormFC(v_dim, hidden)
        self.classifier = WeightNormClassifier(hidden, hidden * 2, self.num_final_outputs, 0.5)

    def forward(self, batch, gumbel=None, train: bool = False, dropout_gen=None):
        gen = dropout_gen if train else None
        text_total = self._text(self.word_embedding(batch["text"]), gen)
        v = batch["image_feature_0"].to(self.opts.dtype)
        attention = self.image_attention_model(v, text_total, gen=gen)
        # reference: sum(attention * image, dim=1)
        image_total = (attention * v).sum(dim=1)
        joint = self.non_linear_text(text_total) * self.non_linear_image(image_total)
        return {"scores": self.classifier(joint, gen).float()}
