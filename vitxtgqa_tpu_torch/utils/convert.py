"""JAX -> port weight conversion.

``from_jax_params`` maps the JAX T2S model's flat parameter dict
(``"qtv/layer_0/query/kernel" -> np.ndarray``, the ``flatten`` form of
vitxtgqa_tpu/utils/torch_convert.py) onto the port's ``state_dict()``.  The
port names its parameters after the reference's torch state dict, so this
is the inverse of vitxtgqa_tpu's ``convert_t2s_like``: flax Dense kernels
[in, out] become Linear weights [out, in], Embed ``embedding`` becomes
``weight``, LayerNorm ``scale`` becomes ``weight``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch


# (torch name, flax name, kind) of the sublayers of one BERT layer
BERT_LAYER = (
    ("attention.self.query", "query", "linear"),
    ("attention.self.key", "key", "linear"),
    ("attention.self.value", "value", "linear"),
    ("attention.output.dense", "attn_out", "linear"),
    ("attention.output.LayerNorm", "attn_ln", "ln"),
    ("intermediate.dense", "ffn_in", "linear"),
    ("output.dense", "ffn_out", "linear"),
    ("output.LayerNorm", "ffn_ln", "ln"),
)


def bert_layer_entries(torch_prefix: str, flax_prefix: str, i: int):
    """Entries of one BERT layer (an empty prefix names a bare encoder)."""
    t = f"{torch_prefix}.layer.{i}" if torch_prefix else f"layer.{i}"
    f = f"{flax_prefix}/layer_{i}" if flax_prefix else f"layer_{i}"
    return [(f"{t}.{tn}", f"{f}/{fn}", kind) for tn, fn, kind in BERT_LAYER]


def _num_layers(flat, flax_prefix: str) -> int:
    pat = re.compile(rf"^{re.escape(flax_prefix)}/layer_(\d+)/")
    ids = {int(m.group(1)) for k in flat for m in [pat.match(k)] if m}
    return max(ids) + 1 if ids else 0


def t2s_entries(flat) -> Iterator[Tuple[str, str, str]]:
    """(torch module name, flax module path, kind) for every T2S module."""
    e, fe = "text_bert.embeddings", "text_bert/embeddings"
    yield from [
        (f"{e}.word_embeddings", f"{fe}/word_embeddings", "embed"),
        (f"{e}.position_embeddings", f"{fe}/position_embeddings", "embed"),
        (f"{e}.token_type_embeddings", f"{fe}/token_type_embeddings", "embed"),
        (f"{e}.LayerNorm", f"{fe}/ln", "ln"),
        ("frame_embeddings", "frame_embeddings", "embed"),
        ("linear_obj_feat_to_mmt_in", "linear_obj_feat_to_mmt_in", "linear"),
        ("obj_feat_layer_norm", "obj_feat_layer_norm", "ln"),
        ("temporal_position_embeddings", "temporal_position_embeddings", "embed"),
        ("track_position_embeddings", "track_position_embeddings", "embed"),
        ("linear_ocr_feat_to_mmt_in", "linear_ocr_feat_to_mmt_in", "linear"),
        ("linear_ocr_bbox_to_mmt_in", "linear_ocr_bbox_to_mmt_in", "linear"),
        ("ocr_feat_layer_norm", "ocr_feat_layer_norm", "ln"),
        ("ocr_bbox_layer_norm", "ocr_bbox_layer_norm", "ln"),
        ("Grounding_Module.q_linear", "grounding/q_linear", "linear"),
        ("Grounding_Module.self_attn", "grounding/self_attn", "linear"),
        ("mmt.prev_pred_embeddings.position_embeddings", "prev_pred_embeddings/position_embeddings", "embed"),
        ("mmt.prev_pred_embeddings.token_type_embeddings", "prev_pred_embeddings/token_type_embeddings", "embed"),
        ("mmt.prev_pred_embeddings.ans_layer_norm", "prev_pred_embeddings/ans_ln", "ln"),
        ("mmt.prev_pred_embeddings.ocr_layer_norm", "prev_pred_embeddings/ocr_ln", "ln"),
        ("mmt.prev_pred_embeddings.emb_layer_norm", "prev_pred_embeddings/emb_ln", "ln"),
        ("ocr_ptr_net.query", "ocr_ptr_net/query", "linear"),
        ("ocr_ptr_net.key", "ocr_ptr_net/key", "linear"),
        ("classifier.module", "classifier", "classifier"),
    ]
    for tp, fp in (("text_bert.encoder", "text_bert/encoder"),
                   ("TransLayer.encoder", "qtv"), ("mmt.encoder", "mmt")):
        for i in range(_num_layers(flat, fp)):
            yield from bert_layer_entries(tp, fp, i)


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX T2S flat params -> the port T2S ``state_dict()`` (float32 CPU
    tensors; ``load_state_dict`` casts them to the model's dtypes)."""
    return convert_entries(flat, t2s_entries(flat))


def convert_entries(flat, entries) -> Dict[str, torch.Tensor]:
    """Apply (torch name, flax path, kind) entries to a flat flax dict (an
    empty flax path names the root module)."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    sd: Dict[str, torch.Tensor] = {}
    for tname, fname, kind in entries:
        leaf = lambda name: flat[f"{fname}/{name}" if fname else name]
        if kind == "linear":
            sd[f"{tname}.weight"] = t(np.asarray(leaf("kernel")).T)
            sd[f"{tname}.bias"] = t(leaf("bias"))
        elif kind == "ln":
            sd[f"{tname}.weight"] = t(leaf("scale"))
            sd[f"{tname}.bias"] = t(leaf("bias"))
        elif kind == "embed":
            sd[f"{tname}.weight"] = t(leaf("embedding"))
        else:  # the classifier keeps [out, in] in both frameworks
            sd[f"{tname}.weight"] = t(leaf("weight"))
            sd[f"{tname}.bias"] = t(leaf("bias"))
    return sd


# (HF ViTModel name, flax name, kind) of the sublayers of one ViT layer
VIT_LAYER = (
    ("attention.attention.query", "query", "linear"),
    ("attention.attention.key", "key", "linear"),
    ("attention.attention.value", "value", "linear"),
    ("attention.output.dense", "attn_out", "linear"),
    ("layernorm_before", "ln1", "ln"),
    ("intermediate.dense", "mlp_in", "linear"),
    ("output.dense", "mlp_out", "linear"),
    ("layernorm_after", "ln2", "ln"),
)


def vit_from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX ViT flat params (vitxtgqa_tpu.models.vit.ViT) -> the port ViT
    ``state_dict()``: the inverse of vitxtgqa_tpu's convert_vit_state.  The
    flax patchify kernel [p, p, 3, D] becomes the Conv2d weight [D, 3, p,
    p]; the CLS token and positions keep their [1, n, D] shapes."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    entries = [("layernorm", "ln_final", "ln")]
    layers = {int(k.split("/")[0][len("layer_"):]) for k in flat if k.startswith("layer_")}
    for i in range(len(layers)):
        entries += [(f"encoder.layer.{i}.{tn}", f"layer_{i}/{fn}", kind)
                    for tn, fn, kind in VIT_LAYER]
    sd = convert_entries(flat, entries)
    sd["embeddings.patch_embeddings.projection.weight"] = t(
        np.asarray(flat["patch_embed/kernel"]).transpose(3, 2, 0, 1))
    sd["embeddings.patch_embeddings.projection.bias"] = t(flat["patch_embed/bias"])
    sd["embeddings.cls_token"] = t(flat["cls_token"])
    sd["embeddings.position_embeddings"] = t(flat["pos_embedding"])
    return sd


def strip_vit_prefix(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF ViT checkpoint's state dict -> the port ViT's: a ``{"model":
    state_dict, ...}`` checkpoint blob unwrapped and DataParallel
    ``module.`` prefixes stripped, as vitxtgqa_tpu's load_state_dict does;
    the ``vit.`` prefix of a model with a head (ViTForImageClassification)
    dropped, as its convert_vit_state drops it; and the pooler and the
    head, which the extractor does not use, left out."""
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        k = k[len("vit."):] if k.startswith("vit.") else k
        if not k.startswith(("pooler.", "classifier.")):
            out[k] = v
    return out
