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
