"""JAX -> port weight conversion.

``from_jax_params`` maps the JAX T2S model's flat parameter dict
(``"qtv/layer_0/query/kernel" -> np.ndarray``, the ``flatten`` form of
vitxtgqa_tpu/utils/torch_convert.py) onto the port's ``state_dict()``;
``from_jax_family_params`` does so for any of the zoo's video models
(t2s, its ablations, m4c, t5vitevqa, gt_box, transtr, mist), by the
model's flags (``FAMILY_FLAGS``: QTV, grounding, post-hoc head, frame-id
embedding, OCR ids, selector).  The port names its parameters after the
reference's torch state dict, so these are the inverses of vitxtgqa_tpu's
``convert_t2s_like`` with the same flags, of its ``convert_transtr`` (the
selector's DETR decoders, ``selector_entries``) and of its
``convert_mist`` (the question pooling and the ISTA selectors): flax Dense
kernels [in, out] become Linear weights [out, in], Embed ``embedding``
becomes ``weight``, LayerNorm ``scale`` becomes ``weight``.  The legacy
image-VQA models (pythia and its ablations, lorra, ban,
top_down_bottom_up) are mapped from their flat keys alone
(``legacy_entries``), their RNN cells onto torch's stacked LSTM / GRU
weights.  ``from_jax_mist_text_params`` maps MIST's auxiliary modules
(models/mist_text.py) and ``clip_state_dict_from_jax`` turns the JAX
CLIP's variables into OpenAI's state-dict layout (models/clip.py), the
inverse of vitxtgqa_tpu's build_clip_params.  The results are whole tensors: a tensor-parallel model
(Options.tp) loads its shards of them through
parallel/tensor_parallel.local_state.
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


def _num_layers(flat, flax_prefix: str, layer: str = "layer_") -> int:
    """The number of ``{flax_prefix}/{layer}{i}`` modules (an empty prefix:
    at the root)."""
    root = f"{re.escape(flax_prefix)}/" if flax_prefix else ""
    pat = re.compile(rf"^{root}{layer}(\d+)/")
    ids = {int(m.group(1)) for k in flat for m in [pat.match(k)] if m}
    return max(ids) + 1 if ids else 0


# convert_t2s_like's flags for each model of the family
T2S_FLAGS = dict(has_qtv=True, has_grounding=True, has_posthoc=False, obj_has_frame_embed=True,
                 ocr_has_ids=True)
FAMILY_FLAGS = {
    "t2s": T2S_FLAGS, "t2s_wo_tg": T2S_FLAGS, "t2s_wo_sg": T2S_FLAGS,
    "m4c": dict(has_qtv=False, has_grounding=False, has_posthoc=True, obj_has_frame_embed=False,
                ocr_has_ids=False),
    "t5vitevqa": dict(has_qtv=False, has_grounding=False, has_posthoc=True,
                      obj_has_frame_embed=True, ocr_has_ids=True),
    "gt_box": dict(has_qtv=False, has_grounding=False, has_posthoc=False,
                   obj_has_frame_embed=True, ocr_has_ids=True),
}
FAMILY_FLAGS["T2S_human"] = FAMILY_FLAGS["gt_box"]
# TranSTR and MIST: T2S's streams and decoder heads without QTV or
# grounding, with their selector (``VideoQAmodel``)
for _key in ("transtr", "mist"):
    FAMILY_FLAGS[_key] = dict(has_qtv=False, has_grounding=False, has_posthoc=False,
                              obj_has_frame_embed=True, ocr_has_ids=True, selector=_key)


def _detr_entries(flat, torch_prefix: str, flax_prefix: str):
    """A DETR decoder stack (models/detr.DetrDecoder): the reference's
    ``multihead_attn`` is the JAX module's ``cross_attn``."""
    for i in range(_num_layers(flat, flax_prefix)):
        t, f = f"{torch_prefix}.layers.{i}", f"{flax_prefix}/layer_{i}"
        for tattn, fattn in (("self_attn", "self_attn"), ("multihead_attn", "cross_attn")):
            for lin in ("q_lin", "k_lin", "v_lin", "out_lin"):
                yield (f"{t}.{tattn}.{lin}", f"{f}/{fattn}/{lin}", "linear")
        yield from [(f"{t}.linear1", f"{f}/linear1", "linear"),
                    (f"{t}.linear2", f"{f}/linear2", "linear")]
        yield from [(f"{t}.norm{j}", f"{f}/norm{j}", "ln") for j in (1, 2, 3)]
    yield (f"{torch_prefix}.norm", f"{flax_prefix}/norm", "ln")


def selector_entries(flat, selector: str):
    """The ``VideoQAmodel`` selector of TranSTR (its resizer and three DETR
    decoders) or of MIST (the question pooling, each ISTA round's two
    selectors)."""
    v = "VideoQAmodel"
    if selector == "transtr":
        yield from [(f"{v}.ocr_resize.fc", "selector/ocr_resize/Dense_0", "linear"),
                    (f"{v}.ocr_resize.layer_norm", "selector/ocr_resize/LayerNorm_0", "ln")]
        for dec in ("frame_decoder", "ocr_decoder", "fo_decoder"):
            yield from _detr_entries(flat, f"{v}.{dec}", f"selector/{dec}")
        return
    yield (f"{v}.self_attn", "q_self_attn", "linear")
    for i in range(_num_layers(flat, "", "ista_")):
        for sel in ("seg_selector", "reg_selector"):
            t, f = f"{v}.ISTA.{i}.{sel}", f"ista_{i}/{sel}"
            yield from [(f"{t}.linear_Q", f"{f}/linear_Q", "linear"),
                        (f"{t}.norm_Q", f"{f}/norm_Q", "ln"),
                        (f"{t}.linear_K", f"{f}/linear_K", "linear"),
                        (f"{t}.norm_K", f"{f}/norm_K", "ln")]


def family_entries(flat, has_qtv: bool = True, has_grounding: bool = True,
                   has_posthoc: bool = False, obj_has_frame_embed: bool = True,
                   ocr_has_ids: bool = True, selector: str = None
                   ) -> Iterator[Tuple[str, str, str]]:
    """(torch module name, flax module path, kind) for every module of a
    zoo model with these flags (``selector``: "transtr" or "mist")."""
    e, fe = "text_bert.embeddings", "text_bert/embeddings"
    yield from [
        (f"{e}.word_embeddings", f"{fe}/word_embeddings", "embed"),
        (f"{e}.position_embeddings", f"{fe}/position_embeddings", "embed"),
        (f"{e}.token_type_embeddings", f"{fe}/token_type_embeddings", "embed"),
        (f"{e}.LayerNorm", f"{fe}/ln", "ln"),
    ]
    if obj_has_frame_embed:
        yield ("frame_embeddings", "frame_embeddings", "embed")
    yield from [
        ("linear_obj_feat_to_mmt_in", "linear_obj_feat_to_mmt_in", "linear"),
        ("obj_feat_layer_norm", "obj_feat_layer_norm", "ln"),
    ]
    if ocr_has_ids:
        yield from [
            ("temporal_position_embeddings", "temporal_position_embeddings", "embed"),
            ("track_position_embeddings", "track_position_embeddings", "embed"),
        ]
    yield from [
        ("linear_ocr_feat_to_mmt_in", "linear_ocr_feat_to_mmt_in", "linear"),
        ("linear_ocr_bbox_to_mmt_in", "linear_ocr_bbox_to_mmt_in", "linear"),
        ("ocr_feat_layer_norm", "ocr_feat_layer_norm", "ln"),
        ("ocr_bbox_layer_norm", "ocr_bbox_layer_norm", "ln"),
    ]
    heads = ([("Grounding_Module", "grounding")] if has_grounding else []) + (
        [("PostHoc", "posthoc")] if has_posthoc else [])
    for tp, fp in heads:
        yield from [(f"{tp}.q_linear", f"{fp}/q_linear", "linear"),
                    (f"{tp}.self_attn", f"{fp}/self_attn", "linear")]
    if selector:
        yield from selector_entries(flat, selector)
    yield from [
        ("mmt.prev_pred_embeddings.position_embeddings", "prev_pred_embeddings/position_embeddings", "embed"),
        ("mmt.prev_pred_embeddings.token_type_embeddings", "prev_pred_embeddings/token_type_embeddings", "embed"),
        ("mmt.prev_pred_embeddings.ans_layer_norm", "prev_pred_embeddings/ans_ln", "ln"),
        ("mmt.prev_pred_embeddings.ocr_layer_norm", "prev_pred_embeddings/ocr_ln", "ln"),
        ("mmt.prev_pred_embeddings.emb_layer_norm", "prev_pred_embeddings/emb_ln", "ln"),
        ("ocr_ptr_net.query", "ocr_ptr_net/query", "linear"),
        ("ocr_ptr_net.key", "ocr_ptr_net/key", "linear"),
        ("classifier.module", "classifier", "classifier"),
    ]
    stacks = [("text_bert.encoder", "text_bert/encoder")]
    stacks += [("TransLayer.encoder", "qtv")] if has_qtv else []
    for tp, fp in stacks + [("mmt.encoder", "mmt")]:
        for i in range(_num_layers(flat, fp)):
            yield from bert_layer_entries(tp, fp, i)


# the legacy image-VQA models (models/legacy_vqa.py): their port modules
# carry the flax module names, so their entries follow from the flat keys
LEGACY_MODELS = ("pythia", "pythia_question_only", "pythia_image_only", "lorra", "ban",
                 "top_down_bottom_up")
# flax RNN cells: the gate Dense names in torch's gate order
RNN_GATES = {"lstm": "ifgo", "gru": "rzn"}
_CELL = re.compile(r"^(.*)/(fwd|bwd)_(\d+)/([ih][a-z])/(kernel|bias)$")


def legacy_entries(flat) -> Iterator[Tuple[str, str, str]]:
    """(torch name, flax path, kind) of a legacy model's flat params: a
    module path keeps its names ("/" -> "."); Dense and Conv ``kernel`` /
    ``bias`` and Embed ``embedding`` take torch's names and layouts, a
    weight-normed linear's ``v`` is transposed ("wn"), BCNet's ``h_mat*``
    / ``h_bias`` pass as they are, and each LSTM / GRU cell (``fwd_<k>`` /
    ``bwd_<k>`` of a stacked RNN) becomes the RNN's stacked weights of
    layer k ("lstm" / "gru")."""
    done = set()
    for key in sorted(flat):
        cell = _CELL.match(key)
        if cell:
            mod, direction, layer = cell.group(1), cell.group(2), cell.group(3)
            path = f"{mod}/{direction}_{layer}"
            if path not in done:
                done.add(path)
                kind = "lstm" if f"{path}/ii/kernel" in flat else "gru"
                sfx = f"_l{layer}" + ("_reverse" if direction == "bwd" else "")
                yield (f"{mod.replace('/', '.')}|{sfx}", path, kind)
            continue
        mod, leaf = key.rsplit("/", 1) if "/" in key else ("", key)
        tmod = mod.replace("/", ".")
        if leaf == "kernel":
            kind = "conv1d" if np.ndim(flat[key]) == 3 else "linear"
            if (tmod, kind) not in done:
                done.add((tmod, kind))
                yield (tmod, mod, kind)
        elif leaf == "embedding":
            yield (tmod, mod, "embed")
        elif leaf == "v":
            yield (tmod, mod, "wn")
        elif leaf in ("h_mat", "h_mat_v", "h_mat_g", "h_bias"):
            yield (f"{tmod}.{leaf}", key, "param")
        elif leaf not in ("bias", "g", "b"):
            raise KeyError(f"legacy_entries: no rule for {key}")


def _rnn_cell(cell: Dict[str, np.ndarray], kind: str) -> Dict[str, np.ndarray]:
    """A flax cell's gate Dense params ({"ii/kernel": ..., ...}) -> the port
    StackedRNN's weights of one layer and direction (models/embeddings.py):
    the gates stacked in torch's order, and the biases the cell has."""
    gates = RNN_GATES[kind]
    out = {"weight_ih": np.concatenate([np.asarray(cell[f"i{g}/kernel"]).T for g in gates]),
           "weight_hh": np.concatenate([np.asarray(cell[f"h{g}/kernel"]).T for g in gates])}
    if kind == "lstm":
        out["bias"] = np.concatenate([np.asarray(cell[f"h{g}/bias"]) for g in gates])
    else:
        out["bias_ih"] = np.concatenate([np.asarray(cell[f"i{g}/bias"]) for g in gates])
        out["bias_hn"] = np.asarray(cell["hn/bias"])
    return out


def from_jax_family_params(flat: Dict[str, np.ndarray], model: str) -> Dict[str, torch.Tensor]:
    """The JAX flat params of the registered ``model`` (a key of
    FAMILY_FLAGS or LEGACY_MODELS) -> the port model's ``state_dict()``
    (float32 CPU tensors; ``load_state_dict`` casts them to the model's
    dtypes)."""
    if model in LEGACY_MODELS:
        return convert_entries(flat, legacy_entries(flat))
    return convert_entries(flat, family_entries(flat, **FAMILY_FLAGS[model]))


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX T2S flat params -> the port T2S ``state_dict()``."""
    return from_jax_family_params(flat, "t2s")


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
        elif kind == "conv1d":  # flax [k, in, out] -> torch [out, in, k]
            sd[f"{tname}.weight"] = t(np.asarray(leaf("kernel")).transpose(2, 1, 0))
            sd[f"{tname}.bias"] = t(leaf("bias"))
        elif kind == "wn":  # weight norm: v [in, out] -> [out, in]; g, b as they are
            sd[f"{tname}.v"] = t(np.asarray(leaf("v")).T)
            sd[f"{tname}.g"] = t(leaf("g"))
            sd[f"{tname}.b"] = t(leaf("b"))
        elif kind == "param":
            sd[tname] = t(flat[fname])
        elif kind in RNN_GATES:
            mod, sfx = tname.split("|")
            cell = {k[len(fname) + 1:]: v for k, v in flat.items() if k.startswith(fname + "/")}
            for name, w in _rnn_cell(cell, kind).items():
                sd[f"{mod}.{name}{sfx}"] = t(w)
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


# the JAX mist_text modules (vitxtgqa_tpu/models/mist_text.py) by the
# port's class names; MistBert's TextEncoder sits at "bert", AModel's at
# "bert/bert"
MIST_TEXT_MODULES = ("DistilTransformer", "FusionEmbeddings", "PositionEmbeddings",
                     "TokenTypeEmbeddings", "EncoderVid", "SentenceMaxpool", "MistBert", "AModel")


def _text_encoder_entries(flat, torch_prefix: str, flax_prefix: str):
    e, fe = f"{torch_prefix}.embeddings", f"{flax_prefix}/embeddings"
    yield from [(f"{e}.word_embeddings", f"{fe}/word_embeddings", "embed"),
                (f"{e}.position_embeddings", f"{fe}/position_embeddings", "embed"),
                (f"{e}.token_type_embeddings", f"{fe}/token_type_embeddings", "embed"),
                (f"{e}.LayerNorm", f"{fe}/ln", "ln")]
    for i in range(_num_layers(flat, f"{flax_prefix}/encoder")):
        yield from bert_layer_entries(f"{torch_prefix}.encoder", f"{flax_prefix}/encoder", i)


def from_jax_mist_text_params(flat: Dict[str, np.ndarray], module: str,
                              batch_stats: Dict[str, np.ndarray] = None
                              ) -> Dict[str, torch.Tensor]:
    """The flat params of a JAX mist_text module (``module``: its class
    name, MIST_TEXT_MODULES) -> the port module's ``state_dict()``;
    EncoderVid's BatchNorm running statistics come from ``batch_stats``
    (its flat ``batch_stats`` collection).  Dense kernels over channels
    become the 1x1 convolutions' [out, in, 1, 1] weights."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    if module == "DistilTransformer":
        entries = []
        for i in range(_num_layers(flat, "")):
            f = f"layer_{i}"
            entries += [(f"layer.{i}.attention.{n}", f"{f}/attention/{n}", "linear")
                        for n in ("q_lin", "k_lin", "v_lin", "out_lin")]
            entries += [(f"layer.{i}.sa_layer_norm", f"{f}/sa_layer_norm", "ln"),
                        (f"layer.{i}.ffn.lin1", f"{f}/ffn/lin1", "linear"),
                        (f"layer.{i}.ffn.lin2", f"{f}/ffn/lin2", "linear"),
                        (f"layer.{i}.output_layer_norm", f"{f}/output_layer_norm", "ln")]
        return convert_entries(flat, entries)
    if module == "FusionEmbeddings":
        return {"position_embeddings.weight": t(flat["position_embeddings"]),
                "modality_embedding.weight": t(flat["modality_embedding"]),
                **convert_entries(flat, [("LayerNorm", "LayerNorm", "ln")])}
    if module == "PositionEmbeddings":
        return {"position_embeddings.weight": t(flat["position_embeddings"])}
    if module == "TokenTypeEmbeddings":
        return {"modality_embedding.weight": t(flat["modality_embedding"])}
    if module == "EncoderVid":
        sd = convert_entries(flat, [("tohid.0", "tohid", "linear")])
        for conv, bn, fi in ((0, 1, 1), (3, 4, 2)):
            sd[f"bbox_conv.{conv}.weight"] = t(np.asarray(flat[f"bbox_conv{fi}/kernel"]).T[:, :, None, None])
            sd[f"bbox_conv.{conv}.bias"] = t(flat[f"bbox_conv{fi}/bias"])
            sd[f"bbox_conv.{bn}.weight"] = t(flat[f"bbox_bn{fi}/scale"])
            sd[f"bbox_conv.{bn}.bias"] = t(flat[f"bbox_bn{fi}/bias"])
            sd[f"bbox_conv.{bn}.running_mean"] = t(batch_stats[f"bbox_bn{fi}/mean"])
            sd[f"bbox_conv.{bn}.running_var"] = t(batch_stats[f"bbox_bn{fi}/var"])
            sd[f"bbox_conv.{bn}.num_batches_tracked"] = torch.tensor(0)
        return sd
    if module == "SentenceMaxpool":
        return convert_entries(flat, [("fc", "fc", "linear")])
    if module == "MistBert":
        return convert_entries(flat, _text_encoder_entries(flat, "bert", "bert"))
    if module == "AModel":
        return convert_entries(flat, [*_text_encoder_entries(flat, "bert.bert", "bert/bert"),
                                      ("linear_text", "linear_text", "linear")])
    raise KeyError(f"{module}: not one of {MIST_TEXT_MODULES}")


def _clip_block(sd: dict, p: str, blk: dict) -> None:
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    lin = lambda a: t(np.asarray(a).T)
    sd[f"{p}.ln_1.weight"], sd[f"{p}.ln_1.bias"] = t(blk["ln_1"]["scale"]), t(blk["ln_1"]["bias"])
    sd[f"{p}.attn.in_proj_weight"] = lin(blk["attn_in"]["kernel"])
    sd[f"{p}.attn.in_proj_bias"] = t(blk["attn_in"]["bias"])
    sd[f"{p}.attn.out_proj.weight"] = lin(blk["attn_out"]["kernel"])
    sd[f"{p}.attn.out_proj.bias"] = t(blk["attn_out"]["bias"])
    sd[f"{p}.ln_2.weight"], sd[f"{p}.ln_2.bias"] = t(blk["ln_2"]["scale"]), t(blk["ln_2"]["bias"])
    for n in ("c_fc", "c_proj"):
        sd[f"{p}.mlp.{n}.weight"] = lin(blk[n]["kernel"])
        sd[f"{p}.mlp.{n}.bias"] = t(blk[n]["bias"])


def clip_state_dict_from_jax(variables: dict) -> Dict[str, torch.Tensor]:
    """The JAX CLIP's variables ({"params": ..., "batch_stats": ...}, the
    nested trees of vitxtgqa_tpu's build_clip_params) -> a CLIP state dict
    in OpenAI's layout (models/clip.py): build_clip_params' inverse.  The
    flax convolution kernels [kh, kw, in, out] become [out, in, kh, kw],
    the Dense kernels transposed; flax counts no BatchNorm batches, so each
    ``num_batches_tracked`` is 0."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    conv = lambda a: t(np.asarray(a).transpose(3, 2, 0, 1))
    lin = lambda a: t(np.asarray(a).T)
    params, stats = variables["params"], variables.get("batch_stats", {})
    vis, sd = params["visual"], {}

    def bn(name: str, p: dict, s: dict) -> None:
        sd[f"{name}.weight"], sd[f"{name}.bias"] = t(p["scale"]), t(p["bias"])
        sd[f"{name}.running_mean"], sd[f"{name}.running_var"] = t(s["mean"]), t(s["var"])
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    if "proj" in vis:  # the ViT tower
        sd["visual.conv1.weight"] = conv(vis["conv1"]["kernel"])
        for name in ("class_embedding", "positional_embedding", "proj"):
            sd[f"visual.{name}"] = t(vis[name])
        for ln in ("ln_pre", "ln_post"):
            sd[f"visual.{ln}.weight"], sd[f"visual.{ln}.bias"] = (t(vis[ln]["scale"]),
                                                                    t(vis[ln]["bias"]))
        for i in range(len(vis["transformer"])):
            _clip_block(sd, f"visual.transformer.resblocks.{i}",
                        vis["transformer"][f"resblock_{i}"])
    else:  # ModifiedResNet
        vs = stats["visual"]
        for i in (1, 2, 3):
            sd[f"visual.conv{i}.weight"] = conv(vis[f"conv{i}"]["kernel"])
            bn(f"visual.bn{i}", vis[f"bn{i}"], vs[f"bn{i}"])
        for stage in (1, 2, 3, 4):
            blk = 0
            while f"layer{stage}_{blk}" in vis:
                fp, tp = f"layer{stage}_{blk}", f"visual.layer{stage}.{blk}"
                bp, bs = vis[fp], vs[fp]
                for j in (1, 2, 3):
                    sd[f"{tp}.conv{j}.weight"] = conv(bp[f"conv{j}"]["kernel"])
                    bn(f"{tp}.bn{j}", bp[f"bn{j}"], bs[f"bn{j}"])
                if "downsample_conv" in bp:
                    sd[f"{tp}.downsample.0.weight"] = conv(bp["downsample_conv"]["kernel"])
                    bn(f"{tp}.downsample.1", bp["downsample_bn"], bs["downsample_bn"])
                blk += 1
        ap = vis["attnpool"]
        sd["visual.attnpool.positional_embedding"] = t(ap["positional_embedding"])
        for n in ("q_proj", "k_proj", "v_proj", "c_proj"):
            sd[f"visual.attnpool.{n}.weight"] = lin(ap[n]["kernel"])
            sd[f"visual.attnpool.{n}.bias"] = t(ap[n]["bias"])
    for i in range(len(params["transformer"])):
        _clip_block(sd, f"transformer.resblocks.{i}", params["transformer"][f"resblock_{i}"])
    sd["token_embedding.weight"] = t(params["token_embedding"]["embedding"])
    sd["positional_embedding"] = t(params["positional_embedding"])
    sd["ln_final.weight"] = t(params["ln_final"]["scale"])
    sd["ln_final.bias"] = t(params["ln_final"]["bias"])
    sd["text_projection"] = t(params["text_projection"])
    sd["logit_scale"] = t(np.asarray(params["logit_scale"]).reshape(()))
    return sd
