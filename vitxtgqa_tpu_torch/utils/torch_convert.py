"""The reference's released state dicts in the port.

Counterpart of vitxtgqa_tpu/utils/torch_convert.py without its flax trees:
the port names its parameters after the reference's torch state dict
(models/common.py, utils/convert.py), so a released checkpoint maps onto a
port model name for name.  What the JAX converter does beside renaming is
kept:
  * only the model's live names are read; the reference's dead parameters
    (the grounding indicator linears, ``frame_attn``, the never-called
    grounding encoder, the obj_frame projections, TranSTR's and MIST's
    unused towers and projections) are dropped and returned, never an
    error;
  * the classifier is read as ``classifier.module.*`` or, failing that,
    ``classifier.*`` (the JAX converter's ``cls_key``);
  * a missing live name or a shape that differs raises.
HF ViT checkpoints load through video_feat's ``--weights``
(utils/convert.strip_vit_prefix).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from vitxtgqa_tpu_torch.parallel.tensor_parallel import local_state, sharded_dims
from vitxtgqa_tpu_torch.training.checkpoint import unwrap_state_dict

CLASSIFIER, CLASSIFIER_ALIAS = "classifier.module.", "classifier."


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file as {name: tensor} on the CPU, the
    reference's {"model": state_dict, ...} and DataParallel ``module.``
    prefixes unwrapped (reference: pythia/utils/checkpoint.py:98-116)."""
    return unwrap_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def _aliases(name: str) -> Tuple[str, ...]:
    if name.startswith(CLASSIFIER):
        return name, CLASSIFIER_ALIAS + name[len(CLASSIFIER):]
    return (name,)


def reference_state(sd: Dict[str, object], model: torch.nn.Module
                    ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(the port state dict of ``model`` read from the reference dict
    ``sd``, the names of ``sd`` it dropped).  Every parameter of the model
    is read under its own name or its alias; a persistent buffer that
    ``sd`` lacks keeps the model's value.  Values keep their dtype:
    ``load_state_dict`` casts them to the model's.  A tensor-parallel
    model's shards are read whole (their shape times the model
    group along the shard dim): tensor_parallel.local_state takes the
    rank's part."""
    own = model.state_dict()
    params = {name for name, _ in model.named_parameters()}
    tp = getattr(getattr(model, "opts", None), "tp", None)
    for name, dim in sharded_dims(model).items():
        shape = list(own[name].shape)
        shape[dim] *= tp.size
        own[name] = own[name].new_empty(shape)
    state, used, missing = {}, set(), []
    for name, current in own.items():
        src = next((a for a in _aliases(name) if a in sd), None)
        if src is None:
            if name in params:
                missing.append(name)
            else:
                state[name] = current
            continue
        value = sd[src]
        value = value if torch.is_tensor(value) else torch.from_numpy(np.asarray(value))
        if tuple(value.shape) != tuple(current.shape):
            raise ValueError(f"{src}: shape {tuple(value.shape)} != the model's "
                             f"{name} {tuple(current.shape)}")
        state[name] = value
        used.add(src)
    if missing:
        raise KeyError(f"{len(missing)} parameters of the model are not in the state dict: "
                       f"{missing}")
    return state, sorted(n for n in sd if n not in used)


def load_reference_weights(model: torch.nn.Module, path: str) -> List[str]:
    """Load a reference (or port) torch file into ``model``; returns the
    names it dropped."""
    state, dropped = reference_state(load_state_dict(path), model)
    model.load_state_dict(local_state(model, state))
    return dropped
