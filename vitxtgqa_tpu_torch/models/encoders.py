"""Image feature encoders.

Counterpart of vitxtgqa_tpu/models/encoders.py (reference:
pythia/modules/encoders.py:12-60): ``default`` passes the features
through; ``finetune_faster_rcnn_fpn_fc7`` is a Linear + ReLU whose weight
and bias start from the pickled numpy arrays shipped with the detectron
feature dumps (read from ``model_data_dir``) and are finetuned from there.
``build_image_encoder`` returns ``(module, out_dim)``.
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class IdentityEncoder(nn.Module):
    """``default`` encoder (reference: encoders.py:16-19)."""

    def forward(self, x):
        return x


class FinetuneFasterRcnnFpnFc7(nn.Linear):
    """fc7 finetune head: a Linear initialised from the pickled detectron
    weights ([out, in], torch's layout), then ReLU (reference:
    encoders.py:31-55).  ``PRETRAINED``: the model's seeded init leaves it."""

    PRETRAINED = True

    def __init__(self, w0: np.ndarray, b0: np.ndarray):
        super().__init__(w0.shape[1], w0.shape[0])
        with torch.no_grad():
            self.weight.copy_(torch.from_numpy(np.ascontiguousarray(w0, np.float32)))
            self.bias.copy_(torch.from_numpy(np.ascontiguousarray(b0, np.float32)))

    def forward(self, x):
        # in x's dtype, as JAX's (x @ w.astype(x.dtype) + b.astype(x.dtype))
        return F.relu(F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype))


def _resolve(path: str, model_data_dir: str) -> str:
    if not os.path.isabs(path) and model_data_dir:
        return os.path.join(model_data_dir, path)
    return path


def build_image_encoder(encoder_type: str, in_dim: int, *, weights_file: str = "",
                        bias_file: str = "", model_data_dir: str = "",
                        **_unused) -> Tuple[nn.Module, int]:
    """The reference ``ImageEncoder.__init__`` dispatch (encoders.py:14-24):
    ``(module, out_dim)``."""
    if encoder_type == "default":
        return IdentityEncoder(), int(in_dim)
    if encoder_type == "finetune_faster_rcnn_fpn_fc7":
        with open(_resolve(weights_file, model_data_dir), "rb") as f:
            w = np.asarray(pickle.load(f), dtype=np.float32)
        with open(_resolve(bias_file, model_data_dir), "rb") as f:
            b = np.asarray(pickle.load(f), dtype=np.float32)
        if w.shape[0] != b.shape[0] and w.shape[1] == b.shape[0]:
            # tolerate [in, out]-stored dumps; the reference assumes [out, in]
            w = w.T
        assert w.shape == (b.shape[0], in_dim), (w.shape, b.shape, in_dim)
        return FinetuneFasterRcnnFpnFc7(w, b), int(b.shape[0])
    raise NotImplementedError(f"Unknown Image Encoder: {encoder_type}")
