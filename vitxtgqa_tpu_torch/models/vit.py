"""Vision Transformer frame-feature extraction: raw frames to one CLS
feature per frame, the ``video_feat`` rows of a T2S request.

Counterpart of vitxtgqa_tpu/models/vit.py (the reference's offline HF
pipeline, tools/video_feat/obtain_vit_feat.py: ViT-L/16-224-in21k, CLS ->
[1, 1024] per frame).  Frames batch through one forward: ``preprocess_frames``
(uint8 -> resized, normalised), the patch embedding, the CLS token and
positions, pre-LN encoder layers, a final LayerNorm.

What runs where on CUDA: in every layer the MLP through the fused FFN
kernel (ops/ffn.py) where the JAX gate holds (eval, lane-aligned widths,
>= 2048 rows: ViT-L/16 at 224 px from 11 frames), and the self-attention
through the bias-tensor kernel (ops/fused_attention.py) where the token
count reaches 256 (ViT-L/16 at 384 px, 577 tokens; not at 224 px, 197
tokens; ViT-H/14 at 224 px, 257 tokens of 16 heads of 80).  On CPU tensors the kernel ops run their plain versions;
``Options(plain=True)`` runs the plain versions on the card along the same
branches.

Parameter names are HF ``ViTModel``'s state-dict names
(``embeddings.patch_embeddings.projection``, ``encoder.layer.{i}.attention
.attention.query``, ``...layernorm_before``, ``layernorm``, ...): a
checkpoint of the reference's extractor loads with ``load_state_dict``
after utils/convert.strip_vit_prefix, and vitxtgqa_tpu's
``convert_vit_state`` maps a port ``state_dict()`` onto the JAX params.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vitxtgqa_tpu_torch.models.common import LayerNorm, Linear
from vitxtgqa_tpu_torch.ops import ffn as FFN
from vitxtgqa_tpu_torch.ops.attention import merge_heads, mha, split_heads
from vitxtgqa_tpu_torch.options import Options


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    ln_eps: float = 1e-12

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


VIT_L_16 = ViTConfig()  # the reference's feature extractor
VIT_B_32 = ViTConfig(
    patch_size=32, hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
    ln_eps=1e-5,
)  # CLIP tower geometry
# google/vit-huge-patch14-224-in21k's config.json: 16 heads of 80, 257
# tokens at 224 px (the bias-tensor attention at head width 80 in every layer)
VIT_H_14 = ViTConfig(
    patch_size=14, hidden_size=1280, num_layers=32, num_heads=16, mlp_dim=5120,
    ln_eps=1e-12,
)
# the frame-feature backbones by name (video_feat --model)
VIT_CONFIGS = {"vit_l_16": VIT_L_16, "vit_h_14": VIT_H_14}


class ViTLayer(nn.Module):
    """Pre-LN transformer block (ViT/CLIP style)."""

    def __init__(self, cfg: ViTConfig, opts: Options):
        super().__init__()
        self.cfg, self.opts = cfg, opts
        d, m = cfg.hidden_size, cfg.mlp_dim
        self.attention = nn.ModuleDict({
            "attention": nn.ModuleDict({
                "query": Linear(d, d), "key": Linear(d, d), "value": Linear(d, d),
            }),
            "output": nn.ModuleDict({"dense": Linear(d, d)}),
        })
        self.intermediate = nn.ModuleDict({"dense": Linear(d, m)})
        self.output = nn.ModuleDict({"dense": Linear(m, d)})
        self.layernorm_before = LayerNorm(d, eps=cfg.ln_eps)
        self.layernorm_after = LayerNorm(d, eps=cfg.ln_eps)

    def mlp(self, h, deterministic: bool = True):
        """gelu(h W1^T + b1) W2^T + b2: the fused FFN under the JAX gate
        (vit.py ViTEncoderLayer._mlp: eval only, ffn_kernel_ok), else the
        two Linear layers around an exact-erf gelu."""
        w_in, w_out = self.intermediate["dense"], self.output["dense"]
        rows = h.numel() // h.shape[-1]
        if deterministic and FFN.ffn_kernel_ok(self.cfg.hidden_size, self.cfg.mlp_dim, rows):
            fn = FFN.fused_ffn_plain if self.opts.plain else FFN.fused_ffn
            return fn(h, w_in.weight, w_in.bias, w_out.weight, w_out.bias)
        return w_out(F.gelu(w_in(h)))

    def forward(self, x, deterministic: bool = True):
        heads = self.cfg.num_heads
        sa = self.attention["attention"]
        h = self.layernorm_before(x)
        q, k, v = (split_heads(sa[n](h), heads) for n in ("query", "key", "value"))
        ctx = mha(q, k, v, plain=self.opts.plain, sp=self.opts.sp)
        x = x + self.attention["output"]["dense"](merge_heads(ctx))
        return x + self.mlp(self.layernorm_after(x), deterministic)


class ViTEmbeddings(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_size = p
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.position_embeddings = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d))
        self.patch_embeddings = nn.Module()
        self.patch_embeddings.projection = nn.Conv2d(3, d, p, stride=p)

    def forward(self, images):
        """images [B, H, W, 3] -> [B, 1 + P, D]: the patchify convolution
        as a product of the flattened patches with the [D, 3 * p * p]
        kernel, the CLS token in front, plus the positions."""
        proj = self.patch_embeddings.projection
        b, hh, ww, c = images.shape
        p = self.patch_size
        patches = images.to(proj.weight.dtype).reshape(b, hh // p, p, ww // p, p, c)
        patches = patches.permute(0, 1, 3, 5, 2, 4).reshape(b, (hh // p) * (ww // p), c * p * p)
        x = F.linear(patches, proj.weight.reshape(proj.weight.shape[0], -1), proj.bias)
        cls = self.cls_token.expand(b, 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embeddings


class ViT(nn.Module):
    """Patchify -> CLS + positions -> pre-LN encoder -> final LayerNorm."""

    def __init__(self, cfg: ViTConfig = VIT_L_16, opts: Options = Options()):
        super().__init__()
        self.cfg, self.opts = cfg, opts
        with torch.device(opts.device):
            self.embeddings = ViTEmbeddings(cfg)
            self.encoder = nn.Module()
            self.encoder.layer = nn.ModuleList([ViTLayer(cfg, opts)
                                                for _ in range(cfg.num_layers)])
            self.layernorm = LayerNorm(cfg.hidden_size, eps=cfg.ln_eps)
        self.to(opts.dtype)

    def init_weights(self, seed: int) -> "ViT":
        """HF ViT's random init from a seeded generator on the model's
        device: N(0, 0.02) weights, CLS token and positions, zero biases,
        unit LayerNorm scales."""
        gen = torch.Generator(device=self.opts.device).manual_seed(int(seed))
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif "layernorm" in name:
                    p.fill_(1.0)
                else:
                    w = torch.empty(p.shape, device=p.device)
                    p.copy_(w.normal_(0.0, 0.02, generator=gen))
        return self

    def forward(self, images, deterministic: bool = True):
        """images [B, H, W, 3] float in model-normalised space -> (cls [B,
        D], tokens [B, P, D]) in the compute dtype."""
        x = self.embeddings(images)
        for layer in self.encoder.layer:
            x = layer(x, deterministic)
        x = self.layernorm(x)
        return x[:, 0], x[:, 1:]


# ImageNet-21k ViT preprocessing (the reference extractor's ViTImageProcessor
# defaults: resize 224, scale 1/255, normalise with mean and std 0.5)
IMAGENET_MEAN = 0.5
IMAGENET_STD = 0.5


def preprocess_frames(frames_uint8: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, size, size, 3] float32, resized and
    normalised on the frames' device.  The resize is bilinear with
    antialiasing (half-pixel centres), as jax.image.resize's "bilinear"."""
    x = frames_uint8.float() / 255.0
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True).permute(0, 2, 3, 1)
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def make_feature_extractor(cfg: ViTConfig = VIT_L_16, state: Optional[dict] = None,
                           options: Optional[Options] = None):
    """Returns (extract, model): ``extract(frames)`` takes uint8 frames [B,
    H, W, 3] (a tensor or a numpy array) and returns their CLS features [B,
    D] in float32 on the model's device.  Without ``state`` the weights are
    random from seed 0; without ``options`` the model runs on the card in
    bf16, the dtype the kernels take."""
    opts = options if options is not None else Options()
    model = ViT(cfg, opts)
    if state is None:
        model.init_weights(0)
    else:
        model.load_state_dict(state)
    model.eval()

    def extract(frames) -> torch.Tensor:
        if isinstance(frames, np.ndarray):
            frames = torch.tensor(frames)  # a copy: the array may be read-only
        with torch.inference_mode():
            images = preprocess_frames(frames.to(opts.device), cfg.image_size)
            return model(images)[0].float()

    return extract, model
