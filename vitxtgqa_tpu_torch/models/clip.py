"""CLIP towers (ViT and ModifiedResNet) and the dual encoder.

Counterpart of vitxtgqa_tpu/models/clip.py, the CLIP package the reference
bundles for MIST (reference: pythia/modules/mist_module/clip/model.py:
Bottleneck :10, AttentionPool2d :58, ModifiedResNet :94, VisionTransformer
:206, CLIP :245, build_model :402).  The reference instantiates the tower
but never calls it in its forward; it is here for the component's parity
and as an image / text embedder.

The modules carry the state-dict names of OpenAI's CLIP
(``visual.transformer.resblocks.{i}.attn.in_proj_weight``,
``visual.layer1.0.downsample.0.weight``, ``token_embedding.weight``, ...),
so a CLIP state dict loads with ``load_state_dict`` alone; ``load_clip``
reads a checkpoint file and infers the geometry (``infer_clip_config``, the
reference's build_model).  utils/convert.clip_state_dict_from_jax turns
the JAX package's CLIP variables back into such a state dict.

What runs where: no TPU kernel; plain PyTorch on any device, float32
parameters.  Attention is the JAX module's ``_attention``: the scores and
softmax in float32, the weights cast to v's dtype, the weighted sum
accumulated in float32.  LayerNorms compute in float32 whatever the
activation dtype; QuickGELU is x * sigmoid(1.702 x).  The ResNet tower's
BatchNorms always use their running statistics (CLIP is frozen in the
reference, mist.py:452), with torch's NCHW layout throughout (images come
in [B, 3, H, W]; the JAX module takes NHWC).
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x):
        return quick_gelu(x)


class FP32LayerNorm(nn.LayerNorm):
    """LayerNorm in float32 whatever the activation dtype, eps 1e-5
    (model.py:157-163); the output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d on its running statistics in training and eval alike
    (flax's ``use_running_average=True``), eps 1e-5."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


def attention(q, k, v, num_heads: int, bias=None):
    """q [B, Lq, D], k / v [B, Lk, D] -> [B, Lq, D]; ``bias`` [Lq, Lk]
    added to the scores (the JAX module's ``_attention``)."""
    b, lq, d = q.shape
    hd = d // num_heads
    heads = lambda t: t.reshape(b, t.shape[1], num_heads, hd).transpose(1, 2)
    qh, kh, vh = heads(q), heads(k), heads(v)
    scores = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) / hd ** 0.5
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1).to(vh.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", w.float(), vh.float()).to(q.dtype)
    return out.transpose(1, 2).reshape(b, lq, d)


class MultiheadAttention(nn.Module):
    """The parameters of torch's nn.MultiheadAttention under its names
    (one packed ``in_proj``, ``out_proj``), computed by ``attention``."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x, bias=None):
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        return self.out_proj(attention(q, k, v, self.n_head, bias))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block with a QuickGELU MLP (model.py:171-192)."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.attn = MultiheadAttention(d_model, n_head)
        self.ln_1 = FP32LayerNorm(d_model)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(d_model, 4 * d_model)), ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(4 * d_model, d_model))]))
        self.ln_2 = FP32LayerNorm(d_model)

    def forward(self, x, bias=None):
        x = x + self.attn(self.ln_1(x), bias)
        return x + self.mlp(self.ln_2(x))


class CLIPTransformer(nn.Module):
    """``layers`` residual attention blocks; ``causal``: the text tower's
    static causal bias (-inf above the diagonal)."""

    def __init__(self, width: int, layers: int, heads: int, causal: bool = False):
        super().__init__()
        self.causal = causal
        self.resblocks = nn.ModuleList([ResidualAttentionBlock(width, heads)
                                        for _ in range(layers)])

    def forward(self, x):
        bias = None
        if self.causal:
            n = x.shape[1]
            bias = torch.full((n, n), -math.inf, device=x.device).triu(1)
        for blk in self.resblocks:
            x = blk(x, bias)
        return x


class CLIPVisionTransformer(nn.Module):
    """Patchify -> CLS -> pre-LN transformer -> CLS projection
    (model.py:206-242)."""

    def __init__(self, input_resolution: int, patch_size: int, width: int, layers: int,
                 heads: int, output_dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        n_tok = (input_resolution // patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(n_tok, width))
        self.ln_pre = FP32LayerNorm(width)
        self.transformer = CLIPTransformer(width, layers, heads)
        self.ln_post = FP32LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def forward(self, images):
        """images [B, 3, H, W] -> [B, output_dim]."""
        x = self.conv1(images.to(self.conv1.weight.dtype))
        x = x.flatten(2).transpose(1, 2)                       # [B, grid^2, width]
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj.to(x.dtype)


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1):
    return (nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False),
            FrozenBatchNorm2d(cout))


class Bottleneck(nn.Module):
    """Anti-aliased ResNet bottleneck (model.py:10-55): the stride as an
    average pool before the last 1x1 convolution and on the shortcut."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(inplanes, planes, 1)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3, self.bn3 = _conv_bn(planes, planes * self.expansion, 1)
        self.downsample = None
        if stride > 1 or inplanes != planes * self.expansion:
            conv, bn = _conv_bn(inplanes, planes * self.expansion, 1)
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity()),
                ("0", conv), ("1", bn)]))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self.avgpool(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention of the mean token over the feature map plus positions
    (model.py:58-91)."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim or embed_dim)

    def forward(self, x):
        """x [B, C, H, W] -> [B, output_dim]."""
        seq = x.flatten(2).transpose(1, 2)                      # [B, H*W, C]
        seq = torch.cat([seq.mean(1, keepdim=True), seq], dim=1)
        seq = seq + self.positional_embedding.to(seq.dtype)
        pooled = attention(self.q_proj(seq[:, :1]), self.k_proj(seq), self.v_proj(seq),
                           self.num_heads)
        return self.c_proj(pooled)[:, 0]


class ModifiedResNet(nn.Module):
    """A 3-convolution stem with an average pool, four anti-aliased
    stages and the attention pool (model.py:94-154)."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(3, width // 2, 3, stride=2)
        self.conv2, self.bn2 = _conv_bn(width // 2, width // 2, 3)
        self.conv3, self.bn3 = _conv_bn(width // 2, width, 3)
        self.avgpool = nn.AvgPool2d(2)
        inplanes = width
        for stage, (mult, blocks) in enumerate(zip((1, 2, 4, 8), layers)):
            planes = width * mult
            stride = 1 if stage == 0 else 2
            seq = []
            for blk in range(blocks):
                seq.append(Bottleneck(inplanes, planes, stride if blk == 0 else 1))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32, heads, output_dim)

    def forward(self, images):
        """images [B, 3, H, W] -> [B, output_dim]."""
        x = images.to(self.conv1.weight.dtype)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = F.relu(bn(conv(x)))
        x = self.avgpool(x)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return self.attnpool(x)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: Union[Tuple[int, int, int, int], int] = 12
    vision_width: int = 768
    vision_patch_size: int = 32
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.vision_layers, (tuple, list))


CLIP_VIT_B_32 = CLIPConfig()  # the geometry MIST loads (mist.py:452)
CLIP_RN50 = CLIPConfig(embed_dim=1024, vision_layers=(3, 4, 6, 3), vision_width=64,
                       vision_patch_size=0)


class CLIP(nn.Module):
    """The dual encoder (model.py:245-375), built on ``device`` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, cfg: CLIPConfig = CLIP_VIT_B_32, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        with torch.device(device):
            if c.is_resnet:
                self.visual = ModifiedResNet(tuple(c.vision_layers), c.embed_dim,
                                             c.vision_width * 32 // 64, c.image_resolution,
                                             c.vision_width)
            else:
                self.visual = CLIPVisionTransformer(c.image_resolution, c.vision_patch_size,
                                                    c.vision_width, int(c.vision_layers),
                                                    c.vision_width // 64, c.embed_dim)
            self.transformer = CLIPTransformer(c.transformer_width, c.transformer_layers,
                                               c.transformer_heads, causal=True)
            self.token_embedding = nn.Embedding(c.vocab_size, c.transformer_width)
            self.positional_embedding = nn.Parameter(
                torch.empty(c.context_length, c.transformer_width))
            self.ln_final = FP32LayerNorm(c.transformer_width)
            self.text_projection = nn.Parameter(torch.empty(c.transformer_width, c.embed_dim))
            self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))

    def init_weights(self, seed: int) -> "CLIP":
        """Seeded random weights on the model's device, every tensor drawn
        (model.py's initialize_parameters in spirit, with no zero bias or
        unit scale, so that a misplaced one shows in a parity test): a
        weight N(0, fan_in^-1/2), the token / positional embeddings N(0,
        0.02) / N(0, 0.01), the class embedding and the projections N(0,
        width^-1/2), a bias N(0, 0.02), a norm's scale 1 + N(0, 0.02); the
        BatchNorms' running statistics stay 0 / 1 and the logit scale
        log(1 / 0.07)."""
        gen = torch.Generator(device=self.logit_scale.device).manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                for leaf, p in mod.named_parameters(recurse=False):
                    shift = 0.0
                    if leaf == "logit_scale":
                        continue
                    if isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
                        std, shift = 0.02, float(leaf == "weight")
                    elif leaf.endswith("bias") or isinstance(mod, nn.Embedding):
                        std = 0.02
                    elif leaf == "positional_embedding":
                        std = 0.01 if mod is self else p.shape[-1] ** -0.5
                    elif leaf == "class_embedding":
                        std = p.shape[-1] ** -0.5
                    elif leaf in ("proj", "text_projection"):
                        std = p.shape[0] ** -0.5
                    else:  # Linear and convolution weights, in_proj_weight
                        std = math.prod(p.shape[1:]) ** -0.5
                    w = torch.empty(p.shape, device=p.device).normal_(0.0, std, generator=gen)
                    p.copy_(w + shift)
        return self

    def encode_image(self, images):
        """images [B, 3, H, W] -> [B, embed_dim]."""
        return self.visual(images)

    def encode_text(self, text):
        """text [B, L] token ids -> (the EOT feature [B, E], every token's
        [B, L, E]); the EOT token is the one of the largest id, the first
        where it repeats (model.py:355-357)."""
        x = self.token_embedding(text) + self.positional_embedding[:text.shape[1]]
        x = self.ln_final(self.transformer(x))
        x_word = x @ self.text_projection.to(x.dtype)
        eot = text.argmax(dim=-1)
        return x_word[torch.arange(text.shape[0], device=text.device), eot], x_word

    def forward(self, images, text):
        """(logits per image [Bi, Bt], logits per text [Bt, Bi])."""
        img = self.encode_image(images)
        txt, _ = self.encode_text(text)
        img = img / img.norm(dim=1, keepdim=True)
        txt = txt / txt.norm(dim=1, keepdim=True)
        per_image = self.logit_scale.exp() * img @ txt.t()
        return per_image, per_image.t()


# the keys of a TorchScript CLIP checkpoint that are no weights (model.py:430)
META_KEYS = ("input_resolution", "context_length", "vocab_size")


def infer_clip_config(sd: Dict[str, object]) -> CLIPConfig:
    """The geometry of a CLIP state dict (model.py:402-439)."""
    shape = lambda k: tuple(sd[k].shape)
    if "visual.proj" in sd:
        vision_width = shape("visual.conv1.weight")[0]
        vision_layers = len([k for k in sd if k.startswith("visual.")
                             and k.endswith(".attn.in_proj_weight")])
        vision_patch_size = shape("visual.conv1.weight")[-1]
        grid = round((shape("visual.positional_embedding")[0] - 1) ** 0.5)
        image_resolution = vision_patch_size * grid
    else:
        vision_layers = tuple(len({k.split(".")[2] for k in sd
                                   if k.startswith(f"visual.layer{b}")}) for b in (1, 2, 3, 4))
        vision_width = shape("visual.layer1.0.conv1.weight")[0]
        out_width = round((shape("visual.attnpool.positional_embedding")[0] - 1) ** 0.5)
        vision_patch_size = 0
        image_resolution = out_width * 32
    width = shape("ln_final.weight")[0]
    return CLIPConfig(
        embed_dim=shape("text_projection")[1], image_resolution=image_resolution,
        vision_layers=vision_layers, vision_width=vision_width,
        vision_patch_size=vision_patch_size, context_length=shape("positional_embedding")[0],
        vocab_size=shape("token_embedding.weight")[0], transformer_width=width,
        transformer_heads=width // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}))


def load_clip(path: str, device="cuda") -> CLIP:
    """A CLIP checkpoint file (a state dict, as utils/torch_convert.
    load_state_dict reads it; a TorchScript checkpoint's metadata keys
    dropped) -> the model of its geometry on ``device``, in eval mode:
    clip.load(..., jit=False) without the TorchScript path, as the JAX
    load_clip."""
    from vitxtgqa_tpu_torch.utils.torch_convert import load_state_dict

    sd = {k: v for k, v in load_state_dict(path).items() if k not in META_KEYS}
    model = CLIP(infer_clip_config(sd), device=device)
    model.load_state_dict(sd)
    return model.eval()
