"""Split-head attention with an additive bias tensor: the kernel wrapper
(differentiable: FusedAttentionFn) and its plain PyTorch version.

Counterpart of vitxtgqa_tpu/ops/pallas_attention.py:fused_attention, which
the split-head ``mha`` takes for an array bias or none (ops/attention.py).
The CUDA kernel is csrc/fused_attention.cu, the flash forward body of
csrc/flash_fwd.cuh under its bias policy: any head width a multiple of 8
up to 128 (ViT-L/16's 64, ViT-H/14's 80; flash_attention.head_width_ok),
q / k / v read through their strides, so the split-head views of a merged
projection are not copied.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops.flash_attention import LANE, NEG, _head_strides, check_head_width


def fused_attention_plain(q, k, v, bias=None):
    """softmax(Q K^T / sqrt(Dh) + bias) V on [B, H, L, Dh] as the Pallas
    kernel computes it: f32 scores with the bias added, the softmax over
    round_up(Lk, 128) keys, the keys past Lk scoring exactly -1e9 (a zero
    key plus the -1e9 bias the JAX wrapper pads with) with zero values, the
    probabilities rounded to v's dtype, f32 accumulation.  A row with a
    score above about -1e9 + 104 is the mha_reference row; a row of -1e9
    biases averages V over round_up(Lk, 128) keys, the padded ones
    included."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.float()
    lk = k.shape[2]
    scores = F.pad(scores, (0, -lk % LANE), value=NEG)
    probs = torch.softmax(scores, dim=-1)[..., :lk].to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def _launch(q, k, v, bias):
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    check_head_width("fused_attention", dh)
    dev, bf = q.device, torch.bfloat16
    strides = (_head_strides(q, "q", (b, h, lq, dh), bf, dev)
               + _head_strides(k, "k", (b, h, lk, dh), bf, dev)
               + _head_strides(v, "v", (b, h, lk, dh), bf, dev))
    # the output is laid out [B, Lq, H, Dh]: merge_heads of its [B, H, Lq,
    # Dh] view is then a free reshape
    out = torch.empty((b, lq, h, dh), dtype=torch.bfloat16, device=dev).transpose(1, 2)
    strides += list(out.stride()[:3])
    bias_ptr = None
    if bias is None:
        strides += [0, 0]
    else:
        if bias.dim() != 4 or bias.shape[1] != 1 or bias.shape[0] != b or bias.shape[3] != lk \
                or bias.shape[2] not in (1, lq):
            raise ValueError(f"bias: shape {tuple(bias.shape)}, expected [{b}, 1, 1, {lk}] or "
                             f"[{b}, 1, {lq}, {lk}]")
        bias = bias.to(torch.float32).contiguous()
        _build.require(bias, "bias", torch.float32, device=dev)
        strides += [bias.stride(0), 0 if bias.shape[2] == 1 else bias.stride(2)]
        bias_ptr = bias.data_ptr()
    c_strides = (ctypes.c_longlong * 14)(*strides)
    with torch.cuda.device(dev):
        err = _build.lib().vt_fused_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(), c_strides, b,
            h, lq, lk, dh, _build.stream_of(q))
    _build.check(err, "fused_attention")
    _build.LAUNCHES["fused_attention"] += 1
    return out


class FusedAttentionFn(torch.autograd.Function):
    """The bias-tensor attention as one autograd node: the kernel forward
    (the plain version on CPU tensors), and a backward that recomputes
    through fused_attention_plain, as FusedFFNFn does: the gradients are
    the plain graph's."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        if not q.is_cuda:
            return fused_attention_plain(q, k, v, bias)
        return _launch(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = fused_attention_plain(*inputs)
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t is not None and t.requires_grad else None for t in inputs)


def fused_attention(q, k, v, bias=None):
    """q [B, H, Lq, Dh], k / v [B, H, Lk, Dh]; bias [B, 1, 1, Lk], [B, 1, Lq,
    Lk] or None -> [B, H, Lq, Dh] in q's dtype.  On CUDA tensors the kernel
    (bf16, Dh a multiple of 8 up to 128; another head width raises), on CPU
    tensors the plain
    version; differentiable (FusedAttentionFn)."""
    return FusedAttentionFn.apply(q, k, v, bias)
