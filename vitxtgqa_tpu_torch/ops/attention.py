"""Multi-head attention core and its routing to the kernels.

Counterpart of vitxtgqa_tpu/ops/attention.py, with the same shape gates:
full-sequence attention with a MaskSpec goes to the flash kernel at key
length >= 256 (MIN_KV, the JAX _PALLAS_MIN_KV), so the 20-token text BERT
stays on the plain path; a decode step over an int8 cache always goes to
the int8 decode kernel, one over a bf16 cache to the bf16 decode kernel at
key length >= 256.  Each kernel wrapper launches its kernel on CUDA
tensors and runs its plain version on CPU tensors; ``plain=True`` takes
the plain version on any device (the oracle mode of ``Options.plain``).
"""

from __future__ import annotations

import math

import torch

from vitxtgqa_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_int8,
    decode_attention_int8_plain,
    decode_attention_plain,
)
from vitxtgqa_tpu_torch.ops.flash_attention import (
    flash_attention_merged,
    flash_attention_merged_plain,
)
from vitxtgqa_tpu_torch.ops.masks import DecodeStepSpec, MaskSpec

MIN_KV = 256


def quantize_kv(x: torch.Tensor):
    """[B, L, H*D] -> (int8 [B, L, H*D], scales [B, L] f32): symmetric
    per-token quantization.  The amax is taken in the input dtype, the
    divide in f32 — bit for bit the JAX quantize_kv."""
    amax = x.abs().amax(dim=-1).float()
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q8 = torch.clamp(torch.round(x.float() / scale[..., None]), -127, 127)
    return q8.to(torch.int8), scale


def dequantize_kv(q8: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q8.float() * scales[..., None]).to(dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, D] -> [B, H, L, D/H]."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, Dh] -> [B, L, H*Dh]."""
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def mha_reference(q, k, v, bias=None):
    """Scaled dot-product attention on [B, H, L, Dh]: f32 scores, the
    probabilities rounded to v's dtype, f32 accumulation."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def mha(q, k, v, bias=None):
    """[B, H, Lq, Dh] attention; ``bias`` is an additive bias or a spec."""
    if isinstance(bias, (MaskSpec, DecodeStepSpec)):
        bias = bias.to_bias()
    return mha_reference(q, k, v, bias)


def mha_merged(q_raw, k_raw, v_raw, bias, num_heads: int, plain: bool = False):
    """Full-sequence attention in merged-head layout; returns [B, L, H*D]."""
    if isinstance(bias, MaskSpec) and k_raw.shape[1] >= MIN_KV:
        fn = flash_attention_merged_plain if plain else flash_attention_merged
        return fn(q_raw, k_raw, v_raw, bias.key_mask.float().contiguous(),
                  bias.dec_len, num_heads)
    ctx = mha(split_heads(q_raw, num_heads), split_heads(k_raw, num_heads),
              split_heads(v_raw, num_heads), bias)
    return merge_heads(ctx)


def decode_mha(q_raw, k_raw, v_raw, spec: DecodeStepSpec, num_heads: int,
               plain: bool = False):
    """One cached decode step in merged-head layout; returns [B, 1, H*D].
    An int8 cache arrives as (values, scales) tuples (see quantize_kv)."""
    if isinstance(k_raw, tuple):
        fn = decode_attention_int8_plain if plain else decode_attention_int8
        return fn(q_raw, k_raw[0], k_raw[1], v_raw[0], v_raw[1],
                  spec.key_mask.float().contiguous(), spec.step,
                  spec.write_offset, num_heads)
    if k_raw.shape[1] >= MIN_KV:
        fn = decode_attention_plain if plain else decode_attention
        return fn(q_raw, k_raw, v_raw, spec.key_mask.float().contiguous(),
                  spec.step, spec.write_offset, num_heads)
    ctx = mha(split_heads(q_raw, num_heads), split_heads(k_raw, num_heads),
              split_heads(v_raw, num_heads), spec)
    return merge_heads(ctx)
