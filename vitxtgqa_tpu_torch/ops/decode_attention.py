"""Single-query attention over the unified decode cache, int8 or bf16: the
kernel wrappers and their plain PyTorch versions.

Counterparts of vitxtgqa_tpu/ops/pallas_attention.py:decode_attention_int8
and decode_attention.  Both CUDA kernels are csrc/decode_attention.cu (one
template, with and without the scale folding).
"""

from __future__ import annotations

import torch

from vitxtgqa_tpu_torch.ops import _build

NEG = -1e9


def _decoder_slots_ok(l, step, write_offset, device):
    cols = torch.arange(l, device=device)
    return (cols >= write_offset) & (cols <= write_offset + step)


def decode_attention_int8_plain(q, k8, ks, v8, vs, key_mask, step: int,
                                write_offset: int, num_heads: int):
    """q [B, 1, H*D]; k8/v8 [B, L, H*D] int8; ks/vs [B, L] f32 per-token
    scales.  Dequantization folds into scores and weights as in the Pallas
    kernel: s = (q . k8) * (ks / sqrt(D)); w = softmax(s) * vs, rounded to
    q's dtype; out = w . v8."""
    b, _, hd_total = q.shape
    l = k8.shape[1]
    d = hd_total // num_heads
    scale = 1.0 / d ** 0.5
    qh = q.reshape(b, num_heads, 1, d).float()
    kh = k8.to(q.dtype).reshape(b, l, num_heads, d).permute(0, 2, 3, 1).float()
    vh = v8.to(q.dtype).reshape(b, l, num_heads, d).transpose(1, 2).float()
    scores = torch.matmul(qh, kh) * (ks.float() * scale)[:, None, None, :]
    allowed = (key_mask > 0) | _decoder_slots_ok(l, step, write_offset, q.device)[None, :]
    scores = scores.masked_fill(~allowed[:, None, None, :], NEG)
    w = torch.softmax(scores, dim=-1) * vs.float()[:, None, None, :]
    out = torch.matmul(w.to(q.dtype).float(), vh)  # [B, H, 1, D]
    return out.reshape(b, 1, hd_total).to(q.dtype)


def decode_attention_plain(q, k, v, key_mask, step: int, write_offset: int,
                           num_heads: int):
    """q [B, 1, H*D]; k/v [B, L, H*D] in q's dtype.  As the Pallas kernel:
    s = (q . k) / sqrt(D) in f32, masked with -1e9; w = softmax(s) rounded
    to v's dtype; out = w . v with f32 accumulation."""
    b, _, hd_total = q.shape
    l = k.shape[1]
    d = hd_total // num_heads
    qh = q.reshape(b, num_heads, 1, d).float()
    kh = k.reshape(b, l, num_heads, d).permute(0, 2, 3, 1).float()
    vh = v.reshape(b, l, num_heads, d).transpose(1, 2).float()
    scores = torch.matmul(qh, kh) * (1.0 / d ** 0.5)
    allowed = (key_mask > 0) | _decoder_slots_ok(l, step, write_offset, q.device)[None, :]
    scores = scores.masked_fill(~allowed[:, None, None, :], NEG)
    w = torch.softmax(scores, dim=-1).to(v.dtype).float()
    return torch.matmul(w, vh).reshape(b, 1, hd_total).to(q.dtype)


def check_head_dim(name, hd_total, num_heads):
    if hd_total % num_heads or hd_total // num_heads != 64:
        raise NotImplementedError(
            f"{name} kernel: head dim 64 only, got {hd_total}/{num_heads}"
        )


def decode_attention(q, k, v, key_mask, step: int, write_offset: int,
                     num_heads: int):
    """One decode step over the bf16 cache; returns [B, 1, H*D]."""
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, key_mask, step, write_offset,
                                      num_heads)
    b, _, hd_total = q.shape
    l = k.shape[1]
    check_head_dim("decode_attention", hd_total, num_heads)
    dev = q.device
    _build.require(q, "q", torch.bfloat16, (b, 1, hd_total), dev)
    for name, t in (("k", k), ("v", v)):
        _build.require(t, name, torch.bfloat16, (b, l, hd_total), dev)
    _build.require(key_mask, "key_mask", torch.float32, (b, l), dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = _build.lib().vt_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
            out.data_ptr(), b, l, num_heads, hd_total // num_heads, int(step),
            int(write_offset), _build.stream_of(q),
        )
    _build.check(err, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_int8(q, k8, ks, v8, vs, key_mask, step: int,
                          write_offset: int, num_heads: int):
    """One decode step over the int8 cache; returns [B, 1, H*D]."""
    if not q.is_cuda:
        return decode_attention_int8_plain(q, k8, ks, v8, vs, key_mask, step,
                                           write_offset, num_heads)
    b, _, hd_total = q.shape
    l = k8.shape[1]
    check_head_dim("decode_attention_int8", hd_total, num_heads)
    dev = q.device
    _build.require(q, "q", torch.bfloat16, (b, 1, hd_total), dev)
    for name, t in (("k8", k8), ("v8", v8)):
        _build.require(t, name, torch.int8, (b, l, hd_total), dev)
    for name, t in (("ks", ks), ("vs", vs), ("key_mask", key_mask)):
        _build.require(t, name, torch.float32, (b, l), dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = _build.lib().vt_decode_attention_int8(
            q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
            vs.data_ptr(), key_mask.data_ptr(), out.data_ptr(), b, l,
            num_heads, hd_total // num_heads, int(step), int(write_offset),
            _build.stream_of(q),
        )
    _build.check(err, "decode_attention_int8")
    _build.LAUNCHES["decode_attention_int8"] += 1
    return out
