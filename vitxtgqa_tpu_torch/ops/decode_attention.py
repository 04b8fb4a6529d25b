"""Single-query attention over the unified int8 decode cache: the kernel
wrapper and its plain PyTorch version.

Counterpart of vitxtgqa_tpu/ops/pallas_attention.py:decode_attention_int8.
The CUDA kernel is csrc/decode_attention.cu.
"""

from __future__ import annotations

import torch

from vitxtgqa_tpu_torch.ops import _build

NEG = -1e9


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
    cols = torch.arange(l, device=q.device)
    dec_ok = (cols >= write_offset) & (cols <= write_offset + step)
    allowed = (key_mask > 0) | dec_ok[None, :]
    scores = scores.masked_fill(~allowed[:, None, None, :], NEG)
    w = torch.softmax(scores, dim=-1) * vs.float()[:, None, None, :]
    out = torch.matmul(w.to(q.dtype).float(), vh)  # [B, H, 1, D]
    return out.reshape(b, 1, hd_total).to(q.dtype)


def decode_attention_int8(q, k8, ks, v8, vs, key_mask, step: int,
                          write_offset: int, num_heads: int):
    """One decode step over the int8 cache; returns [B, 1, H*D]."""
    if not q.is_cuda:
        return decode_attention_int8_plain(q, k8, ks, v8, vs, key_mask, step,
                                           write_offset, num_heads)
    b, _, hd_total = q.shape
    l = k8.shape[1]
    if hd_total % num_heads or hd_total // num_heads != 64:
        raise NotImplementedError(
            f"decode_attention_int8 kernel: head dim 64 only, got "
            f"{hd_total}/{num_heads}"
        )
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
