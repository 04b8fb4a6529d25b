"""Merged-head flash attention (forward): the kernel wrapper and its plain
PyTorch version.

Counterpart of vitxtgqa_tpu/ops/pallas_attention.py:flash_attention_merged.
The CUDA kernel is csrc/flash_attention.cu.  On a CUDA tensor the wrapper
launches it (or raises); on a CPU tensor it runs the plain version, which
is also the oracle the kernel is checked against on the card.
"""

from __future__ import annotations

import torch

from vitxtgqa_tpu_torch.ops import _build

NEG = -1e9  # masked-score fill of the kernels (pallas_attention.py _NEG)


def _allowed(key_mask: torch.Tensor, length: int, dec_len: int) -> torch.Tensor:
    """[B, 1, {1, L}, L] bool attention permission (pallas_attention._allowed)."""
    key_ok = (key_mask > 0)[:, None, None, :]
    if dec_len == 0:
        return key_ok
    l_enc = length - dec_len
    idx = torch.arange(length, device=key_mask.device)
    rows, cols = idx[:, None], idx[None, :]
    causal = (cols >= l_enc) & (rows >= l_enc) & (cols <= rows)
    return key_ok | causal[None, None]


def flash_attention_merged_plain(q, k, v, key_mask, dec_len: int, num_heads: int):
    """softmax(Q_h K_h^T / sqrt(d) + mask) V_h per head on merged [B, L, H*D]
    operands; f32 scores, weights rounded to v's dtype for the second
    product (as the kernel does), output in q's dtype."""
    b, l, hd_total = q.shape
    d = hd_total // num_heads
    split = lambda x: x.reshape(b, l, num_heads, d).transpose(1, 2).float()
    scores = torch.matmul(split(q), split(k).transpose(-1, -2)) * (1.0 / d ** 0.5)
    scores = scores.masked_fill(~_allowed(key_mask, l, dec_len), NEG)
    w = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.matmul(w, split(v))
    return out.transpose(1, 2).reshape(b, l, hd_total).to(q.dtype)


def flash_attention_merged(q, k, v, key_mask, dec_len: int, num_heads: int):
    """q/k/v [B, L, H*D] raw projections (bf16 on CUDA); key_mask [B, L]
    (1 = valid encoder key); dec_len: trailing causal decoder block."""
    if not q.is_cuda:
        return flash_attention_merged_plain(q, k, v, key_mask, dec_len, num_heads)
    b, l, hd_total = q.shape
    if hd_total % num_heads or hd_total // num_heads != 64:
        raise NotImplementedError(
            f"flash_attention_merged kernel: head dim 64 only, got "
            f"{hd_total}/{num_heads}"
        )
    if not 0 <= dec_len <= l:
        raise ValueError(f"dec_len {dec_len} outside [0, {l}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, torch.bfloat16, (b, l, hd_total), q.device)
    _build.require(key_mask, "key_mask", torch.float32, (b, l), q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.lib().vt_flash_attention_merged(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
            out.data_ptr(), b, l, num_heads, hd_total // num_heads, dec_len,
            _build.stream_of(q),
        )
    _build.check(err, "flash_attention_merged")
    _build.LAUNCHES["flash_attention_merged"] += 1
    return out
