"""Merged-head flash attention, forward (with in-kernel dropout of the
attention probabilities, or with the emission of the int8 decode cache)
and backward: the kernel wrappers and their plain PyTorch versions.

Counterpart of vitxtgqa_tpu/ops/pallas_attention.py:flash_attention_merged,
flash_attention_merged_q8 and the backward _flash_merged_bwd_impl.  The
CUDA kernels are
csrc/flash_attention.cu and csrc/flash_attention_bwd.cu.  On a CUDA tensor
a wrapper launches its kernel (or raises); on a CPU tensor it runs the
plain version, which is also the oracle the kernel is checked against on
the card.  Dropout keeps the probability of element (b, h, row, key) where
its Philox bits pass the threshold (ops/dropout.py, stream 0), so the
forward, the backward and the plain versions draw the same mask.
"""

from __future__ import annotations

from typing import Optional

import torch

from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops import dropout as D

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


def _split(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, hd_total = x.shape
    return x.reshape(b, l, num_heads, hd_total // num_heads).transpose(1, 2).float()


def _merge(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d).to(dtype)


def _scores(q, k, key_mask, dec_len: int, num_heads: int) -> torch.Tensor:
    """Masked, scaled f32 scores [B, H, L, L]."""
    l, d = q.shape[1], q.shape[2] // num_heads
    s = torch.matmul(_split(q, num_heads), _split(k, num_heads).transpose(-1, -2)) * (1.0 / d ** 0.5)
    return s.masked_fill(~_allowed(key_mask, l, dec_len), NEG)


def _dropout_scale(q, num_heads: int, rate: float, seed) -> Optional[torch.Tensor]:
    """The keep mask over 1 - rate ([B, H, L, L] f32), or None at rate 0."""
    if rate <= 0.0:
        return None
    b, l, _ = q.shape
    keep = D.keep_mask(seed, D.STREAM_ATTN, (b, num_heads, l, l), rate, q.device)
    return keep.float() * (1.0 / (1.0 - rate))


def flash_attention_merged_plain(q, k, v, key_mask, dec_len: int, num_heads: int,
                                 dropout_rate: float = 0.0, seed=None,
                                 return_lse: bool = False):
    """softmax(Q_h K_h^T / sqrt(d) + mask) V_h per head on merged [B, L, H*D]
    operands; f32 scores, the probabilities dropped (where the Philox mask
    says so) and divided by 1 - rate, then rounded to v's dtype for the
    second product (as the kernel does); output in q's dtype.  With
    ``return_lse`` also the row log-sum-exp [B, H, L] f32."""
    scores = _scores(q, k, key_mask, dec_len, num_heads)
    w = torch.softmax(scores, dim=-1)
    ks = _dropout_scale(q, num_heads, dropout_rate, seed)
    if ks is not None:
        w = w * ks
    out = _merge(torch.matmul(w.to(v.dtype).float(), _split(v, num_heads)), q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def flash_attention_merged_bwd_plain(q, k, v, key_mask, out, lse, g, dec_len: int,
                                     num_heads: int, dropout_rate: float = 0.0, seed=None):
    """dq, dk, dv of flash_attention_merged for the cotangent ``g`` of
    ``out``: P = exp(S - lse), dV = (P K_r)^T g, dS = P (K_r (g V^T) -
    rowsum(g * out)), dQ = dS K / sqrt(d), dK = dS^T Q / sqrt(d), with K_r
    the forward's keep mask over 1 - rate.  Returned in q / k / v's dtypes."""
    d = q.shape[2] // num_heads
    scale = 1.0 / d ** 0.5
    p = torch.exp(_scores(q, k, key_mask, dec_len, num_heads) - lse.float()[..., None])
    ks = _dropout_scale(q, num_heads, dropout_rate, seed)
    gh, vh = _split(g, num_heads), _split(v, num_heads)
    pd = p if ks is None else p * ks
    dv = torch.matmul(pd.transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    if ks is not None:
        dp = dp * ks
    di = (gh * _split(out, num_heads)).sum(dim=-1, keepdim=True)
    ds = p * (dp - di)
    dq = torch.matmul(ds, _split(k, num_heads)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), _split(q, num_heads)) * scale
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


def _dropout_args(rate: float, seed):
    if rate <= 0.0:
        return None, 0, 1.0
    if seed is None:
        raise ValueError("dropout needs a seed")
    return seed, D.threshold(rate), 1.0 / (1.0 - rate)


def _check_geometry(q, num_heads: int, dec_len: int, name: str):
    b, l, hd_total = q.shape
    if hd_total % num_heads or hd_total // num_heads != 64:
        raise NotImplementedError(
            f"{name} kernel: head dim 64 only, got {hd_total}/{num_heads}")
    if not 0 <= dec_len <= l:
        raise ValueError(f"dec_len {dec_len} outside [0, {l}]")
    return b, l, hd_total


def flash_attention_merged(q, k, v, key_mask, dec_len: int, num_heads: int,
                           dropout_rate: float = 0.0, seed=None, return_lse: bool = False):
    """q/k/v [B, L, H*D] raw projections (bf16 on CUDA); key_mask [B, L]
    (1 = valid encoder key); dec_len: trailing causal decoder block;
    dropout: rate and an int64 [1] seed tensor on the device; with
    ``return_lse`` also the row log-sum-exp [B, H, L] f32."""
    if not q.is_cuda:
        return flash_attention_merged_plain(q, k, v, key_mask, dec_len, num_heads,
                                            dropout_rate, seed, return_lse)
    b, l, hd_total = _check_geometry(q, num_heads, dec_len, "flash_attention_merged")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, torch.bfloat16, (b, l, hd_total), q.device)
    _build.require(key_mask, "key_mask", torch.float32, (b, l), q.device)
    seed, thr, ks = _dropout_args(dropout_rate, seed)
    if seed is not None:
        _build.require(seed, "seed", torch.int64, (1,), q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, l), dtype=torch.float32, device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        err = _build.lib().vt_flash_attention_merged(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            None if seed is None else seed.data_ptr(), None, None, None, None, b, l,
            num_heads, hd_total // num_heads, dec_len, thr, ks, _build.stream_of(q),
        )
    _build.check(err, "flash_attention_merged")
    _build.LAUNCHES["flash_attention_merged"] += 1
    return (out, lse) if return_lse else out


def flash_attention_merged_q8_plain(q, k, v, key_mask, dec_len: int, num_heads: int):
    """The eval forward and the quantize_kv layout of k and v:
    (out, (k8, ks), (v8, vs)) — pallas_attention.flash_attention_merged_q8."""
    from vitxtgqa_tpu_torch.ops.attention import quantize_kv

    out = flash_attention_merged_plain(q, k, v, key_mask, dec_len, num_heads)
    return out, quantize_kv(k), quantize_kv(v)


def flash_attention_merged_q8(q, k, v, key_mask, dec_len: int, num_heads: int):
    """flash_attention_merged (eval) that also emits this layer's int8
    decode cache from the same launch: (out [B, L, H*D], (k8 [B, L, H*D]
    int8, ks [B, L] f32), (v8, vs)), bit for bit quantize_kv's."""
    if not q.is_cuda:
        return flash_attention_merged_q8_plain(q, k, v, key_mask, dec_len, num_heads)
    b, l, hd_total = _check_geometry(q, num_heads, dec_len, "flash_attention_merged_q8")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, torch.bfloat16, (b, l, hd_total), q.device)
    _build.require(key_mask, "key_mask", torch.float32, (b, l), q.device)
    out = torch.empty_like(q)
    k8, v8 = (torch.empty((b, l, hd_total), dtype=torch.int8, device=q.device) for _ in range(2))
    ks, vs = (torch.empty((b, l), dtype=torch.float32, device=q.device) for _ in range(2))
    with torch.cuda.device(q.device):
        err = _build.lib().vt_flash_attention_merged(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), out.data_ptr(),
            None, None, k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(), b, l,
            num_heads, hd_total // num_heads, dec_len, 0, 1.0, _build.stream_of(q),
        )
    _build.check(err, "flash_attention_merged_q8")
    _build.LAUNCHES["flash_attention_merged_q8"] += 1
    return out, (k8, ks), (v8, vs)


def flash_attention_merged_bwd(q, k, v, key_mask, out, lse, g, dec_len: int, num_heads: int,
                               dropout_rate: float = 0.0, seed=None):
    """dq, dk, dv (bf16 on CUDA) for the cotangent ``g`` of the forward's
    ``out``, from its saved ``lse``; the dropout mask is regenerated from
    the forward's rate and seed."""
    if not q.is_cuda:
        return flash_attention_merged_bwd_plain(q, k, v, key_mask, out, lse, g, dec_len,
                                                num_heads, dropout_rate, seed)
    b, l, hd_total = _check_geometry(q, num_heads, dec_len, "flash_attention_merged_bwd")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("g", g)):
        _build.require(t, name, torch.bfloat16, (b, l, hd_total), q.device)
    _build.require(key_mask, "key_mask", torch.float32, (b, l), q.device)
    _build.require(lse, "lse", torch.float32, (b, num_heads, l), q.device)
    seed, thr, ks = _dropout_args(dropout_rate, seed)
    if seed is not None:
        _build.require(seed, "seed", torch.int64, (1,), q.device)
    di = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _build.lib().vt_flash_attention_merged_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if seed is None else seed.data_ptr(), b, l, num_heads,
            hd_total // num_heads, dec_len, thr, ks, _build.stream_of(q),
        )
    _build.check(err, "flash_attention_merged_bwd")
    _build.LAUNCHES["flash_attention_merged_bwd"] += 1
    return dq, dk, dv
