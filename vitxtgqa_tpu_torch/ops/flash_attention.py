"""Flash attention: the merged-head forward (with in-kernel dropout of the
attention probabilities, or with the emission of the int8 decode cache)
and backward, and the split-head forward and backward with a query-row
offset (sequence parallelism): the kernel wrappers and their plain PyTorch
versions.

Counterpart of vitxtgqa_tpu/ops/pallas_attention.py:flash_attention_merged,
flash_attention_merged_q8 and the backward _flash_merged_bwd_impl (#1,
#11, #1b), and of flash_attention with its backward _flash_bwd_impl (#10,
#10b), which only the sequence-parallel attention reaches
(parallel/sequence_parallel.py).  The CUDA kernels are
csrc/flash_attention.cu (entry points of the forward body in
csrc/flash_fwd.cuh, which #14 shares) and csrc/flash_attention_bwd.cu (entry
points of the backward body in csrc/flash_bwd.cuh).  On a CUDA tensor
a wrapper launches its kernel (or raises); on a CPU tensor it runs the
plain version, which is also the oracle the kernel is checked against on
the card.  Dropout keeps the probability of element (b, h, row, key) where
its Philox bits pass the threshold (ops/dropout.py, stream 0), with the
row counted in the whole sequence and the head in the whole layer (the
merged forms' ``head_offset``), so the forward, the backward and the
plain versions draw the same mask, and a query shard's rows, or a
tensor-parallel rank's heads, draw the unsharded call's.  The JAX
wrappers pad the keys to round_up(Lk, 128) with
key mask 0, so a query row with no allowed key averages V over that many
keys, the zero-padded ones included; the twins and the kernels count them
too (``_padded_softmax``), and the backward gives such a row's keys the
weight 1 / round_up(Lk, 128).  Every form takes any head width that is a
multiple of 8 up to 128 (the kernels' tiers, csrc/flash_fwd.cuh): 64 on the
main path's constant-width forms, below 64 zero-filled on one 64-column
atom, above 64 on two; wider heads raise (``check_head_width``).
"""

from __future__ import annotations

from typing import Optional

import ctypes

import torch

from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops import dropout as D

NEG = -1e9  # masked-score fill of the kernels (pallas_attention.py _NEG)
LANE = 128  # the JAX wrappers pad the keys to a multiple of this
MAX_HEAD_DIM = 128  # the widest head of the attention kernels' tiers


def head_width_ok(d: int) -> bool:
    """Whether the attention kernels (#1, #1b, #4, #5, #7, #10, #10b, #11,
    #14) take head width ``d``: a multiple of 8 up to MAX_HEAD_DIM, the
    widths their tiers hold (csrc/flash_fwd.cuh, csrc/decode_attention.cu,
    csrc/fused_decode_step.cuh)."""
    return 0 < d <= MAX_HEAD_DIM and d % 8 == 0


def check_head_width(name: str, d: int) -> None:
    """Raise unless the kernel ``name`` takes head width ``d``."""
    if not head_width_ok(d):
        raise NotImplementedError(
            f"{name} kernel: head widths a multiple of 8 up to {MAX_HEAD_DIM}, got {d} (head "
            "widths above 128: ROADMAP.md queue 2 item 5)")


def head_atoms(d: int) -> int:
    """The 64-column atoms of a head row in the kernels' tiers: 1 up to 64,
    2 above."""
    return 1 if d <= 64 else 2


def _padded_softmax(scores: torch.Tensor, with_lse: bool):
    """softmax (and, ``with_lse``, logsumexp, else None) over the last axis
    of masked scores, with round_up(Lk, 128) - Lk more keys at the -1e9
    fill (the JAX wrappers' padding): a row of fills averages over
    round_up(Lk, 128) keys, any other row is unchanged."""
    pad = -scores.shape[-1] % LANE
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG)
    w = torch.softmax(scores, dim=-1)
    lse = torch.logsumexp(scores, dim=-1) if with_lse else None
    return (w[..., :w.shape[-1] - pad] if pad else w), lse


def _padded_probs(scores: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """exp(scores - lse), the probabilities the backward recomputes; a row
    whose lse is the fill (no allowed key) weighs each key 1 / round_up(Lk,
    128), as the JAX kernels' padded keys do."""
    lse = lse.float()[..., None]
    p = torch.exp(scores - lse)
    l_pad = -(-scores.shape[-1] // LANE) * LANE
    return torch.where(lse <= 0.5 * NEG, p / l_pad, p)


def _allowed(key_mask: torch.Tensor, length: int, dec_len: int, row_offset: int = 0,
             rows: Optional[int] = None) -> torch.Tensor:
    """[B, 1, {1, R}, L] bool attention permission of the R query rows that
    start at global row ``row_offset`` (default: all L rows) over the L
    keys (pallas_attention._allowed)."""
    key_ok = (key_mask > 0)[:, None, None, :]
    if dec_len == 0:
        return key_ok
    l_enc = length - dec_len
    r = torch.arange(length if rows is None else rows, device=key_mask.device)[:, None] + row_offset
    cols = torch.arange(length, device=key_mask.device)[None, :]
    causal = (cols >= l_enc) & (r >= l_enc) & (cols <= r)
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


def _dropout_scale(q, num_heads: int, rate: float, seed,
                   head_offset: int = 0) -> Optional[torch.Tensor]:
    """The keep mask over 1 - rate ([B, H, L, L] f32; the heads from global
    head ``head_offset``), or None at rate 0."""
    if rate <= 0.0:
        return None
    b, l, _ = q.shape
    keep = D.keep_mask(seed, D.STREAM_ATTN, (b, num_heads, l, l), rate, q.device,
                       head_offset=head_offset)
    return keep.float() * (1.0 / (1.0 - rate))


def flash_attention_merged_plain(q, k, v, key_mask, dec_len: int, num_heads: int,
                                 dropout_rate: float = 0.0, seed=None,
                                 return_lse: bool = False, head_offset: int = 0):
    """softmax(Q_h K_h^T / sqrt(d) + mask) V_h per head on merged [B, L, H*D]
    operands; f32 scores, the probabilities dropped (where the Philox mask
    says so) and divided by 1 - rate, then rounded to v's dtype for the
    second product (as the kernel does); output in q's dtype.  With
    ``return_lse`` also the row log-sum-exp [B, H, L] f32.
    ``head_offset``: the global head of head 0 (a tensor-parallel rank's
    heads draw the whole layer's mask)."""
    w, lse = _padded_softmax(_scores(q, k, key_mask, dec_len, num_heads), return_lse)
    ks = _dropout_scale(q, num_heads, dropout_rate, seed, head_offset)
    if ks is not None:
        w = w * ks
    out = _merge(torch.matmul(w.to(v.dtype).float(), _split(v, num_heads)), q.dtype)
    if return_lse:
        return out, lse
    return out


def flash_attention_merged_bwd_plain(q, k, v, key_mask, out, lse, g, dec_len: int,
                                     num_heads: int, dropout_rate: float = 0.0, seed=None,
                                     head_offset: int = 0):
    """dq, dk, dv of flash_attention_merged for the cotangent ``g`` of
    ``out``: P = exp(S - lse), dV = (P K_r)^T g, dS = P (K_r (g V^T) -
    rowsum(g * out)), dQ = dS K / sqrt(d), dK = dS^T Q / sqrt(d), with K_r
    the forward's keep mask over 1 - rate.  Returned in q / k / v's dtypes."""
    d = q.shape[2] // num_heads
    scale = 1.0 / d ** 0.5
    p = _padded_probs(_scores(q, k, key_mask, dec_len, num_heads), lse)
    ks = _dropout_scale(q, num_heads, dropout_rate, seed, head_offset)
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


def bwd_ordered() -> bool:
    """Whether the backward kernels sum dq over the key blocks in a fixed
    order (csrc/flash_bwd.cuh, the ordered form: the same bits every run)
    rather than by atomics: under PyTorch's deterministic algorithms
    (torch.use_deterministic_algorithms), as PyTorch's own ops choose."""
    return torch.are_deterministic_algorithms_enabled()


def bwd_parts(lk: int, ordered: bool) -> int:
    """The dq slices of the backward's scratch: one a block of 64 keys in
    the ordered form, else 1 (csrc/flash_bwd.cuh bwd_parts)."""
    return -(-lk // 64) if ordered else 1


def _bwd_scratch(b: int, h: int, lq: int, lk: int, ordered: bool, device,
                 d: int = 64) -> torch.Tensor:
    """The backward kernel's f32 scratch (csrc/flash_bwd.cuh bwd_params):
    per (batch, head) and query row, padded to a multiple of 64 rows, the
    dq sums of each slice (bwd_parts; 64 columns an atom of the head
    width ``d``), D_i and the base-2 lse."""
    lq_pad = -(-lq // 64) * 64
    return torch.empty(b * h * lq_pad * (64 * head_atoms(d) * bwd_parts(lk, ordered) + 2),
                       dtype=torch.float32, device=device)


def _check_geometry(q, num_heads: int, dec_len: int, name: str):
    b, l, hd_total = q.shape
    if num_heads <= 0 or hd_total % num_heads:
        raise ValueError(f"{name}: {hd_total} columns are not {num_heads} heads")
    check_head_width(name, hd_total // num_heads)
    if not 0 <= dec_len <= l:
        raise ValueError(f"dec_len {dec_len} outside [0, {l}]")
    return b, l, hd_total


def flash_attention_merged(q, k, v, key_mask, dec_len: int, num_heads: int,
                           dropout_rate: float = 0.0, seed=None, return_lse: bool = False,
                           head_offset: int = 0):
    """q/k/v [B, L, H*D] raw projections (bf16 on CUDA); key_mask [B, L]
    (1 = valid encoder key); dec_len: trailing causal decoder block;
    dropout: rate and an int64 [1] seed tensor on the device; with
    ``return_lse`` also the row log-sum-exp [B, H, L] f32; ``head_offset``:
    the global head of head 0 in the dropout mask's coordinates."""
    if not q.is_cuda:
        return flash_attention_merged_plain(q, k, v, key_mask, dec_len, num_heads,
                                            dropout_rate, seed, return_lse, head_offset)
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
            num_heads, hd_total // num_heads, dec_len, head_offset, thr, ks,
            _build.stream_of(q),
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
            num_heads, hd_total // num_heads, dec_len, 0, 0, 1.0, _build.stream_of(q),
        )
    _build.check(err, "flash_attention_merged_q8")
    _build.LAUNCHES["flash_attention_merged_q8"] += 1
    return out, (k8, ks), (v8, vs)


def flash_attention_merged_bwd(q, k, v, key_mask, out, lse, g, dec_len: int, num_heads: int,
                               dropout_rate: float = 0.0, seed=None, head_offset: int = 0):
    """dq, dk, dv (bf16 on CUDA) for the cotangent ``g`` of the forward's
    ``out``, from its saved ``lse``; the dropout mask is regenerated from
    the forward's rate, seed and head offset.  Under PyTorch's
    deterministic algorithms dq is summed in a fixed order (bwd_ordered)."""
    if not q.is_cuda:
        return flash_attention_merged_bwd_plain(q, k, v, key_mask, out, lse, g, dec_len,
                                                num_heads, dropout_rate, seed, head_offset)
    b, l, hd_total = _check_geometry(q, num_heads, dec_len, "flash_attention_merged_bwd")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("g", g)):
        _build.require(t, name, torch.bfloat16, (b, l, hd_total), q.device)
    _build.require(key_mask, "key_mask", torch.float32, (b, l), q.device)
    _build.require(lse, "lse", torch.float32, (b, num_heads, l), q.device)
    seed, thr, ks = _dropout_args(dropout_rate, seed)
    if seed is not None:
        _build.require(seed, "seed", torch.int64, (1,), q.device)
    ordered = bwd_ordered()
    scratch = _bwd_scratch(b, num_heads, l, l, ordered, q.device, hd_total // num_heads)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _build.lib().vt_flash_attention_merged_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if seed is None else seed.data_ptr(), b, l, num_heads,
            hd_total // num_heads, dec_len, head_offset, int(ordered), thr, ks,
            _build.stream_of(q),
        )
    _build.check(err, "flash_attention_merged_bwd")
    _build.LAUNCHES["flash_attention_merged_bwd"] += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# split-head flash attention with a query-row offset (#10, #10b)
# ---------------------------------------------------------------------------


def _split_scores(q, k, key_mask, dec_len: int, row_offset: int) -> torch.Tensor:
    """Masked, scaled f32 scores [B, H, Lq, Lk] of the query rows that start
    at global row ``row_offset``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / q.shape[-1] ** 0.5)
    return s.masked_fill(~_allowed(key_mask, k.shape[2], dec_len, row_offset, q.shape[2]), NEG)


def _split_keep(q, k, rate: float, seed, row_offset: int) -> Optional[torch.Tensor]:
    """The keep mask over 1 - rate ([B, H, Lq, Lk] f32) of the rows from
    ``row_offset`` on, or None at rate 0."""
    if rate <= 0.0:
        return None
    b, h, lq, _ = q.shape
    keep = D.keep_mask(seed, D.STREAM_ATTN, (b, h, lq, k.shape[2]), rate, q.device, row_offset)
    return keep.float() * (1.0 / (1.0 - rate))


def flash_attention_plain(q, k, v, key_mask, dec_len: int, row_offset: int = 0,
                          dropout_rate: float = 0.0, seed=None, return_lse: bool = False):
    """q [B, H, Lq, D], k / v [B, H, Lk, D]: mha_reference over rows
    [row_offset, row_offset + Lq) of the prefix-LM bias, with the kernels'
    -1e9 fill; the probabilities dropped (Philox mask of the global rows)
    and divided by 1 - rate, then rounded to v's dtype for the second
    product; output [B, H, Lq, D] in q's dtype.  With ``return_lse`` also
    the row log-sum-exp [B, H, Lq] f32."""
    w, lse = _padded_softmax(_split_scores(q, k, key_mask, dec_len, row_offset),
                             return_lse)
    ks = _split_keep(q, k, dropout_rate, seed, row_offset)
    if ks is not None:
        w = w * ks
    out = torch.matmul(w.to(v.dtype).float(), v.float()).to(q.dtype)
    if return_lse:
        return out, lse
    return out


def flash_attention_bwd_plain(q, k, v, key_mask, out, lse, g, dec_len: int, row_offset: int = 0,
                              dropout_rate: float = 0.0, seed=None):
    """dq (q's dtype) and the f32 partial dk, dv of flash_attention for the
    cotangent ``g`` of ``out`` ([B, H, Lq, D] each): P = exp(S - lse), dV =
    (P K_r)^T g, dS = P (K_r (g V^T) - rowsum(g * out)), dQ = dS K /
    sqrt(d), dK = dS^T Q / sqrt(d), with K_r the forward's keep mask over
    1 - rate."""
    scale = 1.0 / q.shape[-1] ** 0.5
    p = _padded_probs(_split_scores(q, k, key_mask, dec_len, row_offset), lse)
    ks = _split_keep(q, k, dropout_rate, seed, row_offset)
    gf = g.float()
    dv = torch.matmul(p.transpose(-1, -2) if ks is None else (p * ks).transpose(-1, -2), gf)
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    if ks is not None:
        dp = dp * ks
    ds = p * (dp - (gf * out.float()).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk, dv


def _head_strides(t: torch.Tensor, name: str, shape, dtype: torch.dtype, device) -> list:
    """(batch, head, row) element strides of a [B, H, L, D] view with a
    contiguous last dimension and 16-byte aligned rows; raises otherwise."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, expected {dtype} "
                         f"{tuple(shape)} on {device}")
    per16 = 16 // t.element_size()
    if t.stride(-1) != 1 or any(st % per16 for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name}: needs a contiguous last dimension and 16-byte aligned rows, "
                         f"got strides {t.stride()}")
    return list(t.stride()[:3])


def _split_empty(b: int, rows: int, h: int, d: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A [B, H, rows, D] view of a fresh [B, rows, H, D] buffer: merge_heads
    of it is a free reshape, and a row block of it is contiguous."""
    return torch.empty((b, rows, h, d), dtype=dtype, device=device).transpose(1, 2)


def _split_geometry(q, k, dec_len: int, row_offset: int, name: str):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    check_head_width(name, d)
    if not 0 <= dec_len <= lk:
        raise ValueError(f"dec_len {dec_len} outside [0, {lk}]")
    if row_offset < 0 or row_offset + lq > lk:
        raise ValueError(f"query rows [{row_offset}, {row_offset + lq}) outside the {lk} keys")
    return b, h, lq, lk, d


def flash_attention(q, k, v, key_mask, dec_len: int, row_offset: int = 0,
                    dropout_rate: float = 0.0, seed=None, return_lse: bool = False):
    """q [B, H, Lq, D], k / v [B, H, Lk, D] (bf16 on CUDA, any strides
    with a contiguous last dimension: split_heads views are not copied);
    key_mask [B, Lk] (1 = valid encoder key); dec_len: the trailing causal
    decoder block of the Lk-row sequence; row_offset: the global row of
    query row 0; dropout: rate and an int64 [1] seed tensor on the device.
    Returns out [B, H, Lq, D] (a view of a [B, Lq, H, D] buffer), and
    with ``return_lse`` the row log-sum-exp [B, H, Lq] f32."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, key_mask, dec_len, row_offset, dropout_rate, seed,
                                     return_lse)
    b, h, lq, lk, d = _split_geometry(q, k, dec_len, row_offset, "flash_attention")
    dev, bf = q.device, torch.bfloat16
    strides = (_head_strides(q, "q", (b, h, lq, d), bf, dev)
               + _head_strides(k, "k", (b, h, lk, d), bf, dev)
               + _head_strides(v, "v", (b, h, lk, d), bf, dev))
    _build.require(key_mask, "key_mask", torch.float32, (b, lk), dev)
    seed, thr, ks = _dropout_args(dropout_rate, seed)
    if seed is not None:
        _build.require(seed, "seed", torch.int64, (1,), dev)
    out = _split_empty(b, lq, h, d, bf, dev)
    strides += list(out.stride()[:3])
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=dev) if return_lse else None
    with torch.cuda.device(dev):
        err = _build.lib().vt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), None if seed is None else seed.data_ptr(),
            (ctypes.c_longlong * 12)(*strides), b, h, lq, lk, d, dec_len, row_offset, thr, ks,
            _build.stream_of(q))
    _build.check(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, key_mask, out, lse, g, dec_len: int, row_offset: int = 0,
                        dropout_rate: float = 0.0, seed=None):
    """dq [B, H, Lq, D] bf16 and the f32 partial dk, dv [B, H, Lk, D] of
    flash_attention for the cotangent ``g`` of its ``out``, from the saved
    ``lse``; q / k / v / out / g through their strides; the dropout mask is
    regenerated from the forward's rate, seed and row offset; dq in a
    fixed order as flash_attention_merged_bwd's."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, key_mask, out, lse, g, dec_len, row_offset,
                                         dropout_rate, seed)
    b, h, lq, lk, d = _split_geometry(q, k, dec_len, row_offset, "flash_attention_bwd")
    dev, bf = q.device, torch.bfloat16
    strides = []
    for name, t, rows in (("q", q, lq), ("k", k, lk), ("v", v, lk), ("out", out, lq),
                          ("g", g, lq)):
        strides += _head_strides(t, name, (b, h, rows, d), bf, dev)
    _build.require(key_mask, "key_mask", torch.float32, (b, lk), dev)
    _build.require(lse, "lse", torch.float32, (b, h, lq), dev)
    seed, thr, ks = _dropout_args(dropout_rate, seed)
    if seed is not None:
        _build.require(seed, "seed", torch.int64, (1,), dev)
    dq = _split_empty(b, lq, h, d, bf, dev)
    dk, dv = (_split_empty(b, lk, h, d, torch.float32, dev) for _ in range(2))
    for t in (dq, dk, dv):
        strides += list(t.stride()[:3])
    ordered = bwd_ordered()
    scratch = _bwd_scratch(b, h, lq, lk, ordered, dev, d)
    with torch.cuda.device(dev):
        err = _build.lib().vt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if seed is None else seed.data_ptr(),
            (ctypes.c_longlong * 24)(*strides), b, h, lq, lk, d, dec_len, row_offset,
            int(ordered), thr, ks, _build.stream_of(q))
    _build.check(err, "flash_attention_bwd")
    _build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
