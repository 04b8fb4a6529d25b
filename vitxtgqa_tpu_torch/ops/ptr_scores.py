"""OCR pointer-net scores of a decode step over int8 keys: the kernel
wrapper and its plain PyTorch version.

Counterpart of vitxtgqa_tpu/ops/pallas_attention.py:ptr_scores_int8.  The
CUDA kernel is csrc/ptr_scores.cu.
"""

from __future__ import annotations

import torch

from vitxtgqa_tpu_torch.ops import _build


def ptr_scores_int8_plain(q, k8, ks, mask):
    """q [B, 1, D] query projection; k8 [B, N, D] int8 keys with per-token
    scales ks [B, N] f32 (the quantize_kv layout); mask [B, N] the raw 0/1
    OCR mask, ADDED to the scores (the reference quirk).  Returns (q . k8)
    * (ks / sqrt(D)) + mask, [B, 1, N] f32."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bsd,bnd->bsn", q.float(), k8.float())
    return s * (ks.float() * scale)[:, None, :] + mask.float()[:, None, :]


def ptr_scores_int8(q, k8, ks, mask):
    """The scores of ptr_scores_int8_plain in one launch (one query row)."""
    if not q.is_cuda:
        return ptr_scores_int8_plain(q, k8, ks, mask)
    b, s_len, d = q.shape
    n = k8.shape[1]
    if s_len != 1 or d % 16 or d > 1024:
        raise NotImplementedError(
            f"ptr_scores_int8 kernel: one query row and a width that is a multiple of 16 "
            f"up to 1024, got q {tuple(q.shape)}")
    dev = q.device
    _build.require(q, "q", torch.float32, (b, 1, d), dev)
    _build.require(k8, "k8", torch.int8, (b, n, d), dev)
    _build.require(ks, "ks", torch.float32, (b, n), dev)
    _build.require(mask, "mask", torch.float32, (b, n), dev)
    out = torch.empty((b, 1, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().vt_ptr_scores_int8(
            q.data_ptr(), k8.data_ptr(), ks.data_ptr(), mask.data_ptr(), out.data_ptr(), b, n,
            d, 1.0 / d ** 0.5, _build.stream_of(q))
    _build.check(err, "ptr_scores_int8")
    _build.LAUNCHES["ptr_scores_int8"] += 1
    return out
