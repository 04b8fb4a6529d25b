"""Attention-mask builders for the joint multimodal transformer.

Counterpart of vitxtgqa_tpu/ops/masks.py.  The additive mask value stays
-10000 (BERT style, kept for parity with the reference); the kernels
build their masks in-kernel from the compact specs below and fill masked
scores with -1e9 instead.  A key-mask entry > 0 is an allowed key on every
path, as in the kernels (and the JAX package's Pallas kernels): MIST's
frame mask holds 2.0 where a frame was picked twice, which the JAX
package's XLA bias ``(1 - m) * -10000`` turns into a +10000 bonus (the
reference's quirk) and these builders do not; nor do they pass a gradient
into the mask (ROADMAP.md §3).
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = -10000.0


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Compact mask for full-sequence attention.

    key_mask: [B, L] — 1 where the key is a valid encoder token (decoder
        slots and padding are 0).
    dec_len: length of the trailing causal decoder block (0 = plain
        key-validity masking).
    """

    key_mask: torch.Tensor
    dec_len: int = 0

    def to_bias(self) -> torch.Tensor:
        if self.dec_len == 0:
            return self_attention_bias(self.key_mask)
        enc = self.key_mask[:, : self.key_mask.shape[1] - self.dec_len]
        return prefix_lm_bias(enc, self.dec_len)


@dataclasses.dataclass(frozen=True)
class DecodeStepSpec:
    """Compact mask for one cached decode step.

    key_mask: [B, Lcache] — 1 where the cache slot holds a valid encoder key.
    step: decoder position (a Python int: the port's decode loop is a
        Python loop).
    write_offset: index of decoder slot 0 inside the unified cache.

    The query attends valid encoder keys and the decoder slots
    ``write_offset .. write_offset + step``.
    """

    key_mask: torch.Tensor
    step: int
    write_offset: int = 0

    def to_bias(self) -> torch.Tensor:
        cols = torch.arange(self.key_mask.shape[1], device=self.key_mask.device)[None, :]
        dec_ok = (cols >= self.write_offset) & (cols <= self.write_offset + self.step)
        ok = (self.key_mask > 0) | dec_ok
        return ((1.0 - ok.float()) * NEG_INF)[:, None, None, :]


def joint_mask_spec(enc_mask: torch.Tensor, dec_len: int) -> MaskSpec:
    """enc_mask [B, Lenc] -> MaskSpec over the joint [enc | dec] sequence."""
    zeros = enc_mask.new_zeros((enc_mask.shape[0], dec_len))
    return MaskSpec(key_mask=torch.cat([enc_mask, zeros], dim=1), dec_len=dec_len)


def local_rows_bias(key_mask_full: torch.Tensor, dec_len: int, row_offset: int,
                    l_local: int) -> torch.Tensor:
    """Additive bias [B, 1, l_local, L] of the query rows row_offset ..
    row_offset + l_local of a sequence-parallel shard, from the full [B, L]
    key mask: MaskSpec(key_mask_full, dec_len).to_bias()'s rows (every row
    sees the valid encoder keys; rows in the decoder block also see the
    decoder keys causally) — vitxtgqa_tpu/parallel/sequence_parallel.py
    _local_rows_bias."""
    l = key_mask_full.shape[1]
    l_enc = l - dec_len
    dev = key_mask_full.device
    rows = row_offset + torch.arange(l_local, device=dev)[:, None]
    cols = torch.arange(l, device=dev)[None, :]
    allowed = (key_mask_full > 0)[:, None, :]
    if dec_len > 0:
        causal = (cols >= l_enc) & (rows >= l_enc) & (cols <= rows)
        allowed = allowed | causal[None]
    return torch.where(allowed, 0.0, NEG_INF)[:, None]


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] float mask, 1 on valid positions."""
    ar = torch.arange(max_len, device=lengths.device)[None, :]
    return (ar < lengths[:, None]).float()


def causal_mask(n: int, device=None) -> torch.Tensor:
    """[n, n] lower-triangular float mask."""
    return torch.tril(torch.ones((n, n), dtype=torch.float32, device=device))


def _bias(allowed: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """0 where ``allowed``, NEG_INF elsewhere, in ``like``'s dtype."""
    return torch.where(allowed, 0.0, NEG_INF).to(like.dtype)


def self_attention_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """[B, L] key mask -> [B, 1, 1, L] additive bias."""
    return _bias(key_mask > 0, key_mask)[:, None, None, :]


def prefix_lm_bias(enc_mask: torch.Tensor, dec_len: int) -> torch.Tensor:
    """Joint prefix-LM + causal-decoder additive bias [B, 1, T, T],
    T = Lenc + dec_len: every row attends valid encoder tokens; decoder
    tokens are visible only to decoder rows, causally."""
    b, lenc = enc_mask.shape
    total = lenc + dec_len
    key_ok = torch.cat([enc_mask > 0, enc_mask.new_zeros((b, dec_len), dtype=torch.bool)], dim=1)
    allowed = key_ok[:, None, :].expand(b, total, total).clone()
    allowed[:, lenc:, lenc:] = causal_mask(dec_len, enc_mask.device) > 0
    return _bias(allowed, enc_mask)[:, None, :, :]

