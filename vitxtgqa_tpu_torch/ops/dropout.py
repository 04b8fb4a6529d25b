"""Counter-based dropout masks: Philox4x32-10 in plain PyTorch.

The TPU kernels draw their dropout bits from the TPU's own generator,
seeded per grid block (pallas_attention._dropout_keep,
pallas_block_bwd._draw_block_masks).  The port's kernels use Philox4x32-10
(Salmon et al., SC'11; csrc/philox.cuh) instead, keyed by (seed, stream)
and counted by the element's coordinates, never by the block layout: the
bits of element (i3, i2, i1, i0) of a mask of shape [n3, n2, n1, n0] are
word ``i0 % 4`` of Philox(counter = (i0 // 4, i1, i2, i3), key = (seed,
stream)).  So the forward kernel, the backward kernel, a remat recompute
and this plain version all draw the same mask.  The keep test is the TPU
kernels': ``bits >= uint32(min(rate * 2**32, 2**32 - 1))``, so
P(keep) = 1 - rate to within 2**-32.

The JAX package's TPU stream cannot be reproduced; tests that hold the
port against JAX feed masks or run at rate 0.

Streams: the attention probabilities use stream 0; the post-attention
block's two masks (after the attention-output projection, after the FFN)
use streams 1 and 2.  The plain, materialised version computes the 32x32
bit products in 16-bit halves, so that nothing overflows int64.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
ROUNDS = 10

STREAM_ATTN, STREAM_BLOCK_A, STREAM_BLOCK_F = 0, 1, 2

Seed = Union[int, torch.Tensor]


def threshold(rate: float) -> int:
    """The uint32 keep threshold: keep where bits >= threshold."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def draw_seed(gen: torch.Generator, device) -> torch.Tensor:
    """One seed for a kernel-dropout site: an int64 tensor of shape [1] on
    ``device`` drawn from ``gen`` (kernels read it from device memory, so
    drawing it never waits for the device)."""
    s = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=gen.device)
    return s.to(device)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of the 64-bit product a * m, for int64 ``a``
    holding uint32 values; partial products of 16-bit halves."""
    al, ah = a & 0xFFFF, a >> 16
    ml, mh = m & 0xFFFF, m >> 16
    t0 = al * ml
    t1 = ah * ml + (t0 >> 16)
    t2 = al * mh + (t1 & 0xFFFF)
    hi = ah * mh + (t1 >> 16) + (t2 >> 16)
    lo = ((t2 & 0xFFFF) << 16) | (t0 & 0xFFFF)
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of counters (int64 tensors holding uint32 values,
    broadcastable) under key (k0, k1) (ints or int64 tensors); returns the
    four output words."""
    k0 = k0 & MASK32
    k1 = k1 & MASK32
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(seed: Seed, stream: int, shape: Sequence[int],
                device: Optional[torch.device] = None, row_offset: int = 0,
                head_offset: int = 0) -> torch.Tensor:
    """uint32 bits (as int64) of a mask of ``shape`` (up to 4 dims); with
    ``row_offset`` the rows (the second-to-last dim) of a mask whose
    coordinates start there: a sequence-parallel query shard's rows of
    the whole sequence's mask; with ``head_offset`` alike the heads (the
    third-to-last dim): a tensor-parallel rank's heads of the whole
    layer's mask."""
    if isinstance(seed, torch.Tensor):
        device = seed.device if device is None else device
        seed = seed.reshape(()).to(device=device, dtype=torch.int64)
    shape = tuple(shape)
    if len(shape) > 4:
        raise ValueError(f"philox_bits: at most 4 dims, got {shape}")
    n3, n2, n1, n0 = (1,) * (4 - len(shape)) + shape
    g0 = -(-n0 // 4)
    ar = lambda n, dim: torch.arange(n, device=device, dtype=torch.int64).reshape(
        [n if i == dim else 1 for i in range(4)])
    words = philox4x32(ar(g0, 3), ar(n1, 2) + row_offset, ar(n2, 1) + head_offset, ar(n3, 0),
                       seed, stream)
    full = torch.broadcast_shapes(*(w.shape for w in words))
    bits = torch.stack([w.expand(full) for w in words], dim=-1).reshape(n3, n2, n1, g0 * 4)
    return bits[..., :n0].reshape(shape)


def keep_mask(seed: Seed, stream: int, shape: Sequence[int], rate: float,
              device: Optional[torch.device] = None, row_offset: int = 0,
              head_offset: int = 0) -> torch.Tensor:
    """Bool keep mask of ``shape``: P(keep) = 1 - rate (``row_offset``,
    ``head_offset``: see philox_bits)."""
    return philox_bits(seed, stream, shape, device, row_offset, head_offset) >= threshold(rate)


def draw_keep(shape, rate: float, gen: torch.Generator, device,
              shard: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """The keep mask that ``dropout`` draws from ``gen`` for an x of
    ``shape`` on ``device`` (``shard``: see dropout).  Drawn apart, it can
    be replayed: a layer's recompute (Options.remat "full") applies the
    masks its forward drew."""
    shape = list(shape)
    if shard is not None:
        shape[shard[0]] *= shard[2]
    keep = torch.rand(shape, generator=gen, device=gen.device).to(device) >= rate
    if shard is not None:
        keep = keep.chunk(shard[2], dim=shard[0])[shard[1]]
    return keep


def apply_keep(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """``where(keep, x / (1 - rate), 0)``; x itself where ``keep`` is None."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
            shard: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """An ordinary dropout site (embeddings, modality streams, the text
    BERT's attention probabilities) with flax nn.Dropout semantics:
    ``where(keep, x / (1 - rate), 0)``, the keep mask drawn from ``gen``; a
    no-op without a generator (eval) or at rate 0.  ``shard`` (dim, rank,
    size): x is rank's 1 / size of a tensor along dim (a tensor-parallel
    rank's heads), whose mask is that part of the whole tensor's draw, so
    that every rank's generator stays in step with one process's."""
    if gen is None or rate <= 0.0:
        return x
    return apply_keep(x, draw_keep(x.shape, rate, gen, x.device, shard), rate)
