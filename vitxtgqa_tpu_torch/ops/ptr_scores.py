"""OCR pointer-net scores of a decode step over int8 keys: the kernel
wrapper and its plain PyTorch version.

Counterpart of vitxtgqa_tpu/ops/pallas_attention.py:ptr_scores_int8.  The
CUDA kernel is csrc/ptr_scores.cu; ``launch_plan`` and ``tile_keys`` mirror
its grid and its blocks' walk over the keys, and ``bytes_to_f32`` its
conversion of int8 values, for the CPU tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vitxtgqa_tpu_torch.ops import _build

# csrc/ptr_scores.cu's constants: the spread form (tiles of 4 keys, a half
# warp a key, on 64-thread blocks) for launches with fewer tiles of the
# stream form than SMs; the stream form (8 half warps x 4 keys = 32 keys a
# tile, 128-thread blocks, at most PER_SM blocks an SM, each on a
# contiguous range of tiles); the H100's SM count
SPREAD_THREADS, SPREAD_KH = 64, 1
STREAM_THREADS, STREAM_KH = 128, 4
PER_SM, SMS = 4, 132
MAGIC = 8388736.0  # 2^23 + 128
MAX_WIDTH = 2048  # csrc/ptr_scores.cu kMaxChunks: 16 lanes x 16 bytes x 8


class PtrPlan(NamedTuple):
    threads: int          # a half warp a key
    kh: int               # keys of one half warp in a tile
    keys_per_tile: int
    tiles_per_row: int
    tiles: int            # batch row major
    chunk: int            # tiles of a block
    grid: int


def launch_plan(batch: int, n: int, sms: int = SMS) -> PtrPlan:
    """The grid of one call over [batch, n] keys (csrc/ptr_scores.cu's
    launch_plan)."""
    stream_kpb = STREAM_THREADS // 16 * STREAM_KH
    spread = batch * -(-n // stream_kpb) < sms
    threads, kh = (SPREAD_THREADS, SPREAD_KH) if spread else (STREAM_THREADS, STREAM_KH)
    kpb = threads // 16 * kh
    tiles_per_row = -(-n // kpb)
    tiles = batch * tiles_per_row
    chunk = -(-tiles // (tiles if spread else sms * PER_SM))
    return PtrPlan(threads, kh, kpb, tiles_per_row, tiles, chunk, -(-tiles // chunk))


def tile_keys(plan: PtrPlan, n: int):
    """Yield (block, half warp, batch row, key) for every key a lane group
    of the kernel scores: block ``blk`` walks tiles [blk * chunk, (blk + 1)
    * chunk) below the tile count, half warp ``h`` takes keys ``tile *
    keys_per_tile + h + j * half_warps`` of each, j < kh, those below n."""
    hw = plan.threads // 16
    for blk in range(plan.grid):
        for t in range(blk * plan.chunk, min((blk + 1) * plan.chunk, plan.tiles)):
            b, tile = divmod(t, plan.tiles_per_row)
            for h in range(hw):
                for j in range(plan.kh):
                    key = tile * plan.keys_per_tile + h + j * hw
                    if key < n:
                        yield blk, h, b, key


def bytes_to_f32(k8: torch.Tensor) -> torch.Tensor:
    """The kernel's int8 -> f32 conversion, bit by bit: each byte with its
    sign bit flipped (e + 128) as the low mantissa of 2^23, then minus
    2^23 + 128 in float32."""
    u = (k8.to(torch.int32) & 0xFF) ^ 0x80
    f = (u | 0x4B000000).view(torch.float32)
    return f - torch.tensor(MAGIC, dtype=torch.float32)


def ptr_scores_int8_plain(q, k8, ks, mask):
    """q [B, 1, D] query projection; k8 [B, N, D] int8 keys with per-token
    scales ks [B, N] f32 (the quantize_kv layout); mask [B, N] the raw 0/1
    OCR mask, ADDED to the scores (the reference quirk).  Returns (q . k8)
    * (ks / sqrt(D)) + mask, [B, 1, N] f32."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bsd,bnd->bsn", q.float(), k8.float())
    return s * (ks.float() * scale)[:, None, :] + mask.float()[:, None, :]


def width_ok(d: int) -> bool:
    """Whether the kernel takes key width d: a multiple of 16 up to
    MAX_WIDTH."""
    return 0 < d <= MAX_WIDTH and d % 16 == 0


def ptr_scores_int8(q, k8, ks, mask):
    """The scores of ptr_scores_int8_plain in one launch (one query row)."""
    if not q.is_cuda:
        return ptr_scores_int8_plain(q, k8, ks, mask)
    b, s_len, d = q.shape
    n = k8.shape[1]
    if s_len != 1 or not width_ok(d):
        raise NotImplementedError(
            f"ptr_scores_int8 kernel: one query row and a width that is a multiple of 16 "
            f"up to {MAX_WIDTH} (ROADMAP queue 2 item 2), got q {tuple(q.shape)}")
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
