"""The fused epilogue (#6) and the int8 pointer scores (#12) on the CPU:
ops/ptr_scores.py mirrors csrc/ptr_scores.cu's launch plan and its blocks'
walk over the keys, and its int8 -> f32 conversion (PRMT into 2^23's
mantissa, then one FADD); ops/decode_step.epilogue_block_of mirrors which
block of csrc/fused_epilogue.cu scores each work item.  These tests hold
the plan to cover every (batch row, key) exactly once and to fill the card
at batch 1, the conversion to be exact, a model of #12's arithmetic to be
its twin's, and a model of #6's (max, index) merge (warps, then blocks,
then the last block) to be torch.argmax's first maximum on inputs full of
ties.
"""

import math

import numpy as np
import pytest
import torch

from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.ops import decode_step as DS
from vitxtgqa_tpu_torch.ops import ptr_scores as PS


@pytest.mark.parametrize("n", [1, 100, 960, 961])
@pytest.mark.parametrize("batch", [1, 2, 8, 576])
def test_launch_plan_covers_every_key_once(batch, n):
    """Every (batch row, key) is scored by exactly one half warp of one
    block, every block holds at least one key, and the grid keeps to its
    form's limits (a tile a block in the spread form; at most PER_SM blocks
    an SM in the stream form)."""
    plan = PS.launch_plan(batch, n)
    keys = np.array([(blk, b, key) for blk, _, b, key in PS.tile_keys(plan, n)])
    flat = keys[:, 1] * n + keys[:, 2]
    assert len(flat) == batch * n
    assert np.array_equal(np.sort(flat), np.arange(batch * n))
    assert set(keys[:, 0]) == set(range(plan.grid))
    assert plan.keys_per_tile == plan.threads // 16 * plan.kh
    if plan.threads == PS.SPREAD_THREADS:
        assert plan.grid == plan.tiles
    else:
        assert plan.grid <= PS.SMS * PS.PER_SM
        assert batch * math.ceil(n / plan.keys_per_tile) >= PS.SMS


@pytest.mark.parametrize("batch", [1, 2])
def test_launch_plan_fills_the_card_at_small_batch(batch):
    """At the fused decode's batches over 960 OCR slots the keys spread
    over more blocks than the card has SMs; at the serving batch the
    stream form's tiles do too."""
    assert PS.launch_plan(batch, 960).grid >= PS.SMS
    assert PS.launch_plan(8, 960).grid >= PS.SMS


def test_bytes_to_f32_is_exact_for_every_int8_value():
    """2^23 + (e + 128) minus 2^23 + 128 in float32 is e, for all 256 e."""
    e = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    got = PS.bytes_to_f32(e)
    assert got.dtype == torch.float32
    assert torch.equal(got, e.float())


def ptr_scores_model(q, k8, ks, mask):
    """csrc/ptr_scores.cu's arithmetic in torch: each of 16 lanes sums its
    16-byte runs (bytes_to_f32 values times q) in order, the half warp
    adds the lanes by xor shuffles (8, 4, 2, 1), then acc * (ks * scale) +
    mask, each rounded once."""
    b, _, d = q.shape
    n = k8.shape[1]
    nc = -(-d // 256)
    pad = nc * 256 - d
    kf = torch.nn.functional.pad(PS.bytes_to_f32(k8), (0, pad)).reshape(b, n, nc, 16, 16)
    qf = torch.nn.functional.pad(q[:, 0], (0, pad)).reshape(b, 1, nc, 16, 16)
    lane = torch.zeros(b, n, 16)
    for i in range(nc):  # chunk i of every lane: bytes lane * 16 + i * 256 ..
        for t in range(16):
            lane = lane + qf[:, :, i, :, t] * kf[:, :, i, :, t]
    for o in (8, 4, 2, 1):
        lane = lane + lane[..., torch.arange(16) ^ o]
    scale = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32)
    return (lane[..., 0] * (ks * scale) + mask)[:, None, :]


@pytest.mark.parametrize("d", [768, 784])
def test_the_kernels_arithmetic_is_its_twins(d):
    """On q of small integers the model is the twin bit for bit (the dots
    are exact in any order, so only the scale's order counts); on random q
    within float32 rounding."""
    rng = np.random.default_rng(0)
    b, n = 3, 37
    from vitxtgqa_tpu_torch.ops.attention import quantize_kv

    k8, ks = quantize_kv(torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32)))
    mask = torch.from_numpy((rng.random((b, n)) < 0.7).astype(np.float32))
    qi = torch.from_numpy(rng.integers(-2, 3, (b, 1, d)).astype(np.float32))
    assert torch.equal(ptr_scores_model(qi, k8, ks, mask), PS.ptr_scores_int8_plain(qi, k8, ks, mask))
    q = torch.from_numpy(rng.standard_normal((b, 1, d)).astype(np.float32))
    torch.testing.assert_close(ptr_scores_model(q, k8, ks, mask),
                               PS.ptr_scores_int8_plain(q, k8, ks, mask), rtol=0, atol=1e-4)


def argmax_model(scores, qk: int, vp: int, grid: int):
    """csrc/fused_epilogue.cu's argmax over scores [B, W]: each warp keeps
    the best (value, index) of the items it scored (score j of batch row
    b is work item qk + j below vp, else qk + vp + (j - vp) * B + b, on
    warp item mod the grid's warps, numbered block-minor), each block
    merges its warps', the last block merges the blocks' partials, ties
    always to the lower index, whatever the order of the merge."""
    b, w = scores.shape
    better = lambda v, i, bv, bi: v > bv or (v == bv and i < bi)
    warps = DS.EPILOGUE_WARPS * grid
    item = lambda row, j: qk + j if j < vp else qk + vp + (j - vp) * b + row
    best = [[(-math.inf, 2 ** 31 - 1)] * warps for _ in range(b)]
    for row in range(b):
        for j in range(w - 1, -1, -1):  # the walk's order may not matter
            gw = item(row, j) % warps
            v = float(scores[row, j])
            if better(v, j, *best[row][gw]):
                best[row][gw] = (v, j)
    out = []
    for row in range(b):
        blocks = []
        for blk in range(grid):  # warp k of block blk is warp k * grid + blk of the grid
            bv, bi = best[row][blk]
            for k in range(1, DS.EPILOGUE_WARPS):
                if better(*best[row][k * grid + blk], bv, bi):
                    bv, bi = best[row][k * grid + blk]
            assert bi == 2 ** 31 - 1 or DS.epilogue_block_of(item(row, bi), grid) == blk
            blocks.append((bv, bi))
        bv, bi = -math.inf, 2 ** 31 - 1
        for v, i in reversed(blocks):
            if better(v, i, bv, bi):
                bv, bi = v, i
        out.append(bi)
    return torch.tensor(out)


@pytest.mark.parametrize("grid", [264, 132, 7])
@pytest.mark.parametrize("levels", [2, 5])
def test_argmax_merge_is_the_first_maximum(grid, levels):
    """Scores drawn from a few levels (every maximum tied many times over,
    across warps and blocks) give torch.argmax's index, the lowest of the
    tied maxima."""
    rng = np.random.default_rng(grid + levels)
    scores = torch.from_numpy(rng.integers(0, levels, (3, 5120 + 960)).astype(np.float32))
    scores[2, 4000:] = -1e30  # pad lanes, as the classifier's
    got = argmax_model(scores, 768, 5120, grid)
    assert torch.equal(got, scores.argmax(dim=-1))


def test_epilogue_block_of_spreads_the_items_over_the_grid():
    """Work item i belongs to warp i mod W of the grid's W warps, numbered
    block-minor: consecutive items land on consecutive blocks, and each
    block holds the same count of items, or one fewer, for any count."""
    grid, w = DS.EPILOGUE_BLOCKS_PER_SM * DS.H100_SMS, DS.EPILOGUE_WARPS
    owners = [DS.epilogue_block_of(i, grid) for i in range(4 * w * grid)]
    assert owners[:2 * grid] == list(range(grid)) * 2
    for n_items in (768 + 5120 + 960, 768 + 5120 + 2 * 960, 768 + 5120 + 8 * 960):
        counts = np.bincount(owners[:n_items], minlength=grid)
        assert counts.max() - counts.min() <= 1
