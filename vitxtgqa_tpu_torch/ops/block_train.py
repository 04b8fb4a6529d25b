"""The training post-attention block: the forward kernel (#9a) and the
backward kernel (#9b) wrappers and their plain PyTorch versions.

Counterpart of vitxtgqa_tpu/ops/pallas_block_bwd.py:block_train — the
block ``y = LN2(x + drop_f(gelu(x W1^T + b1) W2^T + b2))`` with ``x =
LN1(x_q + drop_a(ctx Wo^T + bo))``, whose forward emits the residuals
(x1h, pre1, h, x2h) and whose backward returns every input, weight, bias and
LayerNorm gradient in one call.  The CUDA kernels are csrc/block_train.cu.
Weights are in nn.Linear layout ([out, in]); biases and LayerNorm vectors
are taken in float32; weight gradients come back float32 in the same
layout.  On a CUDA tensor a wrapper launches its kernel (or raises); on a
CPU tensor it runs the plain version.  ``launch_plan`` cuts the backward's
reductions over the rows (the LayerNorm row passes' grid, the weight
gradients' split of the rows) and sizes their scratch; ``gemm_launches``
lists the GEMM launches of both kernels.

Dropout: the kernels take a seed (an int64 [1] tensor) and draw the two
masks in-kernel: the Philox bits of element (row, col) of the [rows, d]
mask in streams 1 and 2 (ops/dropout.py).  The plain versions take
explicit keep masks (the JAX mask mode), so ``block_train_plain`` can be
held against JAX's ``block_train(mask_a, mask_f, interpret=True)``; where
a wrapper runs its plain version, it materialises the seed's masks for it
(``seed_masks``).

Tensor parallelism (``BlockTrainTPFn``, ``block_train_fwd_tp_steps``,
``block_train_bwd_tp_steps``): the split forms on a rank's shards (wo [d,
dl], w1 [ml, d], b1 [ml], w2 [d, ml]; parallel/tensor_parallel.py), the
kernels' launches with the model group's all-reduce of an f32 partial
between them: in the forward after the attention-output and the FFN-out
products, in the backward after the input gradient of the FFN-in product
(dh_l W1_l).  The masks are the whole rows', drawn from the one seed on
every rank.  dbo, db2 and the LayerNorm gradients come out whole on every
rank, db1 and the weight gradients as the rank's shards.  A share is a
multiple of 64 columns (check_tp_widths): at model 4 a rank's 192
attention columns take the GEMM body's thin tiles in the dctx and
weight-gradient launches.  Each is a generator of its steps, as
ops/fused_block.fused_block_tp_steps; its plain twin is the same sequence
in PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops import dropout as D
from vitxtgqa_tpu_torch.ops import gemm_sm90 as G
from vitxtgqa_tpu_torch.ops.fused_block import (LANE, check_hidden, check_tp_widths, gelu_erf,
                                                gemm_f32)
from vitxtgqa_tpu_torch.parallel import tensor_parallel as TP

GRAD_NAMES = ("x_q", "ctx", "wo", "bo", "s1", "g1", "w1", "b1", "w2", "b2", "s2", "g2")

# csrc/block_train.cu's constants: the GEMM tile's rows and its K step
# (gemm_sm90.cuh), the LayerNorm row passes' rows a block (a warp a row)
# and their grid's cap (two blocks on each of the H100's 132 SMs); then
# the weight gradients' split of the rows: at most MAX_SPLITS splits of at
# least SPLIT_ROWS rows, so that their one launch fills the card at the
# training shape (162 tiles of 128 x 256 x 4 splits: ~4.9 waves of 132
# blocks)
TILE_M, K_STEP = G.TILE_M, G.K_STEP
ROWS_PER_BLOCK, ROW_BLOCKS_MAX = 8, 2 * 132
MAX_SPLITS, SPLIT_ROWS = 4, 2048


class BlockPlan(NamedTuple):
    m_tiles: int      # 128-row tiles of the activation products
    row_blocks: int   # blocks of the LayerNorm row passes, one column-sum partial each
    k_chunk: int      # rows of one split of the weight gradients (a multiple of K_STEP)
    splits: int       # splits of the rows; the last holds rows - (splits - 1) * k_chunk
    col_floats: int   # f32 scratch of the column-sum partials
    w_floats: int     # f32 scratch of the weight-gradient partials (0 with one split)


def launch_plan(rows: int, d: int, m: int, dl: int = 0) -> BlockPlan:
    """The backward's cut of its ``rows``: the row passes' grid (each
    block's warps take rows blockIdx * 8 + warp, then every row_blocks * 8
    further) and the weight gradients' split of the rows, with the scratch
    that csrc/block_train.cu's vt_block_train_bwd reads them from: per row
    pass and block three [d] column sums (LN2: ds2, dg2, db2; LN1: ds1,
    dg1, dbo), per 128-row tile db1's [m], and per split the three f32
    weight-gradient partials.  ``dl`` (default d): the attention width a
    split form's rank holds (dWo [d, dl]); m its FFN share."""
    if rows <= 0:
        raise ValueError(f"block_train: {rows} rows")
    m_tiles = -(-rows // TILE_M)
    row_blocks = min(-(-rows // ROWS_PER_BLOCK), ROW_BLOCKS_MAX)
    splits = max(1, min(MAX_SPLITS, rows // SPLIT_ROWS))
    k_chunk = -(-(-(-rows // splits)) // K_STEP) * K_STEP
    splits = -(-rows // k_chunk)
    dl = dl or d
    return BlockPlan(m_tiles, row_blocks, k_chunk, splits, 2 * row_blocks * 3 * d + m_tiles * m,
                     splits * (d * dl + 2 * m * d) if splits > 1 else 0)


def gemm_launches(rows: int, d: int, m: int):
    """csrc/block_train.cu's GEMM launches (ops/gemm_sm90.py), in order:
    the forward's F1 ctx Wo^T, F3 xb W1^T, F4 h W2^T; the backward's B2
    dlin2 W2, B3 dpre W1, B5 dlin1 Wo and B6, the three weight gradients
    in one launch, their reduction over the rows split by launch_plan."""
    k_chunk = launch_plan(rows, d, m).k_chunk
    one = lambda n, k: G.launch(G.problem(rows, n, k))
    return (one(d, d), one(m, d), one(d, m), one(m, d), one(d, m), one(d, d),
            G.launch(G.problem(d, d, rows, k_chunk), G.problem(m, d, rows, k_chunk),
                     G.problem(d, m, rows, k_chunk), ragged_k=True))


def tp_gemm_launches(rows: int, d: int, dl: int, ml: int):
    """The split forms' GEMM launches on a rank's shares, in order: the
    forward's F1 ctx_l Wo_l^T and F4 h_l W2_l^T into f32 partials, F3 xb
    W1_l^T; the backward's B2 dlin2 W2_l, B3 dpre_l W1_l into an f32
    partial, B5 dlin1 Wo_l, and B6's three weight gradients in one launch."""
    k_chunk = launch_plan(rows, d, ml, dl).k_chunk
    one = lambda n, k: G.launch(G.problem(rows, n, k))
    return (one(d, dl), one(ml, d), one(d, ml), one(ml, d), one(d, ml), one(dl, d),
            G.launch(G.problem(d, dl, rows, k_chunk), G.problem(ml, d, rows, k_chunk),
                     G.problem(d, ml, rows, k_chunk), ragged_k=True))


def kernel_ok(d: int, m: int) -> bool:
    """The JAX gate block_bwd_kernel_ok: lane-aligned widths."""
    return d % LANE == 0 and m % LANE == 0


def gelu_erf_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx gelu(x) = Phi(x) + x phi(x) (pallas_block_bwd._gelu_grad)."""
    return 0.5 * (1.0 + torch.erf(x * 0.7071067811865476)) + x * torch.exp(-0.5 * x * x) * 0.3989422804014327


def _stats(x: torch.Tensor, eps: float):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (x - mu) * inv, inv


def _ln_bwd(g, xhat, inv, scale):
    """Input gradient of y = xhat * scale + bias (pallas_block_bwd._ln_bwd)."""
    dxh = g * scale
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    return inv * (dxh - m1 - xhat * m2)


def masks_from_seed(seed, rows: int, d: int, rate: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two keep masks [rows, d] that the kernels draw from ``seed``."""
    return (D.keep_mask(seed, D.STREAM_BLOCK_A, (rows, d), rate, device),
            D.keep_mask(seed, D.STREAM_BLOCK_F, (rows, d), rate, device))


def seed_masks(seed, rows: int, d: int, rate: float, device):
    """The plain versions' (mask_a, mask_f) for a kernel's seed: the
    seed's masks, or (None, None) without dropout."""
    return masks_from_seed(seed, rows, d, rate, device) if rate > 0.0 else (None, None)


def _drop(x, mask, rate: float):
    if rate <= 0.0:
        return x
    return torch.where(mask != 0, x * (1.0 / (1.0 - rate)), torch.zeros_like(x))


def block_train_fwd_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2,
                          mask_a=None, mask_f=None, rate: float = 0.0, eps: float = 1e-12,
                          reduce=None, copy=None):
    """(y, x1h, pre1, h, x2h), rows [R, d] / [R, m] in x_q's dtype: f32
    products from operands in x_q's dtype, f32 LayerNorm statistics, and
    the kernel's roundings (x1h, x2h rounded before their LayerNorm, pre1
    before the gelu).  ``reduce``: applied to the attention-output and
    FFN-out products (a tensor-parallel rank's partials summed, under
    autograd: tensor_parallel.reduce_from_model); None, the products.
    ``copy``: applied to the FFN-in product's input (under tensor
    parallelism tensor_parallel.copy_to_model, which sums its gradient's
    partials)."""
    steps = _fwd_steps_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, mask_a, mask_f,
                             rate, eps, copy)
    return TP.drive([steps], (lambda parts: reduce(parts[0])) if reduce else TP.shard_sum)[0]


def _fwd_steps_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, mask_a, mask_f, rate,
                     eps, copy=None):
    """block_train_fwd_plain as steps: yields the two f32 row-parallel
    products, takes their sums."""
    dt = x_q.dtype
    mm = lambda a, w: torch.matmul(a.to(dt).float(), w.to(dt).float().t())
    attn = _drop((yield mm(ctx, wo)) + bo.float(), mask_a, rate)
    x1h = (x_q.float() + attn).to(dt)
    x = _ln1(x1h, s1, g1, eps)
    pre1 = (mm(x if copy is None else copy(x), w1) + b1.float()).to(dt)
    h = gelu_erf(pre1.float()).to(dt)
    ffn = _drop((yield mm(h, w2)) + b2.float(), mask_f, rate)
    x2h = (x.float() + ffn).to(dt)
    xhat2, _ = _stats(x2h.float(), eps)
    y = (xhat2 * s2.float() + g2.float()).to(dt)
    return y, x1h, pre1, h, x2h


def _ln1(x1h, s1, g1, eps):
    """x = bf16(LN1(x1h)) in x1h's dtype."""
    xhat1, _ = _stats(x1h.float(), eps)
    return (xhat1 * s1.float() + g1.float()).to(x1h.dtype)


def block_train_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2,
                      mask_a=None, mask_f=None, rate: float = 0.0, eps: float = 1e-12):
    """The block's output y alone (differentiable: the autograd oracle of
    the backward kernel)."""
    return block_train_fwd_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2,
                                 mask_a, mask_f, rate, eps)[0]


def block_train_bwd_plain(g, ctx, x1h, pre1, h, x2h, wo, w1, w2, s1, g1, s2,
                          mask_a=None, mask_f=None, rate: float = 0.0, eps: float = 1e-12):
    """The 12 gradients (dx_q, dctx, dWo, dbo, ds1, dg1, dW1, db1, dW2, db2,
    ds2, dg2) for the cotangent ``g`` of y, from the forward's residuals:
    the sequence of the Pallas kernel (_block_bwd_kernel) with its bf16
    roundings of dlin2, dpre and dlin1 before their products."""
    steps = _bwd_steps_plain(g, ctx, x1h, pre1, h, x2h, wo, w1, w2, s1, g1, s2, mask_a, mask_f,
                             rate, eps)
    return TP.drive([steps], TP.shard_sum)[0]


def _bwd_steps_plain(g, ctx, x1h, pre1, h, x2h, wo, w1, w2, s1, g1, s2, mask_a, mask_f, rate,
                     eps):
    """block_train_bwd_plain as steps: yields the f32 partial dpre W1 of
    the FFN-in input gradient, takes its sum."""
    dt = ctx.dtype
    f = lambda t: t.to(dt).float()
    gf = g.float()
    s1f, g1f, s2f = s1.float(), g1.float(), s2.float()
    xhat2, inv2 = _stats(x2h.float(), eps)
    ds2, dg2 = (gf * xhat2).sum(0), gf.sum(0)
    du2 = _ln_bwd(gf, xhat2, inv2, s2f)
    dlin2 = _drop(du2, mask_f, rate)
    db2 = dlin2.sum(0)
    dlin2 = f(dlin2)
    dw2 = dlin2.t() @ f(h)
    dpre = (dlin2 @ f(w2)) * gelu_erf_grad(pre1.float())
    db1 = dpre.sum(0)
    dpre = f(dpre)
    xhat1, inv1 = _stats(x1h.float(), eps)
    x = f(xhat1 * s1f + g1f)
    dw1 = dpre.t() @ x
    dx = du2 + (yield dpre @ f(w1))
    ds1, dg1 = (dx * xhat1).sum(0), dx.sum(0)
    du1 = _ln_bwd(dx, xhat1, inv1, s1f)
    dlin1 = _drop(du1, mask_a, rate)
    dbo = dlin1.sum(0)
    dlin1 = f(dlin1)
    dctx = (dlin1 @ f(wo)).to(dt)
    dwo = dlin1.t() @ f(ctx)
    return (du1.to(dt), dctx, dwo, dbo, ds1, dg1, dw1, db1, dw2, db2, ds2, dg2)


def _vec(t, n, name, dev):
    t = t.to(torch.float32).contiguous()
    _build.require(t, name, torch.float32, (n,), dev)
    return t


def _dropout_inputs(rate, seed, dev):
    """(seed, threshold, keep_scale) for a launch."""
    if rate <= 0.0:
        return None, 0, 1.0
    if seed is None:
        raise ValueError("block_train: dropout needs a seed")
    _build.require(seed, "seed", torch.int64, (1,), dev)
    return seed, D.threshold(rate), 1.0 / (1.0 - rate)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def check_widths(name: str, d: int, m: int) -> None:
    """Raise unless csrc/block_train.cu takes these widths: what JAX's gate
    block_bwd_kernel_ok routes to its kernel, a lane-aligned hidden width
    (the LayerNorm row passes, up to fused_block.MAX_HIDDEN) and an FFN
    width a multiple of the narrow GEMM tile's 128 columns."""
    check_hidden(name, d)
    if m <= 0 or m % G.NARROW_N:
        raise NotImplementedError(
            f"{name} kernel: an FFN width a multiple of {G.NARROW_N} (the narrow GEMM tile's "
            f"columns), got d={d}, m={m}")


def block_train_fwd(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, rate: float = 0.0,
                    seed=None, eps: float = 1e-12, emit_masks: bool = False):
    """Forward kernel (#9a) on [rows, d] operands: (y, x1h, pre1, h, x2h),
    and with ``emit_masks`` (dropout on) also the two int8 masks it drew.
    On CPU tensors the plain version on the seed's masks."""
    rows, d = x_q.shape
    m = w1.shape[0]
    if emit_masks and (seed is None or rate <= 0.0):
        raise ValueError("block_train_fwd: emit_masks needs dropout (a seed and rate > 0)")
    if not x_q.is_cuda:
        mask_a, mask_f = seed_masks(seed, rows, d, rate, x_q.device)
        out = block_train_fwd_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2,
                                    mask_a, mask_f, rate, eps)
        if emit_masks:
            out = out + (mask_a.to(torch.int8), mask_f.to(torch.int8))
        return out
    check_widths("block_train_fwd", d, m)
    dev = x_q.device
    bf = torch.bfloat16
    _build.require(x_q, "x_q", bf, (rows, d), dev)
    _build.require(ctx, "ctx", bf, (rows, d), dev)
    _build.require(wo, "wo", bf, (d, d), dev)
    _build.require(w1, "w1", bf, (m, d), dev)
    _build.require(w2, "w2", bf, (d, m), dev)
    bo, s1, g1, b2, s2, g2 = (_vec(t, d, n, dev) for t, n in
                              ((bo, "bo"), (s1, "s1"), (g1, "g1"), (b2, "b2"), (s2, "s2"), (g2, "g2")))
    b1 = _vec(b1, m, "b1", dev)
    seed, thr, ks = _dropout_inputs(rate, seed, dev)
    empty = lambda w, dt=bf: torch.empty((rows, w), dtype=dt, device=dev)
    y, x1h, x2h, xb = empty(d), empty(d), empty(d), empty(d)
    pre1, h = empty(m), empty(m)
    ma_out = mf_out = None
    if emit_masks:
        ma_out, mf_out = empty(d, torch.int8), empty(d, torch.int8)
    with torch.cuda.device(dev):
        err = _build.lib().vt_block_train_fwd(
            x_q.data_ptr(), ctx.data_ptr(), wo.data_ptr(), bo.data_ptr(), s1.data_ptr(),
            g1.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            s2.data_ptr(), g2.data_ptr(), _ptr(seed), _ptr(ma_out), _ptr(mf_out), y.data_ptr(),
            x1h.data_ptr(), pre1.data_ptr(), h.data_ptr(), x2h.data_ptr(), xb.data_ptr(), rows,
            d, m, thr, ks, float(eps), _build.stream_of(x_q),
        )
    _build.check(err, "block_train_fwd")
    _build.LAUNCHES["block_train_fwd"] += 1
    out = (y, x1h, pre1, h, x2h)
    return out + (ma_out, mf_out) if emit_masks else out


def block_train_bwd(g, ctx, x1h, pre1, h, x2h, wo, w1, w2, s1, g1, s2, rate: float = 0.0,
                    seed=None, eps: float = 1e-12):
    """Backward kernel (#9b): the 12 gradients for the cotangent ``g``
    [rows, d] of y (dx_q and dctx bf16, the rest f32), the masks
    regenerated from the forward's seed.  On CPU tensors the plain version
    on the seed's masks."""
    rows, d = ctx.shape
    m = w1.shape[0]
    if not g.is_cuda:
        mask_a, mask_f = seed_masks(seed, rows, d, rate, g.device)
        return block_train_bwd_plain(g, ctx, x1h, pre1, h, x2h, wo, w1, w2, s1, g1, s2,
                                     mask_a, mask_f, rate, eps)
    check_widths("block_train_bwd", d, m)
    dev = g.device
    bf, f32 = torch.bfloat16, torch.float32
    for name, t, w in (("g", g, d), ("ctx", ctx, d), ("x1h", x1h, d), ("x2h", x2h, d),
                       ("pre1", pre1, m), ("h", h, m)):
        _build.require(t, name, bf, (rows, w), dev)
    _build.require(wo, "wo", bf, (d, d), dev)
    _build.require(w1, "w1", bf, (m, d), dev)
    _build.require(w2, "w2", bf, (d, m), dev)
    s1, g1, s2 = (_vec(t, d, n, dev) for t, n in ((s1, "s1"), (g1, "g1"), (s2, "s2")))
    seed, thr, ks = _dropout_inputs(rate, seed, dev)
    new = lambda *shape, dt=f32: torch.empty(shape, dtype=dt, device=dev)
    dxq, dctx = new(rows, d, dt=bf), new(rows, d, dt=bf)
    dwo, dw1, dw2 = new(d, d), new(m, d), new(d, m)
    dbo, ds1, dg1, db2, ds2, dg2, db1 = new(d), new(d), new(d), new(d), new(d), new(d), new(m)
    du2 = new(rows, d)
    dlin2, xb, dlin1 = new(rows, d, dt=bf), new(rows, d, dt=bf), new(rows, d, dt=bf)
    dpre = new(rows, m, dt=bf)
    plan = launch_plan(rows, d, m)
    col_part, w_part = new(plan.col_floats), new(max(plan.w_floats, 4))
    with torch.cuda.device(dev):
        err = _build.lib().vt_block_train_bwd(
            g.data_ptr(), ctx.data_ptr(), x1h.data_ptr(), pre1.data_ptr(), h.data_ptr(),
            x2h.data_ptr(), wo.data_ptr(), w1.data_ptr(), w2.data_ptr(), s1.data_ptr(),
            g1.data_ptr(), s2.data_ptr(), _ptr(seed), dxq.data_ptr(), dctx.data_ptr(),
            dwo.data_ptr(), dbo.data_ptr(), ds1.data_ptr(), dg1.data_ptr(), dw1.data_ptr(),
            db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), ds2.data_ptr(), dg2.data_ptr(),
            du2.data_ptr(), dlin2.data_ptr(), dpre.data_ptr(), xb.data_ptr(), dlin1.data_ptr(),
            col_part.data_ptr(), w_part.data_ptr(), plan.row_blocks, plan.k_chunk,
            rows, d, m, thr, ks, float(eps), _build.stream_of(g),
        )
    _build.check(err, "block_train_bwd")
    _build.LAUNCHES["block_train_bwd"] += 1
    return (dxq, dctx, dwo, dbo, ds1, dg1, dw1, db1, dw2, db2, ds2, dg2)


# the remat modes under which the block keeps x_q, ctx and the seed and
# recomputes its residuals in the backward; "none" and "dots" keep them
# (the residuals are outputs of the block's products: JAX's dots_saveable
# keeps them)
RECOMPUTES = ("attn", "attn_qkv", "full")


class BlockTrainFn(torch.autograd.Function):
    """The training block as one autograd node over the two kernels (the
    JAX ``block_train`` custom VJP).  Under a ``remat`` mode of RECOMPUTES
    it saves only x_q, ctx and the dropout seed and relaunches the forward
    kernel in the backward for the residuals (JAX's remat "attn" with
    fused_block_fwd); under "none" and "dots" it saves the residuals.
    ``plain`` runs the plain versions on the seed's masks on any device
    (Options.plain)."""

    @staticmethod
    def forward(fctx, x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, rate, eps, seed, remat,
                plain):
        shape, d = x_q.shape, x_q.shape[-1]
        x2, c2 = x_q.reshape(-1, d).contiguous(), ctx.reshape(-1, d).contiguous()
        fctx.cfg = (shape, rate, eps, remat, plain)
        res = _block_forward(x2, c2, (wo, bo, s1, g1, w1, b1, w2, b2, s2, g2), rate, eps, seed,
                             plain)
        if remat in RECOMPUTES:
            fctx.save_for_backward(x2, c2, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, seed)
        else:
            fctx.save_for_backward(c2, *res[1:], wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, seed)
        return res[0].reshape(shape)

    @staticmethod
    def backward(fctx, gy):
        shape, rate, eps, remat, plain = fctx.cfg
        saved = fctx.saved_tensors
        if remat in RECOMPUTES:
            x2, c2, *weights, seed = saved
            _, x1h, pre1, h, x2h = _block_forward(x2, c2, weights, rate, eps, seed, plain)
        else:
            c2, x1h, pre1, h, x2h, *weights, seed = saved
        wo, bo, s1, g1, w1, b1, w2, b2, s2, g2 = weights
        d = shape[-1]
        args = (gy.reshape(-1, d).to(c2.dtype).contiguous(), c2, x1h, pre1, h, x2h, wo, w1, w2,
                s1, g1, s2)
        if plain:
            grads = block_train_bwd_plain(*args, *seed_masks(seed, c2.shape[0], d, rate, c2.device),
                                          rate, eps)
        else:
            grads = block_train_bwd(*args, rate=rate, seed=seed, eps=eps)
        dxq, dctx, dwo, dbo, ds1, dg1, dw1, db1, dw2, db2, ds2, dg2 = grads
        like = lambda gr, p: gr.to(p.dtype)
        return (dxq.reshape(shape), dctx.reshape(shape), like(dwo, wo), like(dbo, bo),
                like(ds1, s1), like(dg1, g1), like(dw1, w1), like(db1, b1), like(dw2, w2),
                like(db2, b2), like(ds2, s2), like(dg2, g2)) + (None,) * 5


def _block_forward(x2, c2, weights, rate, eps, seed, plain):
    """(y, x1h, pre1, h, x2h) through the forward kernel, or (``plain``)
    its plain version on the seed's masks."""
    if plain:
        masks = seed_masks(seed, x2.shape[0], x2.shape[1], rate, x2.device)
        return block_train_fwd_plain(x2, c2, *weights, *masks, rate, eps)
    return block_train_fwd(x2, c2, *weights, rate=rate, seed=seed, eps=eps)


# ---------------------------------------------------------------------------
# the split forms (tensor parallelism)
# ---------------------------------------------------------------------------


def _fwd_steps_kernel(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, rate, seed, eps,
                      emit_masks):
    rows, d = x_q.shape
    dl, ml = wo.shape[1], w1.shape[0]
    check_tp_widths("block_train_fwd_tp", d, dl, ml)
    dev, bf = x_q.device, torch.bfloat16
    _build.require(x_q, "x_q", bf, (rows, d), dev)
    _build.require(ctx, "ctx", bf, (rows, dl), dev)
    _build.require(w1, "w1", bf, (ml, d), dev)
    _build.require(w2, "w2", bf, (d, ml), dev)
    bo, s1, g1, b2, s2, g2 = (_vec(t, d, n, dev) for t, n in (
        (bo, "bo"), (s1, "s1"), (g1, "g1"), (b2, "b2"), (s2, "s2"), (g2, "g2")))
    b1 = _vec(b1, ml, "b1", dev)
    seed, thr, ks = _dropout_inputs(rate, seed, dev)
    empty = lambda w, dt=bf: torch.empty((rows, w), dtype=dt, device=dev)
    masks = (empty(d, torch.int8), empty(d, torch.int8)) if emit_masks else (None, None)
    lib, st = _build.lib(), _build.stream_of(x_q)

    def rows_pass(total, bias, resid, s, g, stream_id, mask_out):
        xh, out = empty(d), empty(d)
        with torch.cuda.device(dev):
            _build.check(lib.vt_block_train_tp_rows(
                total.data_ptr(), bias.data_ptr(), resid.data_ptr(), s.data_ptr(), g.data_ptr(),
                _ptr(seed), _ptr(mask_out), xh.data_ptr(), out.data_ptr(), rows, d, stream_id,
                thr, ks, float(eps), st), "block_train_fwd_tp")
        return xh, out

    x1h, xb = rows_pass((yield gemm_f32(ctx, wo)), bo, x_q, s1, g1, 1, masks[0])
    pre1, h = empty(ml), empty(ml)
    with torch.cuda.device(dev):
        _build.check(lib.vt_block_train_tp_ffn_in(xb.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                                  pre1.data_ptr(), h.data_ptr(), rows, d, ml,
                                                  st), "block_train_fwd_tp")
    x2h, y = rows_pass((yield gemm_f32(h, w2)), b2, xb, s2, g2, 2, masks[1])
    _build.LAUNCHES["block_train_fwd_tp"] += 1
    out = (y, x1h, pre1, h, x2h)
    return out + masks if emit_masks else out


def block_train_fwd_tp_steps(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2,
                             rate: float = 0.0, seed=None, eps: float = 1e-12,
                             plain: bool = False, emit_masks: bool = False):
    """One rank's split form of the forward (#9a) on [rows, d] operands and
    its shards (ctx [rows, dl], wo [d, dl], w1 [ml, d], b1 [ml], w2 [d,
    ml]) as a generator: it yields the f32 [rows, d] partials of the
    attention-output and FFN-out products, takes their sums, and returns
    (y, x1h, pre1, h, x2h) (pre1, h the rank's [rows, ml]), with
    ``emit_masks`` also the two int8 masks drawn.  The kernels on a CUDA
    tensor, the plain twin on the seed's masks on a CPU one or with
    ``plain``."""
    rows, d = x_q.shape
    if plain or not x_q.is_cuda:
        masks = seed_masks(seed, rows, d, rate, x_q.device)
        return _fwd_steps_masks(_fwd_steps_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2,
                                                 g2, *masks, rate, eps), masks, emit_masks)
    return _fwd_steps_kernel(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, rate, seed, eps,
                             emit_masks)


def _fwd_steps_masks(steps, masks, emit_masks):
    out = yield from steps
    return out + tuple(m.to(torch.int8) for m in masks) if emit_masks else out


def _bwd_steps_kernel(g, ctx, x1h, pre1, h, x2h, wo, w1, w2, s1, g1, s2, rate, seed, eps):
    rows, d = g.shape
    dl, ml = wo.shape[1], w1.shape[0]
    check_tp_widths("block_train_bwd_tp", d, dl, ml)
    dev = g.device
    bf, f32 = torch.bfloat16, torch.float32
    for name, t, w in (("g", g, d), ("ctx", ctx, dl), ("x1h", x1h, d), ("x2h", x2h, d),
                       ("pre1", pre1, ml), ("h", h, ml)):
        _build.require(t, name, bf, (rows, w), dev)
    _build.require(wo, "wo", bf, (d, dl), dev)
    _build.require(w1, "w1", bf, (ml, d), dev)
    _build.require(w2, "w2", bf, (d, ml), dev)
    s1, g1, s2 = (_vec(t, d, n, dev) for t, n in ((s1, "s1"), (g1, "g1"), (s2, "s2")))
    seed, thr, ks = _dropout_inputs(rate, seed, dev)
    new = lambda *shape, dt=f32: torch.empty(shape, dtype=dt, device=dev)
    plan = launch_plan(rows, d, ml, dl)
    col_part, w_part = new(plan.col_floats), new(max(plan.w_floats, 4))
    du2, dx_part = new(rows, d), new(rows, d)
    dlin2, xb, dlin1 = new(rows, d, dt=bf), new(rows, d, dt=bf), new(rows, d, dt=bf)
    dpre = new(rows, ml, dt=bf)
    lib, st = _build.lib(), _build.stream_of(g)
    with torch.cuda.device(dev):
        _build.check(lib.vt_block_train_tp_bwd_head(
            g.data_ptr(), x2h.data_ptr(), pre1.data_ptr(), w2.data_ptr(), w1.data_ptr(),
            s2.data_ptr(), _ptr(seed), du2.data_ptr(), dlin2.data_ptr(), dpre.data_ptr(),
            dx_part.data_ptr(), col_part.data_ptr(), plan.row_blocks, rows, d, ml, thr, ks,
            float(eps), st), "block_train_bwd_tp")
    total = yield dx_part
    dxq, dctx = new(rows, d, dt=bf), new(rows, dl, dt=bf)
    dwo, dw1, dw2 = new(d, dl), new(ml, d), new(d, ml)
    dbo, ds1, dg1, db2, ds2, dg2, db1 = new(d), new(d), new(d), new(d), new(d), new(d), new(ml)
    with torch.cuda.device(dev):
        _build.check(lib.vt_block_train_tp_bwd_tail(
            total.data_ptr(), du2.data_ptr(), ctx.data_ptr(), x1h.data_ptr(), h.data_ptr(),
            wo.data_ptr(), s1.data_ptr(), g1.data_ptr(), _ptr(seed), dxq.data_ptr(),
            dctx.data_ptr(), dwo.data_ptr(), dbo.data_ptr(), ds1.data_ptr(), dg1.data_ptr(),
            dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), ds2.data_ptr(),
            dg2.data_ptr(), dlin2.data_ptr(), dpre.data_ptr(), xb.data_ptr(), dlin1.data_ptr(),
            col_part.data_ptr(), w_part.data_ptr(), plan.row_blocks, plan.k_chunk, rows, d, dl,
            ml, thr, ks, float(eps), st), "block_train_bwd_tp")
    _build.LAUNCHES["block_train_bwd_tp"] += 1
    return (dxq, dctx, dwo, dbo, ds1, dg1, dw1, db1, dw2, db2, ds2, dg2)


def block_train_bwd_tp_steps(g, ctx, x1h, pre1, h, x2h, wo, w1, w2, s1, g1, s2,
                             rate: float = 0.0, seed=None, eps: float = 1e-12,
                             plain: bool = False):
    """One rank's split form of the backward (#9b) as a generator: it
    yields the f32 [rows, d] partial dpre_l W1_l of the FFN-in input
    gradient, takes its sum, and returns the 12 gradients of
    block_train_bwd (dctx [rows, dl], dWo [d, dl], dW1 [ml, d], db1 [ml],
    dW2 [d, ml] the rank's; the rest whole).  The kernels on a CUDA
    tensor, the plain twin on a CPU one or with ``plain``."""
    rows, d = g.shape
    if plain or not g.is_cuda:
        masks = seed_masks(seed, rows, d, rate, g.device)
        return _bwd_steps_plain(g, ctx, x1h, pre1, h, x2h, wo, w1, w2, s1, g1, s2, *masks, rate,
                                eps)
    return _bwd_steps_kernel(g, ctx, x1h, pre1, h, x2h, wo, w1, w2, s1, g1, s2, rate, seed, eps)


def recompute_tp(x1h, s1, g1, w1, b1, eps: float = 1e-12, plain: bool = False):
    """(pre1, h) of a split forward from its saved x1h (its summed
    pre-norm rows): LN1 and F3 on the rank's FFN share, no collective."""
    if plain or not x1h.is_cuda:
        dt = x1h.dtype
        x = _ln1(x1h, s1, g1, eps)
        pre1 = (torch.matmul(x.float(), w1.to(dt).float().t()) + b1.float()).to(dt)
        return pre1, gelu_erf(pre1.float()).to(dt)
    rows, d = x1h.shape
    ml = w1.shape[0]
    dev = x1h.device
    s1, g1 = _vec(s1, d, "s1", dev), _vec(g1, d, "g1", dev)
    b1 = _vec(b1, ml, "b1", dev)
    _build.require(w1, "w1", torch.bfloat16, (ml, d), dev)
    xb = torch.empty((rows, d), dtype=torch.bfloat16, device=dev)
    pre1, h = (torch.empty((rows, ml), dtype=torch.bfloat16, device=dev) for _ in range(2))
    with torch.cuda.device(dev):
        _build.check(_build.lib().vt_block_train_tp_recompute(
            x1h.data_ptr(), s1.data_ptr(), g1.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            xb.data_ptr(), pre1.data_ptr(), h.data_ptr(), rows, d, ml, float(eps),
            _build.stream_of(x1h)), "block_train_fwd_tp")
    _build.LAUNCHES["block_train_fwd_tp"] += 1
    return pre1, h


class BlockTrainTPFn(torch.autograd.Function):
    """The split training block of one tensor-parallel rank as one autograd
    node (BlockTrainFn's counterpart): x_q [.., d] whole, ctx [.., dl] its
    heads' context, the weights its shards; the partials summed over ``tp``
    (a ModelGroup).  Under a ``remat`` mode of RECOMPUTES it saves x_q's
    summed pre-norm rows x1h and x2h (and ctx, the seed) and recomputes
    pre1 and h from x1h in the backward (recompute_tp: LN1 and F3, no
    collective), where a relaunch of the whole forward would repeat its
    two all-reduces; under "none" and "dots" it saves every residual.  The input gradient dx_q is whole,
    dctx the rank's heads'."""

    @staticmethod
    def forward(fctx, x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, rate, eps, seed, remat,
                plain, tp):
        shape, d = x_q.shape, x_q.shape[-1]
        x2, c2 = x_q.reshape(-1, d).contiguous(), ctx.reshape(-1, ctx.shape[-1]).contiguous()
        fctx.cfg = (shape, ctx.shape, rate, eps, remat, plain, tp)
        y, x1h, pre1, h, x2h = TP.run_split(block_train_fwd_tp_steps(
            x2, c2, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, rate, seed, eps, plain), tp)
        kept = (None, None) if remat in RECOMPUTES else (pre1, h)
        fctx.save_for_backward(c2, x1h, x2h, *kept, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2,
                               seed)
        return y.reshape(shape)

    @staticmethod
    def backward(fctx, gy):
        shape, ctx_shape, rate, eps, remat, plain, tp = fctx.cfg
        c2, x1h, x2h, pre1, h, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, seed = fctx.saved_tensors
        if pre1 is None:
            pre1, h = recompute_tp(x1h, s1, g1, w1, b1, eps, plain)
        grads = TP.run_split(block_train_bwd_tp_steps(
            gy.reshape(-1, shape[-1]).to(c2.dtype).contiguous(), c2, x1h, pre1, h, x2h, wo, w1,
            w2, s1, g1, s2, rate, seed, eps, plain), tp)
        dxq, dctx, dwo, dbo, ds1, dg1, dw1, db1, dw2, db2, ds2, dg2 = grads
        like = lambda gr, p: gr.to(p.dtype)
        return (dxq.reshape(shape), dctx.reshape(ctx_shape), like(dwo, wo), like(dbo, bo),
                like(ds1, s1), like(dg1, g1), like(dw1, w1), like(db1, b1), like(dw2, w2),
                like(db2, b2), like(ds2, s2), like(dg2, g2)) + (None,) * 6
