"""The port's training ops against the JAX package, on the CPU in float32.

* the counter-based dropout generator (ops/dropout.py): the Philox4x32-10
  known-answer vectors, reproducibility, the keep rate, coordinates not
  block layout;
* the flash backward's plain version against ``jax.vjp`` of
  ``flash_attention_merged(interpret=True)`` (the Pallas backward in
  interpret mode) at rate 0, and against autograd through the plain
  forward with dropout;
* ``block_train_plain`` (forward and the 12 gradients) against JAX
  ``block_train(mask_a, mask_f, interpret=True)`` with the same numpy
  masks, on the cases of tests/test_block_bwd.py;
* the two autograd Functions (AttentionFn, BlockTrainFn): remat "attn"
  and "none" give the same gradients, and both equal plain autograd.

The JAX TPU dropout stream cannot be matched, so every comparison with
JAX runs at rate 0 or feeds masks.  Tolerances: 2e-4 absolute and
relative where the two sides compute the same float32 expression in
another order through ~3 products of width <= 512 (the tolerance of
tests/test_block_bwd.py); 1e-5 where both sides are the port's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops import attention as TA
from vitxtgqa_tpu_torch.ops import block_train as TBT
from vitxtgqa_tpu_torch.ops import dropout as TD
from vitxtgqa_tpu_torch.ops import flash_attention as TFA
from vitxtgqa_tpu_torch.ops.masks import MaskSpec, joint_mask_spec

T = torch.from_numpy
TOL = dict(atol=2e-4, rtol=2e-4)
SELF = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the dropout generator
# ---------------------------------------------------------------------------

# Random123's known-answer vectors for Philox4x32-10 (counter, key, output)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter, key, want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    words = TD.philox4x32(*[torch.tensor([c], dtype=torch.int64) for c in counter], *key)
    assert [int(w) for w in words] == list(want)


def test_philox_bits_are_a_function_of_coordinates():
    """Reproducible per (seed, stream); element (i3, i2, i1, i0) is word
    i0 % 4 of Philox((i0 // 4, i1, i2, i3), (seed, stream)), so a slice
    of a larger mask is the mask of the slice's coordinates."""
    shape = (2, 3, 5, 13)
    a = TD.philox_bits(7, 0, shape)
    assert torch.equal(a, TD.philox_bits(torch.tensor([7]), 0, shape))
    assert not torch.equal(a, TD.philox_bits(8, 0, shape))
    assert not torch.equal(a, TD.philox_bits(7, 1, shape))
    assert a.min() >= 0 and a.max() < 2 ** 32
    big = TD.philox_bits(7, 0, (2, 3, 5, 40))
    assert torch.equal(big[..., :13], a)
    b, h, r, c = 1, 2, 4, 9
    w = TD.philox4x32(*[torch.tensor([x]) for x in (c // 4, r, h, b)], 7, 0)
    assert int(a[b, h, r, c]) == int(w[c % 4])


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_rate(rate):
    """P(keep) = 1 - rate: over 2**20 draws the keep share is within 5
    standard deviations of 1 - rate."""
    keep = TD.keep_mask(3, TD.STREAM_BLOCK_A, (1024, 1024), rate).float().mean().item()
    sd = (rate * (1 - rate) / 2 ** 20) ** 0.5
    assert abs(keep - (1 - rate)) < 5 * sd
    assert TD.threshold(1.0) == 2 ** 32 - 1 and TD.threshold(0.0) == 0


def test_dropout_is_flax_semantics_and_a_no_op_without_generator():
    x = torch.ones(64, 64)
    assert TD.dropout(x, 0.1, None) is x
    y = TD.dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(torch.unique(y), torch.tensor([0.0, 1.0 / 0.75]))


# ---------------------------------------------------------------------------
# flash attention: dropout forward, backward
# ---------------------------------------------------------------------------


def _merged(b=2, h=4, l_enc=52, dec=12, d=16, seed=5):
    rng = np.random.default_rng(seed)
    l = l_enc + dec
    q, k, v = (_rand(rng, b, l, h * d) for _ in range(3))
    lengths = [l_enc - 12, l_enc][:b] + [l_enc] * max(0, b - 2)
    enc = (np.arange(l_enc)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    key_mask = np.pad(enc, ((0, 0), (0, dec)))
    g = _rand(rng, b, l, h * d)
    return q, k, v, key_mask, g


# (l_enc, dec_len, block_q): one q block, and several (256 rows, 128 a block)
FLASH_BWD_CASES = {"dec0": (64, 0, 0), "dec12": (52, 12, 0), "multi_block_dec12": (244, 12, 128)}


@pytest.mark.parametrize("case", sorted(FLASH_BWD_CASES))
def test_flash_bwd_plain_matches_pallas_interpret_vjp(case):
    """dq, dk, dv of the plain backward (from the plain forward's lse)
    against jax.vjp through the Pallas forward and backward kernels."""
    from vitxtgqa_tpu.ops.pallas_attention import flash_attention_merged

    l_enc, dec, block_q = FLASH_BWD_CASES[case]
    h = 4
    q, k, v, key_mask, g = _merged(l_enc=l_enc, dec=dec)
    f = lambda q_, k_, v_: flash_attention_merged(q_, k_, v_, jnp.asarray(key_mask), dec,
                                                  num_heads=h, block_q=block_q, interpret=True)
    want_out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    out, lse = TFA.flash_attention_merged(T(q), T(k), T(v), T(key_mask), dec, h, return_lse=True)
    np.testing.assert_allclose(_np(out), np.asarray(want_out), atol=2e-5)
    got = TFA.flash_attention_merged_bwd(T(q), T(k), T(v), T(key_mask), out, lse, T(g), dec, h)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(a), np.asarray(w), err_msg="d" + name, **TOL)


@pytest.mark.parametrize("dec", [0, 12])
def test_flash_bwd_plain_matches_pallas_on_a_row_with_no_key(dec):
    """Batch row 0 with no valid key at L 130 / 142 (not multiples of 128):
    its encoder rows average V over the JAX wrapper's 256 padded keys, and
    its gradients weigh every key 1 / 256, as the Pallas backward's padded
    softmax does; the plain forward and backward within 2e-5 of jax.vjp
    through the Pallas kernels."""
    from vitxtgqa_tpu.ops.pallas_attention import flash_attention_merged

    h = 4
    q, k, v, key_mask, g = _merged(l_enc=130, dec=dec, seed=7)
    key_mask[0] = 0.0
    f = lambda q_, k_, v_: flash_attention_merged(q_, k_, v_, jnp.asarray(key_mask), dec,
                                                  num_heads=h, interpret=True)
    want_out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    out, lse = TFA.flash_attention_merged(T(q), T(k), T(v), T(key_mask), dec, h, return_lse=True)
    np.testing.assert_allclose(_np(out), np.asarray(want_out), atol=2e-5)
    assert (_np(lse)[0, :, :130] == -1e9).all()
    got = TFA.flash_attention_merged_bwd(T(q), T(k), T(v), T(key_mask), out, lse, T(g), dec, h)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(a), np.asarray(w), atol=2e-5, err_msg="d" + name)


@pytest.mark.parametrize("dec", [0, 12])
def test_flash_dropout_bwd_plain_matches_autograd(dec):
    """At rate 0.1 the plain backward (mask regenerated from the seed)
    equals autograd through the plain forward with the same seed, and the
    forward equals softmax, then the explicit keep mask over 1 - rate."""
    h, rate, seed = 4, 0.1, torch.tensor([11])
    q, k, v, key_mask, g = _merged(l_enc=52, dec=dec)
    qt, kt, vt = (T(x).requires_grad_() for x in (q, k, v))
    out, lse = TFA.flash_attention_merged_plain(qt, kt, vt, T(key_mask), dec, h, rate, seed,
                                                return_lse=True)
    out.backward(T(g))
    got = TFA.flash_attention_merged_bwd(T(q), T(k), T(v), T(key_mask), out.detach(), lse,
                                         T(g), dec, h, rate, seed)
    for name, a, t in zip("qkv", got, (qt, kt, vt)):
        np.testing.assert_allclose(_np(a), _np(t.grad), err_msg="d" + name, **SELF)
    b, l, _ = q.shape
    keep = TD.keep_mask(seed, TD.STREAM_ATTN, (b, h, l, l), rate)
    split = lambda x: T(x).reshape(b, l, h, -1).transpose(1, 2)
    bias = joint_mask_spec(T(key_mask[:, :l - dec]), dec).to_bias() if dec else \
        MaskSpec(key_mask=T(key_mask)).to_bias()
    s = split(q) @ split(k).transpose(-1, -2) / 4.0 + bias
    p = torch.where(keep, torch.softmax(s, -1) / (1 - rate), torch.zeros(()))
    want = (p @ split(v)).transpose(1, 2).reshape(b, l, -1)
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-5)
    assert 0.88 < keep.float().mean().item() < 0.92


def _layer_weights(rng, d):
    return [T(_rand(rng, d, d, scale=0.1)).requires_grad_() if i % 2 == 0
            else T(_rand(rng, d, scale=0.05)).requires_grad_() for i in range(6)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_fn_remat_modes_match_plain_autograd(rate):
    """AttentionFn (flash route: projections + flash + its backward) with
    remat "attn" and "none" gives the gradients of plain autograd through
    the same projections and the plain flash forward with the same seed."""
    h, d, dec = 4, 64, 12
    rng = np.random.default_rng(3)
    x_np = _rand(rng, 2, 64, d)
    ws = _layer_weights(rng, d)
    key_mask = T(np.pad(np.ones((2, 52), np.float32), ((0, 0), (0, dec))))
    seed = torch.tensor([5]) if rate else None
    g = T(_rand(rng, 2, 64, d))

    def grads(run):
        x = T(x_np).requires_grad_()
        for w in ws:
            w.grad = None
        run(x).backward(g)
        return [x.grad.clone()] + [w.grad.clone() for w in ws]

    def plain(x):
        q, k, v = (torch.nn.functional.linear(x, ws[i], ws[i + 1]) for i in (0, 2, 4))
        return TFA.flash_attention_merged_plain(q, k, v, key_mask, dec, h, rate, seed)

    want = grads(plain)
    for remat in ("attn", "none"):
        got = grads(lambda x: TA.AttentionFn.apply(x, *ws, key_mask, dec, h, rate, seed, remat,
                                                   False))
        for a, w in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(w), **SELF)


# ---------------------------------------------------------------------------
# block_train: plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

D, M = 256, 512


def _block_args(seed, rows, d=D, m=M):
    """numpy operands in the JAX layout (weights [in, out])."""
    rng = np.random.default_rng(seed)
    mk = lambda *s, scale=0.05: _rand(rng, *s, scale=scale)
    return [mk(rows, d, scale=1.0), mk(rows, d, scale=1.0), mk(d, d), mk(d), 1.0 + mk(d), mk(d),
            mk(d, m), mk(m), mk(m, d), mk(d), 1.0 + mk(d), mk(d)]


def _to_port(args):
    """JAX-layout numpy operands -> port tensors (nn.Linear weights)."""
    out = [T(a.T.copy()) if i in (2, 6, 8) else T(a) for i, a in enumerate(args)]
    return [t.requires_grad_() for t in out]


def _masks(seed, rows, rate, d=D):
    rng = np.random.default_rng(seed)
    return rng.random((rows, d)) >= rate, rng.random((rows, d)) >= rate


def _jax_block_grads(args, masks, rate, cot):
    from vitxtgqa_tpu.ops.pallas_block_bwd import block_train

    ma, mf = (None, None) if masks is None else (jnp.asarray(masks[0]), jnp.asarray(masks[1]))
    f = lambda *a: block_train(*a, mask_a=ma, mask_f=mf, rate=rate, interpret=True)
    y, vjp = jax.vjp(f, *[jnp.asarray(a) for a in args])
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _check_block_grads(got, want):
    for i, (name, a, w) in enumerate(zip(TBT.GRAD_NAMES, got, want)):
        a = _np(a)
        if i in (2, 6, 8):  # nn.Linear layout against JAX's [in, out]
            a = a.T
        np.testing.assert_allclose(a, w, err_msg=name, **TOL)


@pytest.mark.parametrize("rows", [256, 300])  # 300: not a multiple of 256
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_block_train_plain_matches_pallas_interpret(rows, rate):
    """y and all 12 gradients: autograd through block_train_plain and the
    explicit-residual block_train_bwd_plain, each against JAX."""
    args = _block_args(0, rows)
    masks = _masks(7, rows, rate) if rate else None
    cot = _rand(np.random.default_rng(1), rows, D)
    want_y, want = _jax_block_grads(args, masks, rate, cot)
    port = _to_port(args)
    mk = [None, None] if masks is None else [T(m) for m in masks]
    y = TBT.block_train_plain(*port, mask_a=mk[0], mask_f=mk[1], rate=rate)
    np.testing.assert_allclose(_np(y), want_y, **TOL)
    y.backward(T(cot))
    _check_block_grads([p.grad for p in port], want)
    res = TBT.block_train_fwd_plain(*port, mask_a=mk[0], mask_f=mk[1], rate=rate)
    x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2 = port
    grads = TBT.block_train_bwd_plain(T(cot), ctx, *res[1:], wo, w1, w2, s1, g1, s2,
                                      mask_a=mk[0], mask_f=mk[1], rate=rate)
    _check_block_grads(grads, want)


def test_block_train_plain_multi_block_accumulation():
    """Rows over three JAX row blocks (3 x 256 + 64): the weight gradients
    reduce over every row."""
    rows = 256 * 3 + 64
    args = _block_args(3, rows)
    cot = _rand(np.random.default_rng(2), rows, D)
    _, want = _jax_block_grads(args, None, 0.0, cot)
    port = _to_port(args)
    TBT.block_train_plain(*port).backward(T(cot))
    _check_block_grads([p.grad for p in port], want)


def test_block_train_zero_masks_drop_grads():
    """Fully dropped activations: wo, bo, w2 and b2 get no gradient."""
    rows = 64
    port = _to_port(_block_args(4, rows))
    zeros = torch.zeros(rows, D, dtype=torch.bool)
    x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2 = port
    res = TBT.block_train_fwd_plain(*port, mask_a=zeros, mask_f=zeros, rate=0.5)
    grads = TBT.block_train_bwd_plain(torch.ones(rows, D), ctx, *res[1:], wo, w1, w2, s1, g1, s2,
                                      mask_a=zeros, mask_f=zeros, rate=0.5)
    for i in (1, 2, 3, 8, 9):  # dctx, dWo, dbo, dW2, db2
        assert float(grads[i].detach().abs().max()) == 0.0, TBT.GRAD_NAMES[i]


def test_block_train_seed_masks_are_the_kernels_coordinates():
    """Seed mode on CPU tensors: the masks are the Philox bits of (row,
    col) in streams 1 and 2, the same the forward emits."""
    rows, rate, seed = 48, 0.1, torch.tensor([9])
    port = [p.detach() for p in _to_port(_block_args(5, rows))]
    out = TBT.block_train_fwd(*port, rate=rate, seed=seed, emit_masks=True)
    ma, mf = TBT.masks_from_seed(seed, rows, D, rate, "cpu")
    assert torch.equal(out[5].bool(), ma) and torch.equal(out[6].bool(), mf)
    assert torch.equal(ma, TD.keep_mask(9, TD.STREAM_BLOCK_A, (rows, D), rate))
    with pytest.raises(ValueError, match="emit_masks"):
        TBT.block_train_fwd(*port, rate=0.0, seed=seed, emit_masks=True)


@pytest.mark.parametrize("plain", [False, True])
def test_block_train_fn_remat_modes_match_plain_autograd(plain):
    """BlockTrainFn with remat "attn" (recompute in the backward) and
    "none" (saved residuals), in-kernel dropout from a seed, through the
    wrappers or (``plain``, Options.plain) the plain versions, gives the
    gradients of autograd through block_train_plain on the seed's masks."""
    rows, rate, seed = 96, 0.1, torch.tensor([21])
    base = _block_args(6, rows)
    cot = T(_rand(np.random.default_rng(4), 2, rows // 2, D))
    ma, mf = TBT.masks_from_seed(seed, rows, D, rate, "cpu")

    def grads(run):
        port = _to_port(base)
        port[0], port[1] = (t.detach().reshape(2, rows // 2, D).requires_grad_() for t in port[:2])
        run(port).backward(cot)
        return [p.grad for p in port]

    want = grads(lambda p: TBT.block_train_plain(
        p[0].reshape(rows, D), p[1].reshape(rows, D), *p[2:], mask_a=ma, mask_f=mf,
        rate=rate).reshape(2, rows // 2, D))
    for remat in ("attn", "none"):
        got = grads(lambda p: TBT.BlockTrainFn.apply(*p, rate, 1e-12, seed, remat, plain))
        for name, a, w in zip(TBT.GRAD_NAMES, got, want):
            np.testing.assert_allclose(_np(a), _np(w), err_msg=f"{remat} {name}", **SELF)


def test_training_wrappers_on_cpu_run_plain_and_count_nothing():
    _build.reset_launch_counts()
    rows = 32
    port = [p.detach() for p in _to_port(_block_args(8, rows))]
    res = TBT.block_train_fwd(*port)
    TBT.block_train_bwd(torch.ones(rows, D), port[1], *res[1:], port[2], port[6], port[8],
                        port[4], port[5], port[10])
    q, k, v, key_mask, g = _merged()
    out, lse = TFA.flash_attention_merged(T(q), T(k), T(v), T(key_mask), 12, 4, 0.1,
                                          torch.tensor([1]), return_lse=True)
    TFA.flash_attention_merged_bwd(T(q), T(k), T(v), T(key_mask), out, lse, T(g), 12, 4, 0.1,
                                   torch.tensor([1]))
    assert all(n == 0 for n in _build.launch_counts().values())
    assert TBT.kernel_ok(768, 3072) and not TBT.kernel_ok(64, 128)


@pytest.mark.parametrize("rows", [20, 40, 540, 960, 1000, 4608, 9000, 9216, 55296])
@pytest.mark.parametrize("widths", [(768, 3072), (64, 128)], ids=["production", "tiny"])
def test_block_launch_plan_covers_every_row_once(rows, widths):
    """launch_plan, the cut of the block backward's reductions over the
    rows: the activation products' 128-row tiles cover the rows; the row
    passes' warps (block b, warp w: rows 8 b + w, then every 8 row_blocks
    further) take every row once and every block a row; the weight
    gradients' splits (multiples of the K step) take every row once, none
    empty; and the scratch holds what csrc/block_train.cu reads: three [d]
    column sums per row-pass block for each LayerNorm, db1's [m] per row
    tile, and per split the three f32 weight-gradient partials."""
    d, m = widths
    plan = TBT.launch_plan(rows, d, m)
    assert (plan.m_tiles - 1) * TBT.TILE_M < rows <= plan.m_tiles * TBT.TILE_M
    per = TBT.ROWS_PER_BLOCK
    seen = np.zeros(rows, dtype=int)
    for b in range(plan.row_blocks):
        taken = 0
        for w in range(per):
            rows_of = np.arange(b * per + w, rows, plan.row_blocks * per)
            seen[rows_of] += 1
            taken += rows_of.size
        assert taken > 0, f"row-pass block {b} has no row"
    assert (seen == 1).all()
    assert plan.row_blocks <= TBT.ROW_BLOCKS_MAX
    assert plan.k_chunk % TBT.K_STEP == 0 and 1 <= plan.splits <= TBT.MAX_SPLITS
    cover = np.zeros(rows, dtype=int)
    for s in range(plan.splits):
        lo, hi = s * plan.k_chunk, min(rows, (s + 1) * plan.k_chunk)
        assert lo < hi, f"split {s} is empty"
        cover[lo:hi] += 1
    assert (cover == 1).all()
    assert plan.col_floats == 2 * plan.row_blocks * 3 * d + plan.m_tiles * m
    assert plan.w_floats == (plan.splits * (d * d + m * d + d * m) if plan.splits > 1 else 0)


def test_block_launch_plan_of_the_training_step():
    """The step's shapes: 55,296 rows in four splits of 13,824 (37.7 MB of
    f32 partials for dW1), the text BERT's 960 rows in one."""
    big, text = TBT.launch_plan(55296, 768, 3072), TBT.launch_plan(960, 768, 3072)
    assert (big.splits, big.k_chunk, big.m_tiles, big.row_blocks) == (4, 13824, 432, 264)
    assert big.w_floats == 4 * (768 * 768 + 2 * 3072 * 768)
    assert (text.splits, text.k_chunk, text.w_floats) == (1, 960, 0)
    with pytest.raises(ValueError):
        TBT.launch_plan(0, 768, 3072)
