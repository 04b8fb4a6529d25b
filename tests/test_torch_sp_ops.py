"""The sequence-parallel slice's kernel op, the split-head flash attention
with a query-row offset (#10, #10b: ops/flash_attention.flash_attention and
flash_attention_bwd), its mask rows, and the SP routing, against the JAX
package.

Everything runs on the CPU, in one process.  The plain versions, which the
wrappers run on CPU tensors, are held against the JAX Pallas kernel
(pallas_attention.flash_attention) in interpret mode, with its row_offset,
on the cases of tests/test_pallas_attention.py's row-offset tests: offsets
0, mid-encoder and across the decoder block, dec_len 0 and 6, and query
shards shorter than the keys; f32 within 2e-5 (the JAX tests' limit).  The
dropout forms (Philox, which the TPU's generator cannot reproduce) are held
against the twins' own properties: a shard's rows are the unsharded call's,
and the backward twin is autograd through the forward twin.  The routing
is held against the JAX gates with both packages' sp_attention recorded.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops import attention as TA
from vitxtgqa_tpu_torch.ops import flash_attention as TFA
from vitxtgqa_tpu_torch.ops import masks as TM

T = torch.from_numpy
LENC, DEC = 122, 6  # 128 rows: two shards of 64, the decoder block from row 122


def _case(b=2, h=2, d=16, dec=DEC, seed=9):
    rng = np.random.default_rng(seed)
    l = LENC + dec
    q, k, v, g = (rng.standard_normal((b, h, l, d)).astype(np.float32) for _ in range(4))
    enc = (np.arange(LENC)[None, :] < np.asarray([[100], [LENC]])[:b]).astype(np.float32)
    key_mask = np.concatenate([enc, np.zeros((b, dec), np.float32)], 1)
    return q, k, v, g, key_mask


# (dec_len, row_offset, query rows): the whole sequence, a first half, a
# mid-encoder block, a block across the decoder's first row (122), the
# last rows, and a shard of a dec_len-0 sequence
FLASH_CASES = {
    "whole_dec6": (6, 0, 128),
    "whole_dec0": (0, 0, 128),
    "first_half_dec6": (6, 0, 64),
    "mid_encoder_dec6": (6, 32, 32),
    "across_decoder_dec6": (6, 96, 32),
    "last_half_dec6": (6, 64, 64),
    "last_half_dec0": (0, 64, 64),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_twin_matches_pallas_with_row_offset(case):
    from vitxtgqa_tpu.ops.pallas_attention import flash_attention

    dec, off, rows = FLASH_CASES[case]
    q, k, v, _, key_mask = _case(dec=DEC)
    if dec == 0:
        key_mask[:, LENC:] = 1.0  # no decoder block: every row sees the same keys
    qs = q[:, :, off:off + rows]
    want = flash_attention(jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v), jnp.asarray(key_mask),
                           dec_len=dec, interpret=True, row_offset=jnp.int32(off))
    got, lse = TFA.flash_attention(T(qs), T(k), T(v), T(key_mask), dec, off, return_lse=True)
    assert got.shape == qs.shape and lse.shape == qs.shape[:3]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("dec", [0, DEC])
def test_flash_bwd_twin_matches_pallas_grads(dec):
    """dq of each shard == jax.vjp of the interpret kernel at that row
    offset, and the shards' f32 dk / dv sum to the unsharded gradients (what
    shard_map's psum delivers; test_flash_row_offset_grads_match_full)."""
    from vitxtgqa_tpu.ops.pallas_attention import flash_attention

    q, k, v, g, key_mask = _case(dec=DEC)
    if dec == 0:
        key_mask[:, LENC:] = 1.0
    jk, jv, jm = jnp.asarray(k), jnp.asarray(v), jnp.asarray(key_mask)
    dk_sum = dv_sum = 0.0
    for off in (0, 64):
        qs, gs = q[:, :, off:off + 64], g[:, :, off:off + 64]
        _, vjp = jax.vjp(lambda a, b_, c: flash_attention(a, b_, c, jm, dec_len=dec, interpret=True,
                                                          row_offset=jnp.int32(off)),
                         jnp.asarray(qs), jk, jv)
        wq, wk, wv = vjp(jnp.asarray(gs))
        out, lse = TFA.flash_attention(T(qs), T(k), T(v), T(key_mask), dec, off, return_lse=True)
        dq, dk, dv = TFA.flash_attention_bwd(T(qs), T(k), T(v), T(key_mask), out, lse, T(gs), dec,
                                             off)
        assert dk.dtype == dv.dtype == torch.float32
        np.testing.assert_allclose(dq.numpy(), np.asarray(wq), atol=2e-5, err_msg=f"dq {off}")
        np.testing.assert_allclose(dk.numpy(), np.asarray(wk), atol=2e-5, err_msg=f"dk {off}")
        dk_sum, dv_sum = dk_sum + dk.numpy(), dv_sum + dv.numpy()
    _, vjp = jax.vjp(lambda a, b_, c: flash_attention(a, b_, c, jm, dec_len=dec, interpret=True),
                     jnp.asarray(q), jk, jv)
    _, wk, wv = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dk_sum, np.asarray(wk), atol=2e-5)
    np.testing.assert_allclose(dv_sum, np.asarray(wv), atol=2e-5)


@pytest.mark.parametrize("dec", [0, 12])
def test_flash_twins_match_pallas_on_a_row_with_no_key(dec):
    """Batch row 1 with no valid key over 130 / 142 keys (not multiples of
    128), query shards at row offsets 0 and 64 (the second across the
    decoder block at dec_len 12): the forward twin within 2e-5 of the
    Pallas kernel (its encoder rows average V over the 256 padded keys),
    and the backward twin's dq within 2e-5 of jax.vjp's, the shards' dk /
    dv summed within 2e-5 of the unsharded gradients."""
    from vitxtgqa_tpu.ops.pallas_attention import flash_attention

    rng = np.random.default_rng(13)
    b, h, d, l = 2, 2, 16, 130 + dec
    q, k, v, g = (rng.standard_normal((b, h, l, d)).astype(np.float32) for _ in range(4))
    key_mask = np.zeros((b, l), np.float32)
    key_mask[0, :100] = 1.0
    jk, jv, jm = jnp.asarray(k), jnp.asarray(v), jnp.asarray(key_mask)
    dk_sum = dv_sum = 0.0
    for off, rows in ((0, 64), (64, l - 64)):
        qs, gs = q[:, :, off:off + rows], g[:, :, off:off + rows]
        want, vjp = jax.vjp(lambda a, b_, c: flash_attention(a, b_, c, jm, dec_len=dec,
                                                             interpret=True,
                                                             row_offset=jnp.int32(off)),
                            jnp.asarray(qs), jk, jv)
        wq, _, _ = vjp(jnp.asarray(gs))
        out, lse = TFA.flash_attention(T(qs), T(k), T(v), T(key_mask), dec, off, return_lse=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5, err_msg=f"out {off}")
        dq, dk, dv = TFA.flash_attention_bwd(T(qs), T(k), T(v), T(key_mask), out, lse, T(gs), dec,
                                             off)
        np.testing.assert_allclose(dq.numpy(), np.asarray(wq), atol=2e-5, err_msg=f"dq {off}")
        dk_sum, dv_sum = dk_sum + dk.numpy(), dv_sum + dv.numpy()
    _, vjp = jax.vjp(lambda a, b_, c: flash_attention(a, b_, c, jm, dec_len=dec, interpret=True),
                     jnp.asarray(q), jk, jv)
    _, wk, wv = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dk_sum, np.asarray(wk), atol=2e-5)
    np.testing.assert_allclose(dv_sum, np.asarray(wv), atol=2e-5)


def test_dropout_shards_are_the_unsharded_rows():
    """With dropout, the Philox mask is counted by the global row: the
    shards' outputs and lse, concatenated, equal the unsharded call's bit
    for bit, and the merged-head twin (#1) draws the same mask at offset 0."""
    q, k, v, _, key_mask = _case()
    seed = torch.tensor([77], dtype=torch.int64)
    args = (T(k), T(v), T(key_mask), DEC)
    full, full_lse = TFA.flash_attention(T(q), *args, 0, 0.25, seed, return_lse=True)
    parts = [TFA.flash_attention(T(q[:, :, o:o + 32]), *args, o, 0.25, seed, return_lse=True)
             for o in range(0, 128, 32)]
    assert torch.equal(torch.cat([p[0] for p in parts], 2), full)
    assert torch.equal(torch.cat([p[1] for p in parts], 2), full_lse)
    merged = lambda x: TA.merge_heads(T(x))
    want = TFA.flash_attention_merged_plain(merged(q), merged(k), merged(v), T(key_mask), DEC, 2,
                                            0.25, seed)
    np.testing.assert_allclose(TA.merge_heads(full).numpy(), want.numpy(), atol=1e-6)
    no_drop = TFA.flash_attention(T(q), *args, 0)
    assert not torch.allclose(full, no_drop)


@pytest.mark.parametrize("off", [0, 64])
def test_flash_bwd_twin_with_dropout_is_the_forward_twins_gradient(off):
    q, k, v, g, key_mask = _case(seed=3)
    seed = torch.tensor([5], dtype=torch.int64)
    qs = T(q[:, :, off:off + 64].copy()).requires_grad_()
    kk, vv = T(k).requires_grad_(), T(v).requires_grad_()
    gs = T(g[:, :, off:off + 64].copy())
    out, lse = TFA.flash_attention_plain(qs, kk, vv, T(key_mask), DEC, off, 0.1, seed,
                                         return_lse=True)
    (out * gs).sum().backward()
    dq, dk, dv = TFA.flash_attention_bwd(qs.detach(), T(k), T(v), T(key_mask), out.detach(),
                                         lse.detach(), gs, DEC, off, 0.1, seed)
    for got, want in ((dq, qs.grad), (dk, kk.grad), (dv, vv.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


@pytest.mark.parametrize("dec, off, rows", [(0, 0, 64), (6, 0, 64), (6, 64, 64), (6, 112, 16)])
def test_local_rows_bias_matches_jax(dec, off, rows):
    """masks.local_rows_bias against sequence_parallel._local_rows_bias, and
    against the rows of the whole sequence's prefix-LM bias."""
    from vitxtgqa_tpu.parallel.sequence_parallel import _local_rows_bias

    _, _, _, _, key_mask = _case(dec=DEC)
    if dec == 0:
        key_mask[:, LENC:] = 1.0
    got = TM.local_rows_bias(T(key_mask), dec, off, rows)
    want = _local_rows_bias(jnp.asarray(key_mask), dec, off, rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    whole = TM.MaskSpec(key_mask=T(key_mask), dec_len=dec).to_bias()
    np.testing.assert_array_equal(got.expand(2, 1, rows, 128).numpy(),
                                  whole.expand(2, 1, 128, 128)[:, :, off:off + rows].numpy())


def test_the_wrappers_take_the_plain_twins_on_cpu_tensors():
    """On CPU tensors the wrappers return the twins' results and launch
    nothing."""
    q, k, v, g, key_mask = _case()
    _build.reset_launch_counts()
    a = (T(q[:, :, 64:]), T(k), T(v), T(key_mask), DEC, 64)
    out, lse = TFA.flash_attention(*a, return_lse=True)
    want, want_lse = TFA.flash_attention_plain(*a, return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    got = TFA.flash_attention_bwd(*a[:4], out, lse, T(g[:, :, 64:]), DEC, 64)
    ref = TFA.flash_attention_bwd_plain(*a[:4], out, lse, T(g[:, :, 64:]), DEC, 64)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert not any(_build.launch_counts().values())


def test_the_wrappers_check_the_query_rows():
    q, k, _, _, _ = _case(d=64)
    assert TFA._split_geometry(T(q[:, :, :64]), T(k), DEC, 64, "flash_attention") == (
        2, 2, 64, 128, 64)
    with pytest.raises(ValueError, match="outside"):
        TFA._split_geometry(T(q[:, :, :64]), T(k), DEC, 96, "flash_attention")
    with pytest.raises(ValueError, match="dec_len"):
        TFA._split_geometry(T(q), T(k), 129, 0, "flash_attention")
    q, k, _, _, _ = _case(d=136)
    with pytest.raises(NotImplementedError, match="head widths above 128"):
        TFA._split_geometry(T(q), T(k), DEC, 0, "flash_attention")


# ---------------------------------------------------------------------------
# the SP routing against the JAX gates
# ---------------------------------------------------------------------------

ROUTE_CASES = [
    # (entry, Lq, Lk, dropout rate)
    ("mha", 128, 128, 0.0), ("mha", 20, 20, 0.0), ("mha", 21, 21, 0.0), ("mha", 64, 128, 0.0),
    ("mha", 1, 128, 0.0), ("mha", 128, 128, 0.1), ("mha_merged", 128, 128, 0.0),
    ("mha_merged", 384, 384, 0.0), ("mha_merged", 129, 129, 0.0),
    ("mha_merged", 384, 384, 0.1), ("mha_merged_quantize", 384, 384, 0.0),
    ("mha_merged_quantize", 129, 129, 0.0),
]


@pytest.mark.parametrize("entry, lq, lk, rate", ROUTE_CASES)
def test_sp_route_is_the_jax_gate(entry, lq, lk, rate, monkeypatch):
    """Under sp of size 2 the port's routing reaches sp_attention exactly
    where JAX's, under set_sequence_parallel on a 2-device mesh, reaches
    its sp_attention (both recorded): equal lengths divisible by the ranks
    and no dropout; mha_merged_quantize has no dropout term."""
    from vitxtgqa_tpu.ops import attention as JA
    from vitxtgqa_tpu.ops import masks as JM
    from vitxtgqa_tpu.parallel import sequence_parallel as JSP
    from vitxtgqa_tpu_torch.parallel import sequence_parallel as TSP

    rng = np.random.default_rng(2)
    h, d = 2, 8
    xq = rng.standard_normal((1, lq, h * d)).astype(np.float32)
    xk = rng.standard_normal((1, lk, h * d)).astype(np.float32)
    mask = np.ones((1, lk), np.float32)
    routes = {"jax": 0, "port": 0}

    def record(side, fn):
        def call(q, k, v, bias, *a, **kw):
            routes[side] += 1
            return fn(q, k, v, None if side == "port" else bias)
        return call

    monkeypatch.setattr(JSP, "sp_attention",
                        record("jax", lambda q, k, v, b: JA.mha_reference(q, k, v)))
    monkeypatch.setattr(TSP, "sp_attention",
                        record("port", lambda q, k, v, b: TA.mha_reference(q, k, v)))
    sp = types.SimpleNamespace(size=2, rank=0)
    jspec, tspec = JM.MaskSpec(key_mask=jnp.asarray(mask)), TM.MaskSpec(key_mask=T(mask))
    JA.set_sequence_parallel(Mesh(np.array(jax.devices()[:2]), ("sp",)))
    try:
        if entry == "mha":
            jq, jk = JA.split_heads(jnp.asarray(xq), h), JA.split_heads(jnp.asarray(xk), h)
            JA.mha(jq, jk, jk, jspec if lq == lk else None, dropout_rate=rate,
                   dropout_rng=jax.random.key(0) if rate else None)
            TA.mha(TA.split_heads(T(xq), h), TA.split_heads(T(xk), h), TA.split_heads(T(xk), h),
                   tspec if lq == lk else None, rate, torch.Generator().manual_seed(0), sp=sp)
        elif entry == "mha_merged":
            JA.mha_merged(*(jnp.asarray(xq),) * 3, jspec, h, dropout_rate=rate,
                          dropout_rng=jax.random.key(0) if rate else None)
            if rate == 0.0:  # the port's eval entry has no dropout
                TA.mha_merged(*(T(xq),) * 3, tspec, h, sp=sp)
            else:
                lin = [torch.nn.Linear(h * d, h * d) for _ in range(3)]
                draw = TA.attention_draw(T(xq), tspec, h, rate, torch.Generator().manual_seed(0),
                                         sp)
                TA.attention_train(T(xq), *lin, tspec, h, rate, draw, "attn", False, sp=sp)
        else:
            JA.mha_merged_quantize(*(jnp.asarray(xq),) * 3, jspec, h)
            TA.mha_merged_quantize(*(T(xq),) * 3, tspec, h, sp=sp)
    finally:
        JA.set_sequence_parallel(None)
    assert routes["port"] == routes["jax"] == int(
        lq == lk and lq % 2 == 0 and (rate == 0.0 or entry == "mha_merged_quantize"))
