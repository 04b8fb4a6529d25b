"""The port's W8A8 block (#8), the int8-emitting flash forward (#11) and the
int8 pointer scores (#12) against the JAX package.

CPU, float32, one torch thread.  The plain versions are held against the
Pallas kernels in interpret mode and against the JAX oracles
(block_w8a8_reference, quantize_kv), on the case lists of
tests/test_w8a8.py and tests/test_pallas_attention.py; the modules that
route to them against their flax counterparts.  Inputs are numpy draws
from a seed handed to both frameworks.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.models import common as JC
from vitxtgqa_tpu.ops.masks import MaskSpec as JMaskSpec
from vitxtgqa_tpu.utils.torch_convert import flatten
from vitxtgqa_tpu_torch.models import common as TC
from vitxtgqa_tpu_torch.ops import flash_attention as TFA
from vitxtgqa_tpu_torch.ops import fused_block as TFB
from vitxtgqa_tpu_torch.ops import ptr_scores as TPS
from vitxtgqa_tpu_torch.ops.attention import quantize_kv
from vitxtgqa_tpu_torch.ops.masks import MaskSpec
from vitxtgqa_tpu_torch.utils.convert import BERT_LAYER, bert_layer_entries, convert_entries

T = torch.from_numpy


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _load(module, params, entries):
    flat = flatten(jax.tree_util.tree_map(np.asarray, params))
    module.load_state_dict(convert_entries(flat, entries), strict=True)
    return module


# ---------------------------------------------------------------------------
# #8: quantization and the W8A8 block
# ---------------------------------------------------------------------------


def _w8_case(rows, d=128, m=256, seed=1):
    """(jax arguments with [in, out] weights, torch arguments with the
    weights quantized from the nn.Linear [out, in] layout)."""
    rng = np.random.default_rng(seed)
    x_q, ctx = _rand(rng, rows, d), _rand(rng, rows, d)
    wo, bo = _rand(rng, d, d, scale=0.05), _rand(rng, d, scale=0.05)
    s1, g1 = 1.0 + _rand(rng, d, scale=0.05), _rand(rng, d, scale=0.05)
    w1, b1 = _rand(rng, d, m, scale=0.05), _rand(rng, m, scale=0.05)
    w2, b2 = _rand(rng, m, d, scale=0.05), _rand(rng, d, scale=0.05)
    s2, g2 = 1.0 + _rand(rng, d, scale=0.05), _rand(rng, d, scale=0.05)
    jax_args = [jnp.asarray(a) for a in (x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2)]
    lin = lambda w: T(np.ascontiguousarray(w.T))
    wo8, wos, w18, w1s, w28, w2s = TFB.quantize_block_weights(lin(wo), lin(w1), lin(w2))
    torch_args = (T(x_q), T(ctx), wo8, wos, T(bo), T(s1), T(g1), w18, w1s, T(b1), w28, w2s,
                  T(b2), T(s2), T(g2))
    return jax_args, torch_args


@pytest.mark.parametrize("what", ["quantize_weight", "quant_rows"])
def test_quantization_bit_exact_with_jax(what):
    """int8 values and f32 scales equal; the weight's scale axis is the
    output channel (dim 1 of the [out, in] weight, axis 0 of JAX's [in,
    out] kernel), with ties, zeros and the scale floor planted."""
    from vitxtgqa_tpu.ops import pallas_ffn as P

    rng = np.random.default_rng(2)
    x = _rand(rng, 96, 64, scale=3.0)
    x[0] = 0.0
    x[1, :4] = [127.5, -127.5, 0.5, -1.5]
    if what == "quantize_weight":
        jq, js = P.quantize_weight(jnp.asarray(x))
        tq, ts = TFB.quantize_weight(T(np.ascontiguousarray(x.T)))
        jq = np.asarray(jq).T
    else:
        jq, js = P._quant_rows(jnp.asarray(x))
        tq, ts = TFB.quant_rows(T(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))


@pytest.mark.parametrize("oracle", ["reference", "interpret"])
@pytest.mark.parametrize("rows", [512, 37])
def test_fused_block_w8a8_plain_matches_jax(rows, oracle):
    """Against block_w8a8_reference and the Pallas kernel in interpret mode:
    atol 5e-5, rtol 1e-4, the JAX test's own (the int32 sums are exact on
    both sides; the LayerNorms' f32 sums run in another order)."""
    from vitxtgqa_tpu.ops import pallas_ffn as P

    ja, ta = _w8_case(rows)
    want = (P.block_w8a8_reference(*ja) if oracle == "reference"
            else P.fused_block_w8a8(*ja, interpret=True))
    got = TFB.fused_block_w8a8(*ta)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=5e-5, rtol=1e-4)


def _rows_off(got, want, atol):
    """Share of rows [..., D] with an entry more than atol off."""
    d = np.abs(got - want).reshape(-1, got.shape[-1]).max(-1)
    return float((d > atol).mean()), float(d.max())


# W8A8 behind an attention: the port's and JAX's contexts differ in the last
# f32 bit (summation order), and where that moves an activation across the
# rounding boundary of its int8 step (~1 in 10^5 entries) its whole row
# moves by up to one step's weight (~1e-2 here).  So rows are held to 1e-4
# and at most 1% of them may be off, by at most W8A8_STEP_TOL.
W8A8_ROW_ATOL, W8A8_ROWS_OFF, W8A8_STEP_TOL = 1e-4, 0.01, 0.05


def test_w8a8_layer_gate_matches_jax(monkeypatch):
    """A layer at 2 x 1024 = 2048 rows of width 128 (the fused-block gate):
    W8A8 off and on against the JAX layer with its block gate opened on the
    CPU (the bf16 block in interpret mode, the W8A8 block through
    block_w8a8_reference), W8A8 rows as W8A8_ROW_ATOL says; the W8A8
    output moves off the bf16 one by < 3%; and the fused decode is off
    under W8A8."""
    from vitxtgqa_tpu.ops import attention as JA
    from vitxtgqa_tpu.ops import pallas_ffn as P

    kw = dict(hidden_size=128, num_hidden_layers=1, num_attention_heads=2, intermediate_size=256)
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 1024, 128)
    km = np.ones((2, 1024), np.float32)
    km[1, 900:] = 0.0
    jl = JC.TransformerLayer(JC.TransformerConfig(**kw))
    jspec = JMaskSpec(key_mask=jnp.asarray(km))
    params = jax.jit(jl.init)(jax.random.key(1), jnp.asarray(x), jspec)["params"]
    monkeypatch.setattr(JC.TransformerLayer, "_fused_block_ok",
                        lambda self, x, deterministic: deterministic and x.shape[-1] == 128)
    monkeypatch.setattr(P, "fused_block", functools.partial(P.fused_block, interpret=True))
    monkeypatch.setattr(P, "fused_block_w8a8", P.block_w8a8_reference)
    outs = {}
    for w8a8 in (False, True):
        JA.set_w8a8(w8a8)
        want = jl.apply({"params": params}, jnp.asarray(x), jspec)
        tl = _load(TC.TransformerLayer(TC.TransformerConfig(**kw), cpu_options(w8a8=w8a8)),
                   params, BERT_LAYER)
        got = tl(T(x), MaskSpec(key_mask=T(km)))
        if w8a8:
            off, worst = _rows_off(_np(got), np.asarray(want), W8A8_ROW_ATOL)
            print(f"W8A8 layer: {off:.4%} of rows off by > {W8A8_ROW_ATOL}, max {worst:.3e}")
            assert off <= W8A8_ROWS_OFF and worst <= W8A8_STEP_TOL
        else:
            np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)
        outs[w8a8] = _np(got)
        # the gate on a batch-1 CUDA tensor (a stand-in: its device and shape)
        enc = TC.TransformerEncoder(TC.TransformerConfig(**kw),
                                    cpu_options(w8a8=w8a8, kv_cache_int8=True))
        assert enc.fused_decode_ok(types.SimpleNamespace(is_cuda=True, shape=(1, 4))) is (not w8a8)
    diff = np.abs(outs[True] - outs[False]).max()
    rel = np.linalg.norm(outs[True] - outs[False]) / np.linalg.norm(outs[False])
    assert diff > 1e-6 and rel < 0.03, (diff, rel)


# ---------------------------------------------------------------------------
# #11: flash forward emitting the int8 decode cache
# ---------------------------------------------------------------------------


def test_flash_q8_plain_matches_pallas_interpret():
    """tests/test_pallas_attention.py's case: the output within 2e-5 of the
    Pallas kernel, the int8 caches equal to its, and the scales bit for bit
    those of JAX's quantize_kv — and within 1e-6 relative of the interpret
    kernel's, as the JAX test holds them (compiled, its division by 127 can
    round the last bit otherwise)."""
    from vitxtgqa_tpu.ops.attention import quantize_kv as jquantize_kv
    from vitxtgqa_tpu.ops.pallas_attention import flash_attention_merged_q8

    b, l, h, d = 2, 256, 4, 16
    rng = np.random.default_rng(11)
    q, k, v = (_rand(rng, b, l, h * d) for _ in range(3))
    mask = (rng.random((b, l)) > 0.2).astype(np.float32)
    want, (wk8, wks), (wv8, wvs) = flash_attention_merged_q8(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), dec_len=8,
        num_heads=h, interpret=True)
    got, (k8, ks), (v8, vs) = TFA.flash_attention_merged_q8(T(q), T(k), T(v), T(mask), 8, h)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5, rtol=2e-5)
    for t8, ts, w8, ws, x in ((k8, ks, wk8, wks, k), (v8, vs, wv8, wvs, v)):
        np.testing.assert_array_equal(_np(t8), np.asarray(w8))
        np.testing.assert_allclose(_np(ts), np.asarray(ws), rtol=1e-6)
        j8, js = jquantize_kv(jnp.asarray(x))
        np.testing.assert_array_equal(_np(t8), np.asarray(j8))
        np.testing.assert_array_equal(_np(ts), np.asarray(js))


def test_flash_q8_plain_matches_pallas_interpret_on_a_row_with_no_key():
    """L 142 (not a multiple of 128), dec_len 12, batch row 0 with no valid
    key: the output within 2e-5 of the Pallas kernel (the row's encoder
    rows average V over the 256 padded keys), the int8 caches equal."""
    from vitxtgqa_tpu.ops.pallas_attention import flash_attention_merged_q8

    b, l, h, d = 2, 142, 4, 16
    rng = np.random.default_rng(12)
    q, k, v = (_rand(rng, b, l, h * d) for _ in range(3))
    mask = (rng.random((b, l)) > 0.2).astype(np.float32)
    mask[0] = 0.0
    mask[:, l - 12:] = 0.0
    want, (wk8, wks), (wv8, wvs) = flash_attention_merged_q8(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), dec_len=12,
        num_heads=h, interpret=True)
    got, (k8, ks), (v8, vs) = TFA.flash_attention_merged_q8(T(q), T(k), T(v), T(mask), 12, h)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5, rtol=2e-5)
    for t8, w8 in ((k8, wk8), (v8, wv8)):
        np.testing.assert_array_equal(_np(t8), np.asarray(w8))


def test_encode_with_cache_quantize_matches_flax():
    """encode_with_cache(quantize=True) over 256 keys (the flash route):
    the port's emitted cache equals its own quantize_cache of the unfused
    encode bit for bit, and the JAX module's within one int8 step (a
    last-bit difference of the f32 projections can flip a rounding),
    scales and hidden states within 1e-5."""
    kw = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128)
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 256, 64)
    km = np.ones((2, 256), np.float32)
    km[0, 200:] = 0.0
    jenc = JC.TransformerEncoder(JC.TransformerConfig(**kw))
    jspec = JMaskSpec(key_mask=jnp.asarray(km))
    params = jax.jit(jenc.init)(jax.random.key(1), jnp.asarray(x), jspec)["params"]
    entries = [e for i in range(2) for e in bert_layer_entries("", "", i)]
    tenc = _load(TC.TransformerEncoder(TC.TransformerConfig(**kw), cpu_options()), params, entries)
    jh, jkv = jax.jit(lambda p, a: jenc.apply({"params": p}, a, jspec, quantize=True,
                                              method="encode_with_cache"))(params, jnp.asarray(x))
    spec = MaskSpec(key_mask=T(km))
    th, tkv = tenc.encode_with_cache(T(x), spec, quantize=True)
    sep = tenc.quantize_cache(tenc.encode_with_cache(T(x), spec)[1])
    np.testing.assert_allclose(_np(th), np.asarray(jh), atol=1e-5, rtol=1e-5)
    for (tk, tv), (sk, sv), (jk, jv) in zip(tkv, sep, jkv):
        for t, s, j in ((tk, sk, jk), (tv, sv, jv)):
            assert torch.equal(t[0], s[0]) and torch.equal(t[1], s[1])
            assert np.abs(_np(t[0]).astype(int) - np.asarray(j[0]).astype(int)).max() <= 1
            np.testing.assert_allclose(_np(t[1]), np.asarray(j[1]), rtol=1e-5)


# ---------------------------------------------------------------------------
# #12: pointer scores over int8 keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,tile", [(2, 8), (5, 1), (5, 2), (5, 8)])
def test_ptr_scores_int8_plain_matches_pallas_interpret(b, tile):
    """tests/test_pallas_attention.py's cases, a batch that is not a tile
    multiple among them: 1e-4 (the JAX tests' own)."""
    from vitxtgqa_tpu.ops.attention import quantize_kv as jquantize_kv
    from vitxtgqa_tpu.ops.pallas_attention import ptr_scores_int8

    rng = np.random.default_rng(7 + b)
    q, k = _rand(rng, b, 1, 64), _rand(rng, b, 70, 64)
    mask = (rng.random((b, 70)) > 0.3).astype(np.float32)
    k8, ks = jquantize_kv(jnp.asarray(k))
    want = ptr_scores_int8(jnp.asarray(q), k8, ks, jnp.asarray(mask), interpret=True,
                           batch_tile=tile)
    tk8, tks = quantize_kv(T(k))
    got = TPS.ptr_scores_int8(T(q), tk8, tks, T(mask))
    assert got.shape == (b, 1, 70) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_scores_from_keys_int8_matches_flax():
    """OcrPtrNet.scores_from_keys with (k8, ks) keys: on the CPU both
    packages dequantize and take the einsum (the kernel is the CUDA
    route); the raw 0/1 mask is added.  1e-5."""
    from vitxtgqa_tpu.ops.attention import quantize_kv as jquantize_kv

    rng = np.random.default_rng(5)
    y, k = _rand(rng, 3, 1, 128), _rand(rng, 3, 40, 128)
    mask = (rng.random((3, 40)) > 0.4).astype(np.float32)
    jp = JC.OcrPtrNet(hidden_size=128, query_key_size=128)
    params = jax.jit(jp.init)(jax.random.key(0), jnp.asarray(y), jnp.asarray(k),
                              jnp.asarray(mask))["params"]
    tp = _load(TC.OcrPtrNet(128, 128), params,
               [("query", "query", "linear"), ("key", "key", "linear")])
    want = jax.jit(lambda p, a, kk, m: jp.apply({"params": p}, a, kk, m,
                                                method="scores_from_keys"))(
        params, jnp.asarray(y), jquantize_kv(jnp.asarray(k)), jnp.asarray(mask))
    got = tp.scores_from_keys(T(y), quantize_kv(T(k)), T(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
