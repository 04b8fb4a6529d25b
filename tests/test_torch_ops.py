"""The PyTorch port's ops (vitxtgqa_tpu_torch/ops) against the JAX package.

Everything runs on the CPU in float32.  The kernels' plain PyTorch
versions are held against the JAX Pallas kernels run in interpret mode,
on the case lists of tests/test_pallas_attention.py and
tests/test_pallas_ffn.py.  Inputs are made with numpy from a seed and
handed to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops import attention as TA
from vitxtgqa_tpu_torch.ops import decode_attention as TDA
from vitxtgqa_tpu_torch.ops import flash_attention as TFA
from vitxtgqa_tpu_torch.ops import fused_block as TFB
from vitxtgqa_tpu_torch.ops import gumbel as TG
from vitxtgqa_tpu_torch.ops import masks as TM

T = torch.from_numpy


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _enc_mask(b, l_enc, lengths):
    return (np.arange(l_enc)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dec_len", [0, 12])
def test_mask_spec_to_bias_matches_jax(dec_len):
    from vitxtgqa_tpu.ops import masks as JM

    enc = _enc_mask(2, 40, [31, 40])
    if dec_len:
        want = JM.joint_mask_spec(jnp.asarray(enc), dec_len).to_bias()
        got = TM.joint_mask_spec(T(enc), dec_len).to_bias()
    else:
        want = JM.MaskSpec(key_mask=jnp.asarray(enc)).to_bias()
        got = TM.MaskSpec(key_mask=T(enc)).to_bias()
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("step", [0, 5, 11])
def test_decode_step_spec_to_bias_matches_jax(step):
    from vitxtgqa_tpu.ops import masks as JM

    km = np.pad(_enc_mask(2, 52, [40, 52]), ((0, 0), (0, 76)))
    want = JM.DecodeStepSpec(key_mask=jnp.asarray(km), step=jnp.int32(step),
                             write_offset=116).to_bias()
    got = TM.DecodeStepSpec(key_mask=T(km), step=step, write_offset=116).to_bias()
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_length_mask_and_prefix_lm_bias_match_jax():
    from vitxtgqa_tpu.ops import masks as JM

    lengths = np.array([3, 7, 0])
    np.testing.assert_array_equal(
        _np(TM.length_mask(T(lengths), 9)), np.asarray(JM.length_mask(jnp.asarray(lengths), 9))
    )
    enc = _enc_mask(2, 20, [13, 20])
    np.testing.assert_array_equal(
        _np(TM.prefix_lm_bias(T(enc), 6)), np.asarray(JM.prefix_lm_bias(jnp.asarray(enc), 6))
    )
    np.testing.assert_array_equal(
        _np(TM.self_attention_bias(T(enc))), np.asarray(JM.self_attention_bias(jnp.asarray(enc)))
    )


# ---------------------------------------------------------------------------
# int8 KV quantization: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 50, 128), (3, 7, 768)])
def test_quantize_kv_bit_exact(shape):
    from vitxtgqa_tpu.ops.attention import dequantize_kv, quantize_kv

    rng = np.random.default_rng(0)
    x = _rand(rng, *shape, scale=3.0)
    x[0, 0] = 0.0  # an all-zero token hits the 1e-6 scale floor
    x[-1, 1, :5] = [127.5, -127.5, 0.5, -0.5, 1.5]  # round-half-even ties
    q8, s = TA.quantize_kv(T(x))
    jq8, js = quantize_kv(jnp.asarray(x))
    assert q8.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(_np(q8), np.asarray(jq8))
    np.testing.assert_array_equal(_np(s), np.asarray(js))
    np.testing.assert_array_equal(
        _np(TA.dequantize_kv(q8, s)), np.asarray(dequantize_kv(jq8, js))
    )


# ---------------------------------------------------------------------------
# gumbel / top-k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("largest", [True, False])
def test_topk_breaks_ties_by_index_like_jax(largest):
    from vitxtgqa_tpu.ops import gumbel as JG

    rng = np.random.default_rng(1)
    s = rng.integers(0, 3, size=(4, 6, 15)).astype(np.float32)
    s[s == 0] = -10000.0  # the grounding's -10000 tie blocks
    np.testing.assert_array_equal(
        _np(TG.topk_mask(T(s), 5, largest)), np.asarray(JG.topk_mask(jnp.asarray(s), 5, largest))
    )
    np.testing.assert_array_equal(
        _np(TG.topk_indices_sorted(T(s), 5, largest)),
        np.asarray(JG.topk_indices_sorted(jnp.asarray(s), 5, largest)),
    )


def test_gumbel_softmax_with_given_noise_matches_jax_formula():
    rng = np.random.default_rng(2)
    logits, noise = _rand(rng, 3, 2, 9), rng.gumbel(size=(3, 2, 9)).astype(np.float32)
    got = TG.gumbel_softmax(T(logits), T(noise), dim=1)
    y = jax.nn.softmax(jnp.asarray(logits + noise), axis=1)
    yh = jnp.put_along_axis(jnp.zeros_like(y), jnp.argmax(y, axis=1, keepdims=True), 1.0,
                            axis=1, inplace=False)
    np.testing.assert_array_equal(_np(got), np.asarray(yh + y - jax.lax.stop_gradient(y)))


def test_sample_gumbel_is_seeded():
    a = TG.sample_gumbel((4, 5), torch.Generator().manual_seed(3))
    b = TG.sample_gumbel((4, 5), torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and torch.isfinite(a).all()


# ---------------------------------------------------------------------------
# flash attention (plain version vs the Pallas kernel in interpret mode)
# ---------------------------------------------------------------------------


FLASH_CASES = {
    # name: (b, h, d, l_enc, dec_len, valid lengths)
    "prefix_lm": (2, 4, 16, 52, 12, [40, 52]),
    "blocked_q": (2, 4, 16, 244, 12, [200, 244]),
    "key_mask_only": (2, 4, 16, 130, 0, [77, 130]),
    "compact_rows": (2, 12, 64, 372, 12, [372, 233]),
    # a batch row with no valid key at lengths that are not multiples of
    # 128: its encoder rows average V over the JAX wrapper's padded keys
    "no_key_row": (2, 4, 16, 130, 0, [0, 77]),
    "no_key_row_dec": (2, 4, 16, 130, 12, [0, 100]),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas_interpret(case):
    """f32: both sides compute the same masked softmax; 2e-5 as in the JAX
    tests (summation order only)."""
    from vitxtgqa_tpu.ops.pallas_attention import flash_attention_merged

    b, h, d, l_enc, dec, lengths = FLASH_CASES[case]
    rng = np.random.default_rng(5)
    l = l_enc + dec
    q, k, v = (_rand(rng, b, l, h * d) for _ in range(3))
    km = np.pad(_enc_mask(b, l_enc, lengths), ((0, 0), (0, dec)))
    want = flash_attention_merged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(km), dec, num_heads=h, interpret=True)
    got = TFA.flash_attention_merged(T(q), T(k), T(v), T(km), dec, h)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_mha_merged_routes_long_mask_spec_to_flash(monkeypatch):
    """Key length >= 256 with a MaskSpec takes the flash path (its plain
    version on CPU); shorter ones and additive biases stay on mha.  Both
    match the JAX mha_merged."""
    from vitxtgqa_tpu.ops import attention as JA
    from vitxtgqa_tpu.ops.masks import MaskSpec as JMaskSpec

    calls = []
    real = TFA.flash_attention_merged_plain
    monkeypatch.setattr(TFA, "flash_attention_merged_plain",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    rng = np.random.default_rng(6)
    for l in (128, 256):
        q, k, v = (_rand(rng, 2, l, 64) for _ in range(3))
        km = _enc_mask(2, l, [l - 30, l])
        got = TA.mha_merged(T(q), T(k), T(v), TM.MaskSpec(key_mask=T(km)), 4)
        want = JA.mha_merged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             JMaskSpec(key_mask=jnp.asarray(km)), 4)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5, rtol=2e-5)
    assert calls == [(2, 256, 64)]


# ---------------------------------------------------------------------------
# fused post-attention block
# ---------------------------------------------------------------------------


def _block_case(rows=70, d=128, m=256, seed=1):
    rng = np.random.default_rng(seed)
    x_q, ctx = _rand(rng, 2, rows, d), _rand(rng, 2, rows, d)
    wo, bo = _rand(rng, d, d, scale=0.05), _rand(rng, d, scale=0.05)
    s1, g1 = 1.0 + _rand(rng, d, scale=0.05), _rand(rng, d, scale=0.05)
    w1, b1 = _rand(rng, d, m, scale=0.05), _rand(rng, m, scale=0.05)
    w2, b2 = _rand(rng, m, d, scale=0.05), _rand(rng, d, scale=0.05)
    s2, g2 = 1.0 + _rand(rng, d, scale=0.05), _rand(rng, d, scale=0.05)
    jax_args = (x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2)
    # the port takes nn.Linear layout: [out, in]
    torch_args = (x_q, ctx, wo.T, bo, s1, g1, w1.T, b1, w2.T, b2, s2, g2)
    return ([jnp.asarray(a) for a in jax_args],
            [T(np.ascontiguousarray(a)) for a in torch_args])


@pytest.mark.parametrize("rows,d,m", [(70, 128, 256), (20, 128, 128)])
def test_fused_block_plain_matches_pallas_interpret(rows, d, m):
    """5e-5 as in the JAX tests: the Pallas gelu's A&S erf is within 1.5e-7
    of the exact erf the port uses; the rest is summation order."""
    from vitxtgqa_tpu.ops.pallas_ffn import fused_block

    ja, ta = _block_case(rows, d, m)
    want = fused_block(*ja, interpret=True)
    np.testing.assert_allclose(_np(TFB.fused_block(*ta)), np.asarray(want), atol=5e-5)


def test_fused_block_tanh_plain_matches_pallas_interpret():
    from vitxtgqa_tpu.ops.pallas_ffn import fused_block_tanh

    ja, ta = _block_case()
    res = _rand(np.random.default_rng(7), *ta[0].shape)
    want = fused_block_tanh(jnp.asarray(res), *ja, interpret=True)
    got = TFB.fused_block_tanh(T(res), *ta)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=5e-5)


def test_fused_block_gate_matches_jax():
    from vitxtgqa_tpu.ops.pallas_ffn import ffn_kernel_ok

    for d, m, rows in [(768, 3072, 9216), (768, 3072, 2047), (64, 128, 4096), (128, 256, 2048)]:
        assert TFB.kernel_ok(d, m, rows) == ffn_kernel_ok(d, m, rows)


# ---------------------------------------------------------------------------
# int8 decode attention
# ---------------------------------------------------------------------------


def _decode_case(b=2, h=4, l_enc=96, dec_len=12, d=16, seed=3, masked_row=None):
    """q, k, v and the key mask of one decode step; ``masked_row``: that
    batch row has no valid encoder key (its only allowed keys are the
    decoder slots)."""
    rng = np.random.default_rng(seed)
    l = l_enc + dec_len
    q = _rand(rng, b, 1, h * d)
    k, v = _rand(rng, b, l, h * d), _rand(rng, b, l, h * d)
    km = np.pad(_enc_mask(b, l_enc, [l_enc - 17, l_enc][:b] + [l_enc] * (b - 2)),
                ((0, 0), (0, dec_len)))
    if masked_row is not None:
        km[masked_row] = 0.0
    return q, k, v, km


# the decode cases: small; the compact cache (384 keys); a batch row with
# every encoder key masked; a ragged cache of 300 keys, which the JAX
# wrappers pad to 384 and no launch plan of the kernel splits evenly
DECODE_GEOMETRY = {"small": {}, "compact": dict(b=3, h=12, l_enc=372, d=64),
                   "masked_row": dict(b=3, masked_row=1),
                   "ragged": dict(b=3, h=12, l_enc=288, d=64)}
DECODE_CASES = [("small", 0), ("small", 4), ("small", 11), ("compact", 3), ("masked_row", 0),
                ("masked_row", 11), ("ragged", 0), ("ragged", 11)]


@pytest.mark.parametrize("geometry,step", DECODE_CASES)
def test_decode_int8_plain_matches_pallas_interpret(geometry, step):
    """Both sides fold the scales the same way in f32: 1e-5."""
    from vitxtgqa_tpu.ops.attention import quantize_kv
    from vitxtgqa_tpu.ops.pallas_attention import decode_attention_int8

    kw = DECODE_GEOMETRY[geometry]
    q, k, v, km = _decode_case(**kw)
    h, wo = kw.get("h", 4), kw.get("l_enc", 96)
    (k8, ks), (v8, vs) = quantize_kv(jnp.asarray(k)), quantize_kv(jnp.asarray(v))
    want = decode_attention_int8(jnp.asarray(q), k8, ks, v8, vs, jnp.asarray(km),
                                 jnp.int32(step), write_offset=wo, num_heads=h, interpret=True)
    tk, tv = TA.quantize_kv(T(k)), TA.quantize_kv(T(v))
    got = TDA.decode_attention_int8(T(q), *tk, *tv, T(km), step, wo, h)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("geometry,step", DECODE_CASES)
def test_decode_bf16_cache_plain_matches_pallas_interpret(geometry, step):
    """The bf16-cache form: the probabilities round to the cache's dtype
    (f32 here) on both sides, scores in f32: 1e-5."""
    from vitxtgqa_tpu.ops.pallas_attention import decode_attention

    kw = DECODE_GEOMETRY[geometry]
    q, k, v, km = _decode_case(**kw)
    h, wo = kw.get("h", 4), kw.get("l_enc", 96)
    want = decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km),
                            jnp.int32(step), write_offset=wo, num_heads=h, interpret=True)
    got = TDA.decode_attention(T(q), T(k), T(v), T(km), step, wo, h)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_mha_matches_jax(quantized):
    """The port routes an int8 cache to the decode kernel's plain version
    (scales folded into scores/weights); JAX on CPU dequantizes first —
    the same values in another rounding order: 1e-5."""
    from vitxtgqa_tpu.ops import attention as JA
    from vitxtgqa_tpu.ops.masks import DecodeStepSpec as JSpec

    q, k, v, km = _decode_case()
    spec_j = JSpec(key_mask=jnp.asarray(km), step=jnp.int32(5), write_offset=96)
    spec_t = TM.DecodeStepSpec(key_mask=T(km), step=5, write_offset=96)
    if quantized:
        jk, jv = JA.quantize_kv(jnp.asarray(k)), JA.quantize_kv(jnp.asarray(v))
        tk, tv = TA.quantize_kv(T(k)), TA.quantize_kv(T(v))
    else:
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), T(k), T(v)
    want = JA.decode_mha(jnp.asarray(q), jk, jv, spec_j, num_heads=4)
    got = TA.decode_mha(T(q), tk, tv, spec_t, 4)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("batch", [1, 2, 8, 64, 576])
@pytest.mark.parametrize("cache_len", [300, 384, 1152])
def test_decode_launch_plan_covers_every_key_once(batch, cache_len):
    """The decode kernel's launch plan at 12 heads of 64, both cache types:
    the cluster's spans hold every key exactly once; a block's row segment
    and a cache row are whole 16-byte chunks, which its threads split
    evenly; its shared memory and compaction fit; and the grid has at
    least 96 blocks at batch 1 and 8."""
    for elem in (1, 2):
        plan = TDA.launch_plan(batch, cache_len, 12, elem)
        spans = [range(r * plan.span, min(cache_len, (r + 1) * plan.span))
                 for r in range(plan.cluster)]
        assert sorted(j for sp in spans for j in sp) == list(range(cache_len))
        assert 1 <= plan.cluster <= TDA.MAX_CLUSTER
        assert plan.heads_per_group * plan.head_groups == 12
        assert (plan.heads_per_group * 64 * elem) % 16 == 0 and (12 * 64 * elem) % 16 == 0
        assert TDA.THREADS % (plan.heads_per_group * 64 * elem // 16) == 0
        assert plan.span <= TDA.MAX_PER_THREAD * TDA.THREADS
        assert plan.smem == TDA.smem_bytes(plan.span, plan.heads_per_group, elem)
        assert plan.smem <= TDA.SMEM_LIMIT
        assert plan.blocks == batch * plan.head_groups * plan.cluster
        if batch in (1, 8):
            assert plan.blocks >= 96


def test_decode_wrappers_need_the_decoder_slot():
    """The kernel reads only the allowed keys, so the wrappers refuse a
    step whose decoder slots leave the cache."""
    TDA._check_slots(1152, 11, 1140)
    for step, wo in ((12, 1140), (0, 1152), (0, -1), (-1, 1140)):
        with pytest.raises(ValueError, match="decoder slots"):
            TDA._check_slots(1152, step, wo)


# ---------------------------------------------------------------------------
# wrappers and the build: no silent fallback
# ---------------------------------------------------------------------------


def test_wrappers_on_cpu_run_plain_and_count_nothing():
    _build.reset_launch_counts()
    q, k, v, km = _decode_case()
    (k8, ks), (v8, vs) = TA.quantize_kv(T(k)), TA.quantize_kv(T(v))
    TDA.decode_attention_int8(T(q), k8, ks, v8, vs, T(km), 0, 96, 4)
    TDA.decode_attention(T(q), T(k), T(v), T(km), 0, 96, 4)
    x = T(_rand(np.random.default_rng(0), 1, 300, 64))
    TFA.flash_attention_merged(x, x, x, torch.ones(1, 300), 0, 4)
    assert _build.launch_counts() == {name: 0 for name in _build.LAUNCHES}


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.lib()
    assert _build._lib is None and not (tmp_path / "kernels").exists()


def test_kernel_wrappers_refuse_cpu_scratch_on_cuda_checks():
    """The argument checks of the CUDA route raise instead of converting."""
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _build.require(torch.zeros(4), "x", torch.float32)
