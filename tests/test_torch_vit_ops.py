"""The ViT slice's kernel ops (ops/ffn.py, ops/fused_attention.py) and the
split-head mha route against the JAX package.

Everything runs on the CPU.  The plain versions, which the wrappers run on
CPU tensors, are held against the JAX Pallas kernels in interpret mode and
the JAX oracles, on the case lists of tests/test_pallas_ffn.py and
tests/test_pallas_attention.py.  Inputs are made with numpy from a seed and
handed to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.ops import attention as TA
from vitxtgqa_tpu_torch.ops import ffn as TFFN
from vitxtgqa_tpu_torch.ops import fused_attention as TFA
from vitxtgqa_tpu_torch.ops import masks as TM

T = torch.from_numpy


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# #13 fused FFN
# ---------------------------------------------------------------------------


def _ffn_case(rows, d=128, m=256, seed=0):
    """x [2, rows, d] and the weights in flax layout (w1 [d, m], w2 [m, d])."""
    rng = np.random.default_rng(seed)
    return (_rand(rng, 2, rows, d), _rand(rng, d, m, scale=0.05), _rand(rng, m, scale=0.05),
            _rand(rng, m, d, scale=0.05), _rand(rng, d, scale=0.05))


def _port_ffn_args(x, w1, b1, w2, b2, dtype=torch.float32):
    """The numpy case in the port's layout (nn.Linear weights [out, in])."""
    return T(x).to(dtype), T(w1.T.copy()), T(b1), T(w2.T.copy()), T(b2)


# (rows, dtype, tolerance): the JAX tests' cases and limits.  f32: the
# Pallas kernel's erf approximation (1.5e-7) against the exact erf; a row
# count off the 512-row block exercises the Pallas padding; bf16: one
# rounding of the activations more or less
FFN_CASES = {
    "f32": (70, torch.float32, 5e-5),
    "row_padding": (37, torch.float32, 5e-5),
    "bf16": (70, torch.bfloat16, 3e-2),
}


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_fused_ffn_plain_matches_pallas_and_reference(case):
    from vitxtgqa_tpu.ops.pallas_ffn import ffn_reference, fused_ffn

    rows, dtype, tol = FFN_CASES[case]
    x, w1, b1, w2, b2 = _ffn_case(rows)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jargs = (jnp.asarray(x).astype(jdt), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
             jnp.asarray(b2))
    got = TFFN.fused_ffn(*_port_ffn_args(x, w1, b1, w2, b2, dtype))
    assert got.dtype == dtype and got.shape == (2, rows, 128)
    for want in (fused_ffn(*jargs, interpret=True), ffn_reference(*jargs)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)


def test_fused_ffn_grads_match_jax():
    """FusedFFNFn's backward (through fused_ffn_plain) against jax.grad of
    the Pallas kernel's custom_vjp (through ffn_reference), every input."""
    from vitxtgqa_tpu.ops.pallas_ffn import fused_ffn

    x, w1, b1, w2, b2 = _ffn_case(70)
    jargs = tuple(jnp.asarray(a) for a in (x, w1, b1, w2, b2))
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(fused_ffn(*a, interpret=True))),
                    argnums=(0, 1, 2, 3, 4))(*jargs)
    leaves = [t.requires_grad_() for t in _port_ffn_args(x, w1, b1, w2, b2)]
    torch.sin(TFFN.fused_ffn(*leaves)).sum().backward()
    got = [leaves[0].grad, leaves[1].grad.t(), leaves[2].grad, leaves[3].grad.t(), leaves[4].grad]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("d, m, rows", [
    (128, 256, 2048), (128, 256, 2047), (1024, 4096, 64 * 197), (1024, 4096, 10 * 197),
    (768, 3072, 64 * 50), (96, 256, 4096), (128, 200, 4096),
])
def test_ffn_kernel_ok_is_the_jax_gate(d, m, rows):
    from vitxtgqa_tpu.ops.pallas_ffn import ffn_kernel_ok

    assert TFFN.ffn_kernel_ok(d, m, rows) == ffn_kernel_ok(d, m, rows)


# ---------------------------------------------------------------------------
# #14 bias-tensor attention
# ---------------------------------------------------------------------------


def _qkv(rng, b, h, lq, lk, d):
    return _rand(rng, b, h, lq, d), _rand(rng, b, h, lk, d), _rand(rng, b, h, lk, d)


def _key_mask_bias(b, lk, lengths):
    mask = (np.arange(lk)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return np.asarray(TM.self_attention_bias(T(mask)))


def _prefix_lm_bias(lenc, dec, lengths):
    enc = (np.arange(lenc)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return np.asarray(TM.prefix_lm_bias(T(enc), dec))


def _attn_case(case):
    """(q, k, v, bias or None, dtype, tolerance): test_pallas_attention.py's
    cases, and Lq != Lk and fully masked rows (every real key at -10000:
    a softmax over the scores shifted by -10000, as both kernels compute
    it), and rows with -1e9 on every key at a key count off a multiple of
    128 (the Pallas kernel's padded keys, also -1e9, share the row).  f32
    within 2e-5, bf16 within 3e-2 (the JAX tests' limits)."""
    rng = np.random.default_rng(7)
    f32, bf = torch.float32, torch.bfloat16
    if case == "no_bias":
        return (*_qkv(rng, 2, 3, 70, 70, 24), None, f32, 2e-5)
    if case == "key_mask":
        return (*_qkv(rng, 2, 3, 50, 50, 24), _key_mask_bias(2, 50, [30, 45]), f32, 2e-5)
    if case == "prefix_lm":
        return (*_qkv(rng, 2, 2, 46, 46, 16), _prefix_lm_bias(40, 6, [33, 40]), f32, 2e-5)
    if case == "bf16":
        return (*_qkv(rng, 2, 3, 64, 64, 32), None, bf, 3e-2)
    if case == "lq_ne_lk_key_mask":
        return (*_qkv(rng, 2, 3, 40, 70, 24), _key_mask_bias(2, 70, [55, 70]), f32, 2e-5)
    if case == "lq_ne_lk_per_row":
        bias = np.where(rng.random((2, 1, 40, 70)) < 0.3, -10000.0, 0.0).astype(np.float32)
        return (*_qkv(rng, 2, 3, 40, 70, 24), bias, f32, 2e-5)
    if case == "fully_masked_key_rows":
        return (*_qkv(rng, 2, 3, 50, 50, 24), _key_mask_bias(2, 50, [0, 45]), f32, 2e-5)
    if case == "fully_masked_prefix_lm_rows":
        return (*_qkv(rng, 2, 2, 46, 46, 16), _prefix_lm_bias(40, 6, [0, 40]), f32, 2e-5)
    if case == "padded_keys_key_mask":
        # batch row 1's bias is -1e9 on every key: the Pallas kernel's 126
        # padded keys (also -1e9) take their share, 130 / 256 of the row
        bias = np.zeros((2, 1, 1, 130), np.float32)
        bias[0, ..., 100:] = -1e9
        bias[1] = -1e9
        return (*_qkv(rng, 2, 2, 130, 130, 16), bias, f32, 2e-5)
    if case == "padded_keys_per_row":
        # query rows 3, 17 and 39 of batch row 0 and 0-9 of batch row 1
        # have -1e9 on every key: 300 / 384 of the row
        bias = np.where(rng.random((2, 1, 40, 300)) < 0.3, -1e9, 0.0).astype(np.float32)
        bias[0, 0, [3, 17, 39]] = -1e9
        bias[1, 0, :10] = -1e9
        return (*_qkv(rng, 2, 3, 40, 300, 24), bias, f32, 2e-5)
    raise KeyError(case)


ATTN_CASES = ("no_bias", "key_mask", "prefix_lm", "bf16", "lq_ne_lk_key_mask",
              "lq_ne_lk_per_row", "fully_masked_key_rows", "fully_masked_prefix_lm_rows",
              "padded_keys_key_mask", "padded_keys_per_row")


@pytest.mark.parametrize("case", ATTN_CASES)
def test_fused_attention_plain_matches_pallas(case):
    from vitxtgqa_tpu.ops.pallas_attention import fused_attention

    q, k, v, bias, dtype, tol = _attn_case(case)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = fused_attention(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                           None if bias is None else jnp.asarray(bias), interpret=True)
    got = TFA.fused_attention(*(T(a).to(dtype) for a in (q, k, v)),
                              None if bias is None else T(bias))
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)


def test_fused_attention_on_a_split_head_view():
    """The wrapper takes q / k / v as the split-head views of merged
    projections (the ViT's), with no copy on the CPU either."""
    rng = np.random.default_rng(3)
    x = [T(_rand(rng, 2, 300, 4 * 64)) for _ in range(3)]
    q, k, v = (TA.split_heads(t, 4) for t in x)
    assert not q.is_contiguous()
    got = TFA.fused_attention(q, k, v)
    want = TA.mha_reference(q.contiguous(), k.contiguous(), v.contiguous())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("case", ["key_mask", "prefix_lm", "no_bias"])
def test_fused_attention_grads_match_jax(case):
    """The wrapper's output is a FusedAttentionFn node, whose backward
    (recomputed through fused_attention_plain) gives q / k / v the
    gradients of jax.grad through the JAX oracle mha_reference; on the card
    the same node carries the kernel's output (chip_smoke.py holds the
    384-px ViT's gradients through it)."""
    from vitxtgqa_tpu.ops.attention import mha_reference

    q, k, v, bias, _, _ = _attn_case(case)
    g = _rand(np.random.default_rng(8), *q.shape)
    jb = None if bias is None else jnp.asarray(bias)
    want = jax.grad(lambda *a: jnp.sum(mha_reference(*a, jb) * jnp.asarray(g)),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [T(a).requires_grad_() for a in (q, k, v)]
    out = TFA.fused_attention(*leaves, None if bias is None else T(bias))
    assert type(out.grad_fn).__name__ == "FusedAttentionFnBackward"
    (out * T(g)).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the split-head mha route against the JAX gate
# ---------------------------------------------------------------------------

ROUTE_CASES = [
    # (bias kind, Lq, Lk, dropout rate)
    ("none", 300, 300, 0.0), ("none", 2, 256, 0.0), ("none", 300, 255, 0.0),
    ("none", 1, 300, 0.0), ("none", 300, 300, 0.1),
    ("key", 300, 300, 0.0), ("key", 20, 20, 0.0), ("key", 40, 300, 0.0),
    ("key", 300, 300, 0.1), ("row", 300, 300, 0.0), ("row", 40, 256, 0.0),
    ("row", 300, 200, 0.0), ("mask_spec", 300, 300, 0.0), ("mask_spec", 20, 20, 0.0),
    ("decode_step", 1, 300, 0.0),
]


@pytest.mark.parametrize("kind, lq, lk, rate", ROUTE_CASES)
def test_mha_takes_the_bias_kernel_where_the_jax_gate_does(kind, lq, lk, rate, monkeypatch):
    """The port's mha reaches fused_attention (#14) exactly where JAX's mha,
    with its Pallas path on, reaches pallas_attention.fused_attention; a
    MaskSpec, which JAX sends to the split-head flash kernel (#10) at equal
    lengths, takes the plain path in the port's mha without sequence
    parallelism (the port reaches #10 through sp_attention only; full
    sequences take mha_merged's flash route)."""
    from vitxtgqa_tpu.ops import attention as JA
    from vitxtgqa_tpu.ops import masks as JM
    from vitxtgqa_tpu.ops import pallas_attention as JPA

    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 1, 1, lq, lk, 8)
    mask = (rng.random((1, lk)) > 0.2).astype(np.float32)
    routes = {"jax": [], "port": []}

    def record(side, name, fn=None):
        def call(q, *a, **kw):
            routes[side].append(name)
            return fn(q, *a, **kw) if fn is not None else q
        return call

    monkeypatch.setattr(JA, "_on_tpu", lambda: True)
    monkeypatch.setattr(JA, "_GLOBAL_USE_PALLAS", True)
    monkeypatch.setattr(JPA, "fused_attention", record("jax", "fused"))
    monkeypatch.setattr(JPA, "flash_attention", record("jax", "flash"))
    monkeypatch.setattr(TA, "fused_attention", record("port", "fused", TA.fused_attention))
    jbias, tbias = {
        "none": (None, None),
        "key": (JM.self_attention_bias(jnp.asarray(mask)), TM.self_attention_bias(T(mask))),
        "row": ((jnp.zeros((1, 1, lq, lk)), torch.zeros(1, 1, lq, lk))),
        "mask_spec": (JM.MaskSpec(key_mask=jnp.asarray(mask)), TM.MaskSpec(key_mask=T(mask))),
        "decode_step": (JM.DecodeStepSpec(key_mask=jnp.asarray(mask), step=2, write_offset=lk - 4),
                        TM.DecodeStepSpec(key_mask=T(mask), step=2, write_offset=lk - 4)),
    }[kind]
    JA.mha(*(jnp.asarray(a) for a in (q, k, v)), jbias, dropout_rate=rate,
           dropout_rng=jax.random.key(0) if rate else None)
    out = TA.mha(T(q), T(k), T(v), tbias, rate, torch.Generator().manual_seed(0))
    assert out.shape == (1, 1, lq, 8)
    jax_fused = routes["jax"] == ["fused"]
    assert (routes["port"] == ["fused"]) == jax_fused
    assert jax_fused == TA.fused_attention_ok(tbias, lq, lk, rate)
    if kind == "mask_spec":
        assert routes["jax"] == (["flash"] if lk >= TA.MIN_KV else [])
