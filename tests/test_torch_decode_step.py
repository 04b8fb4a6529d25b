"""The port's single-kernel decode step and fused epilogue (plain versions
and the encoder methods around them) against the JAX package.

CPU, float32, the geometry of tests/test_pallas_decode_step.py.  The JAX
kernels run in Pallas interpret mode, as that file runs them; the port's
wrappers take their plain versions on CPU tensors.  Inputs are numpy draws
from a seed, handed to both sides; the port's weights are the JAX weights
transposed to nn.Linear layout.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.models import common as JC
from vitxtgqa_tpu.ops import pallas_decode_step as PDS
from vitxtgqa_tpu_torch.models import common as TC
from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops import attention as TA
from vitxtgqa_tpu_torch.ops import decode_step as TDS
from vitxtgqa_tpu_torch.ops.masks import DecodeStepSpec, MaskSpec
from vitxtgqa_tpu_torch.utils.convert import bert_layer_entries, convert_entries
from vitxtgqa_tpu.utils.torch_convert import flatten

N_LAYERS, B, LP, H, HD, M = 2, 3, 256, 4, 16, 128
D = H * HD
WRITE_OFF = 192  # decoder slots live at [192, 192 + dec)
T = torch.from_numpy


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _stacks(seed=7):
    """(JAX stacks in [in, out] layout, port stacks in [out, in] layout)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    shapes = {"wq": (D, D), "wk": (D, D), "wv": (D, D), "wo": (D, D),
              "w1": (D, M), "w2": (M, D)}
    jst, tst = {}, {}
    for name in TDS.STACK_NAMES:
        if name[0] == "w":
            w = mk(N_LAYERS, *shapes[name])
            jst[name], tst[name] = w, np.ascontiguousarray(w.transpose(0, 2, 1))
        else:
            v = mk(N_LAYERS, 1, M if name == "b1" else D)
            if name[0] == "s":
                v = v + 1.0
            jst[name] = tst[name] = v
    return ({k: jnp.asarray(v) for k, v in jst.items()},
            {k: T(np.array(v)) for k, v in tst.items()})


def _cache(seed=8, b=B):
    rng = np.random.default_rng(seed)
    kv8 = rng.integers(-127, 128, (N_LAYERS, b, LP, 2 * D)).astype(np.int8)
    kvs = rng.uniform(0.001, 0.02, (N_LAYERS, b, 2, LP)).astype(np.float32)
    x_t = (rng.standard_normal((b, 1, D)) * 0.3).astype(np.float32)
    mask = ((rng.uniform(size=(b, LP)) > 0.2) & (np.arange(LP)[None, :] < 160)).astype(np.float32)
    return kv8, kvs, x_t, mask


def _check_step(got, want):
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), atol=1e-7)


@pytest.mark.parametrize("step,b", [(0, B), (2, B), (1, 8)])
def test_fused_step_plain_matches_pallas_interpret_and_oracle(step, b):
    """y within 2e-5, row8 bit-exact, rowsc within 1e-7 against both the
    Pallas kernel (interpret) and fused_step_reference."""
    jst, tst = _stacks()
    kv8, kvs, x_t, mask = _cache(b=b)
    got = TDS.fused_decode_step_plain(T(x_t), tst, T(kv8), T(kvs), T(mask), step,
                                      WRITE_OFF, H)
    assert got[0].shape == (b, 1, D) and got[1].shape == (N_LAYERS, b, 1, 2 * D)
    assert got[1].dtype == torch.int8 and got[2].shape == (N_LAYERS, b, 2, 1)
    jargs = (jnp.asarray(x_t), jst, jnp.asarray(kv8), jnp.asarray(kvs), jnp.asarray(mask))
    kern = PDS.fused_decode_step(*jargs, jnp.int32(step), WRITE_OFF, H, interpret=True)
    ref = PDS.fused_step_reference(*jargs, step, WRITE_OFF, H)
    _check_step(got, ref)
    _check_step(got, kern)


def test_fused_step_wrapper_on_cpu_runs_plain_and_counts_nothing():
    _, tst = _stacks()
    kv8, kvs, x_t, mask = _cache()
    _build.reset_launch_counts()
    got = TDS.fused_decode_step(T(x_t), tst, T(kv8), T(kvs), T(mask), 1, WRITE_OFF, H)
    want = TDS.fused_decode_step_plain(T(x_t), tst, T(kv8), T(kvs), T(mask), 1, WRITE_OFF, H)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert _build.launch_counts() == {name: 0 for name in _build.LAUNCHES}


# ---------------------------------------------------------------------------
# the encoder methods: prep and a rollout with commits
# ---------------------------------------------------------------------------


def _encoders():
    kw = dict(hidden_size=D, num_hidden_layers=N_LAYERS, num_attention_heads=H,
              intermediate_size=M)
    jenc = JC.TransformerEncoder(JC.TransformerConfig(**kw, hidden_dropout_prob=0.0,
                                                      attention_probs_dropout_prob=0.0))
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, LP, D)) * 0.3).astype(np.float32)
    mask = np.pad(np.ones((B, WRITE_OFF), np.float32), ((0, 0), (0, LP - WRITE_OFF)))
    from vitxtgqa_tpu.ops.masks import MaskSpec as JMaskSpec

    variables = jax.jit(jenc.init)(jax.random.key(0), jnp.asarray(x),
                                   JMaskSpec(key_mask=jnp.asarray(mask)))
    flat = flatten(jax.tree_util.tree_map(np.asarray, variables["params"]))
    entries = [e for i in range(N_LAYERS) for e in bert_layer_entries("", "", i)]
    tenc = TC.TransformerEncoder(TC.TransformerConfig(**kw), cpu_options(kv_cache_int8=True))
    tenc.load_state_dict(convert_entries(flat, entries), strict=True)
    return jenc, variables, tenc, x, mask


def _caches(jenc, variables, tenc, x, mask):
    from vitxtgqa_tpu.ops.masks import MaskSpec as JMaskSpec

    _, jkvs = jenc.apply(variables, jnp.asarray(x), JMaskSpec(key_mask=jnp.asarray(mask)),
                         method=JC.TransformerEncoder.encode_with_cache)
    jcache = jenc.apply(variables, jkvs, method=JC.TransformerEncoder.quantize_cache)
    with torch.no_grad():
        _, tkvs = tenc.encode_with_cache(T(x), MaskSpec(key_mask=T(mask)))
    return jcache, tenc.quantize_cache(tkvs)


def test_fused_decode_prep_matches_jax():
    """Stacks equal up to the [in, out] -> [out, in] transpose; the packed
    caches are bit-equal when both sides pack the same quantized cache."""
    jenc, variables, tenc, x, mask = _encoders()
    jcache, _ = _caches(jenc, variables, tenc, x, mask)
    jst, jkv8, jkvs = jenc.apply(variables, jcache, method=JC.TransformerEncoder.fused_decode_prep)
    tcache = [tuple((T(np.array(a)), T(np.array(s))) for a, s in layer) for layer in jcache]
    tst, tkv8, tkvs, buffers = tenc.fused_decode_prep(tcache)
    assert buffers is None  # CPU: no kernel scratch
    assert sorted(tst) == sorted(jst)
    for name in tst:
        want = np.asarray(jst[name])
        if name[0] == "w":
            want = want.transpose(0, 2, 1)
        assert tst[name].dtype == torch.float32
        np.testing.assert_array_equal(_np(tst[name]), want, err_msg=name)
    np.testing.assert_array_equal(_np(tkv8), np.asarray(jkv8))
    np.testing.assert_array_equal(_np(tkvs), np.asarray(jkvs))


def test_fused_decode_prep_keeps_stacks_until_the_weights_change():
    """The weight stacks are built once per set of weights: the same
    tensors on a second prep, new ones that hold the new weights after
    load_state_dict or an in-place update."""
    jenc, variables, tenc, x, mask = _encoders()
    _, tcache = _caches(jenc, variables, tenc, x, mask)
    first = tenc.fused_decode_prep(tcache)[0]
    assert all(a is b for a, b in zip(first.values(), tenc.fused_decode_prep(tcache)[0].values()))
    state = {k: v * 2.0 for k, v in tenc.state_dict().items()}
    tenc.load_state_dict(state)
    reloaded = tenc.fused_decode_prep(tcache)[0]
    torch.testing.assert_close(reloaded["wq"], first["wq"] * 2.0, rtol=0, atol=0)
    with torch.no_grad():
        tenc.layer[1].ffn_ln.bias.add_(1.0)
    updated = tenc.fused_decode_prep(tcache)[0]
    torch.testing.assert_close(updated["g2"][1], reloaded["g2"][1] + 1.0, rtol=0, atol=0)


def test_fused_rollout_with_commits_matches_jax(monkeypatch):
    """Three steps through fused_decode_step_apply on both sides, each
    committing its rows into the packed caches the next step reads."""
    monkeypatch.setattr(PDS, "_FORCE_INTERPRET", True)
    jenc, variables, tenc, x, mask = _encoders()
    jcache, tcache = _caches(jenc, variables, tenc, x, mask)
    jst, jkv8, jkvs = jenc.apply(variables, jcache, method=JC.TransformerEncoder.fused_decode_prep)
    tst, tkv8, tkvs, buffers = tenc.fused_decode_prep(tcache)
    np.testing.assert_array_equal(_np(tkv8), np.asarray(jkv8))
    jx, tx = jnp.asarray(x[:, :1] * 0.5), T(x[:, :1] * 0.5)
    for t in range(3):
        jy, jkv8, jkvs = jenc.apply(variables, jst, jx, jkv8, jkvs, jnp.int32(t),
                                    jnp.asarray(mask), WRITE_OFF,
                                    method=JC.TransformerEncoder.fused_decode_step_apply)
        with torch.no_grad():
            ty, tkv8, tkvs = tenc.fused_decode_step_apply(tst, tx, tkv8, tkvs, t, T(mask),
                                                          WRITE_OFF, buffers)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=2e-5, rtol=1e-5,
                                   err_msg=f"step {t}")
        np.testing.assert_array_equal(_np(tkv8), np.asarray(jkv8), err_msg=f"step {t}")
        np.testing.assert_allclose(_np(tkvs), np.asarray(jkvs), atol=1e-7, err_msg=f"step {t}")
        jx, tx = jy * 0.9, ty.clone() * 0.9


@pytest.mark.parametrize("fused,int8,device,b,cap", [
    (True, True, True, 1, 2), (True, True, True, 2, 2), (True, True, True, 3, 2),
    (False, True, True, 1, 2), (True, False, True, 1, 2), (True, True, False, 1, 2),
    (True, True, True, 4, 4), (True, True, True, 5, 4),
])
def test_fused_decode_gate_matches_jax(fused, int8, device, b, cap, monkeypatch):
    """The port's fused_decode_ok against the JAX gate (fused_decode_ok and
    the batch cap of _greedy_decode) in each condition; a CUDA tensor
    stands for the JAX kernel backend (Pallas on a TPU)."""
    from vitxtgqa_tpu.ops import attention as JA
    from vitxtgqa_tpu.ops.masks import MaskSpec as JMaskSpec

    kw = dict(hidden_size=D, num_hidden_layers=1, num_attention_heads=H, intermediate_size=M)
    variables = JC.TransformerEncoder(JC.TransformerConfig(**kw)).init(
        jax.random.key(0), jnp.zeros((b, 8, D)), JMaskSpec(key_mask=jnp.ones((b, 8))))
    monkeypatch.setattr(JA, "_on_tpu", lambda: device)
    JC.set_fused_decode(fused)
    JC.set_kv_cache_int8(int8)
    JC.set_fused_decode_max_batch(cap)
    jenc = JC.TransformerEncoder(JC.TransformerConfig(**kw, use_pallas=device))
    want = (jenc.apply(variables, method=JC.TransformerEncoder.fused_decode_ok)
            and b <= JC.fused_decode_max_batch())
    opts = cpu_options(kv_cache_int8=int8, fused_decode=fused, fused_decode_max_batch=cap)
    tenc = TC.TransformerEncoder(TC.TransformerConfig(hidden_size=D, num_hidden_layers=1,
                                                      num_attention_heads=H,
                                                      intermediate_size=M), opts)
    x = types.SimpleNamespace(is_cuda=device, shape=(b, 8, D))
    assert tenc.fused_decode_ok(x) == want


# ---------------------------------------------------------------------------
# the fused epilogue
# ---------------------------------------------------------------------------

V_FIX, V_P, N_OCR, QK, DEC = 70, 128, 48, D, 4


def _epilogue_case(kind, b=3, seed=3):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    y = r(b, 1, D, sc=0.3)
    cls_w = np.zeros((V_P, D), np.float32)
    cls_w[:V_FIX] = r(V_FIX, D, sc=0.05)
    cls_b = np.full((V_P,), -1e30, np.float32)
    cls_b[:V_FIX] = r(V_FIX, sc=0.01)
    ptr_w, ptr_b = r(QK, D, sc=0.05), r(QK, sc=0.01)
    keys = r(b, N_OCR, QK, sc=0.2)
    mask = (rng.uniform(size=(b, N_OCR)) > 0.4).astype(np.float32)
    ans = np.zeros((V_P, D), np.float32)
    ans[:V_FIX] = r(V_FIX, D, sc=0.3)
    ocr = r(b, N_OCR, D, sc=0.3)
    emb = r(2 * DEC, D, sc=0.1)
    if kind == "fixed":  # a fixed answer beats the +1 of the raw copy mask
        cls_b[17] = 5.0
    elif kind == "ocr":  # a copy slot wins every row
        keys[:, 5] = 20.0 * np.sign(y[:, 0] @ ptr_w.T + ptr_b)
    elif kind == "tie_fixed":  # two fixed answers tie at the top
        cls_w[[11, 40]] = 0.0
        cls_b[[11, 40]] = 50.0
    elif kind == "tie_ocr":  # two identical copy slots tie at the top
        keys[:, 9] = keys[:, 30] = 20.0 * np.sign(y[:, 0] @ ptr_w.T + ptr_b)
        mask[:, [9, 30]] = 1.0
    return y, cls_w, cls_b, ptr_w, ptr_b, keys, mask, ans, ocr, emb


@pytest.mark.parametrize("kind,step", [("fixed", 1), ("ocr", 1), ("tie_fixed", 0),
                                       ("tie_ocr", 2), ("fixed", DEC - 1)])
def test_fused_epilogue_plain_matches_pallas_interpret(kind, step):
    """scores within 1e-5, tokens exact (ties to the lowest index), the
    next embedding within 1e-5."""
    y, cls_w, cls_b, ptr_w, ptr_b, keys, mask, ans, ocr, emb = _epilogue_case(kind)
    scale = 1.0 / QK ** 0.5
    want = PDS.fused_epilogue(jnp.asarray(y), jnp.asarray(cls_w.T), jnp.asarray(cls_b),
                              jnp.asarray(ptr_w.T), jnp.asarray(ptr_b), jnp.asarray(keys),
                              jnp.asarray(mask), jnp.asarray(ans), jnp.asarray(ocr),
                              jnp.asarray(emb), jnp.int32(step), V_FIX, scale, DEC,
                              interpret=True)
    got = TDS.fused_epilogue_plain(T(y), T(cls_w), T(cls_b), T(ptr_w), T(ptr_b), T(keys),
                                   T(mask), T(ans), T(ocr), T(emb), step, V_FIX, scale, DEC)
    assert got[0].shape == (3, 1, V_P + N_OCR) and got[0].dtype == torch.float32
    assert got[1].dtype == torch.int32
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), atol=1e-5, rtol=1e-5)
    tok = _np(got[1])[:, 0, 0]
    expect = {"fixed": 17, "ocr": V_P + 5, "tie_fixed": 11, "tie_ocr": V_P + 9}[kind]
    assert (tok == expect).all(), tok


def test_bf16_cache_decode_wrapper_on_cpu_matches_decode_mha():
    """decode_mha sends a bf16/f32 cache with >= MIN_KV keys to the bf16
    decode wrapper, which runs its plain version on CPU tensors."""
    rng = np.random.default_rng(0)
    q = T((rng.standard_normal((2, 1, D))).astype(np.float32))
    k, v = (T(rng.standard_normal((2, LP, D)).astype(np.float32)) for _ in range(2))
    km = T(_cache()[3][:2])
    from vitxtgqa_tpu_torch.ops import decode_attention as TDA

    spec = DecodeStepSpec(key_mask=km, step=3, write_offset=WRITE_OFF)
    got = TA.decode_mha(q, k, v, spec, H)
    want = TDA.decode_attention_plain(q, k, v, km, 3, WRITE_OFF, H)
    assert torch.equal(got, want)
