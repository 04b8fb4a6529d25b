"""The PyTorch port's modules (vitxtgqa_tpu_torch/models) against their flax
counterparts on the same weights, on the CPU in float32.

Each flax module is initialised from a seed, its params are mapped onto the
port module with the port's own converter (utils/convert.py), and both run
the same numpy inputs.  Unless a test says otherwise the tolerance is
1e-5: both sides compute the same float32 expression, in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitxtgqa_tpu.models import common as JC
from vitxtgqa_tpu.ops.masks import DecodeStepSpec as JDecodeSpec
from vitxtgqa_tpu.ops.masks import MaskSpec as JMaskSpec
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.torch_convert import flatten
from vitxtgqa_tpu_torch.models import common as TC
from vitxtgqa_tpu_torch.ops import fused_block as TFB
from vitxtgqa_tpu_torch.ops.masks import DecodeStepSpec, MaskSpec
from vitxtgqa_tpu_torch.utils.convert import BERT_LAYER, bert_layer_entries, convert_entries

T = torch.from_numpy
ATOL = 1e-5


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _init(module, *args, rngs=None):
    """Jitted flax init (one compile instead of op-by-op dispatch)."""
    return jax.jit(module.init)(rngs or jax.random.key(1), *args)["params"]


def _apply(module, params, *args, **kw):
    """Jitted flax apply; keyword arguments are static."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kw))(params, *args)


def _load(module, params, entries):
    flat = flatten(jax.tree_util.tree_map(np.asarray, params))
    module.load_state_dict(convert_entries(flat, entries), strict=True)
    return module


def _cfgs(hidden=64, layers=2, heads=4, ffn=128):
    kw = dict(hidden_size=hidden, num_hidden_layers=layers, num_attention_heads=heads,
              intermediate_size=ffn)
    return JC.TransformerConfig(**kw), TC.TransformerConfig(**kw)


def _key_mask(b, l, lengths):
    return (np.arange(l)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)


def _encoder_pair(hidden=64, layers=2, heads=4, ffn=128, x=None, spec=None):
    jcfg, tcfg = _cfgs(hidden, layers, heads, ffn)
    jenc = JC.TransformerEncoder(jcfg)
    params = _init(jenc, jnp.asarray(x), spec)
    entries = [e for i in range(layers) for e in bert_layer_entries("", "", i)]
    tenc = _load(TC.TransformerEncoder(tcfg, cpu_options()), params, entries)
    return jenc, params, tenc


@pytest.mark.parametrize("kind", ["mask_spec", "prefix_lm", "additive_bias"])
def test_transformer_layer_matches_flax(kind):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 40, 64)
    km = _key_mask(2, 40, [29, 40])
    if kind == "mask_spec":
        jb, tb = JMaskSpec(key_mask=jnp.asarray(km)), MaskSpec(key_mask=T(km))
    elif kind == "prefix_lm":
        km[:, -8:] = 0.0
        jb, tb = JMaskSpec(key_mask=jnp.asarray(km), dec_len=8), MaskSpec(key_mask=T(km), dec_len=8)
    else:
        bias = ((1.0 - km) * -10000.0)[:, None, None, :]
        jb, tb = jnp.asarray(bias), T(bias)
    jcfg, tcfg = _cfgs()
    jl = JC.TransformerLayer(jcfg)
    params = _init(jl, jnp.asarray(x), jb)
    tl = _load(TC.TransformerLayer(tcfg, cpu_options()), params, BERT_LAYER)
    want_y, (want_k, want_v) = _apply(jl, params, jnp.asarray(x), jb, return_kv=True)
    got_y, (got_k, got_v) = tl(T(x), tb, return_kv=True)
    for g, w in ((got_y, want_y), (got_k, want_k), (got_v, want_v)):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL, rtol=ATOL)


def test_encoder_at_kernel_gates_matches_flax(monkeypatch):
    """Lane-aligned widths, 2048 rows and 1024 keys: the port routes through
    the flash and fused-block (+ tanh) plain versions, the flax encoder on
    CPU through plain XLA ops.  1e-4: three more reductions of 1024 terms."""
    calls = []
    for name in ("fused_block_plain", "fused_block_tanh_plain"):
        real = getattr(TFB, name)
        monkeypatch.setattr(TFB, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 1024, 128)
    km = _key_mask(2, 1024, [1000, 777])
    jenc, params, tenc = _encoder_pair(hidden=128, heads=4, ffn=256, x=x,
                                       spec=JMaskSpec(key_mask=jnp.asarray(km)))
    want = _apply(jenc, params, jnp.asarray(x), JMaskSpec(key_mask=jnp.asarray(km)),
                  tanh_residual_base=jnp.asarray(x))
    got = tenc(T(x), MaskSpec(key_mask=T(km)), tanh_residual_base=T(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert calls == ["fused_block_plain", "fused_block_tanh_plain"]


@pytest.mark.parametrize("int8", [False, True])
def test_encode_with_cache_and_decode_steps_match_flax(int8):
    """Encode a prefix, then two cached decode steps over the unified cache
    (int8 rows quantized on write).  Caches: int8 values within one step
    (a last-bit difference of the f32 projection can flip a rounding)."""
    rng = np.random.default_rng(2)
    l_enc, dec = 52, 12
    l = l_enc + dec
    x = _rand(rng, 2, l, 64)
    x[:, l_enc:] = 0.0
    km = np.pad(_key_mask(2, l_enc, [40, 52]), ((0, 0), (0, dec)))
    jspec = JMaskSpec(key_mask=jnp.asarray(km))
    jenc, params, tenc = _encoder_pair(x=x, spec=jspec)
    jh, jkv = _apply(jenc, params, jnp.asarray(x), jspec, method="encode_with_cache")
    th, tkv = tenc.encode_with_cache(T(x), MaskSpec(key_mask=T(km)))
    np.testing.assert_allclose(_np(th), np.asarray(jh), atol=ATOL, rtol=ATOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(_np(tk), np.asarray(jk), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=ATOL, rtol=ATOL)
    if int8:
        jkv = _apply(jenc, params, jkv, method="quantize_cache")
        tkv = tenc.quantize_cache(tkv)
    for step in range(2):
        x_t = _rand(rng, 2, 1, 64)
        jspec_t = JDecodeSpec(key_mask=jnp.asarray(km), step=jnp.int32(step), write_offset=l_enc)
        jy, jkv = _apply(jenc, params, jnp.asarray(x_t), None, jkv, jnp.int32(step), jspec_t,
                         deterministic=True, write_offset=l_enc, method="decode_step")
        ty, tkv = tenc.decode_step(T(x_t), tkv, step,
                                   DecodeStepSpec(key_mask=T(km), step=step, write_offset=l_enc),
                                   l_enc)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=ATOL, rtol=ATOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        for j, t in ((jk, tk), (jv, tv)):
            if int8:
                assert np.abs(_np(t[0]).astype(int) - np.asarray(j[0]).astype(int)).max() <= 1
                np.testing.assert_allclose(_np(t[1]), np.asarray(j[1]), rtol=1e-5)
            else:
                np.testing.assert_allclose(_np(t), np.asarray(j), atol=ATOL, rtol=ATOL)


def test_text_encoder_matches_flax():
    rng = np.random.default_rng(3)
    jcfg, tcfg = _cfgs(layers=1)
    jcfg = JC.TransformerConfig(**{**jcfg.__dict__, "vocab_size": 100, "max_position_embeddings": 32})
    tcfg = TC.TransformerConfig(**{**tcfg.__dict__, "vocab_size": 100, "max_position_embeddings": 32})
    ids = rng.integers(1, 100, (2, 12)).astype(np.int64)
    mask = _key_mask(2, 12, [10, 7])
    jm = JC.TextEncoder(jcfg)
    params = _init(jm, jnp.asarray(ids), jnp.asarray(mask))
    entries = [
        ("embeddings.word_embeddings", "embeddings/word_embeddings", "embed"),
        ("embeddings.position_embeddings", "embeddings/position_embeddings", "embed"),
        ("embeddings.token_type_embeddings", "embeddings/token_type_embeddings", "embed"),
        ("embeddings.LayerNorm", "embeddings/ln", "ln"),
        *bert_layer_entries("encoder", "encoder", 0),
    ]
    tm = _load(TC.TextEncoder(tcfg, cpu_options()), params, entries)
    want = _apply(jm, params, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(_np(tm(T(ids), T(mask))), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_prev_pred_embeddings_match_flax():
    rng = np.random.default_rng(4)
    jcfg, tcfg = _cfgs()
    ans, ocr = _rand(rng, 17, 64), _rand(rng, 2, 24, 64)
    prev = np.array([[2, 20, 5, 40], [16, 17, 3, 2]], np.int64)  # fixed and copy ids
    jm = JC.PrevPredEmbeddings(jcfg)
    params = _init(jm, jnp.asarray(ans), jnp.asarray(ocr), jnp.asarray(prev))
    entries = [
        ("position_embeddings", "position_embeddings", "embed"),
        ("token_type_embeddings", "token_type_embeddings", "embed"),
        ("ans_layer_norm", "ans_ln", "ln"), ("ocr_layer_norm", "ocr_ln", "ln"),
        ("emb_layer_norm", "emb_ln", "ln"),
    ]
    tm = _load(TC.PrevPredEmbeddings(tcfg), params, entries)
    ja, jo = _apply(jm, params, jnp.asarray(ans), jnp.asarray(ocr), method="tables")
    ta, to = tm.tables(T(ans), T(ocr))
    np.testing.assert_allclose(_np(ta), np.asarray(ja), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=ATOL, rtol=ATOL)
    for offset in (0, 3):
        want = _apply(jm, params, ja, jo, jnp.asarray(prev[:, :1]), deterministic=True,
                      position_offset=offset, method="embed")
        got = tm.embed(ta, to, T(prev[:, :1]), position_offset=offset)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=ATOL)
    want = _apply(jm, params, jnp.asarray(ans), jnp.asarray(ocr), jnp.asarray(prev))
    np.testing.assert_allclose(_np(tm.embed(ta, to, T(prev))), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_ocr_ptr_net_and_classifier_match_flax():
    """The pointer net keeps the raw 0/1 mask add (valid slots get +1)."""
    rng = np.random.default_rng(5)
    q, k = _rand(rng, 2, 3, 64), _rand(rng, 2, 24, 64)
    mask = (rng.random((2, 24)) > 0.4).astype(np.float32)
    jp = JC.OcrPtrNet(hidden_size=64, query_key_size=64)
    params = _init(jp, jnp.asarray(q), jnp.asarray(k), jnp.asarray(mask))
    tp = _load(TC.OcrPtrNet(64, 64), params,
               [("query", "query", "linear"), ("key", "key", "linear")])
    want = _apply(jp, params, jnp.asarray(q), jnp.asarray(k), jnp.asarray(mask))
    np.testing.assert_allclose(_np(tp(T(q), T(k), T(mask))), np.asarray(want), atol=ATOL, rtol=ATOL)

    jcl = JC.FixedVocabClassifier(out_dim=17, in_dim=64)
    cparams = _init(jcl, jnp.asarray(q))
    tcl = _load(TC.FixedVocabClassifier(17, 64), cparams, [("module", "", "classifier")])
    want = _apply(jcl, cparams, jnp.asarray(q))
    np.testing.assert_allclose(_np(tcl(T(q))), np.asarray(want), atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(_np(tcl.table()), np.asarray(cparams["weight"]))


def test_grounding_module_matches_flax_under_shared_noise(monkeypatch):
    """Both sides see the same shape-keyed numpy gumbel noise: the JAX draw
    is patched in this test only (after test_t2s_full_model_parity), the
    port takes the noise as an argument.  Index outputs exact."""
    import vitxtgqa_tpu.models.grounding as G

    b, f, k = 3, 8, 3
    n = f * k
    rng = np.random.default_rng(6)
    noise = {(b, 2, f): rng.gumbel(size=(b, 2, f)).astype(np.float32),
             (b, 2, n): rng.gumbel(size=(b, 2, n)).astype(np.float32)}

    def jax_gumbel(r, logits, tau=1.0, axis=-1, hard=True):
        y = jax.nn.softmax((logits + jnp.asarray(noise[tuple(logits.shape)])) / tau, axis=axis)
        yh = jnp.put_along_axis(jnp.zeros_like(y), jnp.argmax(y, axis=axis, keepdims=True), 1.0,
                                axis=axis, inplace=False)
        return yh + y - jax.lax.stop_gradient(y)

    monkeypatch.setattr(G, "gumbel_softmax", jax_gumbel)
    frame_num = np.array([8, 6, 5])
    frame_id = np.zeros((b, f), np.int32)
    frame_mask = np.zeros((b, f), np.float32)
    temporal = np.zeros((b, n), np.int32)
    for i in range(b):
        frame_id[i, :frame_num[i]] = np.arange(1, frame_num[i] + 1)
        frame_mask[i, :frame_num[i]] = 1
        temporal[i] = np.repeat(frame_id[i], k)
    args = (
        _rand(rng, b, 10, 64), _key_mask(b, 10, [8, 10, 6]), _rand(rng, b, f, 64), frame_mask,
        frame_id, _rand(rng, b, n, 64), (rng.random((b, n)) > 0.3).astype(np.float32),
        rng.random((b, n, 4)).astype(np.float32), temporal,
    )
    jg = G.GroundingModule(hidden_size=64, frame_topk=2, ocr_topk=2, frame_num=f, ocr_frame_num=k)
    params = _init(jg, *map(jnp.asarray, args),
                   rngs={"params": jax.random.key(0), "gumbel": jax.random.key(1)})
    from vitxtgqa_tpu_torch.models.grounding import GroundingModule

    tg = _load(GroundingModule(64, 64, 2, 2, f, k), params,
               [("q_linear", "q_linear", "linear"), ("self_attn", "self_attn", "linear")])
    want = _apply(jg, params, *map(jnp.asarray, args), rngs={"gumbel": jax.random.key(2)})
    got = tg(*map(T, args), gumbel=(T(noise[(b, 2, f)]), T(noise[(b, 2, n)])))
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        if key.endswith("_idx") or key == "ground_frame" or key.endswith("_mask"):
            np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]), err_msg=key)
        else:
            np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), atol=ATOL, err_msg=key)
