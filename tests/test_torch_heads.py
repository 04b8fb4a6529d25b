"""The port's attention kernels at every head width the Pallas kernels take:
the wrappers' gates against the kernels' tiers, the plain twins against
JAX's references or its Pallas kernels in interpret mode at head widths 32,
72, 80 and 128 (the merged flash forward and backward, the split-head form
at a row offset, the bias-tensor attention, the decode attention over the
int8 and the bf16 cache, the decode step over 2,048 slots), T2S at
MiniLM-L12-H384's 12 heads of 32 (models/t2s.t2s_minilm_config, two
layers a stack) against the JAX T2S, and a ViT at ViT-H/14's 16 heads of
80 with patch 14 (two layers) against the JAX ViT.

CPU, float32.  The wrappers take their plain versions on CPU tensors, so
what holds here is the Python side of each kernel (what it admits, its
launch plan, its twin); the kernels themselves are held to these twins on
the card by chip_smoke.py's slice v.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import _assert_grads_close, _patch_jax_gumbel
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import synthetic_batch
from vitxtgqa_tpu.utils.torch_convert import convert_t2s_like, flatten, unflatten
from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.models.t2s import MINILM_L12_H384, T2S, t2s_minilm_config
from vitxtgqa_tpu_torch.ops import attention as TA
from vitxtgqa_tpu_torch.ops import decode_attention as DA
from vitxtgqa_tpu_torch.ops import decode_step as DS
from vitxtgqa_tpu_torch.ops import flash_attention as FA
from vitxtgqa_tpu_torch.ops import fused_attention as FAT
from vitxtgqa_tpu_torch.ops.masks import self_attention_bias
from vitxtgqa_tpu_torch.utils.convert import from_jax_params

T = torch.from_numpy
HEAD_WIDTHS = (32, 72, 80, 128)
TOL = dict(atol=2e-5, rtol=2e-5)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _raises(fn, *a) -> bool:
    try:
        fn(*a)
    except NotImplementedError as e:
        assert "head widths above 128" in str(e) or "queue 2" in str(e), str(e)
        return True
    return False


# ---------------------------------------------------------------------------
# the gates against the kernels' tiers
# ---------------------------------------------------------------------------


def test_the_gates_admit_exactly_the_kernels_tiers():
    """Every head width a multiple of 8 up to 128 is admitted by each
    attention wrapper's gate (the merged and split flash forms, the
    bias-tensor attention, the decode attention, the decode step), any
    other raises NotImplementedError naming ROADMAP queue 2's head-width
    item; the tiers: one 64-column atom up to 64, two above."""
    for d in range(1, 261):
        ok = d % 8 == 0 and d <= 128
        assert FA.head_width_ok(d) == ok, d
        q = torch.zeros(1, 4, 2 * d)
        assert _raises(FA._check_geometry, q, 2, 0, "flash_attention_merged") == (not ok), d
        qs, ks = torch.zeros(1, 2, 4, d), torch.zeros(1, 2, 4, d)
        assert _raises(FA._split_geometry, qs, ks, 0, 0, "flash_attention") == (not ok), d
        assert _raises(DA.check_head_dim, "decode_attention", 4 * d, 4) == (not ok), d
        if ok:
            assert FA.head_atoms(d) == (1 if d <= 64 else 2)
        else:  # the bias-tensor attention raises before it reads an operand
            with pytest.raises(NotImplementedError, match="head widths above 128"):
                FAT._launch(qs, ks, ks, None)


@pytest.mark.parametrize("h, d", [(12, 32), (16, 72), (16, 80), (8, 128), (12, 64), (8, 136)])
def test_the_decode_step_admits_every_head_width_and_caches_to_4096(h, d):
    """#5 takes H heads of any admitted width making a hidden width the
    step takes, caches up to 4,096 slots; past 128 or past 4,096 slots it
    raises naming queue 2."""
    hidden = h * d
    width_ok = DS.step_widths_ok(hidden, 4 * hidden)
    want_ok = FA.head_width_ok(d) and width_ok
    assert _raises(DS.check_step_shape, hidden, 4 * hidden, h, hidden, 1, 4096) == (not want_ok)
    if want_ok:
        assert _raises(DS.check_step_shape, hidden, 4 * hidden, h, hidden, 1, 4097)
        buf = DS.step_buffers(3, 2, hidden, 4 * hidden, "meta", h)
        assert buf["apart"].shape == (2 * h * DS.MAX_SPANS, d)
        assert buf["opart"].shape == (h, 2, hidden)


@pytest.mark.parametrize("h, d", [(12, 32), (16, 72), (16, 80), (8, 128), (12, 64)])
@pytest.mark.parametrize("elem", [1, 2])
def test_the_decode_launch_plans_take_every_head_width(h, d, elem):
    """The decode attention's launch plan at batch 1 and 8 over 1,152 keys:
    a head holds CPH chunks of the thread (16-byte chunks at 64, else 8
    elements: 4 a head up to 32, 8 up to 64, 16 up to 128), a block's
    heads x CPH divide its threads, the shared memory fits."""
    per, cph = DA.chunking(d, elem)
    assert per * cph >= d and d % per == 0 and cph & (cph - 1) == 0
    if d == 64:
        assert per * elem == 16
    for b in (1, 8):
        plan = DA.launch_plan(b, 1152, h, elem, d)
        assert h % plan.head_groups == 0 and plan.heads_per_group * plan.head_groups == h
        assert DA.THREADS % (plan.heads_per_group * cph) == 0
        assert plan.smem <= DA.SMEM_LIMIT and plan.cluster <= DA.MAX_CLUSTER


def test_the_backward_scratch_takes_a_column_atom_more_above_64():
    """The flash backward's dq sums: 64 columns a query row up to head width
    64, 128 above (csrc/flash_bwd.cuh bwd_params)."""
    for d, cols in ((32, 64), (64, 64), (72, 128), (128, 128)):
        scratch = FA._bwd_scratch(2, 3, 100, 1152, False, "cpu", d)
        assert scratch.numel() == 2 * 3 * 128 * (cols + 2)


# ---------------------------------------------------------------------------
# the twins against JAX at each head width
# ---------------------------------------------------------------------------


def _merged(d, b=2, h=2, l_enc=52, dec=12, seed=5):
    rng = np.random.default_rng(seed + d)
    l = l_enc + dec
    q, k, v, g = (rng.standard_normal((b, l, h * d)).astype(np.float32) for _ in range(4))
    enc = (np.arange(l_enc)[None, :] < np.asarray([[l_enc - 12], [l_enc]])[:b]).astype(np.float32)
    return q, k, v, g, np.pad(enc, ((0, 0), (0, dec))), h, dec


@pytest.mark.parametrize("d", HEAD_WIDTHS)
def test_the_merged_flash_twins_match_pallas(d):
    """#1's twin (with the lse) and #1b's against jax.vjp through the
    Pallas merged forward and backward in interpret mode: 2e-5."""
    from vitxtgqa_tpu.ops.pallas_attention import flash_attention_merged

    q, k, v, g, km, h, dec = _merged(d)
    f = lambda q_, k_, v_: flash_attention_merged(q_, k_, v_, jnp.asarray(km), dec,
                                                  num_heads=h, interpret=True)
    want_out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    out, lse = FA.flash_attention_merged(T(q), T(k), T(v), T(km), dec, h, return_lse=True)
    np.testing.assert_allclose(_np(out), np.asarray(want_out), **TOL)
    got = FA.flash_attention_merged_bwd(T(q), T(k), T(v), T(km), out, lse, T(g), dec, h)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(a), np.asarray(w), err_msg="d" + name, **TOL)


@pytest.mark.parametrize("d", HEAD_WIDTHS)
def test_the_split_flash_twins_match_pallas_at_a_row_offset(d):
    """#10's twin on the query rows from 32 and #10b's dq against jax.vjp
    of the Pallas split-head kernel at that row offset: 2e-5."""
    from vitxtgqa_tpu.ops.pallas_attention import flash_attention

    q, k, v, g, km, h, dec = _merged(d, seed=9)
    split = lambda x: np.ascontiguousarray(x.reshape(2, -1, h, d).transpose(0, 2, 1, 3))
    q, k, v, g = (split(x) for x in (q, k, v, g))
    off = 32
    qs, gs = q[:, :, off:], g[:, :, off:]
    want, vjp = jax.vjp(lambda a, b_, c: flash_attention(a, b_, c, jnp.asarray(km), dec_len=dec,
                                                         interpret=True,
                                                         row_offset=jnp.int32(off)),
                        jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v))
    wq, _, _ = vjp(jnp.asarray(gs))
    out, lse = FA.flash_attention(T(qs), T(k), T(v), T(km), dec, off, return_lse=True)
    np.testing.assert_allclose(_np(out), np.asarray(want), **TOL)
    dq, _, _ = FA.flash_attention_bwd(T(qs), T(k), T(v), T(km), out, lse, T(gs), dec, off)
    np.testing.assert_allclose(_np(dq), np.asarray(wq), **TOL)


@pytest.mark.parametrize("d", HEAD_WIDTHS)
@pytest.mark.parametrize("form", ["key_mask", "per_row"])
def test_the_bias_attention_twin_matches_pallas(d, form):
    """#14's twin against the Pallas kernel in interpret mode (which pads
    the head width to 128 lanes) with a key-mask bias and a per-row bias
    over 70 keys: 2e-5."""
    from vitxtgqa_tpu.ops.pallas_attention import fused_attention

    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((2, 2, 70, d)).astype(np.float32) for _ in range(3))
    if form == "key_mask":
        mask = (np.arange(70)[None, :] < np.asarray([[55], [70]])).astype(np.float32)
        bias = np.asarray(self_attention_bias(T(mask)))
    else:
        bias = np.where(rng.random((2, 1, 70, 70)) < 0.3, -10000.0, 0.0).astype(np.float32)
    want = fused_attention(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(bias),
                           interpret=True)
    got = FAT.fused_attention(T(q), T(k), T(v), T(bias))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", HEAD_WIDTHS)
def test_the_decode_twins_match_pallas(d):
    """#4's twin over the int8 cache and #7's over the bf16 (here f32)
    cache against the Pallas kernels in interpret mode, 4 heads over 108
    keys at step 5: 2e-5."""
    from vitxtgqa_tpu.ops.attention import quantize_kv
    from vitxtgqa_tpu.ops.pallas_attention import decode_attention, decode_attention_int8

    rng = np.random.default_rng(d + 1)
    h, l, wo, step = 4, 108, 96, 5
    q = rng.standard_normal((2, 1, h * d)).astype(np.float32)
    k, v = (rng.standard_normal((2, l, h * d)).astype(np.float32) for _ in range(2))
    km = np.zeros((2, l), np.float32)
    km[0, :80], km[1, :96] = 1.0, 1.0
    (k8, ks), (v8, vs) = quantize_kv(jnp.asarray(k)), quantize_kv(jnp.asarray(v))
    want = decode_attention_int8(jnp.asarray(q), k8, ks, v8, vs, jnp.asarray(km), jnp.int32(step),
                                 write_offset=wo, num_heads=h, interpret=True)
    got = DA.decode_attention_int8(T(q), *TA.quantize_kv(T(k)), *TA.quantize_kv(T(v)), T(km),
                                   step, wo, h)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    want = decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km),
                            jnp.int32(step), write_offset=wo, num_heads=h, interpret=True)
    got = DA.decode_attention(T(q), T(k), T(v), T(km), step, wo, h)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("h, d", [(8, 32), (2, 128)])
def test_the_decode_step_twin_matches_jax_over_2048_slots(h, d):
    """#5's twin against fused_step_reference at hidden 256 (8 heads of 32,
    2 of 128), 2 layers, batch 2, over a cache of 2,048 slots (past the old
    1,152): y within 2e-5, the quantized rows exact, their scales within
    1e-7."""
    from vitxtgqa_tpu.ops.pallas_decode_step import fused_step_reference

    hidden, m, lp, layers, b = h * d, 512, 2048, 2, 2
    rng = np.random.default_rng(h)
    mk = lambda *s: (rng.standard_normal(s) * 0.03).astype(np.float32)
    shapes = {"wq": (hidden, hidden), "wk": (hidden, hidden), "wv": (hidden, hidden),
              "wo": (hidden, hidden), "w1": (hidden, m), "w2": (m, hidden)}
    jst, tst = {}, {}
    for name in DS.STACK_NAMES:
        if name[0] == "w":
            w = mk(layers, *shapes[name])
            jst[name], tst[name] = w, np.ascontiguousarray(w.transpose(0, 2, 1))
        else:
            vec = mk(layers, 1, m if name == "b1" else hidden) + (1.0 if name[0] == "s" else 0.0)
            jst[name] = tst[name] = vec
    kv8 = np.clip(np.rint(rng.standard_normal((layers, b, lp, 2 * hidden)) * 40), -127,
                  127).astype(np.int8)
    kvs = (0.01 + rng.random((layers, b, 2, lp)) * 0.02).astype(np.float32)
    mask = (rng.random((b, lp)) > 0.5).astype(np.float32)
    mask[:, 2000:] = 0.0
    x = rng.standard_normal((b, 1, hidden)).astype(np.float32)
    step, off = 3, 2000
    want = jax.jit(fused_step_reference, static_argnums=(5, 6, 7))(
        jnp.asarray(x), {k_: jnp.asarray(v_) for k_, v_ in jst.items()}, jnp.asarray(kv8),
        jnp.asarray(kvs), jnp.asarray(mask), step, off, h)
    got = DS.fused_decode_step(T(x), {k_: T(v_) for k_, v_ in tst.items()}, T(kv8), T(kvs),
                               T(mask), step, off, h)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), atol=1e-7)


# ---------------------------------------------------------------------------
# T2S at MiniLM's widths (12 heads of 32) against the JAX T2S
# ---------------------------------------------------------------------------

FRAMES, OCR_PF, BATCH, DEC = 4, 3, 2, 4
N_OCR = FRAMES * OCR_PF
NF = 5050 + N_OCR
LOSSES = [{"type": "pos_bce_loss", "weight": 1.0}, {"type": "InfoNCE", "weight": 1000}]


def _minilm_t2s_config():
    """t2s_minilm_config at two layers a stack, 4 frames of 3 OCR tokens
    (top 2 of each), every dropout 0: MiniLM's widths in every stack, the
    production feature widths."""
    from vitxtgqa_tpu.core.config import ConfigNode

    cfg = t2s_minilm_config()
    for stack in ("text_bert", "translayers", "encoder", "mmt"):
        cfg[stack] = {**cfg[stack], "num_hidden_layers": 2, "hidden_dropout_prob": 0.0,
                      "attention_probs_dropout_prob": 0.0}
    cfg["obj"] = {**cfg["obj"], "dropout_prob": 0.0}
    cfg["ocr"] = {**cfg["ocr"], "dropout_prob": 0.0}
    cfg["grounding"] = {**cfg["grounding"], "frame_num": FRAMES, "ocr_frame_num": OCR_PF,
                        "max_ocr_num": N_OCR, "frame_topk": 2, "ocr_topk": 2}
    cfg["classifier"] = {**cfg["classifier"], "ocr_max_num": N_OCR}
    return ConfigNode(cfg)


@pytest.fixture(scope="module")
def minilm():
    """(config, batch, gumbel noise, the port's T2S from seed 0, its weights
    in the JAX tree)."""
    cfg = _minilm_t2s_config()
    assert cfg["mmt"]["hidden_size"] // cfg["mmt"]["num_attention_heads"] == 32
    batch = synthetic_batch(batch=BATCH, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=DEC,
                            text_len=10, num_final_outputs=NF, seed=0)
    # every frame and OCR slot valid: the negative grounding's bottom-k then
    # ranks noisy scores only (tests/test_torch_widths.py)
    batch["frame_id"] = np.tile(np.arange(1, FRAMES + 1, dtype=np.int32), (BATCH, 1))
    batch["frame_mask"] = np.ones((BATCH, FRAMES), np.float32)
    batch["frame_num"] = np.full((BATCH,), FRAMES, np.int64)
    batch["temporal_id"] = np.tile(np.repeat(batch["frame_id"][0], OCR_PF), (BATCH, 1))
    batch["ocr_mask"] = np.ones((BATCH, N_OCR), np.float32)
    rng = np.random.default_rng(5)
    noise = {s: rng.gumbel(size=s).astype(np.float32)
             for s in ((BATCH, 2, FRAMES), (BATCH, 2, N_OCR))}
    model = T2S(cfg, NF, bos_idx=2, opts=cpu_options()).init_weights(0)
    state = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    params = unflatten(convert_t2s_like(state, text_layers=2, qtv_layers=2, mmt_layers=2))
    return cfg, batch, noise, model, params


def _tensors(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _noise(noise):
    return T(noise[(BATCH, 2, FRAMES)]), T(noise[(BATCH, 2, N_OCR)])


def test_t2s_minilm_config_is_minilm_at_the_production_depths():
    """Every stack at MiniLM-L12-H384's published widths, the production
    depths (3 / 2 / 3) and sequence; the grounding and pointer at 384."""
    from vitxtgqa_tpu_torch.models.common import TransformerConfig

    cfg = t2s_minilm_config()
    for stack, layers in (("text_bert", 3), ("translayers", 2), ("mmt", 3)):
        tc = TransformerConfig.from_config(cfg[stack])
        assert (tc.hidden_size, tc.num_attention_heads, tc.intermediate_size,
                tc.num_hidden_layers, tc.layer_norm_eps) == (384, 12, 1536, layers, 1e-12)
    assert MINILM_L12_H384["hidden_size"] // MINILM_L12_H384["num_attention_heads"] == 32
    ptr = cfg["classifier"]["ocr_ptr_net"]
    assert cfg["grounding"]["hidden_size"] == ptr["hidden_size"] == ptr["query_key_size"] == 384


def test_t2s_at_minilm_widths_serves_as_the_jax_t2s(minilm, monkeypatch):
    """The serving forward (inference_only) at 12 heads of 32: pos_scores
    within 2e-5, greedy tokens and grounding exact."""
    from vitxtgqa_tpu.models.t2s import T2S as JT2S

    cfg, batch, noise, model, params = minilm
    _patch_jax_gumbel(monkeypatch, noise)
    jm = JT2S(config=cfg, num_final_outputs=NF, bos_idx=2)
    want = jax.jit(lambda p, bt: jm.apply({"params": p}, bt, train=False,
                                          rngs={"gumbel": jax.random.key(0)}))(params, batch)
    with torch.no_grad():
        got = model(_tensors(batch), _noise(noise))
    g, w = got["pos_scores"].numpy(), np.asarray(want["pos_scores"])
    assert g.shape == w.shape == (BATCH, DEC, NF)
    np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    for k in ("ground_frame", "ground_box"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_t2s_at_minilm_widths_trains_as_the_jax_t2s(minilm, monkeypatch):
    """One training forward and backward at 12 heads of 32: the total loss
    within 1e-5 relative, every parameter's gradient within 1e-4 of its
    largest entry plus 1e-3 relative (tests/test_torch_widths.py's
    measure), the stacks' key biases aside (zero but for rounding)."""
    from vitxtgqa_tpu.losses import Losses as JLosses
    from vitxtgqa_tpu.models.t2s import T2S as JT2S

    cfg, batch, noise, model, params = minilm
    _patch_jax_gumbel(monkeypatch, noise)
    jm = JT2S(config=cfg, num_final_outputs=NF, bos_idx=2, train_variant_scan=True)

    def loss_fn(p):
        out = jm.apply({"params": p}, batch, train=True,
                       rngs={"dropout": jax.random.key(1), "gumbel": jax.random.key(2)})
        return JLosses(LOSSES).total(batch, out)[0]

    want_total, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model.zero_grad(set_to_none=True)
    out = model(_tensors(batch), _noise(noise), train=True)
    total = Losses(LOSSES).total(_tensors(batch), out)[0]
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-5)
    want = {k: v.numpy() for k, v in
            from_jax_params(flatten(jax.tree_util.tree_map(np.asarray, want_grads))).items()}
    got = {k: np.zeros_like(want[k]) if p.grad is None else p.grad.numpy()
           for k, p in model.named_parameters()}
    keys = [k for k in want if k.endswith("attention.self.key.bias")]
    assert keys and all(np.abs(want[k]).max() < 1e-5 for k in keys)
    _assert_grads_close({k: v for k, v in got.items() if k not in keys},
                        {k: v for k, v in want.items() if k not in keys}, 1e-4, 1e-3)


# ---------------------------------------------------------------------------
# a ViT at ViT-H/14's heads against the JAX ViT
# ---------------------------------------------------------------------------


def test_vit_h14_preset_is_its_published_config():
    """VIT_H_14 is google/vit-huge-patch14-224-in21k's geometry (257
    tokens at 224 px: the bias-tensor attention's route), by name in
    VIT_CONFIGS."""
    from vitxtgqa_tpu_torch.models.vit import VIT_CONFIGS, VIT_H_14

    assert dataclasses.asdict(VIT_H_14) == dict(image_size=224, patch_size=14, hidden_size=1280,
                                                num_layers=32, num_heads=16, mlp_dim=5120,
                                                ln_eps=1e-12)
    assert VIT_H_14.num_patches + 1 == 257 >= TA.MIN_KV
    assert VIT_CONFIGS["vit_h_14"] is VIT_H_14


def test_a_vit_at_16_heads_of_80_matches_jax(monkeypatch):
    """Two layers of ViT-H/14 (patch 14, 1,280 wide, 16 heads of 80, MLP
    5,120) on one 224-px frame: 257 tokens take the bias-tensor attention
    (#14) in both layers; CLS and tokens within 2e-5 of the JAX ViT from
    the same weights."""
    from tests.test_torch_vit import _images, _jax_params, _port_vit, _unflat
    from vitxtgqa_tpu.models import vit as JV
    from vitxtgqa_tpu_torch.models.vit import VIT_H_14

    geo = {**dataclasses.asdict(VIT_H_14), "num_layers": 2}
    jcfg = JV.ViTConfig(**geo)
    tcfg = dataclasses.replace(VIT_H_14, num_layers=2)
    flat = _jax_params(jcfg)
    images = _images(1, 224)
    want_cls, want_tok = JV.ViT(jcfg).apply({"params": _unflat(flat)}, jnp.asarray(images))
    calls = []
    plain = FAT.fused_attention_plain
    monkeypatch.setattr(FAT, "fused_attention_plain",
                        lambda *a, **kw: calls.append(a[0].shape) or plain(*a, **kw))
    with torch.inference_mode():
        cls, tok = _port_vit(tcfg, flat)(T(images))
    assert calls == [(1, 16, 257, 80)] * 2
    np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), **TOL)
    np.testing.assert_allclose(tok.numpy(), np.asarray(want_tok), **TOL)
