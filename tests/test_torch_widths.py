"""The port's kernels at every hidden and FFN width the Pallas kernels take:
the wrappers' width checks against JAX's gates, the launch plans at wide
rows, the plain twins against JAX's references at bert-large-uncased's
widths and at 512 / 2,048, the training block's dropout masks at 1,024,
and T2S at bert-large's widths (models/t2s.t2s_bert_large_config) against
the JAX T2S.

CPU, float32.  The wrappers take their plain versions on CPU tensors, so
what holds here is the Python side of each kernel (what it admits, what it
launches, its twin); the kernels themselves are held to these twins on the
card by chip_smoke.py's slice u.  JAX's references run as its own tests run
them (pure jnp, or the Pallas kernel in interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_gemm_plans import assert_covers_once
from tests.test_torch_train import _assert_grads_close, _patch_jax_gumbel
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.ops import pallas_block_bwd as PBB
from vitxtgqa_tpu.ops import pallas_ffn as PF
from vitxtgqa_tpu.utils.synthetic import synthetic_batch
from vitxtgqa_tpu.utils.torch_convert import convert_t2s_like, flatten, unflatten
from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.models.t2s import BERT_LARGE, T2S, t2s_bert_large_config
from vitxtgqa_tpu_torch.ops import block_train as BT
from vitxtgqa_tpu_torch.ops import decode_step as DS
from vitxtgqa_tpu_torch.ops import dropout as D
from vitxtgqa_tpu_torch.ops import fused_block as FB
from vitxtgqa_tpu_torch.ops import ptr_scores as PS
from vitxtgqa_tpu_torch.ops.attention import quantize_kv
from vitxtgqa_tpu_torch.utils.convert import from_jax_params

T = torch.from_numpy
# the widths the kernels take: hidden up to csrc/row_ops.cuh's 2,048, FFN
# up to the decode step's 8,192 (the block kernels' GEMMs take any FFN
# width a multiple of 128)
MAX_D, MAX_M = 2048, 8192
# (hidden, FFN) of the twins' checks: bert-large's, and a narrower pair
TWIN_WIDTHS = ((1024, 4096), (512, 2048))
TOL = dict(atol=2e-5, rtol=2e-5)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _raises(fn, *a) -> bool:
    try:
        fn(*a)
    except NotImplementedError:
        return True
    return False


def test_the_wrappers_admit_what_the_jax_gates_route_to_a_kernel():
    """For every hidden width d a multiple of 64 up to 2,048 and FFN width m
    a multiple of 64 up to 8,192: the eval block (#2 / #3), the W8A8 block
    (#8, the same check) and the training block (#9a / #9b) admit (d, m)
    exactly where JAX's ffn_kernel_ok / block_bwd_kernel_ok route it to a
    kernel, and so does the decode step (#5: JAX's fused-decode gate
    reads no width; the step takes every lane-aligned pair, heads of 64);
    the port's own gates are JAX's."""
    for d in range(64, MAX_D + 1, 64):
        for m in range(64, MAX_M + 1, 64):
            jax_eval, jax_train = PF.ffn_kernel_ok(d, m, 2048), PBB.block_bwd_kernel_ok(d, m)
            assert FB.kernel_ok(d, m, 2048) == jax_eval and BT.kernel_ok(d, m) == jax_train
            assert _raises(FB.check_widths, "fused_block", d, m) == (not jax_eval), (d, m)
            assert _raises(BT.check_widths, "block_train", d, m) == (not jax_train), (d, m)
            assert DS.step_widths_ok(d, m) == jax_eval, (d, m)
            assert _raises(DS.check_step_shape, d, m, d // 64, d, 1, DS.MAX_CACHE) == (
                not jax_eval), (d, m)


@pytest.mark.parametrize("d", [2048 + 128, 4096])
def test_beyond_the_caps_the_wrappers_raise_naming_the_roadmap_item(d):
    """Past the row passes' 2,048 columns each block wrapper, and past
    8,192 FFN columns the decode step, raises NotImplementedError naming
    ROADMAP queue 2."""
    for fn, a in ((FB.check_widths, ("fused_block", d, 4096)),
                  (BT.check_widths, ("block_train", d, 4096)),
                  (FB.check_tp_widths, ("fused_block_tp", d, d // 2, 2048)),
                  (DS.check_step_shape, (d, 4096, d // 64, d, 1, 1152)),
                  (DS.check_step_shape, (1024, MAX_M + 128, 16, 1024, 1, 1152))):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
            fn(*a)


def test_the_pointer_scores_take_every_width_up_to_2048():
    """#12: every multiple of 16 up to 2,048 (beyond JAX's lane-aligned
    widths, which its Pallas kernel takes), nothing else."""
    for d in range(8, 4097, 8):
        assert PS.width_ok(d) == (d % 16 == 0 and d <= 2048), d


@pytest.mark.parametrize("d", [512, 1024, 1280, 2048])
def test_every_launch_plan_covers_its_outputs_once_at_wide_rows(d):
    """At hidden d with FFN 4d (and the split forms at model 2 and 4):
    each GEMM launch of #2 / #3, #8, #9a / #9b and the split forms covers
    its output once; the backward's column-sum scratch holds every row
    pass block's three d-wide partials and every tile's db1."""
    m, rows = 4 * d, 2304
    plans = (FB.launch_plan(rows, d, m) + FB.w8a8_launch_plan(rows, d, m)
             + BT.gemm_launches(rows, d, m))
    for n in (2, 4):
        plans += FB.tp_launch_plan(rows, d, d // n, m // n) + BT.tp_gemm_launches(
            rows, d, d // n, m // n)
    for ln in plans:
        assert_covers_once(ln)
    plan = BT.launch_plan(rows, d, m)
    assert plan.col_floats == 2 * plan.row_blocks * 3 * d + plan.m_tiles * m


def _block_case(seed, rows, d, m):
    """numpy operands in the JAX layout (weights [in, out])."""
    rng = np.random.default_rng(seed)
    mk = lambda *s, scale=0.05: (rng.standard_normal(s) * scale).astype(np.float32)
    return [mk(rows, d, scale=1.0), mk(rows, d, scale=1.0), mk(d, d, scale=0.03), mk(d),
            1.0 + mk(d), mk(d), mk(d, m, scale=0.03), mk(m), mk(m, d, scale=0.03), mk(d),
            1.0 + mk(d), mk(d)]


def _port(args):
    return [T(np.ascontiguousarray(a.T)) if i in (2, 6, 8) else T(a) for i, a in enumerate(args)]


@pytest.mark.parametrize("d, m", TWIN_WIDTHS)
def test_the_eval_block_twins_match_jax(d, m):
    """#2 / #3 against block_reference / block_tanh_reference: 2e-5 (f32
    on both sides)."""
    args = _block_case(1, 24, d, m)
    res = np.random.default_rng(2).standard_normal((24, d)).astype(np.float32)
    ja, ta = [jnp.asarray(a) for a in args], _port(args)
    np.testing.assert_allclose(_np(FB.fused_block(*ta)),
                               np.asarray(jax.jit(PF.block_reference)(*ja)), **TOL)
    np.testing.assert_allclose(_np(FB.fused_block_tanh(T(res), *ta)),
                               np.asarray(PF.block_tanh_reference(jnp.asarray(res), *ja)), **TOL)


def test_the_w8a8_block_twin_matches_jax_at_bert_large_widths():
    """#8 against block_w8a8_reference at 1,024 / 4,096, its quantized
    weights from the same nn.Linear weights: 5e-5 / 1e-4 relative (the JAX
    test's own: its LayerNorm sums run in another order)."""
    args = _block_case(1, 24, *TWIN_WIDTHS[0])
    ja, ta = [jnp.asarray(a) for a in args], _port(args)
    q8 = FB.quantize_block_weights(ta[2], ta[6], ta[8])
    w8 = (ta[0], ta[1], q8[0], q8[1], *ta[3:6], q8[2], q8[3], ta[7], q8[4], q8[5], *ta[9:])
    np.testing.assert_allclose(_np(FB.fused_block_w8a8(*w8)),
                               np.asarray(PF.block_w8a8_reference(*ja)), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("d, m", TWIN_WIDTHS)
def test_the_training_block_twins_match_jax(d, m):
    """#9a's twin against block_train_reference and #9b's (the explicit
    backward) against jax.vjp of it, on explicit keep masks at rate 0.1:
    y and all 12 gradients within 2e-5 / 1e-4 (the relative error of the
    JAX test of the backward)."""
    rows, rate = 24, 0.1
    args = _block_case(3, rows, d, m)
    rng = np.random.default_rng(4)
    ma, mf = rng.random((rows, d)) >= rate, rng.random((rows, d)) >= rate
    cot = rng.standard_normal((rows, d)).astype(np.float32)
    f = lambda *a: PBB.block_train_reference(*a, mask_a=jnp.asarray(ma), mask_f=jnp.asarray(mf),
                                             rate=rate)

    @jax.jit
    def y_and_grads(a, ct):
        y, vjp = jax.vjp(f, *a)
        return y, vjp(ct)

    want_y, want = y_and_grads([jnp.asarray(a) for a in args], jnp.asarray(cot))
    want = [np.asarray(g) for g in want]
    port = _port(args)
    res = BT.block_train_fwd_plain(*port, mask_a=T(ma), mask_f=T(mf), rate=rate)
    np.testing.assert_allclose(_np(res[0]), np.asarray(want_y), **TOL)
    x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2 = port
    grads = BT.block_train_bwd_plain(T(cot), ctx, *res[1:], wo, w1, w2, s1, g1, s2,
                                     mask_a=T(ma), mask_f=T(mf), rate=rate)
    for i, (name, a, w) in enumerate(zip(BT.GRAD_NAMES, grads, want)):
        a = _np(a).T if i in (2, 6, 8) else _np(a)
        np.testing.assert_allclose(a, w, atol=1e-4 * np.abs(w).max(), rtol=1e-4, err_msg=name)


def test_the_training_block_masks_at_1024_are_the_element_coordinates():
    """#9a / #9b's masks at hidden 1,024 are the Philox bits of (row, col):
    each group of four columns is one philox4x32 call on the counter (col /
    4, row, 0, 0) under the key (seed, the block's stream), as csrc/
    block_train.cu's row_keep4 draws it; no flat index over a fixed width
    enters, so the bits of a column do not depend on the row's width."""
    rows, d, rate, seed = 5, 1024, 0.1, 20261023
    ma, mf = BT.masks_from_seed(torch.tensor([seed]), rows, d, rate, "cpu")
    for mask, stream in ((ma, D.STREAM_BLOCK_A), (mf, D.STREAM_BLOCK_F)):
        r, c = torch.meshgrid(torch.arange(rows), torch.arange(d // 4), indexing="ij")
        u = lambda v: torch.as_tensor(v, dtype=torch.int64).expand(r.shape)
        words = D.philox4x32(c, r, u(0), u(0), u(seed & 0xFFFFFFFF), u(stream))
        bits = torch.stack(words, dim=-1).reshape(rows, d)
        assert torch.equal(mask, bits >= D.threshold(rate))
    narrow = BT.masks_from_seed(torch.tensor([seed]), rows, 768, rate, "cpu")
    assert torch.equal(narrow[0], ma[:, :768]) and torch.equal(narrow[1], mf[:, :768])


def _step_case(d, m, b=2, lp=128, n_layers=2, seed=7):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * 0.03).astype(np.float32)
    shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d), "w1": (d, m), "w2": (m, d)}
    jst, tst = {}, {}
    for name in DS.STACK_NAMES:
        if name[0] == "w":
            w = mk(n_layers, *shapes[name])
            jst[name], tst[name] = w, np.ascontiguousarray(w.transpose(0, 2, 1))
        else:
            v = mk(n_layers, 1, m if name == "b1" else d) + (1.0 if name[0] == "s" else 0.0)
            jst[name] = tst[name] = v
    kv = rng.standard_normal((n_layers, b, lp, 2 * d)).astype(np.float32)
    kv8 = np.clip(np.rint(kv * 40), -127, 127).astype(np.int8)
    kvs = (0.01 + rng.random((n_layers, b, 2, lp)) * 0.02).astype(np.float32)
    mask = (rng.random((b, lp)) > 0.5).astype(np.float32)
    x = rng.standard_normal((b, 1, d)).astype(np.float32)
    return jst, tst, kv8, kvs, mask, x


@pytest.mark.parametrize("d, m", TWIN_WIDTHS)
def test_the_decode_step_twin_matches_jax(d, m):
    """#5's twin against fused_step_reference at heads of 64 (16 at 1,024,
    8 at 512), at tests/test_torch_decode_step.py's limits: y within 2e-5,
    the quantized rows exact, their scales within 1e-7."""
    from vitxtgqa_tpu.ops.pallas_decode_step import fused_step_reference

    jst, tst, kv8, kvs, mask, x = _step_case(d, m)
    step, off, heads = 3, 100, d // 64
    want = jax.jit(fused_step_reference, static_argnums=(5, 6, 7))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in jst.items()}, jnp.asarray(kv8),
        jnp.asarray(kvs), jnp.asarray(mask), step, off, heads)
    got = DS.fused_decode_step(T(x), {k: T(v) for k, v in tst.items()}, T(kv8), T(kvs),
                               T(mask), step, off, heads)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), atol=1e-7)


@pytest.mark.parametrize("d", [1024, 1280])
def test_the_int8_pointer_scores_twin_matches_jax(d):
    """#12's twin against the Pallas kernel in interpret mode at 1,024
    and beyond the old cap: 1e-4 (the JAX tests' own)."""
    from vitxtgqa_tpu.ops.attention import quantize_kv as jquantize_kv
    from vitxtgqa_tpu.ops.pallas_attention import ptr_scores_int8

    rng = np.random.default_rng(d)
    q = rng.standard_normal((2, 1, d)).astype(np.float32)
    k = rng.standard_normal((2, 40, d)).astype(np.float32)
    mask = (rng.random((2, 40)) > 0.3).astype(np.float32)
    k8, ks = jquantize_kv(jnp.asarray(k))
    want = ptr_scores_int8(jnp.asarray(q), k8, ks, jnp.asarray(mask), interpret=True)
    got = PS.ptr_scores_int8(T(q), *quantize_kv(T(k)), T(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# T2S at bert-large's widths against the JAX T2S
# ---------------------------------------------------------------------------

FRAMES, OCR_PF, BATCH, DEC = 4, 3, 2, 4
N_OCR = FRAMES * OCR_PF
NF = 5050 + N_OCR
LOSSES = [{"type": "pos_bce_loss", "weight": 1.0}, {"type": "InfoNCE", "weight": 1000}]


def _bert_large_t2s_config():
    """t2s_bert_large_config at one layer a stack, 4 frames of 3 OCR
    tokens (top 2 of each), every dropout 0: bert-large's widths in every
    stack, the production feature widths."""
    from vitxtgqa_tpu.core.config import ConfigNode

    cfg = t2s_bert_large_config()
    for stack in ("text_bert", "translayers", "encoder", "mmt"):
        cfg[stack] = {**cfg[stack], "num_hidden_layers": 1, "hidden_dropout_prob": 0.0,
                      "attention_probs_dropout_prob": 0.0}
    cfg["obj"] = {**cfg["obj"], "dropout_prob": 0.0}
    cfg["ocr"] = {**cfg["ocr"], "dropout_prob": 0.0}
    cfg["grounding"] = {**cfg["grounding"], "frame_num": FRAMES, "ocr_frame_num": OCR_PF,
                        "max_ocr_num": N_OCR, "frame_topk": 2, "ocr_topk": 2}
    cfg["classifier"] = {**cfg["classifier"], "ocr_max_num": N_OCR}
    return ConfigNode(cfg)


@pytest.fixture(scope="module")
def bert_large():
    return _bert_large_case()


def _bert_large_case():
    """(config, batch, gumbel noise, the port's T2S from seed 0, its
    weights in the JAX tree)."""
    cfg = _bert_large_t2s_config()
    assert cfg["mmt"]["hidden_size"] == BERT_LARGE["hidden_size"] == 1024
    batch = synthetic_batch(batch=BATCH, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=DEC,
                            text_len=10, num_final_outputs=NF, seed=0)
    # every frame and OCR slot valid: the negative grounding's bottom-k then
    # ranks noisy scores only (a masked slot ties with another, and the two
    # frameworks break ties apart)
    batch["frame_id"] = np.tile(np.arange(1, FRAMES + 1, dtype=np.int32), (BATCH, 1))
    batch["frame_mask"] = np.ones((BATCH, FRAMES), np.float32)
    batch["frame_num"] = np.full((BATCH,), FRAMES, np.int64)
    batch["temporal_id"] = np.tile(np.repeat(batch["frame_id"][0], OCR_PF), (BATCH, 1))
    batch["ocr_mask"] = np.ones((BATCH, N_OCR), np.float32)
    rng = np.random.default_rng(5)
    noise = {s: rng.gumbel(size=s).astype(np.float32)
             for s in ((BATCH, 2, FRAMES), (BATCH, 2, N_OCR))}
    model = T2S(cfg, NF, bos_idx=2, opts=cpu_options()).init_weights(0)
    with torch.no_grad():
        # the pooled question 20x smaller: at width 1,024 the grounding's
        # softmax over the OCR slots saturates at the init's scale, and its
        # bottom-k then ranks values that underflow to 0 in one framework
        # and not in the other
        for t in (model.Grounding_Module.q_linear.weight, model.Grounding_Module.q_linear.bias):
            t.mul_(0.05)
    state = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    params = unflatten(convert_t2s_like(state, text_layers=1, qtv_layers=1, mmt_layers=1))
    return cfg, batch, noise, model, params


def _tensors(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _noise(noise):
    return T(noise[(BATCH, 2, FRAMES)]), T(noise[(BATCH, 2, N_OCR)])


def test_t2s_at_bert_large_widths_serves_as_the_jax_t2s(bert_large, monkeypatch):
    """The serving forward (inference_only): pos_scores within 2e-5,
    greedy tokens and grounding exact."""
    from vitxtgqa_tpu.models.t2s import T2S as JT2S

    cfg, batch, noise, model, params = bert_large
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


def test_t2s_at_bert_large_widths_trains_as_the_jax_t2s(bert_large, monkeypatch):
    """One training forward and backward (the block through BlockTrainFn,
    whose width gate holds at 1,024 / 4,096): the total loss within 1e-5
    relative, every parameter's gradient within 1e-4 of its largest entry
    (floored as tests/test_torch_train.py floors it) plus 1e-3 relative,
    the three stacks' key biases aside (below 1e-5: zero but for
    rounding)."""
    from vitxtgqa_tpu.losses import Losses as JLosses
    from vitxtgqa_tpu.models.t2s import T2S as JT2S

    cfg, batch, noise, model, params = bert_large
    assert BT.kernel_ok(1024, 4096)
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
    # a key projection's bias moves every score of a query alike, which the
    # softmax ignores: its gradient is zero but for rounding (chip_smoke's
    # step_agreement leaves it out too)
    noise = [k for k in want if k.endswith("attention.self.key.bias")]
    assert len(noise) == 3 and all(np.abs(want[k]).max() < 1e-5 for k in noise)
    _assert_grads_close({k: v for k, v in got.items() if k not in noise},
                        {k: v for k, v in want.items() if k not in noise}, 1e-4, 1e-3)
