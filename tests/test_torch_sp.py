"""The port under sequence parallelism on two gloo ranks against the JAX
package under set_sequence_parallel on a 2-device CPU mesh.

One pair of ranks (tests/torch_sp_ranks.py, no JAX in them) runs every
case of this module once, in a module-scoped fixture; each test reads its
case.  The JAX reference runs in this process: sp_attention and T2S with
the sequence axis over 2 of the 8 virtual CPU devices of tests/conftest.py.
CPU, float32, tiny widths; inputs, weights and gumbel noise are made here
with numpy (the port's seeded init for the weights, converted to the JAX
tree) and handed to both sides.

Cases: ``sp_attention`` for the four bias forms of
tests/test_sequence_parallel.py (and the MaskSpec at 256 keys, where the
port's ranks take the split-head flash route, #10's plain twin on CPU
tensors, and JAX off the TPU the -1e4 bias rows: the two agree on every row
with an allowed key) and its gradients against jax.grad through JAX's
sp_attention; T2S at the "wide" width of tests/test_torch_t2s.py (a 384-row
joint sequence: QTV and MMT on the flash route) serving with the int8
cache, full-eval, the serving preset (int8 + compact) and W8A8; a training
step with every dropout at 0 (so that the two frameworks compute the same
function and the attention takes the SP route) against
jax.value_and_grad.  Limits: attention 1e-5 (gradients 2e-5); T2S tokens
and grounding exact, scores within 2e-5 (W8A8 2e-4: see
tests/test_torch_t2s.py); training as tests/test_torch_train.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests import torch_sp_ranks
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import synthetic_batch, tiny_model_config
from vitxtgqa_tpu.utils.torch_convert import convert_t2s_like, flatten, unflatten
from vitxtgqa_tpu_torch.models.t2s import T2S
from vitxtgqa_tpu_torch.utils.convert import from_jax_params

FRAMES, OCR_PF, HIDDEN, DEC_STEPS = 8, 30, 128, 4
LOSSES = [{"type": "pos_bce_loss", "weight": 1.0}, {"type": "InfoNCE", "weight": 1000}]
W8A8_SCORE_TOL = 2e-4


def _plain(node):
    """A config tree as plain dicts (the ranks import no JAX-package type)."""
    if hasattr(node, "items"):
        return {k: _plain(v) for k, v in node.items()}
    return node


def _mesh():
    return Mesh(np.array(jax.devices()[:2]), ("sp",))


# ---------------------------------------------------------------------------
# sp_attention
# ---------------------------------------------------------------------------

# (batch, heads, encoder length, decoder length, head dim, bias form)
ATTN_CASES = {
    "no_bias": (1, 2, 32, 0, 8, "none"),
    "key_row": (2, 3, 64, 0, 16, "key_row"),
    "per_row": (1, 2, 26, 6, 8, "per_row"),
    "mask_spec": (2, 2, 26, 6, 16, "mask_spec"),
    "mask_spec_flash_route": (2, 2, 250, 6, 16, "mask_spec"),
}


@functools.lru_cache(maxsize=None)
def _attn_inputs(case):
    b, h, lenc, dec, d, form = ATTN_CASES[case]
    l = lenc + dec
    rng = np.random.default_rng(sorted(ATTN_CASES).index(case))
    q, k, v, g = (rng.standard_normal((b, h, l, d)).astype(np.float32) for _ in range(4))
    enc = (np.arange(lenc)[None, :] < rng.integers(lenc // 2, lenc + 1, (b, 1))).astype(np.float32)
    key_mask = np.concatenate([enc, np.zeros((b, dec), np.float32)], 1)
    bias = None
    if form == "key_row":
        bias = {"form": form, "bias": ((1.0 - key_mask) * -10000.0)[:, None, None, :]}
    elif form == "per_row":
        from vitxtgqa_tpu.ops.masks import prefix_lm_bias

        bias = {"form": form, "bias": np.asarray(prefix_lm_bias(jnp.asarray(enc), dec))}
    elif form == "mask_spec":
        bias = {"form": form, "key_mask": key_mask, "dec_len": dec}
    return dict(kind="attention", q=q, k=k, v=v, g=g, bias=bias)


def _jax_bias(spec):
    from vitxtgqa_tpu.ops.masks import MaskSpec

    if spec is None:
        return None
    if spec["form"] == "mask_spec":
        return MaskSpec(key_mask=jnp.asarray(spec["key_mask"]), dec_len=spec["dec_len"])
    return jnp.asarray(spec["bias"])


# ---------------------------------------------------------------------------
# T2S
# ---------------------------------------------------------------------------

# name: (batch, Options fields, inference_only)
T2S_CASES = {
    "serving_int8_b2": (2, dict(kv_cache_int8=True), True),
    "full_eval_int8_b2": (2, dict(kv_cache_int8=True), False),
    "preset_b2": (2, dict(kv_cache_int8=True, compact_serving=True), True),
    "w8a8_b6": (6, dict(kv_cache_int8=True, w8a8=True), True),
}


def _config(no_dropout: bool):
    cfg = tiny_model_config(hidden=HIDDEN, frames=FRAMES, ocr_per_frame=OCR_PF)
    c = _plain(cfg)
    if no_dropout:
        for sect in ("text_bert", "translayers", "mmt", "encoder"):
            c[sect].update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        c["obj"]["dropout_prob"] = c["ocr"]["dropout_prob"] = 0.0
    return type(cfg)(c), c


@functools.lru_cache(maxsize=None)
def _t2s_inputs(case):
    train = case == "train"
    b, opts, inference_only = (2, {}, True) if train else T2S_CASES[case]
    cfg, plain_cfg = _config(no_dropout=train)
    n = FRAMES * OCR_PF
    nf = 32 + n
    batch = synthetic_batch(batch=b, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=DEC_STEPS,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=nf, text_vocab=128, seed=0)
    rng = np.random.default_rng(5)
    noise = (rng.gumbel(size=(b, 2, FRAMES)).astype(np.float32),
             rng.gumbel(size=(b, 2, n)).astype(np.float32))
    state = T2S(cfg, nf, opts=cpu_options()).init_weights(0).state_dict()
    case_in = dict(kind="train" if train else "t2s", cfg=plain_cfg, nf=nf, opts=opts,
                   inference_only=inference_only, state=state,
                   batch={k: np.asarray(v) for k, v in batch.items()}, noise=noise)
    if train:
        case_in["losses"] = LOSSES
    return cfg, case_in


def _patch_jax_gumbel(monkeypatch, noise):
    import vitxtgqa_tpu.models.grounding as G

    table = {tuple(x.shape): x for x in noise}

    def jax_gumbel(r, logits, tau=1.0, axis=-1, hard=True):
        y = jax.nn.softmax((logits + jnp.asarray(table[tuple(logits.shape)])) / tau, axis=axis)
        yh = jnp.put_along_axis(jnp.zeros_like(y), jnp.argmax(y, axis=axis, keepdims=True), 1.0,
                                axis=axis, inplace=False)
        return yh + y - jax.lax.stop_gradient(y)

    monkeypatch.setattr(G, "gumbel_softmax", jax_gumbel)


def _open_jax_w8a8_gate(monkeypatch):
    """The JAX layer's fused-block gate opened on the CPU (its shape
    condition), W8A8 on, the W8A8 block through block_w8a8_reference (as
    tests/test_torch_t2s.py does)."""
    from vitxtgqa_tpu.models.common import TransformerLayer as JLayer
    from vitxtgqa_tpu.ops import attention as JA
    from vitxtgqa_tpu.ops import pallas_ffn as P

    def gate(self, x, deterministic):
        rows = int(np.prod(x.shape[:-1]))
        return (deterministic and x.shape[-1] == self.cfg.hidden_size
                and P.ffn_kernel_ok(x.shape[-1], self.cfg.intermediate_size, rows))

    monkeypatch.setattr(JLayer, "_fused_block_ok", gate)
    monkeypatch.setattr(P, "fused_block_w8a8", P.block_w8a8_reference)
    JA.set_w8a8(True)


def _jax_params(state):
    numpy_state = {k: v.detach().numpy() for k, v in state.items()}
    return unflatten(convert_t2s_like(numpy_state, text_layers=1, qtv_layers=1, mmt_layers=2))


@pytest.fixture
def jax_sp():
    """JAX's sequence-parallel switch on a 2-device mesh for one test."""
    from vitxtgqa_tpu.ops.attention import set_sequence_parallel

    set_sequence_parallel(_mesh())
    yield
    set_sequence_parallel(None)


# ---------------------------------------------------------------------------
# the ranks: every case once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {f"attn/{c}": _attn_inputs(c) for c in ATTN_CASES}
    cases.update({f"t2s/{c}": _t2s_inputs(c)[1] for c in list(T2S_CASES) + ["train"]})
    return torch_sp_ranks.launch(cases, tmp_path_factory.mktemp("sp_ranks"))


def test_the_ranks_agree(ranks):
    """Both ranks return the same outputs and gradients, bit for bit: each
    gathers every rank's rows and sums the same partials."""
    r0, r1 = ranks
    assert sorted(r0) == sorted(r1)
    for name in r0:
        flat0, flat1 = flatten_results(r0[name]), flatten_results(r1[name])
        assert sorted(flat0) == sorted(flat1), name
        for key in flat0:
            np.testing.assert_array_equal(flat0[key], flat1[key], err_msg=f"{name} {key}")


def flatten_results(node, prefix=""):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(flatten_results(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(node)}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_sp_attention_matches_jax(case, ranks):
    from vitxtgqa_tpu.parallel.sequence_parallel import sp_attention

    c = _attn_inputs(case)
    want = sp_attention(*(jnp.asarray(c[n]) for n in ("q", "k", "v")), _jax_bias(c["bias"]),
                        _mesh())
    got = ranks[0][f"attn/{case}"]["out"]
    assert got.shape == c["q"].shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_sp_attention_grads_match_jax(case, ranks):
    """SPAttentionFn's backward (each rank's rows, dQ gathered, the f32
    dK / dV partials summed over the ranks) against jax.grad through JAX's
    sp_attention (shard_map's all-gather and psum)."""
    from vitxtgqa_tpu.parallel.sequence_parallel import sp_attention

    c = _attn_inputs(case)
    bias, g = _jax_bias(c["bias"]), jnp.asarray(c["g"])
    want = jax.grad(lambda q, k, v: jnp.sum(sp_attention(q, k, v, bias, _mesh()) * g),
                    argnums=(0, 1, 2))(*(jnp.asarray(c[n]) for n in ("q", "k", "v")))
    got = ranks[0][f"attn/{case}"]
    for name, w in zip(("dq", "dk", "dv"), want):
        np.testing.assert_allclose(got[name], np.asarray(w), atol=2e-5, rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("case", sorted(T2S_CASES))
def test_t2s_under_sp_matches_jax(case, ranks, jax_sp, monkeypatch):
    """Scores within 2e-5 (W8A8 2e-4), greedy tokens and grounding exact."""
    from vitxtgqa_tpu.models.common import set_compact_serving, set_kv_cache_int8
    from vitxtgqa_tpu.models.t2s import T2S as JT2S

    b, opts, inference_only = T2S_CASES[case]
    cfg, c = _t2s_inputs(case)
    _patch_jax_gumbel(monkeypatch, c["noise"])
    set_kv_cache_int8(opts.get("kv_cache_int8", False))
    set_compact_serving(opts.get("compact_serving", False))
    if opts.get("w8a8"):
        _open_jax_w8a8_gate(monkeypatch)
    jm = JT2S(config=cfg, num_final_outputs=c["nf"], bos_idx=2, inference_only=inference_only)
    want = jax.jit(lambda p, bt: jm.apply({"params": p}, bt, train=False,
                                          rngs={"gumbel": jax.random.key(0)}))(
        _jax_params(c["state"]), c["batch"])
    got = ranks[0][f"t2s/{case}"]
    tol = W8A8_SCORE_TOL if opts.get("w8a8") else 2e-5
    keys = ("pos_scores",) if inference_only else ("ref_scores", "pos_scores", "neg_scores")
    for k in keys:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape == (b, DEC_STEPS, c["nf"])
        print(f"{case} {k}: max |diff| {np.abs(got[k] - w).max():.3e} (tol {tol})")
        np.testing.assert_allclose(got[k], w, atol=tol, rtol=tol, err_msg=k)
    np.testing.assert_array_equal(got["pos_scores"].argmax(-1),
                                  np.asarray(want["pos_scores"]).argmax(-1))
    np.testing.assert_array_equal(got["ground_frame"], np.asarray(want["ground_frame"]))
    if inference_only:
        np.testing.assert_array_equal(got["ground_box"], np.asarray(want["ground_box"]))


def test_training_step_under_sp_matches_jax(ranks, jax_sp, monkeypatch):
    """Every dropout 0: the train-mode scores within 2e-5, the losses within
    1e-5 relative, and each parameter's gradient within 1e-4 of its largest
    entry plus 1e-3 relative, that entry floored at 1e-5 of the model's
    largest gradient entry (tests/test_torch_train.py's limits) against
    jax.value_and_grad of the JAX T2S under set_sequence_parallel."""
    from vitxtgqa_tpu.losses import Losses as JLosses
    from vitxtgqa_tpu.models.t2s import T2S as JT2S

    cfg, c = _t2s_inputs("train")
    _patch_jax_gumbel(monkeypatch, c["noise"])
    jm = JT2S(config=cfg, num_final_outputs=c["nf"], bos_idx=2, train_variant_scan=True)
    jlosses = JLosses(LOSSES)

    def loss_fn(p):
        out = jm.apply({"params": p}, c["batch"], train=True,
                       rngs={"dropout": jax.random.key(1), "gumbel": jax.random.key(2)})
        total, parts = jlosses.total(c["batch"], out)
        return total, (parts, out)

    (want_total, (want_parts, want_out)), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(_jax_params(c["state"]))
    got = ranks[0]["t2s/train"]
    for k, v in got["scores"].items():
        np.testing.assert_allclose(v, np.asarray(want_out[k]), atol=2e-5, rtol=2e-5, err_msg=k)
    for k, v in got["parts"].items():
        np.testing.assert_allclose(v, float(want_parts[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["total"], float(want_total), rtol=1e-5)
    want = {k: v.numpy() for k, v in
            from_jax_params(flatten(jax.tree_util.tree_map(np.asarray, want_grads))).items()}
    grads = {k: got["grads"].get(k, np.zeros_like(w)) for k, w in want.items()}
    assert set(got["grads"]) <= set(want)
    floor = 1e-5 * max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(grads[name], w, atol=1e-4 * max(np.abs(w).max(), floor),
                                   rtol=1e-3, err_msg=name)
