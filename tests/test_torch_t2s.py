"""The PyTorch port's T2S serving slice against the JAX T2S, plus its
serving engine, weight conversion, production config and import hygiene.

CPU, float32, tiny config (utils/synthetic.tiny_model_config).  The JAX
model runs jitted as its own tests run it (no Pallas on the CPU); the
port's kernel ops run their plain versions.  Weights: the port's seeded
init, converted to the JAX tree by vitxtgqa_tpu's convert_t2s_like.  Gumbel
noise: shape-keyed numpy draws, patched into the JAX grounding in the test
only and passed to the port as an argument.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import synthetic_batch, tiny_model_config
from vitxtgqa_tpu.utils.torch_convert import convert_t2s_like, unflatten
from vitxtgqa_tpu_torch.models.t2s import T2S, t2s_production_config
from vitxtgqa_tpu_torch.serving.engine import ServingEngine, group_generator
from vitxtgqa_tpu_torch.utils.convert import from_jax_params

FRAMES = 8
DEC_STEPS = 4


def _setup(ocr_pf=3, hidden=64, b=3, int8=False, seed=0, **opts):
    cfg = tiny_model_config(hidden=hidden, frames=FRAMES, ocr_per_frame=ocr_pf)
    nf = 32 + FRAMES * ocr_pf
    batch = synthetic_batch(batch=b, frames=FRAMES, ocr_per_frame=ocr_pf, dec_steps=DEC_STEPS,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=nf, text_vocab=128, seed=seed)
    model = T2S(cfg, nf, bos_idx=2, opts=cpu_options(kv_cache_int8=int8, **opts)).init_weights(seed)
    return cfg, nf, batch, model


def _tensors(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _state_numpy(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


SLICE_CASES = {
    # name: (ocr per frame, hidden, batch, int8 cache).  "wide" reaches the
    # kernel gates: 8 x 30 OCR rows give a 384-row joint sequence (flash and
    # the bf16 decode attention at >= 256 keys) and 6 x 384 = 2304 rows of
    # lane-aligned width 128 (fused block).  "fused" forces the fused-decode
    # gate on for both packages (JAX in Pallas interpret mode), at the
    # batches where it engages by default.  "compact": compact serving (JAX
    # set_compact_serving), the MMT on the 28 kept rows (+ 4 decoder slots,
    # 128 with the padding); with "fused" its step_fused branch.  "w8a8":
    # the W8A8 block wherever the fused block engages (JAX: its block gate
    # opened on the CPU, the W8A8 block through block_w8a8_reference)
    "int8_cache": (3, 64, 3, True),
    "f32_cache": (3, 64, 3, False),
    "wide_int8_cache": (30, 128, 6, True),
    "wide_f32_cache": (30, 128, 6, False),
    "fused_b1": (3, 64, 1, True),
    "fused_b2": (3, 64, 2, True),
    "compact_int8": (3, 64, 3, True),
    "compact_f32": (3, 64, 3, False),
    "compact_fused_b1": (3, 64, 1, True),
    "wide_w8a8": (30, 128, 6, True),
    "wide_compact_w8a8": (30, 128, 6, True),
}
# W8A8 behind attention and LayerNorm: the int8 steps turn the frameworks'
# last-bit f32 differences into larger ones (the wide case reads 2.7e-5),
# and an activation rounded across its step's boundary would move its row
# by a step's weight (tests/test_torch_w8a8.py); the W8A8 cases hold the
# scores to this instead of 2e-5, tokens and grounding still exact
W8A8_SCORE_TOL = 2e-4


def _open_jax_w8a8_gate(monkeypatch):
    """The JAX layer's fused-block gate opened on the CPU (its shape
    condition), W8A8 on, the W8A8 block through block_w8a8_reference."""
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


def _force_fused_decode(monkeypatch):
    """Switch the fused-decode gate on in both packages (the port's gate
    otherwise needs CUDA tensors, the JAX one a TPU)."""
    from vitxtgqa_tpu.models.common import TransformerEncoder as JEnc
    from vitxtgqa_tpu.ops import pallas_decode_step as PDS
    from vitxtgqa_tpu_torch.models.common import TransformerEncoder as TEnc

    monkeypatch.setattr(JEnc, "fused_decode_ok", lambda self: True)
    monkeypatch.setattr(PDS, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(TEnc, "fused_decode_ok", lambda self, x: True)


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_slice_matches_jax_t2s_inference_only(case, monkeypatch):
    """pos_scores within 2e-5 (f32 on both sides; the difference is
    summation order through ~8 layers; W8A8: W8A8_SCORE_TOL), greedy tokens
    and grounding exact."""
    import vitxtgqa_tpu.models.grounding as G
    from vitxtgqa_tpu.models.common import set_compact_serving, set_kv_cache_int8
    from vitxtgqa_tpu.models.t2s import T2S as JT2S
    from vitxtgqa_tpu_torch.ops import decode_attention as TDA
    from vitxtgqa_tpu_torch.ops import decode_step as TDS
    from vitxtgqa_tpu_torch.ops import flash_attention as TFA
    from vitxtgqa_tpu_torch.ops import fused_block as TFB

    ocr_pf, hidden, b, int8 = SLICE_CASES[case]
    compact, w8a8, fused = "compact" in case, "w8a8" in case, "fused" in case
    cfg, nf, batch, model = _setup(ocr_pf, hidden, b, int8, compact_serving=compact, w8a8=w8a8)
    if fused:
        _force_fused_decode(monkeypatch)
    set_compact_serving(compact)
    if w8a8:
        _open_jax_w8a8_gate(monkeypatch)
    n = FRAMES * ocr_pf
    rng = np.random.default_rng(5)
    noise = {(b, 2, FRAMES): rng.gumbel(size=(b, 2, FRAMES)).astype(np.float32),
             (b, 2, n): rng.gumbel(size=(b, 2, n)).astype(np.float32)}

    def jax_gumbel(r, logits, tau=1.0, axis=-1, hard=True):
        y = jax.nn.softmax((logits + jnp.asarray(noise[tuple(logits.shape)])) / tau, axis=axis)
        yh = jnp.put_along_axis(jnp.zeros_like(y), jnp.argmax(y, axis=axis, keepdims=True), 1.0,
                                axis=axis, inplace=False)
        return yh + y - jax.lax.stop_gradient(y)

    monkeypatch.setattr(G, "gumbel_softmax", jax_gumbel)
    set_kv_cache_int8(int8)
    params = unflatten(convert_t2s_like(_state_numpy(model), text_layers=1, qtv_layers=1,
                                        mmt_layers=2))
    jm = JT2S(config=cfg, num_final_outputs=nf, bos_idx=2, inference_only=True)
    want = jax.jit(lambda p, bt: jm.apply({"params": p}, bt, train=False,
                                          rngs={"gumbel": jax.random.key(0)}))(params, batch)

    calls = []
    for mod, name in ((TFA, "flash_attention_merged_plain"), (TFB, "fused_block_plain"),
                      (TFB, "fused_block_tanh_plain"), (TFB, "fused_block_w8a8_plain"),
                      (TDA, "decode_attention_plain"), (TDS, "fused_decode_step_plain"),
                      (TDS, "fused_epilogue_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    got = model(_tensors(batch), (torch.from_numpy(noise[(b, 2, FRAMES)]),
                                  torch.from_numpy(noise[(b, 2, n)])))

    w, g = np.asarray(want["pos_scores"]), got["pos_scores"].numpy()
    assert g.shape == w.shape == (b, DEC_STEPS, nf) and g.dtype == np.float32
    tol = W8A8_SCORE_TOL if w8a8 else 2e-5
    print(f"{case}: max |d pos_scores| {np.abs(g - w).max():.3e} (tol {tol})")
    np.testing.assert_allclose(g, w, atol=tol, rtol=tol)
    np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    np.testing.assert_array_equal(got["ground_frame"].numpy(), np.asarray(want["ground_frame"]))
    np.testing.assert_array_equal(got["ground_box"].numpy(), np.asarray(want["ground_box"]))
    if compact:
        # never-kept copy slots are pinned to -1e4 on both sides
        pinned = w[..., 32:] == -1e4
        assert pinned.any() and np.array_equal(g[..., 32:] == -1e4, pinned)
    want_calls = []
    if case.startswith("wide"):
        # 1 QTV + 2 MMT encode layers at 384 rows: flash and the block in
        # each (W8A8: its own kernel, the tanh added after; else the last
        # (only) QTV layer in its tanh form); over a bf16/f32 cache the 2
        # MMT layers x 4 steps of decode attention.  Compact MMT rows (128
        # a batch row) reach neither gate
        block = (["fused_block_w8a8_plain"] * 3 if w8a8
                 else ["fused_block_plain"] * 2 + ["fused_block_tanh_plain"])
        want_calls = ["flash_attention_merged_plain"] * 3 + block
        if compact:
            want_calls = ["flash_attention_merged_plain", block[-1]]
        if not int8:
            want_calls += ["decode_attention_plain"] * (2 * DEC_STEPS)
    elif fused:
        want_calls = ["fused_decode_step_plain"] * DEC_STEPS
        if not compact:  # compact serving takes step_fused: no fused epilogue
            want_calls += ["fused_epilogue_plain"] * DEC_STEPS
    assert sorted(calls) == sorted(want_calls)


def test_fused_branch_matches_the_per_layer_branch(monkeypatch):
    """The port's fused decode against its own per-layer decode on the same
    weights and batch: greedy tokens exact, scores within 5e-2 (the JAX
    test's bound: the fused epilogue rounds the next embedding's emb rows to
    bf16, the per-layer path does not)."""
    _, _, batch, model = _setup(b=2, int8=True)
    noise = lambda: torch.Generator().manual_seed(3)
    per_layer = model(_tensors(batch), noise())
    _force_fused_decode(monkeypatch)
    fused = model(_tensors(batch), noise())
    a, f = per_layer["pos_scores"].numpy(), fused["pos_scores"].numpy()
    np.testing.assert_array_equal(f.argmax(-1), a.argmax(-1))
    np.testing.assert_allclose(f, a, atol=5e-2, rtol=5e-2)


@pytest.fixture(scope="module")
def served():
    _, nf, batch, model = _setup(b=4, int8=True)
    return model, batch, nf


def _rows(batch, idx):
    return [{k: np.asarray(v)[i] for k, v in batch.items()} for i in idx]


def test_engine_partial_group_matches_padded_direct_forward(served):
    """N=2 requests ride a bucket of 4 (padded with copies of the first);
    each answer equals its row of a direct forward on that padded batch
    under the engine's group-0 generator."""
    model, batch, nf = served
    samples = _rows(batch, [1, 3])
    with ServingEngine(model, buckets=(4,), max_wait_ms=500, rng_seed=7) as eng:
        outs = [f.result(timeout=120) for f in [eng.submit(s) for s in samples]]
    padded = {k: np.stack([s[k] for s in samples] + [samples[0][k]] * 2) for k in samples[0]}
    direct = model(_tensors(padded), group_generator(7, 0, torch.device("cpu")))
    for i, out in enumerate(outs):
        assert out["pos_scores"].shape == (4, nf)
        np.testing.assert_array_equal(out["pos_scores"], direct["pos_scores"][i].numpy())
        np.testing.assert_array_equal(out["ground_frame"], direct["ground_frame"][i].numpy())
        np.testing.assert_array_equal(out["ground_box"], direct["ground_box"][i].numpy())
        assert out["frame_topk"] == 2 and out["ocr_topk"] == 2


def test_engine_keeps_serving_after_a_bad_request(served):
    model, batch, _ = served
    with ServingEngine(model, buckets=(2, 4), max_wait_ms=1) as eng:
        bad = eng.submit({"text": np.zeros((3,), np.int64)})
        with pytest.raises(Exception):
            bad.result(timeout=120)
        ok = eng.submit(_rows(batch, [0])[0]).result(timeout=120)
        assert np.isfinite(ok["pos_scores"]).all()
        two = [f.result(timeout=120) for f in [eng.submit(s) for s in _rows(batch, [0, 2])]]
    assert not np.allclose(two[0]["pos_scores"], two[1]["pos_scores"])
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit(_rows(batch, [0])[0])


def test_engine_group_generators_are_seeded_per_group():
    cpu = torch.device("cpu")
    draw = lambda s, g: torch.rand(4, generator=group_generator(s, g, cpu))
    assert torch.equal(draw(3, 0), draw(3, 0))
    assert not torch.equal(draw(3, 0), draw(3, 1))
    assert not torch.equal(draw(3, 0), draw(4, 0))


def test_from_jax_params_inverts_convert_t2s_like():
    _, nf, _, model = _setup()
    sd = model.state_dict()
    flat = convert_t2s_like(_state_numpy(model), text_layers=1, qtv_layers=1, mmt_layers=2)
    back = from_jax_params(flat)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    fresh = T2S(tiny_model_config(), nf, opts=cpu_options())
    fresh.load_state_dict(back, strict=True)


def test_production_config_equals_the_yaml(repo_root):
    from vitxtgqa_tpu.core.config import build_config
    from vitxtgqa_tpu.models.common import TransformerConfig as JTC
    from vitxtgqa_tpu_torch.models.common import TransformerConfig, cfg_get

    yml = build_config(os.path.join(repo_root, "configs", "t2s_abinet.yml")).model_attributes.t2s
    port = t2s_production_config()
    for sect in ("text_bert", "translayers", "mmt"):
        want = JTC.from_config(cfg_get(yml, sect))
        got = TransformerConfig.from_config(port[sect])
        assert got == TransformerConfig.from_config(cfg_get(yml, sect)), sect
        for f in got.__dataclass_fields__:
            assert getattr(got, f) == getattr(want, f), (sect, f)
    for sect, keys in (("obj", ("mmt_in_dim", "dropout_prob")),
                       ("ocr", ("mmt_in_dim", "dropout_prob")),
                       ("grounding", ("hidden_size", "frame_topk", "ocr_topk", "frame_num",
                                      "ocr_frame_num"))):
        for key in keys:
            assert port[sect][key] == cfg_get(cfg_get(yml, sect), key), (sect, key)
    cls = cfg_get(yml, "classifier")
    assert port["classifier"]["ocr_max_num"] == cfg_get(cls, "ocr_max_num")
    for key in ("hidden_size", "query_key_size"):
        assert port["classifier"]["ocr_ptr_net"][key] == cfg_get(cfg_get(cls, "ocr_ptr_net"), key)


def test_port_synthetic_batch_equals_the_jax_packages():
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch as port_batch

    for kw in (dict(batch=3, seed=4), dict(batch=2, frames=8, ocr_per_frame=3, seed=1)):
        a, b = port_batch(**kw), synthetic_batch(**kw)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_unported_branches_raise():
    """The recompute decode oracle builds now (tests/test_torch_recompute.py
    holds it against JAX); every JAX remat mode builds (tests/test_torch_remat.py
    holds them against JAX) and another raises; compact serving is an
    Options field and builds."""
    cfg = tiny_model_config()
    assert T2S(cfg, 56, opts=cpu_options(), decode_recompute=True).decode_recompute
    assert T2S(cfg, 56, opts=cpu_options(remat="full")).opts.remat == "full"
    with pytest.raises(ValueError, match="remat"):
        cpu_options(remat="sometimes")
    assert T2S(cfg, 56, opts=cpu_options(compact_serving=True, w8a8=True)).opts.compact_serving


_SUBPROCESS = r"""
import sys
import torch
from vitxtgqa_tpu_torch import Options
from vitxtgqa_tpu_torch.models.t2s import T2S
from vitxtgqa_tpu_torch.serving import profiling  # noqa: F401
from vitxtgqa_tpu_torch.serving.engine import ServingEngine
from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

tl = {"hidden_size": 64, "num_hidden_layers": 1, "num_attention_heads": 4,
      "intermediate_size": 128}
cfg = {
    "text_bert": {**tl, "vocab_size": 128, "max_position_embeddings": 40},
    "obj": {"mmt_in_dim": 82}, "ocr": {"mmt_in_dim": 140}, "translayers": tl,
    "grounding": {"frame_topk": 2, "ocr_topk": 2, "frame_num": 8, "ocr_frame_num": 3,
                  "hidden_size": 64},
    "mmt": {**tl, "num_hidden_layers": 2},
    "classifier": {"ocr_max_num": 24, "ocr_ptr_net": {"hidden_size": 64, "query_key_size": 64}},
}
model = T2S(cfg, 56, opts=Options(device="cpu", kv_cache_int8=True)).init_weights(0)
b = synthetic_batch(batch=2, frames=8, ocr_per_frame=3, dec_steps=4, text_len=10,
                    video_feat_dim=32, fasttext_dim=16, phoc_dim=24, num_final_outputs=56,
                    text_vocab=128)
with ServingEngine(model, buckets=(2,)) as eng:
    out = eng.submit({k: v[0] for k, v in b.items()}).result(timeout=120)
assert out["pos_scores"].shape == (4, 56), out["pos_scores"].shape
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "yaml", "vitxtgqa_tpu")))
"""


def test_port_runs_without_jax_flax_or_the_jax_package(repo_root):
    """Importing the port and serving the tiny slice on CPU loads no jax,
    flax, optax, yaml or vitxtgqa_tpu module (a subprocess: this test
    process imports jax through conftest)."""
    proc = subprocess.run([sys.executable, "-c", _SUBPROCESS], cwd=repo_root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout
