"""The port's compact training (Options.compact_train: True and "live")
against the JAX package's (set_compact_train), on the CPU.

The counterparts of tests/test_compact_train.py.  The wide config of
tests/test_torch_train.py (hidden 128, 8 frames of 30 OCR slots, every
dropout 0, the gumbel noise injected into both frameworks): the ref pass
runs the full 384-row sequence (the flash route), pos and neg the 128 rows
the grounding keeps.  Weights: the port's seeded init through
convert_t2s_like; gradients back through the port's converter.
Tolerances as tests/test_torch_train.py's: scores 2e-5, losses 1e-5
relative, each gradient 1e-4 of its largest entry plus 1e-3 relative.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_train import (
    LOSSES,
    _assert_grads_close,
    _jax_params,
    _patch_jax_gumbel,
    _port_noise,
    _setup,
    _tensors,
)
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.torch_convert import flatten
from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.models.t2s import T2S
from vitxtgqa_tpu_torch.utils.convert import from_jax_params

MODES = {"stop_grad": True, "live": "live"}
SCORES = ("ref_scores", "pos_scores", "neg_scores")


def _grounding_capture(model):
    """A list that receives the grounding's output dict at each forward
    (its gather lists name the kept copy slots)."""
    seen = []
    model.Grounding_Module.register_forward_hook(lambda mod, args, out: seen.append(out))
    return seen


def _port_step(compact, case="wide"):
    cfg, nf, batch, noise, _ = _setup(case)
    b, n = batch["text"].shape[0], batch["ocr_mask"].shape[1]
    model = T2S(cfg, nf, bos_idx=2, opts=cpu_options(compact_train=compact)).init_weights(0)
    seen = _grounding_capture(model)
    out = model(_tensors(batch), _port_noise(noise, b, n), train=True)
    total, parts = Losses(LOSSES).total(_tensors(batch), out)
    total.backward()
    grads = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
             for k, p in model.named_parameters()}
    return model, out, total, parts, grads, seen[0]


@pytest.fixture(scope="module", params=sorted(MODES))
def compact_run(request):
    """(mode, the JAX (total, parts, out, grads), the port's (model, out,
    total, parts, grads, grounding)) of one training step under the mode."""
    from vitxtgqa_tpu.losses import Losses as JLosses
    from vitxtgqa_tpu.models.common import set_compact_train
    from vitxtgqa_tpu.models.t2s import T2S as JT2S

    mode = MODES[request.param]
    cfg, nf, batch, noise, _ = _setup("wide")
    port = _port_step(mode)
    jm = JT2S(config=cfg, num_final_outputs=nf, bos_idx=2, train_variant_scan=True)
    jlosses = JLosses(LOSSES)

    def loss_fn(p):
        out = jm.apply({"params": p}, batch, train=True,
                       rngs={"dropout": jax.random.key(1), "gumbel": jax.random.key(2)})
        total, parts = jlosses.total(batch, out)
        return total, (parts, out)

    with pytest.MonkeyPatch.context() as mp:
        _patch_jax_gumbel(mp, noise)
        set_compact_train(mode)
        try:
            (total, (parts, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                _jax_params(port[0]))
        finally:
            set_compact_train(False)
    want_grads = {k: v.numpy() for k, v in from_jax_params(
        flatten(jax.tree_util.tree_map(np.asarray, grads))).items()}
    return request.param, (total, parts, out, want_grads), port


def test_compact_train_scores_match_jax(compact_run):
    """ref, pos and neg scores (pos / neg on the kept rows, the never-kept
    copy slots filled from ref) within 2e-5 of JAX's."""
    _, (_, _, want, _), (_, out, *_) = compact_run
    for k in SCORES:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want[k]), atol=2e-5,
                                   rtol=2e-5, err_msg=k)


def test_compact_train_losses_and_grads_match_jax(compact_run):
    """Both losses within 1e-5 and every parameter's gradient within 1e-4
    (the fill's gradient reaching the trunk under "live" only)."""
    _, (want_total, want_parts, _, want_grads), (_, _, total, parts, grads, _) = compact_run
    for k, v in parts.items():
        np.testing.assert_allclose(float(v.detach()), float(want_parts[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-5)
    _assert_grads_close(grads, want_grads, 1e-4, 1e-3)


def test_compact_train_gradient_structure(compact_run):
    """Finite everywhere, nonzero on the MMT trunk, and the grounding's
    parameters zero-grad exactly where JAX's are (the reference's hard
    top-k: tests/test_compact_train.py)."""
    _, (*_, want_grads), (_, _, _, _, grads, _) = compact_run
    trunk = 0.0
    for name, g in grads.items():
        assert np.isfinite(g).all(), name
        if "Grounding_Module" in name:
            assert (np.abs(g).sum() == 0.0) == (np.abs(want_grads[name]).sum() == 0.0), name
        elif name.startswith("mmt."):
            trunk += float(np.abs(g).sum())
    assert trunk > 0.0
    assert all(np.abs(g).sum() == 0.0 for k, g in grads.items() if "Grounding_Module" in k)


def _kept(g, pfx, n):
    ci = g[f"{pfx}_ocr_idx"].numpy()
    kept = np.zeros((ci.shape[0], n), bool)
    for b in range(ci.shape[0]):
        kept[b, ci[b][ci[b] >= 0]] = True
    return kept


def test_compact_train_kept_rows_equal_the_full_pass(compact_run):
    """The port's compact step against its full step on the same inputs:
    ref equal; pos / neg fixed-vocabulary scores and kept copy slots equal
    within 2e-5; the never-kept slots exactly the ref pass's scores; the
    grounding untouched."""
    _, _, (_, out, _, _, _, g) = compact_run
    _, full, *_, g_full = _port_step(False)
    nv = out["ref_scores"].shape[-1] - g["pos_ocr_mask"].shape[1]
    ref = out["ref_scores"].detach().numpy()
    np.testing.assert_allclose(ref, full["ref_scores"].detach().numpy(), atol=2e-5, rtol=2e-5)
    for pfx in ("pos", "neg"):
        cs, fs = out[f"{pfx}_scores"].detach().numpy(), full[f"{pfx}_scores"].detach().numpy()
        kept = _kept(g, pfx, cs.shape[-1] - nv)
        assert kept.any() and not kept.all(), pfx
        kept3 = np.broadcast_to(kept[:, None, :], cs[..., nv:].shape)
        np.testing.assert_allclose(cs[..., :nv], fs[..., :nv], atol=2e-5, rtol=2e-5, err_msg=pfx)
        np.testing.assert_allclose(cs[..., nv:][kept3], fs[..., nv:][kept3], atol=2e-5,
                                   rtol=2e-5, err_msg=pfx)
        np.testing.assert_array_equal(cs[..., nv:][~kept3], ref[..., nv:][~kept3], err_msg=pfx)
    np.testing.assert_array_equal(out["ground_frame"].numpy(), full["ground_frame"].numpy())
    for k in ("pos_ocr_idx", "neg_ocr_idx"):
        np.testing.assert_array_equal(g[k].numpy(), g_full[k].numpy())


def test_the_ref_fill_takes_a_gradient_under_live_only(compact_run):
    """A loss on the never-kept copy slots of pos and neg alone: under True
    their fill is detached, so no parameter takes a gradient from it; under
    "live" it reaches the MMT through the ref pass."""
    mode, _, _ = compact_run
    cfg, nf, batch, noise, _ = _setup("wide")
    b, n = batch["text"].shape[0], batch["ocr_mask"].shape[1]
    model = T2S(cfg, nf, bos_idx=2, opts=cpu_options(compact_train=MODES[mode])).init_weights(0)
    seen = _grounding_capture(model)
    out = model(_tensors(batch), _port_noise(noise, b, n), train=True)
    loss = 0.0
    for pfx in ("pos", "neg"):
        kept = torch.from_numpy(_kept(seen[0], pfx, n))[:, None, :]
        dyn = out[f"{pfx}_scores"][..., nf - n:]
        loss = loss + torch.where(kept, torch.zeros_like(dyn), dyn).square().sum()
    loss.backward()
    moved = sum(float(p.grad.abs().sum()) for p in model.parameters() if p.grad is not None)
    assert (moved > 0.0) == (mode == "live"), moved


@pytest.mark.parametrize("value, want", [(True, True), ("live", "live"), ("LIVE", "live"),
                                         ("true", True), (False, False), ("false", False),
                                         ("none", False), ("0", False), ("", False),
                                         (None, False)])
def test_the_trainer_reads_compact_train_from_yaml(value, want, repo_root, monkeypatch):
    """training_parameters.tpu.compact_train of configs/t2s_abinet.yml, set
    on the command line as JAX's trainer takes it, reaches Options and the
    trainer's log lines; a T2S built with it takes the compact branch."""
    from vitxtgqa_tpu_torch.core.config import build_config
    from vitxtgqa_tpu_torch.training.trainer import arm_lines, options_from_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = build_config(f"{repo_root}/configs/t2s_abinet.yml",
                       opts=["training_parameters.device", "cpu",
                             "training_parameters.tpu.compact_train", value])
    opts = options_from_config(cfg.training_parameters)
    assert opts.compact_train == want
    lines = [ln for ln in arm_lines(opts) if "compact training" in ln]
    assert len(lines) == (1 if want else 0)
    if want:
        assert ("live" if want == "live" else "stop-gradient") in lines[0]


@pytest.mark.parametrize("key", ["t2s", "t2s_wo_tg", "t2s_wo_sg"])
def test_compact_train_takes_the_gate_of_jax(key, monkeypatch):
    """The compact branch runs where JAX's does (t2s.py:303-308): training
    with compact_train on and both gather lists in the grounding's output.
    T2S takes it; the ablations' groundings give the pos list at most
    (wo_sg) or none (wo_tg), so they train in full."""
    from vitxtgqa_tpu_torch.core.registry import registry
    from vitxtgqa_tpu_torch.run import setup_imports

    setup_imports()
    cfg, nf, batch, _, _ = _setup("tiny")
    calls = []
    real = T2S._compact_train_scores
    monkeypatch.setattr(T2S, "_compact_train_scores",
                        lambda self, *a: calls.append(1) or real(self, *a))
    model = registry.get_model_class(key)(cfg, nf, bos_idx=2,
                                          opts=cpu_options(compact_train=True)).init_weights(0)
    out = model(_tensors(batch), torch.Generator().manual_seed(0), train=True)
    assert all(torch.isfinite(out[k]).all() for k in SCORES)
    assert len(calls) == (1 if key == "t2s" else 0)
