"""TranSTR's parts in the port against the JAX package: the differentiable
top-k operators (ops/diff_topk.py), the DETR decoder (models/detr.py),
``_first_k_true``, and the model on the flash route.

CPU, float32.  The perturbed top-k runs on shared noise: JAX's
``jax.random.normal`` as diff_topk sees it is patched to return the test's
numbers, so that its custom_vjp's forward and backward both see them, and
the port takes the same tensor.  Tolerances: the top-k indicators (hard
and perturbed: means of exact one-hots) exact; the perturbed top-k's
gradient within 1e-6 of its largest entry (scatter sums against XLA's
einsum, another order); the Sinkhorn top-k and its gradient within 1e-5
(200 iterations in float32); the sine embedding within 1e-6 (float32
pow, sin and cos of two libraries); the DETR decoder's output and
weights within 2e-5; the model's scores within 2e-5, tokens and grounding
exact, losses within 1e-5 relative and gradients as
tests/test_torch_train.py holds them.  The eval forward, the training
forward with its gradients (through the perturbed top-k's estimator), the
recompute oracle and the converter at the zoo's tiny geometry are cases
of tests/test_torch_zoo.py and tests/test_torch_zoo_train.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import _assert_grads_close
from tests.test_torch_zoo import (NoiseQueue, jax_params, patch_jax_selector_noise, tensors,
                                  zoo_config)
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.ops import diff_topk as JDT
from vitxtgqa_tpu.utils.synthetic import synthetic_batch
from vitxtgqa_tpu.utils.torch_convert import _detr_decoder_entries, _emit, flatten, unflatten
from vitxtgqa_tpu_torch.ops import diff_topk as DT

T = torch.from_numpy


def _scores(b, n, seed=0, ties=True):
    """Random scores with planted ties (equal values at two indices)."""
    x = np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32)
    if ties:
        x[:, 3] = x[:, 1]
        x[0, :] = 0.5
    return x


@pytest.mark.parametrize("k", [1, 2, 3])
def test_hard_topk_indicator_matches_jax(k):
    """Columns one-hot the k largest entries in descending order; ties go
    to the lower index, as jax.lax.top_k breaks them (row 0 all equal)."""
    x = _scores(4, 9)
    want = np.asarray(JDT.hard_topk_indicator(jnp.asarray(x), k))
    np.testing.assert_array_equal(DT.hard_topk_indicator(T(x), k).numpy(), want)


def _jax_normal(noise):
    """diff_topk's ``jax`` with ``random.normal`` returning ``noise``."""
    return types.SimpleNamespace(lax=jax.lax, nn=jax.nn, random=types.SimpleNamespace(
        normal=lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype)))


@pytest.mark.parametrize("k", [1, 2])
def test_perturbed_topk_forward_and_gradient_match_jax(k, monkeypatch):
    """On shared noise: the indicator exactly (means of one-hots), and the
    gradient of a random cotangent through the port's autograd Function
    against JAX's custom_vjp (its backward regenerates the noise).  The
    backward keeps only [B, nS, k] tensors, not the [B, nS, L] draw."""
    b, n, n_s, sigma = 3, 20, 64, 0.05
    x = _scores(b, n, ties=False) * 0.05
    noise = np.random.default_rng(1).standard_normal((b, n_s, n)).astype(np.float32)
    g = np.random.default_rng(2).standard_normal((b, n, k)).astype(np.float32)
    monkeypatch.setattr(JDT, "jax", _jax_normal(noise))
    want, vjp = jax.vjp(lambda v: JDT.perturbed_topk(v, jax.random.key(0), k, n_s, sigma),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))

    xt = T(x).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        got = DT.perturbed_topk(xt, T(noise), k, n_s, sigma)
    got.backward(T(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert 0 < float(np.asarray(want).max()) and float(np.asarray(want).sum()) == pytest.approx(
        b * k)
    dx = np.asarray(want_dx)
    np.testing.assert_allclose(xt.grad.numpy(), dx, atol=1e-6 * np.abs(dx).max(), rtol=0)
    assert saved and all(tuple(s) == (b, n_s, k) for s in saved)


def test_perturbed_topk_draws_from_a_source():
    """The noise drawn from a generator or a callable source: the same as
    the tensor passed in."""
    x = T(_scores(2, 10, ties=False))
    noise = torch.randn((2, 16, 10), generator=torch.Generator().manual_seed(3))
    want = DT.perturbed_topk(x, noise, 2, 16)
    got = DT.perturbed_topk(x, torch.Generator().manual_seed(3), 2, 16)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    src = NoiseQueue()
    got = DT.perturbed_topk(x, NoiseQueue(), 2, 16)
    np.testing.assert_array_equal(got.numpy(), DT.perturbed_topk(
        x, T(src((2, 16, 10), "normal")), 2, 16).numpy())


def test_sinkhorn_topk_and_its_gradient_match_jax():
    x = _scores(3, 7, ties=False)
    g = np.random.default_rng(4).standard_normal((3, 7, 2)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: JDT.sinkhorn_topk(v, 2, epsilon=0.1, max_iter=200),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = T(x).requires_grad_(True)
    got = DT.sinkhorn_topk(xt, 2, epsilon=0.1, max_iter=200)
    got.backward(T(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_sine_position_embedding_matches_jax(normalize):
    mask = np.ones((2, 64), np.float32)
    mask[1, 40:] = 0.0
    for feats in (64, 96):
        want = np.asarray(JDT.sine_position_embedding(jnp.asarray(mask), feats,
                                                      normalize=normalize))
        got = DT.sine_position_embedding(T(mask), feats, normalize=normalize).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_detr_decoder_matches_jax():
    """The DETR stack (2 layers, 8 heads of 8, query positions, a key mask
    with masked keys): the output and the last cross-attention's
    head-averaged weights, from the port's seeded weights carried by
    vitxtgqa_tpu's own DETR name map."""
    from vitxtgqa_tpu.models.detr import DetrDecoder as JDetr
    from vitxtgqa_tpu_torch.models.base import Wrap
    from vitxtgqa_tpu_torch.models.detr import DetrDecoder

    d, heads, layers = 64, 8, 2
    port = Wrap(dec=DetrDecoder(d, heads, layers, dropout_rate=0.0))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in port.named_parameters():
            scale = 1.0 if "norm" in name and name.endswith("weight") else 0.0
            p.copy_(scale + 0.1 * torch.randn(p.shape, generator=gen))
    sd = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    flat = {}
    _emit(_detr_decoder_entries("dec", "dec", layers), sd, flat)
    params = unflatten(flat)["dec"]
    rng = np.random.default_rng(6)
    tgt, mem = (rng.standard_normal((2, n, d)).astype(np.float32) for n in (8, 10))
    pos = rng.standard_normal((2, 8, d)).astype(np.float32)
    km = np.ones((2, 10), np.float32)
    km[0, 6:] = 0.0
    want, want_w = JDetr(d, heads, layers, dropout=0.0).apply(
        {"params": params}, tgt, mem, jnp.asarray(km), jnp.asarray(pos))
    with torch.no_grad():
        got, got_w = port.dec(T(tgt), T(mem), T(km), T(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=2e-5, rtol=2e-5)
    assert float(got_w[0, :, 6:].abs().max()) == 0.0  # the masked keys weigh nothing
    assert sorted(flatten(params)) == sorted(k[len("dec/"):] for k in flat)


def test_first_k_true_matches_jax():
    from vitxtgqa_tpu.models.transtr import _first_k_true as jax_first_k
    from vitxtgqa_tpu_torch.models.transtr import _first_k_true

    mask = np.random.default_rng(0).random((6, 9)) > 0.7
    mask[0] = False
    mask[1] = True
    for k in (1, 2, 4):
        want = np.asarray(jax_first_k(jnp.asarray(mask), k))
        np.testing.assert_array_equal(_first_k_true(T(mask), k).numpy(), want)


# the flash-route geometry: 8 frames x 30 OCR slots, the MMT's rows 2 fused
# frames + 240 OCR slots + 4 decoder slots -> 256 (MIN_KV): the flash
# twin's route on the CPU, where an encoder row sees its 2 fused frames and
# at most kf * ko = 4 OCR slots
FLASH_FRAMES, FLASH_OPF = 8, 30


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_transtr_on_the_flash_route_matches_jax(mode, monkeypatch):
    """TranSTR with the MMT over 256 rows, which takes the flash route (the
    flash twin on the CPU, counted), on masks of at most 2 + 4 live keys a
    row, against JAX's XLA route: the eval forward (scores, tokens,
    grounding) and the training forward with its losses and every
    parameter's gradient on shared perturbed noise."""
    from vitxtgqa_tpu.losses import Losses as JLosses
    from vitxtgqa_tpu.models.transtr import TranSTR as JTranSTR
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.models.transtr import TranSTR
    from vitxtgqa_tpu_torch.ops import flash_attention as TFA
    from vitxtgqa_tpu_torch.utils.convert import from_jax_family_params

    cfg = zoo_config("transtr", frames=FLASH_FRAMES, ocr_per_frame=FLASH_OPF)
    n = FLASH_FRAMES * FLASH_OPF
    nf = 32 + n
    batch = synthetic_batch(batch=2, frames=FLASH_FRAMES, ocr_per_frame=FLASH_OPF, dec_steps=4,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=nf, text_vocab=128, seed=1)
    model = TranSTR(cfg, nf, opts=cpu_options()).init_weights(2)
    params = jax_params(model, "transtr")
    jm = JTranSTR(config=cfg, num_final_outputs=nf, bos_idx=2)
    calls, twin = [], TFA.flash_attention_merged_plain
    monkeypatch.setattr(TFA, "flash_attention_merged_plain",
                        lambda *a, **kw: calls.append(a[3]) or twin(*a, **kw))
    if mode == "eval":
        want = jax.jit(lambda p, bt: jm.apply({"params": p}, bt, train=False))(params, batch)
        got = model(tensors(batch))
        np.testing.assert_allclose(got["pos_scores"].numpy(), np.asarray(want["pos_scores"]),
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_array_equal(got["pos_scores"].numpy().argmax(-1),
                                      np.asarray(want["pos_scores"]).argmax(-1))
        for k in ("ground_frame", "ground_box"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert calls and all(km.shape[1] == 256 for km in calls)
        live = (calls[0][:, :-4] > 0).sum(1)
        assert int(live.max()) <= 2 + 4 and int(live.min()) >= 2
        return

    patch_jax_selector_noise(monkeypatch, "transtr")
    losses = [dict(x) for x in cfg["losses"]]
    jlosses = JLosses(losses)

    def loss_fn(p):
        out = jm.apply({"params": p}, batch, train=True,
                       rngs={"dropout": jax.random.key(1), "gumbel": jax.random.key(2)})
        return jlosses.total(batch, out)

    (want_total, want_parts), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    out = model(tensors(batch), NoiseQueue(), train=True)
    total, parts = Losses(losses).total(tensors(batch), out)
    total.backward()
    assert calls and all(km.shape[1] == 256 for km in calls)
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-5)
    want = {k: v.numpy() for k, v in from_jax_family_params(
        flatten(jax.tree_util.tree_map(np.asarray, want_grads)), "transtr").items()}
    got = {k: np.zeros_like(want[k]) if p.grad is None else p.grad.numpy()
           for k, p in model.named_parameters()}
    assert any(np.abs(v).max() > 0 for k, v in got.items() if k.startswith("VideoQAmodel.frame"))
    _assert_grads_close(got, want, 1e-4, 1e-3)
