"""The port's T2S training step and full-eval against the JAX package.

CPU, float32, tiny config (utils/synthetic.tiny_model_config) with every
dropout at 0, so that the two frameworks compute the same function; the
gumbel noise is injected (numpy draws keyed by shape, patched into the
JAX grounding, passed to the port as tensors), as tests/test_torch_t2s.py
does.  Weights: the port's seeded init, converted by vitxtgqa_tpu's
convert_t2s_like; gradients come back through the port's converter.

Tolerances: the train-mode scores within 2e-5 and the losses within 1e-5
relative (float32 on both sides, another summation order through ~8
layers); each parameter's gradient within 1e-4 of its largest entry plus
1e-3 relative (the InfoNCE weight of 1000 scales the cotangents up by
three orders), where that entry is floored at 1e-5 of the model's largest
gradient entry (the attention key biases have a gradient that is zero but
for rounding: softmax is shift-invariant); the optimizer's parameters
within 1e-6 after three steps (the same float32 arithmetic).  Also here:
the other routes through the training layers (remat "none", Options.plain,
the block's width gate closed) against the defaults, the Options device
default, the losses and schedule against JAX, and that no module of the
port imports JAX or the JAX package.
"""

import ast
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import synthetic_batch, tiny_model_config
from vitxtgqa_tpu.utils.torch_convert import convert_t2s_like, flatten, unflatten
from vitxtgqa_tpu_torch import Options
from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.models.t2s import T2S
from vitxtgqa_tpu_torch.ops import block_train as TBT
from vitxtgqa_tpu_torch.training import optim as TO
from vitxtgqa_tpu_torch.training.step import step_generators, train_step
from vitxtgqa_tpu_torch.utils.convert import from_jax_params

FRAMES, DEC_STEPS = 8, 4
LOSSES = [{"type": "pos_bce_loss", "weight": 1.0}, {"type": "InfoNCE", "weight": 1000}]


def _no_dropout_config(ocr_pf, hidden):
    cfg = tiny_model_config(hidden=hidden, frames=FRAMES, ocr_per_frame=ocr_pf)
    c = {k: (dict(v) if hasattr(v, "items") else v) for k, v in cfg.items()}
    for sect in ("text_bert", "translayers", "mmt", "encoder"):
        c[sect].update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    c["obj"]["dropout_prob"] = c["ocr"]["dropout_prob"] = 0.0
    return type(cfg)(c)


# (ocr per frame, hidden, batch, int8 cache): "wide" reaches the kernel
# gates as in tests/test_torch_t2s.py (a 384-row joint sequence: the flash
# route, AttentionFn; lane-aligned widths: BlockTrainFn)
CASES = {"tiny": (3, 64, 3, False), "wide": (30, 128, 2, True)}
# full-eval also under compact serving: the pos decode and the neg pass on
# the kept rows (28 + 4 decoder slots, 128 with the padding), ref full
FULL_EVAL_CASES = {**CASES, "compact_tiny": (3, 64, 3, False), "compact_wide": (30, 128, 2, True)}


def _setup(case, seed=0):
    ocr_pf, hidden, b, int8 = FULL_EVAL_CASES[case]
    cfg = _no_dropout_config(ocr_pf, hidden)
    n = FRAMES * ocr_pf
    nf = 32 + n
    batch = synthetic_batch(batch=b, frames=FRAMES, ocr_per_frame=ocr_pf, dec_steps=DEC_STEPS,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=nf, text_vocab=128, seed=seed)
    rng = np.random.default_rng(5)
    noise = {(b, 2, FRAMES): rng.gumbel(size=(b, 2, FRAMES)).astype(np.float32),
             (b, 2, n): rng.gumbel(size=(b, 2, n)).astype(np.float32)}
    return cfg, nf, batch, noise, int8


def _patch_jax_gumbel(monkeypatch, noise):
    import vitxtgqa_tpu.models.grounding as G

    def jax_gumbel(r, logits, tau=1.0, axis=-1, hard=True):
        y = jax.nn.softmax((logits + jnp.asarray(noise[tuple(logits.shape)])) / tau, axis=axis)
        yh = jnp.put_along_axis(jnp.zeros_like(y), jnp.argmax(y, axis=axis, keepdims=True), 1.0,
                                axis=axis, inplace=False)
        return yh + y - jax.lax.stop_gradient(y)

    monkeypatch.setattr(G, "gumbel_softmax", jax_gumbel)


def _jax_params(model):
    # copies: JAX may alias a numpy array's memory on the CPU, and the
    # port's optimizer then updates that memory in place while an
    # asynchronously dispatched JAX step still reads it
    state = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return unflatten(convert_t2s_like(state, text_layers=1, qtv_layers=1, mmt_layers=2))


def _tensors(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _port_noise(noise, b, n):
    return torch.from_numpy(noise[(b, 2, FRAMES)]), torch.from_numpy(noise[(b, 2, n)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_forward_losses_and_grads_match_jax(case, monkeypatch):
    """Train-mode ref/pos/neg scores, both losses and the gradient of
    every parameter against jax.value_and_grad of the JAX T2S
    (train_variant_scan, the production step's forward)."""
    from vitxtgqa_tpu.losses import Losses as JLosses
    from vitxtgqa_tpu.models.t2s import T2S as JT2S

    cfg, nf, batch, noise, _ = _setup(case)
    b, n = batch["text"].shape[0], batch["ocr_mask"].shape[1]
    _patch_jax_gumbel(monkeypatch, noise)
    model = T2S(cfg, nf, bos_idx=2, opts=cpu_options()).init_weights(0)
    jm = JT2S(config=cfg, num_final_outputs=nf, bos_idx=2, train_variant_scan=True)
    jlosses = JLosses(LOSSES)

    def loss_fn(p):
        out = jm.apply({"params": p}, batch, train=True,
                       rngs={"dropout": jax.random.key(1), "gumbel": jax.random.key(2)})
        total, parts = jlosses.total(batch, out)
        return total, (parts, out)

    (want_total, (want_parts, want_out)), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(_jax_params(model))

    out = model(_tensors(batch), _port_noise(noise, b, n), train=True)
    total, parts = Losses(LOSSES).total(_tensors(batch), out)
    total.backward()
    for k in ("ref_scores", "pos_scores", "neg_scores"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want_out[k]), atol=2e-5,
                                   rtol=2e-5, err_msg=k)
    for k, v in parts.items():
        np.testing.assert_allclose(float(v.detach()), float(want_parts[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-5)

    want = {k: v.numpy() for k, v in
            from_jax_params(flatten(jax.tree_util.tree_map(np.asarray, want_grads))).items()}
    got = {k: np.zeros_like(want[k]) if p.grad is None else p.grad.numpy()
           for k, p in model.named_parameters()}
    _assert_grads_close(got, want, 1e-4, 1e-3)


def _assert_grads_close(got, want, scale_tol, rtol):
    """Each gradient within scale_tol of its largest entry plus rtol
    relative, where that entry is floored at 1e-5 of the model's largest
    gradient entry (see the module docstring)."""
    assert sorted(got) == sorted(want)
    floor = 1e-5 * max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=scale_tol * max(np.abs(w).max(), floor),
                                   rtol=rtol, err_msg=name)


def _training_grads(**opts):
    """Every parameter's gradient of one training forward of the wide
    config with dropout on (the config's 0.1, one generator seed)."""
    _, nf, batch, noise, _ = _setup("wide")
    cfg = tiny_model_config(hidden=128, frames=FRAMES, ocr_per_frame=30)
    b, n = batch["text"].shape[0], batch["ocr_mask"].shape[1]
    model = T2S(cfg, nf, opts=cpu_options(**opts)).init_weights(0)
    out = model(_tensors(batch), _port_noise(noise, b, n), train=True,
                dropout_gen=torch.Generator().manual_seed(4))
    Losses(LOSSES).total(_tensors(batch), out)[0].backward()
    return {k: p.grad.numpy() for k, p in model.named_parameters() if p.grad is not None}


@pytest.fixture(scope="module")
def default_training_grads():
    return _training_grads()


# the other routes through the training layers: the same dropout bits (each
# draws its masks from the same seeds), so the same gradients, up to the
# summation order of autograd against the block's explicit backward (1e-4
# relative, 1e-5 of each gradient's largest entry, floored as above).
# "block_autograd" closes the block's width gate, so every block runs as
# plain autograd; "plain" is Options.plain, the oracle mode on the card.
@pytest.mark.parametrize("opts", [dict(remat="none"), dict(plain=True),
                                  dict(plain=True, remat="none"), "block_autograd"],
                         ids=["remat_none", "plain", "plain_remat_none", "block_autograd"])
def test_training_switches_give_the_same_gradients(opts, default_training_grads, monkeypatch):
    if opts == "block_autograd":
        monkeypatch.setattr(TBT, "kernel_ok", lambda d, m: False)
        opts = {}
    _assert_grads_close(_training_grads(**opts), default_training_grads, 1e-5, 1e-4)


@pytest.mark.parametrize("case", sorted(FULL_EVAL_CASES))
def test_full_eval_matches_jax(case, monkeypatch):
    """inference_only=False: the pos greedy decode, then ref and neg from
    one teacher-forced pass at 2B on the decoded tokens (compact: ref at B
    over the full sequence, neg at B on its kept rows); scores within 2e-5,
    tokens and grounding exact."""
    from vitxtgqa_tpu.models.common import set_compact_serving, set_kv_cache_int8
    from vitxtgqa_tpu.models.t2s import T2S as JT2S

    cfg, nf, batch, noise, int8 = _setup(case)
    b, n = batch["text"].shape[0], batch["ocr_mask"].shape[1]
    compact = case.startswith("compact")
    _patch_jax_gumbel(monkeypatch, noise)
    set_kv_cache_int8(int8)
    set_compact_serving(compact)
    model = T2S(cfg, nf, bos_idx=2, opts=cpu_options(kv_cache_int8=int8, compact_serving=compact),
                inference_only=False).init_weights(0)
    jm = JT2S(config=cfg, num_final_outputs=nf, bos_idx=2, inference_only=False)
    want = jax.jit(lambda p, bt: jm.apply({"params": p}, bt, train=False,
                                          rngs={"gumbel": jax.random.key(0)}))(
        _jax_params(model), batch)
    got = model(_tensors(batch), _port_noise(noise, b, n))
    for k in ("ref_scores", "pos_scores", "neg_scores"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape == (b, DEC_STEPS, nf)
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5, err_msg=k)
    np.testing.assert_array_equal(got["pos_scores"].numpy().argmax(-1),
                                  np.asarray(want["pos_scores"]).argmax(-1))
    np.testing.assert_array_equal(got["ground_frame"].numpy(), np.asarray(want["ground_frame"]))


# ---------------------------------------------------------------------------
# losses, schedule, optimizer
# ---------------------------------------------------------------------------


def test_losses_match_jax():
    from vitxtgqa_tpu.losses import Losses as JLosses

    rng = np.random.default_rng(0)
    out = {k: (rng.standard_normal((3, 4, 20)) * 3).astype(np.float32)
           for k in ("ref_scores", "pos_scores", "neg_scores")}
    batch = {"targets": (rng.random((3, 4, 20)) > 0.8).astype(np.float32),
             "train_loss_mask": np.array([[1, 1, 0, 0], [1, 0, 0, 0], [1, 1, 1, 1]], np.float32)}
    total, parts = Losses(LOSSES).total({k: torch.from_numpy(v) for k, v in batch.items()},
                                        {k: torch.from_numpy(v) for k, v in out.items()})
    jtotal, jparts = JLosses(LOSSES).total(batch, out)
    assert sorted(parts) == sorted(jparts)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    with pytest.raises(ValueError, match="not in the registry"):
        Losses([{"type": "nope"}])


def test_lr_multiplier_matches_jax_schedule():
    from vitxtgqa_tpu.training.optim import lr_multiplier_schedule

    for use_warmup in (True, False):
        kw = dict(use_warmup=use_warmup, warmup_factor=0.2, warmup_iterations=1000,
                  lr_steps=[10000, 20000], lr_ratio=0.1)
        want = lr_multiplier_schedule(**kw)
        for step in (0, 1, 500, 999, 1000, 1001, 9999, 10000, 19999, 20000, 23999):
            np.testing.assert_allclose(TO.lr_multiplier(step, *kw.values()), float(want(step)),
                                       rtol=1e-6, err_msg=f"{use_warmup} {step}")


def _tree_to_port(tree):
    """JAX param tree -> port-named numpy dict (the port's converter)."""
    return {k: v.numpy() for k, v in from_jax_params(flatten(tree)).items()}


def test_three_optimizer_steps_match_the_optax_chain():
    """Three clipped, scheduled Adam steps with the text_bert 0.1 scale on
    the tiny T2S parameters: the same numpy gradients into the port's
    build_optimizer and into JAX's build_optimizer chain."""
    from vitxtgqa_tpu.training.optim import build_optimizer as jax_build

    cfg, nf, _, _, _ = _setup("tiny")
    model = T2S(cfg, nf, opts=cpu_options()).init_weights(0)
    oa = types.SimpleNamespace(type="Adam", params={"lr": 1e-3, "eps": 1e-8, "weight_decay": 0})
    tp = types.SimpleNamespace(clip_gradients=True, max_grad_l2_norm=0.25, lr_scheduler=True,
                               lr_steps=[2], lr_ratio=0.1, use_warmup=True, warmup_factor=0.2,
                               warmup_iterations=1)
    tx, _ = jax_build(oa, tp, cfg)

    @jax.jit
    def step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), state

    params = _jax_params(model)
    state = tx.init(params)
    opt = TO.build_optimizer(model, oa, tp, cfg)
    rng = np.random.default_rng(3)
    named = dict(model.named_parameters())
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * 0.1).astype(np.float32), params)
        params, state = step(grads, state, params)
        for name, g in _tree_to_port(grads).items():
            named[name].grad = torch.from_numpy(g)
        opt.clip()
        opt.apply()
    want = _tree_to_port(jax.tree_util.tree_map(np.asarray, params))
    assert opt.count == 3
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6, rtol=1e-6,
                                   err_msg=name)


def test_lr_scale_naming_no_module_raises():
    model = torch.nn.Sequential(torch.nn.Linear(2, 2))
    with pytest.raises(ValueError, match="matches no module"):
        TO.Optimizer(model, lr=1e-3, scales={"text_bert": 0.1})


def test_bf16_parameters_step_a_float32_master_copy():
    lin = torch.nn.Linear(4, 4).to(torch.bfloat16)
    w0 = lin.weight.detach().float().clone()
    opt = TO.Optimizer(lin, lr=1e-3)
    for _ in range(2):
        lin.weight.grad = torch.ones_like(lin.weight)
        lin.bias.grad = torch.ones_like(lin.bias)
        opt.clip()
        opt.apply()
    master = opt.pairs[0][1]
    assert master.dtype == torch.float32 and lin.weight.dtype == torch.bfloat16
    np.testing.assert_allclose(master.numpy(), w0.numpy() - 2e-3, atol=1e-6)
    assert torch.equal(lin.weight, master.to(torch.bfloat16))


def test_train_step_updates_and_the_nan_tripwire_skips():
    cfg, nf, batch, noise, _ = _setup("tiny")
    b, n = batch["text"].shape[0], batch["ocr_mask"].shape[1]
    model = T2S(cfg, nf, opts=cpu_options()).init_weights(0)
    opt = TO.build_optimizer(model, model_config=cfg)
    losses = Losses(LOSSES)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    gens = step_generators(0, 0, "cpu")
    r = train_step(model, losses, opt, _tensors(batch), (gens[0], _port_noise(noise, b, n)))
    assert r["applied"] and np.isfinite(float(r["loss"])) and opt.count == 1
    assert any(not torch.equal(before[k], v) for k, v in model.state_dict().items())
    after = {k: v.clone() for k, v in model.state_dict().items()}
    bad = _tensors(batch)
    bad["video_feat"] = bad["video_feat"] * float("nan")
    r = train_step(model, losses, opt, bad, (gens[0], _port_noise(noise, b, n)))
    assert not r["applied"] and opt.count == 1
    assert all(torch.equal(after[k], v) for k, v in model.state_dict().items())
    assert all(p.grad is None for p in model.parameters())


def test_production_training_parameters_equal_the_yaml(repo_root):
    from vitxtgqa_tpu.core.config import build_config

    cfg = build_config(os.path.join(repo_root, "configs", "t2s_abinet.yml"))
    tp, oa = cfg.training_parameters, cfg.optimizer_attributes
    for k, v in TO.PRODUCTION_TRAINING.items():
        assert getattr(tp, k) == v, k
    assert oa.type == TO.PRODUCTION_OPTIMIZER["type"]
    for k, v in TO.PRODUCTION_OPTIMIZER["params"].items():
        assert float(oa.params[k]) == v, k
    t2s = cfg.model_attributes.t2s
    from vitxtgqa_tpu_torch.models.t2s import t2s_production_config

    assert TO.module_lr_scales(t2s_production_config()) == TO.module_lr_scales(t2s) == {
        "text_bert": 0.1}


# ---------------------------------------------------------------------------
# the device default and import hygiene
# ---------------------------------------------------------------------------


def test_options_default_to_the_card():
    assert Options().device.type == "cuda"
    assert Options(device="cpu").device.type == "cpu"
    cfg = tiny_model_config()
    if torch.cuda.is_available():
        assert next(T2S(cfg, 56).parameters()).is_cuda
    else:  # nothing falls back to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            T2S(cfg, 56)
    assert Options(remat="full").remat == "full"
    with pytest.raises(ValueError, match="remat"):
        Options(remat="sometimes")


def test_options_resolve_the_dtype_by_device():
    """The compute dtype defaults to bf16 on the card, whose kernels are
    bf16, and float32 on the CPU; float32 on the card raises unless the
    plain versions run (plain=True)."""
    assert Options().dtype == torch.bfloat16
    assert Options(device="cpu").dtype == torch.float32
    assert Options(device="cpu", dtype=torch.bfloat16).dtype == torch.bfloat16
    assert Options(dtype=torch.float32, plain=True).dtype == torch.float32
    with pytest.raises(ValueError, match="bf16"):
        Options(dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        Options(device="cuda:0", dtype=torch.float32)
    with pytest.raises(ValueError, match="compute dtype"):
        Options(device="cpu", dtype=torch.float16)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_port_module_imports_jax_or_the_jax_package(repo_root):
    """Every module of the port, and chip_smoke.py, imports no jax, flax,
    optax or vitxtgqa_tpu (statically: at any depth of the file)."""
    files = [os.path.join(repo_root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(repo_root, "vitxtgqa_tpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    assert len(files) > 20
    banned = ("jax", "jaxlib", "flax", "optax", "vitxtgqa_tpu")
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in banned, (path, mod)
