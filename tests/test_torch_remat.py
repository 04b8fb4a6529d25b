"""The port's remat modes (Options.remat: none, attn, attn_qkv, dots, full)
against the JAX package's (set_remat), against each other, and over
ranks, on the CPU.

- Each mode's gradients against JAX's same mode on tests/test_remat.py's
  encoder (hidden 32, 4 heads, 10 tokens, an additive bias: the plain
  route) and on one at the kernels' routes (hidden 128, 2 heads of 64, 256
  keys with an 8-slot causal tail: AttentionFn and BlockTrainFn), float32,
  dropout 0: the input's and every parameter's gradient within 1e-4 of its
  largest entry plus 1e-3 relative (a key projection's bias left out: its
  gradient is 0 but for float32 rounding, since softmax ignores it, as
  tests/test_torch_tp.py leaves it).
- Each mode against "attn" in a T2S training step with every dropout at
  the config's rate (the port's own stream): the loss and every gradient
  equal bit for bit (the recomputes rerun the same operations on the same
  inputs and draws), and the dropout generator left in the same state.
- What each mode keeps and relaunches: AttentionFn's and BlockTrainFn's
  forward relaunches in the backward, the saved activations' bytes, and
  JAX's saved residuals (jax.ad_checkpoint.print_saved_residuals) as
  ops/attention.AttentionFn's table states them.
- "full" on two gloo ranks, tensor-parallel (the encoder with dropout) and
  sequence-parallel (a T2S step), against one process: outputs within
  2e-5, gradients within 1e-4 of their largest entry.
"""

import contextlib
import io
import os

import jax
import jax.ad_checkpoint
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_sp_ranks, torch_tp_ranks
from tests.test_torch_chip_smoke_u import _counting
from tests.test_torch_modules import _init, _rand
from tests.test_torch_train import LOSSES, _port_noise, _setup, _tensors
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.models import common as JC
from vitxtgqa_tpu.ops.masks import MaskSpec as JMaskSpec
from vitxtgqa_tpu.utils.synthetic import tiny_model_config
from vitxtgqa_tpu.utils.torch_convert import flatten
from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.models import common as TC
from vitxtgqa_tpu_torch.models.t2s import T2S
from vitxtgqa_tpu_torch.ops import attention as TA
from vitxtgqa_tpu_torch.ops import block_train as TBT
from vitxtgqa_tpu_torch.ops.masks import MaskSpec
from vitxtgqa_tpu_torch.utils.convert import bert_layer_entries, convert_entries

MODES = ("none", "attn", "attn_qkv", "dots", "full")
# name: (hidden, heads, FFN, tokens, decoder slots: None for an additive
# zero bias, as tests/test_remat.py's)
ENCODERS = {"plain": (32, 4, 64, 10, None), "kernel_routes": (128, 2, 256, 256, 8)}
LAYERS, B = 2, 2


def _encoder_inputs(name):
    hidden, heads, ffn, length, dec = ENCODERS[name]
    rng = np.random.default_rng(11)
    x, g = _rand(rng, B, length, hidden), _rand(rng, B, length, hidden)
    if dec is None:
        bias = np.zeros((B, 1, 1, length), np.float32)
        jb, tb = jnp.asarray(bias), torch.from_numpy(bias)
    else:
        km = np.ones((B, length), np.float32)
        km[1, length // 2:] = 0.0
        km[:, length - dec:] = 0.0
        jb = JMaskSpec(key_mask=jnp.asarray(km), dec_len=dec)
        tb = MaskSpec(key_mask=torch.from_numpy(km), dec_len=dec)
    kw = dict(hidden_size=hidden, num_hidden_layers=LAYERS, num_attention_heads=heads,
              intermediate_size=ffn, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return x, g, jb, tb, kw


def _jax_grads(name, mode, fused_grads=False):
    """(dx, {port name: gradient}) of sum(y * g) through the JAX encoder
    in training under set_remat(mode) (and set_fused_grads), and its
    params."""
    x, g, jb, _, kw = _encoder_inputs(name)
    enc = JC.TransformerEncoder(JC.TransformerConfig(**kw))
    params = _init(enc, jnp.asarray(x), jb)

    def loss(p, xx):
        y = enc.apply({"params": p}, xx, jb, False, rngs={"dropout": jax.random.key(2)})
        return jnp.sum(y * jnp.asarray(g))

    JC.set_remat(mode)
    JC.set_fused_grads(fused_grads)
    try:
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    finally:
        JC.set_remat(False)
        JC.set_fused_grads(False)
    entries = [e for i in range(LAYERS) for e in bert_layer_entries("", "", i)]
    grads = convert_entries(flatten(jax.tree_util.tree_map(np.asarray, gp)), entries)
    state = convert_entries(flatten(jax.tree_util.tree_map(np.asarray, params)), entries)
    return np.asarray(gx), {k: v.numpy() for k, v in grads.items()}, state


def _port_encoder(name, mode, state, opts=None):
    *_, kw = _encoder_inputs(name)
    enc = TC.TransformerEncoder(TC.TransformerConfig(**kw), opts or cpu_options(remat=mode))
    enc.load_state_dict(state)
    return enc


def check_encoder_against_jax(name, want_dx, want, enc):
    """The port encoder's training pass on ENCODERS[name]'s input: the
    input's and every parameter's gradient against JAX's (want_dx,
    want)."""
    x, g, _, tb, _ = _encoder_inputs(name)
    xg = torch.from_numpy(x).requires_grad_()
    (enc(xg, tb, train=True) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xg.grad.numpy(), want_dx, atol=1e-4 * np.abs(want_dx).max(),
                               rtol=1e-3)
    got = {k: p.grad.numpy() for k, p in enc.named_parameters()}
    assert sorted(got) == sorted(want)
    floor = 1e-5 * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        if not k.endswith("attention.self.key.bias"):
            np.testing.assert_allclose(got[k], w, atol=1e-4 * max(np.abs(w).max(), floor),
                                       rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_remat_mode_gradients_match_jax(name, mode):
    """The encoder's training pass under each mode: the input's and every
    parameter's gradient against JAX's under the same mode."""
    want_dx, want, state = _jax_grads(name, mode)
    check_encoder_against_jax(name, want_dx, want, _port_encoder(name, mode, state))


def _t2s_step(mode):
    """One T2S training step of the wide config (the flash route, the block
    kernels' gate, the text BERT's plain route) with every dropout at 0.1
    under remat ``mode``: (loss, gradients, the dropout generator's state
    after)."""
    _, nf, batch, noise, _ = _setup("wide")
    cfg = tiny_model_config(hidden=128, frames=8, ocr_per_frame=30)
    b, n = batch["text"].shape[0], batch["ocr_mask"].shape[1]
    model = T2S(cfg, nf, opts=cpu_options(remat=mode)).init_weights(0)
    gen = torch.Generator().manual_seed(4)
    out = model(_tensors(batch), _port_noise(noise, b, n), train=True, dropout_gen=gen)
    total = Losses(LOSSES).total(_tensors(batch), out)[0]
    total.backward()
    return (total.detach(), {k: p.grad for k, p in model.named_parameters()
                             if p.grad is not None}, gen.get_state())


@pytest.fixture(scope="module")
def attn_step():
    return _t2s_step("attn")


@pytest.mark.parametrize("mode", [m for m in MODES if m != "attn"])
def test_each_mode_equals_attn_bit_for_bit_with_dropout(mode, attn_step):
    """The recomputes relaunch the same operations on the same inputs and
    draws: the loss and every gradient equal "attn"'s bit for bit."""
    loss, grads, _ = _t2s_step(mode)
    want_loss, want, _ = attn_step
    assert torch.equal(loss, want_loss)
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        assert torch.equal(grads[k], w), k


def test_full_draws_from_the_generator_as_attn_does(attn_step):
    """Under "full" each layer draws its seeds and masks before the
    recompute region, which replays them: the dropout generator's state
    after a step is "attn"'s (and so every later layer's masks are)."""
    _, _, state = _t2s_step("full")
    assert torch.equal(state, attn_step[2])


def _attention_fn_case():
    h, d, dec, rate = 2, 128, 8, 0.1
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_rand(rng, 2, 256, d))
    ws = [torch.from_numpy(_rand(rng, d, d, scale=0.05)).requires_grad_() if i % 2 == 0
          else torch.from_numpy(_rand(rng, d, scale=0.05)).requires_grad_() for i in range(6)]
    km = torch.ones(2, 256)
    km[:, 256 - dec:] = 0.0
    g = torch.from_numpy(_rand(rng, 2, 256, d))
    return x, ws, km, dec, h, rate, torch.tensor([5]), g


def test_attention_fn_relaunches_the_flash_forward_under_dots_and_full(monkeypatch):
    """AttentionFn under each mode: the gradients equal "none"'s bit for bit,
    and the backward relaunches #1's forward exactly where the table says
    (dots, full)."""
    x, ws, km, dec, h, rate, seed, g = _attention_fn_case()
    counts = _counting(monkeypatch)
    got = {}
    for mode in MODES:
        xg = x.clone().requires_grad_()
        for w in ws:
            w.grad = None
        y = TA.AttentionFn.apply(xg, *ws, km, dec, h, rate, seed, mode, False, 0)
        before = counts["flash_attention_merged"]
        y.backward(g)
        got[mode] = ([xg.grad] + [w.grad.clone() for w in ws],
                     counts["flash_attention_merged"] - before)
    for mode, (grads, relaunched) in got.items():
        assert relaunched == (1 if mode in ("dots", "full") else 0), mode
        for a, w in zip(grads, got["none"][0]):
            assert torch.equal(a, w), mode


def test_block_train_fn_relaunches_its_forward_per_mode(monkeypatch):
    """BlockTrainFn: attn, attn_qkv and full keep x_q, ctx and the seed and
    relaunch #9a in the backward; none and dots keep the residuals; the
    gradients are equal bit for bit."""
    rng = np.random.default_rng(4)
    d, m, rows = 128, 256, 64
    mk = lambda *s, scale=0.05: torch.from_numpy(_rand(rng, *s, scale=scale))
    ws = [mk(d, d), mk(d), 1.0 + mk(d), mk(d), mk(m, d), mk(m), mk(d, m), mk(d), 1.0 + mk(d),
          mk(d)]
    xq, ctx, gy = mk(rows, d, scale=1.0), mk(rows, d, scale=1.0), mk(rows, d, scale=1.0)
    counts = _counting(monkeypatch)
    got = {}
    for mode in MODES:
        leaves = [t.clone().requires_grad_() for t in [xq, ctx] + ws]
        y = TBT.BlockTrainFn.apply(*leaves, 0.1, 1e-12, torch.tensor([7]), mode, False)
        before = counts["block_train_fwd"]
        y.backward(gy)
        got[mode] = ([t.grad for t in leaves], counts["block_train_fwd"] - before)
    for mode, (grads, relaunched) in got.items():
        assert relaunched == (1 if mode in TBT.RECOMPUTES else 0), mode
        for a, w in zip(grads, got["none"][0]):
            assert torch.equal(a, w), mode


def _saved_activation_bytes(mode):
    """The bytes a training pass of the kernel-routes encoder leaves saved
    for its backward, parameters aside (torch.autograd.graph's hooks)."""
    x, g, _, tb, kw = _encoder_inputs("kernel_routes")
    enc = TC.TransformerEncoder(TC.TransformerConfig(**kw), cpu_options(remat=mode))
    params = {p.data_ptr() for p in enc.parameters()}
    seen = {}

    def pack(t):
        if t.data_ptr() not in params:
            seen[t.data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = enc(torch.from_numpy(x).requires_grad_(), tb, train=True)
    y.backward(torch.from_numpy(g))
    return sum(seen.values())


def test_saved_activations_fall_from_none_to_attn_to_full():
    """none keeps the most, attn_qkv and dots less, attn less again, and
    full the layers' inputs alone."""
    saved = {mode: _saved_activation_bytes(mode) for mode in MODES}
    assert saved["none"] > saved["attn_qkv"] > saved["attn"] > saved["full"] > 0, saved
    assert saved["none"] > saved["dots"] > saved["attn"], saved
    *_, kw = _encoder_inputs("kernel_routes")
    x_bytes = B * ENCODERS["kernel_routes"][3] * kw["hidden_size"] * 4
    assert saved["full"] <= LAYERS * x_bytes + 4096, saved


def test_jax_saved_residuals_are_the_tables():
    """JAX's saved residuals of a training layer (its XLA attention on the
    CPU) under each mode, as AttentionFn's docstring reads them: attn keeps
    attn_ctx, attn_qkv q/k/v and attn_ctx, dots the products' outputs (no
    softmax or LayerNorm intermediate), full the arguments alone."""
    x, _, jb, _, kw = _encoder_inputs("kernel_routes")
    enc = JC.TransformerEncoder(JC.TransformerConfig(**dict(kw, num_hidden_layers=1)))
    params = _init(enc, jnp.asarray(x), jb)
    f = lambda p, xx: enc.apply({"params": p}, xx, jb, False,
                                rngs={"dropout": jax.random.key(2)}).sum()
    lines = {}
    for mode in MODES:
        JC.set_remat(mode)
        try:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                jax.ad_checkpoint.print_saved_residuals(f, params, jnp.asarray(x))
        finally:
            JC.set_remat(False)
        lines[mode] = [ln for ln in buf.getvalue().splitlines()
                       if ln and "from the argument" not in ln and "from a" not in ln]
    assert len(lines["full"]) == 0, lines["full"]
    assert len(lines["attn"]) == 1 and "TransformerLayer.__call__" in lines["attn"][0]
    assert len(lines["attn_qkv"]) == 4, lines["attn_qkv"]
    assert all("TransformerLayer.__call__" in ln for ln in lines["attn_qkv"])
    assert not any("normalization.py" in ln or "exp" in ln.split(" from ")[0]
                   for ln in lines["dots"]), lines["dots"]
    assert sum("Dense.__call__" in ln for ln in lines["dots"]) == 6, lines["dots"]
    assert len(lines["none"]) > len(lines["dots"]), lines["none"]


# ---------------------------------------------------------------------------
# "full" on two gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def full_on_ranks(tmp_path_factory):
    """Two worlds of two ranks in the background: the tensor-parallel
    encoder (tests/test_torch_tp.py's, dropout 0.1) and the
    sequence-parallel T2S step (tests/test_torch_sp.py's), each under remat
    "full"."""
    from tests.test_torch_sp import _t2s_inputs
    from tests.test_torch_tp import ENC_CFG, ENC_DEC, ENC_SEED, _encoder_inputs as tp_inputs

    state, x, km, g = tp_inputs()
    root = tmp_path_factory.mktemp("remat_ranks")
    os.makedirs(root / "tp")
    os.makedirs(root / "sp")
    tp = torch_tp_ranks.start(
        {"encoder": dict(kind="encoder", cfg=ENC_CFG, state=state, x=x, key_mask=km, g=g,
                         dec_len=ENC_DEC, drop_seed=ENC_SEED, opts={"remat": "full"})},
        root / "tp", world=2)
    case = dict(_t2s_inputs("train")[1], opts={"remat": "full"})
    try:
        sp = torch_sp_ranks.launch({"train": case}, root / "sp")
        yield tp.results(), sp, case
    finally:
        for p in tp.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _rel_close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, what


def test_full_on_two_tensor_parallel_ranks_equals_one_process(full_on_ranks):
    """The encoder split over two model ranks under "full" (the recompute
    region repeats the split forms' all-reduces and replays each rank's
    heads' dropout): output, input gradient and every parameter's gradient
    against one process under "full" (which equals "attn" bit for bit)."""
    from tests.test_torch_tp import ENC_CFG, ENC_DEC, ENC_SEED, _encoder_inputs as tp_inputs

    state, x, km, g = tp_inputs()
    enc = TC.TransformerEncoder(TC.TransformerConfig(**ENC_CFG), cpu_options(remat="full"))
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    xg = torch.from_numpy(x).requires_grad_()
    y = enc(xg, MaskSpec(key_mask=torch.from_numpy(km), dec_len=ENC_DEC), train=True,
            gen=torch.Generator().manual_seed(ENC_SEED))
    y.backward(torch.from_numpy(g))
    for r in full_on_ranks[0]:
        got = r["encoder"]
        np.testing.assert_allclose(got["y"], y.detach().numpy(), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got["dx"], xg.grad.numpy(), atol=2e-5, rtol=2e-5)
        for k, p in enc.named_parameters():
            if not k.endswith("attention.self.key.bias"):
                _rel_close(got["grads"][k], p.grad.numpy(), 1e-4, k)


def test_full_on_two_sequence_parallel_ranks_equals_one_process(full_on_ranks):
    """A T2S training step with the attention split over two sp ranks under
    "full" (the recompute repeats the all-gathers): scores, losses and every
    gradient against one process under "full"."""
    _, sp, case = full_on_ranks
    model = T2S(case["cfg"], case["nf"], bos_idx=2, opts=cpu_options(remat="full"))
    model.load_state_dict(case["state"])
    batch = _tensors(case["batch"])
    out = model(batch, tuple(torch.from_numpy(n) for n in case["noise"]), train=True)
    total, _ = Losses(case["losses"]).total(batch, out)
    total.backward()
    for r in sp:
        got = r["train"]
        np.testing.assert_allclose(got["total"], float(total.detach()), rtol=1e-5)
        for k in ("ref_scores", "pos_scores", "neg_scores"):
            np.testing.assert_allclose(got["scores"][k], out[k].detach().numpy(), atol=2e-5,
                                       rtol=2e-5, err_msg=k)
        for k, p in model.named_parameters():
            if p.grad is not None and not k.endswith("attention.self.key.bias"):
                _rel_close(got["grads"][k], p.grad.numpy(), 1e-4, k)
