"""The port's six legacy image-VQA models against the JAX package's: pythia,
pythia_question_only, pythia_image_only, lorra, ban and
top_down_bottom_up (vitxtgqa_tpu/models/legacy_vqa.py), and pythia on the
MMF section schema (an MFH combine, a weight-norm classifier, a bilstm
text embedding beside the attention one).

CPU, tiny widths (vocab 40, embed 8, hidden 16; 3 questions of 8 tokens,
6 + 7 boxes of 12 features, 4 OCR tokens of 10).  Once per case in the
module (``jax_reference``), every parameter of the JAX model (its shapes
from ``jax.eval_shape`` of the init) is drawn from a seeded generator
(biases and weight-norm scales too), converted by
utils/convert.from_jax_family_params and loaded into the port's model
(strict).  Held in float32: the eval forward's scores within 1e-5 of their
largest magnitude; the logit_bce loss of a training forward with dropout
off (the port's train=True without a generator, JAX's deterministic apply)
within 1e-5 relative, and every parameter's gradient within 1e-4 of its
largest entry plus 1e-4 relative (float32 sums in another order, through
14 recurrent steps).  Held with compute_dtype bfloat16 (pythia, lorra,
ban: the features rounded, ImageEmbedding's and BCNet's casts back to
bf16, float32 parameters and products): the scores, the loss and every
gradient against the JAX model's bfloat16 compute_dtype within 1e-5 of
the largest magnitude, as in float32 (the same roundings of the same
values; float32 sums in another order could move a bf16 rounding by one
unit where a value lies on a boundary, which these inputs do not hit:
they agree within 5e-7); the port's float32 scores lie further than that
from JAX's bfloat16 ones (3e-5 to 1.1e-4), so the check sees the
roundings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import cpu_options, fast_jit, one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.core.registry import registry as port_registry
from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.run import setup_imports
from vitxtgqa_tpu_torch.utils.convert import from_jax_family_params

B, T, K, K1, DV, N, DC, NOUT = 3, 8, 6, 7, 12, 4, 10, 11
CFG = {"vocab_size": 40, "embed_dim": 8, "hidden_dim": 16}
SCHEMA = dict(CFG, image_text_modal_combine={"type": "MFH", "params": {"hidden_dim": 16}},
              classifier={"type": "weight_norm", "params": {"hidden_dim": 20, "dropout": 0.3}},
              text_embeddings=[
                  {"type": "attention", "params": {
                      "hidden_dim": 16, "embedding_dim": 8, "num_layers": 1, "conv1_out": 6,
                      "conv2_out": 2, "kernel_size": 1, "padding": 0}},
                  {"type": "bilstm", "params": {"hidden_dim": 6, "num_layers": 2,
                                                "bidirectional": True, "rnn_type": "LSTM"}}])
# (case, registered key, config)
CASES = {"pythia": ("pythia", CFG), "pythia_question_only": ("pythia_question_only", CFG),
         "pythia_image_only": ("pythia_image_only", CFG), "lorra": ("lorra", CFG),
         "ban": ("ban", CFG), "top_down_bottom_up": ("top_down_bottom_up", CFG),
         "pythia_schema": ("pythia", SCHEMA)}
SCALE_TOL, GRAD_RTOL, TOL = 1e-4, 1e-4, 1e-5
# the cases also held in bfloat16, and their tolerance (of the largest
# magnitude)
BF16_CASES, BF16_TOL = ("ban", "lorra", "pythia"), 1e-5


def make_batch(seed=0):
    r = np.random.default_rng(seed)
    batch = {
        "text": r.integers(1, CFG["vocab_size"], (B, T)).astype(np.int64),
        "text_len": np.array([T, T - 3, 2]),
        "image_feature_0": r.standard_normal((B, K, DV)).astype(np.float32),
        "image_feature_1": r.standard_normal((B, K1, DV)).astype(np.float32),
        "image_info_0_max_features": np.array([K, 4, 2]),
        "context_feature_0": r.standard_normal((B, N, DC)).astype(np.float32),
        "order_vectors": np.eye(N, dtype=np.float32)[None].repeat(B, 0),
        "targets": (r.random((B, NOUT)) < 0.3).astype(np.float32) * r.random((B, NOUT)),
    }
    batch["image_feature_0"][1, 5] = 0.0  # a padded box: BAN's v_mask
    batch["order_vectors"][2, 2:] = 0.0
    return batch


def redraw(flat, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.uniform(0.5, 2.0, np.shape(v)) if k.endswith("g")
                else 0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in flat.items()}


def _unflat(flat):
    from flax.traverse_util import unflatten_dict

    return unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def _loss(scores, targets):
    """The JAX package's logit_bce (vitxtgqa_tpu/losses.py)."""
    from vitxtgqa_tpu.losses import logit_bce

    return logit_bce({"targets": targets}, {"scores": scores})


_REFS = {}


def jax_reference(case):
    """{dtype name: (converted weights, JAX scores, JAX loss, converted JAX
    gradients)}, float32 and, for BF16_CASES, bfloat16 (the model's
    compute_dtype) on the same weights, computed once per case and module
    under one jit."""
    if case in _REFS:
        return _REFS[case]
    import vitxtgqa_tpu.models.legacy_vqa  # noqa: F401
    from vitxtgqa_tpu.core.config import ConfigNode
    from vitxtgqa_tpu.core.registry import registry
    from vitxtgqa_tpu.utils.torch_convert import flatten

    key, cfg = CASES[case]
    batch = make_batch()
    dtypes = {"float32": jnp.float32}
    if case in BF16_CASES:
        dtypes["bfloat16"] = jnp.bfloat16
    models = {name: registry.get_model_class(key)(config=ConfigNode(cfg), num_final_outputs=NOUT,
                                                  compute_dtype=dt)
              for name, dt in dtypes.items()}
    # the parameters' shapes alone: every value is redrawn
    params = jax.eval_shape(lambda: models["float32"].init({"params": jax.random.key(0)}, batch,
                                                           train=False))["params"]
    flat = redraw(flatten(params), seed=len(case))
    tree = _unflat(flat)

    def loss_fn(p, model):
        scores = model.apply({"params": p}, batch, train=False)["scores"]
        return _loss(scores, jnp.asarray(batch["targets"])), scores

    # every dtype under one jit: one XLA compile, not one per op
    both = fast_jit(lambda p: {name: jax.value_and_grad(loss_fn, has_aux=True)(p, m)
                               for name, m in models.items()}, tree)
    conv = lambda f: {k: v.numpy() for k, v in from_jax_family_params(f, key).items()}
    weights = conv(flat)
    _REFS[case] = {name: (weights, np.asarray(scores, np.float32), float(loss),
                          conv(flatten(jax.tree_util.tree_map(np.asarray, grads))))
                   for name, ((loss, scores), grads) in both.items()}
    return _REFS[case]


def port_model(case, weights=None, **opts):
    setup_imports()
    key, cfg = CASES[case]
    tb = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    model = port_registry.get_model_class(key)(cfg, NOUT, opts=cpu_options(**opts), example=tb)
    if weights is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return model, tb


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_forward_equals_jax(case):
    weights, want, _, _ = jax_reference(case)["float32"]
    model, tb = port_model(case, weights)
    with torch.no_grad():
        got = model(tb)["scores"]
    assert got.dtype == torch.float32 and got.shape == (B, NOUT)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= TOL * scale


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_gradients_equal_jax(case):
    weights, _, want_loss, want_grads = jax_reference(case)["float32"]
    model, tb = port_model(case, weights)
    out = model(tb, None, train=True, dropout_gen=None)
    total, parts = Losses([{"type": "logit_bce"}], "vqa2").total(tb, out)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), want_loss, rtol=TOL)
    got = {k: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
           for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want_grads)
    top = max(np.abs(w).max() for w in want_grads.values())
    # the biases before a softmax, over the locations (the attention
    # transform's) or over the question tokens (the attention text
    # embedding's conv2): their gradient is float32 noise (softmax is
    # shift-invariant)
    noise = [k for k in want_grads
             if k.endswith(("image_attention_model.module.transform.bias", "conv2.bias"))]
    assert all(max(np.abs(got[k]).max(), np.abs(want_grads[k]).max()) < 1e-6 * top
               for k in noise)
    floor = 1e-5 * top
    for name, w in want_grads.items():
        if name in noise:
            continue
        np.testing.assert_allclose(got[name], w, atol=SCALE_TOL * max(np.abs(w).max(), floor),
                                   rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_equals_jax_bf16(case):
    """compute_dtype bfloat16 in both packages: the parameters stay float32
    in the port, as in JAX, and the scores, the loss and every gradient
    equal JAX's within BF16_TOL of the largest magnitude."""
    refs = jax_reference(case)
    weights, want, want_loss, want_grads = refs["bfloat16"]
    model, tb = port_model(case, weights, dtype=torch.bfloat16)
    assert model.opts.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        got = model(tb)["scores"].numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= BF16_TOL * scale
    # the float32 model is further from JAX's bf16: the roundings show
    assert float(np.abs(refs["float32"][1] - want).max()) > BF16_TOL * scale
    out = model(tb, None, train=True, dropout_gen=None)
    total, _ = Losses([{"type": "logit_bce"}], "vqa2").total(tb, out)
    total.backward()
    assert abs(float(total.detach()) - want_loss) <= BF16_TOL * abs(want_loss)
    top = max(np.abs(w).max() for w in want_grads.values())
    for name, p in model.named_parameters():
        got_g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        assert np.abs(got_g - want_grads[name]).max() <= BF16_TOL * top, name


def test_the_ablations_quirks():
    """question_only ignores the image and the text (its text is zeroed
    after the embedding): its scores are the classifier's text branch of
    fa_txt(0); image_only ignores the text."""
    weights, _, _, _ = jax_reference("pythia_question_only")["float32"]
    model, tb = port_model("pythia_question_only", weights)
    other = dict(tb, image_feature_0=tb["image_feature_0"] * 0 + 7.0,
                 text=(tb["text"] + 5) % CFG["vocab_size"])
    with torch.no_grad():
        a, b = model(tb)["scores"], model(other)["scores"]
    assert torch.equal(a, b) and torch.equal(a[0], a[1])
    assert not hasattr(model, "image_feature_embeddings_list_0_0")
    weights, _, _, _ = jax_reference("pythia_image_only")["float32"]
    model, tb = port_model("pythia_image_only", weights)
    with torch.no_grad():
        a = model(tb)["scores"]
        b = model(dict(tb, text=(tb["text"] + 5) % CFG["vocab_size"]))["scores"]
        c = model(dict(tb, image_feature_0=tb["image_feature_0"] + 1.0))["scores"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not hasattr(model.image_text_multi_modal_combine_layer.module, "fa_txt")


def test_the_registry_and_the_kernel_free_flag():
    setup_imports()
    for key in ("pythia", "pythia_question_only", "pythia_image_only", "lorra", "ban",
                "top_down_bottom_up"):
        cls = port_registry.get_model_class(key)
        assert cls.__module__ == "vitxtgqa_tpu_torch.models.legacy_vqa" and cls.KERNEL_FREE
    assert not getattr(port_registry.get_model_class("t2s"), "KERNEL_FREE", False)
    with pytest.raises(ValueError, match="example"):
        port_registry.get_model_class("ban")(CFG, NOUT, opts=cpu_options())


def test_seeded_init_and_dropout_streams():
    """init_weights is a function of the seed and starts every weight-norm
    scale at 1, as the JAX models do; in training, dropout draws from the
    generator (BAN's BCNet and classifier dropouts), and not without one;
    bf16 keeps float32 parameters, runs and stays finite."""
    a, tb = port_model("ban")
    b, _ = port_model("ban")
    a.init_weights(3), b.init_weights(3)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    scales = [p for n, p in a.named_parameters() if n.endswith((".g", ".h_mat_g"))]
    assert len(scales) > 5 and all(float(p.detach()) == 1.0 for p in scales)
    g = lambda: torch.Generator().manual_seed(5)
    with torch.no_grad():
        ev = a(tb)["scores"]
        t1 = a(tb, None, train=True, dropout_gen=g())["scores"]
        t2 = a(tb, None, train=True, dropout_gen=g())["scores"]
        t0 = a(tb, None, train=True, dropout_gen=None)["scores"]
    assert torch.equal(t1, t2) and not torch.equal(t1, ev) and torch.equal(t0, ev)
    bf, tb = port_model("lorra", dtype=torch.bfloat16)
    bf.init_weights(0)
    assert all(p.dtype == torch.float32 for p in bf.parameters())
    with torch.no_grad():
        out = bf(tb)["scores"]
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_an_unrunnable_text_embedding_raises():
    setup_imports()
    cfg = dict(CFG, text_embeddings=[{"type": "vocab", "params": {"embedding_dim": 8,
                                                                   "vocab_size": 40}}])
    tb = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    with pytest.raises(NotImplementedError, match="vocab"):
        port_registry.get_model_class("pythia")(cfg, NOUT, opts=cpu_options(), example=tb)
