"""The port's smaller opt-in arms against the JAX package's, on the CPU:
the ``fused_grads`` switch (JAX's ``dense_mm`` custom VJP; the port maps it
onto no option, since its backward already accumulates the projections'
weight and bias gradients in float32), the compact-training fill of
models/base's ``_scatter_dynamic``, and
training/trainer.options_from_config on every value the JAX trainer takes
for remat, fused_grads and compact_train (and its ignored dense_mm /
split_dense keys).

Tolerances: float32 on both sides; the gradients as tests/test_torch_remat.py
holds each remat mode's (1e-4 of their largest entry plus 1e-3 relative),
the scatter exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_remat import _jax_grads, _port_encoder, check_encoder_against_jax
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.models import base as TB

# route: tests/test_torch_remat.py's encoder that takes it
ROUTES = {"flash": "kernel_routes", "plain": "plain"}


def _options(tpu):
    import types

    from vitxtgqa_tpu_torch.training.trainer import options_from_config

    return options_from_config(types.SimpleNamespace(device="cpu", batch_size=2,
                                                     tpu=dict(tpu)))


# ---------------------------------------------------------------------------
# fused_grads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fused_grads_gives_the_training_layers_gradients(route, monkeypatch):
    """A training encoder built from ``training_parameters.tpu`` with
    fused_grads on against JAX's under set_fused_grads (its projections
    through dense_mm, its block kernel off) and the same remat: the input's
    and every parameter's gradient.  "flash": AttentionFn and
    BlockTrainFn's backward (256 keys, a MaskSpec); "plain": autograd's
    projections (10 keys, an additive bias, the text BERT's route)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    name = ROUTES[route]
    opts = _options({"fused_grads": True, "remat": "attn", "compute_dtype": "float32"})
    want_dx, want, state = _jax_grads(name, "attn", fused_grads=True)
    check_encoder_against_jax(name, want_dx, want, _port_encoder(name, "attn", state, opts))


# ---------------------------------------------------------------------------
# the compact-training fill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("may_pad", [False, True])
def test_scatter_dynamic_with_a_fill_matches_jax(may_pad):
    """``_scatter_dynamic(..., fill=)``: the kept slots take the compact
    scores, the others the fill (compact training: the ref pass's scores),
    a -1 entry of a padded gather list leaving the fill; exact against
    JAX's."""
    from vitxtgqa_tpu.models.base import JointQAModel as JJoint

    rng = np.random.default_rng(5)
    b, s, n, full_n = 3, 4, 6, 20
    idx = np.stack([rng.permutation(full_n)[:n] for _ in range(b)]).astype(np.int32)
    if may_pad:
        idx[1, 3:] = -1
    dyn = rng.standard_normal((b, s, n)).astype(np.float32)
    fill = rng.standard_normal((b, s, full_n)).astype(np.float32)
    want = JJoint._scatter_dynamic(jnp.asarray(dyn), jnp.asarray(idx), full_n, may_pad,
                                   fill=jnp.asarray(fill))
    got = TB.JointQAModel._scatter_dynamic(torch.from_numpy(dyn), torch.from_numpy(idx), full_n,
                                           may_pad, fill=torch.from_numpy(fill))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kept = np.zeros((b, full_n), bool)
    for r in range(b):
        kept[r, idx[r][idx[r] >= 0]] = True
    np.testing.assert_array_equal(got.numpy()[~np.broadcast_to(kept[:, None], got.shape)],
                                  fill[~np.broadcast_to(kept[:, None], fill.shape)])


# ---------------------------------------------------------------------------
# options_from_config
# ---------------------------------------------------------------------------

# (training_parameters.tpu switches, the Options fields they give)
ARM_VALUES = {
    "remat_absent": ({}, dict(remat="none")),
    "remat_none": ({"remat": "none"}, dict(remat="none")),
    "remat_None": ({"remat": "None"}, dict(remat="none")),
    "remat_null": ({"remat": None}, dict(remat="none")),
    "remat_false": ({"remat": False}, dict(remat="none")),
    "remat_false_str": ({"remat": "false"}, dict(remat="none")),
    "remat_true": ({"remat": True}, dict(remat="full")),
    "remat_true_str": ({"remat": "True"}, dict(remat="full")),
    "remat_full": ({"remat": "full"}, dict(remat="full")),
    "remat_dots": ({"remat": "dots"}, dict(remat="dots")),
    "remat_attn": ({"remat": "attn"}, dict(remat="attn")),
    "remat_attn_upper": ({"remat": "ATTN"}, dict(remat="attn")),
    "remat_attn_qkv": ({"remat": "attn_qkv"}, dict(remat="attn_qkv")),
    # fused_grads maps onto no field: logged where on (arm_lines)
    "fused_grads_true": ({"fused_grads": True}, {}),
    "fused_grads_false": ({"fused_grads": False}, {}),
    "fused_grads_one": ({"fused_grads": 1}, {}),
    "compact_train_true": ({"compact_train": True}, dict(compact_train=True)),
    "compact_train_live": ({"compact_train": "live"}, dict(compact_train="live")),
    "compact_train_false": ({"compact_train": False}, dict(compact_train=False)),
    "compact_train_none_str": ({"compact_train": "none"}, dict(compact_train=False)),
    "compact_train_yes": ({"compact_train": "yes"}, dict(compact_train=True)),
    # JAX reads these keys nowhere: ignored, as there
    "dense_mm": ({"dense_mm": True}, {}),
    "split_dense": ({"split_dense": True}, {}),
}


@pytest.mark.parametrize("case", sorted(ARM_VALUES))
def test_options_from_config_reads_every_jax_value(case, monkeypatch):
    """training_parameters.tpu's remat, fused_grads and compact_train as the
    JAX trainer reads them (set_remat, set_fused_grads, set_compact_train)
    onto Options, with the trainer's log line of each arm on."""
    from vitxtgqa_tpu.models import common as JC
    from vitxtgqa_tpu_torch.training.trainer import arm_lines

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tpu, fields = ARM_VALUES[case]
    opts = _options(tpu)
    assert not hasattr(opts, "fused_grads")
    for k, v in fields.items():
        assert getattr(opts, k) == v, k
    if "remat" in tpu and tpu["remat"] not in (None, False, "none", "None", "false"):
        JC.set_remat(tpu["remat"])
        try:
            jax_mode = JC._GLOBAL_REMAT
        finally:
            JC.set_remat(False)
        assert {True: "full"}.get(jax_mode, jax_mode) == opts.remat
    if "compact_train" in tpu:
        JC.set_compact_train(tpu["compact_train"])
        try:
            assert JC.compact_train_enabled() == opts.compact_train
        finally:
            JC.set_compact_train(False)
    if "fused_grads" in tpu:
        JC.set_fused_grads(tpu["fused_grads"])
        try:
            fused = JC.fused_grads_enabled()
        finally:
            JC.set_fused_grads(False)
        assert fused == bool(tpu["fused_grads"])
    lines = arm_lines(opts, tpu)
    fused = bool(tpu.get("fused_grads"))
    assert len(lines) == ((opts.remat != "none") + fused + bool(opts.compact_train))
    assert any("fused dense grads" in ln for ln in lines) == fused


def test_an_unknown_remat_mode_raises():
    from vitxtgqa_tpu_torch.options import parse_remat

    with pytest.raises(ValueError, match="remat"):
        parse_remat("sometimes")
    with pytest.raises(ValueError, match="remat"):
        cpu_options(remat="sometimes")
    with pytest.raises(ValueError, match="compact_train"):
        cpu_options(compact_train="maybe")
