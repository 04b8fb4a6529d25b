"""The training forward of the port's T2S-family zoo against the JAX
models: the train-mode scores, the losses and every parameter's gradient.

CPU, float32, the tiny configs of tests/test_torch_zoo.py with every
dropout at 0 and the gumbel noise injected.  The ablations train the three
contrastive variants (ref, pos, neg) with pos_bce and InfoNCE x 1000, JAX
with train_variant_scan as the production step does; M4C, T5-ViteVQA and
GT-box one teacher-forced pass with pos_bce.  Tolerances as
tests/test_torch_train.py: scores within 2e-5, losses within 1e-5
relative, each gradient within 1e-4 of its largest entry (floored at 1e-5
of the model's largest) plus 1e-3 relative.
"""

import jax
import numpy as np
import pytest

from tests.test_torch_train import _assert_grads_close
from tests.test_torch_zoo import (ABLATIONS, NF, ZOO, jax_cls, jax_params, patch_jax_gumbel,
                                  port_model, port_noise, tensors, zoo_batch, zoo_config,
                                  zoo_noise)
from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.torch_convert import flatten
from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.utils.convert import from_jax_family_params


@pytest.mark.parametrize("key", sorted(ZOO))
def test_train_forward_losses_and_grads_match_jax(key, monkeypatch):
    from vitxtgqa_tpu.losses import Losses as JLosses

    noise = zoo_noise()
    patch_jax_gumbel(monkeypatch, noise)
    cfg, batch = zoo_config(key), zoo_batch(key)
    losses = [dict(x) for x in cfg["losses"]]
    model = port_model(key)
    kw = {"train_variant_scan": True} if key in ABLATIONS else {}
    jm = jax_cls(key)(config=cfg, num_final_outputs=NF, bos_idx=2, **kw)
    jlosses = JLosses(losses)

    def loss_fn(p):
        out = jm.apply({"params": p}, batch, train=True,
                       rngs={"dropout": jax.random.key(1), "gumbel": jax.random.key(2)})
        total, parts = jlosses.total(batch, out)
        return total, (parts, out)

    (want_total, (want_parts, want_out)), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jax_params(model, key))

    out = model(tensors(batch), port_noise(noise), train=True)
    total, parts = Losses(losses).total(tensors(batch), out)
    total.backward()
    keys = ("ref_scores", "pos_scores", "neg_scores") if key in ABLATIONS else ("pos_scores",)
    assert sorted(k for k in out if k.endswith("_scores")) == sorted(keys)
    for k in keys:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want_out[k]), atol=2e-5,
                                   rtol=2e-5, err_msg=k)
    assert sorted(parts) == sorted(want_parts)
    for k, v in parts.items():
        np.testing.assert_allclose(float(v.detach()), float(want_parts[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-5)

    want = {k: v.numpy() for k, v in from_jax_family_params(
        flatten(jax.tree_util.tree_map(np.asarray, want_grads)), key).items()}
    got = {k: np.zeros_like(want[k]) if p.grad is None else p.grad.numpy()
           for k, p in model.named_parameters()}
    _assert_grads_close(got, want, 1e-4, 1e-3)
