"""The port's recompute decode oracle (T2S(..., decode_recompute=True))
against the JAX package's, and the port's cached decode against it.

CPU, float32, the tiny and wide configs of tests/test_torch_train.py with
every dropout at 0 and the gumbel noise injected; the JAX model gets the
port's weights through convert_t2s_like.  Serving decodes the pos variant
with the full MMT at every step; full-eval stacks [ref; pos; neg] at 3B and
feeds the pos argmax to all three (the reference's loop).  Tolerances: the
greedy tokens and the grounding exact, every score within 2e-5 (float32 on
both sides, another summation order).  The port's KV-cached decode (bf16
cache geometry, float32 here) must choose the oracle's tokens, as JAX's
decode-trace parity test holds its own.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_train import (CASES, DEC_STEPS, _jax_params, _patch_jax_gumbel,
                                    _port_noise, _setup, _tensors)
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.models.t2s import T2S

MODES = ("serving", "full_eval")


def _port(cfg, nf, mode, **kw):
    return T2S(cfg, nf, bos_idx=2, opts=cpu_options(), inference_only=(mode == "serving"),
               **kw).init_weights(0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_recompute_decode_matches_jax(case, mode, monkeypatch):
    from vitxtgqa_tpu.models.t2s import T2S as JT2S

    cfg, nf, batch, noise, _ = _setup(case)
    b, n = batch["text"].shape[0], batch["ocr_mask"].shape[1]
    _patch_jax_gumbel(monkeypatch, noise)
    model = _port(cfg, nf, mode, decode_recompute=True)
    jm = JT2S(config=cfg, num_final_outputs=nf, bos_idx=2, decode_recompute=True,
              inference_only=(mode == "serving"))
    want = jax.jit(lambda p, bt: jm.apply({"params": p}, bt, train=False,
                                          rngs={"gumbel": jax.random.key(0)}))(
        _jax_params(model), batch)
    got = model(_tensors(batch), _port_noise(noise, b, n))
    keys = ("pos_scores",) if mode == "serving" else ("ref_scores", "pos_scores", "neg_scores")
    assert sorted(k for k in got if k.endswith("_scores")) == sorted(keys)
    for k in keys:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape == (b, DEC_STEPS, nf)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1), err_msg=k)
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5, err_msg=k)
    np.testing.assert_array_equal(got["ground_frame"].numpy(), np.asarray(want["ground_frame"]))
    np.testing.assert_array_equal(got["ground_box"].numpy(), np.asarray(want["ground_box"]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_cached_decode_chooses_the_oracles_tokens(case, mode):
    """The cached decode (encode once, a KV cache per MMT layer) and the
    oracle from the same weights and noise: pos tokens equal; pos scores,
    and in full-eval ref / neg (teacher-forced on the decoded tokens, where
    the oracle reran the loop), within 2e-5."""
    cfg, nf, batch, noise, _ = _setup(case)
    b, n = batch["text"].shape[0], batch["ocr_mask"].shape[1]
    oracle = _port(cfg, nf, mode, decode_recompute=True)
    cached = _port(cfg, nf, mode)
    want = oracle(_tensors(batch), _port_noise(noise, b, n))
    got = cached(_tensors(batch), _port_noise(noise, b, n))
    np.testing.assert_array_equal(got["pos_scores"].numpy().argmax(-1),
                                  want["pos_scores"].numpy().argmax(-1))
    for k in want:
        if k.endswith("_scores"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=2e-5, rtol=2e-5,
                                       err_msg=k)


# (batch, full-eval): the wide geometry of tests/test_torch_chip_smoke.py
# (joint sequence 384, width 128): the MMT passes reach the fused block's
# 2,048 rows at 6 sequences (serving at batch 6, full-eval's 3B at batch 2)
RECOMPUTE_LAUNCH_CASES = {"serving_b2": (2, False), "serving_b6": (6, False),
                          "full_eval_b2": (2, True)}


@pytest.mark.parametrize("case", sorted(RECOMPUTE_LAUNCH_CASES))
def test_expected_recompute_launches_count_the_kernel_calls(case, monkeypatch):
    """chip_smoke.expected_recompute_launches against the calls the oracle's
    forward makes on the CPU, where each wrapper runs its plain version
    (counted here)."""
    import chip_smoke as CS
    from tests.test_torch_chip_smoke import FRAMES, OCR_PF, PLAIN_OF
    from vitxtgqa_tpu.utils.synthetic import synthetic_batch, tiny_model_config

    b, full_eval = RECOMPUTE_LAUNCH_CASES[case]
    cfg = tiny_model_config(hidden=128, frames=FRAMES, ocr_per_frame=OCR_PF)
    nf = 32 + FRAMES * OCR_PF
    model = T2S(cfg, nf, opts=cpu_options(), inference_only=not full_eval,
                decode_recompute=True).init_weights(0)
    counts = {name: 0 for name in CS.REPLACES}

    def counting(fn, kernel):
        def call(*a, **kw):
            counts[kernel] += 1
            return fn(*a, **kw)
        return call

    for mod, plain, kernel in PLAIN_OF:
        monkeypatch.setattr(mod, plain, counting(getattr(mod, plain), kernel))
    batch = synthetic_batch(batch=b, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=4,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=nf, text_vocab=128, seed=0)
    model({k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()},
          torch.Generator().manual_seed(0))
    want = CS.expected_recompute_launches(cfg, b, model.opts, full_eval=full_eval, text_len=10,
                                          dec_len=4)
    assert counts == want and counts["flash_attention_merged"] == 1 + 4 * 2


@pytest.mark.parametrize("mode", MODES)
def test_decode_agreement_holds_the_oracles_scores(mode):
    """chip_smoke.decode_agreement (slice l's oracle check) on the tiny
    case: the cached decode against the oracle agrees on every token, with
    every score within 2e-5; a score moved by 0.2 on one step (pos, or ref
    in full-eval) or a NaN is out of tolerance."""
    import chip_smoke as CS

    cfg, nf, batch, noise, _ = _setup(sorted(CASES)[0])
    b, n = batch["text"].shape[0], batch["ocr_mask"].shape[1]
    outs = [_port(cfg, nf, mode, decode_recompute=r)(_tensors(batch), _port_noise(noise, b, n))
            for r in (True, False)]
    agree, diff0, diffs = CS.decode_agreement(*outs)
    keys = ["pos_scores"] + (["neg_scores", "ref_scores"] if mode == "full_eval" else [])
    assert agree == 1.0 and diff0 <= 2e-5 and sorted(diffs) == sorted(keys)
    assert all(d <= 2e-5 for d in diffs.values())
    for k in keys[-1:] + ["pos_scores"]:
        moved = dict(outs[1], **{k: outs[1][k].clone()})
        moved[k][0, 3] += 0.2 * torch.sign(moved[k][0, 3])
        assert CS.decode_agreement(outs[0], moved)[2][k] > CS.REFNEG_TOL, k
    nan = dict(outs[1], pos_scores=outs[1]["pos_scores"].clone())
    nan["pos_scores"][0, 0, 0] = float("nan")
    assert CS.decode_agreement(outs[0], nan)[1] == float("inf")
