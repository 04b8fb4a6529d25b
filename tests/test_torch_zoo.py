"""The port's T2S-family zoo (the wo_tg / wo_sg ablations, M4C with
post-hoc grounding, T5-ViteVQA, the GT-box oracle) against the JAX models.

CPU, float32, tiny config (utils/synthetic.tiny_model_config: hidden 64,
8 frames x 3 OCR slots, top-2 grounding) with every dropout at 0; weights
the port's seeded init converted by vitxtgqa_tpu's convert_t2s_like with
each model's family flags (utils/convert.FAMILY_FLAGS); the gumbel noise
numpy draws keyed by shape, patched into the JAX grounding and passed to
the port (tests/test_torch_train.py).  M4C's tiny config states its input
widths (obj 32, OCR 16 + 24): the port's projections take the config's,
the JAX ones infer theirs.  Tolerances: scores within 2e-5 (float32 on
both sides, another summation order), tokens and grounding exact, losses
within 1e-5 relative, gradients as tests/test_torch_train.py holds them
(1e-4 of each tensor's largest entry plus 1e-3 relative).

Here: the eval forward of each model; the ablations' full-eval and
compact paths on a batch planted so that wo_sg's gather lists are
-1-padded and wo_tg's grounded-frame list too; the compact gates against
JAX's; the -1 wraps; the recompute oracle against the cached decode; the
family converter.  The training forward and gradients are in
tests/test_torch_zoo_train.py, the runtime in tests/test_torch_zoo_runtime.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from tests.test_torch_t2s import _force_fused_decode
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import tiny_model_config
from vitxtgqa_tpu.utils.torch_convert import convert_t2s_like, unflatten
from vitxtgqa_tpu_torch.models.t2s_ablations import _first_k_true_indices, _scatter_ones
from vitxtgqa_tpu_torch.utils.convert import FAMILY_FLAGS, from_jax_family_params
from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

FRAMES, OPF, DEC_STEPS, TOPK = 8, 3, 4, 2
N = FRAMES * OPF
NF = 32 + N
# model key: (JAX class, port class), "module:Class"
ZOO = {
    "t2s_wo_tg": ("t2s_ablations:T2SWithoutTemporalGrounding",) * 2,
    "t2s_wo_sg": ("t2s_ablations:T2SWithoutSpatialGrounding",) * 2,
    "m4c": ("m4c:M4C",) * 2,
    "t5vitevqa": ("t5vitevqa:T5ViteVQA",) * 2,
    "gt_box": ("gt_box:GTBox",) * 2,
}
ABLATIONS = ("t2s_wo_tg", "t2s_wo_sg")


def _cls(package, path):
    mod, name = path.split(":")
    return getattr(importlib.import_module(f"{package}.models.{mod}"), name)


def jax_cls(key):
    return _cls("vitxtgqa_tpu", ZOO[key][0])


def port_cls(key):
    return _cls("vitxtgqa_tpu_torch", ZOO[key][1])


def zoo_config(key, dropout=False):
    """The tiny config with every dropout at 0 (``dropout=False``); M4C's
    with its input widths."""
    cfg = tiny_model_config(hidden=64, frames=FRAMES, ocr_per_frame=OPF, topk=TOPK)
    c = cfg.to_dict()
    if not dropout:
        for sect in ("text_bert", "translayers", "mmt", "encoder"):
            c[sect].update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        c["obj"]["dropout_prob"] = c["ocr"]["dropout_prob"] = 0.0
    if key == "m4c":
        c["obj"]["mmt_in_dim"], c["ocr"]["mmt_in_dim"] = 32, 16 + 24
    if key in ("m4c", "t5vitevqa", "gt_box"):
        c["losses"] = [{"type": "pos_bce_loss", "weight": 1.0}]
    return type(cfg)(c)


def zoo_batch(key, b=3, seed=0, planted=False):
    """The tiny synthetic batch (with the GT-box fields for gt_box);
    ``planted``: row 0 keeps one real frame (chip_smoke.collapse_ground_ids),
    so that its temporal top-2 takes a padding frame whose id 0 maps onto
    frame 1 (wo_sg's OCR gather list is then -1-padded), and its grounded
    frames fill at most one slot of two (wo_tg's list too)."""
    batch = synthetic_batch(batch=b, frames=FRAMES, ocr_per_frame=OPF, dec_steps=DEC_STEPS,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=NF, text_vocab=128, seed=seed,
                            gt_box=(key == "gt_box"))
    if planted:
        CS.collapse_ground_ids(batch, frames=1, ocr_per_frame=OPF)
    return batch


def zoo_noise(b=3):
    rng = np.random.default_rng(5)
    return {(b, 2, FRAMES): rng.gumbel(size=(b, 2, FRAMES)).astype(np.float32),
            (b, 2, N): rng.gumbel(size=(b, 2, N)).astype(np.float32)}


def patch_jax_gumbel(monkeypatch, noise):
    import vitxtgqa_tpu.models.grounding as G

    def jax_gumbel(r, logits, tau=1.0, axis=-1, hard=True):
        y = jax.nn.softmax((logits + jnp.asarray(noise[tuple(logits.shape)])) / tau, axis=axis)
        yh = jnp.put_along_axis(jnp.zeros_like(y), jnp.argmax(y, axis=axis, keepdims=True), 1.0,
                                axis=axis, inplace=False)
        return yh + y - jax.lax.stop_gradient(y)

    monkeypatch.setattr(G, "gumbel_softmax", jax_gumbel)


def port_noise(noise, b=3):
    return torch.from_numpy(noise[(b, 2, FRAMES)]), torch.from_numpy(noise[(b, 2, N)])


def tensors(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def serving_kw(key, inference_only=True):
    """The serving flag where the model has one (T2S and its ablations)."""
    return {"inference_only": inference_only} if key in ABLATIONS else {}


def port_model(key, cfg=None, seed=0, **kw):
    cfg = cfg if cfg is not None else zoo_config(key)
    opts = {k: kw.pop(k) for k in list(kw) if k in ("kv_cache_int8", "compact_serving")}
    return port_cls(key)(cfg, NF, bos_idx=2, opts=cpu_options(**opts), **kw).init_weights(seed)


def jax_params(model, key):
    # copies: JAX may alias a numpy array's memory on the CPU
    state = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return unflatten(convert_t2s_like(state, text_layers=1, qtv_layers=1, mmt_layers=2,
                                      **FAMILY_FLAGS[key]))


def jax_eval(key, cfg, params, batch, **kw):
    jm = jax_cls(key)(config=cfg, num_final_outputs=NF, bos_idx=2, **kw)
    return jax.jit(lambda p, bt: jm.apply({"params": p}, bt, train=False,
                                          rngs={"gumbel": jax.random.key(0)}))(params, batch)


def assert_outputs_match(got, want, keys=("pos_scores",)):
    for k in keys:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape == (got["pos_scores"].shape[0], DEC_STEPS, NF), k
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5, err_msg=k)
    np.testing.assert_array_equal(got["pos_scores"].numpy().argmax(-1),
                                  np.asarray(want["pos_scores"]).argmax(-1))
    np.testing.assert_array_equal(got["ground_frame"].numpy(), np.asarray(want["ground_frame"]))
    np.testing.assert_array_equal(got["ground_box"].float().numpy(),
                                  np.asarray(want["ground_box"]))
    assert int(got["frame_topk"]) == int(want["frame_topk"])
    assert int(got["ocr_topk"]) == int(want["ocr_topk"])


@pytest.mark.parametrize("key", sorted(ZOO))
def test_eval_forward_matches_jax(key, monkeypatch):
    """The eval forward (the ablations' serving forward): pos_scores within
    2e-5, tokens and the grounding outputs exact."""
    noise = zoo_noise()
    patch_jax_gumbel(monkeypatch, noise)
    batch = zoo_batch(key)
    model = port_model(key, **serving_kw(key))
    want = jax_eval(key, zoo_config(key), jax_params(model, key), batch, **serving_kw(key))
    got = model(tensors(batch), port_noise(noise))
    assert sorted(k for k in got if k.endswith("_scores")) == ["pos_scores"]
    assert_outputs_match(got, want)


def test_m4c_middle_frame_index_zero_wraps_as_jax_does(monkeypatch):
    """middel_frame_idx = 0 puts the middle frame at grid position -1: JAX
    gathers the last frame's slots there, and so must the port (its gather
    would read out of range, a device-side assert on the card).  Row 0's
    last frame holds valid OCR, so the boxes are not all zero."""
    batch = zoo_batch("m4c")
    batch["middel_frame_idx"][:] = 0
    batch["ocr_mask"][0, -OPF:] = 1.0
    model = port_model("m4c")
    want = jax_eval("m4c", zoo_config("m4c"), jax_params(model, "m4c"), batch)
    got = model(tensors(batch))
    assert_outputs_match(got, want)
    last = batch["ocr_bbox_coordinates"][0, -OPF:]
    assert np.abs(got["ground_box"][0].numpy()).sum() > 0
    assert all(any(np.array_equal(box, s) for s in last) for box in got["ground_box"][0].numpy())


# (inference_only, compact serving, batch, forced fused decode with the
# int8 cache) of the ablations' eval paths on the planted batch
EVAL_MODES = {
    "full_eval": (False, False, 3, False),
    "compact_serving": (True, True, 3, False),
    "compact_full_eval": (False, True, 3, False),
    "compact_serving_fused_b2": (True, True, 2, True),
}


@pytest.mark.parametrize("mode", sorted(EVAL_MODES))
@pytest.mark.parametrize("key", ABLATIONS)
def test_ablation_eval_paths_match_jax(key, mode, monkeypatch):
    """Full-eval and compact serving of the ablations on the planted batch
    against JAX: scores within 2e-5, tokens and grounding exact.  wo_tg
    returns no gather list, so both compact modes run the full decode;
    wo_sg compacts its serving decode, -1-padded lists through the
    trash-slot scatter (``fused_b2``: the step kernel's branch at batch 2
    with the int8 cache, JAX in Pallas interpret mode), and runs compact
    full-eval in full (no neg list)."""
    from vitxtgqa_tpu.models.common import set_compact_serving, set_kv_cache_int8

    inference_only, compact, b, fused = EVAL_MODES[mode]
    noise = zoo_noise(b)
    patch_jax_gumbel(monkeypatch, noise)
    if fused:
        _force_fused_decode(monkeypatch)
    set_kv_cache_int8(fused)
    set_compact_serving(compact)
    try:
        batch = zoo_batch(key, b=b, planted=True)
        model = port_model(key, inference_only=inference_only, compact_serving=compact,
                           kv_cache_int8=fused)
        want = jax_eval(key, zoo_config(key), jax_params(model, key), batch,
                        inference_only=inference_only)
    finally:
        set_compact_serving(False)
        set_kv_cache_int8(False)
    seen = []
    with CS.padded_scatter_probe(seen):
        got = model(tensors(batch), port_noise(noise, b))
    keys = ("pos_scores",) if inference_only else ("ref_scores", "pos_scores", "neg_scores")
    assert_outputs_match(got, want, keys)
    compacted = key == "t2s_wo_sg" and inference_only and compact
    # the compact decode scatters each step's copy scores, with -1 entries
    # in the planted row's list; nothing else scatters
    assert seen == ([(True, True)] * DEC_STEPS if compacted else [])
    if key == "t2s_wo_tg":
        assert (got["ground_frame"][0] == -1).any()  # the -1-padded frame list


@pytest.mark.parametrize("full_eval", [False, True], ids=["serving", "full_eval"])
@pytest.mark.parametrize("key", ("t2s",) + ABLATIONS)
def test_compact_gates_follow_jax(key, full_eval, monkeypatch):
    """Under compact serving the port compacts exactly where JAX does (its
    _compact_decode called, and the neg pass on gathered rows, counted in
    both packages; JAX traced by eval_shape): T2S in both modes, wo_sg's
    serving decode only, wo_tg never.  Without the gates' gather-list
    conditions the port raised KeyError on wo_tg and on wo_sg's
    full-eval."""
    from vitxtgqa_tpu.models.common import set_compact_serving
    from vitxtgqa_tpu.models.t2s import T2S as JT2S
    from vitxtgqa_tpu_torch.models.t2s import T2S as PT2S

    def count(cls, calls, monkeypatch):
        real = cls._compact_decode
        monkeypatch.setattr(cls, "_compact_decode",
                            lambda self, *a, **kw: calls.append(1) or real(self, *a, **kw))

    jcalls, pcalls = [], []
    count(JT2S, jcalls, monkeypatch)
    count(PT2S, pcalls, monkeypatch)
    batch = zoo_batch(key)
    jcls = (importlib.import_module("vitxtgqa_tpu.models.t2s").T2S if key == "t2s"
            else jax_cls(key))
    pcls = PT2S if key == "t2s" else port_cls(key)
    cfg = zoo_config(key)
    model = pcls(cfg, NF, opts=cpu_options(compact_serving=True),
                 inference_only=not full_eval).init_weights(0)
    jm = jcls(config=cfg, num_final_outputs=NF, bos_idx=2, inference_only=not full_eval)
    set_compact_serving(True)
    try:
        jax.eval_shape(lambda: jm.apply({"params": jax_params(model, key)}, batch, train=False,
                                        rngs={"gumbel": jax.random.key(0)}))
    finally:
        set_compact_serving(False)
    model(tensors(batch), torch.Generator().manual_seed(0))
    assert len(pcalls) == len(jcalls)
    assert len(jcalls) == (1 if key == "t2s" or (key == "t2s_wo_sg" and not full_eval) else 0)


def test_first_k_true_indices_and_the_wrap_match_jax():
    """_first_k_true_indices against JAX's on random masks with rows of
    fewer than k true entries (-1 padded), and the frame masks' scatter
    against JAX's ``.at[b, idx].set(1.0)``, which wraps -1 to the last
    column."""
    from vitxtgqa_tpu.models.t2s_ablations import _first_k_true_indices as jax_first_k

    rng = np.random.default_rng(0)
    mask = rng.random((6, 8)) > 0.7
    mask[0] = False
    mask[1, :] = False
    mask[1, 7] = True
    for k in (1, 2, 5):
        want = np.asarray(jax_first_k(jnp.asarray(mask), k))
        got = _first_k_true_indices(torch.from_numpy(mask), k).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got == -1).any()
        jmask = np.asarray(jnp.zeros((6, 8)).at[jnp.arange(6)[:, None], jnp.asarray(want)].set(1.0))
        np.testing.assert_array_equal(_scatter_ones(torch.from_numpy(got), 8).numpy(), jmask)
    assert _scatter_ones(torch.tensor([[-1, -1]]), 8)[0].tolist() == [0.0] * 7 + [1.0]


@pytest.mark.parametrize("key", sorted(ZOO))
def test_cached_decode_chooses_the_oracles_tokens(key):
    """The recompute oracle (decode_recompute=True: the full MMT at every
    step) and the cached decode from the same weights, batch and noise:
    tokens equal, scores within 2e-5; the grounding equal."""
    batch, noise = zoo_batch(key), zoo_noise()
    outs = [port_model(key, decode_recompute=r, **serving_kw(key))(tensors(batch),
                                                                    port_noise(noise))
            for r in (True, False)]
    want, got = outs
    np.testing.assert_array_equal(got["pos_scores"].numpy().argmax(-1),
                                  want["pos_scores"].numpy().argmax(-1))
    np.testing.assert_allclose(got["pos_scores"].numpy(), want["pos_scores"].numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_array_equal(got["ground_box"].numpy(), want["ground_box"].numpy())


@pytest.mark.parametrize("key", sorted(ZOO) + ["t2s", "T2S_human"])
def test_family_converter_inverts_convert_t2s_like(key):
    """convert_t2s_like with the model's flags, then the port's
    from_jax_family_params: the port's state dict back, every tensor
    exact, no name missing or left over."""
    cls_key = "gt_box" if key == "T2S_human" else key
    if key == "t2s":
        from vitxtgqa_tpu_torch.models.t2s import T2S

        model = T2S(zoo_config(key), NF, opts=cpu_options()).init_weights(3)
    else:
        model = port_model(cls_key, seed=3)
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    flat = convert_t2s_like(state, text_layers=1, qtv_layers=1, mmt_layers=2, **FAMILY_FLAGS[key])
    back = from_jax_family_params(flat, key)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_synthetic_gt_box_fields_follow_the_jax_zoo_test():
    """synthetic_batch(gt_box=True) adds the fields the JAX model-zoo test
    adds to its batch (tests/test_model_zoo.py ``_batch(extra_gt=True)``),
    with their dtypes and shapes and the same values but the random boxes
    (the sampled frames as the annotated ones, the detected masks and ids
    as the annotated ones); every other field stays as without it."""
    from tests.test_model_zoo import DEC, FRAMES as JF, NUM_FINAL, OPF as JOPF, _batch

    want = _batch(extra_gt=True)
    kw = dict(batch=2, frames=JF, ocr_per_frame=JOPF, dec_steps=DEC, text_len=10,
              video_feat_dim=32, fasttext_dim=16, phoc_dim=24, num_final_outputs=NUM_FINAL,
              text_vocab=128, seed=3)
    plain, got = synthetic_batch(**kw), synthetic_batch(gt_box=True, **kw)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if k == "ocr_bbox_list":
            assert (0.0 <= got[k]).all() and (got[k] < 1.0).all()
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    for k, v in plain.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
