"""MIST's parts in the port against the JAX package: the gumbel Selector,
an ISTA round with the OCR mask's padding to 25 ones (and its
``_pad_noise`` seam), the model at a grid of more than 25 OCR slots, and
a frame picked twice.

CPU, float32, every dropout at 0.  The gumbel and padding draws are
shared: tests/test_torch_zoo.NoiseQueue, keyed by (shape, kind, draw
index), one instance a framework, patched into the JAX module and passed
to the port as its noise source.  Tolerances: the Selector's picked
values within 1e-6 (float32 one-hot products), its indices and summed
one-hots exact; the OCR masks exact; the model's scores within 2e-5,
tokens and grounding exact, losses within 1e-5 relative.

A frame picked twice holds 2.0 in the frame mask, which enters the MMT's
key mask.  The port takes every entry > 0 as one allowed key, on every
path, as its kernels and the JAX package's Pallas kernels do; the JAX
package's XLA bias (1 - m) * -10000 gives that frame a +10000 bonus, the
reference's quirk (ROADMAP.md §3).  ``test_a_frame_picked_twice_is_one_
allowed_key`` plants such a pick and holds the port against JAX with its
bias builders under the kernels' rule (and shows that JAX's XLA bias
differs), on the plain route (128 rows) and the flash route (384 rows);
the other parity tests assert that their seeds pick no frame twice.  The
eval forward, the training forward with its gradients, the recompute
oracle and the converter at the zoo's tiny geometry are cases of
tests/test_torch_zoo.py and tests/test_torch_zoo_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_zoo import (NoiseQueue, assert_duplicate_free, binarize_jax_masks,
                                  jax_params, patch_jax_selector_noise, tensors, zoo_config)
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import synthetic_batch
from vitxtgqa_tpu.utils.torch_convert import unflatten

T = torch.from_numpy


def _selector_pair(topk, d=16, seed=0):
    """The port Selector with seeded weights and the JAX params carrying
    them."""
    from vitxtgqa_tpu_torch.models.mist import Selector

    sel = Selector(topk, d, d, d)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sel.named_parameters():
            scale = 1.0 if "norm" in name and name.endswith("weight") else 0.0
            p.copy_(scale + 0.3 * torch.randn(p.shape, generator=gen))
    flat = {}
    for tn, kind in (("linear_Q", "linear"), ("norm_Q", "ln"), ("linear_K", "linear"),
                     ("norm_K", "ln")):
        w, b = (getattr(sel, tn).weight.detach().numpy(), getattr(sel, tn).bias.detach().numpy())
        flat[f"{tn}/{'kernel' if kind == 'linear' else 'scale'}"] = w.T if kind == "linear" else w
        flat[f"{tn}/bias"] = b
    return sel, unflatten(flat)


def ista_probe(monkeypatch):
    """Record each ISTA round's outputs (frame picks, frame mask, OCR
    mask) of the port's MIST."""
    from vitxtgqa_tpu_torch.models import mist as PM

    rounds, real = [], PM.ISTA.forward

    def forward(self, *a):
        rounds.append(real(self, *a))
        return rounds[-1]

    monkeypatch.setattr(PM.ISTA, "forward", forward)
    return rounds


class PlantedQueue(NoiseQueue):
    """NoiseQueue whose gumbel draws over ``shape`` put +30 on frame
    ``frame`` of batch row 0: every pick of that row takes it."""

    def __init__(self, shape, frame=3, seed=5):
        super().__init__(seed)
        self.shape, self.frame = tuple(shape), frame

    def draw(self, shape, kind, index):
        x = super().draw(shape, kind, index)
        if kind == "gumbel" and tuple(shape) == self.shape:
            x[0, self.frame] += 30.0
        return x


@pytest.mark.parametrize("planted", [False, True])
def test_selector_matches_jax(planted, monkeypatch):
    """The gumbel Selector over softmaxed scores, with replacement: the
    picked values, their indices and the summed straight-through one-hots
    (2.0 where row 0 picks its planted key twice)."""
    from vitxtgqa_tpu.models.mist import Selector as JSelector

    b, l, topk = 3, 6, 3
    sel, params = _selector_pair(topk)
    rng = np.random.default_rng(1)
    q, keys = rng.standard_normal((b, 1, 16)), rng.standard_normal((b, l, 16))
    values = rng.standard_normal((b, l, 4, 16))
    q, keys, values = (x.astype(np.float32) for x in (q, keys, values))
    queue = (lambda: PlantedQueue((b, l))) if planted else NoiseQueue
    patch_jax_selector_noise(monkeypatch, "mist", queue=queue())
    want = JSelector(topk=topk, dim=16).apply({"params": params}, q, keys, values,
                                               rngs={"gumbel": jax.random.key(0)})
    with torch.no_grad():
        got = sel(T(q), T(keys), T(values), queue())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[2].sum(-1).numpy(), topk, rtol=1e-6)
    if planted:
        assert got[1][0].tolist() == [3] * topk and float(got[2][0, 3]) == pytest.approx(topk)


@pytest.mark.parametrize("frames,opf", [(10, 3), (8, 3)], ids=["30_slots", "24_slots"])
def test_ista_pads_the_ocr_mask_to_25_ones(frames, opf, monkeypatch):
    """An ISTA round against JAX's on shared noise: the frame picks, the
    frame mask and the OCR mask, whose ones are the picked slots padded at
    random to exactly min(25, F * O)."""
    from vitxtgqa_tpu.models.mist import ISTA as JISTA
    from vitxtgqa_tpu_torch.models.mist import ISTA

    b, d, ft, ot = 2, 16, 2, 2
    ista = ISTA(ft, ot, frames, opf, d, d)
    seg, seg_p = _selector_pair(ft, d, seed=1)
    reg, reg_p = _selector_pair(ot, d, seed=2)
    ista.seg_selector.load_state_dict(seg.state_dict())
    ista.reg_selector.load_state_dict(reg.state_dict())
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, 1, d)).astype(np.float32)
    seg_feat = rng.standard_normal((b, frames, d)).astype(np.float32)
    video_o = rng.standard_normal((b, frames, opf, d)).astype(np.float32)
    patch_jax_selector_noise(monkeypatch, "mist")
    want = JISTA(frame_topk=ft, ocr_topk=ot, frame_num=frames, ocr_frame_num=opf,
                 d_model=d).apply({"params": {"seg_selector": seg_p, "reg_selector": reg_p}},
                                  q, seg_feat, video_o, rngs={"gumbel": jax.random.key(0)})
    with torch.no_grad():
        got = ista(T(q), T(seg_feat), T(video_o), NoiseQueue())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mask = got[2].numpy()
    assert (mask.sum(-1) == min(25, frames * opf)).all() and set(np.unique(mask)) <= {0.0, 1.0}


def test_pad_noise_is_the_padding_seam(monkeypatch):
    """``_pad_noise`` decides the padding: pinned on both sides to a
    descending-index tie-break, the padded ones are the lowest slots the
    picks left free (so at most the 2 x 2 picks lie past slot 25), in the
    port as in JAX."""
    pinned = lambda shape: np.broadcast_to(
        1.0 - np.arange(shape[1], dtype=np.float32) / (shape[1] + 1.0), tuple(shape)).copy()
    rounds = ista_probe(monkeypatch)
    got, want, _ = _mist_eval(monkeypatch, 10, 4, pad=pinned)
    _assert_mist_matches(got, want)
    mask = rounds[-1][2].numpy()
    assert (mask.sum(-1) == 25).all() and (mask[:, 25:].sum(-1) <= 2 * 2).all()


def _mist_eval(monkeypatch, frames, opf, seed=2, pad=None):
    """The port's MIST eval forward on a tiny batch of frames x opf slots,
    and JAX's on the same weights and noise (``pad``: both ``_pad_noise``
    seams pinned to pad(shape)): (port outputs, JAX outputs, batch)."""
    import vitxtgqa_tpu.models.mist as JM
    from vitxtgqa_tpu.models.mist import MIST as JMIST
    from vitxtgqa_tpu_torch.models import mist as PM
    from vitxtgqa_tpu_torch.models.mist import MIST

    cfg = zoo_config("mist", frames=frames, ocr_per_frame=opf)
    n = frames * opf
    nf = 32 + n
    batch = synthetic_batch(batch=3, frames=frames, ocr_per_frame=opf, dec_steps=4, text_len=10,
                            video_feat_dim=32, fasttext_dim=16, phoc_dim=24, num_final_outputs=nf,
                            text_vocab=128, seed=seed)
    model = MIST(cfg, nf, opts=cpu_options()).init_weights(seed)
    patch_jax_selector_noise(monkeypatch, "mist")
    if pad is not None:
        monkeypatch.setattr(JM, "_pad_noise", lambda rng, shape: jnp.asarray(pad(shape)))
        monkeypatch.setattr(PM, "_pad_noise", lambda gumbel, shape, device: T(pad(shape)))
    jm = JMIST(config=cfg, num_final_outputs=nf, bos_idx=2)
    want = jax.jit(lambda p, bt: jm.apply({"params": p}, bt, train=False,
                                          rngs={"gumbel": jax.random.key(0)}))(
        jax_params(model, "mist"), batch)
    return model(tensors(batch), NoiseQueue()), want, batch


def _assert_mist_matches(got, want):
    np.testing.assert_allclose(got["pos_scores"].numpy(), np.asarray(want["pos_scores"]),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(got["pos_scores"].numpy().argmax(-1),
                                  np.asarray(want["pos_scores"]).argmax(-1))
    for k in ("ground_frame", "ground_box"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_eval_forward_pads_a_grid_of_40_slots_as_jax_does(monkeypatch):
    """The eval forward at 10 frames x 4 OCR slots (40 > 25: the padding
    picks 21 slots at random) against JAX on shared noise: scores, tokens,
    the 0-based frame picks and the 25 grounded boxes; the seed picks no
    frame twice."""
    got, want, _ = _mist_eval(monkeypatch, 10, 4)
    assert got["ground_box"].shape == (3, 25, 4)
    assert_duplicate_free(got)
    _assert_mist_matches(got, want)


# (frames, OCR slots a frame) of the two routes of the MMT's attention on
# the CPU: 10 + 8 + 24 + 4 decoder slots -> 128 rows (below MIN_KV: the
# additive bias); 10 + 8 + 240 + 4 -> 384 (the flash twin)
ROUTES = {"plain_route": (8, 3), "flash_route": (8, 30)}


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_frame_picked_twice_is_one_allowed_key(route, mode, monkeypatch):
    """Row 0's segment selector picks frame 3 twice in every round (planted
    noise), so its frame mask holds 2.0.  The port's eval forward (and
    training loss) equals JAX's with the bias builders under the kernels'
    rule (an entry > 0 is one allowed key), and differs from JAX's XLA
    bias, whose (1 - 2) * -10000 gives that frame a +10000 bonus in the
    encoder rows (its decode steps binarize, DecodeStepSpec): the scores
    by more than 50 times the tolerance."""
    from vitxtgqa_tpu.losses import Losses as JLosses
    from vitxtgqa_tpu.models.mist import MIST as JMIST
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.models import mist as PM
    from vitxtgqa_tpu_torch.ops import flash_attention as TFA

    frames, opf = ROUTES[route]
    b, nf = 3, 32 + frames * opf
    cfg = zoo_config("mist", frames=frames, ocr_per_frame=opf)
    batch = synthetic_batch(batch=b, frames=frames, ocr_per_frame=opf, dec_steps=4, text_len=10,
                            video_feat_dim=32, fasttext_dim=16, phoc_dim=24, num_final_outputs=nf,
                            text_vocab=128, seed=4)
    model = PM.MIST(cfg, nf, opts=cpu_options()).init_weights(4)
    params = jax_params(model, "mist")
    jm = JMIST(config=cfg, num_final_outputs=nf, bos_idx=2)
    planted = lambda: PlantedQueue((b, frames))
    losses = [dict(x) for x in cfg["losses"]]

    def jax_run(binarized):
        with pytest.MonkeyPatch.context() as mp:
            patch_jax_selector_noise(mp, "mist", queue=planted())
            if binarized:
                binarize_jax_masks(mp)
            if mode == "eval":
                return jm.apply({"params": params}, batch, train=False,
                                rngs={"gumbel": jax.random.key(0)})["pos_scores"]
            out = jm.apply({"params": params}, batch, train=True,
                           rngs={"dropout": jax.random.key(1), "gumbel": jax.random.key(2)})
            return out["pos_scores"], JLosses(losses).total(batch, out)[0]

    rounds, calls, twin = ista_probe(monkeypatch), [], TFA.flash_attention_merged_plain
    monkeypatch.setattr(TFA, "flash_attention_merged_plain",
                        lambda *a, **kw: calls.append(1) or twin(*a, **kw))
    out = model(tensors(batch), planted(), train=mode == "train")
    assert float(rounds[-1][1][0, 3].detach()) == pytest.approx(2.0)
    assert bool(calls) == (route == "flash_route")
    got = out["pos_scores"].detach().numpy()
    want, xla = jax_run(True), jax_run(False)
    if mode == "train":
        (want, want_loss), (xla, _) = want, xla
        loss = float(Losses(losses).total(tensors(batch), out)[0].detach())
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    want, xla = np.asarray(want), np.asarray(xla)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - xla).max() > 50 * 2e-5
