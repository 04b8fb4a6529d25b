"""The port's legacy image-VQA module library against the JAX package's:
the layers (vitxtgqa_tpu/models/layers.py), the attentions
(attention_legacy.py), the RNN mapping and the embeddings (embeddings.py)
and the encoders (encoders.py).

CPU, float32, tiny widths.  Each JAX module's parameters (their shapes
from ``jax.eval_shape`` of its init) are drawn from a seeded numpy
generator (biases and the weight-norm scales too, so that a bias in the
wrong gate or a norm over the wrong axis shows), converted by
utils/convert.py's legacy rules and loaded into the port's module, which
must then give the JAX output on the same inputs within 1e-5 of the
output's largest magnitude (float32 sums in another order; the RNNs'
gates run 2 x 7 steps).
"""

import pickle

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from tests.torch_helpers import fast_jit, one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.models import attention_legacy as PA
from vitxtgqa_tpu_torch.models import embeddings as PE
from vitxtgqa_tpu_torch.models import encoders as PEnc
from vitxtgqa_tpu_torch.models import layers as PL
from vitxtgqa_tpu_torch.utils.convert import convert_entries, legacy_entries

TOL = 1e-5
B, K, T, DV, DQ, H = 3, 5, 7, 12, 10, 8


def redraw(params, seed: int):
    """Every leaf of a flax tree (of arrays or of their shapes) redrawn:
    N(0, 0.5), weight-norm scales in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    flat = flatten_dict(params, sep="/")
    out = {}
    for k, v in flat.items():
        if k.endswith("g"):
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        else:
            out[k] = (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
    return out


def unflat(flat):
    from flax.traverse_util import unflatten_dict

    return unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def port_state(flat):
    """The JAX module's params (under a root "m") as the port module's
    state dict."""
    nested = {f"m/{k}": v for k, v in flat.items()}
    return {k[2:]: v for k, v in convert_entries(nested, legacy_entries(nested)).items()}


def held(jax_module, port_module, args, seed=0, method=None, port_call=None, **kw):
    """Init the JAX module on ``args``, redraw its params, load them into
    the port module (strict), and compare the outputs (each of a tuple)."""
    # the parameters' shapes alone: every value is redrawn
    params = jax.eval_shape(lambda: jax_module.init(jax.random.key(0), *args, method=method,
                                                    **kw))["params"]
    flat = redraw(params, seed)
    port_module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                                 port_state(flat).items()})
    # under one jit: one XLA compile, not one per op
    want = fast_jit(lambda p, *a: jax_module.apply({"params": p}, *a, method=method, **kw),
                    unflat(flat), *args)
    targs = [torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a for a in args]
    with torch.no_grad():
        got = (port_call or port_module)(*targs)
    wants = want if isinstance(want, tuple) else (want,)
    gots = got if isinstance(got, tuple) else (got,)
    for g, w in zip(gots, wants):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape
        finite = np.isfinite(w)
        assert (np.isfinite(g) == finite).all()
        scale = max(1.0, float(np.abs(w[finite]).max()))
        err = float(np.abs(g[finite] - w[finite]).max())
        assert err <= TOL * scale, (type(port_module).__name__, err, scale)


def rnd(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["wn", "relu_wn", "gated_tanh"])
def test_the_weight_normed_and_gated_linears(kind):
    from vitxtgqa_tpu.models import layers as JL

    x = rnd(B, K, DV)
    jm, pm = {"wn": (JL.WNDense(H), PL.WNDense(DV, H)),
              "relu_wn": (JL.ReLUWithWeightNormFC(H), PL.ReLUWithWeightNormFC(DV, H)),
              "gated_tanh": (JL.GatedTanh(H), PL.GatedTanh(DV, H))}[kind]
    held(jm, pm, (x,))


def test_weight_norm_is_over_the_whole_matrix():
    """w = g v / ||v||_F: one scalar norm, not a norm per row or column."""
    m = PL.WNDense(4, 3)
    with torch.no_grad():
        m.v.copy_(torch.arange(12.0).reshape(3, 4))
        m.g.fill_(2.0)
    want = 2.0 * m.v / torch.linalg.vector_norm(m.v)
    assert torch.allclose(m.weight(), want)


@pytest.mark.parametrize("ctype", ["linear", "logit", "weight_norm"])
def test_the_classifiers(ctype):
    from vitxtgqa_tpu.models import layers as JL

    x = rnd(B, DV)
    p = {"hidden_dim": 9, "text_hidden_dim": 6, "img_hidden_dim": 5, "dropout": 0.5}
    held(JL.ClassifierLayer(ctype, DV, 11, params=p), PL.ClassifierLayer(ctype, DV, 11, p), (x,))


def test_the_logit_classifiers_text_branch():
    from vitxtgqa_tpu.models import layers as JL

    x = rnd(B, DV)
    pm = PL.LogitClassifier(DV, 11, 6, 5, text_only=True)
    held(JL.LogitClassifier(DV, 11, 6, 5), pm, (x,),
         method=lambda m, x: m.linear_text(m.f_o_text(x)), port_call=pm.text)


@pytest.mark.parametrize("case", ["2d", "3d_by_2d", "context"])
def test_non_linear_element_multiply(case):
    from vitxtgqa_tpu.models import layers as JL

    img = rnd(B, K, DV) if case == "3d_by_2d" else rnd(B, DV)
    q = rnd(B, DQ, seed=2)
    args = (img, q) + ((rnd(B, 6, seed=3),) if case == "context" else ())
    pm = PL.NonLinearElementMultiply(DV, DQ, H, context_dim=6 if case == "context" else None)
    held(JL.NonLinearElementMultiply(H), pm, args)


@pytest.mark.parametrize("ctype", ["non_linear_element_multiply", "MFH"])
def test_the_modal_combine_layers(ctype):
    from vitxtgqa_tpu.models import layers as JL

    img, q = rnd(B, K, DV), rnd(B, DQ, seed=2)
    jm = JL.ModalCombineLayer(ctype, H)
    pm = PL.ModalCombineLayer(ctype, DV, DQ, H)
    assert pm.out_dim == (2 * H if ctype == "MFH" else H)
    held(jm, pm, (img, q))


def test_fcnet():
    from vitxtgqa_tpu.models import layers as JL

    held(JL.FCNet((DV, 9, H), act="relu"), PL.FCNet((DV, 9, H)), (rnd(B, K, DV),))


def test_bcnet_glimpse_logits_and_the_weighted_fusion():
    from vitxtgqa_tpu.models import layers as JL

    v, q = rnd(B, K, DV), rnd(B, T, DQ, seed=2)
    for wn in (False, True):
        held(JL.BCNet(h_dim=H, h_out=2, k=3, hmat_weight_norm=wn),
             PL.BCNet(DV, DQ, H, h_out=2, k=3, hmat_weight_norm=wn), (v, q))
    w = np.abs(rnd(B, K, T, seed=4))
    pm = PL.BCNet(DV, DQ, H, h_out=None, k=3)
    held(JL.BCNet(h_dim=H, h_out=None, k=3), pm, (v, q, w),
         method=JL.BCNet.forward_with_weights, port_call=pm.forward_with_weights)


def test_biattention_masks_empty_rows():
    """The glimpse maps over the flattened K x T grid, -inf at an all-zero
    visual row (which then gets weight 0)."""
    from vitxtgqa_tpu.models import layers as JL

    v, q = rnd(B, K, DV), rnd(B, T, DQ, seed=2)
    v[1, 3] = 0.0
    pm = PL.BiAttention(DV, DQ, H, glimpses=2)
    held(JL.BiAttention(H, glimpses=2), pm, (v, q))
    with torch.no_grad():
        p, _ = pm(torch.from_numpy(v), torch.from_numpy(q))
    assert float(p[1, :, 3].abs().max()) == 0.0
    assert torch.allclose(p.sum((2, 3)), torch.ones(B, 2))


# -- attentions ----------------------------------------------------------------

def jax_double_project():
    """JAX's DoubleProjectAttention cannot run (its ProjectAttention.raw_att
    defines submodules outside a compact method: flax raises
    AssignSubModuleError); this runs that raw_att's own code in compact
    wrappers with the same parameter names, its evident semantics."""
    import jax.numpy as jnp
    from flax import linen as nn
    from vitxtgqa_tpu.models import attention_legacy as JA

    class RawProject(JA.ProjectAttention):
        @nn.compact
        def __call__(self, img, q, deterministic=True):
            return JA.ProjectAttention.raw_att(self, img, q, deterministic)

    class Double(nn.Module):
        @nn.compact
        def __call__(self, img, q):
            raw = RawProject(H, name="att1")(img, q) + RawProject(H, name="att2")(img, q)
            return jnp.broadcast_to(jax.nn.softmax(raw, axis=1), img.shape)

    return Double()


@pytest.mark.parametrize("kind", ["concatenation", "project", "double_project"])
def test_the_image_attentions(kind):
    from vitxtgqa_tpu.models import attention_legacy as JA

    img, q = rnd(B, K, DV), rnd(B, DQ, seed=2)
    jm, pm = {"concatenation": (JA.ConcatenationAttention(H),
                                PA.ConcatenationAttention(DV, DQ, H)),
              "project": (JA.ProjectAttention(H), PA.ProjectAttention(DV, DQ, H)),
              "double_project": (None, PA.DoubleProjectAttention(DV, DQ, H))}[kind]
    held(jm or jax_double_project(), pm, (img, q))


@pytest.mark.parametrize("norm", ["softmax", "sigmoid"])
@pytest.mark.parametrize("ctype", ["non_linear_element_multiply", "MFH"])
def test_top_down_attention_with_location_masks(norm, ctype):
    """The attention past each sample's location count zeroed and (softmax)
    renormalised; a sample with no location keeps its zero row sum + EPS."""
    from vitxtgqa_tpu.models import attention_legacy as JA

    img, q = rnd(B, K, DV), rnd(B, DQ, seed=2)
    locs = np.asarray([K, 2, 0], np.float32)
    mc = {"type": ctype, "params": {"hidden_dim": H}}
    tr = {"type": "linear", "params": {"out_dim": 2}}
    pm = PA.AttentionLayer(DV, DQ, mc, tr, norm)
    held(JA.AttentionLayer(DV, DQ, mc, tr, norm), pm, (img, q, locs))
    with torch.no_grad():
        att = pm(torch.from_numpy(img), torch.from_numpy(q), torch.from_numpy(locs))
    assert float(att[1, 2:].abs().max()) == 0.0 and float(att[2].abs().max()) == 0.0
    got = PA.mask_attentions(torch.ones(B, K, 1), torch.from_numpy(locs))
    assert got[:, :, 0].sum(1).tolist() == [K, 2, 0]


# -- RNNs and embeddings ---------------------------------------------------------

@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_the_rnn_mapping(rnn_type, layers, bidirectional):
    """flax's cells in nn.RNN (the backward direction reverse=True,
    keep_order=True) against the port's loop over torch's stacked layout,
    on converted weights with every bias drawn (GRU's hn bias inside the
    reset product)."""
    from vitxtgqa_tpu.models.embeddings import _StackedRNN

    x = rnd(B, T, DQ)
    jm = _StackedRNN(hidden_dim=H, num_layers=layers, rnn_type=rnn_type,
                     bidirectional=bidirectional)
    pm = PE.StackedRNN(DQ, H, layers, rnn_type, bidirectional)
    held(jm, pm, (x,), seed=layers)
    names = {n for n, _ in pm.named_parameters()}
    sfx = ["_l0", "_l1"][:layers]
    sfx += [s + "_reverse" for s in sfx] if bidirectional else []
    # the biases flax's cells have: the LSTM's hidden gates', the GRU's
    # input gates' and its hidden candidate's
    kinds = ("bias",) if rnn_type == "LSTM" else ("bias_ih", "bias_hn")
    assert names == {f"{w}{s}" for w in ("weight_ih", "weight_hh") + kinds for s in sfx}


def test_the_gru_gate_order_matters():
    """A GRU with its r and z gates swapped leaves the mapping test's
    tolerance: the check above can tell."""
    from vitxtgqa_tpu.models.embeddings import _StackedRNN

    x = rnd(B, T, DQ)
    jm = _StackedRNN(hidden_dim=H, rnn_type="GRU")
    flat = redraw(jax.eval_shape(lambda: jm.init(jax.random.key(0), x))["params"], 0)
    want = np.asarray(jm.apply({"params": unflat(flat)}, x))
    pm = PE.StackedRNN(DQ, H, 1, "GRU")
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in port_state(flat).items()}
    for name in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0"):
        r, z, n = sd[name].chunk(3)
        sd[name] = torch.cat([z, r, n])
    pm.load_state_dict(sd)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() > 100 * TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("bidirectional", [False, True])
def test_bilstm_text_embedding(bidirectional):
    from vitxtgqa_tpu.models.embeddings import BiLSTMTextEmbedding as J

    x = rnd(B, T, DQ)
    jm = J(hidden_dim=H, bidirectional=bidirectional, rnn_type="GRU")
    pm = PE.BiLSTMTextEmbedding(DQ, H, bidirectional=bidirectional, rnn_type="GRU")
    held(jm, pm, (x,))
    held(jm, pm, (x,), method=J.forward_all, port_call=pm.forward_all)


@pytest.mark.parametrize("kernel_size,padding,bidirectional", [(1, 0, False), (3, 1, True)])
def test_attention_text_embedding(kernel_size, padding, bidirectional):
    from vitxtgqa_tpu.models.embeddings import AttentionTextEmbedding as J

    x = rnd(B, T, DQ)
    jm = J(hidden_dim=H, conv1_out=6, conv2_out=2, kernel_size=kernel_size, padding=padding,
           bidirectional=bidirectional)
    pm = PE.AttentionTextEmbedding(DQ, H, conv1_out=6, conv2_out=2, kernel_size=kernel_size,
                                   padding=padding, bidirectional=bidirectional)
    assert pm.out_dim == 2 * H
    held(jm, pm, (x,))


def test_image_embedding_with_order_vectors():
    from vitxtgqa_tpu.models.embeddings import ImageEmbedding as J

    img, q = rnd(B, K, DV), rnd(B, DQ, seed=2)
    order = np.eye(K, dtype=np.float32)[None].repeat(B, 0)
    order[1, 3:] = 0.0
    mc = {"type": "non_linear_element_multiply", "params": {"hidden_dim": H}}
    tr = {"type": "linear", "params": {"out_dim": 2}}
    jm = J(image_dim=DV, question_dim=DQ, modal_combine=mc, transform=tr)
    pm = PE.ImageEmbedding(DV, DQ, mc, tr, order_dim=K)
    assert pm.out_dim == 2 * (DV + K)
    held(jm, pm, (img, q, None, order))


def test_vocab_embedding_and_the_dispatch(tmp_path):
    from vitxtgqa_tpu.models.embeddings import VocabEmbedding as J

    ids = np.random.default_rng(0).integers(0, 20, (B, T))
    held(J(embedding_dim=DQ, vocab_size=20), PE.VocabEmbedding(DQ, 20), (ids,))
    table = rnd(20, DQ)
    assert torch.equal(PE.VocabEmbedding(DQ, 20, pretrained=table).weight,
                       torch.from_numpy(table))
    assert PE.text_embedding("identity", DQ) is None
    assert isinstance(PE.text_embedding("torch", DQ, embedding_dim=4, vocab_size=9),
                      PE.VocabEmbedding)
    for qid in (3, 7):
        np.save(tmp_path / f"{qid}.npy", np.full(4, qid, np.float32))
    pre = PE.text_embedding("preextracted", DQ, out_dim=4, base_path=str(tmp_path))
    assert pre([7, 3]).tolist() == [[7.0] * 4, [3.0] * 4]
    with pytest.raises(NotImplementedError):
        PE.text_embedding("nope", DQ)


def test_the_encoders(tmp_path):
    """default is the identity; the fc7 finetune head starts from the
    pickled [out, in] weights (an [in, out] dump transposed), as JAX's, and
    computes in its input's dtype."""
    from vitxtgqa_tpu.models.encoders import build_image_encoder as jbuild

    w, b = rnd(6, DV), rnd(6, seed=2)
    with open(tmp_path / "w.pkl", "wb") as f:
        pickle.dump(w.T, f)  # stored [in, out]
    with open(tmp_path / "b.pkl", "wb") as f:
        pickle.dump(b, f)
    kw = dict(weights_file="w.pkl", bias_file="b.pkl", model_data_dir=str(tmp_path))
    enc, out = PEnc.build_image_encoder("finetune_faster_rcnn_fpn_fc7", DV, **kw)
    jenc, jout = jbuild("finetune_faster_rcnn_fpn_fc7", DV, **kw)
    assert out == jout == 6
    x = rnd(B, K, DV)
    params = jenc.init(jax.random.key(0), x)
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jenc.apply(params, x)), rtol=TOL, atol=TOL)
    # bf16 features: the product in bf16 with the weights cast to it, as
    # JAX's x @ w.astype(x.dtype); within one bf16 unit (2**-7 relative)
    # of the largest output, the sums running in another order
    want = np.asarray(jenc.apply(params, x.astype(jax.numpy.bfloat16)).astype(np.float32))
    with torch.no_grad():
        got = enc(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and enc.weight.dtype == torch.float32
    assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -7 * np.abs(want).max()
    ident, d = PEnc.build_image_encoder("default", DV)
    assert d == DV and ident(torch.ones(2)).tolist() == [1.0, 1.0]
    with pytest.raises(NotImplementedError):
        PEnc.build_image_encoder("resnet", DV)
