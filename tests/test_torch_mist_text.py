"""The port's MIST auxiliary modules (vitxtgqa_tpu_torch/models/mist_text.py)
against their flax twins (vitxtgqa_tpu/models/mist_text.py) on the CPU in
float32, at the JAX tests' tiny geometries (tests/test_mist_text_parity.py).

Every leaf of the flax variables is redrawn from a seed (biases and
LayerNorm scales too, so that a misplaced one shows) and carried to the
port by utils/convert.from_jax_mist_text_params.  Masked attention rows
keep at least one live key: a row with none is NaN in both (the JAX
module's -inf on every key).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.models import common as JCOM
from vitxtgqa_tpu.models import mist_text as JM
from vitxtgqa_tpu.utils.torch_convert import flatten
from vitxtgqa_tpu_torch.models import common as TCOM
from vitxtgqa_tpu_torch.models import mist_text as TM
from vitxtgqa_tpu_torch.utils.convert import MIST_TEXT_MODULES, from_jax_mist_text_params

TOL = 1e-5
T = torch.from_numpy


def _redraw(tree, seed: int):
    """Every leaf drawn anew: N(0, 0.1), 1 + that for a LayerNorm / BatchNorm
    scale, uniform(0.5, 1.5) for a running variance."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32))
        x = rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        return jnp.asarray(x + 1.0 if name == "scale" else x)
    return jax.tree_util.tree_map_with_path(draw, tree)


def _port(module, variables, name: str):
    flat = {k: np.asarray(v) for k, v in flatten(variables["params"]).items()}
    stats = ({k: np.asarray(v) for k, v in flatten(variables["batch_stats"]).items()}
             if "batch_stats" in variables else None)
    module.load_state_dict(from_jax_mist_text_params(flat, name, stats), strict=True)
    return module


def _jinit(jmod, seed: int, *args):
    """The flax module's init, jitted (its shapes; every leaf is redrawn)."""
    return jax.jit(jmod.init)(jax.random.key(seed), *args)


def _japply(jmod, variables, *args, **kw):
    """The flax module's apply, jitted (eager flax dispatches op by op)."""
    return jax.jit(functools.partial(jmod.apply, **kw))(variables, *args)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def test_sinusoidal_embeddings_are_the_jax_table():
    np.testing.assert_array_equal(TM.sinusoidal_embeddings(10, 8), JM.sinusoidal_embeddings(10, 8))


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_distil_transformer_matches_flax(activation):
    """Two post-LN blocks at dim 64, 4 heads, a row with masked keys."""
    kw = dict(dim=64, n_heads=4, n_layers=2, hidden_dim=128, dropout=0.0,
              attention_dropout=0.0, activation=activation)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    mask = np.ones((2, 7), np.float32)
    mask[1, 5:] = 0.0
    jmod = JM.DistilTransformer(JM.DistilConfig(**kw))
    variables = _redraw(_jinit(jmod, 0, x, mask), 1)
    want = _japply(jmod, variables, x, mask)
    port = _port(TM.DistilTransformer(TM.DistilConfig(**kw), device="cpu"), variables,
                 "DistilTransformer")
    _close(port(T(x), T(mask)), want)
    _close(port(T(x)), _japply(jmod, variables, x))  # the default mask: every key live


def test_a_fully_masked_row_is_nan_in_both():
    """JAX's behaviour, kept: every key of row 1 masked gives NaN there."""
    kw = dict(dim=32, n_heads=2, n_layers=1, hidden_dim=64, dropout=0.0, attention_dropout=0.0)
    x = np.random.default_rng(2).standard_normal((2, 4, 32)).astype(np.float32)
    mask = np.ones((2, 4), np.float32)
    mask[1] = 0.0
    jmod = JM.DistilTransformer(JM.DistilConfig(**kw))
    variables = _redraw(_jinit(jmod, 0, x, mask), 3)
    want = np.asarray(_japply(jmod, variables, x, mask))
    got = _port(TM.DistilTransformer(TM.DistilConfig(**kw), device="cpu"), variables,
                "DistilTransformer")(T(x), T(mask)).detach().numpy()
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("sinusoidal", [True, False])
def test_fusion_embeddings_match_flax(sinusoidal):
    x = np.random.default_rng(2).standard_normal((2, 7, 16)).astype(np.float32)
    kw = dict(d_model=16, language_len=3, vision_len=4, dropout=0.0,
              sinusoidal_pos_embds=sinusoidal)
    jmod = JM.FusionEmbeddings(**kw)
    variables = _redraw(_jinit(jmod, 0, x), 4)
    port = _port(TM.FusionEmbeddings(**kw, device="cpu"), variables, "FusionEmbeddings")
    _close(port(T(x)), _japply(jmod, variables, x))
    _close(port(T(x[:, :5])), _japply(jmod, variables, x[:, :5]))  # a shorter sequence


def test_position_and_token_type_embeddings_match_flax():
    rng = np.random.default_rng(3)
    x3 = rng.standard_normal((2, 5, 8)).astype(np.float32)
    x4 = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    jpos = JM.PositionEmbeddings(8, 10, True)
    variables = _redraw(_jinit(jpos, 0, x3), 5)
    port = _port(TM.PositionEmbeddings(8, 10, True, device="cpu"), variables,
                 "PositionEmbeddings")
    _close(port(T(x3)), jpos.apply(variables, x3))
    _close(port(T(x4)), jpos.apply(variables, x4))
    jtype = JM.TokenTypeEmbeddings(8, 3)
    variables = _redraw(jtype.init(jax.random.key(0), x3, "segment"), 6)
    port = _port(TM.TokenTypeEmbeddings(8, 3, device="cpu"), variables, "TokenTypeEmbeddings")
    for kind in TM.TokenTypeEmbeddings.TYPE2ID:
        _close(port(T(x3), kind), jtype.apply(variables, x3, kind))


def _encoder_vid():
    kw = dict(feat_dim=16, bbox_dim=5, feat_hidden=32, pos_hidden=8)
    video_o = np.random.default_rng(1).standard_normal((2, 1, 4, 3, 21)).astype(np.float32)
    jmod = JM.EncoderVid(**kw)
    variables = _redraw(_jinit(jmod, 0, video_o), 7)
    return jmod, variables, _port(TM.EncoderVid(**kw, device="cpu"), variables, "EncoderVid"), \
        video_o


def test_encoder_vid_matches_flax_in_eval():
    jmod, variables, port, video_o = _encoder_vid()
    _close(port(T(video_o)), _japply(jmod, variables, video_o))


def test_encoder_vid_training_step_matches_flax_running_statistics():
    """One training-mode call: the output on the batch's statistics and
    both BatchNorms' running mean and variance after flax's update
    (momentum 0.9, the biased batch variance)."""
    jmod, variables, port, video_o = _encoder_vid()
    want, updates = _japply(jmod, variables, video_o, use_running_average=False,
                            mutable=["batch_stats"])
    bn1 = port.bbox_conv[1]
    torch_bn = torch.nn.BatchNorm2d(8, momentum=0.1).train()
    torch_bn.load_state_dict(bn1.state_dict())
    pos = T(video_o).reshape(2, 4, 3, 21)[..., 16:21].permute(0, 3, 1, 2)
    torch_bn(port.bbox_conv[0](pos))
    got = port(T(video_o), train=True)
    _close(got, want)
    for fi, bn in ((1, bn1), (2, port.bbox_conv[4])):
        stats = updates["batch_stats"][f"bbox_bn{fi}"]
        _close(bn.running_mean, stats["mean"])
        _close(bn.running_var, stats["var"])
    # torch's own update takes the unbiased variance: outside the tolerance
    assert np.abs(torch_bn.running_var.detach().numpy()
                  - np.asarray(updates["batch_stats"]["bbox_bn1"]["var"])).max() > 10 * TOL


def test_sentence_maxpool_matches_flax():
    x = np.random.default_rng(4).standard_normal((2, 6, 16)).astype(np.float32)
    for relu in (True, False):
        jmod = JM.SentenceMaxpool(8, relu=relu)
        variables = _redraw(_jinit(jmod, 0, x), 8)
        port = _port(TM.SentenceMaxpool(16, 8, relu=relu, device="cpu"), variables,
                     "SentenceMaxpool")
        _close(port(T(x)), jmod.apply(variables, x))


BERT_KW = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
               intermediate_size=64, vocab_size=50)


def test_mist_bert_matches_flax():
    """The tokens > 0 mask: padded rows of id 0 at the end."""
    tokens = np.random.default_rng(5).integers(1, 50, (2, 6)).astype(np.int32)
    tokens[1, 4:] = 0
    jmod = JM.MistBert(JCOM.TransformerConfig(**BERT_KW, hidden_dropout_prob=0.0,
                                              attention_probs_dropout_prob=0.0))
    variables = _redraw(_jinit(jmod, 0, tokens), 9)
    port = _port(TM.MistBert(TCOM.TransformerConfig(**BERT_KW), cpu_options()), variables,
                 "MistBert")
    _close(port(T(tokens.astype(np.int64))), _japply(jmod, variables, tokens))


@pytest.mark.parametrize("layout", ["BL", "BNL"])
def test_amodel_matches_flax(layout):
    """[B, L] and [B, n_answers, L] answers through the BERT's first token
    and the Linear."""
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, 50, (2, 3, 5) if layout == "BNL" else (2, 5)).astype(np.int32)
    jmod = JM.AModel(out_dim=12, bert_cfg=JCOM.TransformerConfig(
        **BERT_KW, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
    variables = _redraw(_jinit(jmod, 1, tokens), 10)
    port = _port(TM.AModel(12, TCOM.TransformerConfig(**BERT_KW), cpu_options()), variables,
                 "AModel")
    got = port(T(tokens.astype(np.int64)))
    assert got.shape == tokens.shape[:-1] + (12,)
    _close(got, _japply(jmod, variables, tokens))


def test_every_module_has_a_converter_and_distilbert_base_is_jax_s():
    assert set(MIST_TEXT_MODULES) == {n for n in dir(TM) if n in MIST_TEXT_MODULES}
    assert (TM.DISTILBERT_BASE.num_hidden_layers, TM.DISTILBERT_BASE.vocab_size) == (
        JM.DISTILBERT_BASE.num_hidden_layers, JM.DISTILBERT_BASE.vocab_size)
    with pytest.raises(KeyError):
        from_jax_mist_text_params({}, "Unknown")
