"""The vocabulary-parallel weights of the mesh's model axis: the word
embeddings, the fixed-vocabulary classifier with its table feeding the
decoder slots, and the OCR pointer's query and key, on gloo ranks at model
2 and 4 against the whole modules in this process and JAX's; and the
port's rule table against JAX's param_shardings.

One world of four ranks (tests/torch_tp_ranks.py, no JAX in it) runs the
modules at model 2 (data 2) and model 4, started by a module fixture in the
background.  The vocabulary sizes are the production config's (30,522
words, 5,050 answers) at hidden 64: both shard at model 2 and stay whole at
model 4, where the axis divides neither (JAX's rule); the pointer's 64
query-key columns shard at both.  CPU, float32; weights, inputs and
cotangents made here with numpy.

Limits: outputs within 2e-5, each gradient (the inputs' and every
parameter's, sums over up to 5,050 rows) within 1e-4 of its tensor's
largest entry, of the whole modules and of JAX's; the pointer's
cached-decode scores equal to its full pass within 2e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tests import torch_tp_ranks
from tests.test_torch_dp import FRAMES, N_OCR, _plain
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.models import common as JC
from vitxtgqa_tpu.utils.synthetic import synthetic_batch, tiny_model_config

FWD_TOL, GRAD_TOL = 2e-5, 1e-4
WORDS, ANSWERS, HIDDEN, QK = 30522, 5050, 64, 64
B, TEXT, DEC, OCR = 2, 10, 5, 12
SIZES = (2, 4)


def _rel_close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@functools.lru_cache(maxsize=None)
def _case():
    """The modules' whole weights (port names), inputs and cotangents."""
    from torch import nn

    from vitxtgqa_tpu_torch.models.common import (BertEmbeddings, FixedVocabClassifier,
                                                  OcrPtrNet, PrevPredEmbeddings,
                                                  TransformerConfig)

    cfg = dict(hidden_size=HIDDEN, vocab_size=WORDS, max_position_embeddings=40,
               hidden_dropout_prob=0.0)
    tc = TransformerConfig(**cfg)
    shapes = nn.ModuleDict({"emb": BertEmbeddings(tc),
                            "cls": FixedVocabClassifier(ANSWERS, HIDDEN),
                            "ptr": OcrPtrNet(HIDDEN, QK), "ppe": PrevPredEmbeddings(tc)})
    rng = np.random.default_rng(22)
    state = {}
    for k, v in shapes.state_dict().items():
        base = 1.0 if "LayerNorm.weight" in k or "layer_norm.weight" in k else 0.0
        state[k] = (base + rng.standard_normal(tuple(v.shape)) * (0.05 if v.dim() == 1 else 0.5)
                    ).astype(np.float32)
    ids = rng.integers(0, WORDS, (B, TEXT))
    ids[0, :2] = (0, WORDS - 1)
    prev = rng.integers(0, ANSWERS + OCR, (B, DEC))
    prev[0, :4] = (0, ANSWERS - 1, ANSWERS, ANSWERS + OCR - 1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = (rng.random((B, OCR)) > 0.3).astype(np.float32)
    return dict(kind="vocab", sizes=SIZES, cfg=cfg, answers=ANSWERS, qk=QK, state=state,
                ids=ids, prev=prev, x=f(B, DEC, HIDDEN), ocr=f(B, OCR, HIDDEN),
                keys=f(B, OCR, HIDDEN), ocr_mask=mask, g_emb=f(B, TEXT, HIDDEN),
                g_cls=f(B, DEC, ANSWERS), g_ptr=f(B, DEC, OCR), g_ppe=f(B, DEC, HIDDEN))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ranks = torch_tp_ranks.start({"vocab": _case()}, tmp_path_factory.mktemp("vocab_ranks"),
                                 world=4)
    yield ranks
    for p in ranks.procs:
        if p.poll() is None:
            p.kill()
        p.wait()


@functools.lru_cache(maxsize=None)
def _whole():
    torch.set_num_threads(1)
    return torch_tp_ranks.vocab_modules(_case(), None)


@functools.lru_cache(maxsize=None)
def _jax():
    """JAX's modules on the case (one device): the outputs, the inputs'
    gradients and the parameters' (port names and layouts)."""
    c = _case()
    st = {k: jnp.asarray(v) for k, v in c["state"].items()}
    jcfg = JC.TransformerConfig(hidden_size=HIDDEN, vocab_size=WORDS,
                                max_position_embeddings=40, hidden_dropout_prob=0.0)
    ln = lambda p: {"scale": st[p + ".weight"], "bias": st[p + ".bias"]}
    emb = lambda p: {"embedding": st[p + ".weight"]}
    params = {
        "emb": {"word_embeddings": emb("emb.word_embeddings"),
                "position_embeddings": emb("emb.position_embeddings"),
                "token_type_embeddings": emb("emb.token_type_embeddings"),
                "ln": ln("emb.LayerNorm")},
        "cls": {"weight": st["cls.module.weight"], "bias": st["cls.module.bias"]},
        "ptr": {n: {"kernel": st[f"ptr.{n}.weight"].T, "bias": st[f"ptr.{n}.bias"]}
                for n in ("query", "key")},
        "ppe": {"position_embeddings": emb("ppe.position_embeddings"),
                "token_type_embeddings": emb("ppe.token_type_embeddings"),
                "ans_ln": ln("ppe.ans_layer_norm"), "ocr_ln": ln("ppe.ocr_layer_norm"),
                "emb_ln": ln("ppe.emb_layer_norm")}}
    mods = {"emb": JC.BertEmbeddings(jcfg), "cls": JC.FixedVocabClassifier(ANSWERS, HIDDEN),
            "ptr": JC.OcrPtrNet(HIDDEN, QK), "ppe": JC.PrevPredEmbeddings(jcfg)}
    ids, prev, mask = (jnp.asarray(c[k]) for k in ("ids", "prev", "ocr_mask"))

    def fwd(p, x, ocr, keys):
        out = {"emb": mods["emb"].apply({"params": p["emb"]}, ids),
               "cls": mods["cls"].apply({"params": p["cls"]}, x),
               "ptr": mods["ptr"].apply({"params": p["ptr"]}, x, keys, mask)}
        table = mods["cls"].apply({"params": p["cls"]}, method="table")
        out["ppe"] = mods["ppe"].apply({"params": p["ppe"]}, table, ocr, prev)
        return out

    inputs = [jnp.asarray(c[k]) for k in ("x", "ocr", "keys")]
    out, vjp = jax.vjp(fwd, params, *inputs)
    gp, gx, gocr, gkeys = vjp({k: jnp.asarray(c["g_" + k]) for k in out})
    grads = {"emb.word_embeddings.weight": gp["emb"]["word_embeddings"]["embedding"],
             "emb.LayerNorm.weight": gp["emb"]["ln"]["scale"],
             "cls.module.weight": gp["cls"]["weight"], "cls.module.bias": gp["cls"]["bias"],
             "ptr.query.weight": gp["ptr"]["query"]["kernel"].T,
             "ptr.key.weight": gp["ptr"]["key"]["kernel"].T,
             "ptr.key.bias": gp["ptr"]["key"]["bias"],
             "ppe.ans_layer_norm.weight": gp["ppe"]["ans_ln"]["scale"],
             "ppe.ans_layer_norm.bias": gp["ppe"]["ans_ln"]["bias"],
             "ppe.ocr_layer_norm.weight": gp["ppe"]["ocr_ln"]["scale"]}
    return ({k: np.asarray(v) for k, v in out.items()},
            {"x": np.asarray(gx), "ocr": np.asarray(gocr), "keys": np.asarray(gkeys)},
            {k: np.asarray(v) for k, v in grads.items()})


# the parameters JAX's rules shard at each model axis, by port name
SHARDED = {2: {"emb.word_embeddings.weight", "cls.module.weight", "cls.module.bias",
               "ptr.query.weight", "ptr.query.bias", "ptr.key.weight", "ptr.key.bias"},
           4: {"ptr.query.weight", "ptr.query.bias", "ptr.key.weight", "ptr.key.bias"}}


@pytest.mark.parametrize("n", SIZES)
def test_vocab_parallel_modules_equal_the_whole_modules_and_jax(world, n):
    """At model n every rank's word embeddings, classifier scores, decoder
    slots (the answer table's rows gathered across the shards, after the
    float32 LayerNorm) and pointer scores, their inputs' gradients and
    every parameter's gradient made whole equal the whole modules' and
    JAX's; the shards are 30,522 and 5,050 rows at model 2 and the pointer
    alone at model 4, where the vocabularies stay whole."""
    whole = _whole()
    jout, jdx, jgrads = _jax()
    for r in world.results():
        got = r["vocab"][n]
        assert set(got["sharded"]) == SHARDED[n]
        for k, v in got["out"].items():
            for ref in (whole["out"][k], jout[k]):
                np.testing.assert_allclose(v, ref, atol=FWD_TOL, rtol=FWD_TOL, err_msg=k)
        np.testing.assert_allclose(got["cached"], got["out"]["ptr"], atol=FWD_TOL, rtol=FWD_TOL)
        for k, v in got["dx"].items():
            for ref in (whole["dx"][k], jdx[k]):
                _rel_close(v, ref, GRAD_TOL, k)
        for k, v in got["grads"].items():
            _rel_close(v, whole["grads"][k], GRAD_TOL, k)
            if k in jgrads:
                _rel_close(v, jgrads[k], GRAD_TOL, k)


def test_whole_modules_equal_jax():
    """The whole modules in one process against JAX's (the reference the
    ranks are held to beside them)."""
    whole = _whole()
    jout, jdx, jgrads = _jax()
    for k, v in whole["out"].items():
        np.testing.assert_allclose(v, jout[k], atol=FWD_TOL, rtol=FWD_TOL, err_msg=k)
    for k, v in jdx.items():
        _rel_close(whole["dx"][k], v, GRAD_TOL, k)
    for k, v in jgrads.items():
        _rel_close(whole["grads"][k], v, GRAD_TOL, k)
    assert whole["sharded"] == {}


def _jax_sharded(cfg, nf, n):
    """The T2S parameters that JAX's param_shardings shards at model n, by
    port name and dimension: each sharded leaf gets its index along the
    sharded dimension and goes through the converter, whose transposes
    show the port's dimension."""
    from vitxtgqa_tpu.models.t2s import T2S as JT2S
    from vitxtgqa_tpu.parallel.mesh import _tree_paths, param_shardings
    from vitxtgqa_tpu.utils.torch_convert import unflatten
    from tests.test_torch_train import _tree_to_port

    batch = synthetic_batch(batch=2, frames=FRAMES, ocr_per_frame=3, dec_steps=4, text_len=10,
                            video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=nf, text_vocab=128, seed=3)
    jm = JT2S(config=cfg, num_final_outputs=nf, bos_idx=2)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "gumbel": jax.random.key(1), "dropout": jax.random.key(2)},
        {k: jnp.asarray(v) for k, v in batch.items()}, train=False))["params"]
    mesh = JMesh(np.array(jax.devices()[:n]).reshape(1, n), ("data", "model"))
    specs = _tree_paths(param_shardings(shapes, mesh))
    marked = {}
    for path, leaf in _tree_paths(shapes).items():
        spec = specs[path].spec
        dim = next((i for i, a in enumerate(spec) if a == "model"), None)
        marked[path] = (np.zeros(leaf.shape, np.float32) if dim is None else
                        np.indices(leaf.shape)[dim].astype(np.float32) + 1.0)
    port = _tree_to_port(unflatten(marked))
    out = {}
    for k, v in port.items():
        varies = [d for d in range(v.ndim) if v.shape[d] > 1 and np.ptp(v, axis=d).max() > 0]
        if np.any(v):
            out[k] = varies[0]
    return out


@pytest.mark.parametrize("n", SIZES)
def test_the_rule_table_shards_what_jax_shards(n):
    """A T2S at the tiny widths with the production vocabularies (30,522
    words, 5,050 answers) at model n: the port holds as shards exactly the
    weights that JAX's param_shardings shards, along the same dimension
    (the biases of the column-parallel products and of the classifier go
    with their rows in the port; JAX's rules name the weights only)."""
    from vitxtgqa_tpu_torch.models.t2s import T2S
    from vitxtgqa_tpu_torch.parallel import tensor_parallel as TP
    from vitxtgqa_tpu_torch.parallel.mesh import ModelGroup

    cfg = tiny_model_config(hidden=64, frames=FRAMES, ocr_per_frame=3, layers=2)
    plain = _plain(cfg)
    plain["text_bert"]["vocab_size"] = WORDS
    nf = ANSWERS + N_OCR
    want = _jax_sharded(type(cfg)(plain), nf, n)
    model = T2S(plain, nf, bos_idx=2, opts=cpu_options(tp=ModelGroup(None, 0, n)))
    got = TP.sharded_dims(model)
    weights = {k: d for k, d in got.items() if not k.endswith(".bias")}
    assert weights == want
    assert ("classifier.module.weight" in got) == (n == 2)
    assert ("text_bert.embeddings.word_embeddings.weight" in got) == (n == 2)
    for k in got:
        if k.endswith(".bias"):
            assert k[:-len("bias")] + "weight" in got and got[k] == 0, k
            assert TP.rule_dim(k) == 0
