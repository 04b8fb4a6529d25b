"""The legacy image-VQA data chain and the rest of the training registry in
the port against the JAX package's: the processors (simple_sentence,
glove, vqa_answer, multi_hot_answer_from_vocab, soft_copy_answer), the
vocab embeddings, the VQA2 -> VizWiz -> TextVQA (+ vqa2_ocr) datasets and
builders, the concat dataset, the multi-dataset schedule (one process and
two ranks' rows), the losses (bce_loss, logit_bce, bce, bce_kl_combined,
multi), Adamax and SGD against optax step by step, vqa_accuracy and
temporal_accuracy, and beam search.

CPU, on a tiny synthetic tree (utils/legacy_fixtures.write_tree).  Data,
records and metrics are held exactly; losses and their gradients within
1e-6 relative (float32 sums in another order); the optimizers'
parameters within 1e-6 of their largest magnitude over five steps (optax
and torch update in float32 with the same formulas, in another order).
"""

import copy
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.run import setup_imports
from vitxtgqa_tpu_torch.utils.legacy_fixtures import write_tree

OCR = 6
CONFIGS = {"vqa2": "pythia_vqa2.yml", "textvqa": "lorra_textvqa.yml"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("legacy_data"))
    write_tree(path, questions={"train": 10, "val": 6, "test": 3}, per_image=2, feat_dim=16,
               boxes={"vqa2": 7, "vizwiz": 7, "textvqa": 7}, grid=5, question_vocab=30,
               answers={"vqa2": 12, "vizwiz": 10, "textvqa": 12}, ocr_tokens=OCR, text_len=8)
    return path


def dataset_configs(repo_root, root, name, extra=()):
    """(port, JAX) frozen configs of ``name``'s dataset attributes, from the
    config that includes it (vizwiz / vqa2_ocr read textvqa's, as the JAX
    chain test does)."""
    from vitxtgqa_tpu.core.config import build_config as jax_build
    from vitxtgqa_tpu_torch.core.config import build_config

    key = "vqa2" if name == "vqa2" else "textvqa"
    d = f"dataset_attributes.{key}"
    opts = [f"{d}.data_root_dir={root}", f"{d}.features_max_len=7",
            f"{d}.processors.context_processor.params.max_length={OCR}"]
    if key == "textvqa":
        opts += [f"{d}.processors.answer_processor.params.max_length={OCR}"]
    opts += list(extra)
    path = os.path.join(repo_root, "configs", CONFIGS[key])
    return tuple(b(path, opts=list(opts)).dataset_attributes[key]
                 for b in (build_config, jax_build))


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all(), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


# -- processors and vocabularies ----------------------------------------------------

@pytest.mark.parametrize("kind", ["simple_sentence", "glove", "vqa_answer",
                                  "multi_hot_answer_from_vocab", "soft_copy_answer"])
def test_the_legacy_processors_equal_the_jax_packages(kind, root):
    import vitxtgqa_tpu.data.processors  # noqa: F401
    from vitxtgqa_tpu.core.config import ConfigNode
    from vitxtgqa_tpu.core.registry import registry as jax_registry
    from vitxtgqa_tpu_torch.core.registry import registry

    setup_imports()
    params = {"simple_sentence": {},
              "glove": {"max_length": 5, "vocab": {"vocab_file": "vocabs/vocabulary_100k.txt",
                                                   "embedding_dim": 8},
                        "preprocessor": {"type": "simple_sentence", "params": {}}},
              "soft_copy_answer": {"max_length": 4, "context_preprocessor": {
                  "type": "simple_word", "params": {}}}}.get(kind, {})
    if "answer" in kind:
        params.update(vocab_file="vocabs/answers_vqa.txt",
                      preprocessor={"type": "simple_word", "params": {}})
    procs = [reg.get_processor_class(kind)(ConfigNode(params), data_root_dir=root)
             for reg in (registry, jax_registry)]
    items = {"simple_sentence": [{"text": "What's the sign, on the BUS?"}],
             "glove": [{"text": "what is the color of the w3 zzz"}, {"tokens": ["is", "w1"]}],
             }.get(kind, [{"answers": ["ans1"] * 6 + ["ans2"] * 3 + ["nope"]},
                          {"answers": ["ans3", "Ans3", "ans4"]},
                          {"answers": ["tok1"] * 4 + ["ans1"] * 6, "tokens": ["tok1", "x", "TOK1"]}])
    for item in items:
        _equal(procs[0](dict(item)), procs[1](dict(item)), kind)
    if "answer" in kind:
        assert procs[0].get_vocab_size() == procs[1].get_vocab_size()


@pytest.mark.parametrize("kind", ["random", "custom", "intersected", "pretrained", "extracted",
                                  "model"])
def test_the_vocab_embeddings_equal_the_jax_packages(kind, root, tmp_path):
    from vitxtgqa_tpu.data.vocab_embeddings import Vocab as JVocab
    from vitxtgqa_tpu_torch.data.vocab_embeddings import Vocab

    vocab_file = os.path.join(root, "vocabs", "vocabulary_100k.txt")
    params = {"model": {"embedding_dim": 12}}.get(kind, {"vocab_file": vocab_file,
                                                          "embedding_dim": 12})
    if kind == "extracted":
        emb = np.random.default_rng(0).standard_normal((34, 12)).astype(np.float32)
        np.save(tmp_path / "emb.npy", emb)
        params = {"vocab_file": vocab_file, "embedding_file": str(tmp_path / "emb.npy")}
    got, want = Vocab(type=kind, **params), JVocab(type=kind, **params)
    if kind == "model":
        _equal(got["coffee shop"], want["coffee shop"])
        assert got.get_embedding_dim() == want.get_embedding_dim() == 12
        return
    _equal(got.get_vectors(), want.get_vectors())
    assert got.itos == want.itos and got.get_pad_index() == want.get_pad_index() == 0
    with pytest.raises(ValueError):
        Vocab(type="nope")


# -- datasets ------------------------------------------------------------------

def jax_data_imports():
    """The JAX package's processors and builders into its registry (its
    setup_imports also imports the trainer, and with it orbax)."""
    import vitxtgqa_tpu.data.builders  # noqa: F401
    import vitxtgqa_tpu.data.processors  # noqa: F401


@pytest.mark.parametrize("name", ["vqa2", "vizwiz", "textvqa", "vqa2_ocr"])
def test_the_dataset_chain_equals_the_jax_packages(repo_root, root, name):
    """Every sample of every split (tensors and host fields), the head
    sizes registered, and the EvalAI records of a batch of scores."""
    from vitxtgqa_tpu.core.registry import registry as jax_registry
    from vitxtgqa_tpu.data.dataset import collate as jax_collate
    from vitxtgqa_tpu_torch.core.registry import registry
    from vitxtgqa_tpu_torch.data.dataset import collate

    setup_imports()
    jax_data_imports()
    cfg, jcfg = dataset_configs(repo_root, root, name)
    for split in ("train", "val", "test"):
        ds = registry.get_builder_class(name)().load(split, cfg, seed=1)
        jds = jax_registry.get_builder_class(name)().load(split, jcfg, seed=1)
        assert len(ds) == len(jds) > 0
        samples = [ds[i] for i in range(len(ds))]
        for i, s in enumerate(samples):
            _equal(s, jds[i], f"{name}/{split}/{i}")
        assert samples[0]["dataset_name"] == name
        ds.update_registry_for_model()
        jds.update_registry_for_model()
        for key in ("text_vocab_size", "num_final_outputs"):
            assert registry.get(f"{name}_{key}") == jax_registry.get(f"{name}_{key}")
        batch = collate(samples)
        scores = np.random.default_rng(3).standard_normal(
            (len(samples), registry.get(f"{name}_num_final_outputs"))).astype(np.float32)
        jbatch = jax_collate([jds[i] for i in range(len(jds))])
        _equal(ds.format_for_evalai(batch["tensors"], {"scores": scores}, batch["host"]),
               jds.format_for_evalai(jbatch["tensors"], {"scores": scores}, jbatch["host"]))
    if name == "textvqa":
        s = samples[0]
        n = int(s["context_info_0_max_features"])
        assert s["order_vectors"].shape == (OCR, OCR) and not s["order_vectors"][n:].any()
        assert s["targets"].shape == (registry.get("textvqa_num_final_outputs"),)


def test_a_split_of_several_imdbs_is_a_concat_dataset(repo_root, root):
    """Two imdb files make a ConcatDataset equal to JAX's, whose method
    calls fan out (the first non-None return wins), which pickles for the
    worker processes, and whose batches through two workers equal the
    in-process ones."""
    from vitxtgqa_tpu_torch.core.registry import registry
    from vitxtgqa_tpu_torch.data.concat_dataset import ConcatDataset
    from vitxtgqa_tpu_torch.data.loader import DataLoader

    setup_imports()
    cfg, jcfg = dataset_configs(repo_root, root, "vqa2", extra=[
        "dataset_attributes.vqa2.imdb_files.val=['imdb/vqa/imdb_val2014.npy',"
        "'imdb/vqa/imdb_test2015.npy']",
        "dataset_attributes.vqa2.image_features.val=['coco/detectron_fix_100/fc6/train_val_2014',"
        "'coco/detectron_fix_100/fc6/test2015']"])
    from vitxtgqa_tpu.core.registry import registry as jax_registry

    jax_data_imports()
    ds = registry.get_builder_class("vqa2")().load("val", cfg, seed=1)
    jds = jax_registry.get_builder_class("vqa2")().load("val", jcfg, seed=1)
    assert isinstance(ds, ConcatDataset) and len(ds) == len(jds) == 9
    for i in range(len(ds)):
        _equal(ds[i], jds[i], str(i))
    assert ds.get_item(7)["question_id"] == jds.get_item(7)["question_id"]
    assert ds.seed_sample((1, 2, 3)) is None and ds._name == "vqa2"
    clone = pickle.loads(pickle.dumps(ds))
    _equal(clone[8], ds[8])
    with pytest.raises(AttributeError):
        ds.nope
    inproc = [b["tensors"] for b in DataLoader(ds, batch_size=4, shuffle=True, seed=2,
                                               pad_last=True)]
    loader = DataLoader(ds, batch_size=4, shuffle=True, seed=2, pad_last=True, num_workers=2)
    try:
        workers = [b["tensors"] for b in loader]
    finally:
        loader.close()
    _equal(inproc, workers)


@pytest.mark.parametrize("proportional", [True, False])
def test_the_multi_dataset_schedule_and_the_ranks_rows(repo_root, root, proportional):
    """The schedule equals the JAX MultiDataset's on the same loaders; at
    every step two ranks draw the same dataset, and their rows merged are
    the one-process batch."""
    from vitxtgqa_tpu.data.multi_dataset import MultiDataset as JaxMultiDataset
    from vitxtgqa_tpu_torch.core.registry import registry
    from vitxtgqa_tpu_torch.data.loader import DataLoader, merge_rows
    from vitxtgqa_tpu_torch.data.multi_dataset import MultiDataset

    setup_imports()
    sets = {n: registry.get_builder_class(n)().load(
        "train", dataset_configs(repo_root, root, n)[0], seed=1) for n in ("vqa2", "textvqa")}

    def multi(rank, world):
        return MultiDataset({n: DataLoader(d, batch_size=4 // world, seed=5, drop_last=True,
                                           rank=rank, world_size=world)
                             for n, d in sets.items()}, proportional=proportional, seed=5)

    one, r0, r1 = multi(0, 1), multi(0, 2), multi(1, 2)
    jax_multi = JaxMultiDataset(one.loaders, proportional=proportional, seed=5)
    np.testing.assert_array_equal(one.probs, jax_multi.probs)
    steps = range(12)
    assert [one.dataset_for_step(s) for s in steps] == [jax_multi.dataset_for_step(s)
                                                        for s in steps]
    for batch, b0, b1, _ in zip(one, r0, r1, steps):
        assert batch["host"]["dataset_name"] == b0["host"]["dataset_name"] == \
            b1["host"]["dataset_name"]
        merged = merge_rows([b0["tensors"]["question_id"].tolist(),
                             b1["tensors"]["question_id"].tolist()])
        assert merged == batch["tensors"]["question_id"].tolist()


# -- losses ---------------------------------------------------------------------

LOSS_CASES = {
    "bce_loss": [{"type": "bce_loss"}],
    "logit_bce": [{"type": "logit_bce", "weight": 0.5}],
    "bce": [{"type": "bce"}],
    "bce_kl_combined": [{"type": "bce_kl_combined", "params": {"weight_softmax": 0.5}}],
    "multi": [{"type": "multi", "weight": 2.0, "params": {"params": [
        {"type": "logit_bce", "weight": 0.5}, {"type": "bce_loss"},
        {"type": "bce_kl_combined", "weight": 3.0}]}}],
}


def _loss_batch(kind):
    r = np.random.default_rng(0)
    b, n = 5, 9
    scores = r.standard_normal((b, n)).astype(np.float32)
    if kind == "bce":
        scores = 1.0 / (1.0 + np.exp(-scores))
    targets = ((r.random((b, n)) < 0.3) * r.random((b, n))).astype(np.float32)
    targets[2] = 0.0  # a row with no answer: bce_kl_combined's 1e-6 denominator
    mask = np.array([1, 1, 0, 1, 1], np.float32)
    return {"targets": targets, "train_loss_mask": mask}, {"scores": scores}


@pytest.mark.parametrize("kind", sorted(LOSS_CASES))
def test_the_losses_equal_the_jax_packages(kind):
    """The value and its gradient against the scores; and the pair form:
    the two halves' (numerator, denominator) sums make the whole batch's
    value, as the ranks of a data axis do."""
    import vitxtgqa_tpu.losses  # noqa: F401
    from vitxtgqa_tpu.losses import Losses as JaxLosses
    from vitxtgqa_tpu_torch.losses import Losses

    batch, out = _loss_batch(kind)
    cfg = LOSS_CASES[kind]
    jl = JaxLosses(cfg, "vqa2")
    # under one jit: one XLA compile, not one per op
    want, want_grad = jax.jit(jax.value_and_grad(
        lambda s: jl.total({k: jnp.asarray(v) for k, v in batch.items()}, {"scores": s})[0]))(
        jnp.asarray(out["scores"]))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    scores = torch.from_numpy(out["scores"]).requires_grad_(True)
    losses = Losses(cfg, "vqa2")
    total, parts = losses.total(tb, {"scores": scores})
    total.backward()
    assert list(parts) == [f"vqa2/{kind}"]
    np.testing.assert_allclose(float(total.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(scores.grad.numpy(), np.asarray(want_grad), rtol=1e-5,
                               atol=1e-7)
    halves = [losses.terms({k: v[s] for k, v in tb.items()}, {"scores": scores.detach()[s]})
              for s in (slice(0, 2), slice(2, 5))]
    ((key, (w, n0, d0)),), ((_, (_, n1, d1)),) = (h.items() for h in halves)
    value = w * ((n0 + n1).reshape(-1) / (d0 + d1).clamp_min(1.0).reshape(-1)).sum()
    np.testing.assert_allclose(float(value), float(want), rtol=1e-6)
    zeros = losses.zero_terms()[key]
    assert len(zeros[1]) == len(zeros[2]) == (3 if kind == "multi" else 1)


# -- optimizers -------------------------------------------------------------------

OPTIMIZERS = {
    "adamax": ({"type": "Adamax", "params": {"lr": 0.002, "eps": 1e-8, "weight_decay": 0}},
               {"clip_gradients": False}),
    "adamax_wd_clip": ({"type": "Adamax", "params": {"lr": 0.01, "eps": 1e-3,
                                                     "weight_decay": 0.1}},
                       {"clip_gradients": True, "max_grad_l2_norm": 0.25}),
    "sgd_momentum": ({"type": "SGD", "params": {"lr": 0.05, "momentum": 0.9,
                                                "weight_decay": 0.01}},
                     {"clip_gradients": True, "max_grad_l2_norm": 1.0}),
    "sgd": ({"type": "SGD", "params": {"lr": 0.05}}, {"clip_gradients": False}),
}


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Parameter(torch.tensor(np.random.default_rng(1).standard_normal(
            (3, 4)).astype(np.float32)))
        self.b = torch.nn.Parameter(torch.tensor(np.random.default_rng(2).standard_normal(
            5).astype(np.float32)))


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_adamax_and_sgd_follow_optax_step_by_step(case):
    """Five steps under the warmup and an lr step (the schedule at the
    optimizer's count) from the same gradients: the parameters after each
    equal optax's (build_optimizer of the JAX package); a state_dict taken
    after two steps and loaded into a fresh optimizer continues the same."""
    import optax
    from vitxtgqa_tpu.training.optim import build_optimizer as jax_build
    from vitxtgqa_tpu_torch.training.optim import build_optimizer

    oa, tp = OPTIMIZERS[case]
    tp = dict(tp, lr_scheduler=True, lr_steps=[3], lr_ratio=0.1, use_warmup=True,
              warmup_factor=0.2, warmup_iterations=2)
    net = _Net()
    opt = build_optimizer(net, oa, tp)
    tx, _ = jax_build(types.SimpleNamespace(**oa), types.SimpleNamespace(**tp))
    # copies: jnp.asarray may alias the numpy buffer that the torch update writes
    params = {k: jnp.array(getattr(net, k).detach().numpy().copy()) for k in ("a", "b")}
    state = tx.init(params)
    # under one jit: one XLA compile, not one per op
    update, apply_updates = jax.jit(tx.update), jax.jit(optax.apply_updates)
    rng = np.random.default_rng(4)
    saved = None
    for step in range(5):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        if step == 2:
            saved = copy.deepcopy(opt.state_dict())
            saved_params = copy.deepcopy(net.state_dict())
            later = grads
        # copies: clipping scales the gradients in place
        net.a.grad, net.b.grad = (torch.tensor(grads[k]) for k in ("a", "b"))
        opt.clip()
        opt.apply()
        if step == 2:
            after = copy.deepcopy(net.state_dict())
        updates, state = update({k: jnp.asarray(v) for k, v in grads.items()}, state, params)
        params = apply_updates(params, updates)
        for k in ("a", "b"):
            want = np.asarray(params[k])
            got = getattr(net, k).detach().numpy()
            assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max()), (step, k)
    fresh = _Net()
    fresh.load_state_dict(saved_params)
    resumed = build_optimizer(fresh, oa, tp)
    resumed.load_state_dict(saved)
    assert resumed.count == 2
    fresh.a.grad, fresh.b.grad = (torch.tensor(later[k]) for k in ("a", "b"))
    resumed.clip()
    resumed.apply()
    assert all(torch.equal(v, after[k]) for k, v in fresh.state_dict().items())


def test_an_unknown_optimizer_raises():
    from vitxtgqa_tpu_torch.training.optim import build_optimizer

    with pytest.raises(ValueError, match="rmsprop"):
        build_optimizer(_Net(), {"type": "RMSprop", "params": {}}, {})


# -- metrics ----------------------------------------------------------------------

def test_vqa_accuracy_and_temporal_accuracy_equal_the_jax_packages():
    import vitxtgqa_tpu.metrics.metrics as JM
    from vitxtgqa_tpu.metrics.evaluators import TempGroundAccuracyEvaluator as JTemp
    from vitxtgqa_tpu_torch.metrics import metrics as PM
    from vitxtgqa_tpu_torch.metrics.evaluators import TempGroundAccuracyEvaluator

    r = np.random.default_rng(0)
    scores = r.standard_normal((6, 9)).astype(np.float32)
    targets = ((r.random((6, 9)) < 0.4) * r.random((6, 9))).astype(np.float32)
    tensors, out = {"targets": targets, "question_id": np.arange(6)}, {"scores": scores}
    want = JM.VQAAccuracy()(tensors, out, {}, None)
    assert PM.VQAAccuracy()(tensors, out, {}, None) == want
    assert PM.VQAAccuracy()(tensors, {"pred_inds": scores.argmax(-1)}, {}, None) == want

    class Index:
        def __init__(self, rows):
            self.rows = rows

        def get(self, qid, default=None):
            return self.rows.get(int(qid), default)

    gts = {i: {"spatial_temporal_gt": [{"temporal_gt": [0.1 * i, 0.1 * i + 0.3]}], "fps": 10,
               "width": 64, "height": 48} for i in range(5)}  # question 5 unannotated
    out = {"ground_frame": r.integers(0, 8, (6, 2)), "ground_box": r.random((6, 4, 4)),
           "frame_topk": 2, "ocr_topk": 2}
    ctxs = [m.MetricContext(None, Index(gts)) for m in (PM, JM)]
    got = PM.TemporalAccuracy()(tensors, out, {}, ctxs[0])
    assert got == JM.TemporalAccuracy()(tensors, out, {}, ctxs[1]) and 0.0 < got < 1.0
    preds = [{"st_gt": gts[i]["spatial_temporal_gt"], "video_fps": 10,
              "pred_frame": [1 + i, 5]} for i in range(5)]
    assert TempGroundAccuracyEvaluator().eval_pred_list(preds) == JTemp().eval_pred_list(preds)
    metrics = PM.Metrics([{"type": "vqa_accuracy"}, {"type": "temporal_accuracy"}], "vqa2")
    assert list(metrics({"targets": targets}, {"scores": scores}, {},
                        PM.MetricContext(None))) == ["vqa2/vqa_accuracy"]


# -- beam search ----------------------------------------------------------------------

def test_beam_search_equals_the_jax_packages():
    """The greedy-equivalence case of tests/test_aux_components.py, then a
    stateful step function with ties and an EOS, with and without the
    length penalty: tokens equal, scores within 1e-6."""
    from vitxtgqa_tpu.ops.beam_search import beam_search as jax_beam
    from vitxtgqa_tpu_torch.ops.beam_search import beam_search

    table = np.asarray([[0.0, 0.1, 3.0, 0.2, 0.1, 0.0], [0.0, 2.5, 0.0, 0.1, 0.0, 0.3]],
                       np.float32)
    tokens, scores = beam_search(lambda t, s, i: (torch.from_numpy(table)[t % 2], s),
                                 torch.zeros(6, 1), batch=2, num_beams=3, bos_id=0, eos_id=5,
                                 max_len=4)
    # under one jit: one XLA compile, not one per op
    jt, js = jax.jit(lambda s0: jax_beam(lambda t, s, i: (jnp.asarray(table)[t % 2], s), s0,
                                         batch=2, num_beams=3, bos_id=0, eos_id=5,
                                         max_len=4))(jnp.zeros((6, 1)))
    assert tokens.shape == (2, 3, 4) and int(tokens[0, 0, 0]) == 2
    assert tokens.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=1e-6)

    w = np.random.default_rng(0).standard_normal((7, 7)).astype(np.float32)
    w[:, 4] = w[:, 3]  # tied tokens: the lower index first

    def step(lib):
        def fn(tok, state, t):
            h = state["h"] * 0.5 + lib.asarray(w)[tok]
            return h * 2.0, {"h": h, "n": state["n"] + 1}
        return fn

    for penalty in (0.0, 0.7):
        kw = dict(batch=2, num_beams=3, bos_id=1, eos_id=6, max_len=5, length_penalty=penalty)
        tokens, scores = beam_search(step(torch), {"h": torch.zeros(6, 7),
                                                   "n": torch.zeros(6)}, **kw)
        jt, js = jax.jit(lambda s0: jax_beam(step(jnp), s0, **kw))(
            {"h": jnp.zeros((6, 7)), "n": jnp.zeros(6)})
        assert tokens.tolist() == np.asarray(jt).tolist(), penalty
        np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=1e-6)
