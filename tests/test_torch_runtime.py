"""The port's runtime against the JAX package's: config, data, metrics,
the trainer, checkpoints and the CLI (``python -m vitxtgqa_tpu_torch.run``).

CPU, on fixture trees written by tools/make_fixtures.py into a temporary
directory per module.  Tolerances: configs, batches and the metrics of
the same predictions exactly equal; the trainer against the JAX trainer at
tiny width (float32, dropout 0, the gumbel noise injected from numpy into
both) each step's loss within rtol 1e-5, the parameters after three steps
as tests/test_torch_train.py holds gradients (1e-4 of each tensor's
largest change plus 1e-3 relative), the validation metrics equal and its
losses within rtol 1e-5; a resumed run equal to an uninterrupted one bit
for bit.
"""

import json
import os
import random

import jax
import numpy as np
import pytest
import torch

from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.core.registry import registry as port_registry
from vitxtgqa_tpu_torch.run import run as port_run, setup_imports

CONFIGS = ("t2s_abinet.yml", "t2s_serving.yml")
SIX = ("textvqa_accuracy", "stvqa_anls", "IOU@0.3", "IOU@0.5", "GQA@0.3", "GQA@0.5")
TINY = {"hidden_size": 64, "num_attention_heads": 4, "intermediate_size": 128,
        "num_hidden_layers": 1}
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
# the tiny data geometry (utils/synthetic.tiny_model_config's): 8 frames
# sampled from each fixture video, 3 OCR slots a frame, top-2 grounding
FRAMES, OCR_PER_FRAME, TOPK = 8, 3, 2
OCR = FRAMES * OCR_PER_FRAME


@pytest.fixture(scope="module")
def fixroot(tmp_path_factory):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(os.path.dirname(__file__), "..", "tools", "make_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    root = str(tmp_path_factory.mktemp("fixtures"))
    tool.main(root)
    return root


def _cfg(repo_root, name):
    return os.path.join(repo_root, "configs", name)


def tiny_opts(fixroot, save_dir, dropout=True, **tp):
    """CLI opts: the fixtures, the CPU in float32, batch 2, tiny widths
    (hidden 64, one layer a stack) and data geometry (FRAMES x
    OCR_PER_FRAME), ``dropout=False`` every dropout 0."""
    opts = [f"dataset_attributes.vtextgqa.data_root_dir={fixroot}",
            "training_parameters.device=cpu", "training_parameters.tpu.compute_dtype=float32",
            "training_parameters.batch_size=2", "training_parameters.num_workers=0",
            f"training_parameters.save_dir={save_dir}", "training_parameters.seed=13"]
    for sect in ("text_bert", "translayers", "mmt"):
        sect_opts = {**TINY, **({} if dropout else NO_DROPOUT)}
        opts += [f"model_attributes.t2s.{sect}.{k}={v}" for k, v in sect_opts.items()]
    ds = "dataset_attributes.vtextgqa"
    opts += [f"{ds}.frames={FRAMES}", f"{ds}.ocr_frame_num={OCR_PER_FRAME}"]
    opts += [f"{ds}.processors.{p}.params.max_length={OCR}"
             for p in ("answer_processor", "copy_processor", "phoc_processor", "context_processor")]
    g = "model_attributes.t2s.grounding"
    opts += [f"{g}.hidden_size=64", f"{g}.frame_num={FRAMES}", f"{g}.ocr_frame_num={OCR_PER_FRAME}",
             f"{g}.max_ocr_num={OCR}", f"{g}.frame_topk={TOPK}", f"{g}.ocr_topk={TOPK}",
             f"model_attributes.t2s.classifier.ocr_max_num={OCR}",
             "model_attributes.t2s.classifier.ocr_ptr_net.hidden_size=64",
             "model_attributes.t2s.classifier.ocr_ptr_net.query_key_size=64"]
    if not dropout:
        opts += ["model_attributes.t2s.obj.dropout_prob=0.0",
                 "model_attributes.t2s.ocr.dropout_prob=0.0"]
    opts += [f"training_parameters.{k}={v}" for k, v in tp.items()]
    return opts


TRAIN3 = dict(max_iterations=3, log_interval=1, snapshot_interval=3, warmup_iterations=2)


def _cli(repo_root, config="t2s_abinet.yml", run_type="train"):
    return ["--config", _cfg(repo_root, config), "--model", "t2s", "--datasets", "vtextgqa",
            "--run_type", run_type]


# ---------------------------------------------------------------------------
# config, registry
# ---------------------------------------------------------------------------


CONFIG_OPTS = {"none": [], "opts": ["training_parameters.batch_size=6",
                                     "model_attributes.t2s.mmt.num_hidden_layers=1",
                                     "training_parameters.tpu.kv_cache_int8", "True",
                                     "dataset_attributes.vtextgqa.frames=32"]}


@pytest.mark.parametrize("opts", sorted(CONFIG_OPTS))
@pytest.mark.parametrize("name", CONFIGS)
def test_build_config_equals_the_jax_packages(repo_root, name, opts):
    from vitxtgqa_tpu.core.config import build_config as jax_build
    from vitxtgqa_tpu.core.flags import get_parser as jax_parser
    from vitxtgqa_tpu_torch.core.config import DEFAULTS_DIR, build_config
    from vitxtgqa_tpu_torch.core.flags import get_parser

    argv = _cli(repo_root, name) + ["--seed", "5"] + CONFIG_OPTS[opts]
    args, jargs = get_parser().parse_args(argv), jax_parser().parse_args(argv)
    assert vars(args) == vars(jargs)
    got = build_config(args.config, opts=args.opts, args=args, config_override='{"x": {"y": 1}}')
    want = jax_build(jargs.config, opts=jargs.opts, args=jargs, config_override='{"x": {"y": 1}}')
    assert got.to_dict() == want.to_dict()
    assert DEFAULTS_DIR.startswith(os.path.join(repo_root, "vitxtgqa_tpu_torch"))


def test_the_ports_defaults_are_copies(repo_root):
    """defaults/configs holds base.yml and every file the includes of the
    T2S-family configs reach (the two T2S configs, M4C's, T5-ViteVQA's and
    GT-box's, whose T2S_human.yml includes gt_box.yml) and the legacy
    image-VQA datasets' defaults (vqa2, vizwiz, textvqa), each a copy of
    the JAX package's."""
    from vitxtgqa_tpu_torch.core.config import DEFAULTS_DIR

    rels = sorted(os.path.relpath(os.path.join(d, f), DEFAULTS_DIR)
                  for d, _, names in os.walk(DEFAULTS_DIR) for f in names)
    videoqa, vqa = os.path.join("datasets", "videoqa"), os.path.join("datasets", "vqa")
    assert rels == ["base.yml"] + [os.path.join(videoqa, f) for f in (
        "T2S_human.yml", "gt_box.yml", "vtextgqa.yml")] + [
        os.path.join(vqa, f) for f in ("textvqa.yml", "vizwiz.yml", "vqa2.yml")]
    for rel in rels:
        jax_copy = os.path.join(repo_root, "vitxtgqa_tpu", "defaults", "configs", rel)
        assert open(os.path.join(DEFAULTS_DIR, rel)).read() == open(jax_copy).read(), rel


def test_the_ports_registry_is_its_own():
    """Nothing registered in the JAX registry is seen in the port's and the
    other way round; a later registration replaces an earlier one;
    clear_state drops the state store."""
    import vitxtgqa_tpu
    from vitxtgqa_tpu.core.registry import registry as jax_registry

    vitxtgqa_tpu.setup_imports()
    setup_imports()
    assert port_registry is not jax_registry
    assert port_registry.get_model_class("t2s").__module__ == "vitxtgqa_tpu_torch.models.t2s"
    assert jax_registry.get_model_class("t2s").__module__ == "vitxtgqa_tpu.models.t2s"
    assert sorted(port_registry.list("model")) == sorted(
        ["t2s", "t2s_wo_tg", "t2s_wo_sg", "m4c", "t5vitevqa", "gt_box", "T2S_human", "transtr",
         "mist", "pythia", "pythia_question_only", "pythia_image_only", "lorra", "ban",
         "top_down_bottom_up"])
    assert {"m4c", "transtr", "pythia", "ban"} <= set(jax_registry.list("model"))
    assert sorted(port_registry.list("builder")) == sorted(
        ["gt_box", "gt_box_clipocr", "vtextgqa", "vqa2", "vizwiz", "textvqa", "vqa2_ocr"])
    # every processor and metric of the JAX registry
    for kind in ("processor", "metric"):
        assert set(jax_registry.list(kind)) <= set(port_registry.list(kind)), kind
    for kind in ("model", "builder"):
        for name in port_registry.list(kind):
            assert port_registry._get_class(kind, name).__module__.startswith(
                "vitxtgqa_tpu_torch."), (kind, name)
    assert sorted(port_registry.list("metric")) == sorted(SIX + ("vqa_accuracy",
                                                                  "temporal_accuracy"))
    for kind in ("processor", "builder", "metric", "trainer"):
        for name in port_registry.list(kind):
            assert port_registry._get_class(kind, name).__module__.startswith("vitxtgqa_tpu_torch.")

    class A:
        pass

    class B:
        pass

    old = port_registry.get_processor_class("copy")
    try:
        port_registry.register_processor("copy")(A)
        port_registry.register_processor("copy")(B)
        assert port_registry.get_processor_class("copy") is B
        assert jax_registry.get_processor_class("copy") is not B
    finally:
        port_registry.register_processor("copy")(old)
    port_registry.register("probe", 1)
    assert port_registry.get("probe") == 1 and jax_registry.get("probe") is None
    port_registry.clear_state()
    assert port_registry.get("probe") is None


# ---------------------------------------------------------------------------
# data and metrics
# ---------------------------------------------------------------------------


def _datasets(repo_root, fixroot, split):
    """(port dataset, JAX dataset) of one split from the same config, their
    answer-sequence generators seeded alike (the processor draws from an
    unseeded numpy generator in both packages)."""
    import vitxtgqa_tpu
    from vitxtgqa_tpu.core.config import build_config as jax_build
    from vitxtgqa_tpu.core.registry import registry as jax_registry
    from vitxtgqa_tpu_torch.core.config import build_config

    vitxtgqa_tpu.setup_imports()
    setup_imports()
    opts = [f"dataset_attributes.vtextgqa.data_root_dir={fixroot}"]
    cfg = build_config(_cfg(repo_root, "t2s_abinet.yml"), opts=opts)
    jcfg = jax_build(_cfg(repo_root, "t2s_abinet.yml"), opts=opts)
    port = port_registry.get_builder_class("vtextgqa")().load(
        split, cfg.dataset_attributes.vtextgqa, seed=13)
    jax_ds = jax_registry.get_builder_class("vtextgqa")().load(
        split, jcfg.dataset_attributes.vtextgqa, seed=13)
    for ds in (port, jax_ds):
        ds.answer_processor.processor.rng = np.random.default_rng(7)
    return port, jax_ds


def _assert_batches_equal(got, want):
    assert sorted(got["tensors"]) == sorted(want["tensors"])
    for k, w in want["tensors"].items():
        g = got["tensors"][k]
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        assert np.array_equal(g, w), k
    for k, w in want["host"].items():
        assert got["host"][k] == w, k


def test_train_batches_equal_the_jax_loaders(repo_root, fixroot):
    """Two train epochs in the epoch-seeded order: every key, dtype, shape
    and host field bit for bit; each port batch tagged with its epoch and
    index."""
    from vitxtgqa_tpu.data.loader import DataLoader as JLoader, infinite_batches as jinf
    from vitxtgqa_tpu_torch.data.loader import DataLoader, infinite_batches

    port, jax_ds = _datasets(repo_root, fixroot, "train")
    assert len(port) == len(jax_ds) == 12
    kw = dict(batch_size=2, shuffle=True, seed=13, drop_last=True)
    pl, jl = DataLoader(port, **kw), JLoader(jax_ds, **kw)
    assert len(pl) == len(jl) == 6
    got, want = infinite_batches(pl), jinf(jl)
    for i in range(2 * len(pl)):
        g, w = next(got), next(want)
        assert (g["host"].pop("epoch"), g["host"].pop("epoch_batch")) == divmod(i, 6)
        g["host"].pop("data_rng")
        _assert_batches_equal(g, w)


def test_padded_val_batches_equal_the_jax_loaders(repo_root, fixroot):
    """The val split (6 questions) at batch 4: the last batch padded with
    copies of its last sample, n_valid 2, bit for bit."""
    from vitxtgqa_tpu.data.loader import DataLoader as JLoader
    from vitxtgqa_tpu_torch.data.loader import DataLoader

    port, jax_ds = _datasets(repo_root, fixroot, "val")
    kw = dict(batch_size=4, shuffle=False, drop_last=False, pad_last=True)
    got, want = list(DataLoader(port, **kw)), list(JLoader(jax_ds, **kw))
    assert len(got) == len(want) == 2
    assert [b["host"]["n_valid"] for b in got] == [4, 2]
    for g, w in zip(got, want):
        g["host"].pop("data_rng")
        _assert_batches_equal(g, w)
    last = got[-1]["tensors"]["question_id"]
    assert last[2] == last[3] == last[1]


def test_a_batch_carries_the_generator_state_it_leaves(repo_root, fixroot):
    """With no workers each batch carries the dataset's host generator
    state after its assembly; setting it on a fresh dataset reproduces the
    next batch bit for bit, and iter_from skips to it."""
    from vitxtgqa_tpu_torch.data.loader import DataLoader

    port, _ = _datasets(repo_root, fixroot, "train")
    loader = DataLoader(port, batch_size=2, shuffle=True, seed=13, drop_last=True)
    first = list(loader)
    fresh, _ = _datasets(repo_root, fixroot, "train")
    fresh.set_rng_state(first[2]["host"]["data_rng"])
    again = next(DataLoader(fresh, batch_size=2, shuffle=True, seed=13, drop_last=True).iter_from(3))
    _assert_batches_equal(again, first[3])


def test_worker_batches_depend_on_their_place_alone(repo_root, fixroot):
    """With worker processes each sample draws from generators seeded by
    (seed, epoch, index): two epochs at one and at two workers give the
    same batches bit for bit, iter_from resumes on them, and close stops
    the pool."""
    from vitxtgqa_tpu_torch.data.loader import DataLoader, infinite_batches

    port, _ = _datasets(repo_root, fixroot, "train")
    kw = dict(batch_size=2, shuffle=True, seed=13, drop_last=True)
    loaders = [DataLoader(port, num_workers=n, **kw) for n in (1, 2)]
    try:
        runs = [[next(it) for _ in range(12)] for it in map(infinite_batches, loaders)]
        for g, w in zip(*runs):
            assert "data_rng" not in g["host"]
            _assert_batches_equal(g, w)
        loaders[1].set_epoch(1)
        again = next(loaders[1].iter_from(3))
        again["host"].update(epoch=1, epoch_batch=3)
        _assert_batches_equal(again, runs[0][9])
    finally:
        for loader in loaders:
            loader.close()
    assert all(loader._pool is None for loader in loaders)


_WORKER_PROBE = """
import sys

import numpy as np

from vitxtgqa_tpu_torch.data.loader import DataLoader


class Samples:
    def __len__(self):
        return 8

    def seed_sample(self, entropy):
        pass

    def __getitem__(self, i):
        return {"x": np.full(3, i, np.float32)}


if __name__ == "__main__":
    loader = DataLoader(Samples(), batch_size=2, num_workers=2)
    print(sum(int(b["tensors"]["x"].shape[0]) for b in loader))
    loader.close()
"""


def _session_processes(sid: int) -> list:
    """The command lines of the live processes of session ``sid``."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        # state, ppid, pgrp, session
        if int(fields[3]) == sid and fields[0] != "Z":
            out.append(cmd)
    return out


def test_a_worker_loader_leaves_no_process_behind(repo_root, tmp_path):
    """A program that assembled batches in worker processes leaves none of
    the processes it started running once it has exited: the forkserver
    and the resource tracker are stopped at exit, not a moment after."""
    import subprocess
    import sys

    (tmp_path / "probe.py").write_text(_WORKER_PROBE)
    env = {**os.environ, "PYTHONPATH": repo_root}
    # its output goes to a file: the servers inherit it, and a pipe would
    # stay open until they too had exited
    with open(tmp_path / "out.txt", "w") as out:
        proc = subprocess.Popen([sys.executable, "probe.py"], cwd=tmp_path, env=env,
                                stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
        rc = proc.wait(timeout=300)
    left = _session_processes(proc.pid)
    said = (tmp_path / "out.txt").read_text()
    assert rc == 0, said
    assert said.split() == ["8"]
    assert left == []


@pytest.mark.parametrize("reference_compat", [False, True], ids=["fixed", "reference_compat"])
def test_metrics_equal_the_jax_packages(repo_root, fixroot, reference_compat):
    """The same predictions on a val batch through both Metrics: the six
    values of configs/t2s_abinet.yml exactly equal, and decode_answers
    alike."""
    from vitxtgqa_tpu.metrics import evaluators as jev
    from vitxtgqa_tpu.metrics.metrics import MetricContext as JCtx, Metrics as JMetrics
    from vitxtgqa_tpu.metrics.metrics import decode_answers as jdecode
    from vitxtgqa_tpu_torch.data.dataset import collate
    from vitxtgqa_tpu_torch.metrics.metrics import MetricContext, Metrics, decode_answers

    port, jax_ds = _datasets(repo_root, fixroot, "val")
    batch = collate([port[i] for i in range(len(port))])
    b, vocab = len(port), port.answer_processor.get_true_vocab_size()
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((b, 12, vocab + 960)).astype(np.float32)
    # aim a few rows at their answers: an OCR slot holding the answer, then EOS
    for i in range(0, b, 2):
        slot = batch["host"]["context_tokens"][i].index(batch["host"]["answers_tiled"][i][0])
        scores[i, 0, vocab + slot] = scores[i, 1, port.answer_processor.EOS_IDX] = 50.0
    ctx = MetricContext.from_config(port.config, "val", port.answer_processor)
    jctx = JCtx.from_config(jax_ds.config, "val", jax_ds.answer_processor)
    for hit in (True, False):
        frames = np.tile(np.arange(1, 6), (b, 1))
        boxes = rng.random((b, 25, 4)).astype(np.float32)
        if hit:  # every predicted box of row 0 on its annotated box
            gt = ctx.ground_index.get(int(batch["tensors"]["question_id"][0]))
            span = gt["spatial_temporal_gt"][0]
            (key, box), = span["bbox_gt"].items()
            frames[0, 0] = int(key) + 1
            boxes[0, :5] = np.asarray(box) / [gt["width"], gt["height"], gt["width"],
                                              gt["height"]]
        out = {"pos_scores": scores, "ground_frame": frames, "ground_box": boxes,
               "frame_topk": 5, "ocr_topk": 5}
        metrics = [{"type": t} for t in SIX]
        jev.set_reference_compat(reference_compat)
        got = Metrics(metrics, reference_compat=reference_compat)(
            batch["tensors"], out, batch["host"], ctx)
        want = JMetrics(metrics)(batch["tensors"], out, batch["host"], jctx)
        assert got == want and sorted(got) == sorted(f"vtextgqa/{t}" for t in SIX)
        assert all(0.0 <= v <= 1.0 for v in got.values())
        if hit:
            assert got["vtextgqa/textvqa_accuracy"] > 0 and got["vtextgqa/IOU@0.5"] > 0
    inds = scores.argmax(-1)
    assert decode_answers(inds, batch["host"]["context_tokens"], port.answer_processor) == \
        jdecode(inds, batch["host"]["context_tokens"], jax_ds.answer_processor)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _noise(b=2):
    rng = np.random.default_rng(5)
    return {(b, 2, FRAMES): rng.gumbel(size=(b, 2, FRAMES)).astype(np.float32),
            (b, 2, OCR): rng.gumbel(size=(b, 2, OCR)).astype(np.float32)}


def _inject_port_noise(monkeypatch, noise):
    """The port trainer's gumbel draws: the numpy noise, for every step."""
    from vitxtgqa_tpu_torch.training import trainer as T

    real = T.step_generators

    def gens(seed, step, device, group=None):
        dropout_gen, _ = real(seed, step, device, group)
        return dropout_gen, tuple(torch.from_numpy(noise[(2, 2, n)]) for n in (FRAMES, OCR))

    monkeypatch.setattr(T, "step_generators", gens)


def _reseed_data(trainer, seed=13):
    """Both trainers' datasets restart their host generators from the same
    states (the JAX trainer draws an example batch at load, and the answer
    processor's generator is unseeded)."""
    for ds in trainer.datasets.values():
        ds.rng = random.Random(seed)
        ds.answer_processor.processor.rng = np.random.default_rng(7)


def _port_trainer(repo_root, argv, monkeypatch=None, noise=None):
    """A loaded port trainer (run()'s steps without train())."""
    from vitxtgqa_tpu_torch.core.config import build_config
    from vitxtgqa_tpu_torch.core.flags import get_parser

    setup_imports()
    args = get_parser().parse_args(argv)
    cfg = build_config(args.config, opts=args.opts, args=args)
    if noise is not None:
        _inject_port_noise(monkeypatch, noise)
    trainer = port_registry.get_trainer_class("base_trainer")(cfg)
    trainer.load()
    return trainer


def _series(meter, key):
    return list(meter[key].series)


def test_trainer_trajectory_matches_the_jax_trainer(repo_root, fixroot, tmp_path, monkeypatch):
    """The JAX BaseTrainer and the port's, driven through their own objects
    (load, then train: three steps, the snapshot's validation and the final
    one) on the fixtures from the same initial weights (the JAX trainer's,
    converted): each step's losses, the parameters after three steps, and
    the validation losses and metrics."""
    import flax
    import vitxtgqa_tpu
    from tests.test_torch_train import _assert_grads_close, _patch_jax_gumbel, _tree_to_port
    from vitxtgqa_tpu.core.config import build_config as jax_build
    from vitxtgqa_tpu.core.flags import get_parser as jax_parser
    from vitxtgqa_tpu.core.registry import registry as jax_registry

    noise = _noise()
    _patch_jax_gumbel(monkeypatch, noise)
    vitxtgqa_tpu.setup_imports()
    # the JAX trainer initialises its model eagerly, an XLA compile per op
    # on the CPU (~40 s): the same init under one jit
    from vitxtgqa_tpu.models.t2s import T2S as JT2S

    def jit_init(self, rngs, batch, train=False):
        return jax.jit(lambda r, b: flax.linen.Module.init(self, r, b, train=train))(rngs, batch)

    monkeypatch.setattr(JT2S, "init", jit_init)
    argv = _cli(repo_root) + tiny_opts(fixroot, tmp_path / "jax", dropout=False, **TRAIN3)
    jargs = jax_parser().parse_args(argv)
    jtrainer = jax_registry.get_trainer_class("base_trainer")(
        jax_build(jargs.config, opts=jargs.opts, args=jargs))
    jtrainer.load()
    # copies: the JAX trainer donates its parameter buffers to its steps
    init = _tree_to_port(jax.tree_util.tree_map(np.array, jtrainer.params))

    argv = _cli(repo_root) + tiny_opts(fixroot, tmp_path / "port", dropout=False, **TRAIN3)
    trainer = _port_trainer(repo_root, argv, monkeypatch, noise)
    trainer.model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    for t in (jtrainer, trainer):
        _reseed_data(t)
    jtrainer.train()
    trainer.train()

    for key in ("train/total_loss", "train/vtextgqa/pos_bce_loss", "train/vtextgqa/InfoNCE"):
        got, want = _series(trainer.meter, key), _series(jtrainer.meter, key)
        assert len(got) == len(want) == 3, key
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)
    want = _tree_to_port(jax.tree_util.tree_map(np.asarray, jtrainer.params))
    got = {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}
    # the key biases start at 0 and have a gradient of float32 noise (softmax
    # is shift-invariant), which Adam turns into steps of either sign: held
    # to stay that small
    noise = [k for k in want if k.endswith("attention.self.key.bias")]
    assert noise and all(max(abs(got[k]).max(), abs(want[k]).max()) < 1e-6 for k in noise)
    _assert_grads_close({k: got[k] for k in want if k not in noise},
                        {k: want[k] for k in want if k not in noise}, 1e-4, 1e-3)
    # each tensor's change over the three steps alike in direction and size
    # (elementwise, a gradient near float32 noise can flip its Adam step)
    for k in want:
        g, w = (got[k] - init[k]).ravel(), (want[k] - init[k]).ravel()
        if k in noise or not np.any(w):
            continue
        cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
        ratio = float(np.linalg.norm(g) / np.linalg.norm(w))
        assert cos > 0.999 and abs(ratio - 1) < 1e-3, (k, cos, ratio)
    vals = [k for k in jtrainer.meter.meters if k.startswith("val/")]
    assert sorted(vals) == sorted(k for k in trainer.meter.meters if k.startswith("val/"))
    assert {f"val/vtextgqa/{t}" for t in SIX} <= set(vals)
    for key in vals:
        got, want = _series(trainer.meter, key), _series(jtrainer.meter, key)
        if "loss" in key or "InfoNCE" in key:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)
        else:
            assert got == want, key


def _state(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def _assert_states_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("workers", [0, 2])
def test_resume_equals_an_uninterrupted_run(repo_root, fixroot, tmp_path, workers):
    """Four steps straight against three, a snapshot, and a resume from it
    for the fourth (dropout on), with the batches assembled in the trainer
    or in worker processes: the restored parameters, optimizer state,
    iteration, epoch position and early-stopping state are the saved ones,
    and the fourth step's loss and parameters equal the uninterrupted
    run's bit for bit."""
    from vitxtgqa_tpu_torch.training.checkpoint import Checkpoint

    def trainer(save, resume=None, **tp):
        argv = _cli(repo_root) + tiny_opts(fixroot, tmp_path / save, **{
            **TRAIN3, "snapshot_interval": 3, "num_workers": workers, **tp})
        if resume:
            argv += [f"training_parameters.resume_file={resume}"]
        t = _port_trainer(repo_root, argv)
        if not resume:
            _reseed_data(t)
        return t

    straight = trainer("straight", max_iterations=4)
    straight.train()
    first = trainer("first")
    first.train()
    best = os.path.join(str(tmp_path), "first", "ckpt", "best")
    saved = Checkpoint(str(tmp_path / "first")).load(best)
    meta = json.load(open(os.path.join(best, "meta.json")))
    assert (meta["iteration"], meta["epoch"], meta["epoch_batch"]) == (3, 0, 3)

    resumed = trainer("resumed", resume=best, max_iterations=4)
    assert (resumed.iteration, resumed.current_epoch, resumed.epoch_batch) == (3, 0, 3)
    assert (resumed.early_stopping.best_iteration, resumed.early_stopping.best_value) == (
        first.early_stopping.best_iteration, first.early_stopping.best_value)
    _assert_states_equal(_state(resumed), saved["model"])
    opt = resumed.optimizer.state_dict()
    assert opt["count"] == first.optimizer.count == 3
    for i, s in saved["optimizer"]["adam"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt["adam"]["state"][i][k], s[k]), (i, k)
    resumed.train()
    for t in (straight, first, resumed):
        t.close()
    got, want = _series(resumed.meter, "train/total_loss"), _series(straight.meter,
                                                                    "train/total_loss")
    assert len(got) == 1 and len(want) == 4 and got[0] == want[3]
    finals = [Checkpoint(str(tmp_path / d)).load(
        os.path.join(str(tmp_path), d, "ckpt", "final"))["model"] for d in ("resumed", "straight")]
    _assert_states_equal(*finals)


def test_a_reference_style_model_blob_loads(repo_root, fixroot, tmp_path):
    """A torch file holding {"model": state_dict} with DataParallel
    ``module.`` prefixes restores the model's weights (only)."""
    argv = _cli(repo_root) + tiny_opts(fixroot, tmp_path / "a")
    donor = _port_trainer(repo_root, argv)
    weights = {k: v + 1.0 if v.is_floating_point() else v for k, v in _state(donor).items()}
    blob = str(tmp_path / "ref.pth")
    torch.save({"model": {f"module.{k}": v for k, v in weights.items()}, "iteration": 7}, blob)
    loaded = _port_trainer(repo_root, argv + [f"training_parameters.resume_file={blob}"])
    _assert_states_equal(_state(loaded), weights)
    assert loaded.iteration == 0


@pytest.mark.parametrize("workers", [0, 2])
def test_cli_trains_validates_checkpoints_and_predicts(repo_root, fixroot, tmp_path, workers):
    """``run([...])`` in-process, as tests/test_e2e_slice.py runs the JAX
    CLI: three steps on configs/t2s_abinet.yml write ckpt/best and
    ckpt/final and log the six val/ metrics; then configs/t2s_serving.yml
    (int8 cache, compact serving) predicts the test split from the best
    checkpoint into the JSON the JAX trainer writes.  With and without
    worker processes (the config's own path: num_workers 8), which run()
    stops at its end."""
    save = tmp_path / "save"
    trainer = port_run(_cli(repo_root) + tiny_opts(fixroot, save, num_workers=workers, **TRAIN3))
    assert all(loader._pool is None for loader in trainer.loaders.values())
    assert trainer.iteration == 3
    for d in ("best", "final"):
        assert os.path.exists(os.path.join(str(save), "ckpt", d, "state.pt")), d
    scalars = trainer.meter.get_scalar_dict()
    for t in SIX:
        assert 0.0 <= scalars[f"val/vtextgqa/{t}"] <= 1.0, t
    assert all(np.isfinite(v) for v in _series(trainer.meter, "train/total_loss"))
    assert len(trainer.timings["iteration_ms"]) == 3 and len(trainer.timings["val_ms"]) == 2

    best = os.path.join(str(save), "ckpt", "best")
    pred = port_run(_cli(repo_root, "t2s_serving.yml", "inference")
                    + tiny_opts(fixroot, tmp_path / "pred", num_workers=workers)
                    + [f"training_parameters.resume_file={best}"])
    assert pred.model.inference_only and pred.opts.kv_cache_int8 and pred.opts.compact_serving
    (report,) = os.listdir(os.path.join(str(tmp_path), "pred", "reports"))
    rows = json.load(open(os.path.join(str(tmp_path), "pred", "reports", report)))
    assert len(rows) == len(pred.datasets["test"]) == 6
    for row in rows:
        assert sorted(row) == sorted(["question_id", "video_id", "answer", "grounded frame",
                                      "grounded box", "pred_source"])
        assert len(row["grounded frame"]) == TOPK
        assert np.asarray(row["grounded box"]).shape == (FRAMES * TOPK, 4)
        assert set(row["pred_source"]) <= {"OCR", "VOCAB"}


_AUDIT = r"""
import json, os, sys
repo, argv = sys.argv[1], json.loads(sys.argv[2])
jax_dir = os.path.join(repo, "vitxtgqa_tpu") + os.sep
opened = []
sys.addaudithook(lambda ev, args: ev == "open" and isinstance(args[0], str)
                 and os.path.abspath(args[0]).startswith(jax_dir) and opened.append(args[0]))
sys.path.insert(0, repo)
from vitxtgqa_tpu_torch.run import run
run(argv)
print(json.dumps({"opened": opened, "modules": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vitxtgqa_tpu"))}))
"""


def test_the_runtime_reads_nothing_of_the_jax_package(repo_root, fixroot, tmp_path):
    """A training run of the CLI in a fresh process opens no file under
    vitxtgqa_tpu/ and imports no module of JAX or the JAX package (the
    static import check is test_torch_train.py's
    test_no_port_module_imports_jax_or_the_jax_package)."""
    import subprocess
    import sys

    argv = _cli(repo_root) + tiny_opts(fixroot, tmp_path / "s", max_iterations=1,
                                       snapshot_interval=1)
    proc = subprocess.run([sys.executable, "-c", _AUDIT, repo_root, json.dumps(argv)],
                          cwd=str(tmp_path), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"opened": [], "modules": []}


# ---------------------------------------------------------------------------
# the config's switches onto Options, run()'s refusals, entry()
# ---------------------------------------------------------------------------


def _tp(device="cpu", batch_size=None, **tpu):
    from vitxtgqa_tpu_torch.core.config import ConfigNode

    tp = {"device": device, "tpu": tpu}
    if batch_size is not None:
        tp["batch_size"] = batch_size
    return ConfigNode(tp)


def _world(monkeypatch, size: int):
    """options_from_config in a torch.distributed world of ``size``
    processes (the data axis reads the world size)."""
    from vitxtgqa_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "process_count", lambda: size)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cuda(monkeypatch):
    """options_from_config as on a machine with a card (Options builds no
    tensor)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


# (device, tpu switches, whether CUDA is there, the error's type and words)
REFUSALS = {
    "auto_without_cuda": ("auto", {}, False, RuntimeError, "device=cpu"),
    "cuda_without_cuda": ("cuda", {}, False, RuntimeError, "device=cpu"),
    "float32_on_the_card": ("auto", {"compute_dtype": "float32"}, True, ValueError,
                            "compute_dtype=bfloat16"),
    "float16": ("cpu", {"compute_dtype": "float16"}, False, ValueError, "computes in"),
    "use_pallas_false_on_the_card": ("auto", {"use_pallas": False}, True, ValueError,
                                     "never the main path"),
    "fused_grads": ("cpu", {"fused_grads": True}, False, NotImplementedError, "queue 1 item 6"),
    "compact_train": ("cpu", {"compact_train": True}, False, NotImplementedError,
                      "queue 1 item 6"),
    "dense_mm": ("cpu", {"dense_mm": True}, False, NotImplementedError, "queue 1 item 6"),
    "split_dense": ("cpu", {"split_dense": True}, False, NotImplementedError, "queue 1 item 6"),
    "remat_full": ("cpu", {"remat": "full"}, False, ValueError, "queue 1 item 6"),
    "remat_dots": ("cpu", {"remat": "dots"}, False, ValueError, "queue 1 item 6"),
    "remat_attn_qkv": ("cpu", {"remat": "attn_qkv"}, False, ValueError, "queue 1 item 6"),
    "mesh_sp_2": ("cpu", {"mesh": {"data": -1, "sp": 2}}, False, NotImplementedError,
                  "queue 1 item 5"),
    "mesh_model_2": ("cpu", {"mesh": {"model": 2}}, False, NotImplementedError,
                     "tensor parallelism .*queue 1 item 5"),
    "mesh_pp_2": ("cpu", {"mesh": {"pp": 2}}, False, NotImplementedError,
                  "pipeline parallelism .*queue 1 item 5"),
    "mesh_data_2_sp_2": ("cpu", {"mesh": {"data": 2, "sp": 2}}, False, NotImplementedError,
                         "data axis together with sequence parallelism .*queue 1 item 5"),
    "mesh_data_not_the_world": ("cpu", {"mesh": {"data": 3}}, False, ValueError,
                                "spans the world of 2"),
    "batch_not_divisible": ("cpu", {"mesh": {"data": -1}}, False, ValueError,
                            "batch_size 3 .* not divisible by the data axis of 2"),
}
# (world size, global batch) of the cases that run in a world of several
# processes; the others run in one
WORLDS = {"mesh_data_2_sp_2": (2, 4), "mesh_data_not_the_world": (2, 4),
          "batch_not_divisible": (2, 3), "mesh_data_2": (2, 4)}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_config_switch_raises(case, monkeypatch):
    from vitxtgqa_tpu_torch.training.trainer import options_from_config

    device, tpu, cuda, err, words = REFUSALS[case]
    (_cuda if cuda else _no_cuda)(monkeypatch)
    world, batch = WORLDS.get(case, (1, None))
    _world(monkeypatch, world)
    with pytest.raises(err, match=words):
        options_from_config(_tp(device, batch, **tpu))


# (device, tpu switches, whether CUDA is there, the Options fields expected)
MAPPINGS = {
    "cpu_default": ("cpu", {}, False, dict(dtype=torch.float32, remat="none")),
    "cpu_bf16": ("cpu", {"compute_dtype": "bfloat16"}, False, dict(dtype=torch.bfloat16)),
    "card_default_bf16": ("auto", {}, True, dict(dtype=torch.bfloat16)),
    "card_explicit_cuda": ("cuda", {"compute_dtype": "bfloat16"}, True, dict(dtype=torch.bfloat16)),
    "cpu_use_pallas_false": ("cpu", {"use_pallas": False}, False, dict(plain=False)),
    "always_on_true": ("cpu", {k: True for k in ("kernel_dropout", "fused_block_bwd",
                                                  "fused_block_fwd", "variant_scan")}, False, {}),
    "variant_scan_false": ("cpu", {"variant_scan": False}, False, {}),
    # JAX's XLA block (base.yml's default, kept by the zoo's configs): the
    # port runs its one training block
    "kernel_dropout_false": ("cpu", {"kernel_dropout": False}, False, {}),
    "fused_block_bwd_false": ("cpu", {"fused_block_bwd": False}, False, {}),
    "fused_block_fwd_false": ("cpu", {"fused_block_fwd": False}, False, {}),
    "unported_false": ("cpu", {k: False for k in ("fused_grads", "compact_train", "dense_mm",
                                                   "split_dense")}, False, {}),
    "remat_attn": ("cpu", {"remat": "attn"}, False, dict(remat="attn")),
    "remat_false": ("cpu", {"remat": False}, False, dict(remat="none")),
    "serving": ("cpu", {"kv_cache_int8": True, "fused_decode": False,
                        "fused_decode_max_batch": 4, "w8a8": True, "compact_serving": True},
                False, dict(kv_cache_int8=True, fused_decode=False, fused_decode_max_batch=4,
                            w8a8=True, compact_serving=True)),
    "mesh_one_device": ("cpu", {"mesh": {"data": -1, "model": 1, "sp": 1, "pp": 1}}, False, {}),
    # the data axis over a world of two processes, a global batch of 4
    "mesh_data_2": ("cpu", {"mesh": {"data": 2}}, False, {}),
}


@pytest.mark.parametrize("case", sorted(MAPPINGS))
def test_config_switch_maps_onto_options(case, monkeypatch):
    from vitxtgqa_tpu_torch.training.trainer import options_from_config

    device, tpu, cuda, fields = MAPPINGS[case]
    (_cuda if cuda else _no_cuda)(monkeypatch)
    world, batch = WORLDS.get(case, (1, None))
    _world(monkeypatch, world)
    opts = options_from_config(_tp(device, batch, **tpu))
    assert opts.device.type == ("cuda" if cuda else "cpu")
    for k, v in fields.items():
        assert getattr(opts, k) == v, k


@pytest.mark.parametrize("name", CONFIGS)
def test_the_t2s_configs_map_onto_options(repo_root, name, monkeypatch):
    """The two shipped configs on the card: t2s_abinet.yml trains with remat
    "attn" and the bf16 cache; t2s_serving.yml serves with the int8 cache
    and compact serving; both in bf16, the fused decode at batch <= 2."""
    from vitxtgqa_tpu_torch.core.config import build_config
    from vitxtgqa_tpu_torch.training.trainer import options_from_config

    _cuda(monkeypatch)
    opts = options_from_config(build_config(_cfg(repo_root, name)).training_parameters)
    serving = name == "t2s_serving.yml"
    assert (opts.dtype, opts.remat, opts.kv_cache_int8, opts.compact_serving, opts.w8a8,
            opts.fused_decode, opts.fused_decode_max_batch, opts.plain) == (
        torch.bfloat16, "attn", serving, serving, False, True, 2, False)


@pytest.mark.parametrize("how", ["env", "config"])
def test_run_refuses_multi_process_runs(repo_root, fixroot, tmp_path, monkeypatch, how):
    """The multi-process switch (VITXTGQA_DISTRIBUTED=1 or
    training_parameters.distributed_init) without a torchrun environment
    raises, naming the launch; it trains nothing in one process."""
    from vitxtgqa_tpu_torch.parallel.mesh import WORLD_ENV

    for key in WORLD_ENV:
        monkeypatch.delenv(key, raising=False)
    argv = _cli(repo_root) + tiny_opts(fixroot, tmp_path / "s")
    if how == "env":
        monkeypatch.setenv("VITXTGQA_DISTRIBUTED", "1")
    else:
        argv += ["training_parameters.distributed_init=True"]
    with pytest.raises(RuntimeError, match="torchrun environment .*torch.distributed.run"):
        port_run(argv)
    assert not os.path.exists(os.path.join(str(tmp_path), "s"))


def test_run_without_a_device_option_needs_the_card(repo_root, fixroot, tmp_path, monkeypatch):
    """The acceptance command without training_parameters.device=cpu: on a
    machine without CUDA it raises and trains nothing on the CPU."""
    _no_cuda(monkeypatch)
    argv = [a for a in _cli(repo_root) + tiny_opts(fixroot, tmp_path / "s")
            if not a.startswith(("training_parameters.device=",
                                 "training_parameters.tpu.compute_dtype="))]
    with pytest.raises(RuntimeError, match="has none"):
        port_run(argv)
    assert not os.path.exists(os.path.join(str(tmp_path), "s", "ckpt"))


def test_entry_returns_the_serving_forward_at_production_dims():
    """entry() on the CPU (the card is its default): a callable and one
    argument, the batch-2 production tensors; the model behind it has the
    production widths.  The forward itself runs on the card
    (chip_smoke.py), not here."""
    from vitxtgqa_tpu_torch.entry import entry
    from vitxtgqa_tpu_torch.models.t2s import T2S, PRODUCTION_NUM_FINAL_OUTPUTS

    fn, args = entry(device="cpu")
    (batch,) = args
    assert callable(fn)
    assert batch["video_feat"].shape == (2, 64, 1024) and batch["ocr_mask"].shape == (2, 960)
    assert batch["targets"].shape == (2, 12, PRODUCTION_NUM_FINAL_OUTPUTS)
    (model,) = [c.cell_contents for c in fn.__closure__ if isinstance(c.cell_contents, T2S)]
    assert model.inference_only and not model.decode_recompute
    assert model.classifier.module.weight.shape == (5050, 768)
    assert len(model.mmt.encoder.layer) == 3 and len(model.TransLayer.encoder.layer) == 2
    assert model.opts.device.type == "cpu"


def test_chip_smoke_step_check_rejects_the_planted_faults(repo_root, fixroot, tmp_path,
                                                         monkeypatch):
    """chip_smoke.runtime_step_check (slice l (ii)) dry-run on the fixture
    batch at hidden 128 with three layers a stack (the planted faults name
    MMT layer 2 and text-BERT layer 0; dropout at the config's 0.1): every
    form of the step runs the plain versions here, so each agrees with the
    plain step exactly, and each planted fault moves a gradient of its
    layer past GRAD_REL_TOL, so the check rejects it."""
    import chip_smoke as CS
    from vitxtgqa_tpu_torch.data.loader import infinite_batches
    from vitxtgqa_tpu_torch.ops import block_train as BT

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(CS, "expected_train_launches",
                        lambda cfg, opts: {n: 0 for n in CS.REPLACES})
    wide = [f"model_attributes.t2s.{sect}.{k}={v}" for sect in ("text_bert", "translayers", "mmt")
            for k, v in (("hidden_size", 128), ("intermediate_size", 256),
                         ("num_hidden_layers", 3))]
    wide += ["model_attributes.t2s.grounding.hidden_size=128",
             "model_attributes.t2s.classifier.ocr_ptr_net.hidden_size=128",
             "model_attributes.t2s.classifier.ocr_ptr_net.query_key_size=128"]
    k = _port_trainer(repo_root, _cli(repo_root) + tiny_opts(fixroot, tmp_path / "c") + wide)
    tensors, _ = k._split_device_batch(next(infinite_batches(k.loaders["train"])))
    fwd, bwd = BT.block_train_fwd_plain, BT.block_train_bwd_plain
    summary = CS.runtime_step_check(k, tensors, torch.device("cpu"))
    assert BT.block_train_fwd_plain is fwd and BT.block_train_bwd_plain is bwd
    assert summary["against_plain"][:3] == (0.0, 0.0, 0.0)
    assert all(v[:3] == (0.0, 0.0, 0.0) for v in summary["against_float32"].values())
    for fault, param in (("db2_dropped", "mmt.encoder.layer.2.output.dense.bias"),
                         ("keep_scale_1", "text_bert.encoder.layer.0.")):
        loss_rel, norm_rel, grad_rel, worst = summary["faults"][fault]
        assert grad_rel > 2 * CS.GRAD_REL_TOL and worst.startswith(param), (fault, worst)


def test_chip_smoke_counts_the_trainers_forwards(repo_root, fixroot, tmp_path, monkeypatch):
    """chip_smoke.runtime_eval_forwards (slice l's launch derivation) against
    the eval forwards and steps the trainer makes: three steps with a probe
    each and two validations, then a resumed fourth step."""
    import chip_smoke as CS
    from vitxtgqa_tpu_torch.training import trainer as T

    calls = {"steps": 0, "forwards": 0}
    step, forward = T.train_step, T.BaseTrainer._eval_out

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(T, "train_step", counted("steps", step))
    monkeypatch.setattr(T.BaseTrainer, "_eval_out", counted("forwards", forward))
    save = tmp_path / "s"
    trainer = port_run(_cli(repo_root) + tiny_opts(fixroot, save, **TRAIN3))
    vb = len(trainer.loaders["val"])
    assert vb == 3 and calls == {"steps": 3, "forwards": CS.runtime_eval_forwards(3, 1, 3, vb)}
    calls.update(steps=0, forwards=0)
    port_run(_cli(repo_root) + tiny_opts(fixroot, tmp_path / "r", **{**TRAIN3, "max_iterations": 4})
             + [f"training_parameters.resume_file={save}/ckpt/best"])
    assert calls == {"steps": 1, "forwards": CS.runtime_eval_forwards(4, 1, 3, vb, first=4)}
