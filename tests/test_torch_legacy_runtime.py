"""The port's runtime with the legacy image-VQA models against the JAX
package's: ``python -m vitxtgqa_tpu_torch.run`` with configs/pythia_vqa2.yml
(pythia on vqa2) and configs/lorra_textvqa.yml (LoRRA on textvqa), a resume,
and a two-dataset run (vqa2 + vizwiz) on the JAX schedule.

CPU, float32, on a synthetic tree the port's own writer lays out
(utils/legacy_fixtures.write_tree: 16-d features, <= 7 detectron boxes
and 5 grid cells an image, 12 / 6 / 4 train / val / test questions, 12
answers, TextVQA's <= 6 OCR tokens), the models at vocab 34, embed 8,
hidden 16, batch 4.  Both trainers start from the same weights (the JAX
trainer's init, converted) and read the same batches; the two-dataset run
is held to the JAX schedule (vitxtgqa_tpu/data/multi_dataset.py) on the
port's loaders.  Held: each step's
loss within 1e-5 relative, the validation losses within 1e-5 relative and
vqa_accuracy within 1e-6 (a mean of float32 targets at the same argmax),
the EvalAI records equal; a resumed run equal to an uninterrupted one bit
for bit.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_runtime import _port_trainer, _series
from tests.test_torch_zoo_runtime import _jax_weights
from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.run import run as port_run
from vitxtgqa_tpu_torch.utils.legacy_fixtures import write_tree

QV, MAX_LOC, OCR, BATCH = 30, 7, 6, 4
TRAIN3 = {"max_iterations": 3, "log_interval": 1, "snapshot_interval": 2}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("legacy"))
    write_tree(path, questions={"train": 12, "val": 6, "test": 4}, per_image=2, feat_dim=16,
               boxes={"vqa2": MAX_LOC, "vizwiz": MAX_LOC, "textvqa": MAX_LOC}, grid=5,
               question_vocab=QV, answers={"vqa2": 12, "vizwiz": 12, "textvqa": 12},
               ocr_tokens=OCR, text_len=8)
    return path


def _draw(path, shape, rng):
    """A seeded value for a JAX parameter of ``shape``: a weight-norm scale
    1, a bias 0, an embedding N(0, 1), a matrix N(0, 1 / fan_in), as flax
    initialises them."""
    name = str(path[-1])
    if not shape:
        return np.ones(shape, np.float32)
    if len(shape) == 1:
        return np.zeros(shape, np.float32)
    std = 1.0 if "embedding" in name or "h_" in name else 1.0 / np.sqrt(np.prod(shape[:-1]))
    return (std * rng.standard_normal(shape)).astype(np.float32)


def _jax_trainer(argv, model_cls, monkeypatch):
    """A loaded JAX trainer whose model init is only shaped
    (``jax.eval_shape``) and drawn from a seeded generator (_draw): no XLA
    compile; both trainers then start from these weights."""
    import flax
    import vitxtgqa_tpu
    from vitxtgqa_tpu.core.config import build_config as jax_build
    from vitxtgqa_tpu.core.flags import get_parser as jax_parser
    from vitxtgqa_tpu.core.registry import registry as jax_registry

    vitxtgqa_tpu.setup_imports()

    def shaped_init(self, rngs, batch, train=False):
        shapes = jax.eval_shape(lambda: flax.linen.Module.init(self, rngs, batch, train=train))
        rng = np.random.default_rng(0)
        return jax.tree_util.tree_map_with_path(lambda p, s: _draw(p, s.shape, rng), shapes)

    monkeypatch.setattr(model_cls, "init", shaped_init)
    jargs = jax_parser().parse_args(argv)
    trainer = jax_registry.get_trainer_class("base_trainer")(
        jax_build(jargs.config, opts=jargs.opts, args=jargs))
    trainer.load()
    return trainer


def cli(repo_root, config, model, datasets, run_type):
    return ["--config", config if os.path.isabs(config) else
            os.path.join(repo_root, "configs", config), "--model", model,
            "--datasets", datasets, "--run_type", run_type]


def opts(root, model, save, datasets=("vqa2",), **tp):
    """The tree, the CPU in float32, batch 4, tiny widths; no log files
    (the meters hold what is compared)."""
    out = ["training_parameters.device=cpu", "training_parameters.tpu.compute_dtype=float32",
           "training_parameters.should_not_log=true",
           f"training_parameters.batch_size={BATCH}", "training_parameters.num_workers=0",
           f"training_parameters.save_dir={save}", "training_parameters.seed=13",
           f"model_attributes.{model}.vocab_size={QV + 4}", f"model_attributes.{model}.embed_dim=8",
           f"model_attributes.{model}.hidden_dim=16"]
    for ds in datasets:
        d = f"dataset_attributes.{ds}"
        out += [f"{d}.data_root_dir={root}", f"{d}.features_max_len={MAX_LOC}"]
        if ds == "textvqa":
            out += [f"{d}.processors.answer_processor.params.max_length={OCR}",
                    f"{d}.processors.context_processor.params.max_length={OCR}"]
    return out + [f"training_parameters.{k}={v}" for k, v in tp.items()]


def _reports(save):
    d = os.path.join(str(save), "reports")
    return {name.rsplit("_", 1)[0]: json.load(open(os.path.join(d, name)))
            for name in sorted(os.listdir(d))}


def _assert_series_close(port, jax_, keys):
    for key in keys:
        got, want = _series(port.meter, key), _series(jax_.meter, key)
        assert len(got) == len(want) > 0, key
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)


def test_pythia_on_vqa2_matches_the_jax_trainer(repo_root, root, tmp_path, monkeypatch):
    """configs/pythia_vqa2.yml, train+inference with EvalAI predictions:
    three Adamax steps under the warmup, the snapshot's and the final
    validation, then the val and test predictions, against the JAX
    trainer from the same weights."""
    from vitxtgqa_tpu.models.legacy_vqa import PythiaModel

    args = cli(repo_root, "pythia_vqa2.yml", "pythia", "vqa2", "train+inference")
    jtrainer = _jax_trainer(args + opts(root, "pythia", tmp_path / "jax", evalai_inference=True,
                                        **TRAIN3), PythiaModel, monkeypatch)
    init = _jax_weights(jtrainer, "pythia")
    trainer = _port_trainer(repo_root, args + opts(root, "pythia", tmp_path / "port",
                                                   evalai_inference=True, **TRAIN3))
    assert type(trainer.model).__name__ == "PythiaModel"
    assert type(trainer.optimizer.inner).__name__ == "Adamax"
    trainer.model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    jtrainer.train()
    trainer.train()
    trainer.close()
    _assert_series_close(trainer, jtrainer, ("train/total_loss", "train/vqa2/logit_bce",
                                             "val/vqa2/logit_bce"))
    for key in ("train/vqa2/vqa_accuracy", "val/vqa2/vqa_accuracy"):
        np.testing.assert_allclose(_series(trainer.meter, key), _series(jtrainer.meter, key),
                                   atol=1e-6, err_msg=key)
    got, want = _reports(tmp_path / "port"), _reports(tmp_path / "jax")
    assert sorted(got) == sorted(want) == ["vqa2_test", "vqa2_val"]
    assert got == want and len(got["vqa2_val"]) == 6
    assert set(got["vqa2_val"][0]) == {"question_id", "answer", "actual_answers",
                                       "question_tokens", "image_id"}


def test_lorra_on_textvqa_matches_the_jax_trainer(repo_root, root, tmp_path, monkeypatch):
    """configs/lorra_textvqa.yml, ``run()`` with --run_type val from the
    JAX trainer's weights loaded as a model blob: the val losses and
    vqa_accuracy, then the EvalAI records (OCR-copy answers word-tokenized)
    against the JAX trainer's; the soft-copy head is the answers plus the
    OCR slots."""
    from vitxtgqa_tpu.models.legacy_vqa import LoRRA as JLoRRA
    from vitxtgqa_tpu_torch.core.registry import registry
    from vitxtgqa_tpu_torch.training.trainer import BaseTrainer

    args = cli(repo_root, "lorra_textvqa.yml", "lorra", "textvqa", "val")
    jtrainer = _jax_trainer(args + opts(root, "lorra", tmp_path / "jax", ("textvqa",)), JLoRRA,
                            monkeypatch)
    blob = str(tmp_path / "init.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          _jax_weights(jtrainer, "lorra").items()}}, blob)
    want = jtrainer.evaluate("val")
    seen = []
    real = BaseTrainer.evaluate

    def evaluate(self, split):
        seen.append(real(self, split))
        return seen[-1]

    monkeypatch.setattr(BaseTrainer, "evaluate", evaluate)
    trainer = port_run(args + opts(root, "lorra", tmp_path / "port", ("textvqa",))
                       + [f"training_parameters.resume_file={blob}"])
    assert registry.get("textvqa_num_final_outputs") == trainer.answer_processor.get_true_vocab_size() + OCR
    (got,) = seen
    assert sorted(got[0]) == sorted(want[0]) and sorted(got[1]) == sorted(want[1])
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got[1]["textvqa/vqa_accuracy"], want[1]["textvqa/vqa_accuracy"],
                               atol=1e-6)
    got_rows = json.load(open(trainer.predict_for_evalai("val")))
    want_rows = json.load(open(jtrainer.predict_for_evalai("val")))
    assert got_rows == want_rows and len(got_rows) == 6
    trainer.close()


def test_a_resume_equals_an_uninterrupted_run(repo_root, root, tmp_path):
    """Pythia on vqa2: four Adamax steps straight against three, a snapshot
    and a resume from it for the fourth: the restored iteration, epoch
    position and Adamax state, then the fourth step's loss and the final
    parameters bit for bit."""
    from vitxtgqa_tpu_torch.training.checkpoint import Checkpoint

    args = cli(repo_root, "pythia_vqa2.yml", "pythia", "vqa2", "train")

    def trainer(save, resume=None, **tp):
        argv = args + opts(root, "pythia", tmp_path / save, **{**TRAIN3, "snapshot_interval": 3,
                                                               **tp})
        if resume:
            argv += [f"training_parameters.resume_file={resume}"]
        return _port_trainer(repo_root, argv)

    straight = trainer("straight", max_iterations=4)
    straight.train()
    first = trainer("first")
    first.train()
    best = os.path.join(str(tmp_path), "first", "ckpt", "best")
    saved = Checkpoint(str(tmp_path / "first")).load(best)
    resumed = trainer("resumed", resume=best, max_iterations=4)
    assert (resumed.iteration, resumed.current_epoch, resumed.epoch_batch) == (3, 0, 3)
    opt = resumed.optimizer.state_dict()
    assert opt["count"] == 3
    for i, s in saved["optimizer"]["adam"]["state"].items():
        for k in ("exp_avg", "exp_inf", "step"):
            assert torch.equal(opt["adam"]["state"][i][k], s[k]), (i, k)
    resumed.train()
    got, want = _series(resumed.meter, "train/total_loss"), _series(straight.meter,
                                                                    "train/total_loss")
    assert len(got) == 1 and len(want) == 4 and got[0] == want[3]
    finals = [Checkpoint(str(tmp_path / d)).load(os.path.join(str(tmp_path), d, "ckpt",
                                                              "final"))["model"]
              for d in ("resumed", "straight")]
    assert all(torch.equal(finals[0][k], finals[1][k]) for k in finals[1])


def test_two_datasets_train_on_the_jax_schedule(repo_root, root, tmp_path):
    """--datasets vqa2,vizwiz (VizWiz on VQA2's answer space) through
    ``run()``: six steps, each iteration's batch from the dataset that the
    JAX MultiDataset (built on the port's loaders) draws for that step;
    validation on the primary (vqa2); the schedule resumed at step 4 gives
    the uninterrupted run's batches."""
    from vitxtgqa_tpu.data.multi_dataset import MultiDataset as JaxMultiDataset

    config = tmp_path / "two.yml"
    config.write_text("includes:\n- {}\n- common/defaults/configs/datasets/vqa/vizwiz.yml\n"
                      .format(os.path.join(repo_root, "configs", "pythia_vqa2.yml")))
    args = cli(repo_root, str(config), "pythia", "vqa2,vizwiz", "train")
    extra = ["dataset_attributes.vizwiz.processors.answer_processor.params.vocab_file="
             "vocabs/answers_vqa.txt"]
    trainer = port_run(args + opts(root, "pythia", tmp_path / "port", ("vqa2", "vizwiz"),
                                   max_iterations=6, log_interval=1, snapshot_interval=6) + extra)
    multi = trainer.multi_train
    assert multi.names == ["vizwiz", "vqa2"] and sorted(trainer.datasets) == ["train", "val"]
    jax_multi = JaxMultiDataset(multi.loaders, proportional=True, seed=13)
    np.testing.assert_array_equal(multi.probs, jax_multi.probs)
    want = [jax_multi.dataset_for_step(s) for s in range(6)]
    assert trainer.datasets_drawn == want and set(want) == {"vqa2", "vizwiz"}
    assert [multi.dataset_for_step(s) for s in range(200)] == [
        jax_multi.dataset_for_step(s) for s in range(200)]
    assert len(_series(trainer.meter, "val/vqa2/vqa_accuracy")) >= 1
    straight = [b["tensors"]["question_id"].tolist() for b, _ in zip(multi.iter_from(0),
                                                                       range(9))]
    resumed = [b["tensors"]["question_id"].tolist() for b, _ in zip(multi.iter_from(4),
                                                                      range(5))]
    assert resumed == straight[4:]


@pytest.mark.parametrize("model", ["pythia", "ban", "t2s"])
def test_the_dtype_rule_on_the_card(model, monkeypatch):
    """compute_dtype=float32 on the card: a legacy model (KERNEL_FREE: no
    kernel on its forward) takes it, with the plain versions, as JAX takes
    it everywhere; a model whose forward reaches the bf16 kernels still
    raises.  bfloat16 (base.yml's) is the kernels' route for both."""
    from tests.test_torch_runtime import _tp
    from vitxtgqa_tpu_torch.run import setup_imports
    from vitxtgqa_tpu_torch.training.trainer import kernel_free, options_from_config

    setup_imports()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    free = kernel_free(model)
    assert free == (model != "t2s") and not kernel_free("no_such_model")
    bf16 = options_from_config(_tp("auto", compute_dtype="bfloat16"), free)
    assert bf16.dtype == torch.bfloat16 and not bf16.plain
    if free:
        f32 = options_from_config(_tp("auto", compute_dtype="float32"), free)
        assert f32.device.type == "cuda" and f32.dtype == torch.float32 and f32.plain
    else:
        with pytest.raises(ValueError, match="compute_dtype=bfloat16"):
            options_from_config(_tp("auto", compute_dtype="float32"), free)
