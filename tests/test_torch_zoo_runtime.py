"""The port's runtime with the T2S-family zoo against the JAX package's:
the GT-box dataset, an M4C training run, GT-box validation through
``run()``, and the CLI training and validating each trainable zoo model.

CPU, on a fixture tree written by tools/make_fixtures.py into a temporary
directory per module, with a link ``fps10_ocr_detection_ClipOCR`` to its
``fps10_ocr_detection`` (the GT-box config reads the ClipOCR tokens'
directory, the fixtures write one OCR directory).  The models at tiny
width (hidden 64, one layer a stack) and data geometry (8 frames x 3 OCR
slots), float32.  Tolerances as tests/test_torch_runtime.py: batches and
metrics exactly equal, losses within 1e-5 relative, parameters after
three steps as gradients are held (1e-4 of each tensor's largest change
plus 1e-3 relative).
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_runtime import (FRAMES, NO_DROPOUT, OCR, OCR_PER_FRAME, SIX, TINY, TRAIN3,
                                      _assert_batches_equal, _cfg, _port_trainer, _reseed_data,
                                      _series)
from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.core.registry import registry as port_registry
from vitxtgqa_tpu_torch.run import run as port_run, setup_imports
from vitxtgqa_tpu_torch.utils.convert import from_jax_family_params

# --model: (config, its model_attributes block, dataset)
ZOO_RUNS = {
    "m4c": ("m4c_abinet.yml", "m4c", "vtextgqa"),
    "t5vitevqa": ("t5vitevqa_abinet.yml", "t5vitevqa", "vtextgqa"),
    "t2s_wo_tg": ("t2s_abinet.yml", "t2s", "vtextgqa"),
    "t2s_wo_sg": ("t2s_abinet.yml", "t2s", "vtextgqa"),
    "gt_box": ("gt_box_clipocr.yml", "gt_box", "gt_box"),
}


@pytest.fixture(scope="module")
def fixroot(tmp_path_factory):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(os.path.dirname(__file__), "..", "tools", "make_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    root = str(tmp_path_factory.mktemp("fixtures"))
    tool.main(root)
    os.symlink("fps10_ocr_detection", os.path.join(root, "fps10_ocr_detection_ClipOCR"))
    return root


def zoo_cli(repo_root, model, run_type="train"):
    config, _, dataset = ZOO_RUNS[model]
    return ["--config", _cfg(repo_root, config), "--model", model, "--datasets", dataset,
            "--run_type", run_type]


def zoo_opts(model, fixroot, save_dir, dropout=True, **tp):
    """CLI opts as tests/test_torch_runtime.tiny_opts for ``model``'s
    config block and dataset: the fixtures, the CPU in float32, batch 2,
    tiny widths and data geometry, top-2 grounding, ``dropout=False``
    every dropout 0."""
    _, block, dataset = ZOO_RUNS[model]
    m, ds = f"model_attributes.{block}", f"dataset_attributes.{dataset}"
    opts = [f"{ds}.data_root_dir={fixroot}", "training_parameters.device=cpu",
            "training_parameters.tpu.compute_dtype=float32", "training_parameters.batch_size=2",
            "training_parameters.num_workers=0", f"training_parameters.save_dir={save_dir}",
            "training_parameters.seed=13", f"{ds}.frames={FRAMES}",
            f"{ds}.ocr_frame_num={OCR_PER_FRAME}"]
    for sect in ("text_bert", "translayers", "mmt"):
        sect_opts = {**TINY, **({} if dropout else NO_DROPOUT)}
        opts += [f"{m}.{sect}.{k}={v}" for k, v in sect_opts.items()]
    opts += [f"{ds}.processors.{p}.params.max_length={OCR}"
             for p in ("answer_processor", "copy_processor", "phoc_processor", "context_processor")]
    g = f"{m}.grounding"
    opts += [f"{g}.hidden_size=64", f"{g}.frame_num={FRAMES}", f"{g}.ocr_frame_num={OCR_PER_FRAME}",
             f"{g}.max_ocr_num={OCR}", f"{g}.frame_topk=2", f"{g}.ocr_topk=2",
             f"{m}.classifier.ocr_max_num={OCR}", f"{m}.classifier.ocr_ptr_net.hidden_size=64",
             f"{m}.classifier.ocr_ptr_net.query_key_size=64"]
    if not dropout:
        opts += [f"{m}.obj.dropout_prob=0.0", f"{m}.ocr.dropout_prob=0.0"]
    opts += [f"training_parameters.{k}={v}" for k, v in tp.items()]
    return opts


def _jax_trainer(argv, model_cls, monkeypatch):
    """A loaded JAX trainer, its model's init under one jit (an XLA compile
    per op otherwise)."""
    import flax
    import vitxtgqa_tpu
    from vitxtgqa_tpu.core.config import build_config as jax_build
    from vitxtgqa_tpu.core.flags import get_parser as jax_parser
    from vitxtgqa_tpu.core.registry import registry as jax_registry

    vitxtgqa_tpu.setup_imports()

    def jit_init(self, rngs, batch, train=False):
        return jax.jit(lambda r, b: flax.linen.Module.init(self, r, b, train=train))(rngs, batch)

    monkeypatch.setattr(model_cls, "init", jit_init)
    jargs = jax_parser().parse_args(argv)
    trainer = jax_registry.get_trainer_class("base_trainer")(
        jax_build(jargs.config, opts=jargs.opts, args=jargs))
    trainer.load()
    return trainer


def _jax_weights(jtrainer, model):
    """The JAX trainer's parameters as the port model's state dict (copies:
    the JAX trainer donates its buffers to its steps)."""
    from vitxtgqa_tpu.utils.torch_convert import flatten

    return {k: v.numpy() for k, v in from_jax_family_params(
        flatten(jax.tree_util.tree_map(np.array, jtrainer.params)), model).items()}


@pytest.mark.parametrize("model", ["m4c", "t5vitevqa", "gt_box"])
def test_zoo_configs_equal_the_jax_packages(repo_root, model):
    """build_config of the zoo's configs (their includes among the port's
    copied defaults) equals the JAX package's."""
    from vitxtgqa_tpu.core.config import build_config as jax_build
    from vitxtgqa_tpu_torch.core.config import build_config

    path = _cfg(repo_root, ZOO_RUNS[model][0])
    assert build_config(path).to_dict() == jax_build(path).to_dict()


def test_gt_box_datasets_equal_the_jax_packages(repo_root, fixroot):
    """The gt_box builder's val batches (the annotation grid, its masks and
    ids, the eval-aligned boxes, context features over the annotated
    tokens) equal the JAX builder's; the train split, which has no
    ground_infos, raises ValueError in both."""
    import vitxtgqa_tpu
    from vitxtgqa_tpu.core.config import build_config as jax_build
    from vitxtgqa_tpu.core.registry import registry as jax_registry
    from vitxtgqa_tpu.data.dataset import collate as jax_collate
    from vitxtgqa_tpu_torch.core.config import build_config
    from vitxtgqa_tpu_torch.data.dataset import collate

    vitxtgqa_tpu.setup_imports()
    setup_imports()
    opts = [f"dataset_attributes.gt_box.data_root_dir={fixroot}"]
    cfg = build_config(_cfg(repo_root, "gt_box_clipocr.yml"), opts=opts).dataset_attributes.gt_box
    jcfg = jax_build(_cfg(repo_root, "gt_box_clipocr.yml"), opts=opts).dataset_attributes.gt_box
    for name in ("gt_box", "gt_box_clipocr"):
        port = port_registry.get_builder_class(name)().load("val", cfg, seed=13)
        want = jax_registry.get_builder_class(name)().load("val", jcfg, seed=13)
        for ds in (port, want):
            ds.answer_processor.processor.rng = np.random.default_rng(7)
        got = collate([port[i] for i in range(len(port))])
        ref = jax_collate([want[i] for i in range(len(want))])
        assert {"frame_list", "ocr_bbox_list", "eval_box_list", "frame_mask_embedding",
                "ocr_mask_embedding", "ocr_track_id", "ocr_temporal_id"} <= set(got["tensors"])
        assert got["tensors"]["ocr_mask_embedding"].sum() > 0
        _assert_batches_equal(got, ref)
        with pytest.raises(ValueError, match="ground_infos"):
            port_registry.get_builder_class(name)().load("train", cfg, seed=13)
        with pytest.raises(ValueError, match="ground_infos"):
            jax_registry.get_builder_class(name)().load("train", jcfg, seed=13)


def test_m4c_trainer_trajectory_matches_the_jax_trainer(repo_root, fixroot, tmp_path,
                                                        monkeypatch):
    """The JAX BaseTrainer and the port's on configs/m4c_abinet.yml (three
    steps, the snapshot's validation and the final one) from the same
    initial weights: each step's loss, the parameters after three steps,
    the validation losses and the six metrics."""
    from tests.test_torch_train import _assert_grads_close
    from vitxtgqa_tpu.models.m4c import M4C as JM4C

    argv = zoo_cli(repo_root, "m4c") + zoo_opts("m4c", fixroot, tmp_path / "jax", dropout=False,
                                                 **TRAIN3)
    jtrainer = _jax_trainer(argv, JM4C, monkeypatch)
    init = _jax_weights(jtrainer, "m4c")
    argv = zoo_cli(repo_root, "m4c") + zoo_opts("m4c", fixroot, tmp_path / "port", dropout=False,
                                                 **TRAIN3)
    trainer = _port_trainer(repo_root, argv)
    assert type(trainer.model).__name__ == "M4C"
    trainer.model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    for t in (jtrainer, trainer):
        _reseed_data(t)
    jtrainer.train()
    trainer.train()

    for key in ("train/total_loss", "train/vtextgqa/pos_bce_loss"):
        got, want = _series(trainer.meter, key), _series(jtrainer.meter, key)
        assert len(got) == len(want) == 3, key
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)
    want = _jax_weights(jtrainer, "m4c")
    got = {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}
    # the key biases: a gradient of float32 noise (softmax is shift-invariant)
    noise = [k for k in want if k.endswith("attention.self.key.bias")]
    assert noise and all(max(abs(got[k]).max(), abs(want[k]).max()) < 1e-6 for k in noise)
    _assert_grads_close({k: got[k] for k in want if k not in noise},
                        {k: want[k] for k in want if k not in noise}, 1e-4, 1e-3)
    vals = sorted(k for k in jtrainer.meter.meters if k.startswith("val/"))
    assert vals == sorted(k for k in trainer.meter.meters if k.startswith("val/"))
    assert {f"val/vtextgqa/{t}" for t in SIX} <= set(vals)
    for key in vals:
        got, want = _series(trainer.meter, key), _series(jtrainer.meter, key)
        if "loss" in key:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)
        else:
            assert got == want, key


def test_gt_box_validation_through_run_matches_the_jax_trainer(repo_root, fixroot, tmp_path,
                                                               monkeypatch):
    """``run()`` with --run_type val on configs/gt_box_clipocr.yml (the
    train split skipped: no ground_infos) from the JAX trainer's initial
    weights, loaded as a model blob: the val losses equal the JAX
    trainer's within 1e-5 relative and the six metrics exactly."""
    from vitxtgqa_tpu.models.gt_box import GTBox as JGTBox
    from vitxtgqa_tpu_torch.training.trainer import BaseTrainer

    argv = zoo_cli(repo_root, "gt_box", "val") + zoo_opts("gt_box", fixroot, tmp_path / "jax",
                                                            dropout=False)
    jtrainer = _jax_trainer(argv, JGTBox, monkeypatch)
    blob = str(tmp_path / "init.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          _jax_weights(jtrainer, "gt_box").items()}}, blob)
    _reseed_data(jtrainer)
    want = jtrainer.evaluate("val")

    seen = []
    real = BaseTrainer.evaluate

    def evaluate(self, split):
        if split == "val":
            _reseed_data(self)
        seen.append(real(self, split))
        return seen[-1]

    monkeypatch.setattr(BaseTrainer, "evaluate", evaluate)
    trainer = port_run(zoo_cli(repo_root, "gt_box", "val")
                       + zoo_opts("gt_box", fixroot, tmp_path / "port", dropout=False)
                       + [f"training_parameters.resume_file={blob}"])
    assert type(trainer.model).__name__ == "GTBox" and sorted(trainer.datasets) == ["val"]
    (got,) = seen
    assert sorted(got[0]) == sorted(want[0]) and sorted(got[1]) == sorted(want[1])
    assert {f"gt_box/{t}" for t in SIX} <= set(got[1])
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5, err_msg=k)
    assert got[1] == want[1]


@pytest.mark.parametrize("model", ["m4c", "t5vitevqa", "t2s_wo_tg", "t2s_wo_sg"])
def test_cli_trains_and_validates_each_zoo_model(repo_root, fixroot, tmp_path, model):
    """``python -m vitxtgqa_tpu_torch.run --model <key>`` on the CPU: three
    steps, ckpt/best and ckpt/final, the six val/ metrics in [0, 1].  The
    ablations run on configs/t2s_abinet.yml, whose one model_attributes
    block (t2s) serves them (the JAX trainer's rule)."""
    save = tmp_path / "save"
    trainer = port_run(zoo_cli(repo_root, model) + zoo_opts(model, fixroot, save, **TRAIN3))
    assert trainer.config.model == model
    assert type(trainer.model) is port_registry.get_model_class(model)
    assert trainer.model_cfg is trainer.config.model_attributes[ZOO_RUNS[model][1]]
    assert trainer.iteration == 3
    for d in ("best", "final"):
        assert os.path.exists(os.path.join(str(save), "ckpt", d, "state.pt")), d
    scalars = trainer.meter.get_scalar_dict()
    for t in SIX:
        assert 0.0 <= scalars[f"val/vtextgqa/{t}"] <= 1.0, t
    assert all(np.isfinite(v) for v in _series(trainer.meter, "train/total_loss"))
