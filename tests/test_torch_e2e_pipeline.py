"""The raw-video pipeline (``python -m vitxtgqa_tpu_torch.e2e_pipeline``)
stage by stage against tools/e2e_pipeline.py on the same inputs, on the
CPU: stage 1 (OpenCV decode) frames byte for byte and the meta equal;
stage 2 (ViT features, a tiny ViT on both sides from one HF-named torch
weights file, as ``--vit_weights`` passes it) within 2e-5; stage 3 the
same data root (annotations, links, vocabulary); stage 4 the predictions
of ``run_inference`` equal to ``vitxtgqa_tpu_torch.run.run`` called
directly on the same data root, with the seeded weights and with a
reference-style ``.pth`` as ``--ckpt``, and equal to the JAX tool's
stage 4 from the same ``.pth`` (JAX's converter loading it there)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_runtime import TINY
from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch import e2e_pipeline as P
from vitxtgqa_tpu_torch.models.vit import ViT, ViTConfig
from vitxtgqa_tpu_torch.options import Options
from vitxtgqa_tpu_torch.run import run as port_run
from vitxtgqa_tpu_torch.utils.synthetic import synthetic_frames

VIT = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=1, num_heads=4, mlp_dim=128)
VIDEOS, FRAMES, OCR_PER_FRAME = ("clip01", "clip02"), 8, 3


@pytest.fixture(scope="module")
def jax_tool(repo_root):
    sys.path.insert(0, repo_root)
    from tools import e2e_pipeline

    return e2e_pipeline


def write_frames(root, n=FRAMES, h=48, w=64):
    """Each video's ``n`` frames as 1-indexed jpgs written by Pillow."""
    from PIL import Image

    for vi, vid in enumerate(VIDEOS):
        os.makedirs(os.path.join(root, vid), exist_ok=True)
        for i, frame in enumerate(synthetic_frames(batch=n, h=h, w=w, seed=vi)):
            Image.fromarray(frame).save(os.path.join(root, vid, f"{i + 1}.jpg"))
    return str(root)


def write_ocr(root, n=FRAMES):
    """OCR detections in the reference's npy format: {frame: [{"points",
    "ocr", "ID"}]}, OCR_PER_FRAME a frame."""
    os.makedirs(root, exist_ok=True)
    words = ("stop", "exit", "open", "sale", "cafe")
    for vi, vid in enumerate(VIDEOS):
        info = {str(f): [{"points": [4 + 8 * j, 4, 20 + 8 * j, 4, 20 + 8 * j, 12, 4 + 8 * j, 12],
                          "ocr": words[(f + j + vi) % len(words)], "ID": j + 1}
                         for j in range(OCR_PER_FRAME)] for f in range(1, n + 1)}
        np.save(os.path.join(root, f"{vid}.npy"), np.array(info, dtype=object),
                allow_pickle=True)
    return str(root)


def write_questions(path):
    qs = [{"question_id": 10 * vi + j, "video_id": vid, "question": f"what does sign {j} say?",
           "answers": ["stop"]} for vi, vid in enumerate(VIDEOS) for j in range(3)]
    path.write_text(json.dumps(qs))
    return str(path)


def write_vit_weights(path):
    """An HF ViTForImageClassification-style checkpoint (``vit.`` prefix)
    of the tiny ViT's seeded weights."""
    state = ViT(ViTConfig(**VIT), Options(device="cpu")).init_weights(3).state_dict()
    torch.save({f"vit.{k}": v for k, v in state.items()}, path)
    return str(path)


def read_tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_stage1_decode_videos_matches_jax(jax_tool, tmp_path):
    """A 12-frame clip written by OpenCV at 10 fps, decoded at 10 and 5
    fps: the same jpgs byte for byte and the same (n, width, height)."""
    cv2 = pytest.importorskip("cv2")
    vdir = tmp_path / "videos"
    os.makedirs(vdir)
    w, h = 128, 96
    writer = cv2.VideoWriter(str(vdir / "clip01.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
    for frame in synthetic_frames(batch=12, h=h, w=w, seed=0):
        writer.write(frame)
    writer.release()
    for fps in (10, 5):
        want = jax_tool.decode_videos(str(vdir), str(tmp_path / f"jax{fps}"), fps)
        got = P.decode_videos(str(vdir), str(tmp_path / f"port{fps}"), fps)
        assert got == want and got["clip01"] == (12 // (10 // fps), w, h)
        assert read_tree(tmp_path / f"port{fps}") == read_tree(tmp_path / f"jax{fps}")


def test_stage2_features_match_jax(jax_tool, tmp_path, monkeypatch):
    """Stage 2 with the tiny ViT (the JAX module's VIT_L_16 patched to it,
    as tests/test_e2e_pipeline.py does; the port takes it as ``cfg``) and
    one HF-named weights file: each frame's feature within 2e-5, in chunks
    of 3 frames."""
    import vitxtgqa_tpu.models.vit as jax_vit

    frames = write_frames(tmp_path / "frames", n=5)
    weights = write_vit_weights(tmp_path / "vit.pt")
    monkeypatch.setattr(jax_vit, "VIT_L_16", jax_vit.ViTConfig(**VIT))
    jax_tool.extract_features(frames, str(tmp_path / "jax"), weights=weights, batch=3)
    n = P.extract_features(frames, str(tmp_path / "port"), weights=weights, batch=3,
                           cfg=ViTConfig(**VIT), device="cpu")
    assert n == 5 * len(VIDEOS)
    want, got = read_tree(tmp_path / "jax"), read_tree(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(got) == n
    for name in want:
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert a.shape == b.shape == (1, 64) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5, err_msg=name)


def test_stage2_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        P.extract_features(str(tmp_path), str(tmp_path / "out"), cfg=ViTConfig(**VIT))


@pytest.mark.parametrize("vocab", [False, True], ids=["default_vocab", "vocab_file"])
def test_stage3_assembles_the_jax_data_root(jax_tool, tmp_path, repo_root, vocab):
    """The same qa_sub_test.npy, OCR and feature links and vocabulary
    file (the default one, or a link to ``--vocab``), with the meta of a
    decoded video and a question whose video has none."""
    ocr = write_ocr(tmp_path / "ocr")
    questions = write_questions(tmp_path / "q.json")
    feats = str(tmp_path / "feats")
    meta = {"clip01": (FRAMES, 128, 96)}
    vocab_path = os.path.join(repo_root, "tests", "fixtures", "vocab_small.txt") if vocab else None
    roots = {}
    for name, tool in (("jax", jax_tool), ("port", P)):
        roots[name] = root = str(tmp_path / name)
        os.makedirs(root)
        tool.assemble_data_root(root, questions, ocr, feats, meta, vocab_path=vocab_path)
    listing = {}
    for name, root in roots.items():
        entries = {}
        for d, dirs, files in os.walk(root):
            for e in dirs + files:
                path = os.path.join(d, e)
                rel = os.path.relpath(path, root)
                entries[rel] = ("link", os.readlink(path)) if os.path.islink(path) else (
                    "dir" if os.path.isdir(path) else "file")
        listing[name] = entries
    assert listing["port"] == listing["jax"]
    ann = "vtextgqa/ground_annotation/qa_sub_test.npy"
    got, want = (np.load(os.path.join(roots[n], ann), allow_pickle=True).tolist()
                 for n in ("port", "jax"))
    assert got == want and len(got) == 1 + 3 * len(VIDEOS)
    assert [r.get("video_width") for r in got[1:]] == [128] * 3 + [1280] * 3
    vocabs = []
    for name in ("port", "jax"):
        with open(os.path.join(roots[name], "vtextgqa/vocabulary/fixed_vocab_top5k.txt")) as f:
            vocabs.append(f.read())
    assert vocabs[0] == vocabs[1] and (vocab or vocabs[0].split()[:4] == ["<pad>", "<unk>",
                                                                         "<s>", "</s>"])


@pytest.fixture(scope="module")
def data_root(tmp_path_factory, repo_root):
    """Stages 2 and 3 on Pillow frames with the tiny ViT on the CPU: a data
    root of two 8-frame videos, 3 OCR detections a frame, 3 questions a
    video."""
    tmp = tmp_path_factory.mktemp("e2e")
    frames = write_frames(tmp / "frames")
    feats = str(tmp / "feats")
    P.extract_features(frames, feats, cfg=ViTConfig(**VIT), device="cpu")
    root = str(tmp / "work")
    os.makedirs(root)
    P.assemble_data_root(root, write_questions(tmp / "q.json"), write_ocr(tmp / "ocr"), feats,
                         {vid: (FRAMES, 64, 48) for vid in VIDEOS},
                         vocab_path=os.path.join(repo_root, "tests", "fixtures", "vocab_small.txt"))
    return root


def tiny_opts():
    """The CPU in float32, tiny widths over the tiny ViT's 64-d features,
    the data root's geometry (tests/test_torch_runtime.tiny_opts')."""
    m, ds = "model_attributes.t2s", "dataset_attributes.vtextgqa"
    opts = ["training_parameters.device=cpu", "training_parameters.tpu.compute_dtype=float32",
            "training_parameters.num_workers=0", "training_parameters.seed=13",
            f"{m}.obj.mmt_in_dim={64 + 50}", f"{ds}.frames={FRAMES}",
            f"{ds}.ocr_frame_num={OCR_PER_FRAME}", f"{ds}.feat_dim=64"]
    opts += [f"{m}.{sect}.{k}={v}" for sect in ("text_bert", "translayers", "mmt")
             for k, v in TINY.items()]
    n = FRAMES * OCR_PER_FRAME
    opts += [f"{ds}.processors.{p}.params.max_length={n}"
             for p in ("answer_processor", "copy_processor", "phoc_processor", "context_processor")]
    g = f"{m}.grounding"
    opts += [f"{g}.hidden_size=64", f"{g}.frame_num={FRAMES}", f"{g}.ocr_frame_num={OCR_PER_FRAME}",
             f"{g}.max_ocr_num={n}", f"{g}.frame_topk=2", f"{g}.ocr_topk=2",
             f"{m}.classifier.ocr_max_num={n}", f"{m}.classifier.ocr_ptr_net.hidden_size=64",
             f"{m}.classifier.ocr_ptr_net.query_key_size=64"]
    return opts


def direct_run(repo_root, root, save_dir, ckpt=None):
    """``vitxtgqa_tpu_torch.run.run`` on the data root as stage 4 calls
    it; its one EvalAI JSON and the trainer."""
    argv = ["--config", os.path.join(repo_root, "configs", "t2s_abinet.yml"), "--model", "t2s",
            "--datasets", "vtextgqa", "--run_type", "test",
            f"dataset_attributes.vtextgqa.data_root_dir={root}",
            "training_parameters.batch_size=2", f"training_parameters.save_dir={save_dir}",
            "training_parameters.evalai_inference=True"] + tiny_opts()
    if ckpt:
        argv += [f"training_parameters.resume_file={ckpt}"]
    trainer = port_run(argv)
    (report,) = os.listdir(os.path.join(save_dir, "reports"))
    with open(os.path.join(save_dir, "reports", report)) as f:
        return json.load(f), trainer


def test_stage4_predicts_as_run_does(data_root, repo_root, tmp_path):
    """run_inference's predictions equal run()'s on the same data root,
    every question once; then with ``--ckpt`` a reference-style .pth of
    moved weights (the dead names planted, {"model": ...}, ``module.``,
    the classifier as ``classifier.*``) against run() resumed from a port
    torch file of the same weights, the dead names dropped and logged."""
    config = os.path.join(repo_root, "configs", "t2s_abinet.yml")
    want, trainer = direct_run(repo_root, data_root, str(tmp_path / "direct"))
    with open(P.run_inference(data_root, config, "t2s", batch_size=2,
                              extra_opts=tiny_opts())) as f:
        got = json.load(f)
    assert got == want
    assert sorted(r["question_id"] for r in got) == [0, 1, 2, 10, 11, 12]

    gen = torch.Generator().manual_seed(5)
    state = {k: v + 0.02 * torch.randn(v.shape, generator=gen)
             for k, v in trainer.model.state_dict().items()}
    torch.save(state, tmp_path / "port.pt")
    dead = {"Grounding_Module.frame_attn.weight": torch.ones(4, 64),
            "spatial_enhance.weight_ih_l0": torch.ones(8, 64)}
    ref = {f"module.{k.replace('classifier.module.', 'classifier.')}": v for k, v in state.items()}
    torch.save({"model": {**ref, **{f"module.{k}": v for k, v in dead.items()}},
                "best_iteration": 7}, tmp_path / "ref.pth")
    want, _ = direct_run(repo_root, data_root, str(tmp_path / "direct_ckpt"),
                         ckpt=str(tmp_path / "port.pt"))
    with open(P.run_inference(data_root, config, "t2s", ckpt=str(tmp_path / "ref.pth"),
                              batch_size=2, extra_opts=tiny_opts())) as f:
        got = json.load(f)
    assert got == want
    save = os.path.join(data_root, "save")
    log = ""
    for name in sorted(os.listdir(save)):
        if name.endswith(".log"):
            with open(os.path.join(save, name)) as f:
                log += f.read()
    assert f"dropped 2 names the model does not have, e.g. {sorted(dead)}" in log


def test_stage4_predicts_as_the_jax_tool_does(jax_tool, data_root, repo_root, tmp_path,
                                              monkeypatch):
    """Both tools' stage 4 on the same data root in float32 on the CPU,
    with ``--ckpt`` one reference-style .pth (the dead names planted,
    {"model": ...}, ``module.``, the classifier as ``classifier.*``): the
    port loads it through utils/torch_convert, the JAX trainer through its
    own converter (convert_t2s_like; its checkpoint reader takes orbax
    snapshots alone, so its restore is given the converter here), both
    grounding on the same gumbel noise.  The EvalAI JSONs are equal: every
    answer, source, grounded frame and box."""
    import flax
    import jax
    import vitxtgqa_tpu
    from tests.test_torch_runtime import _inject_port_noise, _noise
    from tests.test_torch_train import _patch_jax_gumbel
    from vitxtgqa_tpu.core.registry import registry as jax_registry
    from vitxtgqa_tpu.models.t2s import T2S as JT2S
    from vitxtgqa_tpu.training.trainer import BaseTrainer as JaxTrainer
    from vitxtgqa_tpu.utils.torch_convert import convert_into_params, convert_t2s_like, flatten
    from vitxtgqa_tpu.utils.torch_convert import load_state_dict as jax_load

    config = os.path.join(repo_root, "configs", "t2s_abinet.yml")
    _, trainer = direct_run(repo_root, data_root, str(tmp_path / "init"))
    gen = torch.Generator().manual_seed(11)
    state = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
             for k, v in trainer.model.state_dict().items()}
    ref = {f"module.{k.replace('classifier.module.', 'classifier.')}": v for k, v in state.items()}
    ref["module.Grounding_Module.frame_attn.weight"] = torch.ones(4, 64)
    torch.save({"model": ref, "best_iteration": 3}, tmp_path / "ref.pth")

    noise = _noise()
    _patch_jax_gumbel(monkeypatch, noise)
    _inject_port_noise(monkeypatch, noise)
    vitxtgqa_tpu.setup_imports()
    jax_registry.clear_state()

    def jit_init(self, rngs, batch, train=False):
        return jax.jit(lambda r, b: flax.linen.Module.init(self, r, b, train=train))(rngs, batch)

    def restore_pth(self, path):
        flat = convert_t2s_like(jax_load(path), text_layers=1, qtv_layers=1, mmt_layers=1)
        assert sorted(flat) == sorted(flatten(jax.tree_util.tree_map(np.asarray, self.params)))
        self.params = jax.device_put(convert_into_params(flat, self.params), self.param_sharding)

    monkeypatch.setattr(JT2S, "init", jit_init)
    monkeypatch.setattr(JaxTrainer, "_restore", restore_pth)
    with open(jax_tool.run_inference(data_root, config, "t2s", ckpt=str(tmp_path / "ref.pth"),
                                     batch_size=2, extra_opts=tiny_opts())) as f:
        want = json.load(f)
    with open(P.run_inference(data_root, config, "t2s", ckpt=str(tmp_path / "ref.pth"),
                              batch_size=2, extra_opts=tiny_opts())) as f:
        got = json.load(f)
    assert sorted(r["question_id"] for r in got) == [0, 1, 2, 10, 11, 12]
    assert got == want
