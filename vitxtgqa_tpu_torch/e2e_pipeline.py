"""End-to-end pipeline: raw videos to grounded QA predictions (BASELINE
config #5).

    python -m vitxtgqa_tpu_torch.e2e_pipeline --videos DIR \\
        --questions questions.json --ocr DIR --workdir DIR \\
        [--config configs/t2s_abinet.yml] [--model t2s] [--ckpt PATH] \\
        [--vit_weights F] [--vocab F] [--fps 10]

Counterpart of tools/e2e_pipeline.py, with its stages and flags:
  1. ``decode_videos``: each video sampled at ``--fps`` by OpenCV (imported
     in the stage), its frames written as 1-indexed jpgs;
  2. ``extract_features`` (video_feat.extract_features): the frames
     through ViT-L/16 on the card, each resized by PIL to the ViT's image
     size first, one CLS feature a frame;
  3. ``assemble_data_root``: a transient data root for split "test" from
     the questions JSON and the OCR detections (``<video>.npy``, the
     reference's ``{frame: [{"points", "ocr", "ID"}]}``; OCR itself is an
     external system in the reference too);
  4. ``run_inference``: vitxtgqa_tpu_torch.run's ``--run_type test`` with
     EvalAI predictions; ``--ckpt`` is its ``--resume_file``: a port
     snapshot directory, a port torch file or a reference ``.pth``
     (utils/torch_convert.py drops its dead parameters).

questions.json: [{"question_id": 1, "video_id": "clip01", "question": "...",
"answers": ["..."]}, ...].  ``--vit_weights`` is an HF ``ViTModel`` torch
checkpoint (video_feat's ``--weights``); without it the ViT's weights are
random from seed 0.  Everything runs on the card; the stage functions take
``device="cpu"`` (stage 2) and ``training_parameters.device=cpu`` (stage
4, through ``extra_opts``) to run the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

# stage 2, shared with python -m vitxtgqa_tpu_torch.video_feat
from vitxtgqa_tpu_torch.video_feat import extract_features  # noqa: F401


def decode_videos(video_dir: str, frames_dir: str, fps: int) -> dict:
    """Sample each video at ``fps`` and dump 1-indexed jpgs; returns
    {video_id: (n_frames, width, height)}."""
    import cv2

    meta = {}
    for name in sorted(os.listdir(video_dir)):
        if not name.lower().endswith((".mp4", ".avi", ".mkv", ".mov")):
            continue
        video_id = os.path.splitext(name)[0]
        out_dir = os.path.join(frames_dir, video_id)
        os.makedirs(out_dir, exist_ok=True)
        cap = cv2.VideoCapture(os.path.join(video_dir, name))
        src_fps = cap.get(cv2.CAP_PROP_FPS) or fps
        step = src_fps / fps
        n, idx, next_pick = 0, 0, 0.0
        width = height = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx >= next_pick:
                n += 1
                cv2.imwrite(os.path.join(out_dir, f"{n}.jpg"), frame)
                height, width = frame.shape[:2]
                next_pick += step
            idx += 1
        cap.release()
        meta[video_id] = (n, width, height)
        print(f"decoded {video_id}: {n} frames @ {fps}fps", flush=True)
    return meta


def assemble_data_root(workdir: str, questions_path: str, ocr_dir: str,
                       feat_dir: str, meta: dict, vocab_path: str = None):
    """Lay out the workdir as a framework data root for split 'test'."""
    with open(questions_path) as f:
        questions = json.load(f)
    imdb = [{"metadata": {"source": "e2e_pipeline"}}]
    for q in questions:
        vid = q["video_id"]
        n, w, h = meta.get(vid, (0, 0, 0))
        imdb.append(
            {
                "question_id": int(q["question_id"]),
                "video_id": vid,
                "question": q["question"],
                "answers": list(q.get("answers", ["<unk>"])) or ["<unk>"],
                "video_width": w or q.get("width", 1280),
                "video_height": h or q.get("height", 720),
            }
        )
    os.makedirs(os.path.join(workdir, "vtextgqa", "ground_annotation"), exist_ok=True)
    os.makedirs(os.path.join(workdir, "vtextgqa", "vocabulary"), exist_ok=True)
    np.save(
        os.path.join(workdir, "vtextgqa", "ground_annotation", "qa_sub_test.npy"),
        np.array(imdb, dtype=object), allow_pickle=True,
    )
    ocr_out = os.path.join(workdir, "fps10_ocr_detection", "test")
    os.makedirs(ocr_out, exist_ok=True)
    for name in os.listdir(ocr_dir):
        if name.endswith(".npy"):
            src = os.path.join(ocr_dir, name)
            dst = os.path.join(ocr_out, name)
            if not os.path.exists(dst):
                os.symlink(os.path.abspath(src), dst)
    feat_link = os.path.join(workdir, "fps10_video_vit_feat")
    if not os.path.exists(feat_link):
        os.symlink(os.path.abspath(feat_dir), feat_link)
    vdst = os.path.join(workdir, "vtextgqa", "vocabulary", "fixed_vocab_top5k.txt")
    if vocab_path and not os.path.exists(vdst):
        os.symlink(os.path.abspath(vocab_path), vdst)
    elif not os.path.exists(vdst):
        with open(vdst, "w") as f:
            f.write("\n".join(["<pad>", "<unk>", "<s>", "</s>", "yes", "no"]) + "\n")


def inference_argv(workdir: str, config: str, model: str, ckpt: str = None,
                   batch_size: int = 8, extra_opts: Optional[Sequence[str]] = None) -> list:
    """vitxtgqa_tpu_torch.run's arguments of stage 4."""
    argv = [
        "--config", config, "--model", model, "--datasets", "vtextgqa",
        "--run_type", "test",
    ]
    if ckpt:
        argv += ["--resume_file", ckpt]
    argv += [
        f"dataset_attributes.vtextgqa.data_root_dir={workdir}",
        f"training_parameters.batch_size={batch_size}",
        f"training_parameters.save_dir={workdir}/save",
        "training_parameters.evalai_inference=True",
    ]
    return argv + list(extra_opts or [])


def run_inference(workdir: str, config: str, model: str, ckpt: str = None,
                  batch_size: int = 8, extra_opts: Optional[Sequence[str]] = None) -> str:
    """Predict the data root's test split through vitxtgqa_tpu_torch.run
    (which predicts it once), then once more as the JAX tool does; returns
    the EvalAI JSON's path."""
    from vitxtgqa_tpu_torch.run import run

    trainer = run(inference_argv(workdir, config, model, ckpt, batch_size, extra_opts))
    try:
        return trainer.predict_for_evalai("test")
    finally:
        trainer.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--videos", required=True)
    ap.add_argument("--questions", required=True)
    ap.add_argument("--ocr", required=True, help="dir of <video>.npy OCR detections")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--config", default="configs/t2s_abinet.yml")
    ap.add_argument("--model", default="t2s")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--vit_weights", default=None)
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--fps", type=int, default=10)
    args = ap.parse_args(argv)

    frames_dir = os.path.join(args.workdir, "frames")
    feat_dir = os.path.join(args.workdir, "vit_feats")
    meta = decode_videos(args.videos, frames_dir, args.fps)
    extract_features(frames_dir, feat_dir, weights=args.vit_weights)
    assemble_data_root(args.workdir, args.questions, args.ocr, feat_dir, meta,
                       vocab_path=args.vocab)
    report = run_inference(args.workdir, args.config, args.model, args.ckpt)
    print(f"predictions: {report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
