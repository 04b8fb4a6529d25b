"""Per-frame ViT features on the card: frames to ``video_feat`` rows.

    python -m vitxtgqa_tpu_torch.video_feat --frames DIR --out DIR \\
        [--weights F] [--batch 64] [--model vit_l_16|vit_h_14]

Counterpart of tools/video_feat/obtain_vit_feat.py, with its contract:
reads ``<frames>/<video>/<n>.jpg`` in numeric order of ``n``, resizes each
frame to 224 x 224 as that tool does (PIL's ``Image.resize``), runs the
frames through ViT-L/16 (``--model vit_h_14``: ViT-H/14) in bf16 on the card
in chunks of ``--batch`` and writes ``<out>/<video>/<n>.npy``, the frame's
CLS feature as float32 [1, 1024] (ViT-H/14: [1, 1280]).
``--weights`` is a torch checkpoint of HF ``ViTModel`` (or a model with a
head: its ``vit.`` prefix is stripped); without it the weights are random
from seed 0, for pipeline tests only.  Pillow is needed here alone, and is
imported by ``extract_features``, which the raw-video pipeline's stage 2
runs too (e2e_pipeline.py).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch


def iter_videos(frames_root: str) -> Iterator[Tuple[str, str, List[str]]]:
    """(video id, its directory, its .jpg names in numeric order) for every
    video directory under ``frames_root``, in sorted order."""
    for video_id in sorted(os.listdir(frames_root)):
        vdir = os.path.join(frames_root, video_id)
        if not os.path.isdir(vdir):
            continue
        frames = sorted((f for f in os.listdir(vdir) if f.endswith(".jpg")),
                        key=lambda f: int(os.path.splitext(f)[0]))
        yield video_id, vdir, frames


def write_features(frames_root: str, out_root: str, extract: Callable,
                   load_frame: Callable[[str], np.ndarray], batch: int = 64) -> int:
    """Run every video's frames through ``extract`` (uint8 [b, H, W, 3] ->
    [b, D]) in chunks of ``batch``; ``load_frame(path)`` gives one frame as
    uint8 [H, W, 3].  Writes ``<out_root>/<video>/<n>.npy`` as float32 [1,
    D]; returns the number of frames written."""
    n_written = 0
    for video_id, vdir, frames in iter_videos(frames_root):
        odir = os.path.join(out_root, video_id)
        os.makedirs(odir, exist_ok=True)
        for start in range(0, len(frames), batch):
            chunk = frames[start:start + batch]
            imgs = np.stack([load_frame(os.path.join(vdir, f)) for f in chunk])
            feats = extract(imgs).float().cpu().numpy()
            for f, feat in zip(chunk, feats):
                np.save(os.path.join(odir, f"{os.path.splitext(f)[0]}.npy"), feat[None, :])
        n_written += len(frames)
        print(f"{video_id}: {len(frames)} frames", flush=True)
    return n_written


def extract_features(frames_root: str, out_root: str, weights: Optional[str] = None,
                     batch: int = 64, cfg=None, device=None) -> int:
    """Every video's frames through the ViT ``cfg`` (default ViT-L/16) on
    ``device`` (default: the card, bf16), each frame resized by PIL to the
    ViT's image size, into ``<out_root>/<video>/<n>.npy``; ``weights``: an
    HF ViT torch checkpoint.  Returns the number of frames."""
    from PIL import Image

    from vitxtgqa_tpu_torch.models.vit import VIT_L_16, make_feature_extractor
    from vitxtgqa_tpu_torch.options import Options, entry_device
    from vitxtgqa_tpu_torch.utils.convert import strip_vit_prefix

    cfg = VIT_L_16 if cfg is None else cfg
    dev = entry_device(device)
    state = None
    if weights:
        state = strip_vit_prefix(torch.load(weights, map_location="cpu", weights_only=True))
    extract, _ = make_feature_extractor(cfg, state, Options(device=dev))
    size = (cfg.image_size, cfg.image_size)

    def load_frame(path: str) -> np.ndarray:
        return np.asarray(Image.open(path).convert("RGB").resize(size), dtype=np.uint8)

    return write_features(frames_root, out_root, extract, load_frame, batch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", required=True, help="directory of <video>/<n>.jpg")
    ap.add_argument("--out", required=True)
    ap.add_argument("--weights", default=None, help="torch ViTModel checkpoint")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--model", default="vit_l_16", choices=("vit_l_16", "vit_h_14"),
                    help="the ViT: the reference's ViT-L/16 or ViT-H/14")
    args = ap.parse_args(argv)
    from vitxtgqa_tpu_torch.models.vit import VIT_CONFIGS

    extract_features(args.frames, args.out, args.weights, args.batch,
                     cfg=VIT_CONFIGS[args.model])
    return 0


if __name__ == "__main__":
    sys.exit(main())
