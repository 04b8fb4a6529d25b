"""Synthetic fixed-shape batches for the smoke run and the tests.

The same generator as vitxtgqa_tpu/utils/synthetic.py:synthetic_batch
(numpy only, identical output for the same arguments — a test holds the
two equal), kept in the port so that it runs without the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_batch(
    batch: int = 2,
    frames: int = 64,
    ocr_per_frame: int = 15,
    dec_steps: int = 12,
    text_len: int = 20,
    video_feat_dim: int = 1024,
    fasttext_dim: int = 300,
    phoc_dim: int = 604,
    num_final_outputs: int = 5050 + 960,
    text_vocab: int = 30522,
    seed: int = 0,
    gt_box: bool = False,
) -> Dict[str, np.ndarray]:
    """A batch with the exact field layout the models consume
    (see vitxtgqa_tpu/data/dataset.py docstring for shapes).  ``gt_box``
    adds the GT-box oracle's fields as the JAX package's model-zoo test
    does (tests/test_model_zoo.py: random annotated boxes from their own
    generator, the sampled frames as the annotated ones, the detected
    masks and ids as the annotated ones); the other fields stay as they
    are without it."""
    r = np.random.default_rng(seed)
    n = frames * ocr_per_frame
    frame_num = r.integers(frames // 2, frames + 1, batch)
    frame_id = np.zeros((batch, frames), np.int32)
    frame_mask = np.zeros((batch, frames), np.float32)
    temporal = np.zeros((batch, n), np.int32)
    for i in range(batch):
        k = frame_num[i]
        frame_id[i, :k] = np.arange(1, k + 1)
        frame_mask[i, :k] = 1
        for f in range(k):
            temporal[i, f * ocr_per_frame : (f + 1) * ocr_per_frame] = f + 1
    ocr_mask = ((r.random((batch, n)) > 0.4) & (temporal > 0)).astype(np.float32)
    targets = np.zeros((batch, dec_steps, num_final_outputs), np.float32)
    targets[:, 0, 5] = 1.0
    targets[:, 1, 3] = 1.0
    prev = np.zeros((batch, dec_steps), np.int64)
    prev[:, 0] = 2
    prev[:, 1] = 5
    loss_mask = np.zeros((batch, dec_steps), np.float32)
    loss_mask[:, :3] = 1.0
    mid_idx = np.maximum(frame_num, 1)
    out = {
        "question_id": np.arange(batch, dtype=np.int64),
        "text": r.integers(1, text_vocab, (batch, text_len)).astype(np.int64),
        "text_len": np.full((batch,), text_len - 2, np.int64),
        "video_feat": r.standard_normal((batch, frames, video_feat_dim)).astype(
            np.float32
        ),
        "mid_img_feat": r.standard_normal((batch, 1, video_feat_dim)).astype(
            np.float32
        ),
        "middel_frame_id": frame_id[np.arange(batch), frame_num - 1][:, None].astype(
            np.int64
        ),
        "middel_frame_idx": mid_idx[:, None].astype(np.int64),
        "frame_id": frame_id,
        "frame_mask": frame_mask,
        "frame_num": frame_num.astype(np.int64),
        "temporal_id": temporal,
        "track_id": r.integers(0, 50, (batch, n)).astype(np.int64),
        "ocr_mask": ocr_mask,
        "context_feature_0": r.standard_normal((batch, n, fasttext_dim)).astype(
            np.float32
        ),
        "context_feature_1": (r.random((batch, n, phoc_dim)) > 0.7).astype(
            np.float32
        ),
        "ocr_bbox_coordinates": r.random((batch, n, 4)).astype(np.float32),
        "train_prev_inds": prev,
        "train_loss_mask": loss_mask,
        "targets": targets,
    }
    if gt_box:
        out.update(
            ocr_bbox_list=np.random.default_rng((seed, 1)).random((batch, n, 4)).astype(np.float32),
            frame_list=frame_id.astype(np.int64), frame_mask_embedding=frame_mask,
            ocr_mask_embedding=ocr_mask, ocr_track_id=out["track_id"],
            ocr_temporal_id=temporal)
    return out


def synthetic_frames(batch: int = 64, h: int = 240, w: int = 320, seed: int = 0) -> np.ndarray:
    """uint8 RGB frames [batch, h, w, 3] from a seed: a smooth colour field
    per frame (so a resize has structure to keep) plus uniform noise."""
    r = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0.0, 1.0, h), np.linspace(0.0, 1.0, w), indexing="ij")
    phase = r.uniform(0.0, 2 * np.pi, (batch, 1, 1, 3))
    freq = r.uniform(1.0, 6.0, (batch, 1, 1, 3))
    field = 0.5 + 0.35 * np.sin(freq * (yy[None, ..., None] + xx[None, ..., None]) * np.pi + phase)
    noise = r.uniform(-0.15, 0.15, (batch, h, w, 3))
    return np.clip((field + noise) * 255.0, 0, 255).astype(np.uint8)
