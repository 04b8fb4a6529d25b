"""Feature stores: per-frame npy reads with a whole-video LRU, and padded
[N, D] -> [max_loc, D] reads for the legacy image-VQA datasets.

The numpy path of vitxtgqa_tpu/data/feature_readers.py: the JAX reader
returns the same arrays from it when its native threaded reader (_featio)
is unavailable (feature_readers.py:65-75, 110-116).  Host IO, not a device
kernel; the native reader is listed in ROADMAP.md.  (reference:
pythia/datasets/features_dataset.py:12-125, feature_readers.py:8-165.)
"""

from __future__ import annotations

import glob
import os
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np


class _LRU:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.store: "OrderedDict[str, Any]" = OrderedDict()

    def get(self, key):
        if key in self.store:
            self.store.move_to_end(key)
            return self.store[key]
        return None

    def put(self, key, value):
        if self.capacity <= 0:
            return
        self.store[key] = value
        self.store.move_to_end(key)
        while len(self.store) > self.capacity:
            self.store.popitem(last=False)


class PaddedFeatureReader:
    """<dir>/<id>.npy [N, D] -> (padded [max_loc, D], n_valid)
    (reference: feature_readers.py:103-142)."""

    def __init__(self, base_dir: str, max_loc: int = 100, cache_size: int = 256):
        self.base_dir = base_dir
        self.max_loc = max_loc
        self.cache = _LRU(cache_size)

    def read(self, item_id: str) -> Tuple[np.ndarray, int]:
        cached = self.cache.get(item_id)
        if cached is not None:
            return cached
        feat = np.load(os.path.join(self.base_dir, f"{item_id}.npy"), allow_pickle=True)
        if feat.ndim == 1:
            feat = feat[None, :]
        n = min(len(feat), self.max_loc)
        out = np.zeros((self.max_loc, feat.shape[-1]), np.float32)
        out[:n] = feat[:n]
        result = (out, n)
        self.cache.put(item_id, result)
        return result


class VideoFeatureReader:
    """<dir>/<video>/<frame>.npy [1, D] per-frame features with an LRU of
    whole videos (the reference dataset's per-frame np.load loop,
    vtextgqa/dataset.py:268-282, read once per video)."""

    def __init__(self, base_dir: str, feat_dim: int = 1024, cache_size: int = 64):
        self.base_dir = base_dir
        self.feat_dim = feat_dim
        self.cache = _LRU(cache_size)

    def frame_count(self, video_id: str) -> int:
        vdir = os.path.join(self.base_dir, video_id)
        return len(glob.glob(os.path.join(vdir, "*.npy")))

    def _load_video(self, video_id: str) -> Dict[int, np.ndarray]:
        cached = self.cache.get(video_id)
        if cached is not None:
            return cached
        vdir = os.path.join(self.base_dir, video_id)
        paths = glob.glob(os.path.join(vdir, "*.npy"))
        fids = [int(os.path.splitext(os.path.basename(p))[0]) for p in paths]
        feats: Dict[int, np.ndarray] = {}
        for fid, path in zip(fids, paths):
            feats[fid] = np.load(path, allow_pickle=True).astype(np.float32)
        self.cache.put(video_id, feats)
        return feats

    def read_frames(self, video_id: str, frame_ids, pad_to: Optional[int] = None
                    ) -> np.ndarray:
        feats = self._load_video(video_id)
        rows = [
            feats.get(int(f), np.zeros((1, self.feat_dim), np.float32)).reshape(-1)[
                : self.feat_dim
            ]
            for f in frame_ids
        ]
        out = np.stack(rows) if rows else np.zeros((0, self.feat_dim), np.float32)
        if pad_to is not None and len(out) < pad_to:
            out = np.concatenate(
                [out, np.zeros((pad_to - len(out), self.feat_dim), np.float32)]
            )
        return out
