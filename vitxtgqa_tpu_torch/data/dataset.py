"""ViTXT-GQA dataset: per-sample assembly into fixed-shape numpy arrays.

The port's copy of vitxtgqa_tpu/data/dataset.py, a re-design of the
reference VTEXTGQADataset (pythia/datasets/videoqa/vtextgqa/dataset.py:19-380)
for a fixed-shape input pipeline: every sample is a dict of statically-shaped numpy arrays
(device fields) plus host-only python objects (strings), so batches collate
into a fixed-shape pytree with no pickle-in-tensor transport
(the reference encodes token lists as uint8 tensors,
objects_to_byte_tensor.py:12-43 — unnecessary here).

Field shapes (T=20 question tokens, F=64 frames, K=15 OCR/frame, N=F*K=960,
S=12 decode steps):
  text[T] i64, text_len scalar, video_feat[F,1024] f32, frame_id[F] i64,
  frame_mask[F] f32, mid_img_feat[1,1024] f32, middel_frame_id[1] i64,
  middel_frame_idx[1] i64, ocr_bbox_coordinates[N,4] f32, track_id[N] i64,
  temporal_id[N] i64, ocr_mask[N] f32, context_feature_0[N,300] f32,
  context_feature_1[N,604] f32, targets[S,V+N] f32, train_prev_inds[S] i64,
  train_loss_mask[S] f32, question_id scalar i64, frame_num scalar i64.
Host fields: image_id, context_tokens (N strings), gt_answers.
"""

from __future__ import annotations

import glob
import os
import random
from typing import Any, Dict, List, Optional

import numpy as np

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.data.feature_readers import VideoFeatureReader
from vitxtgqa_tpu_torch.data.processors import Processor

HOST_KEYS = ("image_id", "context_tokens", "gt_answers", "dataset_type", "dataset_name")


def sample_frames(frames: List[int], sample_len: int) -> List[int]:
    """Uniform stride sampling (reference: vtextgqa/dataset.py:371-380)."""
    if len(frames) <= sample_len:
        return list(frames)
    step = len(frames) // sample_len
    return [frames[i * step] for i in range(sample_len)]


def polygon_to_xyxy(points: List[float]) -> List[float]:
    """8-point OCR polygon -> xyxy (reference: vtextgqa/dataset.py:124-129)."""
    x1 = min(points[0], points[6])
    y1 = min(points[1], points[3])
    x2 = max(points[2], points[4])
    y2 = max(points[5], points[7])
    return [x1, y1, x2, y2]


class VTextGQADataset:
    """One split of the grounded TextVideoQA dataset."""

    def __init__(
        self,
        dataset_type: str,
        config: Any,
        imdb_file_index: int = 0,
        rng: Optional[random.Random] = None,
    ):
        self._name = "vtextgqa"
        self.dataset_type = dataset_type
        self.config = config
        self.data_root = config.data_root_dir
        self.rng = rng or random.Random()

        imdb_files = config.imdb_files
        if dataset_type not in imdb_files:
            raise ValueError(f"no imdb for split {dataset_type}")
        self.imdb_path = self._abs(imdb_files[dataset_type][imdb_file_index])
        # row 0 is metadata (reference: vtextgqa/dataset.py:34)
        self.imdb = np.load(self.imdb_path, allow_pickle=True)[1:]

        self.ocr_info_dir = self._abs(config.ocr_infos[dataset_type][0])
        feats = getattr(config, "image_features", None)
        self.feat_dir = (
            self._abs(feats[dataset_type][0]) if feats else None
        )
        frames_root = getattr(config, "frames_dir", "fps10_frames")
        self.frames_dir = self._abs(frames_root)

        self.num_frames = int(config.frames)
        self.frame_ocr_num = int(config.ocr_frame_num)
        self.feat_dim = int(getattr(config, "feat_dim", 1024))

        # whole-video reads with an LRU replace the reference's 64
        # sequential np.loads (vtextgqa/dataset.py:268-282)
        self.feat_reader = (
            VideoFeatureReader(self.feat_dir, feat_dim=self.feat_dim)
            if self.feat_dir
            else None
        )

        self.init_processors()

    def _abs(self, path: str) -> str:
        if os.path.isabs(path):
            return path
        return os.path.join(self.data_root, path)

    # -- processors --------------------------------------------------------
    def init_processors(self) -> None:
        """Instantiate config-declared processors; register shared ones
        (reference: base_dataset.py:49-62 registers `<name>_<key>`)."""
        pconf = self.config.processors
        extra = {"data_root_dir": self.data_root}
        for key in (
            "text_processor",
            "ocr_token_processor",
            "context_processor",
            "phoc_processor",
            "copy_processor",
            "answer_processor",
        ):
            if hasattr(pconf, key):
                proc = Processor(getattr(pconf, key), **extra)
                setattr(self, key, proc)
                registry.register(f"{self._name}_{key}", proc)

    # -- lifecycle ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.imdb)

    def _count_frames(self, video: str, ocr_info: Dict[str, Any]) -> int:
        """Number of decoded frames for a video.

        The reference globs the raw-frames dir (vtextgqa/dataset.py:100-107);
        we fall back to the feature dir and then to the OCR-info dict so the
        raw frames need not be on disk.
        """
        d = os.path.join(self.frames_dir, video)
        if os.path.isdir(d):
            return len(glob.glob(os.path.join(d, "*.jpg")))
        if self.feat_reader is not None:
            n = self.feat_reader.frame_count(video)
            if n:
                return n
        return len(ocr_info)

    def get_item(self, idx: int) -> Dict[str, Any]:
        info = self.imdb[idx]
        sample: Dict[str, Any] = {}
        sample["question_id"] = np.int64(info["question_id"])
        vid = info["video_id"]
        sample["image_id"] = str(vid) if isinstance(vid, int) else vid
        self._add_sample_details(info, sample)
        self._add_answer_info(info, sample)
        sample["gt_answers"] = list(info["answers"])
        sample["dataset_type"] = self.dataset_type
        sample["dataset_name"] = self._name
        return sample

    __getitem__ = get_item

    # -- assembly ------------------------------------------------------------
    def _add_sample_details(self, info: Dict[str, Any], sample: Dict[str, Any]):
        q = self.text_processor({"question": info["question"]})
        sample["text"] = q["token_inds"]
        sample["text_len"] = q["token_num"]

        video = sample["image_id"]
        width, height = info["video_width"], info["video_height"]

        ocr_info = np.load(
            os.path.join(self.ocr_info_dir, video + ".npy"), allow_pickle=True
        ).item()
        n_avail = self._count_frames(video, ocr_info)
        idxs = sample_frames(list(range(1, n_avail + 1)), self.num_frames)

        F, K = self.num_frames, self.frame_ocr_num
        N = F * K
        ocr_tokens_raw: List[str] = []
        bboxes: List[List[float]] = []
        track = np.zeros(N, dtype=np.int64)
        temporal = np.zeros(N, dtype=np.int64)
        ocr_mask = np.zeros(N, dtype=np.float32)
        frame_id = np.zeros(F, dtype=np.int64)
        frame_mask = np.zeros(F, dtype=np.float32)

        for fi, frame_idx in enumerate(idxs):
            key = str(frame_idx) if len(ocr_info) >= frame_idx else str(frame_idx - 1)
            dets = ocr_info.get(key, [])[:K]
            base = fi * K
            for j, det in enumerate(dets):
                ocr_tokens_raw.append(det["ocr"])
                bboxes.append(polygon_to_xyxy(det["points"]))
                track[base + j] = det["ID"]
                ocr_mask[base + j] = 1.0
            for j in range(len(dets), K):
                ocr_tokens_raw.append("<pad>")
                bboxes.append([0.0, 0.0, 0.0, 0.0])
            # temporal id covers padding slots too (reference: dataset.py:143).
            # INVARIANT the compact t2s_wo_sg serving path relies on: each
            # temporal id appears on exactly one grid frame's K slots
            # (sample_frames returns distinct frame indices), so a ground id
            # matches at most ocr_frame_num slots and the first-k-true slot
            # list in models/t2s_ablations.GroundingWithoutSpatial is
            # complete (ADVICE r2).
            temporal[base : base + K] = frame_idx
            frame_id[fi] = frame_idx
            frame_mask[fi] = 1.0

        # the reference's "middle frame" resolves to the last sampled frame
        # (sequential overwrites, reference: vtextgqa/dataset.py:174-182)
        mid_frame_id = idxs[-1]
        mid_frame_idx = (
            len(idxs) // 2 + 1 if mid_frame_id >= self.num_frames else mid_frame_id
        )
        sample["middel_frame_id"] = np.array([mid_frame_id], dtype=np.int64)
        sample["middel_frame_idx"] = np.array([mid_frame_idx], dtype=np.int64)

        bbox_arr = np.asarray(bboxes, dtype=np.float32) if bboxes else np.zeros(
            (0, 4), np.float32
        )
        bbox_arr = bbox_arr * np.array(
            [1.0 / width, 1.0 / height, 1.0 / width, 1.0 / height], np.float32
        )
        sample["ocr_bbox_coordinates"] = self.copy_processor({"blob": bbox_arr})[
            "blob"
        ]

        sample["track_id"] = track
        sample["temporal_id"] = temporal
        sample["ocr_mask"] = ocr_mask
        sample["frame_id"] = frame_id
        sample["frame_mask"] = frame_mask

        ocr_tokens = [
            self.ocr_token_processor({"text": t})["text"] for t in ocr_tokens_raw[:N]
        ]
        context = self.context_processor({"tokens": ocr_tokens})
        sample["context_feature_0"] = context["text"]
        sample["context_tokens"] = context["tokens"]
        phoc = self.phoc_processor({"tokens": ocr_tokens})
        sample["context_feature_1"] = phoc["text"]

        # precomputed per-frame ViT features <video>/<frame>.npy [1, D],
        # read once per video (feature_readers.py)
        feats = np.zeros((F, self.feat_dim), dtype=np.float32)
        mid_feat = np.zeros((1, self.feat_dim), dtype=np.float32)
        if self.feat_reader is not None:
            rows = self.feat_reader.read_frames(video, idxs, pad_to=F)
            feats[: rows.shape[0]] = rows[:F]
            for fi, frame_idx in enumerate(idxs):
                if frame_idx == mid_frame_id:
                    mid_feat[0] = feats[fi]
        sample["video_feat"] = feats
        sample["mid_img_feat"] = mid_feat
        sample["frame_num"] = np.int64(len(idxs))

    def _add_answer_info(self, info: Dict[str, Any], sample: Dict[str, Any]):
        """Shuffle answers, keep 2, tile to 10 (reference: dataset.py:290-311)."""
        answers = list(info["answers"])
        self.rng.shuffle(answers)
        answers = answers[:2]
        if len(answers) == 1:
            tiled = answers * 10
        else:
            tiled = [answers[0]] * 5 + [answers[1]] * 5
        out = self.answer_processor(
            {"answers": tiled, "context_tokens": sample["context_tokens"]}
        )
        sample["targets"] = out["answers_scores"]
        sample["train_prev_inds"] = out["train_prev_inds"]
        sample["train_loss_mask"] = out["train_loss_mask"]
        sample["answers_tiled"] = tiled

    # -- host generators ----------------------------------------------------
    def rng_state(self) -> Dict[str, Any]:
        """The state of the two host generators a sample draws from: the
        answer shuffle and the answer processor's choice among matching
        decode sequences (a checkpoint keeps it, so that a resumed run
        assembles the batches an uninterrupted one would)."""
        return {"answer_shuffle": self.rng.getstate(),
                "answer_sequence": self.answer_processor.rng.bit_generator.state}

    def set_rng_state(self, state: Dict[str, Any]) -> None:
        self.rng.setstate(state["answer_shuffle"])
        self.answer_processor.rng.bit_generator.state = state["answer_sequence"]

    def seed_sample(self, entropy) -> None:
        """Seed both host generators from ``entropy`` (a worker process
        draws each sample from its (seed, epoch, index): loader.py)."""
        seq = np.random.SeedSequence(entropy)
        self.rng.seed(int(seq.generate_state(1)[0]))
        self.answer_processor.rng.bit_generator.state = (
            np.random.default_rng(seq).bit_generator.state)

    # -- registry hooks ------------------------------------------------------
    def update_registry_for_model(self) -> None:
        """Expose vocab sizes the model classifier needs
        (reference: vqa2/builder.py:40-48)."""
        registry.register(
            f"{self._name}_text_vocab_size", self.text_processor.get_vocab_size()
        )
        registry.register(
            f"{self._name}_num_final_outputs", self.answer_processor.get_vocab_size()
        )
        registry.register(f"{self._name}_answer_processor", self.answer_processor)


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack numpy fields along a new batch dim; keep host fields as lists.

    Replaces SampleList/BatchCollator (reference: pythia/common/sample.py:58-326,
    batch_collator.py:5-15).  Output: {"tensors": {...}, "host": {...}}.
    The JAX package's ``cast`` (a bf16 pre-cast on the host) is left out:
    the port moves float32 features and the model casts them on the device,
    with the same values.
    """
    tensors: Dict[str, np.ndarray] = {}
    host: Dict[str, Any] = {}
    first = samples[0]
    for key, val in first.items():
        if key in ("dataset_type", "dataset_name"):
            host[key] = val
        elif key in ("image_id", "context_tokens", "gt_answers", "answers_tiled"):
            host[key] = [s[key] for s in samples]
        elif isinstance(val, np.ndarray) or np.isscalar(val) or isinstance(
            val, (np.integer, np.floating)
        ):
            tensors[key] = np.stack([np.asarray(s[key]) for s in samples])
        else:
            host[key] = [s[key] for s in samples]
    return {"tensors": tensors, "host": host}
