"""Legacy image-VQA dataset chain: VQA2 -> VizWiz -> TextVQA (+ OCR variant).

The port's copy of vitxtgqa_tpu/data/legacy_vqa_datasets.py, a rebuild of
the reference inheritance chain (reference:
pythia/datasets/vqa/vqa2/dataset.py:15-206 -> vizwiz/dataset.py:8-48 ->
textvqa/dataset.py:6-27; ocr_dataset.py:6-34; builders at
vqa2/builder.py:18-89, vizwiz/builder.py:7-16, textvqa/builder.py:7-12,
ocr_builder.py:7-12), so that the legacy models (models/legacy_vqa.py) run
end to end through ``python -m vitxtgqa_tpu_torch.run`` on a config.
A sample draws nothing at random, so ``seed_sample`` (the loader's worker
seeding) has nothing to seed.

As VTextGQADataset's, every sample is a dict of
statically-shaped numpy arrays plus host-side python strings — no
Sample/SampleList, no pickle-in-tensor transport.  Emitted fields match
what the legacy models consume:

  text [T] i64, text_len i64, question_id i64,
  image_feature_0 [max_loc, D] f32, image_info_0_max_features i64,
  targets [num_final_outputs] f32,
  (use_ocr) context_feature_0 [ocr_max, 300] f32,
            context_info_0_max_features i64,
            order_vectors [ocr_max, ocr_max] f32,
  (use_ocr_info) ocr_bbox [ocr_max, 4] f32.
Host fields: image_id, question_tokens, context_tokens, gt_answers.
"""

from __future__ import annotations

import os
import random
from typing import Any, Dict, List, Optional

import numpy as np

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.data.feature_readers import PaddedFeatureReader
from vitxtgqa_tpu_torch.data.processors import Processor
from vitxtgqa_tpu_torch.data.text import word_tokenize


def load_imdb(path: str):
    """Reference ImageDatabase npy forms (image_database.py:53-69):
    a dict {metadata, data}, or a raw array whose row 0 is metadata when
    it lacks an image_id."""
    db = np.load(path, allow_pickle=True)
    if db.ndim == 0:  # 0-d object array wrapping a dict
        db = db.item()
    if isinstance(db, dict):
        return list(db.get("data", []))
    data = list(db)
    if data and "image_id" not in data[0]:
        data = data[1:]
    return data


def _imdb_answers(info: Dict[str, Any]) -> Optional[List[str]]:
    """Older-imdb aliases + trailing-<copy> strip
    (reference: image_database.py:82-93)."""
    answers = info.get("answers")
    if answers is None:
        if "valid_answers" in info:
            answers = info["valid_answers"]
        elif "all_answers" in info:
            answers = info["all_answers"]
    if answers is not None and len(answers) and answers[-1] == "<copy>":
        answers = answers[:-1]
    return list(answers) if answers is not None else None


class VQA2Dataset:
    """One split of a VQA2-format image-QA dataset
    (reference: vqa2/dataset.py:15-206)."""

    _name = "vqa2"

    def __init__(
        self,
        dataset_type: str,
        config: Any,
        imdb_file_index: int = 0,
        rng: Optional[random.Random] = None,
    ):
        self.dataset_type = dataset_type
        self.config = config
        self.data_root = config.data_root_dir
        self.rng = rng or random.Random()

        imdb_files = config.imdb_files
        if dataset_type not in imdb_files:
            raise ValueError(f"no imdb for split {dataset_type}")
        self.imdb_path = self._abs(imdb_files[dataset_type][imdb_file_index])
        self.imdb = load_imdb(self.imdb_path)

        self.use_ocr = bool(getattr(config, "use_ocr", False))
        self.use_ocr_info = bool(getattr(config, "use_ocr_info", False))

        self.feature_readers: List[PaddedFeatureReader] = []
        feats = getattr(config, "image_features", None)
        if feats is not None and dataset_type in feats:
            max_loc = int(getattr(config, "features_max_len", 100))
            # comma-separated dirs -> image_feature_0, image_feature_1, ...
            # (reference: vqa2/dataset.py:43-56)
            for d in str(feats[dataset_type][imdb_file_index]).split(","):
                self.feature_readers.append(
                    PaddedFeatureReader(self._abs(d.strip()), max_loc=max_loc)
                )

        self.init_processors()

    def _abs(self, path: str) -> str:
        return path if os.path.isabs(path) else os.path.join(self.data_root, path)

    def init_processors(self) -> None:
        """reference base_dataset.py:49-62: instantiate config processors,
        register each as `<name>_<key>`."""
        pconf = self.config.processors
        extra = {"data_root_dir": self.data_root}
        for key in (
            "text_processor",
            "ocr_token_processor",
            "context_processor",
            "bbox_processor",
            "answer_processor",
        ):
            if hasattr(pconf, key):
                proc = Processor(getattr(pconf, key), **extra)
                setattr(self, key, proc)
                registry.register(f"{self._name}_{key}", proc)

    def __len__(self) -> int:
        return len(self.imdb)

    # -- assembly -----------------------------------------------------------
    def get_item(self, idx: int) -> Dict[str, Any]:
        info = self.imdb[idx]
        sample: Dict[str, Any] = {}

        # question (reference: vqa2/dataset.py:100-122)
        if "question_tokens" in info:
            q = self.text_processor({"tokens": list(info["question_tokens"])})
            q_tokens = list(info["question_tokens"])
        else:
            q = self.text_processor({"text": info["question"]})
            q_tokens = [t for t in q["tokens"] if t != "<pad>"]
        sample["text"] = q["text"]
        sample["text_len"] = np.int64(len(q_tokens))
        sample["question_tokens"] = q_tokens
        sample["question_id"] = np.int64(info.get("question_id", -1))
        sample["image_id"] = info.get("image_id", "")

        # features (reference: vqa2/dataset.py:124-127 via FeaturesDataset)
        feat_name = info.get("feature_path")
        if feat_name is None:
            feat_name = f"{info['image_id']}.npy"
        item_key = os.path.splitext(str(feat_name))[0]
        for fi, reader in enumerate(self.feature_readers):
            feat, n = reader.read(item_key)
            sample[f"image_feature_{fi}"] = feat
            sample[f"image_info_{fi}_max_features"] = np.int64(n)

        sample = self.add_ocr_details(info, sample)
        sample = self.add_answer_info(info, sample)

        sample["dataset_type"] = self.dataset_type
        sample["dataset_name"] = self._name
        return sample

    __getitem__ = get_item

    def seed_sample(self, entropy) -> None:
        """Nothing to seed: no processor of the chain draws."""

    def add_ocr_details(self, info, sample):
        """reference vqa2/dataset.py:137-160: fastText context features +
        eye order vectors (rows past the real token count zeroed)."""
        if self.use_ocr:
            raw = list(info.get("ocr_tokens", []))
            ocr_tokens = [
                self.ocr_token_processor({"text": t})["text"] for t in raw
            ]
            context = self.context_processor({"tokens": ocr_tokens})
            sample["context_feature_0"] = context["text"]
            sample["context_tokens"] = context["tokens"]
            n = int(context["length"])
            sample["context_info_0_max_features"] = np.int64(n)
            order = np.eye(len(context["tokens"]), dtype=np.float32)
            order[n:] = 0.0
            sample["order_vectors"] = order
        if self.use_ocr_info and "ocr_info" in info:
            sample["ocr_bbox"] = self.bbox_processor(
                {"info": info["ocr_info"]}
            )["bbox"]["coordinates"]
        return sample

    def add_answer_info(self, info, sample):
        """reference vqa2/dataset.py:162-175: soft answer targets; the
        soft-copy processor additionally scores the OCR tail."""
        answers = _imdb_answers(info)
        if answers is not None:
            arg = {"answers": answers}
            if self.use_ocr:
                arg["tokens"] = list(info.get("ocr_tokens", []))
            out = self.answer_processor(arg)
            sample["gt_answers"] = out["answers"]
            sample["targets"] = out["answers_scores"]
        return sample

    # -- registry hooks -----------------------------------------------------
    def update_registry_for_model(self) -> None:
        """reference vqa2/builder.py:40-48."""
        registry.register(
            f"{self._name}_text_vocab_size", self.text_processor.get_vocab_size()
        )
        registry.register(
            f"{self._name}_num_final_outputs",
            self.answer_processor.get_vocab_size(),
        )
        registry.register(f"{self._name}_answer_processor", self.answer_processor)

    # -- evalai -------------------------------------------------------------
    def _decode_answer(self, answer_id: int, context_tokens: List[str]) -> str:
        space = self.answer_processor.get_true_vocab_size()
        if answer_id >= space:
            return context_tokens[answer_id - space]
        return self.answer_processor.idx2word(answer_id)

    def format_for_evalai(self, tensors, output, host) -> List[Dict[str, Any]]:
        """reference vqa2/dataset.py:180-206 (per-question answer records)."""
        answers = np.asarray(output["scores"]).argmax(-1)
        preds = []
        ctx_tokens = host.get("context_tokens") or [[]] * len(answers)
        for i, qid in enumerate(np.asarray(tensors["question_id"]).tolist()):
            answer = self._decode_answer(int(answers[i]), ctx_tokens[i])
            if answer == "<pad>":
                answer = "unanswerable"
            preds.append(
                {
                    "question_id": int(qid),
                    "answer": answer,
                    "actual_answers": (host.get("gt_answers") or [[]] * len(answers))[i],
                    "question_tokens": (host.get("question_tokens") or [[]] * len(answers))[i],
                    "image_id": host["image_id"][i],
                }
            )
        return preds


class VizWizDataset(VQA2Dataset):
    """reference vizwiz/dataset.py:8-48: image_name overrides image_id;
    evalai rows keyed by VizWiz image filename."""

    _name = "vizwiz"

    def get_item(self, idx):
        sample = super().get_item(idx)
        info = self.imdb[idx]
        if "image_name" in info:
            sample["image_id"] = info["image_name"]
        return sample

    __getitem__ = get_item

    def format_for_evalai(self, tensors, output, host):
        answers = np.asarray(output["scores"]).argmax(-1)
        ctx_tokens = host.get("context_tokens") or [[]] * len(answers)
        preds = []
        for i, image_id in enumerate(host["image_id"]):
            answer = self._decode_answer(int(answers[i]), ctx_tokens[i])
            if answer == "<pad>":
                answer = "unanswerable"
            preds.append(
                {
                    "image": "_".join(
                        ["VizWiz"] + str(image_id).split("_")[2:]
                    ) + ".jpg",
                    "answer": answer,
                }
            )
        return preds


class TextVQADataset(VizWizDataset):
    """reference textvqa/dataset.py:6-27: OCR-copy answers word_tokenized."""

    _name = "textvqa"

    def format_for_evalai(self, tensors, output, host):
        answers = np.asarray(output["scores"]).argmax(-1)
        ctx_tokens = host.get("context_tokens") or [[]] * len(answers)
        space = self.answer_processor.get_true_vocab_size()
        preds = []
        for i, qid in enumerate(np.asarray(tensors["question_id"]).tolist()):
            aid = int(answers[i])
            if aid >= space:
                answer = word_tokenize(ctx_tokens[i][aid - space])
            else:
                answer = self.answer_processor.idx2word(aid)
            preds.append({"question_id": int(qid), "answer": answer})
        return preds


class VQA2OCRDataset(VizWizDataset):
    """reference ocr_dataset.py:6-34 (`vqa2_ocr`): VizWiz assembly with
    word_tokenized OCR-copy answers and the question_id None -> -1 quirk
    (ocr_dataset.py:29-34; get_item already maps a missing id to -1)."""

    _name = "vqa2_ocr"

    def format_for_evalai(self, tensors, output, host):
        answers = np.asarray(output["scores"]).argmax(-1)
        ctx_tokens = host.get("context_tokens") or [[]] * len(answers)
        space = self.answer_processor.get_true_vocab_size()
        preds = []
        for i, qid in enumerate(np.asarray(tensors["question_id"]).tolist()):
            aid = int(answers[i])
            if aid >= space:
                answer = word_tokenize(ctx_tokens[i][aid - space])
            else:
                answer = self.answer_processor.idx2word(aid)
            preds.append({"question_id": int(qid), "answer": answer})
        return preds
