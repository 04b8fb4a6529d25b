"""Synthetic VQA2 / VizWiz / TextVQA data trees for the legacy image-VQA
models (numpy only).

``write_tree(root, ...)`` lays the files out where the port's
``defaults/configs/datasets/vqa/{vqa2,vizwiz,textvqa}.yml`` look for them,
so that a run needs only ``dataset_attributes.<name>.data_root_dir=root``
(and the widths a small tree changes):

  vocabs/vocabulary_100k.txt           question words
  vocabs/answers_vqa.txt               VQA2's answer space
  vocabs/answers_vizwiz_7k.txt         VizWiz's
  vocabs/answers_textvqa_8k.txt        TextVQA's fixed answers
  imdb/vqa/imdb_{train2014,val2014,test2015}.npy
  imdb/vizwiz/imdb_vizwiz_{train,val,test}.npy
  imdb/textvqa_0.5/imdb_textvqa_{train,val,test}.npy
  coco/{detectron_fix_100/fc6,resnet152}/{train_val_2014,test2015}/<image>.npy
  vizwiz/{detectron_fix_100/fc6,resnet152}/{train,val,test}/<image>.npy
  open_images/{detectron_fix_100/fc6,resnet152}/{train,test}/<image>.npy

Each image has ``boxes``-ish detectron fc6 rows (a count drawn in [boxes /
4, boxes], the rest of ``features_max_len`` padding) and ``grid`` resnet152
rows, ``feat_dim`` wide (MMF's: up to 100 / 137 boxes and 196 grid cells of
2,048).  Each question has question tokens from the question vocabulary, ten
answers drawn from the answer space (TextVQA's also from the image's OCR
tokens, so that the copy slots score) and, for TextVQA, up to
``ocr_tokens`` OCR tokens.  The imdbs are the reference's {metadata, data}
dicts.  TextVQA's val split reads the train images, as its defaults say.
The fastText model file is absent: the context processor takes the hashed
300-d vectors (data/word_vectors.py).
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

# dataset -> (imdb dir, imdb name per split, feature dir root, feature split dir, answers)
LAYOUT = {
    "vqa2": ("imdb/vqa", {"train": "imdb_train2014", "val": "imdb_val2014",
                          "test": "imdb_test2015"},
             "coco", {"train": "train_val_2014", "val": "train_val_2014", "test": "test2015"},
             "answers_vqa.txt"),
    "vizwiz": ("imdb/vizwiz", {s: f"imdb_vizwiz_{s}" for s in ("train", "val", "test")},
               "vizwiz", {"train": "train", "val": "val", "test": "test"},
               "answers_vizwiz_7k.txt"),
    "textvqa": ("imdb/textvqa_0.5", {s: f"imdb_textvqa_{s}" for s in ("train", "val", "test")},
                "open_images", {"train": "train", "val": "train", "test": "test"},
                "answers_textvqa_8k.txt"),
}
QUESTION_WORDS = ["what", "is", "the", "color", "of", "sign", "bus", "on", "says", "word",
                  "number", "brand", "written", "here", "which", "team"]


def _write_list(path: str, words: Sequence[str]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(words) + "\n")


def write_tree(root: str, questions: Dict[str, int] = None, per_image: int = 4,
               feat_dim: int = 2048, boxes: Dict[str, int] = None, grid: int = 196,
               question_vocab: int = 100_000, answers: Dict[str, int] = None,
               ocr_tokens: int = 50, text_len: int = 14) -> None:
    """Write the three datasets' trees, from a generator seeded with 0.

    ``questions``: per split (default train 384, val 128, test 64);
    ``boxes``: the detectron rows' upper bound per dataset (default its
    features_max_len: 100, 100, 137); ``answers``: the answer vocabulary
    sizes (default 3,129 VQA2's, 7,000 VizWiz's, 8,000 TextVQA's), words
    ``ans0``, ``ans1``, ... of which the questions' answers draw on the
    first 40."""
    rng = np.random.default_rng(0)
    questions = questions or {"train": 384, "val": 128, "test": 64}
    boxes = {"vqa2": 100, "vizwiz": 100, "textvqa": 137, **(boxes or {})}
    sizes = {"vqa2": 3129, "vizwiz": 7000, "textvqa": 8000, **(answers or {})}
    words = QUESTION_WORDS + [f"w{i}" for i in range(max(0, question_vocab - len(QUESTION_WORDS)))]
    _write_list(os.path.join(root, "vocabs", "vocabulary_100k.txt"), words[:question_vocab])
    for ds in LAYOUT:
        imdb_dir, imdb_names, feat_root, feat_split, answer_file = LAYOUT[ds]
        space = [f"ans{i}" for i in range(sizes[ds])]
        _write_list(os.path.join(root, "vocabs", answer_file), space)
        images: Dict[str, list] = {}
        for split, n_q in questions.items():
            fsplit = feat_split[split]
            n_img = -(-n_q // per_image)
            ids = images.setdefault(fsplit, [])
            base = 1000 * (1 + list(feat_split.values()).index(fsplit))
            while len(ids) < n_img:
                ids.append(base + len(ids))
                det = os.path.join(root, feat_root, "detectron_fix_100", "fc6", fsplit)
                res = os.path.join(root, feat_root, "resnet152", fsplit)
                for d in (det, res):
                    os.makedirs(d, exist_ok=True)
                n_box = int(rng.integers(max(1, boxes[ds] // 4), boxes[ds] + 1))
                np.save(os.path.join(det, f"{ids[-1]}.npy"),
                        rng.standard_normal((n_box, feat_dim), dtype=np.float32))
                np.save(os.path.join(res, f"{ids[-1]}.npy"),
                        rng.standard_normal((grid, feat_dim), dtype=np.float32))
            data = []
            for q in range(n_q):
                image_id = ids[q // per_image]
                n_tok = int(rng.integers(4, text_len + 1))
                tokens = [words[int(i)] for i in rng.integers(0, len(words), n_tok)]
                ocr = [f"tok{int(i)}" for i in rng.integers(0, 4 * ocr_tokens,
                                                            int(rng.integers(1, ocr_tokens + 1)))]
                pool = space[: min(len(space), 40)] + (ocr if ds == "textvqa" else [])
                picks = rng.choice(len(pool), size=3)
                entry = {
                    "question_id": len(data) + 100_000 * list(questions).index(split),
                    "image_id": image_id, "feature_path": f"{image_id}.npy",
                    "question": " ".join(tokens) + "?", "question_tokens": tokens,
                    "answers": [pool[int(picks[i])] for i in rng.choice(3, size=10,
                                                                        p=[0.6, 0.3, 0.1])],
                    "image_name": f"VizWiz_{split}_{image_id:08d}",
                }
                if ds == "textvqa":
                    entry["ocr_tokens"] = ocr
                data.append(entry)
            os.makedirs(os.path.join(root, imdb_dir), exist_ok=True)
            np.save(os.path.join(root, imdb_dir, imdb_names[split] + ".npy"),
                    {"metadata": {"version": 1}, "data": data})
