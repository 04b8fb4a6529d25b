"""GT-box oracle dataset: detected grid + ground-truth annotation grid.

The port's copy of vitxtgqa_tpu/data/gt_box_dataset.py
(reference: pythia/datasets/videoqa/gt_box_clipocr/dataset.py:19-380).
Extends the standard assembly with GT fields consumed by the gt_box model:
frame_list (annotated frame ids), ocr_bbox_list (normalised GT boxes),
frame/ocr decoder masks, GT temporal/track ids, and context features
computed over the *annotated* OCR tokens.  GT annotations come from the
config's `ground_infos` paths (the reference hard-codes absolute paths,
gt_box_clipocr/dataset.py:61-66).  A split without them (the configs'
train split) raises ValueError, which the trainer takes as a split it
cannot load.  ``reference_compat`` is an argument here (the JAX package
reads a process-wide switch; the port's trainer passes
training_parameters.reference_compat to GTBoxBuilder.load).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from vitxtgqa_tpu_torch.data.dataset import VTextGQADataset


class GTBoxDataset(VTextGQADataset):
    def __init__(self, dataset_type: str, config: Any, reference_compat: bool = False,
                 **kwargs):
        super().__init__(dataset_type, config, **kwargs)
        self.reference_compat = bool(reference_compat)
        self._name = "gt_box"
        ground_infos = getattr(config, "ground_infos", None)
        if ground_infos is None or dataset_type not in ground_infos:
            raise ValueError(f"gt_box requires ground_infos for {dataset_type}")
        path = ground_infos[dataset_type][0]
        if not os.path.isabs(path):
            path = os.path.join(self.data_root, path)
        rows = np.load(path, allow_pickle=True)[1:]
        self.ground_by_qid = {int(r["question_id"]): r for r in rows}
        self.init_processors()  # re-register processors under gt_box keys

    def _add_sample_details(self, info: Dict[str, Any], sample: Dict[str, Any]):
        super()._add_sample_details(info, sample)

        F, K = self.num_frames, self.frame_ocr_num
        N = F * K
        width, height = info["video_width"], info["video_height"]
        gt = self.ground_by_qid.get(int(info["question_id"]))

        # annotated frame ids across GT spans (reference: dataset.py:130-143)
        ground_fid_list = []
        if gt is not None:
            fps = int(gt["fps"])
            for span in gt["spatial_temporal_gt"]:
                t0, t1 = span["temporal_gt"]
                st, ed = int(t0 * fps) + 1, int(t1 * fps) + 1
                ground_fid_list.extend(range(st, ed + 1))
        if not ground_fid_list:
            ground_fid_list.append(0)
        ground_fid_list = ground_fid_list[:F]

        # merge spans into frame->(box, ocr) maps, skipping overlapping spans
        # (reference: dataset.py:149-164)
        human_frames, box_dict, ocr_dict = [], {}, {}
        if gt is not None:
            for span in gt["spatial_temporal_gt"]:
                st = int(span["temporal_gt"][0] * 10)
                ed = int(span["temporal_gt"][1] * 10)
                if set(human_frames) & set(str(x) for x in range(st, ed + 1)):
                    continue
                keys = list(span["bbox_gt"].keys())
                human_frames.extend(keys)
                box_dict.update(span["bbox_gt"])
                ocrs = span.get("ocr", ["<unk>"] * len(keys))
                for i, fid in enumerate(keys):
                    ocr_dict[fid] = ocrs[i] if i < len(ocrs) else "<unk>"

        # annotated OCR grid: at most one GT OCR per annotated frame,
        # padded to K slots (reference: dataset.py:166-199)
        frame_count = len(sample["frame_id"][sample["frame_id"] > 0])
        idxs = [int(x) for x in sample["frame_id"][:frame_count]]
        anno_tokens, anno_boxes = [], []
        anno_track = np.zeros(N, np.int64)
        anno_temporal = np.zeros(N, np.int64)
        anno_mask = np.zeros(N, np.float32)
        slot = 0
        for frame_idx in idxs:
            key = str(frame_idx - 1)
            if key in ocr_dict and slot + K <= N:
                box = box_dict[key]
                anno_tokens.append(
                    self.ocr_token_processor({"text": str(ocr_dict[key])})["text"]
                )
                anno_boxes.append([box[0], box[1], box[2], box[3]])
                anno_track[slot] = frame_idx
                anno_temporal[slot] = frame_idx
                anno_mask[slot] = 1.0
                anno_tokens.extend(["<pad>"] * (K - 1))
                anno_boxes.extend([[0, 0, 0, 0]] * (K - 1))
                anno_track[slot + 1 : slot + K] = frame_idx
                anno_temporal[slot + 1 : slot + K] = frame_idx
            else:
                anno_tokens.extend(["<pad>"] * K)
                anno_boxes.extend([[0, 0, 0, 0]] * K)
            slot += K
        anno_tokens = (anno_tokens + ["<pad>"] * N)[:N]
        anno_boxes = (anno_boxes + [[0, 0, 0, 0]] * N)[:N]

        box_arr = np.asarray(anno_boxes, np.float32) * np.array(
            [1.0 / width, 1.0 / height, 1.0 / width, 1.0 / height], np.float32
        )
        sample["ocr_bbox_list"] = self.copy_processor({"blob": box_arr})["blob"]

        frame_list = np.zeros(F, np.int64)
        frame_list[: len(ground_fid_list)] = ground_fid_list
        sample["frame_list"] = frame_list
        fmask = np.zeros(F, np.float32)
        for i in range(F):
            if i + 1 in ground_fid_list:
                fmask[i] = 1.0
        sample["frame_mask_embedding"] = fmask
        sample["ocr_mask_embedding"] = anno_mask
        sample["ocr_track_id"] = anno_track
        sample["ocr_temporal_id"] = anno_temporal

        # eval-aligned ground boxes: the IoU evaluator pairs frame_list[id]
        # with box slots [id*K, (id+1)*K) (m4c_evaluators.py:393-398), but
        # the model-input grid above is laid out per *sampled* frame — the
        # reference feeds the same tensor to both and its oracle IoU
        # misaligns whenever the first annotated frame isn't frame 1.  Here
        # the eval field places each annotated frame's GT box at its
        # frame_list position (deliberate fix, documented).
        # (reference_compat reverts to the reference's behaviour: the same
        # per-sampled-frame tensor feeds both model and evaluator)
        if self.reference_compat:
            sample["eval_box_list"] = np.asarray(
                sample["ocr_bbox_list"], np.float32
            )
        else:
            eval_boxes = np.zeros((N, 4), np.float32)
            for i, fid in enumerate(ground_fid_list):
                if fid <= 0 or i >= F:
                    continue
                key = str(fid - 1)
                if key in box_dict:
                    eval_boxes[i * K] = box_dict[key]
            eval_boxes *= np.array(
                [1.0 / width, 1.0 / height, 1.0 / width, 1.0 / height],
                np.float32,
            )
            sample["eval_box_list"] = eval_boxes

        # context features over the annotated tokens replace the detected
        # ones (reference: dataset.py:248-265) — the answer copy space is the
        # GT OCR vocabulary
        context = self.context_processor({"tokens": anno_tokens})
        sample["context_feature_0"] = context["text"]
        sample["context_tokens"] = context["tokens"]
        phoc = self.phoc_processor({"tokens": anno_tokens})
        sample["context_feature_1"] = phoc["text"]
