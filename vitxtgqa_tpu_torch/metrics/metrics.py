"""Registry-keyed metrics (reference: pythia/modules/metrics.py:53-545).

The port's copy of vitxtgqa_tpu/metrics/metrics.py with the six metrics of
configs/t2s_abinet.yml (textvqa_accuracy, stvqa_anls, IOU@0.3 / 0.5,
GQA@0.3 / 0.5); ``reference_compat`` is an argument of ``Metrics`` (the JAX
package's process-wide switch).  The legacy classifier metric
(vqa_accuracy) and the temporal analysis metric come with their models.

Design changes vs the reference:
  * GT grounding annotations are loaded once into a question_id-keyed index
    via the config's `ground_infos` paths — the reference reloads the full
    npy from hard-coded absolute paths on every batch
    (metrics.py:251-254, 303-307);
  * answer decoding is a shared helper over host-side token lists (no
    pickled-tensor decode);
  * each metric is a pure callable over (batch_tensors_np, model_output_np,
    batch_host, ctx).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.data.text import word_tokenize
from vitxtgqa_tpu_torch.metrics.evaluators import (
    BoxGroundAccuracyEvaluator,
    STVQAANLSEvaluator,
    TextVQAAccuracyEvaluator,
)


class GroundTruthIndex:
    """question_id -> grounding annotation dict, preloaded per split."""

    def __init__(self, path: str):
        rows = np.load(path, allow_pickle=True)[1:]  # row 0 is metadata
        self.by_qid = {int(r["question_id"]): r for r in rows}
        self.misses = 0  # unannotated-qid lookups (diagnostic)

    def get(self, qid: int, default=None):
        hit = self.by_qid.get(int(qid), default)
        if hit is default:
            self.misses += 1
            if self.misses in (1, 100, 10000):
                import warnings

                warnings.warn(
                    f"question_id {qid} missing from the grounding "
                    f"annotation index ({self.misses} misses so far) — "
                    "check the ground_infos path; unannotated samples score "
                    "as grounding misses and stay in the denominator"
                )
        return hit


class MetricContext:
    """Shared eval-time state: answer processor + GT grounding index."""

    def __init__(self, answer_processor, ground_index: Optional[GroundTruthIndex] = None):
        self.answer_processor = answer_processor
        self.ground_index = ground_index

    @classmethod
    def from_config(cls, dataset_config, dataset_type: str, answer_processor):
        gi = None
        ground_infos = getattr(dataset_config, "ground_infos", None)
        if ground_infos is not None and dataset_type in ground_infos:
            path = ground_infos[dataset_type][0]
            if not os.path.isabs(path):
                path = os.path.join(dataset_config.data_root_dir, path)
            if os.path.exists(path):
                gi = GroundTruthIndex(path)
        return cls(answer_processor, gi)


def decode_answers(
    pred_inds: np.ndarray,  # [B, S] argmax over the joint answer space
    context_tokens: List[List[str]],
    answer_processor,
) -> List[str]:
    """Pointer-aware greedy decode to answer strings
    (reference: metrics.py:195-211)."""
    vocab_size = answer_processor.get_true_vocab_size()
    eos = answer_processor.EOS_IDX
    out = []
    for row, tokens in zip(pred_inds, context_tokens):
        words = []
        for idx in row.tolist():
            if idx >= vocab_size:
                words.append(word_tokenize(tokens[idx - vocab_size]))
            else:
                if idx == eos:
                    break
                words.append(answer_processor.answer_vocab.idx2word(idx))
        out.append(" ".join(words).replace(" 's", "'s"))
    return out


def pred_indices(output) -> np.ndarray:
    """The greedy answer indices [B, S]: ``pred_inds`` where the output
    carries them (the ranks of a data axis gather those, not the scores),
    else the argmax of ``pos_scores``."""
    if "pred_inds" in output:
        return np.asarray(output["pred_inds"])
    return np.asarray(output["pos_scores"]).argmax(-1)


def _qa_predictions(tensors, output, host, ctx):
    pred_inds = pred_indices(output)
    preds = decode_answers(pred_inds, host["context_tokens"], ctx.answer_processor)
    # score against the tiled-to-10 answer list, like the reference's
    # gt_answers_enc (vtextgqa/dataset.py:290-298, metrics.py:212)
    gts = host.get("answers_tiled") or host["gt_answers"]
    return [
        {"pred_answer": p, "gt_answers": g} for p, g in zip(preds, gts)
    ]


def _box_predictions(tensors, output, host, ctx):
    frames = np.asarray(output["ground_frame"]).tolist()
    boxes = np.asarray(output["ground_box"]).tolist()
    f_topk = int(np.asarray(output["frame_topk"]))
    o_topk = int(np.asarray(output["ocr_topk"]))
    preds = []
    for i, qid in enumerate(np.asarray(tensors["question_id"]).tolist()):
        # unannotated questions score as misses and remain in the
        # denominator (documented deviation: the reference indexes blindly
        # and crashes on a missing qid, metrics.py:264-265; scores over
        # partially annotated splits are therefore lower bounds)
        gt = ctx.ground_index.get(qid)
        preds.append(
            {
                "pred_frame": frames[i],
                "pred_box": boxes[i],
                "frame_topk": f_topk,
                "ocr_topk": o_topk,
                "st_gt": gt["spatial_temporal_gt"] if gt is not None else [],
                "video_fps": gt["fps"] if gt is not None else 10,
                "width": gt["width"] if gt is not None else 1,
                "height": gt["height"] if gt is not None else 1,
            }
        )
    return preds


@registry.register_metric("textvqa_accuracy")
class TextVQAAccuracy:
    name = "textvqa_accuracy"

    def __init__(self):
        self.evaluator = TextVQAAccuracyEvaluator()

    def __call__(self, tensors, output, host, ctx) -> float:
        _, acc = self.evaluator.eval_pred_list(
            _qa_predictions(tensors, output, host, ctx)
        )
        return float(acc)


@registry.register_metric("stvqa_anls")
class STVQAANLS:
    name = "stvqa_anls"

    def __init__(self):
        self.evaluator = STVQAANLSEvaluator()

    def __call__(self, tensors, output, host, ctx) -> float:
        _, acc = self.evaluator.eval_pred_list(
            _qa_predictions(tensors, output, host, ctx)
        )
        return float(acc)


class _IOUBase:
    threshold: float = 0.5

    def __init__(self, reference_compat: bool = False):
        self.evaluator = BoxGroundAccuracyEvaluator(reference_compat)

    def __call__(self, tensors, output, host, ctx) -> float:
        _, acc = self.evaluator.eval_pred_list(
            _box_predictions(tensors, output, host, ctx), threshold=self.threshold
        )
        return float(acc)


@registry.register_metric("IOU@0.3")
class IOU03(_IOUBase):
    name = "IOU@0.3"
    threshold = 0.3


@registry.register_metric("IOU@0.5")
class IOU05(_IOUBase):
    name = "IOU@0.5"
    threshold = 0.5


class _GQABase:
    """AND of per-sample QA-correct (soft score == 1) and box-grounding hit
    (reference: metrics.py:341-545)."""

    threshold: float = 0.5

    def __init__(self, reference_compat: bool = False):
        self.box_evaluator = BoxGroundAccuracyEvaluator(reference_compat)
        self.qa_evaluator = TextVQAAccuracyEvaluator()

    def __call__(self, tensors, output, host, ctx) -> float:
        box_scores, _ = self.box_evaluator.eval_pred_list(
            _box_predictions(tensors, output, host, ctx), threshold=self.threshold
        )
        qa_scores, _ = self.qa_evaluator.eval_pred_list(
            _qa_predictions(tensors, output, host, ctx)
        )
        # under reference_compat the box list carries the reference's
        # duplicate-appends and is indexed by batch position exactly like
        # metrics.py:432-441 (box_pred_scores[i]); zip() gives identical
        # pairing since len(box_scores) >= len(qa_scores)
        hits = [1 if b == 1 and q == 1 else 0 for b, q in zip(box_scores, qa_scores)]
        return float(sum(hits) / len(hits)) if hits else 0.0


@registry.register_metric("GQA@0.3")
class GQA03(_GQABase):
    name = "GQA@0.3"
    threshold = 0.3


@registry.register_metric("GQA@0.5")
class GQA05(_GQABase):
    name = "GQA@0.5"
    threshold = 0.5


class Metrics:
    """Config-driven metric collection (reference: metrics.py:53-131).

    On train batches only QA metrics run (reference keeps
    textvqa_accuracy/stvqa_anls, metrics.py:110-111) — grounding metrics need
    the GT index which only exists for val/test.  ``reference_compat``
    (training_parameters.reference_compat) gives the grounding metrics the
    reference's exact semantics (evaluators.BoxGroundAccuracyEvaluator).
    """

    TRAIN_ALLOWED = ("textvqa_accuracy", "stvqa_anls", "vqa_accuracy")

    def __init__(self, metric_configs, dataset_name: str = "vtextgqa",
                 reference_compat: bool = False):
        self.entries = []
        for mc in metric_configs:
            name = mc["type"] if isinstance(mc, dict) else mc.type
            cls = registry.get_metric_class(name)
            box = issubclass(cls, (_IOUBase, _GQABase))
            self.entries.append((name, cls(reference_compat) if box else cls()))
        self.dataset_name = dataset_name

    def __call__(self, tensors, output, host, ctx, train: bool = False) -> Dict[str, float]:
        out = {}
        for name, fn in self.entries:
            if train and name not in self.TRAIN_ALLOWED:
                continue
            if not train and ctx.ground_index is None and name.startswith(("IOU", "GQA")):
                continue
            out[f"{self.dataset_name}/{name}"] = fn(tensors, output, host, ctx)
        return out
