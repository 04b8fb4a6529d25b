"""Host-side evaluators: answer normalisation, VQA soft accuracy, ANLS,
temporal and box grounding (reference: pythia/utils/m4c_evaluators.py:5-406).

The normalisation tables (contractions, number words, punctuation) are the
published EvalAI VQA-eval constants — part of the metric definition, kept
verbatim.  Everything is a pure function over python lists so it runs off
the device path.  The port's copy of vitxtgqa_tpu/metrics/evaluators.py,
with ``reference_compat`` a field of the box evaluator instead of a
process-wide switch.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll", "whyre": "why're",
    "whys": "why's", "wont": "won't", "wouldve": "would've",
    "wouldnt": "wouldn't", "wouldnt've": "wouldn't've",
    "wouldn'tve": "wouldn't've", "yall": "y'all", "yall'll": "y'all'll",
    "y'allll": "y'all'll", "yall'd've": "y'all'd've",
    "y'alld've": "y'all'd've", "y'all'dve": "y'all'd've", "youd": "you'd",
    "youd've": "you'd've", "you'dve": "you'd've", "youll": "you'll",
    "youre": "you're", "youve": "you've",
}

NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
ARTICLES = ["a", "an", "the"]
PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")
PUNCTUATIONS = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]


class EvalAIAnswerProcessor:
    """EvalAI answer normalisation (reference: m4c_evaluators.py:5-216)."""

    def word_tokenize(self, word: str) -> str:
        word = word.lower()
        word = word.replace(",", "").replace("?", "").replace("'s", " 's")
        return word.strip()

    def process_punctuation(self, text: str) -> str:
        out = text
        for p in PUNCTUATIONS:
            if (p + " " in text or " " + p in text) or (
                re.search(COMMA_STRIP, text) is not None
            ):
                out = out.replace(p, "")
            else:
                out = out.replace(p, " ")
        return PERIOD_STRIP.sub("", out, re.UNICODE)

    def process_digit_article(self, text: str) -> str:
        out: List[str] = []
        for word in text.lower().split():
            word = NUMBER_MAP.setdefault(word, word)
            if word not in ARTICLES:
                out.append(word)
        for i, word in enumerate(out):
            if word in CONTRACTIONS:
                out[i] = CONTRACTIONS[word]
        return " ".join(out)

    def __call__(self, item: str) -> str:
        item = self.word_tokenize(item)
        item = item.replace("\n", " ").replace("\t", " ").strip()
        item = self.process_punctuation(item)
        item = self.process_digit_article(item)
        return item


def vqa_soft_scores(raw_answers: Sequence[str], processor=None) -> Dict[str, float]:
    """Leave-one-out soft score per unique normalised answer
    (reference: m4c_evaluators.py:223-246)."""
    processor = processor or EvalAIAnswerProcessor()
    answers = [processor(a) for a in raw_answers]
    assert len(answers) == 10
    gt = list(enumerate(answers))
    out: Dict[str, float] = {}
    for unique in set(answers):
        accs = []
        for g in gt:
            others = [o for o in gt if o != g]
            matching = [o for o in others if o[1] == unique]
            accs.append(min(1.0, len(matching) / 3.0))
        out[unique] = sum(accs) / len(accs)
    return out


class TextVQAAccuracyEvaluator:
    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def eval_pred_list(self, pred_list: List[dict]):
        scores = []
        for entry in pred_list:
            pred = self.answer_processor(entry["pred_answer"])
            table = vqa_soft_scores(entry["gt_answers"], self.answer_processor)
            scores.append(table.get(pred, 0.0))
        return scores, (sum(scores) / len(scores) if scores else 0.0)


def levenshtein(s1: str, s2: str) -> int:
    """Edit distance, O(len1*len2) DP (replaces the editdistance package)."""
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    if not s2:
        return len(s1)
    prev = list(range(len(s2) + 1))
    for i, c1 in enumerate(s1):
        cur = [i + 1]
        for j, c2 in enumerate(s2):
            cur.append(min(prev[j + 1] + 1, cur[j] + 1, prev[j] + (c1 != c2)))
        prev = cur
    return prev[-1]


class STVQAANLSEvaluator:
    """ANLS = 1 - normalised edit distance, zeroed below 0.5
    (reference: m4c_evaluators.py:277-298)."""

    def get_anls(self, s1: str, s2: str) -> float:
        s1, s2 = s1.lower().strip(), s2.lower().strip()
        if max(len(s1), len(s2)) == 0:
            return 0.0
        iou = 1 - levenshtein(s1, s2) / max(len(s1), len(s2))
        return iou if iou >= 0.5 else 0.0

    def eval_pred_list(self, pred_list: List[dict]):
        scores = [
            max(self.get_anls(e["pred_answer"], gt) for gt in e["gt_answers"])
            for e in pred_list
        ]
        return scores, (sum(scores) / len(scores) if scores else 0.0)


class TempGroundAccuracyEvaluator:
    """Any predicted frame inside a GT temporal span
    (reference: m4c_evaluators.py:301-326)."""

    def eval_pred_list(self, pred_list: List[dict]):
        scores = []
        for entry in pred_list:
            hit = 0
            for span in entry["st_gt"]:
                t0, t1 = span["temporal_gt"]
                st = int(t0 * entry["video_fps"]) + 1
                ed = int(t1 * entry["video_fps"]) + 1
                if any(st <= f <= ed for f in entry["pred_frame"]):
                    hit = 1
                    break
            scores.append(hit)
        return scores, (sum(scores) / len(scores) if scores else 0.0)


def box_iou(box1, box2) -> float:
    """Pixel IoU with the reference's +1 convention
    (reference: m4c_evaluators.py:333-355)."""
    ax1, ay1, ax2, ay2 = box1
    bx1, by1, bx2, by2 = box2
    ix1, iy1 = max(ax1, bx1), max(ay1, by1)
    ix2, iy2 = min(ax2, bx2), min(ay2, by2)
    inter = max(0, ix2 - ix1 + 1) * max(0, iy2 - iy1 + 1)
    a1 = (ax2 - ax1 + 1) * (ay2 - ay1 + 1)
    a2 = (bx2 - bx1 + 1) * (by2 - by1 + 1)
    return inter / (a1 + a2 - inter)


class BoxGroundAccuracyEvaluator:
    """Spatio-temporal box-grounding hit rate
    (reference: m4c_evaluators.py:329-406).  For each GT span, each predicted
    frame inside it is paired with its ocr_topk predicted boxes (denormalised
    by W/H); a sample scores 1 if any such box clears the IoU threshold
    against that frame's GT box.

    Deviation (deliberate): the reference appends one score per matching
    (span, frame) pair, so a sample with several hits contributes several
    1-entries to the average and misaligns the per-sample list consumed by
    the GQA metric (m4c_evaluators.py:357-374 check_iou appends inside the
    loop; metrics.py:432-441 then indexes by batch position).  Here every
    sample contributes exactly one score, which is what GQA's AND requires.
    ``reference_compat=True`` (config: training_parameters.reference_compat)
    restores the reference's exact semantics (per-pair appends + a trailing
    0 keyed on the LAST pair's flag) for checkpoint-parity diffs.
    """

    def __init__(self, reference_compat: bool = False):
        self.reference_compat = bool(reference_compat)

    def eval_pred_list(self, pred_list: List[dict], threshold: float):
        if self.reference_compat:
            return self._eval_pred_list_reference(pred_list, threshold)
        scores: List[int] = []
        for entry in pred_list:
            w, h = entry["width"], entry["height"]
            boxes = [
                [b[0] * w, b[1] * h, b[2] * w, b[3] * h]
                for b in entry["pred_box"]
            ]
            topk = entry["ocr_topk"]
            hit = False
            for span in entry["st_gt"]:
                t0, t1 = span["temporal_gt"]
                st = int(t0 * entry["video_fps"]) + 1
                ed = int(t1 * entry["video_fps"]) + 1
                for i, frame in enumerate(entry["pred_frame"]):
                    if not (st <= int(frame) <= ed):
                        continue
                    gt_boxes = span["bbox_gt"]
                    key = str(int(frame - 1))
                    if key not in gt_boxes:
                        continue
                    gt = gt_boxes[key]
                    for pb in boxes[i * topk : (i + 1) * topk]:
                        if box_iou(gt, pb) > threshold:
                            hit = True
            scores.append(1 if hit else 0)
        return scores, (sum(scores) / len(scores) if scores else 0.0)

    def _eval_pred_list_reference(self, pred_list: List[dict], threshold: float):
        """Bit-exact reference semantics (m4c_evaluators.py:357-406):
        check_iou appends a 1 per (span, frame) pair whose best box clears
        the threshold; a 0 is appended per sample only when the *last*
        evaluated pair missed (or none were evaluated), so a sample can
        contribute several entries and the list misaligns vs batch order."""
        scores: List[int] = []
        for entry in pred_list:
            w, h = entry["width"], entry["height"]
            boxes = [
                [b[0] * w, b[1] * h, b[2] * w, b[3] * h]
                for b in entry["pred_box"]
            ]
            topk = entry["ocr_topk"]
            flag = False
            for span in entry["st_gt"]:
                t0, t1 = span["temporal_gt"]
                st = int(t0 * entry["video_fps"]) + 1
                ed = int(t1 * entry["video_fps"]) + 1
                for i, frame in enumerate(entry["pred_frame"]):
                    if not (st <= int(frame) <= ed):
                        continue
                    gt_boxes = span["bbox_gt"]
                    key = str(int(frame - 1))
                    if key not in gt_boxes:
                        continue
                    gt = gt_boxes[key]
                    max_iou = 0.0
                    for pb in boxes[i * topk : (i + 1) * topk]:
                        iou = box_iou(gt, pb)
                        if iou > max_iou:
                            max_iou = iou
                    flag = max_iou > threshold
                    if flag:
                        scores.append(1)
            if not flag:
                scores.append(0)
        return scores, (sum(scores) / len(scores) if scores else 0.0)
