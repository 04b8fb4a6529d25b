"""Per-sample processors (config-selected, registry-keyed).

The port's copy of vitxtgqa_tpu/data/processors.py, every processor of
its registry: those of the vtextgqa dataset and the T2S configs
(bert_tokenizer, m4c_answer, simple_word, fasttext, phoc, copy, bbox and
their vocab base), and those of the legacy image-VQA datasets
(simple_sentence, the text preprocessor of the vqa2 / vizwiz / textvqa
defaults; glove; the answer processors vqa_answer,
multi_hot_answer_from_vocab and soft_copy_answer).

Same registry keys and call contracts as the reference processor suite
(reference: pythia/datasets/processors.py:167-1156) so dataset configs work
unchanged, but all outputs are numpy arrays with static shapes (they feed
a fixed-shape batch that the trainer moves to the device), and the hot
paths (PHOC over the 960-slot OCR grid, word vectors) are batched instead
of per-token Python loops.
"""

from __future__ import annotations

import os
from collections import Counter, defaultdict
from typing import Any, Dict, List, Optional

import numpy as np

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.data.text import VocabDict, tokenize, word_tokenize
from vitxtgqa_tpu_torch.data.word_vectors import load_word_vectors
from vitxtgqa_tpu_torch.data.wordpiece import WordPieceTokenizer
from vitxtgqa_tpu_torch.ops.phoc import PHOC_DIM, build_phoc_batch


class BaseProcessor:
    def __init__(self, config: Any = None, *args, **kwargs):
        self.config = config

    def __call__(self, item: Dict[str, Any], *args, **kwargs) -> Dict[str, Any]:
        raise NotImplementedError


class Processor:
    """Config dispatcher: {"type": name, "params": {...}} -> instance.

    (reference: pythia/datasets/processors.py:123-165)
    """

    def __init__(self, config: Any, *args, **kwargs):
        if not hasattr(config, "type"):
            raise AttributeError("Processor config must have 'type'")
        cls = registry.get_processor_class(config.type)
        params = getattr(config, "params", None) or {}
        self.processor = cls(params, *args, **kwargs)
        self.processor_type = config.type

    def __call__(self, item, *args, **kwargs):
        return self.processor(item, *args, **kwargs)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.processor, name)


def _cfg_get(config: Any, key: str, default: Any = None) -> Any:
    if config is None:
        return default
    if hasattr(config, key):
        value = getattr(config, key)
        return default if value is None else value
    if isinstance(config, dict):
        return config.get(key, default)
    return default


@registry.register_processor("simple_word")
class SimpleWordProcessor(BaseProcessor):
    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, item, *args, **kwargs):
        return {"text": word_tokenize(item["text"], *args, **kwargs)}


@registry.register_processor("simple_sentence")
class SimpleSentenceProcessor(BaseProcessor):
    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, item, *args, **kwargs):
        return {"text": tokenize(item["text"], *args, **kwargs)}


@registry.register_processor("vocab")
class VocabProcessor(BaseProcessor):
    """Tokens -> padded index array (reference: processors.py:167-314)."""

    MAX_LENGTH_DEFAULT = 50
    PAD_TOKEN = "<pad>"
    PAD_INDEX = 0

    def __init__(self, config, *args, data_root_dir: Optional[str] = None, **kwargs):
        self.config = config
        self.max_length = int(_cfg_get(config, "max_length", self.MAX_LENGTH_DEFAULT))
        self.preprocessor = None
        pre = _cfg_get(config, "preprocessor")
        if pre is not None:
            self.preprocessor = Processor(pre)
        vocab_cfg = _cfg_get(config, "vocab")
        self.vocab = None
        if vocab_cfg is not None and _cfg_get(vocab_cfg, "vocab_file"):
            self.vocab = VocabDict(
                _cfg_get(vocab_cfg, "vocab_file"), data_root_dir=data_root_dir
            )

    def _tokens_of(self, item) -> List[str]:
        if "tokens" in item:
            return item["tokens"]
        if "text" in item:
            if self.preprocessor is None:
                raise AssertionError("text input requires a preprocessor")
            return self.preprocessor({"text": item["text"]})["text"]
        raise AssertionError("need 'text' or 'tokens'")

    def _map_strings_to_indices(self, tokens: List[str]) -> np.ndarray:
        out = np.full(self.max_length, self.PAD_INDEX, dtype=np.int64)
        for i, tok in enumerate(tokens[: self.max_length]):
            out[i] = self.vocab.word2idx(tok)
        return out

    def _pad_tokens(self, tokens: List[str]):
        padded = [self.PAD_TOKEN] * self.max_length
        n = min(len(tokens), self.max_length)
        padded[:n] = tokens[:n]
        return padded, np.int64(n)

    def __call__(self, item):
        tokens = self._tokens_of(item)
        indices = self._map_strings_to_indices(tokens)
        padded, length = self._pad_tokens(tokens)
        return {"text": indices, "tokens": padded, "length": length}

    def get_vocab_size(self):
        return self.vocab.num_vocab if self.vocab else 0


@registry.register_processor("fasttext")
class FastTextProcessor(VocabProcessor):
    """OCR token -> word vector [max_length, dim] (reference: processors.py:360-495).

    Vector backend resolved by data.word_vectors (real fastText bin, .npz
    cache, or hashed fallback); per-token vector is the mean over space-split
    words, matching WordToVectorDict (reference: vocab.py:375-381).
    """

    def __init__(self, config, *args, data_root_dir: Optional[str] = None, **kwargs):
        super().__init__(config, *args, data_root_dir=data_root_dir, **kwargs)
        import os

        model_file = _cfg_get(config, "model_file")
        if model_file and data_root_dir and not os.path.isabs(model_file):
            candidate = os.path.join(data_root_dir, model_file)
            model_file = candidate if os.path.exists(candidate) else model_file
        self.stov = load_word_vectors(model_file)
        self.dim = self.stov.dim

    def _map_strings_to_indices(self, tokens: List[str]) -> np.ndarray:
        tokens = tokens[: self.max_length]
        out = np.empty((self.max_length, self.dim), dtype=np.float32)
        out[: len(tokens)] = self.stov.get_many(tokens)
        out[len(tokens):] = 0.0
        return out


@registry.register_processor("phoc")
class PhocProcessor(VocabProcessor):
    """OCR token -> PHOC [max_length, 604] (ops/phoc.build_phoc_batch)."""

    def __init__(self, config, *args, **kwargs):
        self.config = config
        self.max_length = int(_cfg_get(config, "max_length", 50))
        self.preprocessor = None
        pre = _cfg_get(config, "preprocessor")
        if pre is not None:
            self.preprocessor = Processor(pre)

    def _map_strings_to_indices(self, tokens: List[str]) -> np.ndarray:
        # np.empty + explicit zero tail: a np.zeros would memset the full
        # 960x604 buffer (2.3 MB) only to overwrite it with the PHOC rows
        out = np.empty((self.max_length, PHOC_DIM), dtype=np.float32)
        tokens = list(tokens[: self.max_length])
        if tokens:
            out[: len(tokens)] = build_phoc_batch(tokens)
        out[len(tokens):] = 0.0
        return out


@registry.register_processor("copy")
class CopyProcessor(BaseProcessor):
    """Zero-pad a numpy blob to fixed length (reference: processors.py:931-944)."""

    def __init__(self, config, *args, **kwargs):
        self.max_length = int(_cfg_get(config, "max_length"))

    def __call__(self, item):
        blob = np.asarray(item["blob"])
        out = np.zeros((self.max_length,) + blob.shape[1:], blob.dtype)
        out[: len(blob)] = blob[: self.max_length]
        return {"blob": out}


@registry.register_processor("bbox")
class BBoxProcessor(BaseProcessor):
    """Bbox info dicts -> padded xyxy tensor (reference: processors.py:820-869,
    dataset_utils.py:7-37)."""

    def __init__(self, config, *args, **kwargs):
        self.max_length = int(_cfg_get(config, "max_length", 50))

    def __call__(self, item):
        infos = item["info"][: self.max_length]
        coords = np.zeros((self.max_length, 4), dtype=np.float32)
        widths = np.zeros(self.max_length, dtype=np.float32)
        heights = np.zeros(self.max_length, dtype=np.float32)
        for i, info in enumerate(infos):
            bb = info["bounding_box"]
            x, y = bb["top_left_x"], bb["top_left_y"]
            w, h = bb["width"], bb["height"]
            coords[i] = (x, y, x + w, y + h)
            widths[i], heights[i] = w, h
        return {
            "bbox": {
                "coordinates": coords,
                "width": widths,
                "height": heights,
                "bbox_types": ["xyxy"] * self.max_length,
            }
        }


@registry.register_processor("bert_tokenizer")
class BertTokenizerProcessor(BaseProcessor):
    """Question -> BERT wordpiece ids [max_length] (reference: processors.py:947-984)."""

    def __init__(self, config, *args, data_root_dir: Optional[str] = None, **kwargs):
        import os

        self.max_length = int(_cfg_get(config, "max_length", 20))
        vocab_file = _cfg_get(config, "vocab_file")
        if vocab_file and data_root_dir and not os.path.isabs(vocab_file):
            candidate = os.path.join(data_root_dir, vocab_file)
            vocab_file = candidate if os.path.exists(candidate) else vocab_file
        if vocab_file and not os.path.exists(vocab_file):
            vocab_file = None
        self.tokenizer = WordPieceTokenizer(vocab_file)
        assert self.tokenizer.pad_id == 0  # PAD must be 0 (reference assert :955)

    def get_vocab_size(self):
        return self.tokenizer.vocab_size

    def __call__(self, item):
        token_inds = np.zeros(self.max_length, dtype=np.int64)
        indices = self.tokenizer.encode(item["question"], add_special_tokens=True)
        indices = indices[: self.max_length]
        token_inds[: len(indices)] = indices
        return {
            "token_inds": token_inds,
            "token_num": np.int64(len(indices)),
        }


@registry.register_processor("m4c_answer")
class M4CAnswerProcessor(BaseProcessor):
    """Iterative-decoding answer targets (reference: processors.py:987-1156).

    Produces, per sample:
      answers_scores  [max_copy_steps, vocab+max_length] soft targets
      train_prev_inds [max_copy_steps] teacher-forcing inputs
      train_loss_mask [max_copy_steps]
    Step-0 scores are VQA soft scores of all matching first tokens; later
    steps one-hot a randomly sampled matching decoding sequence.
    """

    def __init__(self, config, *args, data_root_dir: Optional[str] = None, **kwargs):
        self.answer_vocab = VocabDict(
            _cfg_get(config, "vocab_file"), data_root_dir=data_root_dir
        )
        self.PAD_IDX = self.answer_vocab.word2idx("<pad>")
        self.BOS_IDX = self.answer_vocab.word2idx("<s>")
        self.EOS_IDX = self.answer_vocab.word2idx("</s>")
        self.UNK_IDX = self.answer_vocab.UNK_INDEX
        assert self.PAD_IDX != self.UNK_IDX
        assert self.BOS_IDX != self.UNK_IDX
        assert self.EOS_IDX != self.UNK_IDX
        assert self.PAD_IDX == 0

        self.answer_preprocessor = Processor(_cfg_get(config, "preprocessor"))
        self.num_answers = int(_cfg_get(config, "num_answers", 10))
        self.max_length = int(_cfg_get(config, "max_length", 960))
        self.max_copy_steps = int(_cfg_get(config, "max_copy_steps", 12))
        assert self.max_copy_steps >= 1
        self.rng = np.random.default_rng()

    def get_vocab_size(self) -> int:
        return self.answer_vocab.num_vocab + self.max_length

    def get_true_vocab_size(self) -> int:
        return self.answer_vocab.num_vocab

    def match_answer_to_vocab_ocr_seq(
        self, answer, vocab2idx_dict, ocr2inds_dict, max_match_num=20
    ):
        """All (vocab|OCR)-index sequences that spell `answer`, capped."""
        num_vocab = len(vocab2idx_dict)
        matches_per_word = []
        for word in answer.split():
            matched = []
            if word in vocab2idx_dict:
                matched.append(vocab2idx_dict[word])
            matched.extend(num_vocab + i for i in ocr2inds_dict[word])
            if not matched:
                return []
            matches_per_word.append(matched)
        if not matches_per_word:
            return []
        seqs = [()]
        for matched in matches_per_word:
            seqs = [s + (i,) for s in seqs for i in matched]
            if len(seqs) > max_match_num:
                seqs = seqs[:max_match_num]
        return seqs

    @staticmethod
    def compute_soft_scores(answers: List[str]) -> Dict[str, float]:
        """VQA leave-one-out soft score per unique answer
        (reference: processors.py:1072-1090)."""
        gt = list(enumerate(answers))
        out = {}
        for unique in sorted(set(answers)):
            accs = []
            for g in gt:
                others = [o for o in gt if o != g]
                matching = [o for o in others if o[1] == unique]
                accs.append(min(1.0, len(matching) / 3.0))
            out[unique] = sum(accs) / len(accs)
        return out

    def __call__(self, item):
        answers = [
            self.answer_preprocessor({"text": a})["text"] for a in item["answers"]
        ]
        assert len(answers) == self.num_answers
        unique_answer2score = self.compute_soft_scores(answers)

        scores = np.zeros(
            (self.max_copy_steps, self.get_vocab_size()), dtype=np.float32
        )

        ocr2inds_dict = defaultdict(list)
        for idx, token in enumerate(item["context_tokens"]):
            ocr2inds_dict[token].append(idx)
        answer_dec_inds = [
            self.match_answer_to_vocab_ocr_seq(
                a, self.answer_vocab.word2idx_dict, ocr2inds_dict
            )
            for a in answers
        ]

        all_idx_seq_list = []
        for answer, idx_seq_list in zip(answers, answer_dec_inds):
            all_idx_seq_list.extend(idx_seq_list)
            score = unique_answer2score[answer]
            for idx_seq in idx_seq_list:
                # step-0 score is the max over all answers sharing that first token
                first = idx_seq[0]
                scores[0, first] = max(scores[0, first], score)

        train_prev_inds = np.zeros(self.max_copy_steps, dtype=np.int64)
        train_loss_mask = np.zeros(self.max_copy_steps, dtype=np.float32)
        if all_idx_seq_list:
            idx_seq = all_idx_seq_list[self.rng.integers(len(all_idx_seq_list))]
            dec_step_num = min(1 + len(idx_seq), self.max_copy_steps)
            train_loss_mask[:dec_step_num] = 1.0
            train_prev_inds[0] = self.BOS_IDX
            for t in range(1, dec_step_num):
                train_prev_inds[t] = idx_seq[t - 1]
                score_idx = idx_seq[t] if t < len(idx_seq) else self.EOS_IDX
                scores[t, score_idx] = 1.0
        else:
            idx_seq = ()

        return {
            "answers": answers,
            "answers_scores": scores,
            "sampled_idx_seq": idx_seq,
            "train_prev_inds": train_prev_inds,
            "train_loss_mask": train_loss_mask,
        }


@registry.register_processor("glove")
class GloVeProcessor(VocabProcessor):
    """Token indices looked up in a pre-extracted embedding table
    (reference: processors.py:317-357 over torchtext GloVe caches; here the
    vectors come from the vocab-embedding family, data/vocab_embeddings.py)."""

    def __init__(self, config, *args, data_root_dir: Optional[str] = None, **kwargs):
        super().__init__(config, *args, data_root_dir=data_root_dir, **kwargs)
        from vitxtgqa_tpu_torch.data.vocab_embeddings import Vocab as EmbedVocab

        vocab_cfg = _cfg_get(config, "vocab") or {}
        vocab_file = _cfg_get(vocab_cfg, "vocab_file")
        if vocab_file and data_root_dir and not os.path.isabs(vocab_file):
            vocab_file = os.path.join(data_root_dir, vocab_file)
        self.embed_vocab = EmbedVocab(
            type="intersected", vocab_file=vocab_file,
            model_file=_cfg_get(vocab_cfg, "model_file"),
            embedding_dim=int(_cfg_get(vocab_cfg, "embedding_dim", 300)))

    def __call__(self, item):
        tokens = self._tokens_of(item)
        table = self.embed_vocab.get_vectors()
        out = np.zeros((self.max_length, self.embed_vocab.dim), np.float32)
        for i, tok in enumerate(tokens[: self.max_length]):
            out[i] = table[self.embed_vocab.stoi.get(tok, self.embed_vocab.UNK_INDEX)]
        return {"text": out}


def _soft_score(answers: List[Any], target: Any) -> float:
    """The VQA leave-one-out accuracy of ``target`` among ``answers``: the
    mean over each answer left out of min(1, matches among the others / 3)."""
    gt = list(enumerate(answers))
    accs = []
    for g in gt:
        matching = [o for o in gt if o != g and o[1] == target]
        accs.append(min(1.0, len(matching) / 3.0))
    return sum(accs) / len(accs)


@registry.register_processor("vqa_answer")
class VQAAnswerProcessor(BaseProcessor):
    """VQA soft-score answer targets over a fixed vocabulary
    (reference: processors.py:498-677)."""

    DEFAULT_NUM_ANSWERS = 10

    def __init__(self, config, *args, data_root_dir: Optional[str] = None, **kwargs):
        self.answer_vocab = VocabDict(_cfg_get(config, "vocab_file"), data_root_dir=data_root_dir)
        pre = _cfg_get(config, "preprocessor")
        self.preprocessor = Processor(pre) if pre is not None else None
        self.num_answers = int(_cfg_get(config, "num_answers", self.DEFAULT_NUM_ANSWERS))

    def get_vocab_size(self) -> int:
        return self.answer_vocab.num_vocab

    def get_true_vocab_size(self) -> int:
        return self.answer_vocab.num_vocab

    def word2idx(self, word):
        return self.answer_vocab.word2idx(word)

    def idx2word(self, idx):
        return self.answer_vocab.idx2word(idx)

    def _increase_to_ten(self, tokens):
        while len(tokens) < self.DEFAULT_NUM_ANSWERS:
            tokens = tokens + tokens[: self.DEFAULT_NUM_ANSWERS - len(tokens)]
        return tokens

    def compute_answers_scores(self, answers_indices) -> np.ndarray:
        """Leave-one-out soft score per unique index, UNK zeroed
        (reference: processors.py:634-654)."""
        scores = np.zeros(self.get_vocab_size(), np.float32)
        indices = [int(a) for a in answers_indices]
        for answer in set(indices):
            if answer != self.answer_vocab.UNK_INDEX:
                scores[answer] = _soft_score(indices, answer)
        return scores

    def _tokens(self, item) -> List[str]:
        if "answer_tokens" in item:
            tokens = list(item["answer_tokens"])
        elif "answers" in item:
            assert self.preprocessor is not None
            tokens = [self.preprocessor({"text": a})["text"] for a in item["answers"]]
        else:
            raise AssertionError("need 'answers' or 'answer_tokens'")
        return self._increase_to_ten(tokens)

    def __call__(self, item):
        tokens = self._tokens(item)
        indices = np.full(self.DEFAULT_NUM_ANSWERS, self.answer_vocab.UNK_INDEX, np.int64)
        for i, tok in enumerate(tokens[: self.DEFAULT_NUM_ANSWERS]):
            indices[i] = self.answer_vocab.word2idx(tok)
        return {"answers": tokens, "answers_indices": indices,
                "answers_scores": self.compute_answers_scores(indices)}


@registry.register_processor("multi_hot_answer_from_vocab")
class MultiHotAnswerFromVocabProcessor(VQAAnswerProcessor):
    """Multi-hot targets (reference: processors.py:680-688)."""

    def compute_answers_scores(self, answers_indices) -> np.ndarray:
        scores = np.zeros(self.get_vocab_size(), np.float32)
        scores[np.asarray(answers_indices, np.int64)] = 1.0
        scores[self.answer_vocab.UNK_INDEX] = 0.0
        return scores


@registry.register_processor("soft_copy_answer")
class SoftCopyAnswerProcessor(VQAAnswerProcessor):
    """VQA answers + the OCR soft-copy space (reference:
    processors.py:690-781, LoRRA's answer space): the scores over the
    fixed vocabulary, then ``max_length`` OCR slots, each the soft score of
    its (preprocessed) token among the answers."""

    DEFAULT_MAX_LENGTH = 200

    def __init__(self, config, *args, data_root_dir: Optional[str] = None, **kwargs):
        super().__init__(config, *args, data_root_dir=data_root_dir, **kwargs)
        self.max_length = int(_cfg_get(config, "max_length", self.DEFAULT_MAX_LENGTH))
        ctx_pre = _cfg_get(config, "context_preprocessor")
        self.context_preprocessor = Processor(ctx_pre) if ctx_pre is not None else None

    def get_vocab_size(self) -> int:
        return self.answer_vocab.num_vocab + self.max_length

    def get_true_vocab_size(self) -> int:
        return self.answer_vocab.num_vocab

    def __call__(self, item):
        out = super().__call__({"answers": item["answers"]})
        answers = out["answers"]
        n_vocab = self.answer_vocab.num_vocab
        scores = np.zeros(self.get_vocab_size(), np.float32)
        scores[:n_vocab] = out["answers_scores"][:n_vocab]
        tokens = list(item.get("tokens", []))
        if self.context_preprocessor is not None:
            tokens = [self.context_preprocessor({"text": t})["text"] for t in tokens]
        counter = Counter(answers)
        token_scores = np.zeros(self.max_length, np.float32)
        for i, tok in enumerate(tokens[: self.max_length]):
            if counter[tok]:
                token_scores[i] = _soft_score(answers, tok)
        scores[-self.max_length:] = token_scores
        out["answers_scores"] = scores
        return out
