"""Text utilities: tokenisation and vocabulary dictionaries.

Behaviour-compatible with the reference text layer
(reference: pythia/utils/text_utils.py:57-159) — same regex split, same
special tokens — implemented without torch.  The port's copy of vitxtgqa_tpu/data/text.py.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

SENTENCE_SPLIT_REGEX = re.compile(r"(\W+)")


def tokenize(
    sentence: str,
    regex: "re.Pattern" = SENTENCE_SPLIT_REGEX,
    keep: Optional[List[str]] = None,
    remove: Optional[List[str]] = None,
) -> List[str]:
    keep = ["'s"] if keep is None else keep
    remove = [",", "?"] if remove is None else remove
    sentence = sentence.lower()
    for token in keep:
        sentence = sentence.replace(token, " " + token)
    for token in remove:
        sentence = sentence.replace(token, "")
    tokens = regex.split(sentence)
    return [t.strip() for t in tokens if len(t.strip()) > 0]


def word_tokenize(word: str, remove: Optional[List[str]] = None) -> str:
    remove = [",", "?"] if remove is None else remove
    word = word.lower()
    for item in remove:
        word = word.replace(item, "")
    word = word.replace("'s", " 's")
    return word.strip()


def load_str_list(fname: str) -> List[str]:
    with open(fname, encoding="utf-8") as f:
        return [line.strip() for line in f.readlines()]


class VocabDict:
    """Word<->index dictionary over a newline-separated vocab file.

    Same contract as the reference VocabDict (pythia/utils/text_utils.py:88-159):
    <unk> prepended if missing; word2idx falls back to UNK; special tokens
    <pad>/<s>/</s> looked up by the answer processor.
    """

    UNK_TOKEN = "<unk>"
    PAD_TOKEN = "<pad>"
    START_TOKEN = "<s>"
    END_TOKEN = "</s>"

    def __init__(self, vocab_file: str, data_root_dir: Optional[str] = None):
        if not os.path.isabs(vocab_file) and data_root_dir is not None:
            vocab_file = os.path.abspath(os.path.join(data_root_dir, vocab_file))
        if not os.path.exists(vocab_file):
            raise RuntimeError(f"Vocab file {vocab_file} doesn't exist")
        self.word_list = load_str_list(vocab_file)
        self._build()

    @classmethod
    def from_list(cls, words: List[str]) -> "VocabDict":
        obj = cls.__new__(cls)
        obj.word_list = list(words)
        obj._build()
        return obj

    def _build(self) -> None:
        if self.UNK_TOKEN not in self.word_list:
            self.word_list = [self.UNK_TOKEN] + self.word_list
        self.word2idx_dict: Dict[str, int] = {
            w: i for i, w in enumerate(self.word_list)
        }
        self.stoi = self.word2idx_dict
        self.itos = self.word_list
        self.num_vocab = len(self.word_list)
        self.UNK_INDEX = self.word2idx_dict[self.UNK_TOKEN]

    def idx2word(self, idx: int) -> str:
        return self.word_list[idx]

    def word2idx(self, word: str) -> int:
        return self.word2idx_dict.get(word, self.UNK_INDEX)

    def tokenize_and_index(self, sentence: str) -> List[int]:
        return [self.word2idx(w) for w in tokenize(sentence)]

    def __len__(self) -> int:
        return self.num_vocab

    def get_size(self) -> int:
        return self.num_vocab
