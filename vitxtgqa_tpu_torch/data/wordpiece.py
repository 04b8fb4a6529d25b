"""Self-contained BERT-style WordPiece tokenizer (the port's copy of
vitxtgqa_tpu/data/wordpiece.py).

The reference shells out to HuggingFace's BertTokenizer for question encoding
(reference: pythia/datasets/processors.py:947-984).  This environment has no
network and no cached HF assets, so the tokenizer is implemented natively:

  * with a `vocab_file` (bert-base-uncased vocab.txt): full BasicTokenizer +
    greedy longest-match WordPiece, byte-compatible ids with HF for the
    uncased model;
  * without a vocab file: a deterministic hashed fallback that keeps the
    [PAD]=0 / [CLS]=101 / [SEP]=102 / [UNK]=100 id conventions so models and
    fixtures run end-to-end (ids are stable across processes).
"""

from __future__ import annotations

import hashlib
import unicodedata
from typing import Dict, List, Optional

BERT_VOCAB_SIZE = 30522
PAD_ID, UNK_ID, CLS_ID, SEP_ID, MASK_ID = 0, 100, 101, 102, 103
_HASH_ID_LO, _HASH_ID_HI = 1000, 29996  # leave specials + unused ids alone


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch) in ("Cc", "Cf")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def basic_tokenize(text: str, lower: bool = True) -> List[str]:
    """BERT BasicTokenizer: clean, lowercase+strip accents, split punctuation."""
    out_chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        out_chars.append(" " if _is_whitespace(ch) else ch)
    text = "".join(out_chars)

    tokens: List[str] = []
    for tok in text.strip().split():
        if lower:
            tok = tok.lower()
            tok = "".join(
                c for c in unicodedata.normalize("NFD", tok)
                if unicodedata.category(c) != "Mn"
            )
        word = []
        for ch in tok:
            if _is_punctuation(ch):
                if word:
                    tokens.append("".join(word))
                    word = []
                tokens.append(ch)
            else:
                word.append(ch)
        if word:
            tokens.append("".join(word))
    return tokens


def wordpiece(token: str, vocab: Dict[str, int], max_chars: int = 200) -> List[str]:
    """Greedy longest-match-first subword split with ## continuations."""
    if len(token) > max_chars:
        return ["[UNK]"]
    pieces: List[str] = []
    start = 0
    while start < len(token):
        end = len(token)
        cur = None
        while start < end:
            sub = token[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                cur = sub
                break
            end -= 1
        if cur is None:
            return ["[UNK]"]
        pieces.append(cur)
        start = end
    return pieces


class WordPieceTokenizer:
    def __init__(self, vocab_file: Optional[str] = None, lower: bool = True):
        self.lower = lower
        self.vocab: Optional[Dict[str, int]] = None
        if vocab_file:
            with open(vocab_file, encoding="utf-8") as f:
                words = [line.rstrip("\n") for line in f]
            self.vocab = {w: i for i, w in enumerate(words)}
            self.inv_vocab = {i: w for w, i in self.vocab.items()}
            self.pad_id = self.vocab.get("[PAD]", PAD_ID)
            self.unk_id = self.vocab.get("[UNK]", UNK_ID)
            self.cls_id = self.vocab.get("[CLS]", CLS_ID)
            self.sep_id = self.vocab.get("[SEP]", SEP_ID)
            self.vocab_size = len(self.vocab)
        else:
            self.pad_id, self.unk_id = PAD_ID, UNK_ID
            self.cls_id, self.sep_id = CLS_ID, SEP_ID
            self.vocab_size = BERT_VOCAB_SIZE

    def _hashed_id(self, token: str) -> int:
        digest = hashlib.md5(token.encode("utf-8")).digest()
        span = _HASH_ID_HI - _HASH_ID_LO
        return _HASH_ID_LO + int.from_bytes(digest[:4], "little") % span

    def tokenize(self, text: str) -> List[str]:
        basics = basic_tokenize(text, lower=self.lower)
        if self.vocab is None:
            return basics
        out: List[str] = []
        for tok in basics:
            out.extend(wordpiece(tok, self.vocab))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        toks = self.tokenize(text)
        if self.vocab is None:
            ids = [self._hashed_id(t) for t in toks]
        else:
            ids = [self.vocab.get(t, self.unk_id) for t in toks]
        if add_special_tokens:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids
