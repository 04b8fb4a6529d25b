"""CLIP byte-level BPE tokenizer.

The port's own copy of vitxtgqa_tpu/data/clip_tokenizer.py (pure Python),
the tokenizer the reference bundles for its CLIP tower (reference:
pythia/modules/mist_module/clip/simple_tokenizer.py and clip/clip.py
``tokenize``).  The BPE merge table is data: it is read from a path the
caller gives (the standard ``bpe_simple_vocab_16e6.txt.gz`` of every CLIP
release); no vocabulary ships with the package.

Behaviour:
  * the byte -> unicode table maps every byte to a printable code point, so
    merges work on reversible unicode strings (simple_tokenizer.py:16-35);
  * words end with ``</w>``; the vocabulary is [256 byte symbols, 256
    ``</w>`` variants, 48,894 merges, 2 specials] = 49,408 entries (the
    merge table's lines 1 to 48,894);
  * text cleaning: ftfy (where importable; identity on well-formed text
    otherwise), html.unescape twice, whitespace collapsed, lower case
    (simple_tokenizer.py:50-59).  The word pattern takes the ``regex``
    module's \\p classes where it is importable, else an ASCII pattern of
    the stdlib ``re``.
"""

from __future__ import annotations

import gzip
import html
import re as _stdlib_re
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

try:  # the reference's regex with \p classes needs the `regex` module
    import regex as _re

    _WORD_PATTERN = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # the ASCII classes of the stdlib re
    _re = _stdlib_re
    _WORD_PATTERN = _stdlib_re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
        _stdlib_re.IGNORECASE,
    )

try:
    import ftfy

    _fix_text = ftfy.fix_text
except ImportError:  # identity on well-formed text
    _fix_text = lambda s: s


@lru_cache()
def byte_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (simple_tokenizer.py:16-35)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    fill = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + fill)
            fill += 1
    return mapping


def _clean(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    return _stdlib_re.sub(r"\s+", " ", text).strip()


class ClipBPETokenizer:
    """Byte-level BPE with CLIP's end-of-word convention."""

    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, bpe_path: str):
        self._b2u = byte_to_unicode()
        self._u2b = {u: b for b, u in self._b2u.items()}

        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rb") as f:
            lines = f.read().decode("utf-8").split("\n")
        # line 0 is a version banner; the standard table keeps 48894 merges
        merge_lines = lines[1 : 49152 - 256 - 2 + 1]
        merges: List[Tuple[str, str]] = [
            tuple(line.split()) for line in merge_lines
        ]

        symbols = list(self._b2u.values())
        vocab = symbols + [s + "</w>" for s in symbols]
        vocab += ["".join(pair) for pair in merges]
        vocab += [self.SOT, self.EOT]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self._rank: Dict[Tuple[str, str], int] = {
            pair: i for i, pair in enumerate(merges)
        }
        self._cache: Dict[str, str] = {self.SOT: self.SOT, self.EOT: self.EOT}

    @property
    def sot_token(self) -> int:
        return self.encoder[self.SOT]

    @property
    def eot_token(self) -> int:
        return self.encoder[self.EOT]

    def _merge_word(self, token: str) -> str:
        """Apply merges greedily by rank until none apply."""
        if token in self._cache:
            return self._cache[token]
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        if len(parts) == 1:
            return token + "</w>"

        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]) for i in range(len(parts) - 1)}
            best = min(pairs, key=lambda p: self._rank.get(p, float("inf")))
            if best not in self._rank:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    i < len(parts) - 1
                    and parts[i] == first
                    and parts[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged

        result = " ".join(parts)
        self._cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _WORD_PATTERN.findall(_clean(text).lower()):
            mapped = "".join(self._b2u[b] for b in word.encode("utf-8"))
            ids.extend(
                self.encoder[piece] for piece in self._merge_word(mapped).split(" ")
            )
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        joined = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self._u2b[ch] for ch in joined)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


def tokenize(
    tokenizer: ClipBPETokenizer,
    texts,
    context_length: int = 77,
    truncate: bool = False,
) -> np.ndarray:
    """Batch of texts -> [N, context_length] int32 with SOT/EOT framing.

    Mirrors clip/clip.py `tokenize`: raises on overflow unless ``truncate``
    (then the last slot becomes EOT).
    """
    if isinstance(texts, str):
        texts = [texts]
    out = np.zeros((len(texts), context_length), np.int32)
    for row, text in enumerate(texts):
        ids = [tokenizer.sot_token] + tokenizer.encode(text) + [tokenizer.eot_token]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length "
                    f"{context_length}"
                )
            ids = ids[:context_length]
            ids[-1] = tokenizer.eot_token
        out[row, : len(ids)] = ids
    return out
