"""Word-vector providers for OCR-token features (the port's copy of
vitxtgqa_tpu/data/word_vectors.py).

The reference loads the 8GB fastText wiki.en.bin through the native fasttext
library (reference: pythia/datasets/processors.py:463-491, vector =
mean over space-split subwords of get_word_vector, vocab.py:375-381).  This
framework wraps that behind a `WordVectors` interface with three backends:

  * FastTextVectors  — real fastText .bin via the `fasttext` package when
                       both the package and the model file exist
  * CachedVectors    — a pre-extracted {token: vector} .npy/.npz cache
                       (produced offline by tools/extract_word_vectors.py)
  * HashedVectors    — deterministic char-n-gram hash embeddings, the
                       dependency-free fallback used by tests/fixtures;
                       mimics fastText's subword structure so unseen tokens
                       still get non-trivial, stable vectors
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

import numpy as np


class WordVectors:
    dim: int = 300

    def get_word_vector(self, word: str) -> np.ndarray:
        raise NotImplementedError

    def __getitem__(self, phrase: str) -> np.ndarray:
        """Mean over space-split words (reference: vocab.py:379-381)."""
        words = phrase.split(" ")
        return np.mean([self.get_word_vector(w) for w in words], axis=0)

    def get_many(self, phrases) -> np.ndarray:
        """[N, dim] float32 for a token list — the 960-slot OCR hot path.

        Phrase-level memo on top of the backend lookup: a sample's OCR grid
        repeats tokens heavily (`<pad>` alone fills most slots) and the
        token distribution across samples is Zipfian, so this turns the
        per-sample cost into ~N dict hits + row copies (measured 10.3 ->
        ~1.5 ms/sample on the host bench, tools/bench_host_pipeline.py)."""
        cache = getattr(self, "_phrase_cache", None)
        if cache is None:
            cache = self._phrase_cache = {}
        out = np.empty((len(phrases), self.dim), np.float32)
        for i, p in enumerate(phrases):
            v = cache.get(p)
            if v is None:
                v = np.asarray(self[p], np.float32)
                if len(cache) < 500_000:
                    cache[p] = v
            out[i] = v
        return out


class HashedVectors(WordVectors):
    """Stable char-n-gram hash embedding (fastText-like subword averaging)."""

    def __init__(self, dim: int = 300, ngram_range=(3, 6), seed: int = 1234):
        self.dim = dim
        self.ngram_range = ngram_range
        self.seed = seed
        self._cache: Dict[str, np.ndarray] = {}

    def _ngram_vec(self, ngram: str) -> np.ndarray:
        digest = hashlib.blake2b(
            ngram.encode("utf-8"), digest_size=8, key=str(self.seed).encode()
        ).digest()
        rng = np.random.default_rng(int.from_bytes(digest, "little"))
        return rng.standard_normal(self.dim).astype(np.float32)

    def get_word_vector(self, word: str) -> np.ndarray:
        if word in self._cache:
            return self._cache[word]
        if not word:
            return np.zeros(self.dim, np.float32)
        wrapped = f"<{word}>"
        lo, hi = self.ngram_range
        grams = [wrapped] + [
            wrapped[i : i + n]
            for n in range(lo, hi + 1)
            for i in range(len(wrapped) - n + 1)
        ]
        vec = np.mean([self._ngram_vec(g) for g in grams], axis=0).astype(np.float32)
        if len(self._cache) < 200_000:
            self._cache[word] = vec
        return vec


class CachedVectors(WordVectors):
    """token->vector table from an .npz file with arrays `tokens`, `vectors`."""

    def __init__(self, path: str):
        data = np.load(path, allow_pickle=True)
        tokens = [str(t) for t in data["tokens"]]
        vectors = np.asarray(data["vectors"], dtype=np.float32)
        self.table = dict(zip(tokens, vectors))
        self.dim = int(vectors.shape[1])
        self._fallback = HashedVectors(dim=self.dim)

    def get_word_vector(self, word: str) -> np.ndarray:
        vec = self.table.get(word)
        return vec if vec is not None else self._fallback.get_word_vector(word)


class FastTextVectors(WordVectors):
    def __init__(self, model_file: str):
        from fasttext import load_model  # optional dependency

        self.model = load_model(model_file)
        self.dim = self.model.get_dimension()

    def get_word_vector(self, word: str) -> np.ndarray:
        return np.asarray(self.model.get_word_vector(word), dtype=np.float32)


def load_word_vectors(model_file: Optional[str], dim: int = 300) -> WordVectors:
    """Resolve the best available backend for `model_file`."""
    if model_file and os.path.exists(model_file):
        if model_file.endswith(".npz"):
            return CachedVectors(model_file)
        try:
            return FastTextVectors(model_file)
        except ImportError:
            pass
    return HashedVectors(dim=dim)
