"""Vocab family: vocabulary objects with attached embedding matrices (the
port's copy of vitxtgqa_tpu/data/vocab_embeddings.py).

(reference: pythia/utils/vocab.py:15-375 — Vocab dispatch over types
random/custom/pretrained/intersected/extracted/model, built on torchtext
GloVe caches.)  Here embeddings come from the word_vectors providers, so
the same types work offline: `pretrained`/`intersected` intersect a vocab
file with a vector source, `random` draws a seeded gaussian table, `model`
wraps a vector provider directly (WordToVectorDict equivalent).
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from vitxtgqa_tpu_torch.data.text import VocabDict
from vitxtgqa_tpu_torch.data.word_vectors import WordVectors, load_word_vectors

PAD_TOKEN = "<pad>"
UNK_TOKEN = "<unk>"
SOS_TOKEN = "<s>"
EOS_TOKEN = "</s>"


class BaseVocab:
    """Vocab + [num_vocab, dim] embedding table."""

    def __init__(self, word_list: List[str], dim: int,
                 vectors: Optional[np.ndarray] = None, seed: int = 0):
        specials = [PAD_TOKEN, UNK_TOKEN, SOS_TOKEN, EOS_TOKEN]
        words = [w for w in word_list if w not in specials]
        self.word_list = specials + words
        self.vocab = VocabDict.from_list(self.word_list)
        self.PAD_INDEX = self.vocab.word2idx(PAD_TOKEN)
        self.UNK_INDEX = self.vocab.word2idx(UNK_TOKEN)
        self.SOS_INDEX = self.vocab.word2idx(SOS_TOKEN)
        self.EOS_INDEX = self.vocab.word2idx(EOS_TOKEN)
        self.stoi = self.vocab.word2idx_dict
        self.itos = self.vocab.word_list
        if vectors is None:
            rng = np.random.default_rng(seed)
            vectors = rng.standard_normal((len(self.word_list), dim)).astype(
                np.float32
            )
            vectors[self.PAD_INDEX] = 0.0
        self.vectors = vectors
        self.dim = dim

    def get_size(self) -> int:
        return len(self.word_list)

    def get_pad_index(self) -> int:
        return self.PAD_INDEX

    def get_embedding_dim(self) -> int:
        return self.dim

    def get_vectors(self) -> np.ndarray:
        return self.vectors


class RandomVocab(BaseVocab):
    def __init__(self, vocab_file: str, embedding_dim: int = 300, **kw):
        from vitxtgqa_tpu_torch.data.text import load_str_list

        super().__init__(load_str_list(vocab_file), embedding_dim)


class IntersectedVocab(BaseVocab):
    """Vocab file with embeddings pulled from a vector source
    (reference `intersected`/`pretrained` types)."""

    def __init__(self, vocab_file: str, model_file: Optional[str] = None,
                 embedding_dim: int = 300, **kw):
        from vitxtgqa_tpu_torch.data.text import load_str_list

        source = load_word_vectors(model_file, dim=embedding_dim)
        words = load_str_list(vocab_file)
        specials = [PAD_TOKEN, UNK_TOKEN, SOS_TOKEN, EOS_TOKEN]
        ordered = specials + [w for w in words if w not in specials]
        vectors = np.zeros((len(ordered), source.dim), np.float32)
        for i, w in enumerate(ordered):
            if w not in specials:
                vectors[i] = source[w]
        super().__init__(words, source.dim, vectors=vectors)


class ExtractedVocab(BaseVocab):
    """Pre-extracted embedding npy alongside the vocab file
    (reference `extracted` type)."""

    def __init__(self, vocab_file: str, embedding_file: str, **kw):
        from vitxtgqa_tpu_torch.data.text import load_str_list

        vectors = np.load(embedding_file).astype(np.float32)
        words = load_str_list(vocab_file)
        super().__init__(words, vectors.shape[1], vectors=vectors)


class ModelVocab:
    """No vocabulary — a vector provider queried per word
    (reference `model` type + WordToVectorDict, vocab.py:375-381)."""

    def __init__(self, model_file: Optional[str] = None, embedding_dim: int = 300, **kw):
        self.stov: WordVectors = load_word_vectors(model_file, dim=embedding_dim)
        self.dim = self.stov.dim

    def __getitem__(self, word: str) -> np.ndarray:
        return self.stov[word]

    def get_embedding_dim(self) -> int:
        return self.dim


def Vocab(type: str = "random", **params) -> Any:
    """Type-dispatched constructor (reference: vocab.py:15-66)."""
    kinds = {
        "random": RandomVocab,
        "custom": RandomVocab,
        "pretrained": IntersectedVocab,
        "intersected": IntersectedVocab,
        "extracted": ExtractedVocab,
        "model": ModelVocab,
    }
    if type not in kinds:
        raise ValueError(f"unknown vocab type {type!r}; known: {sorted(kinds)}")
    return kinds[type](**params)
