"""PHOC (Pyramidal Histogram Of Characters) descriptor, 604-d.

The numpy half of vitxtgqa_tpu/ops/phoc.py (reference:
pythia/utils/phoc/src/cphoc.c:12-113 and build_phoc.py:9-14): the JAX
package's native C++ extension and its on-device version are not ported,
and `build_phoc_batch` is the vectorised numpy form, memoised per token
(the 960-slot OCR grid repeats its tokens, `<pad>` above all).  The JAX
tests hold the native and numpy forms bit for bit equal.

Layout: levels 2..5 over 36 unigrams [a-z0-9] (14 regions x 36 = 504), then
level 2 over 50 common bigrams (2 x 50 = 100).  A region bit is set when the
region covers >= 0.5 of the character (or bigram) span.
"""

from __future__ import annotations

import functools
from typing import Iterable, List

import numpy as np

PHOC_DIM = 604
UNIGRAMS = "abcdefghijklmnopqrstuvwxyz0123456789"
BIGRAMS = [
    "th", "he", "in", "er", "an", "re", "es", "on", "st", "nt",
    "en", "at", "ed", "nd", "to", "or", "ea", "ti", "ar", "te",
    "ng", "al", "it", "as", "is", "ha", "et", "se", "ou", "of",
    "le", "sa", "ve", "ro", "ra", "ri", "hi", "ne", "me", "de",
    "co", "ta", "ec", "si", "ll", "so", "na", "li", "la", "el",
]
_UNIGRAM_IDX = {c: i for i, c in enumerate(UNIGRAMS)}
_BIGRAM_IDX = {b: i for i, b in enumerate(BIGRAMS)}
# starting region offset (in units of 36) for each pyramid level
_LEVEL_START = {2: 0, 3: 2, 4: 5, 5: 9}
_BIGRAM_OFFSET = 14 * 36  # 504

# (level, region) pairs flattened: 2+3+4+5 = 14 regions
_LEVELS = np.concatenate([np.full(l, l) for l in (2, 3, 4, 5)]).astype(np.float32)
_REGIONS = np.concatenate([np.arange(l) for l in (2, 3, 4, 5)]).astype(np.float32)
_REGION_BASE = (
    np.concatenate([np.arange(l) + _LEVEL_START[l] for l in (2, 3, 4, 5)])
    .astype(np.int64)
)


def normalize_token(token: str) -> str:
    """Lowercase and keep only [a-z0-9]."""
    return "".join(c for c in token.lower() if c in _UNIGRAM_IDX)


def _occupancy(span0: np.ndarray, span1: np.ndarray) -> np.ndarray:
    """[K] spans x 14 regions -> bool [K, 14] occupancy per region."""
    r0 = _REGIONS / _LEVELS  # [14]
    r1 = (_REGIONS + 1.0) / _LEVELS
    lo = np.maximum(span0[:, None], r0[None, :])
    hi = np.minimum(span1[:, None], r1[None, :])
    return (hi - lo) / (span1 - span0)[:, None] >= 0.5


def phoc_numpy(token: str) -> np.ndarray:
    """Single-token PHOC, float32 [604]."""
    word = normalize_token(token)
    out = np.zeros(PHOC_DIM, dtype=np.float32)
    n = len(word)
    if n == 0:
        return out

    chars = np.array([_UNIGRAM_IDX[c] for c in word], dtype=np.int64)
    pos = np.arange(n, dtype=np.float32)
    occ = _occupancy(pos / n, (pos + 1) / n)  # [n, 14]
    ci, ri = np.nonzero(occ)
    out[_REGION_BASE[ri] * 36 + chars[ci]] = 1.0

    if n >= 2:
        bigram_ids = np.array(
            [_BIGRAM_IDX.get(word[i : i + 2], -1) for i in range(n - 1)],
            dtype=np.int64,
        )
        valid = bigram_ids >= 0
        if valid.any():
            pos2 = np.arange(n - 1, dtype=np.float32)
            occ2 = _occupancy(pos2 / n, (pos2 + 2) / n)[:, :2]  # level-2 only
            bi, ri2 = np.nonzero(occ2 & valid[:, None])
            out[_BIGRAM_OFFSET + ri2 * 50 + bigram_ids[bi]] = 1.0
    return out


def phoc_batch_numpy(tokens: Iterable[str]) -> np.ndarray:
    return np.stack([phoc_numpy(t) for t in tokens]) if tokens else np.zeros(
        (0, PHOC_DIM), np.float32
    )


@functools.lru_cache(maxsize=65536)
def _phoc_cached(token: str) -> np.ndarray:
    out = phoc_numpy(token)
    out.setflags(write=False)
    return out


def build_phoc(token: str) -> np.ndarray:
    """[604] float32 (read-only: shared by the memo)."""
    return _phoc_cached(token)


def build_phoc_batch(tokens: List[str]) -> np.ndarray:
    """[N, 604] float32 over a token list (the 960-slot OCR grid hot path)."""
    if not tokens:
        return np.zeros((0, PHOC_DIM), np.float32)
    return np.stack([_phoc_cached(t) for t in tokens])
