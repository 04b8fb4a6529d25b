"""The port's CLIP BPE tokenizer (vitxtgqa_tpu_torch/data/clip_tokenizer.py,
its own copy) against the JAX package's, on a small merge table the test
writes itself (plain and gzipped): encode, decode and tokenize's SOT / EOT
framing, its overflow error and truncation.  Nothing is downloaded."""

import gzip

import numpy as np
import pytest

from vitxtgqa_tpu.data import clip_tokenizer as J
from vitxtgqa_tpu_torch.data import clip_tokenizer as P

MERGES = ["t h", "th e</w>", "a n", "an d</w>", "i n", "in g</w>", "s t", "st r", "e r</w>",
          "o n</w>", "c a", "ca t</w>", "h e", "he l", "hel l", "hell o</w>", "1 2", "é t"]
TEXTS = ["The cat and the string", "hello, hello world!", "running  &amp; jumping 123",
         "été 2024 l'été", "", "CAT<|endoftext|>dog", "tabs\tand\nnewlines"]


@pytest.fixture(scope="module", params=["txt", "gz"])
def tables(tmp_path_factory, request):
    path = tmp_path_factory.mktemp("bpe") / f"merges.{request.param}"
    body = ("#version: 0.2\n" + "\n".join(MERGES)).encode("utf-8")
    if request.param == "gz":
        path.write_bytes(gzip.compress(body))
    else:
        path.write_bytes(body)
    return J.ClipBPETokenizer(str(path)), P.ClipBPETokenizer(str(path))


def test_vocabulary_and_specials_match(tables):
    jt, pt = tables
    assert pt.encoder == jt.encoder and pt.decoder == jt.decoder
    assert len(pt.encoder) == 512 + len(MERGES) + 2
    assert (pt.sot_token, pt.eot_token) == (jt.sot_token, jt.eot_token)
    assert P.byte_to_unicode() == J.byte_to_unicode()


@pytest.mark.parametrize("text", TEXTS)
def test_encode_and_decode_match(tables, text):
    jt, pt = tables
    ids = pt.encode(text)
    assert ids == jt.encode(text)
    assert pt.decode(ids) == jt.decode(ids)
    if text == "The cat and the string":  # the merges apply
        assert [pt.decoder[i] for i in ids][:2] == ["the</w>", "cat</w>"]


def test_tokenize_frames_pads_and_truncates_as_jax(tables):
    jt, pt = tables
    got, want = P.tokenize(pt, TEXTS, context_length=24), J.tokenize(jt, TEXTS, context_length=24)
    assert got.dtype == want.dtype == np.int32 and got.shape == (len(TEXTS), 24)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == pt.sot_token).all()
    np.testing.assert_array_equal(P.tokenize(pt, "the cat"), J.tokenize(jt, "the cat"))
    long = "the cat " * 20
    with pytest.raises(RuntimeError, match="too long"):
        P.tokenize(pt, long, context_length=8)
    cut = P.tokenize(pt, long, context_length=8, truncate=True)
    np.testing.assert_array_equal(cut, J.tokenize(jt, long, context_length=8, truncate=True))
    assert cut[0, -1] == pt.eot_token
