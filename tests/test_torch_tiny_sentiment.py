"""The tiny sentiment corpus in the PyTorch port
(``deeplearning4j_torch.data.tiny_sentiment``): its own copy of the
reference's TSV, byte for byte; the corpus's integrity; a vocabulary that
covers it with no ``[UNK]``; and the pair-aware split, the vocabulary ids
and the encoded BertIterator batches equal to the JAX package's (at t 16,
the corpus's longest sentence, and at t 512, BERT's flash-route length)."""
import pathlib

import numpy as np
import pytest

from deeplearning4j_torch.data import BertIterator
from deeplearning4j_torch.data import tiny_sentiment as ts

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_corpus_is_a_byte_copy_of_the_reference():
    mine = pathlib.Path(ts._TSV)
    assert mine.is_relative_to(ROOT / "deeplearning4j_torch")
    ref = ROOT / "deeplearning4j_tpu" / "data" / "corpora" / \
        "tiny_sentiment.tsv"
    assert mine.read_bytes() == ref.read_bytes()


def test_corpus_integrity():
    data = ts.load_tiny_sentiment()
    assert len(data) == 318
    labels = [l for _, l in data]
    assert sum(labels) == 159                      # balanced
    texts = [t for t, _ in data]
    assert len(set(texts)) == len(texts)           # no duplicates
    train, test = ts.train_test_split()
    assert len(train) == 238 and len(test) == 80
    assert not set(t for t, _ in train) & set(t for t, _ in test)
    assert 30 <= sum(l for _, l in test) <= 50     # held-out balanced-ish


def test_vocab_covers_corpus_no_unk():
    tok = ts.make_tokenizer()
    unk = tok.vocab["[UNK]"]
    for text, _ in ts.load_tiny_sentiment():
        ids, mask, _ = tok.encode(text, max_len=16)
        assert unk not in ids
        assert sum(mask) >= 4                      # CLS + words + SEP


@pytest.fixture(scope="module")
def jts():
    pytest.importorskip("jax")
    from deeplearning4j_tpu.data import tiny_sentiment
    return tiny_sentiment


def test_corpus_split_and_vocab_equal_jax(jts):
    assert ts.load_tiny_sentiment() == jts.load_tiny_sentiment()
    assert ts.train_test_split() == jts.train_test_split()
    assert ts.train_test_split(k=3) == jts.train_test_split(k=3)
    assert ts.build_vocab() == jts.build_vocab()
    assert ts.SPECIALS == jts.SPECIALS


@pytest.mark.parametrize("t", [16, 512])
def test_encoded_batches_equal_jax(jts, t):
    """The pipeline of the chip smoke's data phase — split, seeded
    shuffle, batches of 34 (train) and 40 (held out) — gives the same
    int32 ids, masks, segments and labels in both packages."""
    from deeplearning4j_tpu.data.bert_iterator import BertIterator as JIt
    train, test = ts.train_test_split()
    np.random.default_rng(7).shuffle(train)
    jtrain, jtest = jts.train_test_split()
    np.random.default_rng(7).shuffle(jtrain)
    assert train == jtrain
    for rows, jrows, batch in ((train, jtrain, 34), (test, jtest, 40)):
        got = list(BertIterator(ts.make_tokenizer(), rows, batch, t))
        want = list(JIt(jts.make_tokenizer(), jrows, batch, t))
        assert len(got) == len(want) == len(rows) // batch
        for g, w in zip(got, want):
            assert g.features[0].shape == (batch, t)
            for a, b in zip(g.features + g.labels, w.features + w.labels):
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)
