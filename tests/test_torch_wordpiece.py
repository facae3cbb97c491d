"""WordPiece tokenizer + BertIterator in the PyTorch port
(``deeplearning4j_torch.nlp.wordpiece``, ``deeplearning4j_torch.data.
bert_iterator``), each case held to the JAX package's tokenizer and
iterator on the same vocab file (exact: lists and int arrays equal), and
to the installed ``transformers.BertTokenizer`` where it is present (the
reference suite's goldens; no download)."""
import numpy as np
import pytest

from deeplearning4j_torch.data.bert_iterator import BertIterator
from deeplearning4j_torch.nlp.wordpiece import BertWordPieceTokenizerFactory

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "quick", "brown", "fox", "jump", "##s", "##ed", "##ing",
         "over", "lazy", "dog", "pack", "box", "with", "five", "dozen",
         "liquor", "jug", "un", "##aff", "##able", ",", ".", "!", "?",
         "'", "a", "b", "c", "d", "e"]

SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "Pack my box with five dozen liquor jugs!",
    "unaffable jumping, quick?",
    "Entirely-unknown words appear",
    "the the the",
    "Café naïve résumé",
]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("wp") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n")
    return str(p)


@pytest.fixture(scope="module")
def ref(vocab_file):
    """(the JAX package's tokenizer over the same vocab file, its
    BertIterator class)."""
    pytest.importorskip("jax")
    from deeplearning4j_tpu.data.bert_iterator import BertIterator as JIt
    from deeplearning4j_tpu.nlp.wordpiece import (
        BertWordPieceTokenizerFactory as JTok)
    return JTok(vocab_file), JIt


@pytest.fixture(scope="module")
def hf(vocab_file):
    transformers = pytest.importorskip("transformers")
    return transformers.BertTokenizer(vocab_file=vocab_file,
                                      do_lower_case=True)


@pytest.fixture(scope="module")
def tok(vocab_file):
    return BertWordPieceTokenizerFactory(vocab_file)


def test_tokenize_matches_jax(tok, ref):
    for s in SENTENCES:
        assert tok.tokenize(s) == ref[0].tokenize(s), s


def test_tokenize_matches_hf(tok, hf):
    for s in SENTENCES[:5]:
        assert tok.tokenize(s) == hf.tokenize(s), s


@pytest.mark.parametrize("max_len", [None, 6, 16])
def test_encode_matches_jax(tok, ref, max_len):
    for s in SENTENCES:
        assert tok.encode(s, max_len=max_len) == \
            ref[0].encode(s, max_len=max_len), s


def test_encode_matches_hf(tok, hf):
    for s in SENTENCES[:5]:
        enc = hf(s, padding="max_length", truncation=True, max_length=16)
        ids, mask, tt = tok.encode(s, max_len=16)
        assert ids == enc["input_ids"], s
        assert mask == enc["attention_mask"], s
        assert tt == enc["token_type_ids"], s


def test_encode_pair_matches_jax_and_hf(tok, ref, hf):
    a, b = "the quick fox", "a lazy dog!"
    got = tok.encode(a, pair=b, max_len=20)
    assert got == ref[0].encode(a, pair=b, max_len=20)
    enc = hf(a, b, padding="max_length", truncation=False, max_length=20)
    assert got[0] == enc["input_ids"]
    assert got[2] == enc["token_type_ids"]


@pytest.mark.parametrize("max_len", [12, 13, 16])
def test_encode_pair_truncation_matches_jax(tok, ref, max_len):
    """longest_first pair truncation keeps both [SEP]s and the segment
    ids."""
    a = "the quick brown fox jumps over the lazy dog"
    b = "pack box with five dozen"
    got = tok.encode(a, pair=b, max_len=max_len)
    assert got == ref[0].encode(a, pair=b, max_len=max_len)
    assert got[0].count(tok.vocab["[SEP]"]) == 2
    assert len(got[0]) == max_len


@pytest.mark.parametrize("max_len", [12, 13, 16])
def test_encode_pair_truncation_matches_hf(tok, hf, max_len):
    a = "the quick brown fox jumps over the lazy dog"
    b = "pack box with five dozen"
    enc = hf(a, b, padding="max_length", truncation="longest_first",
             max_length=max_len)
    ids, mask, tt = tok.encode(a, pair=b, max_len=max_len)
    assert ids == enc["input_ids"]
    assert tt == enc["token_type_ids"]
    assert mask == enc["attention_mask"]


def test_decode_roundtrip(tok, ref):
    ids, _, _ = tok.encode("the quick brown fox jumps")
    assert tok.decode(ids) == "the quick brown fox jumps"
    assert tok.decode(ids) == ref[0].decode(ids)
    assert tok.decode([5, 9, 10, 99]) == ref[0].decode([5, 9, 10, 99])


def test_bert_iterator_classification_matches_jax(tok, ref):
    data = [("the quick brown fox", 1), ("pack my box", 0),
            ("five dozen liquor jugs", 0), ("lazy dog jumps", 1),
            ("the fox", 1)]
    got = list(BertIterator(tok, data, batch_size=2, max_len=16))
    want = list(ref[1](ref[0], data, batch_size=2, max_len=16))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g.features) == 3 and len(g.labels) == 1
        for a, b in zip(g.features + g.labels, w.features + w.labels):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [1, 5])
def test_bert_iterator_mlm_masking_matches_jax(tok, ref, seed):
    """The MLM draws use numpy's default_rng(seed) in both packages, so
    masks, replaced ids and targets are equal; the selection rules hold."""
    sents = ["the quick brown fox jumps over the lazy dog"] * 8 \
        + ["pack my box with five dozen liquor jugs"] * 4
    it = BertIterator(tok, sents, batch_size=8, max_len=16,
                      task="unsupervised", mask_prob=0.5, seed=seed)
    jit = ref[1](ref[0], sents, batch_size=8, max_len=16,
                 task="unsupervised", mask_prob=0.5, seed=seed)
    batches = list(it)
    for g, w in zip(batches, jit):
        for a, b in zip(g.features + g.labels, w.features + w.labels):
            np.testing.assert_array_equal(a, b)
    ds = batches[0]
    ids, mask, tt = ds.features
    tgt, sel = ds.labels
    assert ids.shape == (8, 16)
    assert sel.sum() > 0
    cls, sep, pad = (tok.vocab["[CLS]"], tok.vocab["[SEP]"],
                     tok.vocab["[PAD]"])
    # selection never hits special or padded positions
    assert not np.any(sel & np.isin(tgt, [cls, sep, pad]))
    assert not np.any(sel & (mask == 0))
    # unselected positions are untouched; most selected become [MASK]
    assert np.array_equal(ids[sel == 0], tgt[sel == 0])
    frac_masked = (ids[sel == 1] == tok.vocab["[MASK]"]).mean()
    assert 0.6 < frac_masked <= 1.0


def test_mlm_always_selects_at_least_one(tok, ref):
    """Every example with candidates gets >= 1 selected position even at
    a tiny mask_prob — the same positions as the JAX package's."""
    sents = ["the fox"] * 16
    sel = next(iter(BertIterator(tok, sents, batch_size=16, max_len=8,
                                 task="unsupervised", mask_prob=0.01,
                                 seed=0))).labels[1]
    want = next(iter(ref[1](ref[0], sents, batch_size=16, max_len=8,
                            task="unsupervised", mask_prob=0.01,
                            seed=0))).labels[1]
    assert (sel.sum(axis=1) >= 1).all()
    np.testing.assert_array_equal(sel, want)


def test_encode_degenerate_max_len_raises(tok, ref):
    """max_len too small for the [CLS]/[SEP] framing raises, as in the
    reference."""
    for t in (tok, ref[0]):
        with pytest.raises(ValueError, match="max_len"):
            t.encode("the quick fox", max_len=1)
        with pytest.raises(ValueError, match="max_len"):
            t.encode("the quick", pair="lazy dog", max_len=2)
    ids, mask, tt = tok.encode("the", max_len=2)
    assert len(ids) == 2
    assert (ids, mask, tt) == ref[0].encode("the", max_len=2)


def test_bad_vocab_and_task_raise():
    with pytest.raises(ValueError, match=r"\[SEP\]"):
        BertWordPieceTokenizerFactory({"[PAD]": 0, "[CLS]": 1, "[UNK]": 2})
    t = BertWordPieceTokenizerFactory({s: i for i, s in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a"])})
    with pytest.raises(ValueError, match="unknown task"):
        BertIterator(t, ["a"], 1, 4, task="nsp")
    with pytest.raises(ValueError, match=r"\[MASK\]"):
        BertIterator(t, ["a"], 1, 4, task="unsupervised")
