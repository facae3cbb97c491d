"""The port's NLP embeddings (``deeplearning4j_torch.nlp``: Word2Vec,
ParagraphVectors, FastText, WordVectorSerializer) against the JAX
package's on numpy-seeded inputs, on the CPU.

Held across packages: the pair stream (``_pairs``, with and without
frequent-word subsampling) and the Huffman tree equal; one
negative-sampling step, one hierarchical-softmax step and one FastText
subword step from the same tables and batch, the port given the
negatives the JAX step draws from its key, within 1e-6.  Convergence
(embedding quality, OOV vectors, document vectors, the serializer round
trip) is checked in the port only: ``torch.Generator`` negatives differ
from ``jax.random``'s.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.nlp import (FastText, ParagraphVectors,  # noqa: E402
                                      Word2Vec, WordVectorSerializer)
from deeplearning4j_torch.nlp import word2vec as w2v  # noqa: E402
from deeplearning4j_torch.nlp import fasttext as ft  # noqa: E402

STEP_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread: many small CPU ops whose thread pools
    would starve each other under the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    jax = pytest.importorskip("jax")
    return (jax, jax.numpy,
            importlib.import_module("deeplearning4j_tpu.nlp.word2vec"),
            importlib.import_module("deeplearning4j_tpu.nlp.fasttext"))


def _topic_corpus(rng, n_sent=300, sent_len=8):
    """Two disjoint topics: words co-occur only within their topic."""
    a = [f"apple{i}" for i in range(10)]
    b = [f"boat{i}" for i in range(10)]
    sents = []
    for _ in range(n_sent):
        pool = a if rng.random() < 0.5 else b
        sents.append(" ".join(rng.choice(pool, sent_len)))
    return sents, a, b


def _quality(model, a, b):
    intra, inter = [], []
    for i in range(0, 8, 2):
        intra.append(model.similarity(a[i], a[i + 1]))
        intra.append(model.similarity(b[i], b[i + 1]))
        inter.append(model.similarity(a[i], b[i]))
    return float(np.mean(intra)), float(np.mean(inter))


def _vocab_of(m, sents):
    toks = [m.tokenizer_factory.tokenize(s) for s in sents]
    m._build_vocab(toks)
    return toks


# -- across packages ----------------------------------------------------
@pytest.mark.parametrize("sampling,window", [(0.0, 5), (1e-2, 3)])
def test_pairs_and_vocab_equal_jax(sampling, window):
    """The vectorised pair stream equals the reference's loop: same
    vocabulary, same pairs in the same shuffled order, the generator left
    in the same state (one draw per in-vocabulary token when
    subsampling); short sentences and out-of-vocabulary words included."""
    _, _, jw, _ = _jax()
    rng = np.random.default_rng(5)
    sents, _, _ = _topic_corpus(rng, n_sent=80)
    sents += ["apple1", "", "rare words here apple2 boat3"]
    kw = dict(window_size=window, sampling=sampling, min_word_frequency=2)
    jm, pm = jw.Word2Vec(**kw), Word2Vec(device="cpu", **kw)
    jt, pt = _vocab_of(jm, sents), _vocab_of(pm, sents)
    assert pm.index2word == jm.index2word and pm.vocab == jm.vocab
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    jp, pp = jm._pairs(jt, r1), pm._pairs(pt, r2)
    assert pp.dtype == jp.dtype == np.int32
    np.testing.assert_array_equal(pp, jp)
    assert r1.random() == r2.random()


def test_huffman_tree_equal_jax():
    _, _, jw, _ = _jax()
    counts = np.random.default_rng(3).integers(1, 500, 37).tolist()
    for got, want in zip(w2v.build_huffman(counts),
                         jw.build_huffman(counts)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match=">= 2"):
        w2v.build_huffman([5])


def _step_inputs(n_vocab, n_rows, d, b, seed):
    r = np.random.default_rng(seed)
    syn0 = ((r.random((n_rows, d)) - 0.5) / d).astype(np.float32)
    syn1 = (r.normal(size=(n_vocab, d)) * 0.1).astype(np.float32)
    centers = r.integers(0, n_vocab, b).astype(np.int32)
    contexts = r.integers(0, n_vocab, b).astype(np.int32)
    return syn0, syn1, centers, contexts


def _counted_model(cls, n_vocab, seed, **kw):
    """A model of ``cls`` in either package with a seeded vocabulary and
    counts (no fit)."""
    from collections import Counter
    m = cls(**kw)
    m.index2word = [f"w{i:03d}" for i in range(n_vocab)]
    m.vocab = {w: i for i, w in enumerate(m.index2word)}
    counts = np.random.default_rng(seed).integers(1, 1000, n_vocab)
    m.counts = Counter(dict(zip(m.index2word, counts.tolist())))
    return m


def _t(a):
    return torch.from_numpy(np.array(a)).to(
        torch.int64 if np.issubdtype(np.asarray(a).dtype, np.integer)
        else torch.float32)


def _jax_negatives(jax, jnp, cdf, key, b, neg, n_vocab):
    """The negatives the JAX step draws from ``key`` (its
    ``sample_negatives``)."""
    u = jax.random.uniform(key, (b, neg))
    return np.asarray(jnp.clip(jnp.searchsorted(cdf, u), 0, n_vocab - 1))


def test_ns_step_matches_jax_given_its_negatives():
    """One negative-sampling step (unigram^0.75 negatives, lr 0.3): the
    JAX jitted step from a key, the port's ``ns_update`` given the
    negatives that key draws; loss and both tables within 1e-6."""
    jax, jnp, jw, _ = _jax()
    n_vocab, d, b, neg = 60, 16, 64, 5
    jm = _counted_model(jw.Word2Vec, n_vocab, 1, negative=neg)
    syn0, syn1, c, x = _step_inputs(n_vocab, n_vocab, d, b, 2)
    key = jax.random.key(7)
    j0, j1, jl = jm._make_step(n_vocab)(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(c),
        jnp.asarray(x), jnp.asarray(0.3, jnp.float32), key)
    negs = _jax_negatives(jax, jnp, jm._unigram_cdf(n_vocab), key, b, neg,
                          n_vocab)
    p0, p1 = _t(syn0), _t(syn1)
    loss = w2v.ns_update(p0, p1, _t(c), _t(x), _t(negs), 0.3)
    np.testing.assert_allclose(float(loss), float(jl), rtol=0,
                               atol=STEP_TOL)
    np.testing.assert_allclose(p0.numpy(), np.asarray(j0), rtol=0,
                               atol=STEP_TOL)
    np.testing.assert_allclose(p1.numpy(), np.asarray(j1), rtol=0,
                               atol=STEP_TOL)


def test_hs_step_matches_jax():
    """One hierarchical-softmax step on the same Huffman tree: loss and
    both tables within 1e-6 (no random draws involved)."""
    jax, jnp, jw, _ = _jax()
    n_vocab, d, b = 45, 12, 48
    jm = _counted_model(jw.Word2Vec, n_vocab, 4, use_hierarchic_softmax=True)
    pm = _counted_model(Word2Vec, n_vocab, 4, use_hierarchic_softmax=True,
                        device="cpu")
    syn0, _, c, x = _step_inputs(n_vocab, n_vocab, d, b, 5)
    syn1 = (np.random.default_rng(6).normal(size=(n_vocab - 1, d)) * 0.1
            ).astype(np.float32)
    j0, j1, jl = jm._make_hs_step(n_vocab)(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(c),
        jnp.asarray(x), jnp.asarray(0.2, jnp.float32), jax.random.key(0))
    p0, p1 = _t(syn0), _t(syn1)
    loss = pm._make_hs_step(n_vocab)(p0, p1, _t(c), _t(x), 0.2, None)
    np.testing.assert_allclose(float(loss), float(jl), rtol=0,
                               atol=STEP_TOL)
    np.testing.assert_allclose(p0.numpy(), np.asarray(j0), rtol=0,
                               atol=STEP_TOL)
    np.testing.assert_allclose(p1.numpy(), np.asarray(j1), rtol=0,
                               atol=STEP_TOL)


def test_fasttext_subword_step_matches_jax_given_its_negatives():
    """One FastText step: the same subword table (FNV-1a buckets of the
    words' n-grams), the port given the JAX key's negatives; loss and
    both tables (word and bucket rows) within 1e-6."""
    jax, jnp, _, jf = _jax()
    n_vocab, bucket, d, b, neg = 40, 300, 8, 32, 4
    jm = _counted_model(jf.FastText, n_vocab, 8, negative=neg, bucket=bucket)
    pm = _counted_model(FastText, n_vocab, 8, negative=neg, bucket=bucket,
                        device="cpu")
    jm._build_subword_table()
    pm._build_subword_table()
    np.testing.assert_array_equal(pm.subword_table, jm.subword_table)
    np.testing.assert_array_equal(pm.subword_mask, jm.subword_mask)
    syn0, syn1, c, x = _step_inputs(n_vocab, n_vocab + bucket, d, b, 9)
    key = jax.random.key(3)
    j0, j1, jl = jm._make_step(n_vocab)(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(c),
        jnp.asarray(x), jnp.asarray(0.4, jnp.float32), key)
    negs = _jax_negatives(jax, jnp, jm._unigram_cdf(n_vocab), key, b, neg,
                          n_vocab)
    p0, p1 = _t(syn0), _t(syn1)
    loss = ft.subword_ns_update(p0, p1, _t(c), _t(x), _t(negs),
                                _t(pm.subword_table), _t(pm.subword_mask),
                                0.4)
    np.testing.assert_allclose(float(loss), float(jl), rtol=0,
                               atol=STEP_TOL)
    np.testing.assert_allclose(p0.numpy(), np.asarray(j0), rtol=0,
                               atol=STEP_TOL)
    np.testing.assert_allclose(p1.numpy(), np.asarray(j1), rtol=0,
                               atol=STEP_TOL)
    assert ft.fnv1a("cat") == jf.fnv1a("cat")
    assert ft.word_ngrams("cats", 3, 6) == jf.word_ngrams("cats", 3, 6)


def test_unigram_cdf_equal_jax_and_negatives_follow_it():
    """The same f32 CDF as the reference's, and the port's draws follow
    counts^0.75 (power 0: uniform, no table)."""
    _, _, jw, _ = _jax()
    jm = _counted_model(jw.Word2Vec, 3, 0)
    pm = _counted_model(Word2Vec, 3, 0, device="cpu")
    from collections import Counter
    for m in (jm, pm):
        m.counts = Counter({"w000": 1000, "w001": 100, "w002": 10})
    cdf = pm._unigram_cdf(3)
    np.testing.assert_array_equal(cdf.numpy(), np.asarray(jm._unigram_cdf(3)))
    gen = torch.Generator().manual_seed(0)
    s = w2v.sample_negatives(cdf, 3, 5, 10000, gen, "cpu")
    freq = np.bincount(s.numpy().ravel(), minlength=3) / s.numel()
    expect = np.array([1000.0, 100.0, 10.0]) ** 0.75
    np.testing.assert_allclose(freq, expect / expect.sum(), atol=0.01)
    pm.negative_table_power = 0.0
    assert pm._unigram_cdf(3) is None


# -- inside the port ----------------------------------------------------
@pytest.mark.parametrize("hs", [False, True], ids=["ns", "hs"])
def test_word2vec_embedding_quality(hs):
    rng = np.random.default_rng(1 if hs else 0)
    sents, a, b = _topic_corpus(rng)
    m = Word2Vec(vector_size=24, window_size=3, negative=5, epochs=10,
                 batch_size=128, learning_rate=1.0, seed=2 if hs else 1,
                 use_hierarchic_softmax=hs, device="cpu")
    losses = m.fit(sents)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * (0.85 if hs else 0.6)
    intra, inter = _quality(m, a, b)
    assert intra > inter + 0.3, (intra, inter)
    assert set(m.words_nearest("apple0", 4)) <= set(a)


def test_word2vec_subsampling_runs_end_to_end():
    sents, a, _ = _topic_corpus(np.random.default_rng(2))
    m = Word2Vec(vector_size=16, window_size=3, epochs=2, seed=3,
                 sampling=1e-2, device="cpu")
    assert np.isfinite(m.fit(sents)).all()
    assert m.has_word(a[0]) and m.syn0.shape == (len(m.vocab), 16)


def test_paragraph_vectors_separate_topics():
    animals = ["cat", "dog", "horse", "bird", "fish"]
    tech = ["cpu", "gpu", "code", "data", "chip"]
    rng = np.random.default_rng(3)
    docs = [" ".join(rng.choice(animals if rng.random() < 0.5 else tech, 6))
            for _ in range(60)]
    pv = ParagraphVectors(vector_size=12, negative=4, epochs=20,
                          learning_rate=1.0, seed=3, device="cpu")
    pv.fit(docs)
    is_animal = np.asarray([d.split()[0] in animals for d in docs])
    vecs = np.stack([pv.get_doc_vector(i) for i in range(len(docs))])
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True) + 1e-9
    a, t = vecs[is_animal], vecs[~is_animal]
    within = (a @ a.mean(0)).mean() + (t @ t.mean(0)).mean()
    across = (a @ t.mean(0)).mean() + (t @ a.mean(0)).mean()
    assert within > across, (within, across)
    assert pv.similarity("cat", "dog") > pv.similarity("cat", "gpu")


def test_fasttext_trains_ranks_topics_and_composes_oov():
    rng = np.random.default_rng(0)
    a = [f"apple{i}" for i in range(8)]
    b = [f"boat{i}" for i in range(8)]
    sents = [" ".join(rng.choice(a if rng.random() < 0.5 else b, 6))
             for _ in range(250)]
    m = FastText(vector_size=24, window_size=3, epochs=8, batch_size=128,
                 learning_rate=0.8, seed=1, bucket=5000, device="cpu")
    losses = m.fit(sents)
    assert losses[-1] < losses[0] * 0.8
    intra = np.mean([m.similarity(a[i], a[i + 1]) for i in range(0, 6, 2)])
    inter = np.mean([m.similarity(a[i], b[i]) for i in range(0, 6, 2)])
    assert intra > inter
    v = m.get_word_vector("apple999")                       # OOV
    assert v.shape == (24,) and np.isfinite(v).all()
    assert m.similarity("apple999", "apple0") > \
        m.similarity("apple999", "boat0")
    with pytest.raises(NotImplementedError, match="negative sampling"):
        FastText(use_hierarchic_softmax=True, device="cpu").fit(["a b c"])


def test_serializer_roundtrip_and_reads_the_jax_packages_file(tmp_path):
    """The text format round-trips in the port, and a file the JAX
    package writes reads back to the same vocabulary and vectors."""
    _, _, jw, _ = _jax()
    jser = importlib.import_module("deeplearning4j_tpu.nlp.serializer")
    sents, _, _ = _topic_corpus(np.random.default_rng(4), n_sent=50)
    m = Word2Vec(vector_size=8, epochs=2, seed=2, device="cpu")
    m.fit(sents)
    p = str(tmp_path / "vecs.txt")
    WordVectorSerializer.write_word_vectors(m, p)
    loaded = WordVectorSerializer.read_word_vectors(p)
    assert loaded.index2word == m.index2word
    np.testing.assert_allclose(loaded.get_word_vector("apple1"),
                               m.get_word_vector("apple1"), atol=1e-5)
    jm = jser.WordVectorSerializer.read_word_vectors(p)
    q = str(tmp_path / "jax.txt")
    jser.WordVectorSerializer.write_word_vectors(jm, q)
    again = WordVectorSerializer.read_word_vectors(q)
    assert again.index2word == m.index2word
    np.testing.assert_array_equal(again.syn0, loaded.syn0)
