"""The char-RNN in the port, held to the JAX package
(``tests/test_char_rnn.py`` and ``test_pretrained_weights.py``'s
``test_char_rnn_pretrained_generates`` ported): ``CharacterIterator``
yields the same batches (the numpy RNG is shared), the
``TextGenerationLSTM`` configuration is the reference's, the checked-in
``TextGenerationLSTM_pangrams.zip`` restores in both packages with the
same outputs and score (1e-5) and samples the same string, and a small
char-RNN trained with tBPTT follows the JAX package's loss curve (1e-5
relative) and samples in-vocabulary text."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.data import (CharacterIterator,  # noqa: E402
                                       sample_characters)
from deeplearning4j_torch.models.multi_layer_network import (  # noqa: E402
    MultiLayerNetwork)
from deeplearning4j_torch.nn.conf.builder import (  # noqa: E402
    MultiLayerConfiguration)
from deeplearning4j_torch.optimize import CollectScoresListener  # noqa: E402
from deeplearning4j_torch.utils.convert import (  # noqa: E402
    load_numpy_params)
from deeplearning4j_torch.utils.model_serializer import (  # noqa: E402
    restore_model)
from deeplearning4j_torch.zoo import TextGenerationLSTM  # noqa: E402

TEXT = ("the quick brown fox jumps over the lazy dog. " * 40)
ROOT = pathlib.Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "deeplearning4j_tpu" / "zoo" / "weights"
PANGRAMS = WEIGHTS / "TextGenerationLSTM_pangrams.zip"
PANGRAM_WORDS = ("the", "fox", "dog", "box", "quick", "jugs", "lazy")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread for each test: the recurrence is many
    small CPU ops, whose thread pools would starve each other under the
    suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    return pytest.importorskip("jax")


def _np_tree(tree):
    return _jax().tree_util.tree_map(np.asarray, tree)


def _vocab():
    with open(str(PANGRAMS) + ".json") as f:
        return json.load(f)["vocab"]


def test_char_iterator_shapes():
    it = CharacterIterator(TEXT, seq_length=20, batch=4)
    ds = next(iter(it))
    v = it.vocab_size
    assert ds.features.shape == (4, 20, v)
    assert ds.labels.shape == (4, 20, v)
    # labels are features shifted by one step
    f_idx = ds.features.argmax(-1)
    l_idx = ds.labels.argmax(-1)
    assert np.all(f_idx[:, 1:] == l_idx[:, :-1])


def test_char_iterator_batches_equal_jax():
    """Two epochs of batches (a fresh permutation each), the vocabulary,
    encode and decode: the same arrays as the JAX package's iterator."""
    _jax()
    from deeplearning4j_tpu.data.char_iterator import (
        CharacterIterator as JIterator)
    text = TEXT + "Pack my box with five dozen liquor jugs! "
    kw = dict(seq_length=17, batch=5, seed=9)
    p, j = CharacterIterator(text, **kw), JIterator(text, **kw)
    assert p.chars == j.chars and p.vocab_size == j.vocab_size
    for _ in range(2):
        pb, jb = list(p), list(j)
        assert len(pb) == len(jb) > 3
        for a, b in zip(pb, jb):
            assert np.array_equal(a.features, b.features)
            assert np.array_equal(a.labels, b.labels)
        p.reset()
        j.reset()
    assert np.array_equal(p.encode("fox"), j.encode("fox"))
    assert p.decode([3, 1, 4]) == j.decode([3, 1, 4])


def test_text_generation_lstm_conf_matches_jax():
    _jax()
    from deeplearning4j_tpu.zoo import TextGenerationLSTM as JModel
    for kw in ({}, dict(vocab_size=28, hidden=16, n_layers=1,
                        tbptt_length=10)):
        assert TextGenerationLSTM(**kw).conf().to_dict() == \
            JModel(**kw).conf().to_dict()
    net = TextGenerationLSTM().init_graph(device="cpu")
    # 2 x GravesLSTM(256) (W, R, b, P) + the [256, 77] head
    assert net.num_params() == (77 * 1024 + 256 * 1024 + 1024 + 3 * 256
                                + 256 * 1024 + 256 * 1024 + 1024
                                + 3 * 256 + 256 * 77 + 77)
    assert net.conf.backprop_type == "truncated_bptt"
    assert net.conf.tbptt_fwd_length == 50


def _pangram_batch(vocab):
    return next(iter(CharacterIterator(TEXT, seq_length=40, batch=4,
                                       valid_chars=vocab, seed=0)))


def test_pangrams_zip_outputs_and_score_match_jax():
    _jax()
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.zoo import load_pretrained
    jnet = load_pretrained("TextGenerationLSTM", "pangrams")
    net = restore_model(PANGRAMS, device="cpu")
    assert net.conf.to_dict() == jnet.conf.to_dict()
    ds = _pangram_batch(_vocab())
    np.testing.assert_allclose(net.output(ds.features).numpy(),
                               np.asarray(jnet.output(ds.features)),
                               rtol=1e-5, atol=1e-5)
    assert net.score(ds) == pytest.approx(
        jnet.score(JDataSet(ds.features, ds.labels)), rel=1e-5)


def test_char_rnn_pretrained_generates():
    """The pangrams zip samples the same 44 characters in both packages
    (the numpy RNG is shared); a trained pangram model keeps emitting
    in-vocabulary words.  On a divergence the message gives the two
    packages' probabilities of the two characters at the first
    differing position."""
    _jax()
    from deeplearning4j_tpu.data.char_iterator import (
        CharacterIterator as JIterator, sample_characters as jsample)
    from deeplearning4j_tpu.zoo import load_pretrained
    vocab = _vocab()
    it = CharacterIterator("".join(vocab), seq_length=10, batch=1,
                           valid_chars=vocab)
    net = restore_model(PANGRAMS, device="cpu")
    out = sample_characters(net, it, init="the ", n_chars=40,
                            temperature=0.3)
    assert len(out) == 44
    assert any(w in out for w in PANGRAM_WORDS), out
    jnet = load_pretrained("TextGenerationLSTM", "pangrams")
    ref = jsample(jnet, JIterator("".join(vocab), seq_length=10, batch=1,
                                  valid_chars=vocab),
                  init="the ", n_chars=40, temperature=0.3)
    if out != ref:
        k = next(i for i, (a, b) in enumerate(zip(out, ref)) if a != b)
        x = it.encode(out[:k])
        p = net.output(x).numpy()[0, -1]
        pj = np.asarray(jnet.output(x))[0, -1]
        a, b = it.char_to_idx[out[k]], it.char_to_idx[ref[k]]
        pytest.fail(f"samples differ at {k}: {out!r} vs {ref!r}; "
                    f"p(port) {p[a]:.8f} / {p[b]:.8f}, "
                    f"p(jax) {pj[a]:.8f} / {pj[b]:.8f}")


def test_char_rnn_learns_and_samples():
    """The reference's case, with the JAX model's initial parameters
    carried into the port: fifteen epochs of tBPTT 15 over t 30 in both
    packages, the port's loss curve within 1e-5 relative of the JAX
    package's, then the port's loss under 0.8x its first and its sample
    in the vocabulary."""
    _jax()
    from deeplearning4j_tpu.data.char_iterator import (
        CharacterIterator as JIterator)
    from deeplearning4j_tpu.optimize.listeners import (
        CollectScoresListener as JScores)
    from deeplearning4j_tpu.zoo import TextGenerationLSTM as JModel
    kw = dict(seq_length=30, batch=8, seed=1)
    it, jit = CharacterIterator(TEXT, **kw), JIterator(TEXT, **kw)
    jnet = JModel(vocab_size=it.vocab_size, hidden=64, n_layers=1,
                  tbptt_length=15, seed=5).init_graph()
    model = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jnet.conf.to_dict()))
    load_numpy_params(model, _np_tree(jnet.params_tree), device="cpu")
    scores, jscores = CollectScoresListener(), JScores()
    model.set_listeners(scores)
    jnet.set_listeners(jscores)
    first = model.fit(it, n_epochs=1, async_prefetch=False)
    jnet.fit(jit, n_epochs=1, async_prefetch=False)
    for _ in range(14):
        last = model.fit(it, n_epochs=1, async_prefetch=False)
        jnet.fit(jit, n_epochs=1, async_prefetch=False)
    assert [i for i, _ in scores.scores] == [i for i, _ in jscores.scores]
    assert len(scores.scores) == 15 * 7 * 2
    np.testing.assert_allclose([s for _, s in scores.scores],
                               [s for _, s in jscores.scores], rtol=1e-5)
    assert last < first * 0.8, (first, last)
    text = sample_characters(model, it, init="the ", n_chars=40,
                             temperature=0.5)
    assert len(text) == 44
    assert all(c in it.char_to_idx for c in text)


def test_rnn_phase_rehearsal_on_cpu(monkeypatch):
    """``chip_smoke.py``'s rnn phase whole on the CPU at a tiny width (2 x
    8 GravesLSTM, 2,000 characters of its corpus at t 100, batch 8, tBPTT
    5: the card's 2 epochs x 2 batches x 20 chunks): the CPU f32 against
    f64 within the phase's bounds, the pangrams zip, the main path's
    counters and carry clearing, the preemption after iteration 59 (in
    the second epoch) and a bit-equal resume, the yardstick against torch.nn.LSTM.  The profiled
    chunk and the peak memory are the card's only."""
    import chip_smoke
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    cfg = dict(chip_smoke.RNN_CFG, hidden=8, seq_length=100, batch=8,
               tbptt=5)
    text, chars = chip_smoke.rnn_corpus(str(ROOT), 2000)
    assert len(chars) == 77
    row = chip_smoke.rnn_parts(torch, np, "cpu", cfg, text, chars,
                               lambda: None, "cpu", str(ROOT))
    assert lines == [row]
    c, d = row["c_main_path"], row["d_resume"]
    assert (c["iterations"], c["batches_per_epoch"],
            c["chunks_per_batch"]) == (80, 2, 20)
    assert c["checks"]["cleared_at_iterations"] == [20, 40, 60, 80]
    assert c["peak_allocated_bytes_above_start"] is None
    assert d["preempted_at"] == 59 and d["params_and_adam_equal_bitwise"]
    assert d["resumed_losses_equal"] and d["iteration_count"] == 80
    assert row["b_pangrams"]["sample_equal_to_cpu"]
    assert set(row["e_timings"]) == {"yardstick"}
