"""Evaluation in the PyTorch port (``deeplearning4j_torch.eval``, numpy
only): the reference suite's seven hand-computed cases
(``tests/test_eval.py``), each metric also equal to the JAX package's on
the same arrays; then ``MultiLayerNetwork.evaluate`` (with each batch's
features mask) and ``evaluate_roc`` on a tiny Bert at t 512 (the flash
route), equal to the JAX package's on the same parameters and batches —
the same confusion matrix, accuracy within 1e-12 and AUCs within 1e-6."""
import numpy as np
import pytest

from deeplearning4j_torch.eval import (ROC, Evaluation, EvaluationBinary,
                                       EvaluationCalibration,
                                       RegressionEvaluation, ROCMultiClass)


def test_evaluation_confusion_and_accuracy():
    ev = Evaluation()
    labels = np.eye(3)[[0, 0, 1, 1, 2, 2]]
    preds = np.eye(3)[[0, 1, 1, 1, 2, 0]]  # 4/6 correct
    ev.eval(labels, preds + 0.01)
    assert abs(ev.accuracy() - 4 / 6) < 1e-9
    assert ev.confusion[0, 1] == 1 and ev.confusion[2, 0] == 1
    assert ev.confusion[1, 1] == 2


def test_evaluation_streaming_merge_equivalence():
    rng = np.random.default_rng(0)
    labels = np.eye(4)[rng.integers(0, 4, 100)]
    preds = rng.random((100, 4))
    full = Evaluation()
    full.eval(labels, preds)
    a, b = Evaluation(), Evaluation()
    a.eval(labels[:50], preds[:50])
    b.eval(labels[50:], preds[50:])
    a.merge(b)
    assert np.array_equal(a.confusion, full.confusion)


def test_precision_recall_f1_binary_case():
    ev = Evaluation()
    # class1: tp=2 fp=1 fn=1
    labels = np.eye(2)[[1, 1, 1, 0, 0]]
    preds = np.eye(2)[[1, 1, 0, 1, 0]]
    ev.eval(labels, preds + 1e-3)
    assert abs(ev.precision(1) - 2 / 3) < 1e-9
    assert abs(ev.recall(1) - 2 / 3) < 1e-9


def test_roc_auc_perfect_and_random():
    roc = ROC()
    labels = np.array([1, 1, 1, 0, 0, 0])
    perfect = np.array([0.9, 0.8, 0.7, 0.3, 0.2, 0.1])
    roc.eval(labels, perfect)
    assert abs(roc.calculate_auc() - 1.0) < 1e-9
    roc2 = ROC()
    roc2.eval(labels, 1 - perfect)
    assert roc2.calculate_auc() < 0.01


def test_roc_histogram_mode_approximates_exact():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 2, 3000)
    scores = np.clip(labels * 0.3 + rng.normal(0.35, 0.25, 3000), 0, 1)
    exact, hist = ROC(exact=True), ROC(exact=False, n_bins=200)
    exact.eval(labels, scores)
    hist.eval(labels, scores)
    assert abs(exact.calculate_auc() - hist.calculate_auc()) < 0.02


def test_regression_eval_r2_and_mse():
    ev = RegressionEvaluation()
    labels = np.array([[1.0], [2.0], [3.0], [4.0]])
    preds = np.array([[1.1], [1.9], [3.2], [3.8]])
    ev.eval(labels, preds)
    expect_mse = np.mean((preds - labels) ** 2)
    assert abs(ev.mean_squared_error(0) - expect_mse) < 1e-9
    assert ev.r_squared(0) > 0.95
    assert ev.pearson_correlation(0) > 0.99


def test_evaluation_binary_per_output():
    ev = EvaluationBinary()
    labels = np.array([[1, 0], [1, 1], [0, 0], [0, 1]])
    preds = np.array([[0.9, 0.1], [0.8, 0.4], [0.3, 0.2], [0.1, 0.9]])
    ev.eval(labels, preds)
    assert ev.accuracy(0) == 1.0
    assert abs(ev.recall(1) - 0.5) < 1e-9


# -- against the JAX package -------------------------------------------
@pytest.fixture(scope="module")
def jeval():
    pytest.importorskip("jax")
    import deeplearning4j_tpu.eval as jeval
    return jeval


def test_every_metric_equals_jax(jeval):
    rng = np.random.default_rng(11)
    labels = np.eye(3)[rng.integers(0, 3, 200)]
    preds = rng.random((200, 3))
    mask = (rng.random(200) > 0.1).astype(np.float32)
    for top_n in (1, 2):
        a, b = Evaluation(top_n=top_n), jeval.Evaluation(top_n=top_n)
        a.eval(labels, preds, mask)
        b.eval(labels, preds, mask)
        assert np.array_equal(a.confusion, b.confusion)
        assert a.stats() == b.stats()
        assert a.top_n_accuracy() == b.top_n_accuracy()
        for c in (None, 0, 1, 2):
            assert a.precision(c) == b.precision(c)
            assert a.recall(c) == b.recall(c)
            assert a.f1(c) == b.f1(c)
    for exact in (True, False):
        r, jr = ROCMultiClass(exact=exact), jeval.ROCMultiClass(exact=exact)
        r.eval(labels, preds)
        jr.eval(labels, preds)
        assert r.calculate_average_auc() == jr.calculate_average_auc()
    bl = (rng.random((50, 4)) > 0.5).astype(np.float32)
    bp = rng.random((50, 4))
    e, je = EvaluationBinary(), jeval.EvaluationBinary()
    e.eval(bl, bp)
    je.eval(bl, bp)
    assert e.stats() == je.stats()
    y = rng.normal(size=(40, 2))
    yp = y + rng.normal(scale=0.3, size=(40, 2))
    r, jr = RegressionEvaluation(), jeval.RegressionEvaluation()
    r.eval(y, yp)
    jr.eval(y, yp)
    assert r.stats() == jr.stats()
    c, jc = EvaluationCalibration(), jeval.EvaluationCalibration()
    c.eval(labels, preds)
    jc.eval(labels, preds)
    assert c.stats() == jc.stats()


def test_network_evaluate_and_roc_equal_jax_on_tiny_bert(jeval):
    """evaluate (features masks passed to output) and evaluate_roc on a
    tiny Bert at t 512 over two padded batches: the port's evaluators
    see the same predictions as the JAX package's, up to f32 rounding,
    so the confusion matrices are equal."""
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.data.iterator import (
        ListDataSetIterator as JList)
    from deeplearning4j_tpu.zoo import Bert as JBert
    from deeplearning4j_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_torch.utils import load_numpy_params
    from deeplearning4j_torch.zoo import Bert
    kw = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, vocab_size=120,
              seq_len=512, max_len=512, compute_dtype=None, seed=3)
    jnet = JBert(**kw).init_graph()
    pnet = load_numpy_params(Bert(**kw).init_graph(device="cpu"),
                             jax.tree_util.tree_map(np.asarray,
                                                    jnet.params_tree),
                             device="cpu")
    rng = np.random.default_rng(12)
    batches = []
    for _ in range(2):
        x = rng.integers(0, 120, (4, 512)).astype(np.int32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
        m = np.ones((4, 512), np.float32)
        for r in range(4):
            m[r, rng.integers(64, 513):] = 0.0
        batches.append((x, y, m))
    pit = ListDataSetIterator([DataSet(*b) for b in batches])
    jit = JList([JDataSet(*b) for b in batches])
    ev, jev = pnet.evaluate(pit), jnet.evaluate(jit)
    assert ev.confusion.sum() == 8
    assert np.array_equal(ev.confusion, jev.confusion)
    assert abs(ev.accuracy() - jev.accuracy()) < 1e-12
    # the confusion matrix is the argmax of output() over the batches
    want = np.zeros((2, 2), np.int64)
    for x, y, m in batches:
        pred = pnet.output(x, features_mask=m).numpy().argmax(-1)
        np.add.at(want, (y.argmax(-1), pred), 1)
    assert np.array_equal(ev.confusion, want)
    roc, jroc = pnet.evaluate_roc(pit), jnet.evaluate_roc(jit)
    for c in (0, 1):
        assert roc.calculate_auc(c) == pytest.approx(jroc.calculate_auc(c),
                                                     abs=1e-6)


def test_network_evaluate_regression_equals_jax(jeval):
    """evaluate_regression on a small dense regressor, the JAX package's
    parameters carried across: the same per-column statistics."""
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.data.iterator import (
        ListDataSetIterator as JList)
    from deeplearning4j_tpu.models.multi_layer_network import (
        MultiLayerNetwork as JMLN)
    from deeplearning4j_tpu.nn.conf.builder import (
        NeuralNetConfiguration as JNNC)
    from deeplearning4j_tpu.nn.conf.layers_core import (
        DenseLayer as JDense, OutputLayer as JOut)
    from deeplearning4j_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf import (DenseLayer,
                                              NeuralNetConfiguration,
                                              OutputLayer)
    from deeplearning4j_torch.utils import load_numpy_params

    def conf(nnc, dense, out):
        return (nnc.builder().seed(5).list()
                .layer(dense(n_in=4, n_out=8, activation="tanh"))
                .layer(out(n_out=2, activation="identity", loss="mse"))
                .build())
    jnet = JMLN(conf(JNNC, JDense, JOut)).init()
    pnet = load_numpy_params(
        MultiLayerNetwork(conf(NeuralNetConfiguration, DenseLayer,
                               OutputLayer)).init(device="cpu"),
        jax.tree_util.tree_map(np.asarray, jnet.params_tree), device="cpu")
    rng = np.random.default_rng(13)
    data = [(rng.normal(size=(16, 4)).astype(np.float32),
             rng.normal(size=(16, 2)).astype(np.float32)) for _ in range(3)]
    ev = pnet.evaluate_regression(ListDataSetIterator(
        [DataSet(x, y) for x, y in data]))
    jev = jnet.evaluate_regression(JList([JDataSet(x, y) for x, y in data]))
    for c in (0, 1):
        assert ev.mean_squared_error(c) == pytest.approx(
            jev.mean_squared_error(c), rel=1e-5)
        assert ev.r_squared(c) == pytest.approx(jev.r_squared(c), rel=1e-5,
                                                abs=1e-6)
