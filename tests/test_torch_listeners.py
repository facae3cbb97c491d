"""The port's remaining listeners and ``ExistingDataSetIterator`` against
the JAX package (``deeplearning4j_tpu/optimize/listeners.py``,
``data/iterator.py``): the zip ``CheckpointListener``'s keep-last-K
rotation (``tests/test_serialization.py``'s case) with the port's newest
zip restored by the JAX package, ``EvaluativeListener`` and
``TimeIterationListener`` on a fit from the JAX net's parameters, and
``ExistingDataSetIterator`` over a list and a factory.  Scores,
evaluations and restored parameters agree within 1e-5 (f32)."""
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.data import (DataSet,  # noqa: E402
                                       ExistingDataSetIterator,
                                       ListDataSetIterator)
from deeplearning4j_torch.optimize import (  # noqa: E402
    CollectScoresListener, EvaluativeListener, TimeIterationListener)
from deeplearning4j_torch.optimize.listeners import (  # noqa: E402
    CheckpointListener)


def _pair():
    """A JAX 6-10-3 MLP and the port's copy (same parameters)."""
    import jax

    from deeplearning4j_tpu import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf.layers_core import (DenseLayer as JDense,
                                                        OutputLayer as JOut)

    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf.builder import MultiLayerConfiguration
    from deeplearning4j_torch.utils import load_numpy_params
    jconf = (JNNC.builder().seed(11)
             .updater({"type": "Nadam", "learning_rate": 1e-2}).list()
             .layer(JDense(n_in=6, n_out=10, activation="tanh"))
             .layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
             .build())
    jnet = JMLN(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jconf.to_dict())).init(device="cpu")
    load_numpy_params(pnet, jax.tree_util.tree_map(
        np.asarray, jnet.params_tree), device="cpu")
    return jnet, pnet


def _batches(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(8, 6)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(n)]


def test_zip_checkpoint_listener_rotation_restores_in_jax(tmp_path):
    """Every epoch a zip, the last two kept; the port's newest zip
    restores in the JAX package with the port's parameters, updater
    state and counters."""
    pytest.importorskip("jax")
    import jax

    from deeplearning4j_tpu.utils.model_serializer import restore_model
    _, pnet = _pair()
    d = tmp_path / "ckpts"
    pnet.set_listeners(CheckpointListener(d, every_n_epochs=1, keep_last=2))
    pnet.fit(ListDataSetIterator([DataSet(*b) for b in _batches()]),
             n_epochs=5, async_prefetch=False)
    files = sorted(os.listdir(d))
    assert files == ["checkpoint_epoch_3.zip", "checkpoint_epoch_4.zip"]
    jnet = restore_model(str(d / files[-1]))
    assert jnet.epoch_count == 5 and jnet.iteration_count == 20
    flat = jax.tree_util.tree_leaves(jnet.params_tree)
    np.testing.assert_array_equal(np.concatenate(
        [np.asarray(a).ravel() for a in flat]), pnet.params())
    m = jax.tree_util.tree_leaves(jnet.opt_state["m"])
    np.testing.assert_array_equal(
        np.asarray(m[0]), pnet.opt_state["m"]["layer_0"]["W"].numpy())


def test_iteration_zips_and_evaluative_listener_track_jax(tmp_path, caplog):
    """Zips every 3 iterations; an evaluation every epoch and every 2
    iterations; the ETA log; the same fit in JAX gives the same scores
    and the same final evaluation."""
    pytest.importorskip("jax")
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.data.iterator import ListDataSetIterator as JList
    from deeplearning4j_tpu.optimize.listeners import (
        CollectScoresListener as JScores, EvaluativeListener as JEval)
    jnet, pnet = _pair()
    data = _batches()
    held = _batches(seed=1, n=2)
    ev_epoch = EvaluativeListener(
        ListDataSetIterator([DataSet(*b) for b in held]))
    ev_iter = EvaluativeListener(
        ListDataSetIterator([DataSet(*b) for b in held]), frequency=2,
        unit="iteration")
    scores = CollectScoresListener()
    ck = CheckpointListener(tmp_path / "it", every_n_iterations=3)
    eta = TimeIterationListener(total_iterations=8, frequency=4)
    pnet.set_listeners(scores, ev_epoch, ev_iter, ck, eta)
    with caplog.at_level(logging.INFO, logger="deeplearning4j_torch"):
        pnet.fit(ListDataSetIterator([DataSet(*b) for b in data]),
                 n_epochs=2)
    assert sorted(os.listdir(tmp_path / "it")) == [
        "checkpoint_iter_3.zip", "checkpoint_iter_6.zip"]
    assert [r.getMessage().split(",")[0] for r in caplog.records
            if "ETA" in r.getMessage()] == ["iteration 4/8", "iteration 8/8"]
    jscores = JScores()
    jev = JEval(JList([JDataSet(*b) for b in held]))
    jev_iter = JEval(JList([JDataSet(*b) for b in held]), frequency=2,
                     unit="iteration")
    jnet.set_listeners(jscores, jev, jev_iter)
    jnet.fit(JList([JDataSet(*b) for b in data]), n_epochs=2)
    np.testing.assert_allclose([s for _, s in scores.scores],
                               [s for _, s in jscores.scores], rtol=1e-5)
    for pev, jev in ((ev_epoch, jev), (ev_iter, jev_iter)):
        assert pev.last_evaluation.accuracy() == pytest.approx(
            jev.last_evaluation.accuracy())
        np.testing.assert_array_equal(pev.last_evaluation.confusion,
                                      jev.last_evaluation.confusion)


def test_existing_dataset_iterator_over_a_list_and_a_factory():
    """Over a list it replays after reset; over a factory each pass asks
    for a fresh iterable; fit on either equals fit on ListDataSetIterator
    (bit for bit, the same batches in the same order)."""
    data = [DataSet(*b) for b in _batches()]
    it = ExistingDataSetIterator(data)
    assert [d.num_examples() for d in it] == [8, 8, 8, 8]
    it.reset()
    assert len(list(it)) == 4
    calls = []

    def factory():
        calls.append(1)
        return (d for d in data[:3])

    fit = ExistingDataSetIterator(factory)
    assert len(list(fit)) == 3 and len(list(fit)) == 3 and len(calls) == 2
    losses = []
    for src in (ExistingDataSetIterator(data), ListDataSetIterator(data)):
        _, pnet = _pair()
        losses.append(pnet.fit(src, n_epochs=2))
        assert pnet.iteration_count == 8
    assert losses[0] == losses[1]
