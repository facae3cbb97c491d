"""The port's ``Ema`` wrapper updater against the JAX package's
(``tests/test_ema.py``): the recursion of update + finalize, the average
taken after decoupled weight decay, the JSON round trip, and training a
``MultiLayerNetwork`` — each held to the JAX package on the same numpy
inputs and parameters (f32; 1e-6 on the small recursions, 1e-5 after
ten Adam fit steps).  The sharded-trainer case comes with the training
scale-out slice."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.optimize import Adam, Ema, Sgd  # noqa: E402
from deeplearning4j_torch.optimize import updater_from_dict  # noqa: E402
from deeplearning4j_torch.utils.trees import iter_leaves  # noqa: E402


def _pair(updater, weight_decay=None):
    """A JAX 8-16-3 MLP and the port's copy of it (same parameters)."""
    import jax

    from deeplearning4j_tpu import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf.layers_core import (DenseLayer as JDense,
                                                        OutputLayer as JOut)

    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf.builder import MultiLayerConfiguration
    from deeplearning4j_torch.utils import load_numpy_params
    b = JNNC.builder().seed(3).updater(updater)
    if weight_decay:
        b = b.weight_decay(weight_decay)
    jconf = (b.list()
             .layer(JDense(n_in=8, n_out=16, activation="relu"))
             .layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
             .build())
    jnet = JMLN(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jconf.to_dict())).init(device="cpu")
    load_numpy_params(pnet, jax.tree_util.tree_map(
        np.asarray, jnet.params_tree), device="cpu")
    return jnet, pnet


def _close(got, want, atol):
    import jax
    want = dict(iter_leaves(jax.tree_util.tree_map(np.asarray, want)))
    got = dict(iter_leaves(got))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[path], rtol=0, atol=atol,
                                   err_msg="/".join(path))


def test_ema_math_matches_manual_recursion():
    """update() + finalize() tracks the ACTUAL new parameters, in both
    packages."""
    pytest.importorskip("jax")
    from deeplearning4j_tpu.optimize import Ema as JEma
    from deeplearning4j_tpu.optimize import Sgd as JSgd
    u = Ema(base=Sgd(learning_rate=0.5), decay=0.8)
    ju = JEma(base=JSgd(learning_rate=0.5), decay=0.8)
    params = {"w": torch.tensor([1.0, 2.0])}
    jparams = {"w": np.asarray([1.0, 2.0], np.float32)}
    state, jstate = u.init_state(params), ju.init_state(jparams)
    np.testing.assert_allclose(state["ema"]["w"].numpy(), [1.0, 2.0])
    # the average is a copy: the solver updates params in place
    assert state["ema"]["w"].data_ptr() != params["w"].data_ptr()
    ema_ref, p_ref = np.array([1.0, 2.0]), np.array([1.0, 2.0])
    for step in range(3):
        g = np.asarray([0.2, -0.4], np.float32)
        updates, state = u.update({"w": torch.from_numpy(g)}, state,
                                  params, step)
        params = {"w": params["w"] - updates["w"]}
        state = u.finalize(state, params)
        jup, jstate = ju.update({"w": g}, jstate, jparams, step)
        jparams = {"w": jparams["w"] - jup["w"]}
        jstate = ju.finalize(jstate, jparams)
        p_ref = p_ref - 0.5 * np.array([0.2, -0.4])
        ema_ref = 0.8 * ema_ref + 0.2 * p_ref
        np.testing.assert_allclose(params["w"].numpy(), p_ref, atol=1e-6)
        np.testing.assert_allclose(
            Ema.params_from_state(state)["w"].numpy(), ema_ref, atol=1e-6)
        _close(Ema.params_from_state(state), JEma.params_from_state(jstate),
               1e-6)


def test_ema_tracks_post_weight_decay_params():
    """With decoupled weight decay the solver folds lr*wd*p into the
    update AFTER updater.update: the average tracks the decayed params
    exactly (decay=0 => identity), in both packages."""
    pytest.importorskip("jax")
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet

    from deeplearning4j_torch.data import DataSet
    jnet, pnet = _pair({"type": "Ema", "decay": 0.0,
                        "base": {"type": "Sgd", "learning_rate": 0.1}},
                       weight_decay=0.2)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    for _ in range(3):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
    for (_, e), (_, p) in zip(iter_leaves(Ema.params_from_state(
            pnet.opt_state)), iter_leaves(pnet.params_tree)):
        np.testing.assert_allclose(e.numpy(), p.numpy(), atol=1e-7)
    _close(pnet.params_tree, jnet.params_tree, 1e-6)
    _close(Ema.params_from_state(pnet.opt_state),
           jnet.opt_state["ema"], 1e-6)


def test_ema_serialization_roundtrip():
    u = Ema(base=Adam(learning_rate=1e-2), decay=0.9)
    d = u.to_dict()
    u2 = updater_from_dict(d)
    assert isinstance(u2, Ema)
    assert isinstance(u2._resolved(), Adam)
    assert u2.decay == 0.9
    assert u2._resolved().learning_rate == 1e-2
    pytest.importorskip("jax")
    from deeplearning4j_tpu.optimize import Adam as JAdam
    from deeplearning4j_tpu.optimize import Ema as JEma
    assert JEma(base=JAdam(learning_rate=1e-2), decay=0.9).to_dict() == d


def test_ema_in_multi_layer_network_training():
    """Ten Adam fit steps under Ema(decay 0.5): the average exists for
    every parameter, lags the raw weights, serves as weights, and equals
    the JAX package's within 1e-5."""
    pytest.importorskip("jax")
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet

    from deeplearning4j_torch.data import DataSet
    jnet, pnet = _pair({"type": "Ema", "decay": 0.5,
                        "base": {"type": "Adam", "learning_rate": 1e-2}})
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    for _ in range(10):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
    ema = Ema.params_from_state(pnet.opt_state)
    pairs = list(zip(iter_leaves(ema), iter_leaves(pnet.params_tree)))
    assert pairs
    for (_, e), (_, p) in pairs:
        assert e.shape == p.shape
        assert not torch.allclose(e, p, atol=1e-8)       # lags behind
    _close(ema, jnet.opt_state["ema"], 1e-5)
    _close(pnet.params_tree, jnet.params_tree, 1e-5)
    pnet.params_tree = ema                               # usable as weights
    out = pnet.output(x).numpy()
    assert out.shape == (64, 3)
    np.testing.assert_allclose(out.sum(1), 1.0, atol=1e-5)
