"""The port's updaters against the JAX package's (``tests/test_updaters.py``
ported, plus the cross-package runs).

Every updater — the six of this slice (AMSGrad, Nadam, AdaMax, RmsProp,
AdaGrad, Ema over Adam and over AdamW) and the earlier ones — runs five
steps on the same numpy-seeded parameter and gradient sequence in both
packages (``update`` then ``params - updates`` then ``finalize``, the
solver's order); updates and state agree at rtol 1e-6 (f32, the same
operations in the same order; the bias corrections in f32 on the host
where the reference traces them).  A configuration JSON the JAX package
writes, naming each updater, loads in the port and takes one fit step
equal to JAX's within 1e-5.  The closed-form numpy checks of the
reference run on the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.optimize import updaters as pupd  # noqa: E402
from deeplearning4j_torch.optimize.updaters import (  # noqa: E402
    AdaDelta, AdaGrad, AdaMax, Adam, AdamW, AMSGrad, Ema, Nadam, Nesterovs,
    RmsProp, Sgd, updater_from_dict)
from deeplearning4j_torch.utils.trees import iter_leaves  # noqa: E402

CASES = {
    "AMSGrad": {"type": "AMSGrad", "learning_rate": 3e-3},
    "Nadam": {"type": "Nadam", "learning_rate": 3e-3, "beta1": 0.85},
    "AdaMax": {"type": "AdaMax", "learning_rate": 2e-3},
    "RmsProp": {"type": "RmsProp", "learning_rate": 1e-2,
                "rms_decay": 0.9},
    "AdaGrad": {"type": "AdaGrad", "learning_rate": 5e-2},
    "EmaAdam": {"type": "Ema", "decay": 0.7,
                "base": {"type": "Adam", "learning_rate": 3e-3}},
    "EmaAdamW": {"type": "Ema", "decay": 0.9,
                 "base": {"type": "AdamW", "learning_rate": 3e-3,
                          "weight_decay": 0.05}},
    "Sgd": {"type": "Sgd", "learning_rate": 0.1},
    "Nesterovs": {"type": "Nesterovs", "learning_rate": 0.05},
    "Adam": {"type": "Adam", "learning_rate": 3e-3},
    "AdamW": {"type": "AdamW", "learning_rate": 3e-3, "weight_decay": 0.05},
    "AdaDelta": {"type": "AdaDelta"},
    "NoOp": {"type": "NoOp"},
}


def _tree(rng):
    return {"a": {"W": rng.normal(size=(4, 3)).astype(np.float32)},
            "b": {"b": rng.normal(size=(5,)).astype(np.float32)},
            "c": {}}


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _tt(tree):
    return {k: _tt(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _assert_trees(got, want, what):
    want = dict(iter_leaves(_np(want)))
    got = dict(iter_leaves(got))
    assert set(got) == set(want), what
    for path, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-6,
                                   atol=1e-8,
                                   err_msg=f"{what}: {'/'.join(path)}")


@pytest.mark.parametrize("case", list(CASES))
def test_five_steps_match_jax(case):
    """Five update + finalize steps on one numpy sequence in both
    packages: updates and state within rtol 1e-6."""
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.optimize import updaters as jupd
    rng = np.random.default_rng(list(CASES).index(case))
    params = _tree(rng)
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        for _ in range(5)]
    ju = jupd.updater_from_dict(CASES[case])
    pu = pupd.updater_from_dict(CASES[case])
    assert pu.to_dict() == ju.to_dict()
    jp, pp = params, _tt(params)
    js, ps = ju.init_state(jp), pu.init_state(pp)
    for step, g in enumerate(grads):
        jup, js = ju.update(g, js, jp, step)
        pup, ps = pu.update(_tt(g), ps, pp, step)
        _assert_trees(pup, jup, f"step {step} updates")
        jp = jax.tree_util.tree_map(lambda p, u: p - u, jp, jup)
        pp = {k: {n: p - pup[k][n] for n, p in v.items()}
              for k, v in pp.items()}
        js, ps = ju.finalize(js, jp), pu.finalize(ps, pp)
        _assert_trees(ps, js, f"step {step} state")


@pytest.mark.parametrize("case", ["AMSGrad", "Nadam", "AdaMax", "RmsProp",
                                  "AdaGrad", "EmaAdam", "EmaAdamW"])
def test_jax_written_config_loads_and_steps_in_port(case):
    """The JAX package's configuration JSON naming the updater loads in
    the port (the same updater, the same JSON back), and one fit step
    from the same parameters and optimizer state agrees within 1e-5."""
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.nn.conf.layers_core import (DenseLayer as JDense,
                                                        OutputLayer as JOut)

    from deeplearning4j_torch.data import DataSet
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf.builder import MultiLayerConfiguration
    from deeplearning4j_torch.utils import (load_numpy_opt_state,
                                            load_numpy_params)
    jconf = (JNNC.builder().seed(7).updater(CASES[case]).list()
             .layer(JDense(n_in=6, n_out=8, activation="tanh"))
             .layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
             .build())
    pconf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert pconf.to_dict() == jconf.to_dict()
    pu = updater_from_dict(pconf.global_conf.updater)
    assert type(pu).__name__ == CASES[case]["type"]
    rng = np.random.default_rng(3)
    batches = [(rng.normal(size=(10, 6)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)])
               for _ in range(2)]
    jnet = JMLN(jconf).init()
    jnet.fit(JDataSet(*batches[0]))          # non-trivial optimizer state
    pnet = MultiLayerNetwork(pconf).init(device="cpu")
    load_numpy_params(pnet, _np(jnet.params_tree), device="cpu")
    load_numpy_opt_state(pnet, _np(jnet.opt_state))
    pnet.iteration_count = jnet.iteration_count
    jl = jnet.fit(JDataSet(*batches[1]))
    pl = pnet.fit(DataSet(*batches[1]))
    assert pl == pytest.approx(jl, rel=1e-5)
    want = dict(iter_leaves(_np(jnet.params_tree)))
    for path, t in iter_leaves(pnet.params_tree):
        np.testing.assert_allclose(t.numpy(), want[path], rtol=0, atol=1e-5)
    _assert_opt_close(pnet.opt_state, jnet.opt_state)


def _assert_opt_close(got, want):
    want = dict(iter_leaves(_np(want)))
    for path, t in iter_leaves(got):
        np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-5,
                                   atol=1e-7, err_msg="/".join(path))


# -- the reference's closed-form checks, on the port ------------------------
def _p():
    return {"W": torch.tensor([1.0, -2.0, 3.0]), "b": torch.tensor([0.5])}


def _g():
    return {"W": torch.tensor([0.1, -0.2, 0.3]), "b": torch.tensor([0.05])}


def test_sgd_step():
    u = Sgd(learning_rate=0.5)
    updates, _ = u.update(_g(), u.init_state(_p()), _p(), 0)
    np.testing.assert_allclose(updates["W"], [0.05, -0.1, 0.15], rtol=1e-6)


def test_adam_two_steps_match_numpy():
    lr, b1, b2, eps = 1e-2, 0.9, 0.999, 1e-8
    u = Adam(learning_rate=lr, beta1=b1, beta2=b2, epsilon=eps)
    params, grads = _p(), _g()
    st = u.init_state(params)
    m = v = np.zeros(3)
    g = grads["W"].numpy()
    for t in range(1, 3):
        upd, st = u.update(grads, st, params, t - 1)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        alpha = lr * np.sqrt(1 - b2**t) / (1 - b1**t)
        np.testing.assert_allclose(upd["W"].numpy(),
                                   alpha * m / (np.sqrt(v) + eps),
                                   rtol=2e-5)


def test_nesterovs_lookahead():
    lr, mu = 0.1, 0.9
    u = Nesterovs(learning_rate=lr, momentum=mu)
    upd, _ = u.update(_g(), u.init_state(_p()), _p(), 0)
    g = _g()["W"].numpy()
    np.testing.assert_allclose(upd["W"].numpy(),
                               -(mu * (-lr * g) - lr * g), rtol=1e-6)


def test_adagrad_accumulates():
    u = AdaGrad(learning_rate=0.1, epsilon=1e-6)
    params, grads = _p(), _g()
    st = u.init_state(params)
    upd1, st = u.update(grads, st, params, 0)
    upd2, st = u.update(grads, st, params, 1)
    # the second step divides by the root of a doubled accumulator
    assert bool((upd2["W"].abs() < upd1["W"].abs()).all())


def test_rmsprop_matches_numpy():
    lr, d, eps = 0.01, 0.95, 1e-8
    u = RmsProp(learning_rate=lr, rms_decay=d, epsilon=eps)
    upd, _ = u.update(_g(), u.init_state(_p()), _p(), 0)
    g = _g()["W"].numpy()
    np.testing.assert_allclose(upd["W"].numpy(),
                               lr * g / (np.sqrt((1 - d) * g * g) + eps),
                               rtol=1e-5)


def test_adamw_decoupled_decay():
    u = AdamW(learning_rate=1e-3, weight_decay=0.1)
    base = Adam(learning_rate=1e-3)
    uw, _ = u.update(_g(), u.init_state(_p()), _p(), 0)
    ua, _ = base.update(_g(), base.init_state(_p()), _p(), 0)
    np.testing.assert_allclose((uw["W"] - ua["W"]).numpy(),
                               1e-3 * 0.1 * _p()["W"].numpy(), rtol=1e-5)


@pytest.mark.parametrize("cls", [Sgd, Adam, AdamW, AdaMax, Nesterovs,
                                 RmsProp, AdaGrad, AdaDelta, AMSGrad, Nadam,
                                 Ema])
def test_serialization_roundtrip(cls):
    u = cls()
    d = u.to_dict()
    u2 = updater_from_dict(d)
    assert type(u2) is cls
    assert u2.to_dict() == d


@pytest.mark.parametrize("cls", [Adam, AdaMax, Nesterovs, RmsProp, AdaGrad,
                                 AdaDelta, AMSGrad, Nadam])
def test_all_updaters_decrease_simple_quadratic(cls):
    # minimize ||w||^2 / 2: the gradient is w
    u = cls(learning_rate=0.05)
    params = {"w": torch.tensor([1.0, -1.5, 2.0])}
    st = u.init_state(params)
    # AdaDelta's unit-correcting step starts near sqrt(eps)
    for step in range(1500 if cls is AdaDelta else 200):
        upd, st = u.update({"w": params["w"]}, st, params, step)
        params = {"w": params["w"] - upd["w"]}
    assert float((params["w"] ** 2).sum()) < 1.0
