"""The port's Keras importer (``deeplearning4j_torch.keras_import``)
against the JAX package's and against Keras, on the CPU.

* The reference's h5 golden cases (LeNet-style, batch norm with running
  stats, a trailing Activation folded into the output layer, LSTM, a
  functional residual block, an unknown layer) built with the installed
  Keras: the port's import within 1e-5 of ``model.predict`` and of the
  JAX package's import of the same file.
* The committed LeNet golden (``tests/fixtures/keras_lenet_golden.npz``,
  made by ``gen_keras_fixtures.py``): config + weights in
  ``_read_weights``' form, no h5py or Keras needed.
* Keras's ResNet-50 functional config (``keras_resnet50_config.json``)
  with its input edited to 32 x 32 and numpy-seeded weights, imported
  once per module in both packages: outputs within 1e-5.
"""
import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.keras_import import KerasModelImport  # noqa: E402

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_import():
    pytest.importorskip("jax")
    return importlib.import_module(
        "deeplearning4j_tpu.keras_import").KerasModelImport


def _out(y):
    """A network's output as numpy (a graph's single output unwrapped)."""
    if isinstance(y, dict):
        (y,) = y.values()
    return y.detach().cpu().numpy() if hasattr(y, "detach") \
        else np.asarray(y)


def _lenet_golden():
    g = np.load(os.path.join(FIX, "keras_lenet_golden.npz"))
    weights = {}
    for key in g.files:
        if key.startswith("w/"):
            _, layer, leaf = key.split("/")
            weights.setdefault(layer, {})[leaf] = g[key]
    return json.loads(str(g["config"])), weights, g["x"], g["predict"]


def test_lenet_golden_without_h5py():
    """dl4j-examples' LeNet from the committed golden: the config dict and
    the weights dict go straight to ``_import_sequential`` (what the card
    runs, with no h5py there); output within 1e-5 of Keras's predict and
    of the JAX package's import."""
    cfg, weights, x, want = _lenet_golden()
    assert cfg["class_name"] == "Sequential"
    model = KerasModelImport._import_sequential(cfg["config"], weights,
                                                device="cpu")
    got = _out(model.output(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    J = _jax_import()
    jm = J._import_sequential(cfg["config"], weights)
    np.testing.assert_allclose(got, np.asarray(jm.output(x)), rtol=0,
                               atol=TOL)
    assert [type(ly).__name__ for ly in model.conf.layers] == \
        [type(ly).__name__ for ly in jm.conf.layers]


# -- the reference's h5 cases ---------------------------------------------
def _keras():
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "")
    return pytest.importorskip("keras")


def _both(path, x):
    """(port output, JAX output) of the file imported by each package."""
    J = _jax_import()
    pm = KerasModelImport.import_keras_model_and_weights(path, device="cpu")
    jm = J.import_keras_model_and_weights(path)
    return pm, _out(pm.output(x)), jm, _out(jm.output(x))


def _h5_cases(keras):
    from keras import layers
    inp = keras.Input((8, 8, 3), name="img")
    a = layers.Conv2D(4, 3, padding="same", activation="relu", name="ca")(inp)
    b = layers.Conv2D(4, 3, padding="same", name="cb")(a)
    r = layers.Activation("relu", name="act")(layers.Add(name="res")([a, b]))
    out = layers.Dense(5, activation="softmax", name="head")(
        layers.GlobalAveragePooling2D(name="gap")(r))
    return {
        "lenet": (keras.Sequential([
            keras.Input((14, 14, 1)),
            layers.Conv2D(6, 5, activation="relu", name="c1"),
            layers.MaxPooling2D(2),
            layers.Conv2D(16, 3, activation="relu", name="c2"),
            layers.Flatten(),
            layers.Dense(32, activation="relu", name="fc1"),
            layers.Dense(10, activation="softmax", name="out")]),
            (4, 14, 14, 1)),
        "batchnorm": (keras.Sequential([
            keras.Input((8, 8, 2)),
            layers.Conv2D(4, 3, name="c"),
            layers.BatchNormalization(name="bn"),
            layers.Activation("relu"),
            layers.Flatten(),
            layers.Dense(3, activation="softmax", name="o")]), (3, 8, 8, 2)),
        "trailing_softmax": (keras.Sequential([
            keras.Input((6,)),
            layers.Dense(12, activation="relu", name="h"),
            layers.Dense(4, name="logits"),
            layers.Activation("softmax", name="sm")]), (5, 6)),
        "trailing_after_relu": (keras.Sequential([
            keras.Input((6,)),
            layers.Dense(4, activation="relu", name="d"),
            layers.Activation("softmax", name="sm2")]), (5, 6)),
        "lstm": (keras.Sequential([
            keras.Input((6, 5)),
            layers.LSTM(8, return_sequences=False, name="l1"),
            layers.Dense(3, activation="softmax", name="o")]), (4, 6, 5)),
        "functional_residual": (keras.Model(inp, out), (2, 8, 8, 3)),
    }


H5_CASES = ["lenet", "batchnorm", "trailing_softmax", "trailing_after_relu",
            "lstm", "functional_residual"]


@pytest.mark.parametrize("case", H5_CASES)
def test_h5_import_matches_keras_and_jax(case, tmp_path):
    keras = _keras()
    model, shape = _h5_cases(keras)[case]
    if case == "batchnorm":     # non-trivial running statistics
        bn = model.get_layer("bn")
        bn.moving_mean.assign(np.linspace(-1, 1, 4).astype(np.float32))
        bn.moving_variance.assign(np.linspace(0.5, 2, 4).astype(np.float32))
    path = str(tmp_path / f"{case}.h5")
    model.save(path)
    x = np.random.default_rng(len(case)).normal(size=shape).astype(
        np.float32)
    pm, got, jm, jgot = _both(path, x)
    want = np.asarray(model.predict(x, verbose=0))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, jgot, rtol=0, atol=TOL)
    if case == "trailing_softmax":
        from deeplearning4j_torch.data import DataSet
        from deeplearning4j_torch.nn.conf import OutputLayer
        assert isinstance(pm.conf.layers[-1], OutputLayer)
        y = np.eye(4, dtype=np.float32)[np.arange(5) % 4]
        assert np.isfinite(float(pm.fit(DataSet(x, y))))
    if case == "trailing_after_relu":
        from deeplearning4j_torch.nn.conf import OutputLayer
        assert not isinstance(pm.conf.layers[-2], OutputLayer)


def test_import_rejects_unknown_layer(tmp_path):
    keras = _keras()
    from keras import layers
    m = keras.Sequential([keras.Input((4,)),
                          layers.Dense(4, activation="relu"),
                          layers.LayerNormalization(),
                          layers.Dense(2, activation="softmax")])
    p = str(tmp_path / "bad.h5")
    m.save(p)
    with pytest.raises(ValueError, match="LayerNormalization"):
        KerasModelImport.import_keras_model_and_weights(p, device="cpu")


# -- ResNet-50's functional config ------------------------------------------
@pytest.fixture(scope="module")
def resnet50_pair():
    """ResNet-50 at 32 x 32 imported by both packages from the same
    config and seeded weights (``chip_smoke.py``'s, as the card's
    phase makes them; one JAX import per module, ~10 s)."""
    import chip_smoke
    J = _jax_import()
    cfg = chip_smoke.keras_resnet50_config(chip_smoke.ROOT_DIR, 32)
    probe = KerasModelImport._import_functional(cfg["config"], {},
                                                device="cpu")
    weights = chip_smoke.seeded_keras_weights(np, probe, 0)
    pm = KerasModelImport._import_functional(cfg["config"], weights,
                                             device="cpu")
    jm = J._import_functional(cfg["config"], weights)
    return pm, jm, weights


def test_resnet50_functional_config_matches_jax(resnet50_pair):
    pm, jm, weights = resnet50_pair
    assert len(weights) == 107    # 53 conv + 53 batch norm + the head
    assert pm.vertex_names() == list(jm.vertex_names())
    x = np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32)
    got, want = _out(pm.output(x)), _out(jm.output(x))
    assert got.shape == (2, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
