"""Keras fixtures for the Keras importer's tests and the card's
``periphery`` phase, made with the installed Keras (3.13.1 for the
committed files):

* ``keras_lenet_golden.npz`` — dl4j-examples' LeNet (MNIST, 28 x 28 x 1:
  conv 20 5x5, max-pool 2, conv 50 5x5, max-pool 2, dense 500 relu,
  softmax 10) saved as a legacy full-model ``.h5``: its ``model_config``
  JSON (``config``), its weights in ``KerasModelImport._read_weights``'
  form (``w/<layer>/<leaf>``), a seeded input batch (``x``, b 8) and
  ``model.predict`` on it (``predict``), so the import runs without h5py
  or Keras;
* ``keras_resnet50_config.json`` — the ``model_config`` of
  ``keras.applications.ResNet50(weights=None)`` (224 x 224 x 3, 1000
  classes), config only: the tests and the phase seed its weights.

Run from the repository root: ``python tests/fixtures/gen_keras_fixtures.py``.
"""
import json
import os
import tempfile

os.environ.setdefault("CUDA_VISIBLE_DEVICES", "")
os.environ.setdefault("TF_ENABLE_ONEDNN_OPTS", "0")

import h5py  # noqa: E402
import keras  # noqa: E402
import numpy as np  # noqa: E402

OUT = os.path.dirname(os.path.abspath(__file__))


def read_h5(path):
    """(model_config JSON string, {layer: {leaf: array}}) of a legacy
    full-model ``.h5`` — the importer's ``_read_weights`` walk."""
    out = {}
    with h5py.File(path, "r") as f:
        cfg = f.attrs["model_config"]
        grp = f["model_weights"]
        for layer in grp:
            leaf = {}

            def visit(name, obj, leaf=leaf):
                if isinstance(obj, h5py.Dataset):
                    leaf[name.split("/")[-1].split(":")[0]] = np.asarray(obj)
            grp[layer].visititems(visit)
            if leaf:
                out[layer] = leaf
    return cfg if isinstance(cfg, str) else cfg.decode(), out


def lenet(tmp):
    from keras import layers
    keras.utils.set_random_seed(0)
    m = keras.Sequential([
        keras.Input((28, 28, 1)),
        layers.Conv2D(20, 5, activation="relu", name="conv1"),
        layers.MaxPooling2D(2, name="pool1"),
        layers.Conv2D(50, 5, activation="relu", name="conv2"),
        layers.MaxPooling2D(2, name="pool2"),
        layers.Flatten(name="flatten"),
        layers.Dense(500, activation="relu", name="dense1"),
        layers.Dense(10, activation="softmax", name="output"),
    ])
    path = os.path.join(tmp, "lenet.h5")
    m.save(path)
    cfg, weights = read_h5(path)
    x = np.random.default_rng(28).random((8, 28, 28, 1)).astype(np.float32)
    arrays = {f"w/{layer}/{leaf}": a for layer, leaves in weights.items()
              for leaf, a in leaves.items()}
    np.savez_compressed(os.path.join(OUT, "keras_lenet_golden.npz"),
                        config=np.asarray(cfg), x=x,
                        predict=np.asarray(m.predict(x, verbose=0)),
                        **arrays)


def resnet50(tmp):
    m = keras.applications.ResNet50(weights=None)
    path = os.path.join(tmp, "resnet50.h5")
    m.save(path)
    with h5py.File(path, "r") as f:
        cfg = f.attrs["model_config"]
    cfg = json.loads(cfg if isinstance(cfg, str) else cfg.decode())
    with open(os.path.join(OUT, "keras_resnet50_config.json"), "w") as f:
        json.dump(cfg, f, separators=(",", ":"))


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        lenet(tmp)
        resnet50(tmp)
