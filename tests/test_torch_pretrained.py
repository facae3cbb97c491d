"""The port's pretrained registry (``zoo/pretrained.py``) and
``ZooModel.init_pretrained``, held to the JAX package's
(``tests/test_pretrained_weights.py``, ``tests/test_zoo_extra.py``):
both packages find the same in-repo weight sets by path (the JAX
package's ``zoo/weights/``, each zip with its sha256 manifest); the
zips the port restores through ``load_pretrained`` give the JAX
package's outputs (f32, rtol 1e-5 / atol 1e-6); a port ``save_pretrained``
round trip (registry entry, sidecar manifest, a fresh lookup by
directory) restores the same outputs in both packages; a tampered zip is
refused by checksum, in the cache directory and in a directory named by
the caller.  No path downloads anything."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from torch_model_util import (  # noqa: F401 (a fixture among them)
    host, jax, one_torch_thread)

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

from deeplearning4j_torch.zoo import pretrained  # noqa: E402
from deeplearning4j_torch.zoo.pretrained import (  # noqa: E402
    load_pretrained, package_weights_dir, save_pretrained, sha256_of)

IN_REPO = ("LeNet_mnist", "SimpleCNN_cifar10-synthetic",
           "TextGenerationLSTM_pangrams", "Gpt_pangrams-char")


def test_package_weights_dir_is_the_reference_folder():
    jax()
    from deeplearning4j_tpu.zoo import pretrained as jpre
    assert os.path.samefile(package_weights_dir(),
                            jpre.package_weights_dir())
    for name in IN_REPO:
        path = os.path.join(package_weights_dir(), name + ".zip")
        with open(path + ".json") as f:
            assert sha256_of(path) == json.load(f)["sha256"], name


@pytest.mark.parametrize("name,dataset,shape", [
    ("LeNet", "mnist", (4, 28, 28, 1)),
    ("SimpleCNN", "cifar10-synthetic", (4, 32, 32, 3))])
def test_in_repo_weights_restore_with_jax_outputs(name, dataset, shape,
                                                  monkeypatch, tmp_path):
    jax()
    from deeplearning4j_tpu.zoo import load_pretrained as jload
    # an empty cache: the lookup falls through to the repository's sets
    monkeypatch.setenv("DL4J_TPU_PRETRAINED_DIR", str(tmp_path))
    monkeypatch.setattr(pretrained, "_REGISTRY", {})
    pm = load_pretrained(name, dataset, device="cpu")
    jm = jload(name, dataset)
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    np.testing.assert_allclose(host(pm.output(x)), host(jm.output(x)),
                               rtol=1e-5, atol=1e-6)
    assert (name, dataset) in pretrained.registered()


def test_registry_roundtrip_in_both_packages(tmp_path, monkeypatch):
    """save_pretrained of a port Darknet19 (after one fit step) writes
    the zip and its manifest into the cache directory; a fresh lookup
    (empty registry) restores it with the same outputs, and so does the
    JAX package from the same directory."""
    jax()
    from deeplearning4j_tpu.zoo import load_pretrained as jload

    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.zoo import Darknet19
    monkeypatch.setenv("DL4J_TPU_PRETRAINED_DIR", str(tmp_path))
    monkeypatch.setattr(pretrained, "_REGISTRY", {})
    model = Darknet19(n_classes=4, width=8,
                      input_shape=(32, 32, 3)).init_graph(device="cpu")
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[r.integers(0, 4, 2)]
    model.fit(DataSet(x, y))
    entry = save_pretrained(model, "darknet19", "toy")
    assert entry["path"] == str(tmp_path / "darknet19_toy.zip")
    assert entry["sha256"] == sha256_of(entry["path"])
    with open(entry["path"] + ".json") as f:
        assert json.load(f) == {"model": "darknet19", "dataset": "toy",
                                "sha256": entry["sha256"]}
    want = host(model.output(x))
    monkeypatch.setattr(pretrained, "_REGISTRY", {})
    np.testing.assert_allclose(
        host(load_pretrained("darknet19", "toy", device="cpu").output(x)),
        want, rtol=1e-6)
    jm = jload("darknet19", "toy", directory=str(tmp_path))
    out = jm.output(x)
    out = out["output"] if isinstance(out, dict) else out
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5, atol=1e-6)


def test_tampered_weights_are_refused(tmp_path, monkeypatch):
    d = tmp_path / "copy"
    d.mkdir()
    for suffix in (".zip", ".zip.json"):
        shutil.copy(os.path.join(package_weights_dir(),
                                 "LeNet_mnist" + suffix), d)
    assert load_pretrained("LeNet", "mnist", directory=str(d),
                           device="cpu") is not None
    with open(d / "LeNet_mnist.zip", "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02")
    with pytest.raises(IOError, match="Checksum"):
        load_pretrained("LeNet", "mnist", directory=str(d), device="cpu")
    monkeypatch.setenv("DL4J_TPU_PRETRAINED_DIR", str(d))
    monkeypatch.setattr(pretrained, "_REGISTRY", {})
    with pytest.raises(IOError, match="Checksum"):
        load_pretrained("LeNet", "mnist", device="cpu")
    with pytest.raises(KeyError, match="No pretrained weights"):
        load_pretrained("LeNet", "imagenet", directory=str(d),
                        device="cpu")


def test_init_pretrained_and_yolo_restore_without_the_zoo(tmp_path):
    """ZooModel.init_pretrained restores a local checkpoint; a TinyYOLO
    checkpoint restores in a process that never imports the zoo (the
    detection head is in the layer registry)."""
    from deeplearning4j_torch.zoo import LeNet, TinyYOLO
    m = LeNet().init_pretrained(
        os.path.join(package_weights_dir(), "LeNet_mnist.zip"),
        device="cpu")
    assert m.num_params() > 0
    yolo = TinyYOLO(n_classes=2, width=4,
                    input_shape=(16, 16, 1)).init_graph(device="cpu")
    p = str(tmp_path / "yolo.zip")
    yolo.save(p)
    code = ("import sys\n"
            "from deeplearning4j_torch.utils.model_serializer import "
            "restore_model\n"
            f"m = restore_model({p!r}, device='cpu')\n"
            "assert not [k for k in sys.modules if 'zoo' in k]\n"
            "print('RESTORED', type(m).__name__)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert b"RESTORED ComputationGraph" in r.stdout
