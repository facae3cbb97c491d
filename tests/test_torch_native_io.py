"""The port's native IO binding (``deeplearning4j_torch.native_io``) on
the CPU: ``build_native`` (the repository's ``native/`` CMake project, as
it is) into a copy of that project, so the build never races the JAX
package's own in-tree build under parallel workers; the native CSV parse
equals the JAX package's and the port's ``CSVRecordReader`` parses; the
reader feeds a port MLP's training; the error paths and the Python
fallback.
"""
import importlib
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch import native_io  # noqa: E402
from deeplearning4j_torch.native_io import binding  # noqa: E402

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """``build_native`` run on a copy of ``native/`` (sources only)."""
    if shutil.which("cmake") is None:
        pytest.skip("needs cmake")
    copy = tmp_path_factory.mktemp("native") / "native"
    shutil.copytree(NATIVE_DIR, copy, ignore=shutil.ignore_patterns("build"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(binding, "_NATIVE_DIR", str(copy))
        mp.setattr(binding, "_lib", None)
        mp.delenv("DL4J_TPU_NATIVE_LIB", raising=False)
        path = native_io.build_native()
        assert path.startswith(str(copy)) and native_io.native_available()
        yield str(copy)
    binding._lib = None


@pytest.fixture(scope="module")
def csv_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("csv") / "data.csv"
    data = np.random.default_rng(0).normal(size=(3000, 12)).astype(
        np.float32)
    with open(p, "w") as f:
        f.write("# header line\n")
        for row in data:
            f.write(",".join(f"{v:.6f}" for v in row) + "\n")
    return str(p), data


def test_native_unit_tests_pass(built):
    import subprocess
    exe = os.path.join(built, "build", "test_csv_loader")
    r = subprocess.run([exe], capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()
    assert b"ALL NATIVE TESTS PASSED" in r.stdout


def test_native_parse_equals_both_packages_readers(built, csv_file):
    """The native parse, the port's ``CSVRecordReader`` and the JAX
    package's ``CSVRecordReader`` give the same matrix (the text's six
    decimals, exactly as float32)."""
    pytest.importorskip("jax")
    jrec = importlib.import_module("deeplearning4j_tpu.datavec.records")
    from deeplearning4j_torch.datavec import CSVRecordReader
    path, data = csv_file
    m = native_io.load_csv_native(path, skip_lines=1)
    assert m.shape == data.shape and m.dtype == np.float32
    port_rows = np.asarray(list(CSVRecordReader(path, skip_lines=1)),
                           np.float32)
    jax_rows = np.asarray(list(jrec.CSVRecordReader(path, skip_lines=1)),
                          np.float32)
    np.testing.assert_array_equal(port_rows, jax_rows)
    np.testing.assert_array_equal(m, port_rows)
    reader = native_io.NativeCSVRecordReader(path, skip_lines=1)
    np.testing.assert_array_equal(np.asarray(list(reader), np.float32), m)


def test_native_reader_feeds_training(built, tmp_path):
    """``NativeCSVRecordReader`` slots into the port's ETL bridge and a
    port MLP trains from it on the CPU."""
    from deeplearning4j_torch.datavec import RecordReaderDataSetIterator
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf import (DenseLayer,
                                              NeuralNetConfiguration,
                                              OutputLayer)
    from deeplearning4j_torch.optimize.updaters import Adam
    rng = np.random.default_rng(1)
    x = rng.normal(size=(300, 4)).astype(np.float32)
    y = (x.sum(1) > 0).astype(int)
    p = tmp_path / "train.csv"
    with open(p, "w") as f:
        for row, c in zip(x, y):
            f.write(",".join(f"{v:.5f}" for v in row) + f",{c}\n")
    it = RecordReaderDataSetIterator(
        native_io.NativeCSVRecordReader(str(p)), batch_size=64,
        label_index=-1, n_classes=2)
    conf = (NeuralNetConfiguration.builder().seed(1)
            .updater(Adam(learning_rate=0.05)).list()
            .layer(DenseLayer(n_in=4, n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .build())
    model = MultiLayerNetwork(conf).init(device="cpu")
    model.fit(it, n_epochs=20)
    assert model.evaluate(it).accuracy() > 0.95


def test_u8_scale_and_error_paths(built, tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (32, 32, 3), np.uint8)
    np.testing.assert_allclose(native_io.u8_to_f32_scaled(img),
                               img.astype(np.float32) / 255.0, atol=1e-7)
    with pytest.raises(IOError):
        native_io.load_csv_native(str(tmp_path / "missing.csv"))
    bad = tmp_path / "bad.csv"
    bad.write_text("1,banana,3\n")
    with pytest.raises(ValueError, match="non-numeric"):
        native_io.load_csv_native(str(bad))


def test_without_the_library_the_reader_takes_the_python_path(
        csv_file, monkeypatch):
    """No built library: ``native_available()`` is False,
    ``load_csv_native`` raises, and ``NativeCSVRecordReader`` reads
    through the Python ``CSVRecordReader`` (the reference's fallback)."""
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding, "_find_lib", lambda: None)
    path, data = csv_file
    assert not native_io.native_available()
    with pytest.raises(RuntimeError, match="not built"):
        native_io.load_csv_native(path)
    rows = native_io.NativeCSVRecordReader(path, skip_lines=1).matrix()
    np.testing.assert_allclose(rows, data, atol=1e-6)
