"""DataVec in the port (``deeplearning4j_torch.datavec``) against the JAX
package's: the cases of ``tests/test_datavec.py`` with every reader,
transform and iterator run in both packages on the same data and held
equal (records, schemas, JSON, batches and masks), a TransformProcess
JSON written by either package executing in the other, the image reader
with OpenCV, and the port's iterators feeding ``MultiLayerNetwork.fit``
on the CPU through ``AsyncDataSetIterator``."""
import time

import numpy as np
import pytest
import torch

import deeplearning4j_torch.datavec as P

pytest.importorskip("jax")
import deeplearning4j_tpu.datavec as R  # noqa: E402

BOTH = (P, R)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_csv_readers_equal(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("# header\n1,2.5,setosa\n3,4.5,virginica\n\n7,-1e3,x\n")
    for M in BOTH:
        assert list(M.CSVRecordReader(str(p), skip_lines=1)) == [
            [1, 2.5, "setosa"], [3, 4.5, "virginica"], [7, -1000.0, "x"]]
    t = "a;b\n1;2\n"
    assert list(P.CSVRecordReader(text=t, delimiter=";",
                                  parse_numbers=False)) == \
        list(R.CSVRecordReader(text=t, delimiter=";", parse_numbers=False))
    for i in range(2):
        (tmp_path / f"s{i}.csv").write_text("1,0\n2,1\n3,0\n")
    paths = [str(tmp_path / f"s{i}.csv") for i in range(2)]
    assert list(P.CSVSequenceRecordReader(paths)) == \
        list(R.CSVSequenceRecordReader(paths))
    (tmp_path / "l.txt").write_text("x y\nz\n")
    assert list(P.LineRecordReader(str(tmp_path / "l.txt"))) == \
        list(R.LineRecordReader(str(tmp_path / "l.txt")))
    with pytest.raises(ValueError):
        P.CSVRecordReader()


def _iris_schema(M):
    return (M.Schema.builder()
            .add_column_double("sl", "sw", "pl", "pw")
            .add_column_categorical("species", ["setosa", "versicolor",
                                                "virginica"])
            .build())


ROWS = [[6.0, 3.0, 1.4, 0.2, "setosa"], [5.0, 2.0, 4.5, 1.5, "versicolor"],
        [float("nan"), 1, 1, 1, "virginica"], [4.4, 2.9, 1.4, 0.2,
                                               "virginica"]]


def _chains(M):
    s = _iris_schema(M)
    return [
        M.TransformProcess.builder(s).normalize_min_max("sl", 4.0, 8.0)
        .categorical_to_integer("species").remove_columns("pw").build(),
        M.TransformProcess.builder(s).filter_invalid("sl")
        .categorical_to_one_hot("species").build(),
        M.TransformProcess.builder(s).keep_columns("sl", "species")
        .string_map("species", {"setosa": "versicolor"})
        .categorical_to_integer("species")
        .integer_to_categorical("species", ["a", "b", "c"])
        .double_math_op("sl", "multiply", 2.0)
        .replace_less_than("sl", 9.0, 0.0).build(),
    ]


@pytest.mark.parametrize("i", range(3))
def test_transform_process_equal_and_json_crosses_packages(i):
    tp, tr = _chains(P)[i], _chains(R)[i]
    rows = ROWS if i == 1 else [r for r in ROWS if r[0] == r[0]]
    assert tp.execute(rows) == tr.execute(rows)
    assert tp.final_schema().to_dict() == tr.final_schema().to_dict()
    assert tp.to_json() == tr.to_json()
    assert P.TransformProcess.from_json(tr.to_json()).execute(rows) == \
        tr.execute(rows)
    assert R.TransformProcess.from_json(tp.to_json()).execute(rows) == \
        tp.execute(rows)


def test_transform_validates_eagerly():
    with pytest.raises(KeyError):
        P.TransformProcess.builder(_iris_schema(P)).remove_columns("nope") \
            .build()
    with pytest.raises(ValueError):
        P.TransformProcess.builder(_iris_schema(P)) \
            .categorical_to_integer("sl").build()
    with pytest.raises(ValueError):
        P.TransformProcess.builder(_iris_schema(P)) \
            .double_math_op("sl", "nope", 1.0)


def _csv(tmp_path, n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x @ np.array([1.0, -1.0, 0.5, 0.2])) > 0
    names = ["neg", "pos"]
    p = tmp_path / "train.csv"
    p.write_text("\n".join(",".join(f"{v:.5f}" for v in row)
                           + f",{names[int(c)]}" for row, c in zip(x, y))
                 + "\n")
    return str(p), names


def _csv_iter(M, path, names, batch=50):
    schema = (M.Schema.builder().add_column_double("a", "b", "c", "d")
              .add_column_categorical("label", names).build())
    tp = M.TransformProcess.builder(schema) \
        .categorical_to_integer("label").build()
    return M.RecordReaderDataSetIterator(
        M.CSVRecordReader(path), batch_size=batch, label_index=-1,
        n_classes=2, transform_process=tp)


def test_record_reader_iterators_equal(tmp_path):
    path, names = _csv(tmp_path, n=120)
    pb = list(_csv_iter(P, path, names, batch=50))
    rb = list(_csv_iter(R, path, names, batch=50))
    assert [b.num_examples() for b in pb] == [50, 50, 20]
    for a, b in zip(pb, rb):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
    reg, ref = (list(M.RecordReaderDataSetIterator(
        M.CollectionRecordReader([[1.0, 2.0, 0.5], [3.0, 4.0, 1.5]]), 2,
        label_index=0)) for M in BOTH)        # regression labels
    np.testing.assert_array_equal(reg[0].features, ref[0].features)
    np.testing.assert_array_equal(reg[0].labels, ref[0].labels)

    seqs = [[[0.1, 0.2, 0], [0.3, 0.4, 1]], [[0.5, 0.6, 1]]]
    out = [next(iter(M.SequenceRecordReaderDataSetIterator(
        M.CollectionRecordReader(seqs), batch_size=2, n_classes=2)))
        for M in BOTH]
    assert out[0].features.shape == (2, 2, 2)
    np.testing.assert_allclose(out[0].features_mask, [[1, 1], [1, 0]])
    for k in ("features", "labels", "features_mask", "labels_mask"):
        np.testing.assert_array_equal(getattr(out[0], k),
                                      getattr(out[1], k))


def _mlp(n_in, n_out, seed=1, lr=0.05, input_type=None):
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf import (DenseLayer,
                                              NeuralNetConfiguration,
                                              OutputLayer)
    from deeplearning4j_torch.optimize.updaters import Adam
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(Adam(learning_rate=lr)).list())
    if input_type is not None:
        b = b.set_input_type(input_type)
    conf = (b.layer(DenseLayer(n_in=n_in, n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=n_out, activation="softmax",
                               loss="mcxent")).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def test_csv_to_fit_end_to_end(tmp_path):
    """The Iris flow: CSV file -> TransformProcess -> iterator ->
    AsyncDataSetIterator -> fit -> evaluate."""
    from deeplearning4j_torch.data.iterator import AsyncDataSetIterator
    path, names = _csv(tmp_path)
    it = _csv_iter(P, path, names)
    model = _mlp(4, 2)
    model.fit(AsyncDataSetIterator(it), n_epochs=30)
    assert model.evaluate(it).accuracy() > 0.95


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    import cv2
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for lab in ("cat", "dog"):
        d = root / lab
        d.mkdir()
        for i in range(12):
            img = rng.integers(0, 255, (40, 52, 3), np.uint8)
            if lab == "cat":      # separable: cats are red-heavy
                img[..., 2] = np.minimum(
                    255, img[..., 2].astype(int) + 120).astype(np.uint8)
            cv2.imwrite(str(d / f"{i}.png"), img)
    return str(root)


def test_image_record_reader_equal(image_tree):
    pr = P.ImageRecordReader(32, 32, 3, root=image_tree, shuffle_seed=0)
    rr = R.ImageRecordReader(32, 32, 3, root=image_tree, shuffle_seed=0)
    assert pr.label_names == rr.label_names == ["cat", "dog"]
    assert len(pr) == 24 and pr.paths == rr.paths
    for (a, la), (b, lb) in zip(pr, rr):
        assert a.shape == (32, 32, 3) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        assert la == lb
    g = P.ImageRecordReader(16, 16, 1, paths=pr.paths[:2], labels=[0, 1])
    assert next(iter(g))[0].shape == (16, 16, 1)


def test_image_pipeline_trains(image_tree):
    from deeplearning4j_torch.data.normalization import (
        ImagePreProcessingScaler)
    from deeplearning4j_torch.nn.conf.inputs import InputType
    rr = P.ImageRecordReader(16, 16, 3, root=image_tree, shuffle_seed=1)
    it = P.RecordReaderDataSetIterator(rr, batch_size=8, n_classes=2)
    it.pre_processor = ImagePreProcessingScaler()
    model = _mlp(None, 2, seed=3, lr=0.01,
                 input_type=InputType.convolutional(16, 16, 3))
    model.fit(it, n_epochs=20)
    assert model.evaluate(it).accuracy() > 0.9


def test_async_prefetch_overlaps_image_decode(image_tree):
    """The prefetch thread decodes ahead while the consumer computes."""
    from deeplearning4j_torch.data.iterator import (AsyncDataSetIterator,
                                                    DataSetIterator)
    inner = P.RecordReaderDataSetIterator(
        P.ImageRecordReader(32, 32, 3, root=image_tree), batch_size=6,
        n_classes=2)
    events = []

    class Logging(DataSetIterator):
        def __iter__(self):
            for i, ds in enumerate(inner):
                events.append((i, time.perf_counter()))
                yield ds

    consumed0_done = None
    for i, ds in enumerate(AsyncDataSetIterator(Logging(), queue_size=2)):
        time.sleep(0.1)
        if i == 0:
            consumed0_done = time.perf_counter()
    produced = dict(events)
    assert len(produced) == 4
    assert produced[2] < consumed0_done, (produced, consumed0_done)
