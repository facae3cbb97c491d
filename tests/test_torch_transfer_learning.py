"""The port's transfer learning (``models/transfer_learning.py``) held to
the JAX package on the scenarios of ``tests/test_transfer_learning.py``
and ``tests/test_transfer_learning_graph.py``.

Each scenario runs in BOTH packages (``run(S)``, ``S`` the package's
classes).  The source model is the JAX one — the MLP trained five Adam
steps, the residual graph, the checked-in LeNet — carried into the port.
Every fine-tune model a scenario builds is synced: its retained
parameters must already equal the JAX fine-tune's bit for bit (copied
from equal sources), and only the layers the builder re-initialises
(``n_out_replace``'s layer and its first consumer, an added head) may
differ — those take the JAX model's fresh draws, so the two fine-tunes
start from one point.  The scenarios' records then agree: frozen
indices and names, shapes, every loss (rtol 1e-4, f32 over up to 150
steps), the frozen parameters bit-identical to the source's, the heads'
accuracies (the LeNet fine-tune: the first 10 steps' losses in both,
then the port alone to the reference's 40 steps and accuracy gate).
Port-only cases pin what the reference's regressions pin: the source
model survives a fine-tune step (copies, not shared
tensors), ``n_out_replace`` re-infers through pooling, and the builders
reject a frozen fresh layer or an unknown vertex."""
import types

import numpy as np
import pytest

from torch_model_util import (  # noqa: F401 (a fixture among them)
    carry, conf_ns, host, jax, np_tree, one_torch_thread)

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _package(name):
    """The package's transfer-learning surface and conf namespace."""
    import importlib
    tl = importlib.import_module(f"{name}.models.transfer_learning")
    S = types.SimpleNamespace(**vars(conf_ns(name)))
    for k in ("TransferLearning", "GraphBuilder", "TransferLearningHelper",
              "mln_to_graph", "frozen_layer_indices", "freeze_graph_layers"):
        setattr(S, k, getattr(tl, k))
    ds = importlib.import_module(f"{name}.data.dataset")
    S.DataSet = ds.DataSet
    S.zoo = importlib.import_module(f"{name}.zoo")
    S.ser = importlib.import_module(f"{name}.utils.model_serializer")
    S.mnist = importlib.import_module(f"{name}.data.mnist")
    S.port = name == "deeplearning4j_torch"
    return S


def _xy(rng, n=64, n_in=8, n_classes=2):
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    labels = (x[:, 0] > 0).astype(int) if n_classes == 2 else \
        rng.integers(0, n_classes, n)
    return x, np.eye(n_classes, dtype=np.float32)[labels]


# -- the sources (built in JAX, carried into the port) -----------------
def _jax_base_mlp():
    S = _package("deeplearning4j_tpu")
    conf = (S.NeuralNetConfiguration.builder().seed(7)
            .updater(S.Adam(learning_rate=1e-2)).list()
            .layer(S.DenseLayer(n_in=8, n_out=16, activation="relu"))
            .layer(S.DenseLayer(n_out=12, activation="tanh"))
            .layer(S.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    from deeplearning4j_tpu.models.multi_layer_network import (
        MultiLayerNetwork)
    m = MultiLayerNetwork(conf).init()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    for _ in range(5):
        m.fit(S.DataSet(x, y))
    return m, x, y


def _jax_residual_graph():
    S = _package("deeplearning4j_tpu")
    from deeplearning4j_tpu.models.computation_graph import ComputationGraph
    return ComputationGraph(_residual_conf(S)).init()


def _residual_conf(S):
    g = (S.NeuralNetConfiguration.builder().seed(5)
         .updater(S.Adam(learning_rate=1e-2))
         .graph().add_inputs("in")
         .set_input_types(S.InputType.feed_forward(8)))
    g.add_layer("d1", S.DenseLayer(n_out=16, activation="relu"), "in")
    g.add_layer("d2", S.DenseLayer(n_out=16, activation="relu"), "d1")
    g.add_vertex("res", S.ElementWiseVertex("add"), "d1", "d2")
    g.add_layer("head", S.DenseLayer(n_out=8, activation="relu"), "res")
    g.add_layer("out", S.OutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent"), "head")
    return g.set_outputs("out").build()


def _source(S, jsrc):
    """The scenario's source model in package ``S``: the JAX one, or
    its carry into the port."""
    if not S.port:
        return jsrc
    from deeplearning4j_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf.builder import MultiLayerConfiguration
    from deeplearning4j_torch.models.computation_graph import (
        ComputationGraphConfiguration as CGC)
    d = jsrc.conf.to_dict()
    if hasattr(jsrc, "vertex_names"):
        net = ComputationGraph(CGC.from_dict(d))
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(d))
    return carry(jsrc, net)


class _Sync:
    """Records each fine-tune model the JAX run builds (its initial
    params and state); in the port run, checks the port's model against
    the recorded one and installs the JAX draws of the fresh layers."""

    def __init__(self):
        self.models = []

    def __call__(self, S, ft, fresh=()):
        if not S.port:
            self.models.append((np_tree(ft.params_tree),
                                np_tree(ft.state_tree)))
            return ft
        params, state = self.models.pop(0)
        assert sorted(ft.params_tree) == sorted(params)
        for key, leaves in ft.params_tree.items():
            same = all(np.array_equal(host(v), params[key][k])
                       for k, v in leaves.items())
            shapes = {k: tuple(v.shape) for k, v in leaves.items()} == {
                k: np.shape(v) for k, v in params[key].items()}
            assert shapes, key
            assert same == (key not in fresh), (key, fresh)
        from deeplearning4j_torch.utils.convert import (load_numpy_params,
                                                        load_numpy_state)
        load_numpy_params(ft, params, device="cpu")
        return load_numpy_state(ft, state)


# -- scenarios ------------------------------------------------------------
def _feature_extractor(S, src, x, y, sync):
    ft = sync(S, S.TransferLearning.Builder(src)
              .fine_tune_configuration(updater=S.Sgd(learning_rate=0.1))
              .set_feature_extractor(1).build())
    frozen = {k: host(ft.params_tree[f"layer_{k}"]["W"]).copy()
              for k in (0, 1)}
    w2 = host(ft.params_tree["layer_2"]["W"]).copy()
    losses = [float(ft.fit(S.DataSet(x, y))) for _ in range(5)]
    for k, w in frozen.items():
        assert np.array_equal(host(ft.params_tree[f"layer_{k}"]["W"]), w)
        assert np.array_equal(w, host(src.params_tree[f"layer_{k}"]["W"]))
    assert not np.allclose(host(ft.params_tree["layer_2"]["W"]), w2)
    return {"frozen": S.frozen_layer_indices(ft), "losses": losses,
            "head": host(ft.params_tree["layer_2"]["W"])}


def _new_head_trains(S, src, x, y, sync):
    labels = (x[:, 0] > 0).astype(int)
    y2 = np.eye(2, dtype=np.float32)[labels]
    ft = sync(S, S.TransferLearning.Builder(src)
              .fine_tune_configuration(updater=S.Adam(learning_rate=5e-3))
              .set_feature_extractor(0)
              .remove_output_layer_and_processing()
              .add_layer(S.OutputLayer(n_in=12, n_out=2,
                                       activation="softmax", loss="mcxent"))
              .build(), fresh=("layer_2",))
    losses = [float(ft.fit(S.DataSet(x, y2))) for _ in range(41)]
    acc = float((host(ft.output(x)).argmax(-1) == labels).mean())
    assert losses[-1] < 0.5 * losses[0] and acc > 0.9, (losses, acc)
    return {"n_layers": len(ft.layers), "losses": losses, "acc": acc}


def _n_out_replace(S, src, x, y, sync):
    ft = sync(S, S.TransferLearning.Builder(src).n_out_replace(1, 20)
              .build(), fresh=("layer_1", "layer_2"))
    shapes = [tuple(np.shape(host(ft.params_tree[f"layer_{i}"]["W"])))
              for i in range(3)]
    assert np.array_equal(host(ft.params_tree["layer_0"]["W"]),
                          host(src.params_tree["layer_0"]["W"]))
    losses = [float(ft.fit(S.DataSet(x, y))) for _ in range(5)]
    assert losses[-1] < losses[0]
    return {"shapes": shapes, "n_out": ft.layers[1].n_out,
            "losses": losses}


def _freeze_survives_save_load(S, src, x, y, sync, tmp):
    ft = sync(S, S.TransferLearning.Builder(src).set_feature_extractor(0)
              .build())
    p = str(tmp / f"ft_{S.port}.zip")
    S.ser.write_model(ft, p)
    kw = {"device": "cpu"} if S.port else {}
    ft2 = S.ser.restore_model(p, **kw)
    w0 = host(ft2.params_tree["layer_0"]["W"]).copy()
    losses = [float(ft2.fit(S.DataSet(x, y))) for _ in range(3)]
    assert np.array_equal(host(ft2.params_tree["layer_0"]["W"]), w0)
    return {"frozen": S.frozen_layer_indices(ft2), "losses": losses,
            "json": ft2.conf.to_dict()}


def _graph_ancestor_freeze(S, src, x, y, sync):
    ft = sync(S, S.GraphBuilder(src).set_feature_extractor("res")
              .fine_tune_configuration(updater=S.Sgd(learning_rate=1e-2))
              .build())
    assert S.TransferLearning.GraphBuilder is S.GraphBuilder
    w = {n: host(ft.params_tree[n]["W"]).copy() for n in ("d1", "d2",
                                                         "head")}
    losses = [float(ft.fit(S.DataSet(x, y))) for _ in range(4)]
    for n in ("d1", "d2"):
        assert np.array_equal(host(ft.params_tree[n]["W"]), w[n])
    assert np.abs(host(ft.params_tree["head"]["W"]) - w["head"]).max() > 0
    return {"frozen": sorted(ft.conf.frozen_layers), "losses": losses}


def _graph_n_out_replace(S, src, x, y, sync):
    ft = sync(S, S.GraphBuilder(src).n_out_replace("head", 12).build(),
              fresh=("head", "out"))
    losses = [float(ft.fit(S.DataSet(x, y))) for _ in range(5)]
    return {"shapes": [tuple(np.shape(host(ft.params_tree[n]["W"])))
                       for n in ("head", "out")], "losses": losses}


def _graph_new_head_trains(S, src, x, y, sync):
    r = np.random.default_rng(2)
    x2, y2 = _xy(r, n=128, n_classes=2)
    ft = sync(S, S.GraphBuilder(src)
              .remove_vertex_and_connections("out")
              .add_layer("out2", S.OutputLayer(n_out=2, activation="softmax",
                                               loss="mcxent"), "head")
              .set_outputs("out2").set_feature_extractor("res")
              .fine_tune_configuration(updater=S.Adam(learning_rate=1e-2))
              .build(), fresh=("out2",))
    losses = [float(ft.fit(S.DataSet(x2, y2))) for _ in range(150)]
    acc = float((host(ft.output(x2)).argmax(-1) == y2.argmax(-1)).mean())
    assert acc > 0.9, acc
    return {"vertices": sorted(ft.conf.vertices), "losses": losses[::10],
            "acc": acc}


def _graph_freeze_and_save(S, src, x, y, sync, tmp):
    model = S.GraphBuilder(src).build()
    model = sync(S, model)
    S.freeze_graph_layers(model, ["d1"])
    w1 = host(model.params_tree["d1"]["W"]).copy()
    losses = [float(model.fit(S.DataSet(x, y))) for _ in range(4)]
    assert np.array_equal(host(model.params_tree["d1"]["W"]), w1)
    p = str(tmp / f"g_{S.port}.zip")
    S.ser.write_model(model, p)
    g2 = S.ser.restore_model(p, **({"device": "cpu"} if S.port else {}))
    w1b = host(g2.params_tree["d1"]["W"]).copy()
    g2.fit(S.DataSet(x, y))
    assert np.array_equal(host(g2.params_tree["d1"]["W"]), w1b)
    return {"frozen": list(g2.conf.frozen_layers), "losses": losses}


def _helper_featurize(S, src, x, y, sync):
    helper = S.TransferLearningHelper(src, "res")
    feats = host(helper.featurize(x))
    np.testing.assert_allclose(feats, host(src.feed_forward(x)["res"]),
                               atol=1e-6)
    with pytest.raises(ValueError, match="unknown vertex"):
        S.TransferLearningHelper(src, "zzz")
    return {"feats": feats}


def _lenet_graph_finetune(S, src, x, y, sync):
    """mln_to_graph of the checked-in LeNet, freeze its features, a new
    binary head on synthetic MNIST: frozen convs bit-identical; the
    port's held-out accuracy > 0.9 after 40 steps."""
    graph = S.mln_to_graph(src)
    x4 = np.random.default_rng(3).normal(size=(4, 28, 28, 1)).astype(
        np.float32)
    np.testing.assert_allclose(host(src.output(x4)), host(graph.output(x4)),
                               atol=1e-5)
    n = len(src.layers)
    ft = sync(S, S.GraphBuilder(graph)
              .set_feature_extractor(f"layer_{n - 3}")
              .remove_vertex_and_connections(f"layer_{n - 1}")
              .add_layer("binary", S.OutputLayer(
                  n_out=2, activation="softmax", loss="mcxent"),
                  f"layer_{n - 2}")
              .set_outputs("binary")
              .fine_tune_configuration(updater=S.Adam(learning_rate=3e-3))
              .build(), fresh=("binary",))
    frozen_w = host(ft.params_tree["layer_0"]["W"]).copy()
    xs, labels = [], []
    for ds in S.mnist.MnistDataSetIterator(64, n_examples=512, seed=9):
        xs.append(np.asarray(ds.features).reshape(-1, 28, 28, 1))
        labels.append((np.argmax(np.asarray(ds.labels), -1) < 5)
                      .astype(int))
    x_all = np.concatenate(xs)
    y_all = np.eye(2, dtype=np.float32)[np.concatenate(labels)]
    # both packages take the first 10 steps (the record); the port goes
    # on to the reference test's 40 and its accuracy gate
    losses = [float(ft.fit(S.DataSet(x_all[:384], y_all[:384])))
              for _ in range(40 if S.port else 10)]
    if S.port:
        acc = float((host(ft.output(x_all[384:])).argmax(-1)
                     == y_all[384:].argmax(-1)).mean())
        assert acc > 0.9, acc
    assert np.array_equal(host(ft.params_tree["layer_0"]["W"]), frozen_w)
    return {"frozen": sorted(ft.conf.frozen_layers), "losses": losses[:10]}


# name: (scenario, source kind, wants tmp)
SCENARIOS = {
    "feature_extractor_freezes_prefix": (_feature_extractor, "mlp"),
    "new_head_trains": (_new_head_trains, "mlp"),
    "n_out_replace_reinitializes_neighbors": (_n_out_replace, "mlp"),
    "freeze_survives_save_load": (_freeze_survives_save_load, "mlp"),
    "graph_ancestor_closure_freeze": (_graph_ancestor_freeze, "graph"),
    "graph_n_out_replace_reinitializes_consumers": (_graph_n_out_replace,
                                                    "graph"),
    "graph_remove_add_head_trains": (_graph_new_head_trains, "graph"),
    "graph_freeze_and_serialization": (_graph_freeze_and_save, "graph"),
    "featurizer_helper": (_helper_featurize, "graph"),
    "lenet_mln_to_graph_finetune": (_lenet_graph_finetune, "lenet"),
}


def _jax_source(kind):
    if kind == "mlp":
        return _jax_base_mlp()
    if kind == "graph":
        x, y = _xy(np.random.default_rng(0), n_classes=3)
        return _jax_residual_graph(), x, y
    from deeplearning4j_tpu.zoo import load_pretrained
    return load_pretrained("LeNet", "mnist"), None, None


def _same(a, b, path="record"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray) or (isinstance(a, list) and a and
                                       isinstance(a[0], float)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6, err_msg=path)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-4, abs=1e-6), path
    else:
        assert a == b, path


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_transfer_learning_matches_jax(name, tmp_path):
    jax()
    fn, kind = SCENARIOS[name]
    jsrc, x, y = _jax_source(kind)
    sync = _Sync()
    recs = []
    for pkg in ("deeplearning4j_tpu", "deeplearning4j_torch"):
        S = _package(pkg)
        src = _source(S, jsrc)
        before = {k: {n: host(v).copy() for n, v in d.items()}
                  for k, d in src.params_tree.items()}
        extra = (tmp_path,) if "save" in fn.__name__ else ()
        recs.append(fn(S, src, x, y, sync, *extra))
        for k, d in src.params_tree.items():     # the source is untouched
            for n, v in d.items():
                assert np.array_equal(host(v), before[k][n]), (k, n)
    assert not sync.models
    _same(recs[1], recs[0])


# -- port-only regressions ------------------------------------------------
def _port_mlp():
    S = _package("deeplearning4j_torch")
    jsrc, x, y = _jax_base_mlp()
    return S, _source(S, jsrc), x, y


def test_source_model_survives_finetune_step():
    """The fine-tune's parameters are copies: training it leaves the
    source model's output as it was, and the source still trains."""
    S, m, x, y = _port_mlp()
    ft = S.TransferLearning.Builder(m).set_feature_extractor(0).build()
    before = host(m.output(x)).copy()
    for _ in range(3):
        ft.fit(S.DataSet(x, y))
    np.testing.assert_array_equal(host(m.output(x)), before)
    assert np.isfinite(m.fit(S.DataSet(x, y)))
    for key in ft.params_tree:
        for k, v in ft.params_tree[key].items():
            assert v.data_ptr() != m.params_tree[key][k].data_ptr()


def test_n_out_replace_propagates_through_pooling():
    """Changing a conv's n_out re-infers through the pooling layer and
    re-initialises the first parameterised consumer (the checked-in
    LeNet, read through the pretrained registry)."""
    from deeplearning4j_torch.models.transfer_learning import (
        TransferLearning)
    from deeplearning4j_torch.zoo import load_pretrained
    m = load_pretrained("LeNet", "mnist", device="cpu")
    conv_idx = next(i for i, ly in enumerate(m.layers)
                    if type(ly).__name__ == "ConvolutionLayer" and i > 0)
    ft = TransferLearning.Builder(m).n_out_replace(conv_idx, 32).build()
    assert ft.params_tree[f"layer_{conv_idx}"]["W"].shape[-1] == 32
    assert ft.params_tree[f"layer_{conv_idx + 2}"]["W"].shape[0] == \
        7 * 7 * 32
    x = np.random.default_rng(0).normal(size=(2, 28, 28, 1)).astype(
        np.float32)
    assert ft.output(x).shape == (2, 10)


def test_builders_reject_frozen_fresh_layers_and_unknown_vertices():
    S, m, _, _ = _port_mlp()
    with pytest.raises(ValueError, match="out of range"):
        S.TransferLearning.Builder(m).set_feature_extractor(10).build()
    with pytest.raises(ValueError, match="frozen but replaced"):
        (S.TransferLearning.Builder(m).set_feature_extractor(2)
         .remove_output_layer_and_processing()
         .add_layer(S.OutputLayer(n_in=12, n_out=2, activation="softmax",
                                  loss="mcxent")).build())
    src = _source(S, _jax_residual_graph())
    gb = S.GraphBuilder(src).n_out_replace("d2", 16)
    gb._freeze.add("d2")                    # freeze after the replace
    with pytest.raises(ValueError, match="frozen but replaced"):
        gb.build()
    with pytest.raises(ValueError, match="unknown vert"):
        S.GraphBuilder(src).set_feature_extractor("nope")
    with pytest.raises(ValueError, match="unknown layer vertices"):
        S.freeze_graph_layers(src, ["zzz"])
