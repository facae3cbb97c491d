"""ComputationGraph in the port, held to the JAX package on the same
numpy-seeded inputs with the JAX graph's parameters (and batch-norm
state) carried across: the cases of ``tests/test_computation_graph.py``
and ``tests/test_graph_advanced.py`` (an output layer that feeds a
downstream vertex), every graph vertex, the configuration JSON and the
checkpoint zip (``state.npz`` included) both ways, AdaDelta against the
JAX updater, and three AdaDelta steps of a small residual graph built
from ``ResNet50``'s own block methods (zero pad, 7x7/2 conv, batch norm,
relu, 'same' 3x3/2 max-pool, one projection and one identity bottleneck,
global average pool, softmax): loss, gradients, parameters and
batch-norm state.

Tolerances (f32): outputs and losses rtol 1e-5 (atol 1e-6), gradients,
parameters and state after training steps rtol 1e-4 (atol 1e-5 on the
AdaDelta residual graph, whose first steps are ~1e-3 in size)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy


def _ns(jax_side: bool):
    """One package's classes under the same names."""
    if jax_side:
        from deeplearning4j_tpu.data.dataset import DataSet, MultiDataSet
        from deeplearning4j_tpu.models import computation_graph as cg
        from deeplearning4j_tpu.nn.conf import graph_vertices as gv
        from deeplearning4j_tpu.nn.conf import layers_conv as conv
        from deeplearning4j_tpu.nn.conf import layers_core as core
        from deeplearning4j_tpu.nn.conf.builder import NeuralNetConfiguration
        from deeplearning4j_tpu.nn.conf.inputs import InputType
        from deeplearning4j_tpu.optimize import updaters as upd
        from deeplearning4j_tpu.utils import model_serializer as ser
        from deeplearning4j_tpu.zoo import resnet
    else:
        from deeplearning4j_torch.data.dataset import DataSet, MultiDataSet
        from deeplearning4j_torch.models import computation_graph as cg
        from deeplearning4j_torch.nn.conf import graph_vertices as gv
        from deeplearning4j_torch.nn.conf import layers_conv as conv
        from deeplearning4j_torch.nn.conf import layers_core as core
        from deeplearning4j_torch.nn.conf.builder import (
            NeuralNetConfiguration)
        from deeplearning4j_torch.nn.conf.inputs import InputType
        from deeplearning4j_torch.optimize import updaters as upd
        from deeplearning4j_torch.utils import model_serializer as ser
        from deeplearning4j_torch.zoo import resnet
    return types.SimpleNamespace(**locals())


J, P = _ns(True), _ns(False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(build):
    """(jax graph, port graph): the same configuration from both
    builders (its JSON equal), the JAX graph's parameters and state
    carried into the port on the CPU."""
    from deeplearning4j_torch.utils.convert import (load_numpy_params,
                                                    load_numpy_state)
    jconf, pconf = build(J), build(P)
    assert pconf.to_dict() == jconf.to_dict()
    jnet = J.cg.ComputationGraph(jconf).init()
    pnet = P.cg.ComputationGraph(pconf)
    load_numpy_params(pnet, _np(jnet.params_tree), device="cpu")
    load_numpy_state(pnet, _np(jnet.state_tree))
    return jnet, pnet


def _close(p, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(
        p.detach().float().numpy() if isinstance(p, torch.Tensor) else p,
        np.asarray(j), rtol=rtol, atol=atol)


def _assert_trees_close(ptree, jtree, rtol=1e-4, atol=1e-6):
    from deeplearning4j_torch.utils.trees import iter_leaves
    pl = dict(iter_leaves(ptree))
    jl = dict(iter_leaves(_np(jtree)))
    assert set(pl) == set(jl)
    for path, leaf in pl.items():
        np.testing.assert_allclose(leaf.detach().numpy(), jl[path],
                                   rtol=rtol, atol=atol,
                                   err_msg="/".join(path))


def _simple_graph(ns, seed=12, updater=None):
    return (ns.NeuralNetConfiguration.builder().seed(seed)
            .updater(updater or ns.upd.Adam(learning_rate=1e-2))
            .graph()
            .add_inputs("in")
            .set_input_types(ns.InputType.feed_forward(8))
            .add_layer("d1", ns.core.DenseLayer(n_out=16, activation="relu"),
                       "in")
            .add_layer("d2", ns.core.DenseLayer(n_out=16, activation="relu"),
                       "d1")
            .add_vertex("res", ns.gv.ElementWiseVertex("add"), "d1", "d2")
            .add_layer("out", ns.core.OutputLayer(
                n_out=3, activation="softmax", loss="mcxent"), "res")
            .set_outputs("out")
            .build())


def _xy(seed=0, n=32, n_in=8, n_out=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, n)]
    return x, y


def test_topology_shapes_and_outputs_match_jax():
    jnet, pnet = _pair(_simple_graph)
    assert pnet.conf.vertices["d1"].layer.n_in == 8
    assert pnet.conf.vertices["out"].layer.n_in == 16
    assert pnet.vertex_names() == jnet.vertex_names()
    x, _ = _xy(n=32)
    out = pnet.output(x)
    assert tuple(out.shape) == (32, 3)
    _close(out, jnet.output(x))
    _close(out.sum(1), np.ones(32), atol=1e-5)
    assert pnet.num_params() == jnet.num_params()
    assert pnet.summary().splitlines()[-1] == jnet.summary().splitlines()[-1]


def test_feed_forward_residual_add_matches_jax():
    jnet, pnet = _pair(_simple_graph)
    x, _ = _xy(n=4)
    pacts, jacts = pnet.feed_forward(x), jnet.feed_forward(x)
    assert set(pacts) == set(jacts)
    for k in jacts:
        _close(pacts[k], jacts[k])
    _close(pacts["res"], pacts["d1"] + pacts["d2"])


def test_training_steps_match_jax():
    jnet, pnet = _pair(_simple_graph)
    x, y = _xy(seed=1, n=64)
    for _ in range(5):
        jl = jnet.fit(J.DataSet(x, y))
        pl = pnet.fit(P.DataSet(x, y))
        assert pl == pytest.approx(jl, rel=1e-5)
    assert pnet.iteration_count == jnet.iteration_count == 5
    _assert_trees_close(pnet.params_tree, jnet.params_tree)
    _assert_trees_close(pnet.opt_state, jnet.opt_state, atol=1e-8)
    assert pnet.score(P.DataSet(x, y)) == pytest.approx(
        jnet.score(J.DataSet(x, y)), rel=1e-5)


def _multi_io(ns):
    return (ns.NeuralNetConfiguration.builder().seed(5)
            .updater(ns.upd.Adam(learning_rate=1e-2))
            .graph()
            .add_inputs("a", "b")
            .set_input_types(ns.InputType.feed_forward(4),
                             ns.InputType.feed_forward(6))
            .add_layer("da", ns.core.DenseLayer(n_out=8, activation="tanh"),
                       "a")
            .add_layer("db", ns.core.DenseLayer(n_out=8, activation="tanh"),
                       "b")
            .add_vertex("merged", ns.gv.MergeVertex(), "da", "db")
            .add_layer("out1", ns.core.OutputLayer(
                n_out=2, activation="softmax", loss="mcxent"), "merged")
            .add_layer("out2", ns.core.OutputLayer(
                n_out=1, activation="identity", loss="mse"), "merged")
            .set_outputs("out1", "out2")
            .build())


def test_multi_input_multi_output_matches_jax():
    jnet, pnet = _pair(_multi_io)
    assert pnet.conf.vertices["out1"].layer.n_in == 16
    rng = np.random.default_rng(2)
    xa = rng.normal(size=(16, 4)).astype(np.float32)
    xb = rng.normal(size=(16, 6)).astype(np.float32)
    y1 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    y2 = rng.normal(size=(16, 1)).astype(np.float32)
    po, jo = pnet.output(xa, xb), jnet.output(xa, xb)
    assert len(po) == 2 and tuple(po[1].shape) == (16, 1)
    for p, j in zip(po, jo):
        _close(p, j)
    for _ in range(3):
        jl = jnet.fit(J.MultiDataSet([xa, xb], [y1, y2]))
        pl = pnet.fit(P.MultiDataSet([xa, xb], [y1, y2]))
        assert pl == pytest.approx(jl, rel=1e-5)
    _assert_trees_close(pnet.params_tree, jnet.params_tree)


def test_implicit_merge_on_multi_input_layer_matches_jax():
    def build(ns):
        return (ns.NeuralNetConfiguration.builder().seed(5)
                .updater(ns.upd.Sgd(learning_rate=0.1))
                .graph()
                .add_inputs("a", "b")
                .set_input_types(ns.InputType.feed_forward(3),
                                 ns.InputType.feed_forward(5))
                .add_layer("out", ns.core.OutputLayer(
                    n_out=2, activation="softmax", loss="mcxent"), "a", "b")
                .set_outputs("out")
                .build())
    jnet, pnet = _pair(build)
    assert pnet.conf.vertices["out"].layer.n_in == 8
    rng = np.random.default_rng(3)
    xa = rng.normal(size=(4, 3)).astype(np.float32)
    xb = rng.normal(size=(4, 5)).astype(np.float32)
    _close(pnet.output(xa, xb), jnet.output(xa, xb))
    _close(pnet.output({"a": xa, "b": xb}), jnet.output(xa, xb))


@pytest.mark.parametrize("name,kw,n_in", [
    ("MergeVertex", {}, 2), ("ElementWiseVertex", {"op": "add"}, 3),
    ("ElementWiseVertex", {"op": "subtract"}, 2),
    ("ElementWiseVertex", {"op": "product"}, 2),
    ("ElementWiseVertex", {"op": "average"}, 3),
    ("ElementWiseVertex", {"op": "max"}, 2),
    ("SubsetVertex", {"from_index": 1, "to_index": 2}, 1),
    ("ScaleVertex", {"scale_factor": 2.5}, 1),
    ("ShiftVertex", {"shift_factor": 1.5}, 1),
    ("StackVertex", {}, 2),
    ("UnstackVertex", {"from_index": 1, "stack_size": 2}, 1),
    ("L2NormalizeVertex", {}, 1),
    ("ReshapeVertex", {"new_shape": (2, 2)}, 1),
    ("PreprocessorVertex", {"preprocessor": "cnn_to_ff"}, 1)],
    ids=lambda v: v if isinstance(v, str) else None)
def test_vertices_match_jax(name, kw, n_in):
    """Each vertex: its forward and input gradients, its inferred type,
    and its JSON read by the other package."""
    from deeplearning4j_tpu.nn.conf.inputs import Preprocessor as JPre

    from deeplearning4j_torch.nn.conf.inputs import Preprocessor as PPre
    shape = (6, 2, 2, 1) if name == "PreprocessorVertex" else (6, 4)
    jkw, pkw = dict(kw), dict(kw)
    if "preprocessor" in kw:
        jkw["preprocessor"] = JPre(kw["preprocessor"])
        pkw["preprocessor"] = PPre(kw["preprocessor"])
    jv, pv = getattr(J.gv, name)(**jkw), getattr(P.gv, name)(**pkw)
    assert pv.to_dict() == jv.to_dict()
    assert P.gv.vertex_from_dict(jv.to_dict()) == pv
    assert J.gv.vertex_from_dict(pv.to_dict()) == jv
    assert pv.n_inputs() == jv.n_inputs()
    it_kind = "cnn" if len(shape) == 4 else "ff"
    jt = [J.InputType(it_kind, shape[1:])] * n_in
    pt = [P.InputType(it_kind, shape[1:])] * n_in
    assert pv.infer_shapes(pt).to_dict() == jv.infer_shapes(jt).to_dict()
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=shape).astype(np.float32) for _ in range(n_in)]
    jy = jv.apply([jnp.asarray(x) for x in xs])
    g = rng.normal(size=jy.shape).astype(np.float32)
    jdx = jax.grad(lambda *a: jnp.sum(jv.apply(list(a)) * g),
                   argnums=tuple(range(n_in)))(*[jnp.asarray(x) for x in xs])
    pts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    py = pv.apply(pts)
    pdx = torch.autograd.grad((py * torch.from_numpy(g)).sum(), pts)
    _close(py, jy)
    for p, j in zip(pdx, jdx):
        _close(p, j, rtol=1e-5, atol=1e-6)


def test_graph_cycle_and_fan_in_checks_match_jax():
    for ns in (J, P):
        gb = (ns.NeuralNetConfiguration.builder().graph()
              .add_inputs("in")
              .set_input_types(ns.InputType.feed_forward(4)))
        gb.add_layer("a", ns.core.DenseLayer(n_out=4), "in", "b")
        gb.add_layer("b", ns.core.DenseLayer(n_out=4), "a")
        gb.set_outputs("b")
        with pytest.raises(ValueError, match="cycle"):
            gb.build()
        gb = (ns.NeuralNetConfiguration.builder().graph()
              .add_inputs("in")
              .set_input_types(ns.InputType.feed_forward(4)))
        gb.add_vertex("s", ns.gv.ElementWiseVertex("subtract"), "in")
        gb.add_layer("out", ns.core.OutputLayer(n_out=2), "s")
        gb.set_outputs("out")
        with pytest.raises(ValueError, match="accepts 2..2"):
            gb.build()


def test_configuration_json_reads_both_ways():
    jconf, pconf = _simple_graph(J), _simple_graph(P)
    back = P.cg.ComputationGraphConfiguration.from_json(jconf.to_json())
    assert back.to_dict() == jconf.to_dict()
    jback = J.cg.ComputationGraphConfiguration.from_json(pconf.to_json())
    assert jback.to_dict() == pconf.to_dict()
    # a configuration without a stored order gets the same topological
    # sort in both packages
    d = jconf.to_dict()
    d["topological_order"] = []
    assert (P.cg.ComputationGraphConfiguration.from_dict(d)
            .topological_order == jconf.topological_order)


def _bn_graph(ns):
    """A graph with state: dense -> batch norm -> output."""
    return (ns.NeuralNetConfiguration.builder().seed(3)
            .updater(ns.upd.AdaDelta())
            .graph()
            .add_inputs("in")
            .set_input_types(ns.InputType.feed_forward(6))
            .add_layer("d", ns.core.DenseLayer(n_out=8, activation="relu"),
                       "in")
            .add_layer("bn", ns.conv.BatchNormalization(), "d")
            .add_layer("out", ns.core.OutputLayer(
                n_out=3, activation="softmax", loss="mcxent"), "bn")
            .set_outputs("out")
            .build())


def test_checkpoints_round_trip_both_ways(tmp_path):
    """A JAX checkpoint (params, batch-norm state, AdaDelta state,
    counters) restores in the port and trains on exactly as the JAX
    graph does; the port's own checkpoint restores in the JAX package."""
    jnet, _ = _pair(_bn_graph)
    x, y = _xy(seed=5, n=16, n_in=6)
    jnet.fit(J.DataSet(x, y))
    jnet.save(tmp_path / "j.zip")
    pnet = P.ser.restore_model(tmp_path / "j.zip", device="cpu")
    assert isinstance(pnet, P.cg.ComputationGraph)
    assert pnet.iteration_count == 1
    _assert_trees_close(pnet.state_tree, jnet.state_tree, rtol=0, atol=0)
    _close(pnet.output(x), jnet.output(x))
    jl = jnet.fit(J.DataSet(x, y))
    pl = pnet.fit(P.DataSet(x, y))
    assert pl == pytest.approx(jl, rel=1e-5)
    _assert_trees_close(pnet.params_tree, jnet.params_tree)
    _assert_trees_close(pnet.state_tree, jnet.state_tree)
    pnet.save(tmp_path / "p.zip")
    back = J.ser.restore_model(str(tmp_path / "p.zip"))
    assert type(back).__name__ == "ComputationGraph"
    assert back.iteration_count == 2
    _close(pnet.output(x), back.output(x))
    _assert_trees_close(pnet.opt_state, back.opt_state, rtol=0, atol=0)
    again = P.cg.ComputationGraph.load(tmp_path / "p.zip", device="cpu")
    _close(again.output(x), pnet.output(x), rtol=0, atol=0)


def test_params_vector_order_matches_jax():
    jnet, pnet = _pair(_bn_graph)
    v = pnet.params()
    np.testing.assert_array_equal(v, np.asarray(jnet.params()))
    assert v.size == pnet.num_params() == jnet.num_params()
    other = P.cg.ComputationGraph(_bn_graph(P)).init(seed=99, device="cpu")
    other.set_params(v)
    other.state_tree = pnet.state_tree
    x, _ = _xy(seed=6, n=4, n_in=6)
    _close(other.output(x), pnet.output(x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="Expected"):
        other.set_params(v[:-1])


def test_compiled_train_step_matches_jax():
    jnet, pnet = _pair(_simple_graph)
    jstep, pstep = jnet.compiled_train_step(), pnet.compiled_train_step()
    jst, pst = jstep.init(), pstep.init()
    x, y = _xy(seed=7, n=64)
    before = {k: v.clone() for k, v in pnet.params_tree["d1"].items()}
    for _ in range(5):
        jst, jl = jstep(jst, x, y)
        pst, pl = pstep(pst, torch.from_numpy(x), y)
        assert float(pl) == pytest.approx(float(jl), rel=1e-5)
    assert pst.step == int(jst.step) == 5
    _assert_trees_close(pst.params, jst.params)
    # the step trains copies: the model's own trees are untouched
    for k, v in before.items():
        assert torch.equal(pnet.params_tree["d1"][k], v)
    # and fit after it builds the model's own optimizer state
    assert pnet.opt_state is None
    assert np.isfinite(pnet.fit(P.DataSet(x, y)))
    assert pnet.opt_state is not None


def _downstream(ns):
    return (ns.NeuralNetConfiguration.builder().seed(7)
            .updater(ns.upd.Adam(learning_rate=1e-2))
            .graph()
            .add_inputs("in")
            .set_input_types(ns.InputType.feed_forward(5))
            .add_layer("d", ns.core.DenseLayer(n_out=8, activation="tanh"),
                       "in")
            .add_layer("out1", ns.core.OutputLayer(
                n_out=3, activation="softmax", loss="mcxent"), "d")
            .add_vertex("cat", ns.gv.MergeVertex(), "d", "out1")
            .add_layer("out2", ns.core.OutputLayer(
                n_out=2, activation="softmax", loss="mcxent"), "cat")
            .set_outputs("out1", "out2")
            .build())


def test_output_layer_feeding_downstream_vertex_matches_jax():
    """The downstream consumer of an output layer sees its REAL
    activation in training too (graph_advanced's case), in both."""
    jnet, pnet = _pair(_downstream)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(16, 5)).astype(np.float32)
    y1 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    y2 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    assert pnet.score(P.MultiDataSet([x], [y1, y2])) == pytest.approx(
        jnet.score(J.MultiDataSet([x], [y1, y2])), rel=1e-5)
    for _ in range(3):
        jl = jnet.fit(J.MultiDataSet([x], [y1, y2]))
        pl = pnet.fit(P.MultiDataSet([x], [y1, y2]))
        assert pl == pytest.approx(jl, rel=1e-5)
    for p, j in zip(pnet.output(x), jnet.output(x)):
        _close(p, j, rtol=1e-4)


def _masked_rnn(ns):
    return (ns.NeuralNetConfiguration.builder().seed(9)
            .updater(ns.upd.Sgd(learning_rate=0.1))
            .graph()
            .add_inputs("a", "b")
            .set_input_types(ns.InputType.recurrent(3, 6),
                             ns.InputType.recurrent(2, 6))
            .add_vertex("m", ns.gv.MergeVertex(), "a", "b")
            .add_layer("pool", ns.conv.GlobalPoolingLayer(
                pooling_type="avg"), "m")
            .add_layer("out", ns.core.OutputLayer(
                n_out=2, activation="softmax", loss="mcxent"), "pool")
            .set_outputs("out")
            .build())


def test_masks_are_anded_across_inputs_like_jax():
    """A combining vertex's mask is the AND of its inputs' masks: the
    masked pool after the merge sees only steps valid in both."""
    jnet, pnet = _pair(_masked_rnn)
    rng = np.random.default_rng(9)
    xa = rng.normal(size=(3, 6, 3)).astype(np.float32)
    xb = rng.normal(size=(3, 6, 2)).astype(np.float32)
    ma = np.ones((3, 6), np.float32)
    mb = np.ones((3, 6), np.float32)
    ma[0, 4:] = 0.0
    mb[0, :2] = 0.0
    mb[1, 3:] = 0.0
    po = pnet.output(xa, xb, features_mask=[ma, mb])
    _close(po, jnet.output(xa, xb, features_mask=[ma, mb]))
    xa2 = xa.copy()
    xa2[0, :2] = 50.0                  # masked out by b's mask only
    _close(pnet.output(xa2, xb, features_mask=[ma, mb]), po)


def test_frozen_layers_hold_and_the_rest_matches_jax():
    jconf, pconf = _simple_graph(J), _simple_graph(P)
    jconf.frozen_layers = ["d1"]
    pconf.frozen_layers = ["d1"]
    from deeplearning4j_torch.utils.convert import load_numpy_params
    jnet = J.cg.ComputationGraph(jconf).init()
    pnet = load_numpy_params(P.cg.ComputationGraph(pconf),
                             _np(jnet.params_tree), device="cpu")
    w0 = pnet.params_tree["d1"]["W"].clone()
    x, y = _xy(seed=10, n=32)
    for _ in range(3):
        jnet.fit(J.DataSet(x, y))
        pnet.fit(P.DataSet(x, y))
    assert torch.equal(pnet.params_tree["d1"]["W"], w0)
    _assert_trees_close(pnet.params_tree, jnet.params_tree)


def test_evaluate_matches_output_argmax_and_jax():
    jnet, pnet = _pair(_simple_graph)
    x, y = _xy(seed=11, n=40)
    from deeplearning4j_tpu.data.iterator import ListDataSetIterator as JL

    from deeplearning4j_torch.data.iterator import ListDataSetIterator as PL
    pev = pnet.evaluate(PL([P.DataSet(x, y)], batch_size=16))
    jev = jnet.evaluate(JL([J.DataSet(x, y)], batch_size=16))
    np.testing.assert_array_equal(pev.confusion, jev.confusion)
    host = np.zeros((3, 3), np.int64)
    np.add.at(host, (y.argmax(-1), pnet.output(x).numpy().argmax(-1)), 1)
    np.testing.assert_array_equal(pev.confusion, host)


@pytest.mark.parametrize("rho,eps", [(0.95, 1e-6), (0.9, 1e-4)])
def test_adadelta_matches_jax(rho, eps):
    """The zoo CNNs' default updater, several updates on random grads."""
    rng = np.random.default_rng(12)
    params = {"a": {"W": rng.normal(size=(3, 4)).astype(np.float32)},
              "b": {}}
    ju, pu = J.upd.AdaDelta(rho=rho, epsilon=eps), \
        P.upd.AdaDelta(rho=rho, epsilon=eps)
    assert pu.to_dict() == ju.to_dict()
    assert P.upd.updater_from_dict(ju.to_dict()) == pu
    jst = ju.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    pst = pu.init_state({"a": {"W": torch.from_numpy(params["a"]["W"])},
                         "b": {}})
    for step in range(4):
        g = rng.normal(size=(3, 4)).astype(np.float32) * (step + 1)
        jup, jst = ju.update({"a": {"W": jnp.asarray(g)}, "b": {}}, jst,
                             None, step)
        pup, pst = pu.update({"a": {"W": torch.from_numpy(g)}, "b": {}},
                             pst, None, step)
        _close(pup["a"]["W"], jup["a"]["W"], rtol=1e-5, atol=1e-8)
    _assert_trees_close(pst, jst, rtol=1e-5, atol=1e-9)


def test_left_out_recurrent_features_raise():
    """The recurrent features this file's graphs once left out no longer
    raise: ``rnn_clear_previous_state`` on a graph without recurrent
    vertices leaves its state as it is, and truncated BPTT over a batch
    with no time axis is one ordinary step — both as in the JAX package
    (the recurrent graph cases are in test_torch_layers_recurrent.py)."""
    jnet, pnet = _pair(_simple_graph)
    state = pnet.state_tree
    pnet.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    assert pnet.state_tree == state and not pnet._has_rnn()
    for net in (jnet, pnet):
        net.conf.backprop_type = "truncated_bptt"
        net.conf.tbptt_fwd_length = 2
    x, y = _xy(n=4)
    assert pnet.fit(P.DataSet(x, y)) == pytest.approx(
        jnet.fit(J.DataSet(x, y)), rel=1e-5)
    assert pnet.iteration_count == jnet.iteration_count == 1
    _assert_trees_close(pnet.params_tree, jnet.params_tree)


def _mini_resnet(ns):
    """ResNet50's own stem and bottleneck methods at a few channels."""
    class Mini(ns.resnet.ResNet50):
        def conf(self):
            g = (ns.NeuralNetConfiguration.builder().seed(self.seed)
                 .updater(ns.upd.AdaDelta())
                 .compute_dtype("float32")
                 .weight_init("xavier")
                 .graph()
                 .add_inputs("input")
                 .set_input_types(ns.InputType.convolutional(16, 16, 3)))
            g.add_layer("pad1", ns.conv.ZeroPaddingLayer(padding=(3, 3)),
                        "input")
            stem = self._conv_bn_relu(g, "conv1", "pad1", 4, (7, 7), (2, 2))
            g.add_layer("pool1", ns.conv.SubsamplingLayer(
                kernel_size=(3, 3), stride=(2, 2), pooling_type="max",
                convolution_mode="same"), stem)
            x = self._bottleneck(g, 2, 0, "pool1", (2, 2, 6), (2, 2))
            x = self._bottleneck(g, 2, 1, x, (2, 2, 6), (1, 1))
            g.add_layer("avgpool", ns.conv.GlobalPoolingLayer(
                pooling_type="avg"), x)
            g.add_layer("output", ns.core.OutputLayer(
                n_out=3, activation="softmax", loss="mcxent"), "avgpool")
            return g.set_outputs("output").build()
    return Mini(n_classes=3, input_shape=(16, 16, 3)).conf()


def test_residual_graph_adadelta_steps_match_jax():
    jnet, pnet = _pair(_mini_resnet)
    assert "s2b0_sc" in pnet.vertex_names()     # the projection shortcut
    rng = np.random.default_rng(13)
    x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    # loss and gradients of the first step
    pnet._build_solver()
    pbatch = pnet._batch_dict(P.DataSet(x, y))
    ploss, pstate, pgrads = pnet._solver._loss_and_grads(
        pnet.params_tree, pnet.state_tree, pbatch, None)
    jbatch = {"features": jnp.asarray(x), "labels": jnp.asarray(y)}
    (jloss, jstate), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnet._score_batch(p, jnet.state_tree, jbatch, None, True),
        has_aux=True))(jnet.params_tree)
    assert float(ploss) == pytest.approx(float(jloss), rel=1e-5)
    _assert_trees_close(pgrads, jgrads, rtol=1e-4, atol=1e-5)
    _assert_trees_close(pstate, jstate, rtol=1e-5, atol=1e-6)
    # three AdaDelta steps through fit
    for _ in range(3):
        jl = jnet.fit(J.DataSet(x, y))
        pl = pnet.fit(P.DataSet(x, y))
        assert pl == pytest.approx(jl, rel=1e-5)
    _assert_trees_close(pnet.params_tree, jnet.params_tree, atol=1e-5)
    _assert_trees_close(pnet.state_tree, jnet.state_tree, atol=1e-5)
    _assert_trees_close(pnet.opt_state, jnet.opt_state, atol=1e-8)
    _close(pnet.output(x), jnet.output(x), rtol=1e-4, atol=1e-5)
