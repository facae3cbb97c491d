"""Control flow in the port's graph IR against the JAX package's:
``while_loop``/``cond`` nodes over sub-SameDiffs, run as Python loops and
branches (the reference lowers them to lax.scan/while_loop/cond); the
cases of ``tests/test_control_flow.py`` in both packages, and frozen
TensorFlow graphs with StatelessWhile/StatelessIf (nested ones too)
imported through the port's wire codec to the same IR TensorFlow's own
parse gives the reference."""
import numpy as np
import pytest
import torch

from torch_graph_util import ir, npv, ns

pytest.importorskip("jax")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sum_loop(N):
    """while i < 5: acc += i; i += 1  (from i=start, acc=0)."""
    body = N.create()
    i = body.placeholder("i", (), "int32")
    acc = body.placeholder("acc", (), "float32")
    i2 = body.op("add", i, body.constant("one", np.int32(1)))
    acc2 = body.op("add", acc, body.op("cast", i, dtype="float32"))
    body.outputs = [i2.name, acc2.name]

    cond = N.create()
    ci = cond.placeholder("i", (), "int32")
    cond.placeholder("acc", (), "float32")
    lt = cond.op("less", ci, cond.constant("n", np.int32(5)))
    cond.outputs = [lt.name]

    sd = N.create()
    start = sd.placeholder("start", (), "int32")
    outs = sd.op("while_loop", start, sd.constant("z", np.float32(0)),
                 cond=cond, body=body, n_out=2)
    return sd, outs


@pytest.mark.parametrize("which", ["port", "jax"])
def test_while_loop_executes(which):
    sd, outs = _sum_loop(ns(which))
    for start, want in ((0, 10.0), (3, 7.0), (7, 0.0)):
        res = sd.output({"start": np.int32(start)}, [outs[1].name])
        assert float(npv(res[outs[1].name])) == want


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_while_loop_zip_crosses_packages(tmp_path, writer, reader):
    sd, outs = _sum_loop(ns(writer))
    p = str(tmp_path / "while.sdz")
    sd.save(p)
    sd2 = ns(reader).load(p)
    assert sd2.to_dict() == sd.to_dict()
    res = sd2.output({"start": np.int32(0)}, [outs[1].name])
    assert float(npv(res[outs[1].name])) == 10.0


def _cond_graph(N):
    then_g = N.create()
    tx = then_g.placeholder("x", (3,), "float32")
    then_g.outputs = [then_g.op(
        "mul", tx, then_g.constant("c2", np.float32(2.0))).name]
    else_g = N.create()
    ex = else_g.placeholder("x", (3,), "float32")
    else_g.outputs = [else_g.op("square", ex).name]
    sd = N.create()
    p = sd.placeholder("p", (), "bool")
    xv = sd.var("xv", np.array([1., 2., 3.], np.float32))
    co = sd.op("cond", p, xv, then=then_g, orelse=else_g, n_out=1)
    sd.set_loss_variables(sd.reduce_mean(co, name="loss"))
    return sd, co.name


def test_cond_executes_and_differentiates_as_the_reference():
    for pred, out, grad in ((True, [2., 4., 6.], [2 / 3] * 3),
                            (False, [1., 4., 9.], [2 / 3, 4 / 3, 2.])):
        res = []
        for which in ("port", "jax"):
            sd, co = _cond_graph(ns(which))
            feeds = {"p": np.bool_(pred)}
            res.append((npv(sd.output(feeds, [co])[co]),
                        npv(sd.calculate_gradients(feeds)["xv"])))
        for o, g in res:
            np.testing.assert_allclose(o, out, atol=1e-6)
            np.testing.assert_allclose(g, grad, atol=1e-6)


def test_subgraph_without_outputs_raises():
    N = ns("port")
    body = N.create()
    body.placeholder("x", (), "float32")
    sd = N.create()
    p = sd.placeholder("x", (), "float32")
    out = sd.op("cond", sd.constant("t", np.bool_(True)), p,
                then=body, orelse=body, n_out=1)
    with pytest.raises(ValueError, match="no designated outputs"):
        sd.output({"x": np.float32(1)}, [out.name])


# ---------------------------------------------------------------------------
# TF v2 functional control flow import
# ---------------------------------------------------------------------------
def _freeze(f):
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    return convert_variables_to_constants_v2(
        f.get_concrete_function(), lower_control_flow=False
    ).graph.as_graph_def()


@pytest.fixture(scope="module")
def tf_graphs():
    """{name: (frozen GraphDef, tf function, sample inputs)}: a while
    then an if; a cond nested in a while body; a bounded loop applying a
    trainable weight (stateful While, as TF emits it for a captured
    variable)."""
    tf = pytest.importorskip("tensorflow")

    @tf.function(input_signature=[tf.TensorSpec((), tf.float32)])
    def loop_then_if(x):
        i, v = tf.while_loop(lambda i, v: i < 4,
                             lambda i, v: (i + 1, v * 1.5),
                             [tf.constant(0), x])
        return tf.cond(v > 5.0, lambda: v - 5.0, lambda: v + 100.0)

    @tf.function(input_signature=[tf.TensorSpec((), tf.float32)])
    def nested(x):
        def b(i, v):
            v = tf.cond(v > 10.0, lambda: v * 0.5, lambda: v * 3.0)
            return i + 1, v
        _, v = tf.while_loop(lambda i, v: i < 3, b, [tf.constant(0), x])
        return v

    w0 = np.random.default_rng(0).normal(
        scale=0.5, size=(4, 4)).astype(np.float32)
    w = tf.Variable(w0)

    @tf.function(input_signature=[tf.TensorSpec((None, 4), tf.float32)])
    def bounded(x):
        _, v = tf.while_loop(lambda i, v: i < 3,
                             lambda i, v: (i + 1, tf.linalg.matmul(v, w)),
                             [tf.constant(0), x])
        return v

    xs = np.random.default_rng(1).normal(size=(2, 4)).astype(np.float32)
    return {"loop_then_if": (_freeze(loop_then_if), loop_then_if,
                             [np.float32(v) for v in (2.0, 0.1, -3.0)]),
            "nested": (_freeze(nested), nested,
                       [np.float32(v) for v in (1.0, 7.0)]),
            "bounded": (_freeze(bounded), bounded, [xs])}


GRAPHS = ("loop_then_if", "nested", "bounded")


@pytest.mark.parametrize("name", GRAPHS)
def test_codec_gives_the_ir_of_tensorflows_parse(tf_graphs, name):
    gd = tf_graphs[name][0]
    ops = {n.op for n in gd.node}
    assert ops & {"StatelessWhile", "While"}, ops
    port = ns("port").import_graph_def(gd.SerializeToString())
    ref = ns("jax").import_graph_def(gd)
    assert ir(port) == ir(ref)


@pytest.mark.parametrize("name", GRAPHS)
def test_imported_control_flow_matches_tensorflow(tf_graphs, name):
    import tensorflow as tf
    gd, f, samples = tf_graphs[name]
    sds = [ns(w).import_graph_def(gd) for w in ("port", "jax")]
    for x in samples:
        theirs = f(tf.constant(x)).numpy()
        for sd in sds:
            ph = [v.name for v in sd.vars.values()
                  if v.var_type == "PLACEHOLDER"][0]
            ours = npv(list(sd.output({ph: x}).values())[0])
            np.testing.assert_allclose(ours, theirs, atol=1e-5)


def test_imported_bounded_loop_matches_the_static_pattern(tf_graphs):
    sd = ns("port").import_graph_def(tf_graphs["bounded"][0])
    node = next(n for n in sd.ops if n.op_name == "while_loop")
    assert sd._while_static_pattern(node) is not None


def test_imported_bounded_loop_finetunes_as_the_reference(tf_graphs):
    """Gradients flow THROUGH the imported loop: the same SGD steps give
    the same losses (1e-5) and weights (1e-5) in both packages, the loss
    falls and the loop's weight moves."""
    gd = tf_graphs["bounded"][0]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    y = x @ rng.normal(scale=0.5, size=(4, 4)).astype(np.float32)
    res = []
    for which in ("port", "jax"):
        N = ns(which)
        sd = N.import_graph_def(gd)
        ph = [v.name for v in sd.vars.values()
              if v.var_type == "PLACEHOLDER"][0]
        out_name = [o for n in sd.ops for o in n.outputs][-1]
        tgt = sd.placeholder("target", (None, 4), "float32")
        diff = sd.op("sub", sd.vars[out_name], tgt)
        sd.set_loss_variables(sd.reduce_mean(sd.op("square", diff),
                                             name="loss"))
        sd.set_training_config(N.TrainingConfig(
            updater=N.Sgd(learning_rate=0.05),
            data_set_feature_mapping=[ph],
            data_set_label_mapping=["target"]))
        w_name = next(k for k, v in sd.vars.items()
                      if v.var_type == "VARIABLE"
                      and np.asarray(sd.values[k]).shape == (4, 4))
        before = sd.values[w_name].copy()
        losses = sd.fit([N.MultiDataSet([x], [y])] * 8, n_epochs=1)
        res.append((np.asarray(losses), sd.values[w_name], before))
    (pl, pw, b0), (jl, jw, _) = res
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pw, jw, rtol=1e-5, atol=1e-5)
    assert pl[-1] < pl[0] and not np.allclose(pw, b0)


def test_unbounded_loop_raises_clear_fit_error():
    N = ns("port")
    sd, outs = _sum_loop(N)    # counter starts from a PLACEHOLDER
    sd.set_loss_variables(sd.reduce_mean(outs[1], name="loss"))
    sd.set_training_config(N.TrainingConfig(
        updater=N.Sgd(learning_rate=0.1),
        data_set_feature_mapping=["start"],
        data_set_label_mapping=[]))
    with pytest.raises(ValueError, match="scan-convertible"):
        sd.fit([N.MultiDataSet([np.int32(0)], [])], n_epochs=1)
