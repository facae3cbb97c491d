"""The port's recurrent stack, held to the JAX package
(``tests/test_layers_recurrent.py`` ported case by case, plus the graph
tBPTT cases of ``tests/test_graph_advanced.py``): LSTM / GravesLSTM / GRU /
SimpleRnn cell math, masking, the carry, streaming ``rnn_time_step``,
truncated BPTT, ``reverse_sequence``, ``LastTimeStep``, ``Bidirectional``
in its four modes, the JSON and parameter-vector round trips.

Each JAX configuration and its parameters carry into the port
(``utils.convert``) and both run the same numpy-seeded inputs on the CPU
in f32: outputs, carries and the parameters after six tBPTT chunks agree
within 1e-5 (the two sum in different orders).  The learning cases keep
the reference's own criteria on the port.  JAX is imported per test, so
the ``gpu`` case runs on a machine without it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.data import DataSet, MultiDataSet  # noqa: E402
from deeplearning4j_torch.models.computation_graph import (  # noqa: E402
    ComputationGraph, ComputationGraphConfiguration)
from deeplearning4j_torch.models.multi_layer_network import (  # noqa: E402
    MultiLayerNetwork)
from deeplearning4j_torch.nn.conf import (GRU, LSTM,  # noqa: E402
                                          Bidirectional, GravesLSTM,
                                          InputType, LastTimeStep,
                                          NeuralNetConfiguration,
                                          OutputLayer, RnnOutputLayer,
                                          SimpleRnn)
from deeplearning4j_torch.nn.conf.base import layer_from_dict  # noqa: E402
from deeplearning4j_torch.nn.conf.builder import (  # noqa: E402
    MultiLayerConfiguration)
from deeplearning4j_torch.nn.conf.layers_recurrent import (  # noqa: E402
    last_time_step, reverse_sequence)
from deeplearning4j_torch.optimize.updaters import Adam  # noqa: E402
from deeplearning4j_torch.utils.convert import (  # noqa: E402
    load_numpy_params)
from deeplearning4j_torch.utils.trees import iter_leaves  # noqa: E402

KINDS = ("LSTM", "GravesLSTM", "GRU", "SimpleRnn")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread for each test: the recurrence is many
    small CPU ops, whose thread pools would starve each other under the
    suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    return pytest.importorskip("jax")


def _np_tree(tree):
    jax = _jax()
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(jnet):
    """The port's copy of a JAX network (configuration and parameters) on
    the CPU."""
    d = jnet.conf.to_dict()
    if "vertices" in d:
        net = ComputationGraph(ComputationGraphConfiguration.from_dict(d))
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(d))
    return load_numpy_params(net, _np_tree(jnet.params_tree), device="cpu")


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _assert_params_close(pnet, jnet, tol=1e-5):
    want = dict(iter_leaves(_np_tree(jnet.params_tree)))
    got = list(iter_leaves(pnet.params_tree))
    assert [p for p, _ in got] == sorted(want)
    for path, leaf in got:
        _close(leaf, want[path], tol)


def _jlayer(kind, **kw):
    from deeplearning4j_tpu.nn.conf import layers_recurrent as jr
    return getattr(jr, kind)(**kw)


def _seq_model(layer, n_in=6, n_out=4, seed=3, tbptt=None):
    """The reference's ``_seq_model`` in the JAX package (``layer`` a
    JAX layer)."""
    _jax()
    from deeplearning4j_tpu import MultiLayerNetwork as JNet
    from deeplearning4j_tpu import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JType
    from deeplearning4j_tpu.nn.conf.layers_recurrent import (
        RnnOutputLayer as JOut)
    from deeplearning4j_tpu.optimize.updaters import Adam as JAdam
    b = (JConf.builder().seed(seed)
         .updater(JAdam(learning_rate=5e-3))
         .list()
         .layer(layer)
         .layer(JOut(n_out=n_out, activation="softmax", loss="mcxent"))
         .set_input_type(JType.recurrent(n_in)))
    if tbptt:
        b.backprop_type("truncated_bptt", tbptt)
    return JNet(b.build()).init()


def _port_seq_model(layer, n_in=6, n_out=4, seed=3, tbptt=None):
    """The same model built by the port's builder (the port's own init)."""
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(Adam(learning_rate=5e-3))
         .list()
         .layer(layer)
         .layer(RnnOutputLayer(n_out=n_out, activation="softmax",
                               loss="mcxent"))
         .set_input_type(InputType.recurrent(n_in)))
    if tbptt:
        b.backprop_type("truncated_bptt", tbptt)
    return MultiLayerNetwork(b.build()).init(device="cpu")


def _toy_seq(rng, b=16, t=12, n_in=6, n_cls=4):
    """Label at each step = argmax of the input a step earlier (forces the
    net to use its recurrent state)."""
    x = rng.normal(size=(b, t, n_in)).astype(np.float32)
    src = np.argmax(x[:, :-1, :n_cls], axis=-1)
    lab = np.concatenate([np.zeros((b, 1), np.int64), src], axis=1)
    y = np.eye(n_cls, dtype=np.float32)[lab]
    return x, y


def _numpy_lstm(x, W, R, bias, h0, c0):
    """Reference LSTM (gate order i,f,g,o; sigmoid gates, tanh act)."""
    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))
    b, t, _ = x.shape
    h_dim = R.shape[0]
    h, c = h0.copy(), c0.copy()
    ys = []
    for step in range(t):
        z = x[:, step] @ W + h @ R + bias
        i, f, g, o = (z[:, :h_dim], z[:, h_dim:2 * h_dim],
                      z[:, 2 * h_dim:3 * h_dim], z[:, 3 * h_dim:])
        c = sig(f) * c + sig(i) * np.tanh(g)
        h = sig(o) * np.tanh(c)
        ys.append(h)
    return np.stack(ys, 1), h, c


def _t(a):
    return torch.from_numpy(np.array(a))


def test_lstm_matches_numpy_reference(rng):
    ly = LSTM(n_in=5, n_out=7, weight_init="xavier")
    params = ly.init(torch.Generator().manual_seed(0), device="cpu")
    x = rng.normal(size=(3, 9, 5)).astype(np.float32)
    y, state = ly.apply(params, {}, _t(x))
    ref, hT, cT = _numpy_lstm(
        x, params["W"].numpy(), params["R"].numpy(), params["b"].numpy(),
        np.zeros((3, 7), np.float32), np.zeros((3, 7), np.float32))
    assert np.allclose(y.numpy(), ref, atol=1e-5)
    assert np.allclose(state["rnn_h"].numpy(), hT, atol=1e-5)
    assert np.allclose(state["rnn_c"].numpy(), cT, atol=1e-5)


def test_lstm_forget_bias_init():
    ly = LSTM(n_in=4, n_out=3, weight_init="xavier",
              forget_gate_bias_init=1.0)
    b = ly.init(torch.Generator().manual_seed(0), device="cpu")["b"].numpy()
    assert np.all(b[3:6] == 1.0) and np.all(b[:3] == 0.0)
    g = GravesLSTM(n_in=4, n_out=3).init(torch.Generator().manual_seed(0))
    assert sorted(g) == ["P", "R", "W", "b"] and not g["P"].any()
    assert {k: tuple(v.shape) for k, v in g.items()} == \
        GravesLSTM(n_in=4, n_out=3).param_shapes()


@pytest.mark.parametrize("kind", KINDS)
def test_layer_forward_masked_and_carry_match_jax(rng, kind):
    """The cell math of each layer against the JAX package's, from the
    same parameters (peepholes and biases drawn non-zero): the forward
    and its final carry, from zeros and from a given carry, unmasked and
    masked (the carry held and the output zeroed past each length)."""
    jax = _jax()
    jly = _jlayer(kind, n_in=5, n_out=7, weight_init="xavier")
    params, _ = jly.init(jax.random.PRNGKey(1))
    params = {k: np.asarray(v) + (rng.normal(0, 0.3, v.shape).astype(
        np.float32) if k in ("P", "b") else 0) for k, v in params.items()}
    ply = layer_from_dict(jly.to_dict())
    assert type(ply).__name__ == kind and ply.to_dict() == jly.to_dict()
    assert ply.param_shapes() == {k: v.shape for k, v in params.items()}
    tparams = {k: _t(v) for k, v in params.items()}
    x = rng.normal(size=(4, 9, 5)).astype(np.float32)
    mask = np.ones((4, 9), np.float32)
    mask[0, 3:] = 0.0
    mask[2, 6:] = 0.0
    keys = ply.CARRY_KEYS
    carry0 = {k: rng.normal(size=(4, 7)).astype(np.float32) for k in keys}
    for m in (None, mask):
        for state in ({}, carry0):
            jy, jstate = jly.apply(params, dict(state), x, training=False,
                                   mask=m)
            py, pstate = ply.apply(tparams, {k: _t(v)
                                             for k, v in state.items()},
                                   _t(x), mask=None if m is None else _t(m))
            _close(py, jy)
            assert sorted(pstate) == sorted(jstate) == sorted(keys)
            for k in keys:
                _close(pstate[k], jstate[k])
            if m is not None:
                assert np.all(py.numpy()[0, 3:] == 0.0)


@pytest.mark.parametrize("kind", KINDS)
def test_recurrent_layers_learn_shifted_argmax(rng, kind):
    """The JAX package's model carried into the port scores the same,
    then learns the shifted argmax on the port alone."""
    jnet = _seq_model(_jlayer(kind, n_out=8, activation="tanh"))
    model = _carry(jnet)
    x, y = _toy_seq(rng, b=32)
    ds = DataSet(x, y)
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    s0 = model.score(ds)
    assert s0 == pytest.approx(jnet.score(JDataSet(x, y)), rel=1e-5)
    for _ in range(150):
        model.fit(ds)
    s1 = model.score(ds)
    assert s1 < s0 * 0.6, (s0, s1)


def test_masking_holds_state_and_zeroes_output(rng):
    jax = _jax()
    jly = _jlayer("LSTM", n_in=4, n_out=5, activation="tanh",
                  weight_init="xavier")
    jparams, _ = jly.init(jax.random.PRNGKey(1))
    ly = layer_from_dict(jly.to_dict())
    params = {k: _t(v) for k, v in _np_tree(jparams).items()}
    x = rng.normal(size=(2, 6, 4)).astype(np.float32)
    mask = np.ones((2, 6), np.float32)
    mask[0, 3:] = 0.0  # example 0: only 3 valid steps
    y, state = ly.apply(params, {}, _t(x), mask=_t(mask))
    jy, _ = jly.apply(jparams, {}, x, training=False, mask=mask)
    _close(y, jy)
    y = y.numpy()
    # masked outputs are exactly zero
    assert np.all(y[0, 3:] == 0.0)
    # final carry equals the step-2 hidden state (held through padding)
    _, state_short = ly.apply(params, {}, _t(x[:, :3]))
    assert np.allclose(state["rnn_h"].numpy()[0],
                       state_short["rnn_h"].numpy()[0], atol=1e-6)


def test_rnn_time_step_streaming_matches_full_forward(rng):
    jnet = _seq_model(_jlayer("LSTM", n_out=8, activation="tanh"))
    model = _carry(jnet)
    x, _ = _toy_seq(rng, b=4, t=10)
    full = model.output(x).numpy()
    _close(full, jnet.output(x))
    model.rnn_clear_previous_state()
    h1 = model.rnn_time_step(x[:, :4]).numpy()
    h2 = model.rnn_time_step(x[:, 4:]).numpy()
    stream = np.concatenate([h1, h2], axis=1)
    assert np.allclose(stream, full, atol=1e-5)
    # the JAX package streams the same values
    jnet.rnn_clear_previous_state()
    np.asarray(jnet.rnn_time_step(x[:, :4]))
    _close(h2, jnet.rnn_time_step(x[:, 4:]))
    # single-step form returns [b, out]
    model.rnn_clear_previous_state()
    s = model.rnn_time_step(x[:, 0])
    assert s.shape == (4, 4)
    assert not s.requires_grad


def test_tbptt_fit_runs_and_counts_iterations(rng):
    model = _port_seq_model(LSTM(n_out=8, activation="tanh"), tbptt=4)
    x, y = _toy_seq(rng, b=8, t=12)
    model.fit(DataSet(x, y))
    # 12 steps / tbptt 4 = 3 chunks = 3 iterations
    assert model.iteration_count == 3 and model.batch_in_epoch == 0
    # carry stripped after the batch
    assert not any(k.startswith("rnn_")
                   for k in model.state_tree["layer_0"])


@pytest.mark.parametrize("kind", KINDS)
def test_tbptt_params_match_jax_after_six_chunks(rng, kind):
    """tBPTT 4 over t 12, two batches (the second masked, a ragged last
    chunk of 2 steps on t 14): six optimizer steps in both packages from
    the same parameters; the carry flows across the chunks of a batch
    (gradients stop at each chunk's start) and is cleared between
    batches.  Params and the last loss within 1e-5."""
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    jnet = _seq_model(_jlayer(kind, n_out=8, activation="tanh"), tbptt=4)
    model = _carry(jnet)
    x1, y1 = _toy_seq(rng, b=8, t=12)
    x2, y2 = _toy_seq(rng, b=6, t=14)
    mask = np.ones((6, 14), np.float32)
    mask[1, 9:] = 0.0
    mask[4, 3:] = 0.0
    losses = []
    for net, ds_cls in ((jnet, JDataSet), (model, DataSet)):
        losses.append([net.fit(ds_cls(x1, y1)),
                       net.fit(ds_cls(x2, y2, mask, mask.copy()))])
    assert model.iteration_count == jnet.iteration_count == 7
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    _assert_params_close(model, jnet)
    assert not any(k.startswith("rnn_") for s in model.state_tree.values()
                   for k in s)


def test_tbptt_converges(rng):
    model = _port_seq_model(GravesLSTM(n_out=12, activation="tanh"),
                            tbptt=6)
    x, y = _toy_seq(rng, b=32, t=12)
    ds = DataSet(x, y)
    s0 = model.score(ds)
    for _ in range(80):
        model.fit(ds)
    assert model.score(ds) < s0 * 0.7


def test_reverse_sequence_mask_aware():
    x = np.arange(12, dtype=np.float32).reshape(1, 4, 3)
    x = np.concatenate([x, x + 100], axis=0)
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], np.float32)
    r = reverse_sequence(_t(x), _t(mask)).numpy()
    # example 0: first 3 steps reversed, padding step untouched
    assert np.allclose(r[0, :3], x[0, :3][::-1])
    assert np.allclose(r[0, 3], x[0, 3])
    # example 1: full flip
    assert np.allclose(r[1], x[1][::-1])
    _jax()
    from deeplearning4j_tpu.nn.conf.layers_recurrent import (
        reverse_sequence as jrev)
    assert np.array_equal(r, np.asarray(jrev(x, mask)))
    assert np.array_equal(reverse_sequence(_t(x), None).numpy(),
                          np.asarray(jrev(x, None)))
    # a [b, t] tensor reverses too
    assert np.array_equal(reverse_sequence(_t(x[..., 0]), _t(mask)).numpy(),
                          np.asarray(jrev(x[..., 0], mask)))


def test_last_time_step_layer(rng):
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    mask = np.array([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]],
                    np.float32)
    out = last_time_step(_t(x), _t(mask)).numpy()
    assert np.allclose(out[0], x[0, 1])
    assert np.allclose(out[1], x[1, 4])
    assert np.allclose(out[2], x[2, 0])
    _jax()
    from deeplearning4j_tpu.nn.conf.layers_recurrent import (
        last_time_step as jlast)
    assert np.array_equal(out, np.asarray(jlast(x, mask)))
    assert np.array_equal(last_time_step(_t(x), None).numpy(), x[:, -1])


def _bidir_model(mode, seed=7, lr=5e-3):
    """The reference's Bidirectional + LastTimeStep classifier in the JAX
    package."""
    _jax()
    from deeplearning4j_tpu import MultiLayerNetwork as JNet
    from deeplearning4j_tpu import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JType
    from deeplearning4j_tpu.nn.conf.layers_core import OutputLayer as JOut
    from deeplearning4j_tpu.nn.conf.layers_recurrent import (
        Bidirectional as JBi, LastTimeStep as JLast)
    from deeplearning4j_tpu.optimize.updaters import Adam as JAdam
    conf = (JConf.builder().seed(seed)
            .updater(JAdam(learning_rate=lr))
            .list()
            .layer(JBi(layer=_jlayer("LSTM", n_out=8, activation="tanh"),
                       mode=mode))
            .layer(JLast(layer=_jlayer("LSTM", n_out=8, activation="tanh")))
            .layer(JOut(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(JType.recurrent(4))
            .build())
    return JNet(conf).init()


@pytest.mark.parametrize("mode", ("concat", "add", "mul", "average"))
def test_bidirectional_modes_match_jax(rng, mode):
    """Each combine mode against the JAX package from the same params:
    the masked output (each example's valid prefix reversed for the
    backward direction), then three fit steps on the masked batch."""
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    jnet = _bidir_model(mode)
    model = _carry(jnet)
    assert sorted(model.params_tree["layer_0"]) == ["bwd", "fwd"]
    x = rng.normal(size=(6, 7, 4)).astype(np.float32)
    mask = np.ones((6, 7), np.float32)
    mask[0, 4:] = 0.0
    mask[3, 2:] = 0.0
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 6)]
    _close(model.output(x, features_mask=mask),
           jnet.output(x, features_mask=mask))
    for _ in range(3):
        jl = jnet.fit(JDataSet(x, y, features_mask=mask))
        pl = model.fit(DataSet(x, y, features_mask=mask))
        assert pl == pytest.approx(jl, rel=1e-5)
    _assert_params_close(model, jnet)


def test_bidirectional_concat_and_classification(rng):
    model = _carry(_bidir_model("concat"))
    # sequence classification: does the sequence sum start positive?
    x = rng.normal(size=(32, 6, 4)).astype(np.float32)
    lab = (x[:, 0].sum(-1) > 0).astype(np.int64)
    y = np.eye(2, dtype=np.float32)[lab]
    ds = DataSet(x, y)
    s0 = model.score(ds)
    for _ in range(100):
        model.fit(ds)
    assert model.score(ds) < s0


def test_recurrent_json_round_trip():
    model = _port_seq_model(GravesLSTM(n_out=8, activation="tanh"),
                            tbptt=4)
    s = model.conf.to_json()
    conf2 = MultiLayerConfiguration.from_json(s)
    assert isinstance(conf2.layers[0], GravesLSTM)
    assert conf2.tbptt_fwd_length == 4
    m2 = MultiLayerNetwork(conf2).init(seed=3, device="cpu")
    x = np.zeros((2, 5, 6), np.float32)
    assert tuple(m2.output(x).shape) == (2, 5, 4)
    # the same builder calls give the JAX package's configuration
    jnet = _seq_model(_jlayer("GravesLSTM", n_out=8, activation="tanh"),
                      tbptt=4)
    assert model.conf.to_dict() == jnet.conf.to_dict()


def test_rnn_time_step_does_not_pollute_output(rng):
    """DL4J keeps rnnTimeStep state in a separate stateMap: output() after
    streaming must still start from zero state."""
    model = _port_seq_model(LSTM(n_out=8, activation="tanh"))
    x, _ = _toy_seq(rng, b=4, t=10)
    clean = model.output(x).numpy()
    model.rnn_time_step(x)  # stores streaming carry
    again = model.output(x).numpy()
    assert np.allclose(clean, again, atol=1e-6)
    # and streaming continues independently
    model.rnn_clear_previous_state()
    h1 = model.rnn_time_step(x[:, :5]).numpy()
    _ = model.output(x)  # interleaved inference
    h2 = model.rnn_time_step(x[:, 5:]).numpy()
    full = model.output(x).numpy()
    assert np.allclose(np.concatenate([h1, h2], 1), full, atol=1e-5)


def test_carry_not_leaked_with_last_time_step_wrapper(rng):
    """LastTimeStep(LSTM) must still count as recurrent for carry
    stripping between batches."""
    conf = (NeuralNetConfiguration.builder().seed(2)
            .updater(Adam(learning_rate=1e-3)).list()
            .layer(LastTimeStep(layer=LSTM(n_out=6)))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(3)).build())
    model = MultiLayerNetwork(conf).init(device="cpu")
    assert model._has_rnn()
    x = rng.normal(size=(8, 5, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    model.fit(DataSet(x, y))
    assert not any(k.startswith("rnn_")
                   for k in model.state_tree["layer_0"])


def test_bidirectional_params_vector_round_trip(rng):
    """Flattened-params APIs handle the nested {fwd,bwd} layout, in the
    JAX package's order."""
    _jax()
    from deeplearning4j_tpu import MultiLayerNetwork as JNet
    from deeplearning4j_tpu import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JType
    from deeplearning4j_tpu.nn.conf.layers_recurrent import (
        Bidirectional as JBi, RnnOutputLayer as JOut)
    from deeplearning4j_tpu.optimize.updaters import Adam as JAdam
    jconf = (JConf.builder().seed(2)
             .updater(JAdam(learning_rate=1e-3)).l2(1e-4).list()
             .layer(JBi(layer=_jlayer("LSTM", n_out=6), mode="concat"))
             .layer(JOut(n_out=2, activation="softmax", loss="mcxent"))
             .set_input_type(JType.recurrent(3)).build())
    jnet = JNet(jconf).init()
    m1 = _carry(jnet)
    v = m1.params()
    assert v.size == m1.num_params()
    assert np.array_equal(v, np.asarray(jnet.params()))
    m2 = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(m1.conf.to_json())).init(
            seed=77, device="cpu")
    m2.set_params(v)
    x = np.random.default_rng(1).normal(size=(2, 5, 3)).astype(np.float32)
    assert np.allclose(m1.output(x).numpy(), m2.output(x).numpy(),
                       atol=1e-6)
    assert "Bidirectional" in m1.summary()
    # l2 regularization reaches the nested weights, as in the JAX package
    reg = float(m1._regularization_score(m1.params_tree))
    assert reg > 0.0
    assert reg == pytest.approx(
        float(jnet._regularization_score(jnet.params_tree)), rel=1e-5)


def test_bidirectional_json_round_trip():
    bd = Bidirectional(layer=LSTM(n_in=4, n_out=8, activation="tanh"),
                       mode="add")
    bd2 = layer_from_dict(bd.to_dict())
    assert isinstance(bd2.layer, LSTM)
    assert bd2.mode == "add" and bd2.layer.n_out == 8
    # the JAX package's nested JSON reads into the port, and back
    _jax()
    from deeplearning4j_tpu.nn.conf.layers_recurrent import (
        Bidirectional as JBi, LastTimeStep as JLast)
    for j in (JBi(layer=_jlayer("GRU", n_in=4, n_out=8), mode="mul"),
              JLast(layer=_jlayer("SimpleRnn", n_in=4, n_out=3))):
        p = layer_from_dict(j.to_dict())
        assert type(p.layer).__name__ == type(j.layer).__name__
        assert p.to_dict() == j.to_dict()


def _seq_graph(tbptt=None):
    """The reference's ``_seq_graph`` (tests/test_graph_advanced.py) in
    the JAX package."""
    _jax()
    from deeplearning4j_tpu import ComputationGraph as JGraph
    from deeplearning4j_tpu import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JType
    from deeplearning4j_tpu.nn.conf.layers_recurrent import (
        RnnOutputLayer as JOut)
    from deeplearning4j_tpu.optimize.updaters import Adam as JAdam
    gb = (JConf.builder().seed(3)
          .updater(JAdam(learning_rate=5e-3))
          .graph()
          .add_inputs("in")
          .set_input_types(JType.recurrent(6))
          .add_layer("lstm", _jlayer("LSTM", n_out=8, activation="tanh"),
                     "in")
          .add_layer("out", JOut(n_out=4, activation="softmax",
                                 loss="mcxent"), "lstm")
          .set_outputs("out"))
    if tbptt:
        gb.backprop_type("truncated_bptt", tbptt)
    return JGraph(gb.build()).init()


def _seq_xy(rng, b=8, t=12, f=6, c=4):
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, (b, t))]
    return x, y


def test_graph_tbptt_chunks_and_trains(rng):
    model = _carry(_seq_graph(tbptt=4))
    x, y = _seq_xy(rng, t=12)
    ds = DataSet(x, y)
    before = model.score(ds)
    model.fit(ds)
    # 12 timesteps / tbptt 4 -> 3 parameter updates for one batch
    assert model.iteration_count == 3
    for _ in range(20):
        model.fit(ds)
    assert model.score(ds) < before


def test_graph_tbptt_matches_mds(rng):
    model = _carry(_seq_graph(tbptt=5))
    x, y = _seq_xy(rng, t=12)
    model.fit(MultiDataSet([x], [y]))
    # ceil(12/5) = 3 chunks
    assert model.iteration_count == 3


def test_graph_tbptt_carry_survives_between_chunks(rng):
    """The graph threads the recurrent vertex's carry from chunk to chunk
    within a batch, as the JAX package does: params after two batches of
    three chunks within 1e-5; a run that drops the carry at every chunk
    differs."""
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    jnet = _seq_graph(tbptt=4)
    model, fresh = _carry(jnet), _carry(jnet)
    x, y = _seq_xy(rng, t=12)
    for _ in range(2):
        assert model.fit(DataSet(x, y)) == pytest.approx(
            jnet.fit(JDataSet(x, y)), rel=1e-5)
    _assert_params_close(model, jnet)
    assert model.state_tree["lstm"] == {}
    # the carry between chunks matters: dropping it after every chunk
    # (stripping what each step stored) trains other params
    from deeplearning4j_torch.nn.conf.layers_recurrent import (
        strip_rnn_carry)
    from deeplearning4j_torch.optimize.listeners import TrainingListener

    class DropCarry(TrainingListener):
        def iteration_done(self, m, iteration, epoch, loss):
            m.state_tree = strip_rnn_carry(m.state_tree)

    fresh.set_listeners(DropCarry())
    for _ in range(2):
        fresh.fit(DataSet(x, y))
    assert not np.allclose(fresh.params_tree["lstm"]["R"].numpy(),
                           model.params_tree["lstm"]["R"].numpy(),
                           atol=1e-6)


@pytest.mark.gpu
def test_cuda_rnn_matches_cpu():
    """chip_smoke.py's rnn part (a) at a small width on the card: f32
    against the CPU in f64 within its stated bounds (output, loss,
    gradients, rnn_time_step, a masked stream and its held carry, the
    Bidirectional + LastTimeStep net's output and fit step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card; see README)")
    import chip_smoke
    cfg = dict(chip_smoke.RNN_CFG, hidden=32, batch=4, tbptt=20)
    row = chip_smoke.rnn_card_vs_cpu(torch, np, "cuda", cfg)
    assert set(row["errors"]) == set(row["bounds"])
