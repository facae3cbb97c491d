"""The layers the BERT slice adds to the port, each against its JAX
counterpart on the same numpy-seeded inputs: ``GlobalPoolingLayer``
(max, avg, sum, pnorm; with a [b, t] mask, a fully masked row, and
``collapse_dimensions=False``), ``ActivationLayer``, ``DropoutLayer`` (at
rate 0 and in inference), ``EmbeddingLayer`` and ``LossLayer``; then a
small network of them, its configuration JSON, its parameters carried
across (``utils.convert``), its output and its loss.  f32: outputs within
1e-6 (pnorm 1e-5), input gradients within 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from deeplearning4j_tpu.nn.conf import layers_conv as jconv  # noqa: E402
from deeplearning4j_tpu.nn.conf import layers_core as jcore  # noqa: E402

from deeplearning4j_torch.nn.conf import layers_conv as pconv  # noqa: E402
from deeplearning4j_torch.nn.conf import layers_core as pcore  # noqa: E402
from deeplearning4j_torch.nn.conf.inputs import (InputType,  # noqa: E402
                                                 Preprocessor, adapt)


def _run_jax(layer, x, mask=None, params=None):
    """(y, d sum(y * g) / dx) of the JAX layer, g fixed by a seed."""
    kw = {"mask": None if mask is None else jnp.asarray(mask)} \
        if getattr(layer, "USES_MASK", False) else {}

    def fwd(xx):
        return layer.apply(params or {}, {}, xx, training=False, **kw)[0]

    y = fwd(jnp.asarray(x))
    g = np.random.default_rng(99).normal(size=y.shape).astype(np.float32)
    dx = jax.grad(lambda xx: jnp.sum(fwd(xx) * g))(jnp.asarray(x))
    return np.asarray(y), np.asarray(dx)


def _run_port(layer, x, mask=None, params=None):
    kw = {"mask": None if mask is None else torch.from_numpy(mask)} \
        if getattr(layer, "USES_MASK", False) else {}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer.apply(params or {}, xt, **kw)
    g = np.random.default_rng(99).normal(size=tuple(y.shape)).astype(
        np.float32)
    (dx,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), xt)
    return y.detach().numpy(), dx.numpy()


def _seq(seed=0, b=3, t=7, f=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[1, 4:] = 0.0                 # a padded row
    mask[2, :] = 0.0                  # a fully masked row
    return x, mask


@pytest.mark.parametrize("collapse", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_matches_jax(pooling, masked, collapse):
    x, mask = _seq()
    if pooling == "pnorm":
        x = x + np.sign(x) * 0.1      # keep |x| away from pnorm's kink
    kw = dict(pooling_type=pooling, pnorm=3, collapse_dimensions=collapse)
    jl, pl = jconv.GlobalPoolingLayer(**kw), pconv.GlobalPoolingLayer(**kw)
    assert pl.to_dict() == jl.to_dict()
    assert pl.infer_shapes((7, 5)) == jl.infer_shapes((7, 5))
    assert pl.OUTPUT_KIND == jl.OUTPUT_KIND
    m = mask if masked else None
    jy, jdx = _run_jax(jl, x, m)
    py, pdx = _run_port(pl, x, m)
    assert py.shape == jy.shape == ((3, 5) if collapse else (3, 1, 5))
    tol = 1e-5 if pooling == "pnorm" else 1e-6
    np.testing.assert_allclose(py, jy, rtol=tol, atol=tol)
    np.testing.assert_allclose(pdx, jdx, rtol=1e-5, atol=1e-5)
    if masked:
        # the fully masked row pools to 0 (not -inf under max); padded
        # positions get no gradient.  Under pnorm the fully masked row's
        # gradient is 0 * inf = NaN in both packages (d 0^(1/p)).
        assert np.all(py[2] == 0.0)
        assert np.all(pdx[1, 4:] == 0.0)
        if pooling == "pnorm":
            assert np.isnan(jdx[2]).all() and np.isfinite(pdx[:2]).all()
        else:
            assert np.all(pdx[2] == 0.0) and np.isfinite(pdx).all()


def test_global_pooling_bf16_masked_avg_matches_jax():
    """BERT's head in bf16 compute: masked average over [b, t, f] bf16."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 512, 16)).astype(np.float32)
    mask = np.ones((2, 512), np.float32)
    mask[1, 300:] = 0.0
    layer_kw = dict(pooling_type="avg")
    jy = jconv.GlobalPoolingLayer(**layer_kw).apply(
        {}, {}, jnp.asarray(x, jnp.bfloat16), training=False,
        mask=jnp.asarray(mask))[0]
    py = pconv.GlobalPoolingLayer(**layer_kw).apply(
        {}, torch.from_numpy(x).bfloat16(), mask=torch.from_numpy(mask))
    assert py.dtype == torch.bfloat16
    np.testing.assert_allclose(py.float().numpy(),
                               np.asarray(jy, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_global_pooling_builds_after_rnn_and_refuses_ff():
    """WANTED_KINDS is a tuple (cnn, rnn): an rnn input passes as it is;
    a feed-forward input has no adapter to either kind."""
    from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.layers_core import OutputLayer
    conf = (NeuralNetConfiguration.builder().list()
            .set_input_type(InputType.recurrent(6, 9))
            .layer(pconv.GlobalPoolingLayer(pooling_type="sum"))
            .layer(OutputLayer(n_out=2, activation="softmax"))
            .build())
    assert conf.preprocessors == [None, None]
    assert conf.layers[1].n_in == 6
    with pytest.raises(ValueError, match="GlobalPoolingLayer"):
        (NeuralNetConfiguration.builder().list()
         .set_input_type(InputType.feed_forward(6))
         .layer(pconv.GlobalPoolingLayer())
         .layer(OutputLayer(n_out=2)).build())


def test_input_types_and_adapters_match_jax():
    from deeplearning4j_tpu.nn.conf import inputs as jin
    for it, jit in ((InputType.recurrent(8, 5), jin.InputType.recurrent(8, 5)),
                    (InputType.recurrent(8), jin.InputType.recurrent(8)),
                    (InputType.feed_forward(3),
                     jin.InputType.feed_forward(3))):
        assert it.to_dict() == jit.to_dict()
        assert InputType.from_dict(jit.to_dict()) == it
        for kind in ("any", "ff", "rnn"):
            try:
                want = jin.adapt(jit, kind)
            except ValueError:
                with pytest.raises(ValueError):
                    adapt(it, kind)
                continue
            pre, out = adapt(it, kind)
            assert out.to_dict() == want[1].to_dict()
            assert (None if pre is None else pre.to_dict()) == \
                (None if want[0] is None else want[0].to_dict())
    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    np.testing.assert_array_equal(
        Preprocessor("rnn_to_ff")(torch.from_numpy(x)).numpy(),
        np.asarray(jin.Preprocessor("rnn_to_ff")(jnp.asarray(x))))


@pytest.mark.parametrize("act", ["relu", "tanh", "gelu", "softmax"])
def test_activation_layer_matches_jax(act):
    x, _ = _seq(2)
    jy, jdx = _run_jax(jcore.ActivationLayer(activation=act), x)
    py, pdx = _run_port(pcore.ActivationLayer(activation=act), x)
    np.testing.assert_allclose(py, jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pdx, jdx, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rate,training", [(0.0, True), (0.5, False),
                                           (0.0, False)])
def test_dropout_layer_identity_cases_match_jax(rate, training):
    """Rate 0 while training, and any rate in inference, pass x through
    unchanged in both packages (the draws themselves differ by design:
    torch generator vs threefry)."""
    x, _ = _seq(3)
    jl, pl = jcore.DropoutLayer(rate=rate), pcore.DropoutLayer(rate=rate)
    assert pl.to_dict() == jl.to_dict()
    jy = jl.apply({}, {}, jnp.asarray(x), training=training,
                  rng=jax.random.key(0))[0]
    py = pl.apply({}, torch.from_numpy(x), training=training, rng=5)
    np.testing.assert_array_equal(py.numpy(), x)
    np.testing.assert_array_equal(np.asarray(jy), x)


def test_dropout_layer_training_draws_keep_scale():
    """In training at rate 0.5 the port's draws zero about half the
    entries and scale the rest by 1 / keep, reproducibly per key."""
    x = np.ones((64, 64), np.float32)
    pl = pcore.DropoutLayer(rate=0.5)
    y1 = pl.apply({}, torch.from_numpy(x), training=True, rng=7).numpy()
    y2 = pl.apply({}, torch.from_numpy(x), training=True, rng=7).numpy()
    np.testing.assert_array_equal(y1, y2)
    assert set(np.unique(y1)) <= {0.0, 2.0}
    assert 0.4 < (y1 == 0).mean() < 0.6


@pytest.mark.parametrize("has_bias,shape", [(False, (6,)), (True, (6, 1)),
                                            (True, (2, 3))])
def test_embedding_layer_matches_jax(has_bias, shape):
    kw = dict(n_in=11, n_out=4, has_bias=has_bias, activation="tanh",
              bias_init=0.25)
    jl, pl = jcore.EmbeddingLayer(**kw), pcore.EmbeddingLayer(**kw)
    assert pl.to_dict() == jl.to_dict()
    assert pl.infer_shapes((1,)) == jl.infer_shapes((1,))
    jp, _ = jl.init(jax.random.key(0))
    pp = pl.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in pp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()} == pl.param_shapes()
    if has_bias:
        assert torch.all(pp["b"] == 0.25)
    ids = np.random.default_rng(4).integers(0, 11, shape).astype(np.int32)
    jy = np.asarray(jl.apply(jp, {}, jnp.asarray(ids), training=False)[0])
    carried = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    py = pl.apply(carried, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(py, jy, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("loss,act", [("mcxent", "softmax"), ("mse",
                                                              "identity"),
                                      ("xent", "sigmoid")])
def test_loss_layer_matches_jax(loss, act):
    rng = np.random.default_rng(6)
    z = rng.normal(size=(5, 3)).astype(np.float32)
    if loss == "mcxent":
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)]
    else:
        y = rng.random((5, 3)).astype(np.float32)
    jl = jcore.LossLayer(loss=loss, activation=act)
    pl = pcore.LossLayer(loss=loss, activation=act)
    assert pl.to_dict() == jl.to_dict()
    assert pl.param_shapes() == {}
    np.testing.assert_allclose(
        pl.apply({}, torch.from_numpy(z)).numpy(),
        np.asarray(jl.apply({}, {}, jnp.asarray(z), training=False)[0]),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        pl.per_example_score(torch.from_numpy(y),
                             pl.pre_output({}, torch.from_numpy(z))).numpy(),
        np.asarray(jl.per_example_score(jnp.asarray(y),
                                        jl.pre_output({}, jnp.asarray(z)))),
        rtol=1e-5, atol=1e-6)


def _stack(pkg):
    """ids [b, 1] -> EmbeddingLayer -> Dense -> ActivationLayer ->
    DropoutLayer -> Dense -> LossLayer, built with either package's
    classes."""
    if pkg == "jax":
        from deeplearning4j_tpu.nn.conf.builder import NeuralNetConfiguration
        from deeplearning4j_tpu.nn.conf.inputs import InputType as IT
        core = jcore
    else:
        from deeplearning4j_torch.nn.conf.builder import (
            NeuralNetConfiguration)
        IT = InputType
        core = pcore
    return (NeuralNetConfiguration.builder().seed(3)
            .updater({"type": "Sgd", "learning_rate": 0.1}).list()
            .set_input_type(IT.feed_forward(1))
            .layer(core.EmbeddingLayer(n_in=20, n_out=8, has_bias=True))
            .layer(core.DenseLayer(n_out=6, activation="relu"))
            .layer(core.ActivationLayer(activation="tanh"))
            .layer(core.DropoutLayer(rate=0.0))
            .layer(core.DenseLayer(n_out=3))
            .layer(core.LossLayer(loss="mcxent", activation="softmax"))
            .build())


def test_layer_stack_config_params_output_and_fit_match_jax():
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.models.multi_layer_network import (
        MultiLayerNetwork as JMLN)
    from deeplearning4j_torch.data import DataSet
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.utils import load_numpy_params
    jconf, pconf = _stack("jax"), _stack("torch")
    assert pconf.to_dict() == jconf.to_dict()
    jnet = JMLN(jconf).init()
    pnet = MultiLayerNetwork(pconf).init(device="cpu")
    load_numpy_params(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree),
                      device="cpu")
    assert pnet.num_params() == jnet.num_params()
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 20, (10, 1)).astype(np.int32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
    np.testing.assert_allclose(pnet.output(ids).numpy(),
                               np.asarray(jnet.output(ids)), rtol=1e-5,
                               atol=1e-6)
    for _ in range(3):
        jl = jnet.fit(JDataSet(ids, y))
        pl = pnet.fit(DataSet(ids, y))
        assert pl == pytest.approx(jl, rel=1e-5)
    np.testing.assert_allclose(pnet.params(), jnet.params(), rtol=0,
                               atol=1e-5)


def test_solver_keeps_layers_without_parameters():
    """A fault the BERT path exposed: ``Solver._loss_and_grads`` rebuilt
    the parameter tree from its leaves alone, so the pooling layer's
    empty dict vanished and ``fit`` on a Bert raised KeyError('layer_3').
    The live and gradient trees keep the params' skeleton."""
    from deeplearning4j_torch.data import DataSet
    from deeplearning4j_torch.zoo import Bert
    net = Bert(n_layers=1, d_model=16, n_heads=2, d_ff=32, vocab_size=30,
               seq_len=8, max_len=8, compute_dtype=None).init_graph(
        device="cpu")
    rng = np.random.default_rng(0)
    x = rng.integers(0, 30, (3, 8)).astype(np.int32)
    y = np.eye(2, dtype=np.float32)[[0, 1, 1]]
    net._build_solver()
    _, _, grads = net._solver._loss_and_grads(
        net.params_tree, net.state_tree, net._batch_dict(DataSet(x, y)),
        None)
    assert set(grads) == set(net.params_tree)
    assert grads["layer_2"] == {} == net.params_tree["layer_2"]
    before = net.params()
    assert np.isfinite(net.fit(DataSet(x, y)))
    assert not np.array_equal(net.params(), before)
