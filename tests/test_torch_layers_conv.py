"""The conv stack's layers in the port, each against its JAX counterpart
on the same numpy-seeded inputs and carried parameters: the forward, the
gradient of sum(y * g) (g fixed by a seed) with respect to the input and
to every parameter, the configuration JSON and the inferred shape.

Every padding mode ('same', 'truncate', 'strict') x stride 1/2 x odd/even
size x dilation 1/2 for the convolutions and every pooling type,
including XLA's asymmetric 'same' pads: (0, 1) for ResNet-50's 3x3/2
max-pool on 112 and (2, 3) for SimpleCNN's 7x7/2 conv on 32.  Batch norm
in training and inference with its state update, ``lock_gamma_beta`` and
``use_global_stats``; then a small MultiLayerNetwork with batch norm
trained in both packages — the state protocol: its running statistics
after ``fit`` equal the JAX package's.

Tolerances (f32): outputs and new state rtol = atol = 1e-5, gradients
rtol = atol = 1e-4 (sums over windows and channels in another order);
the bf16 conv within 2e-2 of the JAX package's bf16 conv.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from deeplearning4j_tpu.nn.conf import base as jbase  # noqa: E402
from deeplearning4j_tpu.nn.conf import layers_conv as jconv  # noqa: E402

from deeplearning4j_torch.nn.conf import base as pbase  # noqa: E402
from deeplearning4j_torch.nn.conf import layers_conv as pconv  # noqa: E402

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _pair_layers(cls_name, kw, in_shape):
    """The JAX and port layer built from the same kwargs, defaults
    resolved and shapes inferred; asserts the same JSON and shape."""
    jl = getattr(jconv, cls_name)(**kw)
    pl = getattr(pconv, cls_name)(**kw)
    jl.resolve_defaults(jbase.GlobalConf())
    pl.resolve_defaults(pbase.GlobalConf())
    jout = jl.infer_shapes(tuple(in_shape))
    pout = pl.infer_shapes(tuple(in_shape))
    assert tuple(jout) == tuple(pout)
    assert jl.to_dict() == pl.to_dict()
    return jl, pl, tuple(pout)


def _run_both(jl, pl, x, seed=0, training=False, state_np=None,
              jax_grad_fwd=None):
    """(y, dx, dparams, new_state) of each package on the same input and
    the JAX layer's initial parameters carried across.  ``jax_grad_fwd``
    replaces the JAX layer's forward for the gradient only (where JAX has
    no VJP)."""
    jp, js = jl.init(jax.random.PRNGKey(seed))
    if state_np is not None:
        js = {k: jnp.asarray(v) for k, v in state_np.items()}
    pnp = {k: np.asarray(v) for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in pnp.items()} == {
        k: tuple(s) for k, s in pl.param_shapes().items()}

    def jfwd(params, xx):
        return jl.apply(params, js, xx, training=training)

    jy, jstate = jax.jit(jfwd)(jp, jnp.asarray(x))
    g = np.random.default_rng(99).normal(size=jy.shape).astype(np.float32)
    gfwd = jax_grad_fwd or (lambda p, xx: jfwd(p, xx)[0])
    jdp, jdx = jax.jit(jax.grad(lambda p, xx: jnp.sum(gfwd(p, xx) * g),
                                argnums=(0, 1)))(jp, jnp.asarray(x))

    pp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in pnp.items()}
    ps = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in js.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    if pl.HAS_STATE:
        py, pstate = pl.apply(pp, ps, xt, training=training)
    else:
        py, pstate = pl.apply(pp, xt, training=training), {}
    grads = torch.autograd.grad((py * torch.from_numpy(g)).sum(),
                                [xt] + list(pp.values()), allow_unused=True)
    pdp = {k: (np.zeros_like(pnp[k]) if gr is None else gr.numpy())
           for k, gr in zip(pp, grads[1:])}
    return ((np.asarray(jy), np.asarray(jdx),
             {k: np.asarray(v) for k, v in jdp.items()},
             {k: np.asarray(v) for k, v in jstate.items()}),
            (py.detach().numpy(), grads[0].numpy(), pdp,
             {k: v.numpy() for k, v in pstate.items()}))


def _assert_match(j, p):
    jy, jdx, jdp, jst = j
    py, pdx, pdp, pst = p
    assert py.shape == jy.shape
    np.testing.assert_allclose(py, jy, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(pdx, jdx, rtol=GRAD_TOL, atol=GRAD_TOL)
    assert set(pdp) == set(jdp)
    for k in jdp:
        np.testing.assert_allclose(pdp[k], jdp[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)
    assert set(pst) == set(jst)
    for k in jst:
        np.testing.assert_allclose(pst[k], jst[k], rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=k)


def _image(size, c=3, b=2, seed=1):
    h, w = (size, size) if isinstance(size, int) else size
    return np.random.default_rng(seed).normal(
        size=(b, h, w, c)).astype(np.float32)


def _check(cls_name, kw, x, **run_kw):
    try:
        jl, pl, out = _pair_layers(cls_name, kw, x.shape[1:])
    except ValueError:
        # strict mode on a size that does not divide: both refuse
        with pytest.raises(ValueError):
            getattr(jconv, cls_name)(**kw).infer_shapes(tuple(x.shape[1:]))
        with pytest.raises(ValueError):
            getattr(pconv, cls_name)(**kw).infer_shapes(tuple(x.shape[1:]))
        return None
    j, p = _run_both(jl, pl, x, **run_kw)
    assert p[0].shape[1:] == out
    _assert_match(j, p)
    return j, p


MODES = ["same", "truncate", "strict"]


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("size", [9, 8])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_convolution_modes_match_jax(mode, stride, size, dilation):
    kw = dict(kernel_size=(3, 3), stride=(stride, stride),
              dilation=(dilation, dilation), convolution_mode=mode,
              n_out=4, padding=(1, 1) if mode == "truncate" else (0, 0))
    _check("ConvolutionLayer", kw, _image(size))


@pytest.mark.parametrize("case", [
    # SimpleCNN's first conv: 7x7/2 'same' on 32 pads (2, 3)
    dict(size=32, kernel_size=(7, 7), stride=(2, 2), mode="same"),
    # an even kernel: 'same' puts the odd element at the end
    dict(size=7, kernel_size=(2, 2), stride=(1, 1), mode="same"),
    dict(size=(9, 6), kernel_size=(3, 2), stride=(2, 1), mode="same"),
    dict(size=10, kernel_size=(1, 1), stride=(2, 2), mode="truncate",
         has_bias=False),
    dict(size=8, kernel_size=(3, 3), stride=(1, 1), mode="truncate",
         activation="relu", weight_init="relu")],
    ids=["7x7s2_on_32", "even_kernel", "rect", "1x1s2_nobias", "relu"])
def test_convolution_cases_match_jax(case):
    case = dict(case)
    size, mode = case.pop("size"), case.pop("mode")
    _check("ConvolutionLayer", dict(convolution_mode=mode, n_out=5, **case),
           _image(size))


def test_same_pads_are_xla_same():
    assert pconv.same_pads(112, 3, 2) == (0, 1)      # ResNet-50 pool1
    assert pconv.same_pads(32, 7, 2) == (2, 3)       # SimpleCNN conv 1
    assert pconv.same_pads(28, 5, 1) == (2, 2)       # LeNet
    assert pconv.same_pads(9, 3, 2, 2) == (2, 2)     # dilated


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("size", [9, 8])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
def test_subsampling_modes_match_jax(pooling, mode, stride, size, dilation):
    kw = dict(kernel_size=(3, 3), stride=(stride, stride),
              dilation=(dilation, dilation), convolution_mode=mode,
              pooling_type=pooling, pnorm=3,
              padding=(1, 1) if mode == "truncate" else (0, 0))
    x = _image(size, c=2)
    if pooling == "pnorm":
        x = x + np.sign(x) * 0.1      # keep |x| away from pnorm's kink
    grad_fwd = None
    if pooling == "max" and dilation > 1:
        # JAX has no VJP for a dilated max-pool: its gradient is taken
        # through the max over the strided window slices of the -inf
        # padded input, which is the same function
        grad_fwd = _jax_dilated_max(kw, x.shape[1:3])
    _check("SubsamplingLayer", kw, x, jax_grad_fwd=grad_fwd)


def _jax_dilated_max(kw, hw):
    (k, _), (s, _), (d, _) = kw["kernel_size"], kw["stride"], kw["dilation"]
    if kw["convolution_mode"] == "same":
        pads = [pconv.same_pads(n, k, s, d) for n in hw]
    else:
        pads = [(kw["padding"][0],) * 2] * 2

    def fwd(_, x):
        xp = jnp.pad(x, ((0, 0), pads[0], pads[1], (0, 0)),
                     constant_values=-jnp.inf)
        oh = (xp.shape[1] - (k - 1) * d - 1) // s + 1
        ow = (xp.shape[2] - (k - 1) * d - 1) // s + 1
        return jnp.max(jnp.stack([
            xp[:, i * d:i * d + (oh - 1) * s + 1:s,
               j * d:j * d + (ow - 1) * s + 1:s, :]
            for i in range(k) for j in range(k)]), axis=0)
    return fwd


@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_resnet_pool1_shape_matches_jax(pooling):
    """ResNet-50's 3x3/2 'same' max-pool on 112 pads (0, 1): same shape
    as a symmetric pad of 1, different values — held to the JAX layer."""
    kw = dict(kernel_size=(3, 3), stride=(2, 2), convolution_mode="same",
              pooling_type=pooling)
    res = _check("SubsamplingLayer", kw, _image(112, c=2, b=1))
    assert res[1][0].shape == (1, 56, 56, 2)
    x = torch.from_numpy(_image(112, c=2, b=1))
    sym = torch.nn.functional.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1)
    assert tuple(sym.shape) == (1, 2, 56, 56)
    if pooling == "max":
        assert not np.allclose(sym.permute(0, 2, 3, 1).numpy(), res[1][0])


@pytest.mark.parametrize("pad", ["SAME", "explicit"])
@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
def test_pool2d_matches_jax(pooling, pad):
    """``pool2d`` with the reference's own signature."""
    x = np.abs(_image(7, c=3)) + 0.1
    padding = "SAME" if pad == "SAME" else [(0, 0), (1, 2), (0, 1), (0, 0)]
    args = (pooling, (1, 3, 2, 1), (1, 2, 1, 1), padding, (1, 1, 1, 1), 2)
    want = np.asarray(jconv.pool2d(jnp.asarray(x), *args))
    got = pconv.pool2d(torch.from_numpy(x), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_avg_pool_edge_counts_match_jax():
    """3x3 input, 2x2/2 'same': edge windows divide by the count of real
    elements, not the window area."""
    x = np.arange(9, dtype=np.float32).reshape(1, 3, 3, 1)
    kw = dict(kernel_size=(2, 2), stride=(2, 2), pooling_type="avg",
              convolution_mode="same")
    _, p = _check("SubsamplingLayer", kw, x)
    np.testing.assert_allclose(p[0][0, 0, 0, 0], np.mean([0, 1, 3, 4]))
    np.testing.assert_allclose(p[0][0, 1, 1, 0], 8.0)


@pytest.mark.parametrize("kind", ["ff", "cnn", "rnn"])
@pytest.mark.parametrize("lock", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax(kind, lock, training):
    rng = np.random.default_rng(3)
    shape = {"ff": (16, 6), "cnn": (4, 5, 5, 6), "rnn": (3, 7, 6)}[kind]
    x = (rng.normal(size=shape) * 3 + 2).astype(np.float32)
    state = {"mean": rng.normal(size=6).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, size=6).astype(np.float32)}
    kw = dict(lock_gamma_beta=lock, decay=0.8, eps=1e-3)
    jl, pl, _ = _pair_layers("BatchNormalization", kw, shape[1:])
    j, p = _run_both(jl, pl, x, training=training, state_np=state)
    _assert_match(j, p)
    if not training:       # inference reads the state and keeps it
        np.testing.assert_array_equal(p[3]["mean"], state["mean"])


def test_batch_norm_global_stats_and_relu_match_jax():
    x = np.random.default_rng(4).normal(size=(3, 4, 4, 5)).astype(
        np.float32)
    jl, pl, _ = _pair_layers("BatchNormalization",
                             dict(use_global_stats=True, activation="relu"),
                             x.shape[1:])
    j, p = _run_both(jl, pl, x, training=True)
    _assert_match(j, p)
    np.testing.assert_array_equal(p[3]["var"], np.ones(5, np.float32))


def test_batch_norm_running_stats_use_biased_variance():
    """One training forward moves the running variance toward the BIASED
    batch variance with decay 0.9 — not F.batch_norm's unbiased one."""
    x = np.random.default_rng(5).normal(size=(8, 3)).astype(np.float32)
    bn = pconv.BatchNormalization()
    bn.resolve_defaults(pbase.GlobalConf())
    bn.infer_shapes((3,))
    _, st = bn.apply(bn.init(torch.Generator()), bn.init_state(),
                     torch.from_numpy(x), training=True)
    np.testing.assert_allclose(st["var"].numpy(),
                               0.9 + 0.1 * x.var(axis=0), rtol=1e-5)
    np.testing.assert_allclose(st["mean"].numpy(), 0.1 * x.mean(axis=0),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode", ["same", "truncate"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [2, 3])
def test_deconvolution_matches_jax(mode, stride, kernel):
    kw = dict(kernel_size=(kernel, kernel), stride=(stride, stride),
              convolution_mode=mode, n_out=3,
              padding=(1, 1) if (mode == "truncate" and kernel == 3)
              else (0, 0))
    _check("Deconvolution2D", kw, _image(5, c=2))


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", ["same", "truncate"])
@pytest.mark.parametrize("cls", ["DepthwiseConvolution2D",
                                 "SeparableConvolution2D"])
def test_depthwise_and_separable_match_jax(cls, mode, stride, dilation):
    kw = dict(kernel_size=(3, 3), stride=(stride, stride),
              dilation=(dilation, dilation), convolution_mode=mode,
              depth_multiplier=2)
    if cls == "SeparableConvolution2D":
        kw["n_out"] = 5
    _check(cls, kw, _image(8, c=3))


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", ["same", "causal", "truncate"])
def test_convolution_1d_matches_jax(mode, stride, dilation):
    kw = dict(kernel_size=3, stride=stride, dilation=dilation,
              convolution_mode=mode, n_out=4,
              padding=1 if mode == "truncate" else 0)
    x = np.random.default_rng(6).normal(size=(2, 11, 3)).astype(np.float32)
    _check("Convolution1DLayer", kw, x)


def test_convolution_1d_causal_output_ignores_the_future():
    x = np.random.default_rng(7).normal(size=(2, 10, 4)).astype(np.float32)
    _, pl, _ = _pair_layers("Convolution1DLayer",
                            dict(kernel_size=3, n_out=6,
                                 convolution_mode="causal"), x.shape[1:])
    params = pl.init(torch.Generator().manual_seed(0))
    y = pl.apply(params, torch.from_numpy(x))
    x2 = x.copy()
    x2[:, 5:] += 10.0
    y2 = pl.apply(params, torch.from_numpy(x2))
    np.testing.assert_allclose(y2[:, :5].numpy(), y[:, :5].numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("cls,kw,size", [
    ("ZeroPaddingLayer", dict(padding=(1, 2)), 4),
    ("ZeroPaddingLayer", dict(padding=(0, 1, 2, 3)), 5),
    ("Cropping2D", dict(cropping=(1, 2)), 6),
    ("Cropping2D", dict(cropping=(1, 0, 2, 1)), 6),
    ("Upsampling2D", dict(size=(2, 3)), 3),
    ("SpaceToDepthLayer", dict(block_size=2), 4),
    ("LocalResponseNormalization", dict(), 4),
    ("LocalResponseNormalization", dict(n=3, k=1.0, beta=0.5), 4),
    ("GlobalPoolingLayer", dict(pooling_type="avg"), 5),
    ("GlobalPoolingLayer", dict(pooling_type="max",
                                collapse_dimensions=False), 5)],
    ids=lambda v: v if isinstance(v, str) else None)
def test_shape_layers_match_jax(cls, kw, size):
    _check(cls, kw, _image(size, c=8 if "Local" in cls else 3))


@pytest.mark.parametrize("masked", [False, True])
def test_cnn_loss_layer_scores_match_jax(masked):
    rng = np.random.default_rng(8)
    z = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 4, 4))]
    mask = (rng.random((2, 4, 4)) > 0.3).astype(np.float32) if masked \
        else None
    kw = dict(activation="softmax", loss="mcxent")
    jl, pl, _ = _pair_layers("CnnLossLayer", kw, (4, 4, 3))
    want = np.asarray(jl.per_example_score(
        jnp.asarray(labels), jnp.asarray(z),
        None if mask is None else jnp.asarray(mask)))
    got = pl.per_example_score(torch.from_numpy(labels), torch.from_numpy(z),
                               None if mask is None
                               else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    jy, _ = jl.apply({}, {}, jnp.asarray(z), training=False)
    np.testing.assert_allclose(pl.apply({}, torch.from_numpy(z)).numpy(),
                               np.asarray(jy), rtol=FWD_TOL, atol=1e-6)


def test_conv_bf16_matches_jax_bf16():
    """bf16 compute on f32 master weights: the conv runs in bf16 in both
    packages; the two agree to bf16 rounding."""
    x = _image(9, c=4)
    kw = dict(kernel_size=(3, 3), stride=(2, 2), convolution_mode="same",
              n_out=8)
    jl, pl, _ = _pair_layers("ConvolutionLayer", kw, x.shape[1:])
    jp, js = jl.init(jax.random.PRNGKey(0))
    jy, _ = jl.apply(jp, js, jnp.asarray(x), training=False,
                     compute_dtype=jnp.bfloat16)
    py = pl.apply({k: torch.from_numpy(np.array(v)) for k, v in
                   jp.items()}, torch.from_numpy(x),
                  compute_dtype=torch.bfloat16)
    assert py.dtype == torch.bfloat16
    np.testing.assert_allclose(py.float().numpy(),
                               np.asarray(jy, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("kind", ["cnn", "cnn_flat"])
def test_input_types_and_cnn_adapters_match_jax(kind):
    from deeplearning4j_tpu.nn.conf import inputs as jin

    from deeplearning4j_torch.nn.conf import inputs as pin
    maker = "convolutional" if kind == "cnn" else "convolutional_flat"
    it, jit = getattr(pin.InputType, maker)(4, 5, 3), \
        getattr(jin.InputType, maker)(4, 5, 3)
    assert it.to_dict() == jit.to_dict() and it.flat_size() == 60
    for wanted in ("any", "ff", "cnn", "rnn"):
        try:
            want = jin.adapt(jit, wanted)
        except ValueError:
            with pytest.raises(ValueError):
                pin.adapt(it, wanted)
            continue
        pre, out = pin.adapt(it, wanted)
        assert out.to_dict() == want[1].to_dict()
        assert (None if pre is None else pre.to_dict()) == \
            (None if want[0] is None else want[0].to_dict())
    with pytest.raises(ValueError, match="convolutional_flat"):
        pin.adapt(pin.InputType.feed_forward(60), "cnn")
    x = np.arange(2 * 4 * 5 * 3, dtype=np.float32).reshape(2, 4, 5, 3)
    for pre in (pin.Preprocessor("cnn_to_ff"), pin.Preprocessor("cnn_to_rnn"),
                pin.Preprocessor("ff_to_cnn", (4, 5, 3)),
                pin.Preprocessor("ff_to_rnn", (5,)),
                pin.Preprocessor("identity")):
        src = {"ff_to_cnn": x.reshape(2, -1),
               "ff_to_rnn": x.reshape(10, -1)}.get(pre.name, x)
        want = jin.Preprocessor(pre.name, pre.spec)(jnp.asarray(src))
        np.testing.assert_array_equal(pre(torch.from_numpy(src)).numpy(),
                                      np.asarray(want))


def _lenet_bn_confs(jax_side):
    """A small conv -> pool -> batch norm -> dense -> softmax stack with
    AdaDelta, built by either package's builder."""
    if jax_side:
        from deeplearning4j_tpu.nn.conf import layers_core as core
        from deeplearning4j_tpu.nn.conf.builder import NeuralNetConfiguration
        from deeplearning4j_tpu.nn.conf.inputs import InputType
        from deeplearning4j_tpu.optimize.updaters import AdaDelta
        conv = jconv
    else:
        from deeplearning4j_torch.nn.conf import layers_core as core
        from deeplearning4j_torch.nn.conf.builder import (
            NeuralNetConfiguration)
        from deeplearning4j_torch.nn.conf.inputs import InputType
        from deeplearning4j_torch.optimize.updaters import AdaDelta
        conv = pconv
    return (NeuralNetConfiguration.builder().seed(12)
            .updater(AdaDelta()).list()
            .layer(conv.ConvolutionLayer(kernel_size=(3, 3), n_out=6,
                                         convolution_mode="same",
                                         activation="relu"))
            .layer(conv.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(conv.BatchNormalization())
            .layer(core.DenseLayer(n_out=16, activation="relu"))
            .layer(core.OutputLayer(n_out=4, activation="softmax",
                                    loss="mcxent"))
            .set_input_type(InputType.convolutional(10, 10, 2))
            .build())


def test_mln_fit_threads_batch_norm_state_like_jax():
    """The state protocol: MultiLayerNetwork.fit stores the running mean
    and variance the forward returns, step after step, equal to the JAX
    package's (a network that dropped the state would keep the initial
    zeros and ones); inference after fit reads them, and the parameters
    and loss follow the JAX package's too."""
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.models.multi_layer_network import (
        MultiLayerNetwork as JNet)

    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.utils.convert import load_numpy_params
    jconf, pconf = _lenet_bn_confs(True), _lenet_bn_confs(False)
    assert jconf.to_dict() == pconf.to_dict()
    jnet = JNet(jconf).init()
    pnet = load_numpy_params(MultiLayerNetwork(pconf),
                             jax.tree_util.tree_map(np.asarray,
                                                    jnet.params_tree),
                             device="cpu")
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(16, 10, 10, 2)) * 2 + 1).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    for _ in range(3):
        jl = jnet.fit(JDataSet(x, y))
        pl = pnet.fit(DataSet(x, y))
        assert pl == pytest.approx(float(jl), rel=1e-5)
    jst = np.asarray(jnet.state_tree["layer_2"]["var"])
    pst = pnet.state_tree["layer_2"]["var"].numpy()
    assert not np.allclose(pst, 1.0)                  # the stats moved
    for k in ("mean", "var"):
        np.testing.assert_allclose(
            pnet.state_tree["layer_2"][k].numpy(),
            np.asarray(jnet.state_tree["layer_2"][k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pst, jst, rtol=1e-5)
    for name in ("W", "b"):
        np.testing.assert_allclose(
            pnet.params_tree["layer_0"][name].numpy(),
            np.asarray(jnet.params_tree["layer_0"][name]), rtol=1e-4,
            atol=1e-6)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=1e-4,
                               atol=1e-6)


def test_non_finite_step_keeps_batch_norm_state():
    """A step whose loss is not finite moves neither the parameters nor
    the batch-norm statistics, as the reference's solver keeps them."""
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    net = MultiLayerNetwork(_lenet_bn_confs(False)).init(device="cpu")
    rng = np.random.default_rng(12)
    x = rng.normal(size=(8, 10, 10, 2)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
    net.fit(DataSet(x, y))
    before = {k: v.clone() for k, v in net.state_tree["layer_2"].items()}
    assert not torch.equal(before["var"], torch.ones_like(before["var"]))
    x[0, 0, 0, 0] = np.nan
    assert not np.isfinite(net.fit(DataSet(x, y)))
    for k, v in before.items():
        assert torch.equal(net.state_tree["layer_2"][k], v), k
