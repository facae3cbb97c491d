"""The nine zoo CNNs the port adds (AlexNet, VGG16/19, Darknet19,
TinyYOLO, YOLO2, SqueezeNet, UNet, Xception, InceptionResNetV1,
FaceNetNN4Small2, NASNet), held to the JAX package: every model's
configuration JSON equals the reference's at its defaults and at the
reference tests' sizes (``tests/test_zoo.py``, ``tests/test_zoo_extra.py``:
16-64 px, narrow widths); at those sizes the inference output equals the
JAX graph's with its parameters and batch-norm state carried across (f32,
rtol 1e-4 / atol 1e-5: up to ~60 layers deep); and one training forward
and backward of YOLO2 (grid labels), UNet (per-pixel softmax) and
FaceNetNN4Small2 (the center term on non-zero centers) gives the JAX
package's loss, gradients and batch-norm state in f64 (1e-9 of each
tensor's largest element), then the port's ``fit`` lowers the loss over
the reference test's number of steps.  The YOLO2 passthrough
reorders channels as the reference's
``SpaceToDepthLayer`` does."""
import numpy as np
import pytest

from torch_model_util import (  # noqa: F401 (a fixture among them)
    assert_trees_close, host, jax, jax_from_port, np_tree, one_torch_thread,
    port_loss_grads)

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# name: (constructor kwargs of the reference tests' sizes, batch)
SMALL = {
    "AlexNet": dict(n_classes=10, input_shape=(64, 64, 3)),
    "VGG16": dict(n_classes=10, input_shape=(32, 32, 3)),
    "VGG19": dict(n_classes=10, input_shape=(32, 32, 3)),
    "Darknet19": dict(n_classes=4, width=8, input_shape=(32, 32, 3)),
    "TinyYOLO": dict(n_classes=3, width=8, input_shape=(32, 32, 3)),
    "YOLO2": dict(n_classes=3, width=8, input_shape=(64, 64, 3), seed=4),
    "SqueezeNet": dict(n_classes=4, input_shape=(64, 64, 3), seed=1,
                       fire_plan=((8, 16), (8, 16)), pool_after=(0,)),
    "UNet": dict(n_classes=2, depth=2, base_filters=4,
                 input_shape=(16, 16, 1)),
    "Xception": dict(n_classes=3, input_shape=(64, 64, 3), width=8,
                     middle_blocks=1, seed=2),
    "InceptionResNetV1": dict(n_classes=5, blocks=2, filters=8,
                              input_shape=(32, 32, 3)),
    "FaceNetNN4Small2": dict(n_classes=4, width=8, embedding_size=32,
                             input_shape=(64, 64, 3), seed=5),
    "NASNet": dict(n_classes=3, input_shape=(32, 32, 3),
                   penultimate_filters=24, n_cells=1, seed=6),
}


def _models(name, **kw):
    from deeplearning4j_tpu import zoo as jzoo

    from deeplearning4j_torch import zoo as pzoo
    return getattr(jzoo, name)(**kw), getattr(pzoo, name)(**kw)


def _port_net(conf):
    from deeplearning4j_torch.models.computation_graph import (
        ComputationGraph, ComputationGraphConfiguration)
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    if isinstance(conf, ComputationGraphConfiguration):
        return ComputationGraph(conf)
    return MultiLayerNetwork(conf)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_zoo_configuration_json_equals_reference(name):
    """At the reference's defaults and at the tests' sizes."""
    for kw in ({}, SMALL[name]):
        jm, pm = _models(name, **kw)
        assert pm.conf().to_dict() == jm.conf().to_dict(), kw


def test_vgg16_and_alexnet_parameter_counts_at_full_width():
    """VGG16 at 224 x 224 x 3 with 1000 classes has the canonical
    138,357,544 parameters, as in the reference's test; VGG19 16 convs
    and 3 dense layers; AlexNet builds at its default input."""
    from deeplearning4j_torch.nn.conf.layers_conv import ConvolutionLayer
    from deeplearning4j_torch.nn.conf.layers_core import DenseLayer
    from deeplearning4j_torch.zoo import VGG19, AlexNet, VGG16
    n = 0
    for ly in VGG16().conf().layers:
        n += sum(int(np.prod(s)) for s in ly.param_shapes().values())
    assert n == 138_357_544
    layers = VGG19(n_classes=10).conf().layers
    assert len([ly for ly in layers if isinstance(ly, ConvolutionLayer)]) \
        == 16
    assert len([ly for ly in layers if type(ly) is DenseLayer]) == 2
    assert AlexNet().conf().layers[-1].n_in == 4096


def _pair(name, dtype=None):
    """(JAX net, port net) of zoo model ``name`` at its test size, the
    port's seeded parameters and state on both (the JAX package's eager
    init of these graphs takes 5-25 s; its layers' init shapes are
    checked instead)."""
    from deeplearning4j_tpu.models.computation_graph import (
        ComputationGraph as JGraph)
    from deeplearning4j_tpu.models.multi_layer_network import (
        MultiLayerNetwork as JMLN)
    jm, pm = _models(name, **SMALL[name])
    jconf, pconf = jm.conf(), pm.conf()
    if dtype is not None:
        jconf.global_conf.dtype = jconf.global_conf.compute_dtype = dtype
        pconf.global_conf.dtype = pconf.global_conf.compute_dtype = dtype
    pnet = _port_net(pconf).init(device="cpu")
    jcls = JGraph if hasattr(pnet, "vertex_names") else JMLN
    return jax_from_port(jcls(jconf), pnet), pnet


@pytest.mark.parametrize("name", sorted(SMALL))
def test_zoo_forward_matches_jax(name):
    """Inference output at the tests' sizes, b 2 (batch norm on its
    running statistics, moved off their init values first)."""
    jnet, pnet = _pair(name)
    r = np.random.default_rng(2)
    for key, st in pnet.state_tree.items():
        for k, v in st.items():
            v.copy_(torch.from_numpy(r.uniform(0.5, 1.5, v.shape)
                                     .astype(np.float32)))
    jnet = jax_from_port(type(jnet)(jnet.conf), pnet)
    x = np.random.default_rng(1).normal(
        size=(2,) + tuple(SMALL[name]["input_shape"])).astype(np.float32)
    got, want = host(pnet.output(x)), host(jnet.output(x))
    if isinstance(want, dict):
        want = want["output"]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _yolo_labels(rng, b, gh, gw, n_cls):
    y = np.zeros((b, gh, gw, 5 + n_cls), np.float32)
    for i in range(b):
        gi, gj = rng.integers(0, gh), rng.integers(0, gw)
        y[i, gi, gj, :5] = [1.0, *rng.random(2), *(rng.random(2) + 0.5)]
        y[i, gi, gj, 5 + rng.integers(0, n_cls)] = 1.0
    return y


def _unet_labels(rng, x):
    return np.stack([(x[..., 0] <= 0), (x[..., 0] > 0)], -1).astype(
        np.float32)


# name: (batch, labels(rng, x), the reference test's fit steps)
TRAIN = {
    "YOLO2": (2, lambda r, x: _yolo_labels(r, 2, 8, 8, 3), 8),
    "UNet": (4, _unet_labels, 15),
    "FaceNetNN4Small2": (4, lambda r, x: np.eye(4, dtype=np.float32)[
        r.integers(0, 4, 4)], 10),
}


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_zoo_training_step_matches_jax_in_f64(name):
    """One training forward and backward (batch norm in training mode)
    in f64 in both packages: loss, every gradient and every batch-norm
    state agree; then the port's fit lowers the loss over the reference
    test's number of steps on the same batch (its "trains" check)."""
    j = jax()
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet

    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.utils.trees import iter_leaves, map_leaves
    b, labels, steps = TRAIN[name]
    r = np.random.default_rng(3)
    # f32-representable inputs: the port takes a float64 host array as
    # f32 (the reference's jnp.asarray without x64), then computes in f64
    x = r.normal(size=(b,) + tuple(SMALL[name]["input_shape"])).astype(
        np.float32).astype(np.float64)
    y = labels(r, x).astype(np.float32).astype(np.float64)
    with j.enable_x64(True):
        jnet, pnet = _pair(name, "float64")
        if name == "FaceNetNN4Small2":
            with torch.no_grad():
                pnet.params_tree["output"]["centers"].normal_(
                    generator=torch.Generator().manual_seed(0))
            jnet = jax_from_port(type(jnet)(jnet.conf), pnet)
        batch = jnet._batch_dict(JDataSet(x, y))
        (jl, jstate), jg = j.jit(j.value_and_grad(
            lambda p, s: jnet._score_batch(p, s, batch, None, True),
            has_aux=True))(jnet.params_tree, jnet.state_tree)
        jg, jstate = np_tree(jg), np_tree(jstate)
    ds = DataSet(x, y)
    pl, pg = port_loss_grads(pnet, ds)
    assert pl == pytest.approx(float(jl), rel=1e-10)
    # a conv bias that feeds a training-mode batch norm has a zero true
    # gradient: both packages give rounding noise there
    scale = max(float(np.abs(g).max()) for _, g in iter_leaves(jg))
    for path, g in iter_leaves(jg):
        if float(np.abs(g).max()) < 1e-9 * scale:
            got = pg
            for p in path:
                got = got[p]
            assert float(np.abs(got).max()) < 1e-9 * scale, path
            got[...] = g
    assert_trees_close(pg, jg, 1e-9)
    _, pstate, _ = pnet._solver._loss_and_grads(
        pnet.params_tree, pnet.state_tree, pnet._batch_dict(ds), None)
    assert_trees_close(map_leaves(lambda t: t.numpy(), pstate), jstate,
                       1e-9)
    if name == "FaceNetNN4Small2":
        ce_only = pnet.output_layers[-1].per_example_score(
            torch.from_numpy(y), torch.log(pnet.output(x))).mean()
        assert pl > float(ce_only)
    losses = [pnet.fit(ds) for _ in range(steps)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_space_to_depth_passthrough_exact():
    """YOLO2's reorg: block (0, 0) of example 0 is rows 0-1 x cols 0-1,
    the input channels minor (the reference's layout)."""
    from deeplearning4j_torch.nn.conf.layers_conv import SpaceToDepthLayer
    x = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
    out = SpaceToDepthLayer(block_size=2).apply({}, torch.from_numpy(x))
    out = out.numpy()
    assert out.shape == (2, 2, 2, 12)
    np.testing.assert_array_equal(out[0, 0, 0],
                                  x[0, 0:2, 0:2, :].reshape(-1))
