"""The zoo CNNs and their data in the port, held to the JAX package:
ResNet-50's configuration, topology and parameter count (25,583,592
trainable + 53,120 batch-norm statistics); ResNet-50 at 32x32 (4
classes, f32) with the JAX graph's parameters carried across; LeNet and
SimpleCNN forwards and LeNet's AdaDelta steps; the checked-in
``LeNet_mnist.zip`` and ``SimpleCNN_cifar10-synthetic.zip`` restored in
both packages (same outputs) and held to the reference's accuracy gates
(> 0.97, > 0.9) on smaller synthetic test splits; the synthetic MNIST and
CIFAR sets, Iris and the three normalizers equal to the reference's.
ResNet-50 at 64x64, b 4, 1000 classes: its training gradients equal the
JAX package's in f64, its f32 gradients part from f64 alike in both
packages, and three AdaDelta steps follow the JAX package's trajectory.
JAX is imported per test, so the ``gpu`` tests (ResNet-50 on the card
against the CPU, one bf16 step) run on a machine without JAX.

Tolerances: outputs rtol 1e-5 (atol 1e-6) in f32, ResNet-50's 53
layers rtol 1e-4 (atol 1e-5); its f64 gradients and batch-norm state
1e-9 of each tensor's largest element; its f32 gradients (normwise from
f64) within 2x the JAX package's own; the AdaDelta losses rtol 1e-6;
the card against the CPU as chip_smoke.py's resnet part (a) states."""
import functools
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.data.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.data.iterator import (  # noqa: E402
    ListDataSetIterator)
from deeplearning4j_torch.models.computation_graph import (  # noqa: E402
    ComputationGraph)
from deeplearning4j_torch.models.multi_layer_network import (  # noqa: E402
    MultiLayerNetwork)
from deeplearning4j_torch.utils.convert import (  # noqa: E402
    load_numpy_params, load_numpy_state)
from deeplearning4j_torch.utils.model_serializer import (  # noqa: E402
    restore_model)
from deeplearning4j_torch.zoo import LeNet, ResNet50  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "deeplearning4j_tpu" / "zoo" / "weights"
ZIPS = {"LeNet": WEIGHTS / "LeNet_mnist.zip",
        "SimpleCNN": WEIGHTS / "SimpleCNN_cifar10-synthetic.zip"}


def _jax():
    jax = pytest.importorskip("jax")
    return jax


def _carry(jnet, pnet, device="cpu"):
    """The JAX net's parameters and state installed on the port net."""
    jax = _jax()
    load_numpy_params(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree),
                      device=device)
    load_numpy_state(pnet, jax.tree_util.tree_map(np.asarray,
                                                  jnet.state_tree))
    return pnet


def _close(p, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(p.detach().float().cpu().numpy(),
                               np.asarray(j), rtol=rtol, atol=atol)


def test_resnet50_topology_and_count_match_jax():
    jax = _jax()
    from deeplearning4j_tpu.zoo import ResNet50 as JResNet50
    jconf, pconf = JResNet50().conf(), ResNet50().conf()
    assert pconf.to_dict() == jconf.to_dict()
    n_params = n_state = 0
    for name in jconf.topological_order:
        ly = jconf.vertices[name].layer
        if ly is None:
            continue
        p, s = jax.eval_shape(lambda ly=ly: ly.init(jax.random.PRNGKey(0)))
        n_params += sum(int(np.prod(a.shape))
                        for a in jax.tree_util.tree_leaves(p))
        n_state += sum(int(np.prod(a.shape))
                       for a in jax.tree_util.tree_leaves(s))
    net = ResNet50().init_graph(device="cpu")
    assert isinstance(net, ComputationGraph)
    assert net.num_params() == n_params == 25_583_592
    assert sum(v.numel() for d in net.state_tree.values()
               for v in d.values()) == n_state == 53_120
    assert len([v for v in net.vertex_names() if v.endswith("_add")]) == 16
    assert net.vertex_names() == list(jconf.topological_order)
    assert net._compute_dtype == torch.bfloat16


def test_resnet50_flop_count_follows_the_conv_shapes():
    """flops_per_image_train() == 6 x the multiply-adds of every conv and
    the dense head, counted here from the configuration's shapes."""
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers_conv import ConvolutionLayer
    from deeplearning4j_torch.nn.conf.layers_core import OutputLayer
    model = ResNet50()
    conf = model.conf()
    types = {"input": InputType.convolutional(224, 224, 3)}
    macs = 0
    for name in conf.topological_order:
        spec = conf.vertices[name]
        ins = [types[i] for i in conf.vertex_inputs[name]]
        if spec.layer is None:
            types[name] = spec.vertex.infer_shapes(ins)
            continue
        ly = spec.layer
        shape = ly.infer_shapes(ins[0].shape)
        types[name] = InputType(getattr(ly, "OUTPUT_KIND", None)
                                or ins[0].kind, tuple(shape))
        if isinstance(ly, ConvolutionLayer):
            kh, kw = ly.kernel_size
            macs += int(np.prod(shape)) * kh * kw * ly.n_in
        elif isinstance(ly, OutputLayer):
            macs += ly.n_in * ly.n_out
    assert model.flops_per_image_train() == 6.0 * macs
    assert 3.8e9 < macs < 3.9e9


def test_resnet50_small_forward_matches_jax():
    """ResNet50(n_classes=4, input_shape=(32, 32, 3), f32) with the JAX
    graph's parameters carried across: the same softmax output (the
    training loss is held in f64 below)."""
    from deeplearning4j_tpu.zoo import ResNet50 as JResNet50
    kw = dict(n_classes=4, input_shape=(32, 32, 3), compute_dtype="float32")
    jnet = JResNet50(**kw).init_graph()
    pnet = _carry(jnet, ComputationGraph(ResNet50(**kw).conf()))
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    _close(pnet.output(x), jnet.output(x), rtol=1e-4, atol=1e-5)


# ResNet-50 at 64x64 with its 1000 classes, b 4: the inputs of the
# training tests below, and the leaves whose f32 gradients are held to
# f64 (the stem, a projection conv, a batch-norm gamma in each of two
# middle stages, the head)
R64 = dict(n_classes=1000, input_shape=(64, 64, 3))
R64_LEAVES = (("conv1", "W"), ("s2b0_a", "W"), ("s3b3_b_bn", "gamma"),
              ("s4b2_b_bn", "gamma"), ("output", "W"))


def _r64_batch(seed=5):
    """(x, y): b 4 seeded normal images and random one-hot labels."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    return x, np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, 4)]


@functools.lru_cache(maxsize=None)
def _jax_r64(dtype):
    """(the JAX package's ResNet-50 graph at ``R64`` in ``dtype``, its
    jitted (params, state, batch) -> ((loss, new state), grads) of one
    training forward and backward), built once per dtype: call it under
    ``jax.enable_x64(dtype == "float64")``."""
    jax = _jax()
    from deeplearning4j_tpu.models.computation_graph import (
        ComputationGraph as JGraph)
    from deeplearning4j_tpu.zoo import ResNet50 as JResNet50
    with jax.enable_x64(dtype == "float64"):
        jconf = JResNet50(compute_dtype=dtype, **R64).conf()
        jconf.global_conf.dtype = dtype
        jnet = JGraph(jconf).init()
    return jnet, jax.jit(jax.value_and_grad(
        lambda p, s, batch: jnet._score_batch(p, s, batch, None, True),
        has_aux=True))


def _port_r64_graph(dtype):
    conf = ResNet50(compute_dtype=dtype, **R64).conf()
    conf.global_conf.dtype = dtype
    return ComputationGraph(conf)


def _port_r64(dtype, params, state):
    """The port's ResNet-50 at ``R64`` in ``dtype`` on the CPU with the
    numpy ``params`` (cast to ``dtype``) and ``state``."""
    from deeplearning4j_torch.utils.trees import map_leaves
    net = load_numpy_params(_port_r64_graph(dtype),
                            map_leaves(lambda a: np.asarray(a, dtype),
                                       params), device="cpu")
    return load_numpy_state(net, state)


def _np_tree(tree):
    return _jax().tree_util.tree_map(np.asarray, tree)


def test_resnet50_training_gradients_match_jax_in_f64():
    """One training forward and backward of ResNet-50 (64x64, b 4, 1000
    classes) in f64 in both packages, the JAX graph's parameters carried
    across: loss, every gradient and every batch-norm state agree to
    1e-9 of each tensor's largest element (the conv biases' gradients,
    0 in truth before a training-mode batch norm, are held below
    1e-10).  In f32 both part from f64 alike:
    ``test_resnet50_f32_gradients_part_from_f64_alike_in_both_packages``."""
    jax = _jax()
    jnp = jax.numpy
    from deeplearning4j_torch.utils.trees import iter_leaves
    x, y = _r64_batch()
    jnet, grad_fn = _jax_r64("float64")
    with jax.enable_x64(True):
        batch = {"features": jnp.asarray(x), "labels": jnp.asarray(y)}
        (jloss, jstate), jgrads = grad_fn(jnet.params_tree, jnet.state_tree,
                                          batch)
        jgrads, jstate = _np_tree(jgrads), _np_tree(jstate)
        pnet = _carry(jnet, _port_r64_graph("float64"))
    _, ploss, pgrads, pstate = _train_forward_backward(pnet, x, y)
    assert pnet.params_tree["conv1"]["W"].dtype == torch.float64
    assert float(ploss) == pytest.approx(float(jloss), rel=1e-12)
    for tree, ref in ((pgrads, jgrads), (pstate, jstate)):
        for path, leaf in iter_leaves(tree):
            want = ref
            for p in path:
                want = want[p]
            got = leaf.detach().numpy()
            if path[-1] == "b" and path[0] != "output":
                # a conv bias feeds training-mode batch norm: its true
                # gradient is 0, both give rounding noise
                assert float(np.abs(got).max()) < 1e-10, path
                continue
            scale = max(float(np.abs(want).max()), 1e-300)
            assert float(np.abs(got - want).max()) / scale <= 1e-9, path


def _norm_err(a, ref):
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def test_resnet50_f32_gradients_part_from_f64_alike_in_both_packages():
    """ResNet-50's f32 training gradients are ill-conditioned at random
    init, in the JAX package itself: on f32 parameters and inputs, its
    f32 gradients of the leaves below the head read more than 1e-2
    (normwise) from its own f64 gradients (~5e-2 on this seed), while
    the head's stays within 1e-3.  The port's CPU f32 gradients are no
    further from the JAX f64 ones than 2x the JAX package's own f32
    reading.  This is why the card's f32 gradients are held to f64
    through such a ratio, and layer by layer, not at 1e-3 against the
    CPU's f32 (chip_smoke.py's resnet phase, part (a))."""
    jax = _jax()
    jnp = jax.numpy
    x, y = _r64_batch()
    j32, grad32 = _jax_r64("float32")
    j64, grad64 = _jax_r64("float64")
    params, state = _np_tree(j32.params_tree), _np_tree(j32.state_tree)
    grads = {}
    batch = {"features": jnp.asarray(x), "labels": jnp.asarray(y)}
    grads["jax32"] = _np_tree(grad32(j32.params_tree, j32.state_tree,
                                     batch)[1])
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        grads["jax64"] = _np_tree(grad64(p64, j64.state_tree, batch)[1])
    grads["port32"] = {v: {k: t.detach().numpy() for k, t in d.items()}
                       for v, d in _train_forward_backward(
                           _port_r64("float32", params, state), x, y)[2]
                       .items()}
    for v, k in R64_LEAVES:
        ref = grads["jax64"][v][k]
        e_jax = _norm_err(grads["jax32"][v][k], ref)
        e_port = _norm_err(grads["port32"][v][k], ref)
        if v == "output":
            assert e_jax < 1e-3 and e_port < 1e-3, (v, e_jax, e_port)
        else:
            assert e_jax > 1e-2, (v, e_jax)
            assert e_port <= 2 * e_jax, (v, e_port, e_jax)


def test_resnet50_adadelta_trajectory_matches_jax_in_f64():
    """Three AdaDelta steps of ResNet-50 (64x64, b 4, 1000 classes, f64)
    through the port's ``fit`` and through the JAX package's training
    forward and backward and its own ``AdaDelta`` updater, on the
    buffers x0, x0, x1 with one label set, as chip_smoke.py's main path
    feeds its buffers: the losses agree to 1e-6 and the head's
    parameters to 1e-6 of their largest element.  The trajectory is
    the reference's: the second step, x0 again after one update, reads
    below the first, and the third, a fresh buffer, above it.  AdaDelta
    at its defaults moves every weight by up to sqrt(eps / (1 - rho)) ~
    4.5e-3 at its first update, and the loss overshoots; so the main
    path's gate is the first update's fall on its own buffer, not a
    last loss below the first."""
    jax = _jax()
    jnp = jax.numpy
    from deeplearning4j_tpu.optimize.updaters import AdaDelta as JAdaDelta
    _, y = _r64_batch()
    xs = [_r64_batch(seed)[0] for seed in (5, 6)]
    jnet, grad_fn = _jax_r64("float64")
    upd = JAdaDelta()
    jl, pl = [], []
    with jax.enable_x64(True):
        pnet = _carry(jnet, _port_r64_graph("float64"))
        params, state = jnet.params_tree, jnet.state_tree
        opt = upd.init_state(params)
        for i in (0, 0, 1):
            batch = {"features": jnp.asarray(xs[i]), "labels": jnp.asarray(y)}
            (loss, state), grads = grad_fn(params, state, batch)
            dx, opt = upd.update(grads, opt, params, len(jl))
            params = jax.tree_util.tree_map(lambda p, u: p - u, params, dx)
            jl.append(float(loss))
            pl.append(float(pnet.fit(DataSet(xs[i], y))))
        head = _np_tree(params["output"])
    np.testing.assert_allclose(pl, jl, rtol=1e-6)
    for k in ("W", "b"):
        got = pnet.params_tree["output"][k].detach().numpy()
        scale = float(np.abs(head[k]).max())
        assert float(np.abs(got - head[k]).max()) / scale <= 1e-6, k
    for losses in (jl, pl):
        assert losses[1] < losses[0] < losses[2], losses


@pytest.mark.parametrize("name", ["LeNet", "SimpleCNN"])
def test_lenet_and_simple_cnn_forward_match_jax(name):
    from deeplearning4j_tpu import zoo as jzoo

    from deeplearning4j_torch import zoo as pzoo
    kw = {"LeNet": dict(n_classes=10), "SimpleCNN": dict(n_classes=5)}[name]
    jm, pm = getattr(jzoo, name)(**kw), getattr(pzoo, name)(**kw)
    assert pm.conf().to_dict() == jm.conf().to_dict()
    jnet = jm.init_graph()
    pnet = _carry(jnet, MultiLayerNetwork(pm.conf()))
    x = np.random.default_rng(1).random(
        (3,) + tuple(pm.input_shape)).astype(np.float32)
    out = pnet.output(x)
    _close(out, jnet.output(x))
    _close(out.sum(1), np.ones(3), atol=1e-5)


def test_lenet_adadelta_steps_match_jax():
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.zoo import LeNet as JLeNet
    jnet = JLeNet().init_graph()
    pnet = _carry(jnet, MultiLayerNetwork(LeNet().conf()))
    rng = np.random.default_rng(2)
    x = rng.random((8, 28, 28, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    for _ in range(2):
        jl = jnet.fit(JDataSet(x, y))
        pl = pnet.fit(DataSet(x, y))
        assert pl == pytest.approx(jl, rel=1e-5)
    for k in ("W", "b"):
        _close(pnet.params_tree["layer_4"][k],
               jnet.params_tree["layer_4"][k], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["LeNet", "SimpleCNN"])
def test_checked_in_zip_restores_and_matches_jax(name):
    _jax()
    from deeplearning4j_tpu.utils.model_serializer import (
        restore_model as jrestore)
    jnet = jrestore(str(ZIPS[name]))
    pnet = restore_model(ZIPS[name], device="cpu")
    assert isinstance(pnet, MultiLayerNetwork)
    assert pnet.conf.to_dict() == jnet.conf.to_dict()
    shape = tuple(pnet.conf.input_type.shape)
    x = np.random.default_rng(3).random((6,) + shape).astype(np.float32)
    _close(pnet.output(x), jnet.output(x))
    # the checkpoint's batch-norm statistics came with it
    if name == "SimpleCNN":
        np.testing.assert_array_equal(
            pnet.state_tree["layer_1"]["var"].numpy(),
            np.asarray(jnet.state_tree["layer_1"]["var"]))


def _image_batches(it, shape):
    """An iterator's batches with the features reshaped to NHWC."""
    return ListDataSetIterator([
        DataSet(ds.features.reshape((-1,) + shape), ds.labels)
        for ds in it])


@pytest.mark.parametrize("name,gate", [("LeNet", 0.97), ("SimpleCNN", 0.9)])
def test_checked_in_zips_meet_the_reference_gates(name, gate):
    """The reference's gates (tests/test_pretrained_weights.py) on 500
    examples of each synthetic test split; evaluate()'s confusion equals
    the argmax of output() on the host."""
    from deeplearning4j_torch.data.builtin import Cifar10DataSetIterator
    from deeplearning4j_torch.data.mnist import MnistDataSetIterator
    net = restore_model(ZIPS[name], device="cpu")
    if name == "LeNet":
        it = MnistDataSetIterator(256, n_examples=500, train=False)
    else:
        it = Cifar10DataSetIterator(256, train=False, n_examples=500,
                                    seed=11)
    assert it.is_synthetic
    batches = _image_batches(it, tuple(net.conf.input_type.shape))
    ev = net.evaluate(batches)
    assert ev.accuracy() > gate, ev.accuracy()
    host = np.zeros((10, 10), np.int64)
    for ds in batches:
        pred = net.output(ds.features).numpy().argmax(-1)
        np.add.at(host, (ds.labels.argmax(-1), pred), 1)
    np.testing.assert_array_equal(ev.confusion, host)
    assert host.sum() == 500


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_sets_equal_the_reference(train):
    from deeplearning4j_tpu.data import builtin as jb
    from deeplearning4j_tpu.data import mnist as jm

    from deeplearning4j_torch.data import builtin as pb
    from deeplearning4j_torch.data import mnist as pm
    for a, b in zip(pm.synthetic_mnist(300, train, seed=5),
                    jm.synthetic_mnist(300, train, seed=5)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pb.synthetic_cifar(200, train, 11),
                    jb._synthetic_cifar(200, train, 11)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for pit, jit in ((pm.MnistDataSetIterator(64, train=train,
                                              n_examples=150),
                      jm.MnistDataSetIterator(64, train=train,
                                              n_examples=150)),
                     (pb.Cifar10DataSetIterator(64, train=train,
                                                n_examples=100, seed=11),
                      jb.Cifar10DataSetIterator(64, train=train,
                                                n_examples=100, seed=11)),
                     (pb.IrisDataSetIterator(50, n_examples=120),
                      jb.IrisDataSetIterator(50, n_examples=120))):
        for _ in range(2):           # two epochs: the shuffles agree too
            pbs, jbs = list(pit), list(jit)
            assert len(pbs) == len(jbs)
            for p, j in zip(pbs, jbs):
                np.testing.assert_array_equal(p.features, j.features)
                np.testing.assert_array_equal(p.labels, j.labels)


@pytest.mark.parametrize("kind", ["NormalizerStandardize",
                                  "NormalizerMinMaxScaler",
                                  "ImagePreProcessingScaler"])
def test_normalizers_match_the_reference(kind):
    from deeplearning4j_tpu.data import normalization as jn
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.data.iterator import ArrayDataSetIterator as JA

    from deeplearning4j_torch.data import normalization as pn
    from deeplearning4j_torch.data.iterator import ArrayDataSetIterator
    rng = np.random.default_rng(4)
    x = (rng.random((40, 4, 4, 2)) * 255).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 40)]
    pnorm = getattr(pn, kind)().fit(ArrayDataSetIterator(x, y, 16))
    jnorm = getattr(jn, kind)().fit(JA(x, y, 16))
    for k, v in jnorm.state_dict().items():
        np.testing.assert_allclose(pnorm.state_dict()[k], v, rtol=1e-6)
    got = pnorm.transform(DataSet(x[:5], y[:5])).features
    want = jnorm.transform(JDataSet(x[:5], y[:5])).features
    np.testing.assert_allclose(got, want, rtol=1e-6)
    it = ArrayDataSetIterator(x, y, 16)
    it.pre_processor = pnorm
    np.testing.assert_array_equal(
        next(iter(it)).features,
        pnorm.transform(DataSet(x[:16], y[:16])).features)


def test_init_graph_builds_the_configurations_class():
    assert isinstance(LeNet().init_graph(device="cpu"), MultiLayerNetwork)
    net = ResNet50(n_classes=3, input_shape=(32, 32, 3)).init_graph(
        device="cpu")
    assert isinstance(net, ComputationGraph)
    assert net.device == torch.device("cpu")


# -- on the card -------------------------------------------------------
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu "
                    "tests/test_torch_*.py on the card)")


def _train_forward_backward(net, x, y):
    """(inference output, loss, grads, new state) of one training
    forward and backward."""
    net._build_solver()
    loss, state, grads = net._solver._loss_and_grads(
        net.params_tree, net.state_tree, net._batch_dict(DataSet(x, y)),
        None)
    return net.output(x), loss, grads, state


@pytest.mark.gpu
def test_cuda_resnet50_matches_cpu():
    """chip_smoke.py's resnet part (a) at 64x64, b 2: the same
    f32-representable parameters on the card and on the CPU.  f64:
    output, loss, the stem's, a strided projection's, a batch-norm
    gamma's and the head's gradients and every batch-norm state within
    1e-7; f32 with TF32 off: output, loss and state within 1e-3, the
    gradients (channels-last) no further than 4x the CPU f32's own
    normwise distance from the CPU's f64; every distinct convolution and
    pooling alone in f32 channels-last within 1e-4 of the CPU in f64."""
    _cuda_or_skip()
    import chip_smoke
    row, bad = chip_smoke.resnet_card_vs_cpu(torch, np, 64, "cuda")
    assert not bad, row
    assert len(row["layers"]["err"]) >= 15


@pytest.mark.gpu
def test_cuda_resnet50_bf16_step():
    """One bf16 compiled_train_step and one fit step of ResNet-50 at
    64x64 on the card: finite losses, batch-norm statistics moved."""
    _cuda_or_skip()
    net = ResNet50(n_classes=10, input_shape=(64, 64, 3)).init_graph()
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(4, 64, 64, 3)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
    step = net.compiled_train_step()
    st, loss = step(step.init(), x, y)
    assert np.isfinite(float(loss)) and st.step == 1
    assert not torch.equal(st.model_state["conv1_bn"]["var"],
                           net.state_tree["conv1_bn"]["var"])
    fit_loss = net.fit(DataSet(x.float().cpu().numpy(), y))
    assert np.isfinite(fit_loss)
    assert float(net.state_tree["conv1_bn"]["mean"].abs().sum()) > 0
