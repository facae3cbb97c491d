"""The port's gradient-check harness (``tests/test_gradient_check.py``
ported, its two LSTM cases included).

Each model is the JAX package's configuration and initial parameters
carried into the port (``utils.convert``), checked on the same
numpy-seeded batch: float64, centred differences against
``torch.autograd``, DL4J's rule (relative error below 1e-5 or absolute
below 1e-8).  For the MLP the JAX harness runs too and the two check the
same entries.  Beyond the reference: a two-layer causal transformer stack
at t 512, whose attention takes ``_Flash``'s plain route (the K3 forward
and the hand-written K5/K6 backward); there the step is 1e-4, where
f64 rounding of the 512-token mean stays below the absolute bound.  The
harness must also FAIL on a wrong gradient: a loss term the gradient
does not see, and a dQ scaled by 0.9 in the flash backward."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.data import DataSet  # noqa: E402
from deeplearning4j_torch.utils.gradient_check import (  # noqa: E402
    check_model_gradients)


@pytest.fixture
def one_torch_thread():
    """Torch on one intra-op thread for the test: its many small CPU ops
    otherwise spin a thread pool per test worker, and under the suite's
    parallel workers those pools starve each other (a 5 s case took over
    100 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(jnet):
    """The port's copy of a JAX network: configuration, parameters and
    batch-norm state, on the CPU."""
    import jax

    from deeplearning4j_torch.models.computation_graph import (
        ComputationGraph, ComputationGraphConfiguration)
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf.builder import MultiLayerConfiguration
    from deeplearning4j_torch.utils import (load_numpy_params,
                                            load_numpy_state)
    d = jnet.conf.to_dict()
    if "vertices" in d:
        net = ComputationGraph(ComputationGraphConfiguration.from_dict(d))
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(d))
    net.init(device="cpu")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    load_numpy_params(net, np_tree(jnet.params_tree), device="cpu")
    load_numpy_state(net, np_tree(jnet.state_tree))
    return net


def _mln(layers, input_type, seed=12, l1=None, l2=None):
    pytest.importorskip("jax")
    from deeplearning4j_tpu import MultiLayerNetwork, NeuralNetConfiguration
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater({"type": "Sgd", "learning_rate": 0.1}))
    if l1:
        b = b.l1(l1).l2(l2)
    b = b.list()
    for ly in layers:
        b.layer(ly)
    return MultiLayerNetwork(b.set_input_type(input_type).build()).init()


def _cls_ds(rng, shape, n_cls, seq=False):
    x = rng.normal(size=shape).astype(np.float64)
    lab = rng.integers(0, n_cls, shape[:2] if seq else shape[0])
    return x, np.eye(n_cls)[lab].astype(np.float64)


def _jax_layers():
    pytest.importorskip("jax")
    from deeplearning4j_tpu.nn.conf import inputs, layers_conv, layers_core
    return inputs.InputType, layers_core, layers_conv


def test_dense_mlp_gradients_match_jax_harness(rng):
    InputType, core, _ = _jax_layers()
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.utils.gradient_check import (
        check_model_gradients as jax_check)
    jnet = _mln([core.DenseLayer(n_out=12, activation="tanh"),
                 core.DenseLayer(n_out=8, activation="sigmoid"),
                 core.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent")],
                InputType.feed_forward(6))
    x, y = _cls_ds(rng, (5, 6), 3)
    res = check_model_gradients(_carry(jnet), DataSet(x, y),
                                max_per_param=16)
    assert res.passed, res.failures[:5]
    ref = jax_check(jnet, JDataSet(x, y), max_per_param=16)
    assert ref.passed
    assert res.n_checked == ref.n_checked == 71


def test_dense_l1_l2_gradients(rng):
    InputType, core, _ = _jax_layers()
    jnet = _mln([core.DenseLayer(n_out=10, activation="relu"),
                 core.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent")],
                InputType.feed_forward(6), seed=4, l1=0.02, l2=0.05)
    res = check_model_gradients(_carry(jnet), DataSet(*_cls_ds(rng, (5, 6),
                                                              3)),
                                max_per_param=16)
    assert res.passed, res.failures[:5]


def test_conv_bn_pool_gradients(rng):
    InputType, core, conv = _jax_layers()
    jnet = _mln([conv.ConvolutionLayer(kernel_size=(3, 3), n_out=4,
                                       activation="tanh",
                                       convolution_mode="same"),
                 conv.BatchNormalization(),
                 conv.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                       pooling_type="max"),
                 core.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent")],
                InputType.convolutional(8, 8, 2))
    res = check_model_gradients(_carry(jnet),
                                DataSet(*_cls_ds(rng, (4, 8, 8, 2), 2)),
                                max_per_param=12)
    assert res.passed, res.failures[:5]


def _recurrent():
    pytest.importorskip("jax")
    from deeplearning4j_tpu.nn.conf import inputs, layers_recurrent
    return inputs.InputType, layers_recurrent


def test_lstm_gradients(rng):
    InputType, rec = _recurrent()
    jnet = _mln([rec.LSTM(n_out=7),
                 rec.RnnOutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent")],
                InputType.recurrent(5))
    res = check_model_gradients(_carry(jnet),
                                DataSet(*_cls_ds(rng, (3, 6, 5), 3,
                                                 seq=True)),
                                max_per_param=12)
    assert res.passed, res.failures[:5]
    assert res.n_checked == 12 * 4 + 3      # the head bias has 3


def test_graves_lstm_masked_gradients(rng):
    """GravesLSTM (peepholes drawn non-zero, so their gradients are not
    trivially those of zero weights) under a features and labels mask:
    the carry is held through the padding, the loss sees valid steps
    only."""
    InputType, rec = _recurrent()
    jnet = _mln([rec.GravesLSTM(n_out=6),
                 rec.RnnOutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent")],
                InputType.recurrent(4))
    net = _carry(jnet)
    with torch.no_grad():
        net.params_tree["layer_0"]["P"].copy_(torch.from_numpy(
            rng.normal(0, 0.5, (3, 6)).astype(np.float32)))
    ds = DataSet(*_cls_ds(rng, (3, 5, 4), 3, seq=True))
    mask = np.ones((3, 5))
    mask[0, 3:] = 0
    mask[2, 2:] = 0
    ds.features_mask = mask
    ds.labels_mask = mask.copy()
    res = check_model_gradients(net, ds, max_per_param=12)
    assert res.passed, res.failures[:5]
    assert res.n_checked == 12 * 5 + 3


def test_graph_residual_gradients(rng):
    InputType, core, _ = _jax_layers()
    from deeplearning4j_tpu import ComputationGraph, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.graph_vertices import ElementWiseVertex
    conf = (NeuralNetConfiguration.builder().seed(5)
            .updater({"type": "Sgd", "learning_rate": 0.1})
            .graph().add_inputs("in")
            .set_input_types(InputType.feed_forward(6))
            .add_layer("d1", core.DenseLayer(n_out=10, activation="tanh"),
                       "in")
            .add_layer("d2", core.DenseLayer(n_out=10, activation="tanh"),
                       "d1")
            .add_vertex("res", ElementWiseVertex("add"), "d1", "d2")
            .add_layer("out", core.OutputLayer(n_out=3, activation="softmax",
                                               loss="mcxent"), "res")
            .set_outputs("out").build())
    net = _carry(ComputationGraph(conf).init())
    res = check_model_gradients(net, DataSet(*_cls_ds(rng, (4, 6), 3)),
                                max_per_param=16)
    assert res.passed, res.failures[:5]


def test_detects_wrong_gradient(rng):
    """A loss term the gradient does not see must fail the check."""
    InputType, core, _ = _jax_layers()
    net = _carry(_mln([core.DenseLayer(n_out=8, activation="relu"),
                       core.OutputLayer(n_out=3, activation="softmax",
                                        loss="mcxent")],
                      InputType.feed_forward(6)))
    orig = net._score_batch

    def broken(params, state, batch, rng_, training):
        loss, st = orig(params, state, batch, rng_, training)
        w = params["layer_0"]["W"]
        # contributes to the value but not to the gradient
        return loss + 0.1 * torch.sum(torch.square(w.detach())), st

    net._score_batch = broken
    res = check_model_gradients(net, DataSet(*_cls_ds(rng, (4, 6), 3)),
                                max_per_param=8)
    assert not res.passed


def _tiny_flash_gpt():
    from deeplearning4j_torch.zoo import Gpt
    return Gpt(vocab_size=11, d_model=8, n_layers=2, n_heads=2, d_ff=16,
               seq_len=512, max_len=512, compute_dtype=None,
               seed=3).init_graph(device="cpu")


def test_transformer_stack_through_flash_plain_route(monkeypatch,
                                                     one_torch_thread):
    """Two causal TransformerEncoderBlocks at t 512 (the flash route:
    K3's plain forward, K5/K6's plain backward), checked in f64; a dQ
    scaled by 0.9 in the backward fails the same check."""
    fa = importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")
    rng = np.random.default_rng(0)
    x = rng.integers(0, 11, (1, 512)).astype(np.int32)
    ds = DataSet(x, np.roll(x, -1, axis=1))
    net = _tiny_flash_gpt()
    fa.reset_route_log()
    res = check_model_gradients(net, ds, epsilon=1e-4, max_per_param=4)
    assert fa.route_log()[0] == ("flash", 512, 4)
    assert res.passed, res.failures[:5]
    assert res.n_checked > 80

    orig = fa.flash_bwd_dq
    monkeypatch.setattr(fa, "flash_bwd_dq",
                        lambda *a, **kw: 0.9 * orig(*a, **kw))
    bad = check_model_gradients(net, ds, epsilon=1e-4, max_per_param=2)
    assert not bad.passed
    assert any("Wqkv" in f.path for f in bad.failures)
