"""The port's weight-only int8 inference (``runtime/quantization.py``)
held to the JAX package's (``tests/test_quantization.py``):
``quantize_leaf`` gives bit-equal int8 values and scales; on the same
model (the checked-in LeNet, its graph form, a two-input graph)
``compression_ratio()`` is exactly the reference's and
``max_abs_weight_error()`` equal (the same bf16 dequantisation); the
int8 leaves stay int8 on the model's device; the quantized outputs agree
with the JAX package's (bf16-rounded weights: 2e-2 absolute on softmax
outputs) and keep the f32 model's argmax; accuracy on the synthetic MNIST
test split drops by at most one point and stays above 0.95, as the
reference's gate."""
import numpy as np
import pytest

from torch_model_util import (  # noqa: F401 (a fixture among them)
    carry, conf_ns, host, jax, one_torch_thread)

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

from deeplearning4j_torch.runtime.quantization import (  # noqa: E402
    QuantizedInference, quantize_leaf)


def test_quantize_leaf_bit_equal_to_jax():
    jax()
    from deeplearning4j_tpu.runtime.quantization import (
        quantize_leaf as jquantize)
    r = np.random.default_rng(0)
    for shape in ((64, 32), (3, 3, 8, 16), (5, 7)):
        w = r.normal(scale=0.3, size=shape).astype(np.float32)
        w[..., 0] = 0.0                      # an all-zero channel
        q, s = quantize_leaf(w)
        jq, js = jquantize(w)
        assert q.dtype == np.int8 and s.dtype == np.float32
        assert np.array_equal(q, jq) and np.array_equal(s, js)
        deq = q.astype(np.float32) * s
        assert (np.abs(w - deq) <= s * 0.5 + 1e-7).all()


def _lenet_pair():
    jax()
    from deeplearning4j_tpu.zoo import load_pretrained as jload

    from deeplearning4j_torch.zoo import load_pretrained
    return jload("LeNet", "mnist"), load_pretrained("LeNet", "mnist",
                                                    device="cpu")


def test_lenet_int8_matches_jax():
    from deeplearning4j_tpu.runtime.quantization import (
        QuantizedInference as JQI)
    from deeplearning4j_torch.data.mnist import MnistDataSetIterator
    jm, pm = _lenet_pair()
    qi, jqi = QuantizedInference(pm), JQI(jm)
    assert qi.compression_ratio() == jqi.compression_ratio()
    assert qi.compression_ratio() > 3.5
    assert qi.max_abs_weight_error() == jqi.max_abs_weight_error()
    assert qi.max_abs_weight_error() < 0.02
    assert all(q.dtype == torch.int8 and s.dtype == torch.float32
               for q, s in qi._quant.values())
    hits_f = hits_q = total = 0
    for ds in MnistDataSetIterator(256, n_examples=1000, train=False):
        x = np.asarray(ds.features).reshape(-1, 28, 28, 1)
        y = np.argmax(np.asarray(ds.labels), -1)
        got = host(qi.output(x))
        if total == 0:
            np.testing.assert_allclose(got, host(jqi.output(x)), atol=2e-2)
        hits_f += int((host(pm.output(x)).argmax(-1) == y).sum())
        hits_q += int((got.argmax(-1) == y).sum())
        total += len(y)
    acc_f, acc_q = hits_f / total, hits_q / total
    assert acc_q >= acc_f - 0.01 and acc_q > 0.95, (acc_f, acc_q)


def test_quantized_graph_logit_parity():
    from deeplearning4j_tpu.models.transfer_learning import (
        mln_to_graph as jto_graph)
    from deeplearning4j_tpu.runtime.quantization import (
        QuantizedInference as JQI)

    from deeplearning4j_torch.models.transfer_learning import mln_to_graph
    jm, pm = _lenet_pair()
    graph, jgraph = mln_to_graph(pm), jto_graph(jm)
    qi, jqi = QuantizedInference(graph), JQI(jgraph)
    assert qi.compression_ratio() == jqi.compression_ratio()
    x = np.random.default_rng(1).normal(size=(8, 28, 28, 1)).astype(
        np.float32)
    ref, got = host(graph.output(x)), host(qi.output(x))
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    assert float(np.abs(got - ref).max()) < 0.15
    np.testing.assert_allclose(got, host(jqi.output(x)), atol=2e-2)


def test_quantized_multi_input_graph():
    jax()
    from deeplearning4j_tpu.models.computation_graph import (
        ComputationGraph as JCG)
    from deeplearning4j_tpu.runtime.quantization import (
        QuantizedInference as JQI)

    from deeplearning4j_torch.models.computation_graph import (
        ComputationGraph)

    def conf(package):
        P = conf_ns(package)
        g = (P.NeuralNetConfiguration.builder().seed(2).graph()
             .add_inputs("a", "b")
             .set_input_types(P.InputType.feed_forward(4),
                              P.InputType.feed_forward(6)))
        g.add_layer("da", P.DenseLayer(n_out=8, activation="relu"), "a")
        g.add_layer("db", P.DenseLayer(n_out=8, activation="relu"), "b")
        g.add_vertex("m", P.MergeVertex(), "da", "db")
        g.add_layer("out", P.OutputLayer(n_out=3, activation="softmax",
                                         loss="mcxent"), "m")
        return g.set_outputs("out").build()
    jnet = JCG(conf("deeplearning4j_tpu")).init()
    pnet = carry(jnet, ComputationGraph(conf("deeplearning4j_torch")))
    qi, jqi = QuantizedInference(pnet), JQI(jnet)
    assert qi.compression_ratio() == jqi.compression_ratio()
    assert qi.max_abs_weight_error() == jqi.max_abs_weight_error()
    r = np.random.default_rng(3)
    xa = r.normal(size=(5, 4)).astype(np.float32)
    xb = r.normal(size=(5, 6)).astype(np.float32)
    ref = host(pnet.output(xa, xb))
    got = host(qi.output([xa, xb]))
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    np.testing.assert_allclose(got, host(jqi.output([xa, xb])), atol=2e-2)
