"""The port's ``ParallelInference`` (``parallel/inference.py``) held to the
JAX package's on the cases of ``tests/test_parallel_aux.py`` (a direct
batch, 24 concurrent single-example callers, shutdown) and the
multi-output graph of ``tests/test_graph_advanced.py``: the same model
(the JAX net's parameters carried across), served by both packages'
servers, gives the same numpy results (f32, atol 1e-6), and the port's
equal its own ``output()`` of the same rows.  Then what the reference
promises beyond that: the batches the model sees are padded to powers of
two (``inference_padding_waste``), the ``_param_sync_hook`` runs before
every batch, ``shed_on_full`` rejects into ``inference_shed_total``, a
caller's ``timeout`` counts into ``inference_timeout_total``, an
exception in the worker reaches every caller of its batch, and the nine
``inference_*`` series keep the reference's names and kinds."""
import threading
import time

import numpy as np
import pytest

from torch_model_util import (  # noqa: F401 (a fixture among them)
    carry, conf_ns, host, jax, one_torch_thread)

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

from deeplearning4j_torch import telemetry  # noqa: E402
from deeplearning4j_torch.parallel import ParallelInference  # noqa: E402

SERIES = ("inference_requests_total", "inference_batches_total",
          "inference_errors_total", "inference_shed_total",
          "inference_timeout_total", "inference_latency_seconds",
          "inference_queue_depth", "inference_batch_occupancy",
          "inference_padding_waste")


def _mlp(package, seed=3):
    P = conf_ns(package)
    return (P.NeuralNetConfiguration.builder().seed(seed)
            .updater(P.Adam(learning_rate=1e-2)).list()
            .layer(P.DenseLayer(n_in=8, n_out=16, activation="relu"))
            .layer(P.OutputLayer(n_out=4, activation="softmax",
                                 loss="mcxent"))
            .build())


def _pair():
    """(JAX MLP, the port's carry of it on the CPU)."""
    jax()
    from deeplearning4j_tpu.models.multi_layer_network import (
        MultiLayerNetwork as JMLN)

    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    jnet = JMLN(_mlp("deeplearning4j_tpu")).init()
    return jnet, carry(jnet, MultiLayerNetwork(_mlp("deeplearning4j_torch")))


def _port_mlp():
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    return MultiLayerNetwork(_mlp("deeplearning4j_torch")).init(device="cpu")


def _concurrent(pi, xs):
    results = [None] * len(xs)

    def call(i):
        results[i] = pi.output(xs[i])
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def test_direct_batch_matches_jax():
    from deeplearning4j_tpu.parallel import ParallelInference as JPI
    jnet, pnet = _pair()
    x = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    with ParallelInference(pnet, batch_limit=8) as pi:
        got = pi.output(x)
    with JPI(jnet, batch_limit=8) as jpi:
        want = jpi.output(x)
    assert isinstance(got, np.ndarray) and got.shape == (16, 4)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got, host(pnet.output(x)), atol=1e-6)


def test_concurrent_callers_match_jax():
    from deeplearning4j_tpu.parallel import ParallelInference as JPI
    jnet, pnet = _pair()
    r = np.random.default_rng(1)
    xs = [r.normal(size=(8,)).astype(np.float32) for _ in range(24)]
    with ParallelInference(pnet, batch_limit=16, timeout_ms=10) as pi:
        got = _concurrent(pi, xs)
    with JPI(jnet, batch_limit=16, timeout_ms=10) as jpi:
        want = _concurrent(jpi, xs)
    direct = host(pnet.output(np.stack(xs)))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is not None and g.shape == (4,), i
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6)
        np.testing.assert_allclose(g, direct[i], atol=1e-5)


def test_multi_output_graph_matches_jax():
    jax()
    from deeplearning4j_tpu.models.computation_graph import (
        ComputationGraph as JCG)
    from deeplearning4j_tpu.parallel import ParallelInference as JPI

    from deeplearning4j_torch.models.computation_graph import (
        ComputationGraph)

    def conf(package):
        P = conf_ns(package)
        return (P.NeuralNetConfiguration.builder().seed(11)
                .updater(P.Adam(learning_rate=1e-2)).graph()
                .add_inputs("in").set_input_types(P.InputType.feed_forward(4))
                .add_layer("d", P.DenseLayer(n_out=8, activation="relu"),
                           "in")
                .add_layer("out1", P.OutputLayer(
                    n_out=3, activation="softmax", loss="mcxent"), "d")
                .add_layer("out2", P.OutputLayer(
                    n_out=1, activation="identity", loss="mse"), "d")
                .set_outputs("out1", "out2").build())
    jnet = JCG(conf("deeplearning4j_tpu")).init()
    pnet = carry(jnet, ComputationGraph(conf("deeplearning4j_torch")))
    x = np.random.default_rng(2).normal(size=(6, 4)).astype(np.float32)
    with ParallelInference(pnet, batch_limit=8) as pi:
        got = pi.output(x)
        one = pi.output(x[0])
    with JPI(jnet, batch_limit=8) as jpi:
        want = jpi.output(x)
    assert isinstance(got, list) and len(got) == 2
    for g, w, d in zip(got, want, host(pnet.output(x))):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)
        np.testing.assert_allclose(g, d, atol=1e-5)
    assert [o.shape for o in one] == [(3,), (1,)]


def test_rejects_after_shutdown():
    pi = ParallelInference(_port_mlp())
    pi.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        pi.output(np.zeros((8,), np.float32))


def _series(name):
    return telemetry.get_registry().get(name)


def test_batches_padded_to_powers_of_two_with_the_sync_hook():
    """Three rows coalesced into one batch run as a bucket of 4 (one
    padded row: waste 0.25), and the hook runs before each batch (and
    once at construction: ``_check_init`` syncs a lazily synced model,
    as the reference's does)."""
    net = _port_mlp()
    seen, hooks = [], []
    orig = net._forward_infer
    net._forward_infer = lambda p, s, x: (seen.append(x.shape[0]),
                                          orig(p, s, x))[1]
    net._param_sync_hook = lambda: hooks.append(1)
    waste0 = _series("inference_padding_waste").count
    waste_sum0 = _series("inference_padding_waste").sum
    with ParallelInference(net, batch_limit=8) as pi:
        out = pi.output(np.ones((3, 8), np.float32))
    assert out.shape == (3, 4) and seen == [4] and hooks == [1, 1]
    assert _series("inference_padding_waste").count == waste0 + 1
    assert _series("inference_padding_waste").sum - waste_sum0 == \
        pytest.approx(0.25)


def _blocked(net):
    """Make ``net``'s forward wait on the returned event."""
    gate = threading.Event()
    orig = net._forward_infer

    def slow(p, s, x):
        gate.wait(10)
        return orig(p, s, x)
    net._forward_infer = slow
    return gate


def test_shed_on_full_and_timeout_count():
    net = _port_mlp()
    gate = _blocked(net)
    shed0 = _series("inference_shed_total").value
    to0 = _series("inference_timeout_total").value
    x = np.ones((8,), np.float32)
    with ParallelInference(net, batch_limit=1, queue_limit=1,
                           shed_on_full=True) as pi:
        first = threading.Thread(target=pi.output, args=(x,))
        first.start()                      # taken by the worker, blocked
        deadline = time.time() + 5
        while pi._queue.qsize() and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(TimeoutError):
            pi.output(x, timeout=0.05)     # queued, then abandoned
        with pytest.raises(RuntimeError, match="shed"):
            pi.output(x)                   # the queue (1) is full
        gate.set()
        first.join(5)
    assert _series("inference_shed_total").value == shed0 + 1
    assert _series("inference_timeout_total").value == to0 + 1


def test_worker_exception_reaches_every_caller():
    net = _port_mlp()
    gate = _blocked(net)
    orig = net._forward_infer

    def boom(p, s, x):
        orig(p, s, x)
        raise ValueError("forward failed")
    net._forward_infer = boom
    err0 = _series("inference_errors_total").value
    errors = []

    def call(pi):
        try:
            pi.output(np.ones((8,), np.float32))
        except ValueError as e:
            errors.append(e)
    with ParallelInference(net, batch_limit=4, timeout_ms=200) as pi:
        threads = [threading.Thread(target=call, args=(pi,))
                   for _ in range(3)]
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join(10)
    assert len(errors) == 3 and all("forward failed" in str(e)
                                    for e in errors)
    assert _series("inference_errors_total").value >= err0 + 3


def test_series_names_and_kinds_match_jax():
    jax()
    import deeplearning4j_tpu.parallel.inference  # noqa: F401
    from deeplearning4j_tpu import telemetry as jtel
    for name in SERIES:
        mine, ref = _series(name), jtel.get_registry().get(name)
        assert mine is not None and ref is not None, name
        assert mine.kind == ref.kind, name
        if mine.kind == "histogram":
            assert tuple(mine.buckets) == tuple(ref.buckets), name


def _tiny_vgg_class():
    """VGG16 cut to two conv blocks and dense 16 (the infer phase's
    rehearsal size)."""
    from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers_conv import (ConvolutionLayer,
                                                          SubsamplingLayer)
    from deeplearning4j_torch.nn.conf.layers_core import (DenseLayer,
                                                          OutputLayer)
    from deeplearning4j_torch.optimize.updaters import Nesterovs
    from deeplearning4j_torch.zoo import VGG16

    class TinyVGG(VGG16):
        def conf(self):
            h, w, c = self.input_shape
            lb = (NeuralNetConfiguration.builder().seed(self.seed)
                  .updater(Nesterovs(learning_rate=1e-2, momentum=0.9))
                  .weight_init("xavier").list())
            for n_out in (4, 8):
                lb.layer(ConvolutionLayer(kernel_size=(3, 3),
                                          convolution_mode="same",
                                          n_out=n_out, activation="relu"))
                lb.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                          pooling_type="max"))
            return (lb.layer(DenseLayer(n_out=16, activation="relu",
                                        dropout=0.5))
                    .layer(DenseLayer(n_out=16, activation="relu",
                                      dropout=0.5))
                    .layer(OutputLayer(n_out=self.n_classes,
                                       activation="softmax", loss="mcxent"))
                    .set_input_type(InputType.convolutional(h, w, c))
                    .build())
    return TinyVGG


def test_pinned_decisions_follow_the_recorded_branch():
    """``chip_smoke.pinned_decisions``, which part (a) of the infer phase
    uses to hold the card's f32 gradients to f64 along the card's own
    ReLU and max-pool decisions: replayed on the recorded run's input it
    reproduces that run's loss and gradients exactly (z * mask is the
    ReLU, the gather is the pool); replayed on another input it keeps the
    recorded branch, so its loss differs from that input's own run, whose
    decisions differ (counted by ``flips``)."""
    import chip_smoke

    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.utils.trees import map_leaves
    vgg = _tiny_vgg_class()(n_classes=10, input_shape=(16, 16, 3))
    params = map_leaves(lambda t: t.numpy(), MultiLayerNetwork(
        vgg.conf()).init(device="cpu").params_tree)
    r = np.random.default_rng(5)
    x1, x2 = (r.normal(size=(2, 16, 16, 3)).astype(np.float32)
              for _ in range(2))
    y = np.eye(10, dtype=np.float32)[[1, 7]]
    pd = chip_smoke.pinned_decisions

    def run(x, dec):
        return chip_smoke.infer_vgg_pass(torch, vgg, params, x, y,
                                         "float64", "cpu", dec)
    a, b = pd(), pd()
    ra, rb = run(x1, a), run(x2, b)
    flips = b.flips(a)
    assert set(flips) == {"relu", "max_pool"}
    assert flips["relu"][1] == 2 * (16 * 16 * 4 + 8 * 8 * 8 + 16 + 16)
    assert flips["max_pool"][1] == 2 * (8 * 8 * 4 + 4 * 4 * 8)
    assert flips["relu"][0] > 0 and flips["max_pool"][0] > 0
    same = run(x1, pd(replay=a))
    assert torch.equal(same[1], ra[1])
    assert all(torch.equal(same[2][k], g) for k, g in ra[2].items())
    other = run(x2, pd(replay=a))
    assert not torch.equal(other[1], rb[1])


def test_infer_phase_rehearsal_on_cpu(monkeypatch):
    """``chip_smoke.py``'s infer phase whole on the CPU at tiny sizes: a
    two-block VGG (16 x 16 x 3, dense 16) for parts (a)-(d), the zoo
    tests' sizes for (e), and the attention classifier at 2 heads of 8
    (t 512 and 1024, the flash route's plain versions) with counting
    stand-ins for the flash wrappers: one launch of K4, K5 and K6 a step
    at t 512, of K3, K5 and K6 at t 1024."""
    import importlib

    import chip_smoke
    from test_torch_zoo_extra import SMALL

    fa = importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")
    TinyVGG = _tiny_vgg_class()

    def counted(orig):
        def wrapper(*a, **kw):
            wrapper.launches += 1
            return orig(*a, **kw)
        wrapper.launches = 0
        return wrapper

    for name in chip_smoke.FLASH_WRAPPERS:
        monkeypatch.setattr(fa, name, counted(getattr(fa, name)))
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    cfg = dict(chip_smoke.INFER_CFG, tl_b=4, tl_steps=4, tl_classes=3,
               pi_threads=3, pi_requests=4, pi_batch_limit=4,
               pi_queue_limit=8, q_images=8, attn_b=2, attn_heads=2,
               attn_head=8, attn_steps=2, attn_long_steps=1,
               zoo_kwargs=SMALL)
    torch.manual_seed(0)
    counts = chip_smoke.infer_parts(
        torch, np, "cpu", cfg, TinyVGG(n_classes=10,
                                       input_shape=(16, 16, 3)),
        lambda: None, "cpu")
    assert counts == {
        "masked": {"flash_fwd": 0, "flash_fwd_single": 2,
                   "flash_bwd_dkdv": 2, "flash_bwd_dq": 2},
        "long": {"flash_fwd": 1, "flash_fwd_single": 0,
                 "flash_bwd_dkdv": 1, "flash_bwd_dq": 1}}
    (row,) = lines
    assert row["b_transfer"]["frozen_bit_identical"]
    assert row["c_parallel_inference"]["requests"] == 12
    assert row["c_parallel_inference"]["shed"]["counted"] == 1
    assert row["d_quantized"]["compression_ratio"] > 2
    assert set(row["e_zoo"]["forward"]) == set(chip_smoke.ZOO_INFER)
    assert row["e_zoo"]["fit"]["FaceNetNN4Small2"]["center_term"] > 0
    assert all(v == 0 for v in
               row["f_attention"]["masked"]["kernel_vs_plain"].values())
    a = row["a_vgg_card_vs_cpu"]
    assert {k.split()[0] for k in a["layers"]} == {
        "ConvolutionLayer", "SubsamplingLayer", "DenseLayer"}
    assert a["flipped_decisions"]["card"] == a["flipped_decisions"]["cpu"]
    assert a["float32"]["grad"] <= 1e-5
