"""The port's runtime sanitizer (``DL4J_TPU_SANITIZE=nan``) and the
fit-loop telemetry bridge, held to the JAX package: the reference's
``tests/test_analysis.py`` sanitizer cases (the ``nan`` mode and the
parser; ``donation`` is accepted and does nothing in the port — torch
has no buffer donation), run in BOTH packages where they are pure host;
a poisoned slot caught at the decode tick of the port's server; a NaN
loss caught by the port's fit loop with the reference's message; and
``TelemetryListener`` series equal across packages on the same fit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_plane_util import plane  # noqa: E402
from torch_serving_util import tiny_net  # noqa: E402

PORT = "deeplearning4j_torch"


def _sanitize(pkg):
    import importlib
    return importlib.import_module(f"{pkg}.analysis.sanitize")


@pytest.fixture
def san_env(monkeypatch):
    touched = []

    def set_modes(modes, pkg=PORT):
        monkeypatch.setenv("DL4J_TPU_SANITIZE", modes)
        mod = _sanitize(pkg)
        touched.append(mod)
        return mod.refresh()
    yield set_modes
    monkeypatch.delenv("DL4J_TPU_SANITIZE", raising=False)
    for mod in touched:
        mod.refresh()


def test_modes_parse_alike_in_both_packages(san_env):
    pytest.importorskip("jax")
    out = {}
    for pkg in ("deeplearning4j_tpu", PORT):
        rows = []
        for text in ("", "nan", "donation", "nan,donation", "all",
                     " NaN , "):
            rows.append(sorted(san_env(text, pkg)))
        with pytest.raises(ValueError):
            san_env("nan,bogus", pkg)
        out[pkg] = rows
    assert out[PORT] == out["deeplearning4j_tpu"]
    assert out[PORT][1] == ["nan"] and out[PORT][4] == ["donation", "nan"]


def test_nan_check(san_env):
    san = _sanitize(PORT)
    san_env("nan")
    assert san.active("nan")
    san.check_finite("ok", np.ones(4))
    san.check_finite("ok", torch.ones(4))
    san.check_finite("ints", np.asarray([1, 2]))
    for bad in (float("nan"), torch.tensor([1.0, float("inf")]),
                np.asarray([np.nan, 1.0], np.float32)):
        with pytest.raises(san.SanitizerError, match="train/loss"):
            san.check_finite("train/loss", bad)


def test_nan_rows_masked(san_env):
    san = _sanitize(PORT)
    san_env("nan")
    for arr in (np.ones((3, 4), np.float32), torch.ones(3, 4)):
        arr[1] = float("nan")
        san.check_finite_rows("tick", arr, [True, False, True])
        with pytest.raises(san.SanitizerError, match=r"row\(s\) \[1\]"):
            san.check_finite_rows("tick", arr, [False, True, False])


def test_off_by_default_and_donation_is_a_no_op(san_env):
    san = _sanitize(PORT)
    san_env("")
    assert not san.enabled() and not san.active("nan")
    san_env("donation")
    assert san.active("donation") and not san.active("nan")


def test_decode_tick_catches_a_poisoned_slot(san_env):
    """A request whose prompt reaches a NaN embedding row poisons its own
    slot's logits: with the sanitizer on, the decode tick's active-row
    check trips (counted), the server's recovery fails that request
    alone, and a clean request in the other slot completes."""
    from deeplearning4j_torch.models.generation import TransformerGenerator
    from deeplearning4j_torch.parallel import GenerationServer
    from deeplearning4j_torch.resilience.errors import RetryableServerError
    P = plane(PORT)
    san = _sanitize(PORT)
    net = tiny_net()
    emb = net.params_tree["layer_0"]
    name = "W" if "W" in emb else sorted(emb)[0]
    clean = np.asarray([1, 2, 3, 4, 5], np.int32)
    ref = TransformerGenerator(net, device="cpu").generate(clean[None],
                                                           n_new=12)[0]
    with torch.no_grad():
        emb[name][7] = float("nan")
    trips = P.telemetry.get_registry().counter(
        "sanitizer_trips_total", labelnames=("mode",)).labels(mode="nan")
    t0 = trips.value
    san_env("nan")
    with GenerationServer(net, n_slots=2, max_len=32, block_size=4,
                          tick_batch=1, tick_timeout_s=None,
                          device="cpu") as srv:
        h_bad = srv.submit_async(np.asarray([3, 7, 2], np.int32), 8)
        h_ok = srv.submit_async(clean, 12)
        with pytest.raises(RetryableServerError) as ei:
            h_bad.result(timeout=120)
        np.testing.assert_array_equal(h_ok.result(timeout=120), ref)
    cause = ei.value.__cause__
    assert isinstance(cause, san.SanitizerError), cause
    assert "serve/tick logits" in str(cause)
    assert trips.value - t0 >= 1


def _fit_models():
    """{package: model}: the same one-layer softmax classifier in both
    packages, the port carrying the JAX package's initial weights."""
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf.layers_core import OutputLayer as JOut
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf import (NeuralNetConfiguration,
                                              OutputLayer)
    from deeplearning4j_torch.utils import load_numpy_params
    nets = {}
    for pkg, nnc, out in (("deeplearning4j_tpu", JNNC, JOut),
                          (PORT, NeuralNetConfiguration, OutputLayer)):
        conf = (nnc.builder().seed(3).list()
                .layer(out(n_in=4, n_out=2, activation="softmax",
                           loss="mcxent"))
                .build())
        nets[pkg] = conf
    jnet = JMLN(nets["deeplearning4j_tpu"]).init()
    pnet = MultiLayerNetwork(nets[PORT]).init(device="cpu")
    load_numpy_params(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree),
                      device="cpu")
    return {"deeplearning4j_tpu": jnet, PORT: pnet}


def _batches(pkg, poison=False):
    import importlib
    ds = importlib.import_module(f"{pkg}.data.dataset")
    it = importlib.import_module(f"{pkg}.data.iterator")
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    if poison:
        x[4:] = np.nan                  # the second batch of four
    y = np.eye(2, dtype=np.float32)[[0, 1] * 4]
    return it.ListDataSetIterator(ds.DataSet(x, y).batch_by(4))


def test_fit_loop_nan_trips(san_env):
    """A NaN batch at iteration 1: the port's fit loop raises with the
    same site and iteration as the JAX package's."""
    pytest.importorskip("jax")
    msgs = {}
    for pkg, m in _fit_models().items():
        san = _sanitize(pkg)
        san_env("nan", pkg)
        with pytest.raises(san.SanitizerError,
                           match="iteration 1") as ei:
            m.fit(_batches(pkg, poison=True), n_epochs=1,
                  async_prefetch=False)
        msgs[pkg] = str(ei.value)
    assert msgs[PORT] == msgs["deeplearning4j_tpu"]
    assert "train/loss" in msgs[PORT]


def test_telemetry_listener_series_alike_in_both_packages():
    """One epoch of the same model on the same batches, each package's
    ``TelemetryListener`` on a private registry: the same series, the
    same loss gauge (1e-5: two frameworks' softmax), the same step and
    example counts, one snapshot record per epoch."""
    pytest.importorskip("jax")
    out = {}
    for pkg, m in _fit_models().items():
        P = plane(pkg)
        import importlib
        lst_mod = importlib.import_module(f"{pkg}.telemetry.listener")

        class _Store:
            def __init__(self):
                self.recs = []

            def put(self, rec):
                self.recs.append(rec)

        reg, store = P.registry.MetricsRegistry(), _Store()
        m.set_listeners(lst_mod.TelemetryListener(
            registry=reg, storage=store, flops_per_example=100.0))
        m.fit(_batches(pkg), n_epochs=1, async_prefetch=False)
        snap = reg.snapshot()
        out[pkg] = {"names": sorted(f.name for f in reg.families()),
                    "loss": snap["gauges"]["train_loss"],
                    "steps": snap["histograms"]["train_step_seconds"]
                    ["count"],
                    "records": [r["type"] for r in store.recs],
                    "mfu_set": snap["gauges"]["mfu"] > 0}
    ref, port = out["deeplearning4j_tpu"], out[PORT]
    assert port["names"] == ref["names"]
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert port["steps"] == ref["steps"] == 1
    assert port["records"] == ref["records"] == ["telemetry_snapshot"]
    assert port["mfu_set"] and ref["mfu_set"]
