"""The port's arbiter and ui modules against the JAX package's, and a CPU
rehearsal of ``chip_smoke.py``'s ``periphery`` phase.

* arbiter: the random and grid generators give the same candidate
  sequences in both packages (numpy's generator on the host), and the
  runners evaluate and pick alike; the reference test's random search
  runs in the port inside the rehearsal below.
* ui: ``StatsListener`` records from the same training run in both
  packages (the port's MLP carries the JAX parameters) have the same
  keys, and equal values apart from the wall-clock ones; ``render_report``
  writes the same HTML in both for the same records once timestamps are
  removed; ``ProfilerListener`` writes a Chrome trace of its window.
* ``test_periphery_phase_rehearsal_on_cpu`` runs
  ``chip_smoke.periphery_parts`` whole on the CPU at tiny sizes.
"""
import importlib
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch import arbiter, ui  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mod(name):
    pytest.importorskip("jax")
    return importlib.import_module(f"deeplearning4j_tpu.{name}")


def _space(A):
    return {"lr": A.ContinuousParameterSpace(1e-4, 0.3, log_scale=True),
            "hidden": A.IntegerParameterSpace(4, 32),
            "act": A.DiscreteParameterSpace(["tanh", "relu", "gelu"]),
            "lin": A.ContinuousParameterSpace(-1.0, 1.0)}


# -- arbiter ----------------------------------------------------------------
def test_arbiter_candidate_sequences_equal_jax():
    JA = _jax_mod("arbiter")
    for seed in (0, 4):
        pg = iter(arbiter.RandomSearchGenerator(_space(arbiter), seed=seed))
        jg = iter(JA.RandomSearchGenerator(_space(JA), seed=seed))
        assert [next(pg) for _ in range(20)] == [next(jg) for _ in range(20)]
    assert list(arbiter.GridSearchGenerator(_space(arbiter), 3)) == \
        list(JA.GridSearchGenerator(_space(JA), 3))


def test_arbiter_runner_orders_and_picks_as_jax():
    """A scorer of the candidate alone: both runners evaluate the same
    candidates in the same order and pick the same best (minimising
    too), and both refuse an all-NaN search."""
    JA = _jax_mod("arbiter")

    def scorer(model, p):
        return p["lr"] * p["hidden"] + p["lin"]

    for maximize in (True, False):
        res = [A.OptimizationRunner(A.RandomSearchGenerator(_space(A), 7),
                                    lambda p: None, scorer,
                                    max_candidates=9,
                                    maximize=maximize).execute()
               for A in (arbiter, JA)]
        assert res[0].all_results == res[1].all_results
        assert res[0].best_candidate == res[1].best_candidate
        assert res[0].best_score == res[1].best_score
    with pytest.raises(ValueError, match="NaN"):
        arbiter.OptimizationRunner(
            arbiter.GridSearchGenerator({"a": arbiter.IntegerParameterSpace(
                1, 2)}), lambda p: None, lambda m, p: float("nan")).execute()


# -- ui -----------------------------------------------------------------------
_CLOCK = ("timestamp", "iter_seconds", "examples_per_sec")


def _stats_run(name, tmp_path):
    """Three epochs of an 8-16-4 MLP (the JAX package's init, carried into
    the port) with a StatsListener(collect_param_stats, every 2nd record)
    into a FileStatsStorage; returns the records."""
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf.layers_core import (DenseLayer as JD,
                                                        OutputLayer as JO)
    conf = (JNNC.builder().seed(3)
            .updater({"type": "Adam", "learning_rate": 1e-2}).list()
            .layer(JD(n_in=8, n_out=16, activation="relu"))
            .layer(JO(n_out=4, activation="softmax", loss="mcxent"))
            .build())
    jnet = JMLN(conf).init()
    r = np.random.default_rng(1)
    x = r.normal(size=(48, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[r.integers(0, 4, 48)]
    if name == "jax":
        from deeplearning4j_tpu.data.dataset import DataSet
        from deeplearning4j_tpu.data.iterator import ListDataSetIterator
        U, net = _jax_mod("ui"), jnet
    else:
        from deeplearning4j_torch.data import DataSet, ListDataSetIterator
        from deeplearning4j_torch.models.multi_layer_network import (
            MultiLayerNetwork)
        from deeplearning4j_torch.nn.conf.builder import (
            MultiLayerConfiguration)
        from deeplearning4j_torch.utils import load_numpy_params
        U = ui
        net = load_numpy_params(
            MultiLayerNetwork(MultiLayerConfiguration.from_dict(
                conf.to_dict())).init(device="cpu"),
            jax.tree_util.tree_map(np.asarray, jnet.params_tree),
            device="cpu")
    store = U.FileStatsStorage(str(tmp_path / name / "stats.jsonl"))
    net.set_listeners(U.StatsListener(store, collect_param_stats=True,
                                      param_stats_frequency=2))
    net.fit(ListDataSetIterator(DataSet(x, y).batch_by(16)), n_epochs=3)
    return store.records()


def test_stats_records_equal_jax(tmp_path):
    jr, pr = _stats_run("jax", tmp_path), _stats_run("port", tmp_path)
    assert len(pr) == len(jr) == 9
    for p, j in zip(pr, jr):
        assert sorted(p) == sorted(j)
        assert {k: v for k, v in p.items() if k not in _CLOCK
                and k not in ("loss", "params")} == \
            {k: v for k, v in j.items() if k not in _CLOCK
             and k not in ("loss", "params")}
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-5)
        assert ("params" in p) == ("params" in j)
        if "params" in p:
            assert list(p["params"]) == list(j["params"])
            for leaf in p["params"]:
                for stat in ("mean", "std", "absmax"):
                    np.testing.assert_allclose(
                        p["params"][leaf][stat], j["params"][leaf][stat],
                        rtol=0, atol=1e-5, err_msg=f"{leaf}/{stat}")


def test_render_report_equal_jax(tmp_path):
    """The same records (an iteration stream and a telemetry snapshot)
    render to the same HTML in both packages."""
    JU = _jax_mod("ui")
    recs = [{"iteration": i, "epoch": i // 3, "loss": 1.0 / (i + 1),
             "timestamp": 1700000000.0 + i, "batch_size": 16,
             "examples_per_sec": 100.0 + i} for i in range(7)]
    recs.append({"type": "telemetry_snapshot",
                 "counters": {"train_steps_total": 7},
                 "gauges": {"lr": 0.01},
                 "histograms": {"step_s": {"count": 7, "sum": 0.7,
                                           "p50": 0.1, "p95": 0.12,
                                           "p99": 0.13}}})
    pages = []
    for U in (ui, JU):
        store = U.InMemoryStatsStorage()
        for r in recs:
            store.put(dict(r))
        path = str(tmp_path / f"{len(pages)}.html")
        assert U.render_report(store, path, title="t",
                               trace_path="trace.jsonl") == path
        with open(path) as f:
            pages.append(f.read())
    assert pages[0] == pages[1]
    assert "<svg" in pages[0] and "train_steps_total" in pages[0]
    assert ui.render_report(ui.InMemoryStatsStorage(),
                            str(tmp_path / "none.html")) is None


def test_profiler_listener_writes_a_chrome_trace(tmp_path):
    """``ProfilerListener(start 1, n 2)`` over four CPU fit steps: the
    trace file of its window, the profile's events, closed at the
    epoch's end when the window outlives it."""
    from deeplearning4j_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf import (DenseLayer,
                                              NeuralNetConfiguration,
                                              OutputLayer)
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .build())
    r = np.random.default_rng(0)
    x = r.normal(size=(64, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[r.integers(0, 2, 64)]
    for start, n in ((1, 2), (2, 10)):
        net = MultiLayerNetwork(conf).init(device="cpu")
        prof = ui.ProfilerListener(str(tmp_path / f"p{start}"),
                                   start_iteration=start, n_iterations=n)
        net.set_listeners(prof)
        net.fit(ListDataSetIterator(DataSet(x, y).batch_by(16)))
        assert prof.trace_dir == str(tmp_path / f"p{start}")
        with open(prof.trace_path) as f:
            trace = json.load(f)
        names = {e.get("name") for e in trace["traceEvents"]}
        assert any(str(nm).startswith("aten::") for nm in names)
        assert not prof._active
    assert ui.TelemetryListener is importlib.import_module(
        "deeplearning4j_torch.telemetry").TelemetryListener


# -- the chip phase, rehearsed ------------------------------------------------
def test_periphery_phase_rehearsal_on_cpu(tmp_path, monkeypatch):
    """``chip_smoke.periphery_parts`` whole on the CPU at tiny sizes:
    ResNet-50's Keras config at 32 x 32, a 20,000-token corpus, the rl
    and arbiter parts at their real (host-sized) configurations, a
    one-layer Gpt at t 1024 with counting stand-ins for the flash
    wrappers (K3, K5, K6 once a layer a step), a 2,000-row CSV; the
    native build goes into a copy of ``native/`` so it never races the
    JAX package's in-tree build."""
    import chip_smoke
    from deeplearning4j_torch.native_io import binding
    if shutil.which("cmake") is None:
        pytest.skip("needs cmake")
    fa = importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")

    def counted(orig):
        def wrapper(*a, **kw):
            wrapper.launches += 1
            return orig(*a, **kw)
        wrapper.launches = 0
        return wrapper

    for name in chip_smoke.FLASH_WRAPPERS:
        monkeypatch.setattr(fa, name, counted(getattr(fa, name)))
    native = tmp_path / "native"
    shutil.copytree(os.path.join(chip_smoke.ROOT_DIR, "native"), native,
                    ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(binding, "_NATIVE_DIR", str(native))
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.delenv("DL4J_TPU_NATIVE_LIB", raising=False)
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    cfg = dict(chip_smoke.PERIPHERY_CFG, resnet_hw=32, resnet_fit_b=4,
               resnet_steps=1,
               w2v=dict(chip_smoke.PERIPHERY_CFG["w2v"], tokens=20000,
                        topics=4, topic_words=30, probe_steps=3),
               pv_sentences=400, ft_tokens=6000, ft_bucket=2000,
               ui_gpt={"n_layers": 1, "d_model": 32, "n_heads": 2,
                       "d_ff": 64, "vocab_size": 64, "max_len": 1024},
               ui_b=2, ui_t=1024, csv_rows=2000, csv_cols=8,
               csv_classes=3, csv_batch=100)
    counts = chip_smoke.periphery_parts(
        torch, np, "cpu", cfg, lambda: None, "cpu",
        lambda fn: (fn(), {})[1], chip_smoke.ROOT_DIR)
    assert counts == {"flash_fwd": 5, "flash_fwd_single": 0,
                      "flash_bwd_dkdv": 5, "flash_bwd_dq": 5}
    parts = {r["phase"].split("/")[1]: r for r in lines[:-1]}
    row = lines[-1]
    assert row["phase"] == "periphery" and list(parts) == list(
        row["part_s"]) == ["a_keras", "b_word2vec", "c_rl4j", "d_arbiter",
                           "e_ui", "f_native_io"]
    assert row["e_launches"] == counts
    a = parts["a_keras"]
    assert a["lenet"]["max_abs_err_vs_keras"] <= 1e-5
    assert a["resnet50"]["weights_leaves"] == 107
    assert a["resnet50"]["f32_vs_f64"]["flash_err"] <= 1e-4
    b = parts["b_word2vec"]
    assert b["step_checks"]["ns"]["syn0_err"] <= 1e-5
    assert b["topic_cosine"]["same"] > b["topic_cosine"]["other"]
    assert b["serializer"]["max_abs_err"] <= 1e-6
    assert parts["c_rl4j"]["dqn"]["greedy_return"] > 0.8
    d = parts["d_arbiter"]            # the reference test's search
    assert d["order_equals_host"] and len(d["candidates"]) == 6
    assert d["best_score"] > 0.8, d["scores"]
    assert 1e-4 <= d["best_candidate"]["lr"] <= 0.3
    assert parts["e_ui"]["records"] == 5
    f = parts["f_native_io"]
    assert f["parses_equal"] and f["rows"] == 2000
