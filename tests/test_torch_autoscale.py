"""The port's fleet metric plane and autoscaler, held to the JAX
package's ``tests/test_fleet_observability.py`` (its FleetRegistry merge
matrix, beacon transport and snapshot exchange, ``:58-194``; its
forecaster, autoscaler hysteresis and lint-visibility cases,
``:452-760``) case by case: same names, same scripted snapshots and
injected times, the same assertions.  The pure-host cases run in BOTH
packages with the results compared (``torch_plane_util.both``: equal,
floats within 1e-12 relative).  The span, trace-store and profiler cases
of that file are held by ``test_torch_telemetry.py``.

Beyond the reference's cases: a seeded pressure trace through both
packages' autoscalers over one fake fleet each (the same decisions pass
for pass), ``exchange_snapshots`` across two gloo processes, and — on
the card — ``add_replica`` / ``remove_replica`` through the autoscaler
on ``cuda``."""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_plane_util import both, plane  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "deeplearning4j_torch"


# ---------------------------------------------------------------------------
# FleetRegistry merge-semantics matrix
# ---------------------------------------------------------------------------
def _worker_registry(P, counter=0, gauge=None, samples=()):
    r = P.registry.MetricsRegistry()
    if counter:
        r.counter("reqs_total", labelnames=("tenant",)).labels(
            tenant="x").inc(counter)
    if gauge is not None:
        r.gauge("depth").set(gauge)
    h = r.histogram("lat", buckets=(0.1, 0.5, 1.0))
    for v in samples:
        h.observe(v)
    return r


def test_counter_delta_merge_is_idempotent_and_monotonic():
    def run(P):
        w = _worker_registry(P, counter=5)
        fr = P.fleet.FleetRegistry(stale_after_s=60)
        fr.ingest("a", w.snapshot(), now=0.0)
        fr.ingest("a", w.snapshot(), now=1.0)
        b1 = fr.view(now=1.0).render_prometheus()
        w.get("reqs_total").labels(tenant="x").inc(3)
        fr.ingest("a", w.snapshot(), now=2.0)
        b2 = fr.view(now=2.0).render_prometheus()
        return ('reqs_total{tenant="x",host="a"} 5.0' in b1,
                'reqs_total{tenant="x",host="a"} 8.0' in b2,
                'reqs_total{tenant="x",host="fleet"} 8.0' in b2)

    assert both(run) == (True, True, True)


def test_counter_reset_detected_as_fresh_epoch():
    def run(P):
        fr = P.fleet.FleetRegistry(stale_after_s=60)
        fr.ingest("a", _worker_registry(P, counter=7).snapshot(), now=0.0)
        fr.ingest("a", _worker_registry(P, counter=2).snapshot(), now=1.0)
        view = fr.view(now=1.0)
        return (view.get("reqs_total").labels(tenant="x", host="a").value,
                view.get("fleet_counter_resets_total").labels(
                    host="a").value >= 1,
                fr.hosts(now=1.0)["a"]["resets"] >= 1)

    assert both(run) == (9, True, True)


def test_histogram_reset_keeps_count_sum_consistent():
    def run(P):
        fr = P.fleet.FleetRegistry(stale_after_s=60)
        fr.ingest("a", _worker_registry(
            P, samples=(0.05, 0.3, 2.0)).snapshot(), now=0.0)
        fr.ingest("a", _worker_registry(P, samples=(0.05,)).snapshot(),
                  now=1.0)
        return fr.view(now=1.0).get("lat").labels(host="a").state()

    uppers, counts, total, count = both(run)
    assert count == 4 and sum(counts) == count
    assert total == pytest.approx(0.05 + 0.3 + 2.0 + 0.05)


def test_gauge_last_write_wins_and_staleness_marks():
    def run(P):
        fr = P.fleet.FleetRegistry(stale_after_s=5.0)
        fr.ingest("a", _worker_registry(P, gauge=3).snapshot(), now=0.0)
        fr.ingest("a", _worker_registry(P, gauge=7).snapshot(), now=1.0)
        fr.ingest("b", _worker_registry(P, gauge=2).snapshot(), now=4.0)
        v1 = fr.view(now=4.5)
        d = v1.get("depth")
        live = (d.labels(host="a").value, d.labels(host="fleet").value,
                d.labels(host="fleet_max").value)
        v2 = fr.view(now=8.0)
        d = v2.get("depth")
        up = v2.get("fleet_host_up")
        return live, (up.labels(host="a").value, up.labels(host="b").value,
                      d.labels(host="fleet").value,
                      d.labels(host="a").value,
                      v2.get("fleet_hosts_stale").value)

    assert both(run) == ((7, 9, 7), (0, 1, 2, 7, 1))


def test_histogram_bucket_merge_equals_pooled_samples():
    rng = np.random.default_rng(0)
    buckets = tuple((i + 1) / 10 for i in range(10))
    sa = rng.uniform(0, 1, 200)
    sb = rng.uniform(0, 1, 300)

    def run(P):
        fr = P.fleet.FleetRegistry(stale_after_s=60)
        for host, samples in (("a", sa), ("b", sb)):
            r = P.registry.MetricsRegistry()
            h = r.histogram("lat", buckets=buckets)
            for v in samples:
                h.observe(float(v))
            fr.ingest(host, r.snapshot(), now=0.0)
        pooled = P.registry.MetricsRegistry().histogram("lat",
                                                        buckets=buckets)
        for v in np.concatenate([sa, sb]):
            pooled.observe(float(v))
        merged = fr.view(now=0.0).get("lat").labels(host="fleet")
        return ([merged.percentile(q) for q in (0.5, 0.9, 0.95, 0.99)],
                [pooled.percentile(q) for q in (0.5, 0.9, 0.95, 0.99)],
                merged.state()[3])

    merged, pooled, n = both(run)
    assert merged == pytest.approx(pooled) and n == 500


def test_beacon_file_transport_roundtrip(tmp_path):
    def run(P):
        d = tmp_path / P.pkg
        r = _worker_registry(P, counter=4, gauge=1, samples=(0.2,))
        P.telemetry.publish_beacon(d, "hostA", registry=r)
        with P.telemetry.MetricsBeacon(d, host="hostB", registry=r,
                                       interval_s=0.05):
            time.sleep(0.15)
        fr = P.fleet.FleetRegistry(d, stale_after_s=60)
        hosts = sorted(fr.refresh())
        body = fr.render_prometheus()
        return (hosts, 'reqs_total{tenant="x",host="hostA"} 4.0' in body,
                'reqs_total{tenant="x",host="fleet"} 8.0' in body,
                'fleet_beacon_publishes_total{host="hostB"}' in body,
                r.get("fleet_beacon_publishes_total").value >= 2)

    assert both(run) == (["hostA", "hostB"], True, True, True, True)


def test_label_schema_conflict_drops_series_not_scrape():
    def run(P):
        a = P.registry.MetricsRegistry()
        a.counter("odd_total", labelnames=("x",)).labels(x="1").inc()
        a.counter("fine_total").inc(2)
        b = P.registry.MetricsRegistry()
        b.counter("odd_total", labelnames=("y",)).labels(y="2").inc()
        b.counter("fine_total").inc(3)
        fr = P.fleet.FleetRegistry(stale_after_s=60)
        fr.ingest("a", a.snapshot(), now=0.0)
        fr.ingest("b", b.snapshot(), now=0.0)
        view = fr.view(now=0.0)
        return (view.get("fine_total").labels(host="fleet").value,
                view.get("fleet_aggregate_conflicts_total").value >= 1)

    assert both(run) == (5, True)


def test_exchange_snapshots_single_process_degenerate():
    def run(P):
        r = _worker_registry(P, counter=1)
        out = P.fleet.exchange_snapshots(registry=r, host="me")
        return list(out), out["me"]["counters"]['reqs_total{tenant="x"}']

    assert both(run) == (["me"], 1)


EXCHANGE = r'''
import sys
import torch.distributed as dist
from deeplearning4j_torch.telemetry import MetricsRegistry
from deeplearning4j_torch.telemetry.fleet import (FleetRegistry,
                                                  exchange_snapshots)
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
r = MetricsRegistry()
r.counter("reqs_total", labelnames=("tenant",)).labels(
    tenant="x").inc(3 + rank)
out = exchange_snapshots(registry=r, host=f"host{rank:03d}")
fr = FleetRegistry(stale_after_s=60)
for host, snap in sorted(out.items()):
    fr.ingest(host, snap, now=0.0)
v = fr.view(now=0.0).get("reqs_total")
print(sorted(out), v.labels(tenant="x", host="fleet").value)
dist.destroy_process_group()
'''


def test_exchange_snapshots_across_two_gloo_processes():
    """Two processes of one ``torch.distributed`` group (gloo on the
    CPU): each contributes its snapshot and both receive the fleet's."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", EXCHANGE, str(rank), str(port)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert out.strip().splitlines()[-1] == \
            "['host000', 'host001'] 7.0"


# ---------------------------------------------------------------------------
# predictive autoscaling: forecast math + pre-warm ordering
# ---------------------------------------------------------------------------
def test_forecast_math_on_synthetic_ramp():
    def run(P):
        A = P.autoscale
        ramp = [(float(t), 2.0 * t) for t in range(6)]
        return (A.fit_trend(ramp), A.predict_breach_s(ramp, 20.0),
                A.predict_breach_s([(t, 5.0) for t in range(5)], 20.0),
                A.predict_breach_s([(t, 20.0 - t) for t in range(5)], 20.0),
                A.predict_breach_s(ramp, 9.0), A.fit_trend([(1.0, 3.0)]))

    fit, breach, flat, shrink, over, thin = both(run)
    assert fit[0] == pytest.approx(2.0) and fit[1] == pytest.approx(10.0)
    assert breach == pytest.approx(5.0)
    assert flat is None and shrink is None and over == 0.0 and thin is None


def test_forecaster_window_prunes_and_publishes():
    def run(P):
        fc = P.autoscale.BacklogForecaster(window_s=4.0, min_points=3)
        for t in range(10):
            fc.observe(float(t), 2.0 * t)
        fc2 = P.autoscale.BacklogForecaster(window_s=10.0, min_points=5)
        fc2.observe(0.0, 1.0)
        return fc.breach_s(28.0), fc.points(), fc2.breach_s(10.0)

    b, pts, thin = both(run)
    assert b == pytest.approx(5.0) and thin is None
    assert [t for t, _v in pts] == [5.0, 6.0, 7.0, 8.0, 9.0]


class _FakeFleet:
    def __init__(self, reg, n=1):
        self.n_replicas = n
        self.reg = reg
        self.adds = []
        self.removes = []
        self.demotes = []
        self._sync()

    def _sync(self):
        live = self.n_replicas - len(self.removes)
        self.reg.gauge("fleet_replicas_healthy").set(live)

    def add_replica(self):
        idx = self.n_replicas
        self.n_replicas += 1
        self.adds.append(idx)
        self._sync()
        return idx

    def remove_replica(self, idx, timeout=30.0):
        self.removes.append(idx)
        self._sync()

    def demote_waiting(self, tenants, priority=None, cancel=False):
        self.demotes.append((tuple(tenants), priority, cancel))
        return 1

    def stats(self):
        live = [i for i in range(self.n_replicas)
                if i not in self.removes]
        return {"replicas": [{"dead": False, "removed": i in
                              self.removes}
                             for i in range(self.n_replicas)],
                "healthy_replicas": len(live)}


def test_predictive_prewarm_fires_before_reactive_signal():
    def run(P):
        A = P.autoscale
        reg = P.registry.MetricsRegistry()
        fleet = _FakeFleet(reg)
        pol = A.AutoscalePolicy(min_replicas=1, max_replicas=2,
                                queue_wait_p99_target_s=1e9,
                                queue_depth_high=100,
                                forecast_horizon_s=30.0,
                                forecast_window_s=60.0,
                                forecast_min_points=3,
                                up_consecutive=2, cooldown_s=0.0)
        sc = A.Autoscaler(fleet, pol, source=reg)
        prewarm = P.telemetry.get_registry().counter(
            "fleet_autoscale_prewarms_total")
        pw0 = prewarm.value
        acts = []
        for i in range(6):
            reg.gauge("fleet_queue_depth").set(5.0 * i)
            acts.append(sc.evaluate(now=100.0 + i))
        fc = P.telemetry.get_registry().get("fleet_autoscale_forecast")
        return (acts, fleet.adds, prewarm.value - pw0,
                fc.labels(signal="slope").value,
                fc.labels(signal="breach_s").value)

    acts, adds, pw, slope, breach = both(run)
    assert "up" in acts and adds == [1] and pw == 1
    assert slope == pytest.approx(5.0, rel=0.2) and breach >= 0


def test_forecast_respects_hysteresis_no_single_eval_flap():
    def run(P):
        A = P.autoscale
        reg = P.registry.MetricsRegistry()
        fleet = _FakeFleet(reg)
        pol = A.AutoscalePolicy(min_replicas=1, max_replicas=2,
                                queue_wait_p99_target_s=1e9,
                                queue_depth_high=100,
                                forecast_horizon_s=30.0,
                                forecast_min_points=3,
                                up_consecutive=3, cooldown_s=0.0)
        sc = A.Autoscaler(fleet, pol, source=reg)
        acts = []
        for i in range(4):
            reg.gauge("fleet_queue_depth").set(10.0 * i)
            acts.append(sc.evaluate(now=100.0 + i))
        adds = list(fleet.adds)
        reg.gauge("fleet_queue_depth").set(40.0)
        acts.append(sc.evaluate(now=104.0))
        return acts, adds

    acts, adds = both(run)
    assert acts == ["hold"] * 4 + ["up"] and adds == []


def test_forecast_requires_depth_ceiling():
    def run(P):
        with pytest.raises(ValueError):
            P.autoscale.AutoscalePolicy(forecast_horizon_s=5.0)
        return True

    assert both(run)


# ---------------------------------------------------------------------------
# Autoscaler hysteresis (fake fleet, isolated registry)
# ---------------------------------------------------------------------------
def _pressured(reg, wait_s):
    h = reg.histogram("fleet_queue_wait_seconds", labelnames=("tenant",))
    for _ in range(4):
        h.labels(tenant="inter").observe(wait_s)


def _scaler(P, reg, fleet, **pol):
    defaults = dict(min_replicas=1, max_replicas=2,
                    queue_wait_p99_target_s=0.1,
                    up_consecutive=2, down_consecutive=3,
                    cooldown_s=10.0)
    defaults.update(pol)
    return P.autoscale.Autoscaler(
        fleet, P.autoscale.AutoscalePolicy(**defaults), source=reg,
        tenant_classes={"batch": "batch"})


def _setup(P, n=1):
    reg = P.registry.MetricsRegistry()
    reg.gauge("fleet_queue_depth").set(0)
    return reg, _FakeFleet(reg, n=n)


def test_flapping_load_does_not_flap_replicas():
    def run(P):
        reg, fleet = _setup(P)
        sc = _scaler(P, reg, fleet)
        acts = []
        for i in range(12):
            if i % 2 == 0:
                _pressured(reg, 0.5)
            acts.append(sc.evaluate(now=100.0 + i))
        return acts, fleet.adds, fleet.removes

    acts, adds, removes = both(run)
    assert acts == ["hold"] * 12 and adds == [] and removes == []


def test_sustained_pressure_scales_up_once_then_cooldown():
    def run(P):
        reg, fleet = _setup(P)
        sc = _scaler(P, reg, fleet, cooldown_s=10.0)
        acts = []
        for i in range(6):
            _pressured(reg, 0.5)
            acts.append(sc.evaluate(now=100.0 + i))
        return acts, fleet.adds, sc.target

    acts, adds, target = both(run)
    assert acts.count("up") == 1 and adds == [1] and target == 2


def test_idle_scales_down_to_min_and_stops():
    def run(P):
        reg, fleet = _setup(P)
        sc = _scaler(P, reg, fleet, cooldown_s=1.0)
        t = 100.0
        acts = []
        for i in range(3):
            _pressured(reg, 0.5)
            acts.append(sc.evaluate(now=t + i))
        t += 20.0
        idle = [sc.evaluate(now=t + i) for i in range(10)]
        floor = [sc.evaluate(now=t + 20 + i) for i in range(6)]
        return acts, idle, floor, fleet.removes, sc.target

    acts, idle, floor, removes, target = both(run)
    assert acts == ["hold", "hold", "up"]
    assert idle.count("down") == 1 and removes == [1] and target == 1
    assert "down" not in floor


def test_overflow_bucket_waits_still_count_as_pressure():
    def run(P):
        reg, fleet = _setup(P)
        sc = _scaler(P, reg, fleet, cooldown_s=0.0)
        h = reg.histogram("fleet_queue_wait_seconds",
                          labelnames=("tenant",))
        for i in range(3):
            for _ in range(4):
                h.labels(tenant="inter").observe(60.0)
            if sc.evaluate(now=100.0 + i) == "up":
                break
        return fleet.adds

    assert both(run) == [1]


def test_pressure_at_max_defers_then_sheds_batch():
    def run(P):
        reg, fleet = _setup(P, n=2)
        sc = _scaler(P, reg, fleet, max_replicas=2, cooldown_s=1.0)
        sc._target = 2
        seen = []
        for i in range(8):
            _pressured(reg, 0.5)
            seen.append(sc.evaluate(now=100.0 + 2.0 * i))
        return seen, fleet.adds, [(d[0], d[2]) for d in fleet.demotes]

    seen, adds, kinds = both(run)
    assert "defer" in seen and "shed" in seen
    assert seen.index("defer") < seen.index("shed") and adds == []
    assert (("batch",), False) in kinds and (("batch",), True) in kinds


def test_scale_down_waits_for_healthy_target():
    def run(P):
        reg, fleet = _setup(P, n=2)
        sc = _scaler(P, reg, fleet, cooldown_s=0.0)
        sc._target = 2
        reg.gauge("fleet_replicas_healthy").set(1)
        held = [sc.evaluate(now=100.0 + i) for i in range(6)]
        reg.gauge("fleet_replicas_healthy").set(2)
        return held, [sc.evaluate(now=110.0 + i) for i in range(4)]

    held, acts = both(run)
    assert held == ["hold"] * 6 and "down" in acts


def test_seeded_pressure_trace_decisions_equal_in_both_packages():
    """A numpy-seeded trace — interactive and batch queue waits, replica
    queue phases, EDF slack, queue depth, free and evictable KV blocks,
    healthy replicas, a beaconed alert gauge; a busy half then a quiet
    one — through both packages' autoscalers (forecast on, every signal armed) over one fake fleet
    each: the same action, target, pressure and forecast every pass."""
    rng = np.random.default_rng(17)
    n = 160
    waits = rng.exponential(0.2, (n, 3)) * (1 + 8 * (rng.random(n) < 0.3)
                                            )[:, None]
    slack = rng.normal(1.0, 0.6, (n, 3))
    depth = np.maximum(0, np.cumsum(rng.normal(0.0, 4.0, n))).round()
    free = rng.integers(0, 40, n)
    evict = rng.integers(0, 10, n)
    alert = rng.random(n) < 0.05
    quiet = np.arange(n) >= n // 2           # the second half idles
    waits[quiet] *= 0.01
    slack[quiet] = 5.0
    depth[quiet] = 0
    free[quiet] = 100
    alert[quiet] = False

    def run(P):
        A = P.autoscale
        reg = P.registry.MetricsRegistry()
        fleet = _FakeFleet(reg)
        pol = A.AutoscalePolicy(
            min_replicas=1, max_replicas=3, queue_wait_p99_target_s=0.6,
            edf_slack_p10_floor_s=0.1, queue_depth_high=60,
            free_blocks_floor=8, up_consecutive=2, down_consecutive=4,
            cooldown_s=3.0, forecast_horizon_s=10.0, forecast_window_s=8.0,
            forecast_min_points=3)
        sc = A.Autoscaler(fleet, pol, source=reg,
                          tenant_classes={"bulk": "batch",
                                          "chat": "interactive"})
        qw = reg.histogram("fleet_queue_wait_seconds",
                           labelnames=("tenant",))
        ph = reg.histogram("fleet_request_phase_seconds",
                           labelnames=("phase",))
        sl = reg.histogram("fleet_edf_slack_seconds",
                           labelnames=("tenant",))
        firing = reg.gauge("fleet_slo_alert_firing", labelnames=("slo",))
        fc = P.telemetry.get_registry().get("fleet_autoscale_forecast")
        rows = []
        for i in range(n):
            qw.labels(tenant="chat").observe(float(waits[i, 0]))
            qw.labels(tenant="bulk").observe(float(waits[i, 1]) * 3)
            ph.labels(phase="queue").observe(float(waits[i, 2]))
            for v in slack[i]:
                sl.labels(tenant="chat").observe(float(v))
            reg.gauge("fleet_queue_depth").set(float(depth[i]))
            reg.gauge("kv_pool_blocks_free").set(float(free[i]))
            reg.gauge("kv_pool_blocks_evictable").set(float(evict[i]))
            firing.labels(slo="x").set(1.0 if alert[i] else 0.0)
            act = sc.evaluate(now=1000.0 + 0.5 * i)
            rows.append((act, sc.target, tuple(fleet.adds),
                         tuple(fleet.removes),
                         fc.labels(signal="slope").value))
        return rows, fleet.demotes

    rows, demotes = both(run)
    acts = {r[0] for r in rows}
    assert "up" in acts and "down" in acts and "hold" in acts


# ---------------------------------------------------------------------------
# the reference's concurrency and lock-order rules over the port's
# threaded control-plane modules (the reference's analysis, run as
# tooling; nothing of it is edited)
# ---------------------------------------------------------------------------
def _port_index(subdir):
    from deeplearning4j_tpu.analysis import package_index
    pkg = os.path.join(REPO, "deeplearning4j_torch", subdir)
    index, _pf, _stats = package_index.build_index(pkg, root=REPO)
    return index


def test_conc_rules_see_telemetry_fleet():
    pytest.importorskip("jax")
    from deeplearning4j_tpu.analysis import concurrency_lint
    index = _port_index("telemetry")
    mods = [m for m, s in index.modules.items()
            if s["path"].endswith("telemetry/fleet.py")]
    assert mods, "the port's telemetry/fleet.py is missing from the index"
    seeds = index.thread_seeds()
    assert any("MetricsBeacon" in s for s in seeds), seeds
    parent = index.closure(seeds)
    assert any("MetricsBeacon._publish_loop" in fid for fid in parent)
    assert any("MetricsBeacon.publish" in fid for fid in parent)
    facts = index.class_facts(mods[0], "FleetRegistry")
    assert "_lock" in facts["lock_attrs"] and "_hosts" in facts["guarded"]
    findings = [f for f in concurrency_lint.lint_package(index)
                if f.path.endswith("telemetry/fleet.py")]
    assert findings == [], [f.render() for f in findings]


@pytest.mark.parametrize("subdir", ["telemetry", "serving", "analysis"])
def test_conc_rules_find_nothing_in_the_control_plane(subdir):
    """Every thread-owning class of the port's plane is seen by the
    rules (the recorder, the alert loop, the ladder, the autoscaler, the
    scrape server) and the whole package directory lints clean —
    including the two findings the reference baselines in its own
    registry and scrape server, repaired in the port."""
    pytest.importorskip("jax")
    from deeplearning4j_tpu.analysis import concurrency_lint
    index = _port_index(subdir)
    owners = {"telemetry": (("telemetry/tsdb.py", "TimeSeriesStore"),
                            ("telemetry/slo.py", "AlertEngine"),
                            ("telemetry/exposition.py", "MetricsServer"),
                            ("telemetry/profiling.py", "DeviceProfiler")),
              "serving": (("serving/degrade.py", "DegradeLadder"),
                          ("serving/autoscale.py", "Autoscaler")),
              "analysis": ()}[subdir]
    for fname, cls in owners:
        mods = [m for m, s in index.modules.items()
                if s["path"].endswith(fname)]
        assert mods, f"{fname} missing from the index"
        assert "_lock" in index.class_facts(mods[0], cls)["lock_attrs"], cls
    findings = concurrency_lint.lint_package(index)
    assert findings == [], [f.render() for f in findings]


# ---------------------------------------------------------------------------
# on the card: the autoscaler builds and retires a replica on cuda
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_autoscaler_adds_and_removes_a_replica_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    P = plane(PORT)
    from deeplearning4j_torch.zoo import Gpt
    net = Gpt(vocab_size=50, max_len=32, d_model=32, n_layers=2,
              n_heads=4, d_ff=64, seq_len=8, compute_dtype=None,
              seed=3).init_graph(device="cuda")

    class _Alert:
        firing = True

        def evaluate(self, reg, now=None):
            return []

        def any_firing(self):
            return self.firing

        def exhausted_tenants(self):
            return frozenset()

    alert = _Alert()
    p = np.arange(1, 9, dtype=np.int32)
    with P.serving.ServingFleet(net, n_replicas=1, n_slots=2, max_len=32,
                                block_size=4, tick_batch=1) as fleet:
        sc = P.autoscale.Autoscaler(fleet, P.autoscale.AutoscalePolicy(
            min_replicas=1, max_replicas=2, queue_wait_p99_target_s=1e9,
            up_consecutive=1, down_consecutive=2, cooldown_s=0.0),
            alert_engine=alert)
        assert sc.evaluate(now=0.0) == "up"
        new = fleet.replica(1)
        assert new.device.type == "cuda" and new._kc.is_cuda
        deadline = time.monotonic() + 60
        while fleet.stats()["healthy_replicas"] < 2:
            assert time.monotonic() < deadline, fleet.stats()
            time.sleep(0.01)
        outs = [fleet.submit(p, 6, timeout=120) for _ in range(4)]
        assert all(o.shape == (14,) for o in outs)
        alert.firing = False
        acts = [sc.evaluate(now=1.0 + i) for i in range(4)]
        assert acts.count("down") == 1
        assert fleet.stats()["replicas"][1]["removed"]
        assert fleet.submit(p, 6, timeout=120).shape == (14,)
