"""The port's SLO error-budget engine, burn-rate alerting, flight-recorder
ring, trace-store retention and exposition, held to the JAX package's
``tests/test_slo.py`` case by case (same names, same scripted registry
values at the same injected times, the same assertions), each pure-host
case run in BOTH packages with the results compared
(``torch_plane_util.both``: equal, floats within 1e-12 relative).

Beyond the reference's cases: a numpy-seeded traffic history through
both engines (alerts, projections, admission decisions and state at
every step), and the series names a drive of the whole plane registers
in each package, in fresh interpreters.  The fleet case runs the port's
``ServingFleet`` on the tiny Gpt (its reference runs the JAX fleet).
The reference's SIGKILL case (``@slow`` there, a JAX worker) has no port
here: the port's black-box salvage is held by
``test_torch_telemetry.py``."""
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_plane_util import both, plane, port_only  # noqa: E402
from torch_serving_util import TINY, tiny_net  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_postmortem():
    path = os.path.join(REPO, "scripts", "postmortem.py")
    spec = importlib.util.spec_from_file_location("postmortem", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _avail_engine(P, windows, target=0.9, window_s=100.0, tenant=None,
                  **kw):
    src = P.registry.MetricsRegistry()
    src.counter("fleet_requests_total", labelnames=("tenant", "outcome"))
    spec = P.slo.SLOSpec("t-avail", objective="availability",
                         target=target, tenant=tenant, window_s=window_s,
                         windows=windows, **kw)
    return P.slo.AlertEngine([spec], source=src,
                             registry=P.registry.MetricsRegistry()), src


def _feed(src, good=0.0, bad=0.0, tenant="a"):
    fam = src.counter("fleet_requests_total",
                      labelnames=("tenant", "outcome"))
    if good:
        fam.labels(tenant=tenant, outcome="admitted").inc(good)
    if bad:
        fam.labels(tenant=tenant, outcome="failed").inc(bad)


# ---------------------------------------------------------------------------
# burn-rate + budget math, pinned by hand
# ---------------------------------------------------------------------------
def test_burn_rate_math_pinned():
    r = both(lambda P: [P.slo.burn_rate(*a) for a in (
        (99, 1, 0.01), (80, 20, 0.1), (0, 10, 0.1), (10, 0, 0.1),
        (0, 0, 0.1))])
    assert r[:3] == [pytest.approx(1.0), pytest.approx(2.0),
                     pytest.approx(10.0)]
    assert r[3:] == [0.0, 0.0]


def test_windowed_burn_hand_computed():
    def run(P):
        eng, src = _avail_engine(P, [(10.0, 30.0, 100.0, "page")])
        eng.evaluate(now=0.0)
        _feed(src, good=90, bad=10)
        a1 = eng.evaluate(now=10.0)[0]
        _feed(src, good=100, bad=0)
        a2 = eng.evaluate(now=20.0)[0]
        return [a1["burns"], a2["burns"]]

    b1, b2 = both(run)
    assert b1["10s"] == pytest.approx(1.0)
    assert b1["30s"] == pytest.approx(1.0)
    assert b2["10s"] == 0.0
    assert b2["30s"] == pytest.approx((10 / 200) / 0.1)


def test_budget_accounting_matrix():
    def run(P):
        out = []
        for good, bad in [(90, 10), (80, 20), (100, 0), (95, 5)]:
            eng, src = _avail_engine(P, [(10.0, 30.0, 1e9, "page")],
                                     tenant="a")
            eng.evaluate(now=0.0)
            _feed(src, good=good, bad=bad)
            a = eng.evaluate(now=100.0)[0]
            out.append((a["budget_remaining"], a["exhausted"]))
        eng, src = _avail_engine(P, [(10.0, 30.0, 1e9, "page")],
                                 tenant="a")
        eng.evaluate(now=0.0)
        _feed(src, good=90, bad=10)
        a = eng.evaluate(now=50.0)[0]
        out.append((a["budget_remaining"], a["exhausted"]))
        eng, src = _avail_engine(P, [(10.0, 30.0, 1e9, "page")],
                                 tenant="a")
        eng.evaluate(now=0.0)
        _feed(src, good=0, bad=10, tenant="a")
        eng.evaluate(now=100.0)
        return out, sorted(eng.exhausted_tenants())

    rows, exhausted = both(run)
    for (rem, exh), want in zip(rows, (0.0, -1.0, 1.0, 0.5)):
        assert rem == pytest.approx(want) and exh == (want <= 0.0)
    assert rows[4][0] == pytest.approx(0.5) and not rows[4][1]
    assert exhausted == ["a"]


def test_tenant_filter_reads_only_that_tenant():
    def run(P):
        eng, src = _avail_engine(P, [(10.0, 30.0, 2.0, "page")],
                                 tenant="a")
        eng.evaluate(now=0.0)
        _feed(src, good=100, bad=0, tenant="a")
        _feed(src, good=0, bad=50, tenant="b")
        return eng.evaluate(now=10.0)[0]["burns"]["10s"]

    assert both(run) == 0.0


def test_latency_objective_bucket_math():
    def run(P):
        src = P.registry.MetricsRegistry()
        h = src.histogram("fleet_request_phase_seconds",
                          labelnames=("phase",))
        spec = P.slo.SLOSpec("t-lat", objective="latency", target=0.9,
                             phase="queue", threshold_s=0.1,
                             window_s=100.0,
                             windows=[(10.0, 10.0, 1.5, "page")])
        eng = P.slo.AlertEngine([spec], source=src,
                                registry=P.registry.MetricsRegistry())
        eng.evaluate(now=0.0)
        for _ in range(8):
            h.labels(phase="queue").observe(0.05)
        for _ in range(2):
            h.labels(phase="queue").observe(0.3)
        h.labels(phase="decode").observe(9.0)
        a = eng.evaluate(now=10.0)[0]
        return a["burns"]["10s"], a["state"]

    burn, state = both(run)
    assert burn == pytest.approx((2 / 10) / 0.1)
    assert state == "firing"


def test_ttft_objective_reads_the_server_histogram():
    """The ``ttft`` objective reads ``generation_server_ttft_seconds``
    (the chip phase's SLO): observations at or under the bar are good."""
    def run(P):
        src = P.registry.MetricsRegistry()
        h = src.histogram("generation_server_ttft_seconds")
        spec = P.slo.SLOSpec("t-ttft", objective="ttft", target=0.99,
                             threshold_s=0.1, window_s=60.0,
                             windows=[(2.0, 4.0, 14.4, "page")],
                             for_s=0.5, clear_for_s=1.0)
        eng = P.slo.AlertEngine([spec], source=src,
                                registry=P.registry.MetricsRegistry())
        states = [eng.evaluate(now=0.0)[0]["state"]]
        for t in (1.0, 2.0, 3.0, 4.0, 4.25, 4.5, 5.0):
            h.observe(0.05)
            h.observe(0.8)
            states.append(eng.evaluate(now=t)[0]["state"])
        for t in (6.0, 8.0, 10.0, 11.0, 12.0):
            states.append(eng.evaluate(now=t)[0]["state"])
        return states, eng.alerts()[0]

    states, alert = both(run)
    assert "pending" in states and "firing" in states
    assert states.index("pending") < states.index("firing")
    assert states[-1] == "resolved"
    assert alert["transitions"] == {"pending": 1, "firing": 1,
                                    "resolved": 1}


def test_reset_detection_reprimes_instead_of_negative_burn():
    def run(P):
        eng, src = _avail_engine(P, [(10.0, 10.0, 1.5, "page")])
        eng.evaluate(now=0.0)
        _feed(src, good=50, bad=50)
        s = eng.evaluate(now=10.0)[0]["state"]
        eng.source = fresh = P.registry.MetricsRegistry()
        _feed(fresh, good=10, bad=0)
        b1 = eng.evaluate(now=20.0)[0]["burns"]["10s"]
        b2 = eng.evaluate(now=30.0)[0]["burns"]["10s"]
        return s, b1, b2

    assert both(run) == ("firing", 0.0, 0.0)


# ---------------------------------------------------------------------------
# alert state machine
# ---------------------------------------------------------------------------
def test_alert_fires_after_for_s_and_resolves_after_clear():
    def run(P):
        eng, src = _avail_engine(P, [(10.0, 20.0, 1.5, "page")],
                                 for_s=5.0, clear_for_s=5.0)
        eng.evaluate(now=0.0)
        _feed(src, good=0, bad=10)
        out = [eng.evaluate(now=t)[0] for t in (20.0, 22.0, 25.0)]
        _feed(src, good=500, bad=0)
        out += [eng.evaluate(now=t)[0] for t in (51.0, 57.0)]
        return out

    a = both(run)
    assert [x["state"] for x in a] == ["pending", "pending", "firing",
                                       "firing", "resolved"]
    assert a[2]["t_fired"] == 25.0
    assert a[-1]["transitions"] == {"pending": 1, "firing": 1,
                                    "resolved": 1}


def test_pending_blip_goes_back_inactive_without_resolved():
    def run(P):
        eng, src = _avail_engine(P, [(5.0, 10.0, 1.5, "page")],
                                 for_s=20.0)
        eng.evaluate(now=0.0)
        _feed(src, good=0, bad=5)
        s = eng.evaluate(now=10.0)[0]["state"]
        _feed(src, good=500, bad=0)
        return s, eng.evaluate(now=22.0)[0]

    s, a = both(run)
    assert s == "pending" and a["state"] == "inactive"
    assert "resolved" not in a["transitions"]


def test_flapping_load_does_not_flap_alert():
    def run(P):
        eng, src = _avail_engine(P, [(10.0, 40.0, 3.0, "page")])
        eng.evaluate(now=0.0)
        t, rows = 0.0, []
        for _cycle in range(5):
            _feed(src, good=10, bad=10)
            rows.append(eng.evaluate(now=t + 10.0)[0])
            for i in (20.0, 30.0, 40.0):
                _feed(src, good=20, bad=0)
                rows.append(eng.evaluate(now=t + i)[0])
            t += 40.0
        return rows

    rows = both(run)
    assert all(a["state"] == "inactive" for a in rows)
    bursts = rows[::4]
    assert all(a["burns"]["10s"] == pytest.approx(5.0) for a in bursts)
    assert all(a["burns"]["40s"] < 3.0 for a in bursts[1:])
    assert rows[-1]["transitions"] == {}


def test_spec_validation():
    def run(P):
        S, E, R = P.slo.SLOSpec, P.slo.AlertEngine, P.registry
        for kw in ({"target": 1.0}, {"objective": "latency"},
                   {"windows": [(10.0, 5.0, 2.0, "page")]},
                   {"objective": "nope"}):
            with pytest.raises(ValueError):
                S("x", **kw)
        with pytest.raises(ValueError):
            E([], registry=R.MetricsRegistry())
        s = S("dup")
        with pytest.raises(ValueError):
            E([s, s], registry=R.MetricsRegistry())
        spec = S("d", window_s=30 * 86400.0)
        return spec.windows

    w = both(run)
    assert w[0][:2] == (300.0, 3600.0)
    assert w[1][:2] == (1800.0, 21600.0)


def test_seeded_traffic_alerts_and_admission_equal_in_both_packages():
    """Seeded good/bad traffic for two tenants at seeded instants through
    both packages' engines (an availability spec per tenant, a latency
    spec, a ttft spec; two burn-window pairs; for_s/clear_for_s): every
    evaluation's alerts, then projection, admission decisions for three
    tenants, exhausted tenants and the full state — equal step by step."""
    rng = np.random.default_rng(15)
    n = 120
    times = np.cumsum(rng.uniform(0.5, 4.0, n))
    good = rng.integers(0, 30, (n, 2))
    burst = rng.random(n) < 0.25
    bad = np.where(burst[:, None], rng.integers(5, 40, (n, 2)),
                   rng.integers(0, 2, (n, 2)))
    waits = rng.exponential(0.2, (n, 6))

    def run(P):
        src = P.registry.MetricsRegistry()
        fam = src.counter("fleet_requests_total",
                          labelnames=("tenant", "outcome"))
        ph = src.histogram("fleet_request_phase_seconds",
                           labelnames=("phase",))
        ttft = src.histogram("generation_server_ttft_seconds")
        win = [(5.0, 30.0, 6.0, "page"), (10.0, 60.0, 3.0, "ticket")]
        specs = [P.slo.SLOSpec(f"avail-{t}", target=0.95, tenant=t,
                               window_s=120.0, windows=win, for_s=4.0,
                               clear_for_s=6.0) for t in ("chat", "bulk")]
        specs.append(P.slo.SLOSpec("queue", objective="latency",
                                   target=0.9, phase="queue",
                                   threshold_s=0.25, window_s=120.0,
                                   windows=win))
        specs.append(P.slo.SLOSpec("ttft", objective="ttft", target=0.99,
                                   threshold_s=0.1, window_s=120.0,
                                   windows=win, min_events=3))
        eng = P.slo.AlertEngine(specs, source=src,
                                registry=P.registry.MetricsRegistry())
        steps = []
        for i, t in enumerate(times):
            for j, tenant in enumerate(("chat", "bulk")):
                fam.labels(tenant=tenant, outcome="admitted").inc(
                    float(good[i, j]))
                fam.labels(tenant=tenant, outcome="failed").inc(
                    float(bad[i, j]))
            for w in waits[i]:
                ph.labels(phase="queue").observe(float(w))
                ttft.observe(float(w) * (3.0 if burst[i] else 0.5))
            alerts = eng.evaluate(now=float(t))
            steps.append({
                "alerts": alerts,
                "projection": eng.projection(now=float(t)),
                "admit": [eng.admission_decision(x, now=float(t))
                          for x in ("chat", "bulk", "other")],
                "exhausted": sorted(eng.exhausted_tenants()),
                "firing": eng.any_firing()})
        return {"steps": steps, "state": eng.state()}

    r = both(run)
    decisions = {a["decision"] for s in r["steps"] for a in s["admit"]}
    states = {a["state"] for s in r["steps"] for a in s["alerts"]}
    assert "firing" in states and "resolved" in states
    assert "admit" in decisions and len(decisions) >= 2


# ---------------------------------------------------------------------------
# flight recorder ring
# ---------------------------------------------------------------------------
def test_flight_ring_overflow_keeps_newest_in_order():
    def run(P):
        fr = P.flightrec.FlightRecorder(capacity=8)
        for i in range(20):
            fr.record("k", i=i)
        evs = fr.events()
        return {"i": [e["i"] for e in evs], "seq": [e["seq"] for e in evs],
                "kinds": {e["kind"] for e in evs},
                "last3": [e["i"] for e in fr.events(last=3)],
                "ordered": [e["ts"] for e in evs] == sorted(
                    e["ts"] for e in evs)}

    r = both(run)
    assert r["i"] == list(range(12, 20)) and r["seq"] == list(range(12, 20))
    assert r["kinds"] == {"k"} and r["last3"] == [17, 18, 19]
    assert r["ordered"]


def test_flight_ring_concurrent_append_drops_nothing():
    def run(P):
        fr = P.flightrec.FlightRecorder(capacity=10000)

        def spam(tag):
            for i in range(500):
                fr.record("spam", tag=tag, i=i)

        threads = [threading.Thread(target=spam, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        evs = fr.events()
        return len(evs), len({e["seq"] for e in evs})

    assert both(run) == (2000, 2000)


def test_request_dump_bundle_anatomy(tmp_path):
    def run(P):
        reg = P.registry.MetricsRegistry()
        reg.counter("things_total").inc(3)
        tracer = P.telemetry.SpanTracer()
        sp = tracer.begin("request/decode", trace="r-1", slot=0)
        eng, src = _avail_engine(P, [(10.0, 10.0, 1.5, "page")])
        eng.evaluate(now=0.0)
        _feed(src, good=0, bad=4)
        eng.evaluate(now=10.0)
        fr = P.flightrec.FlightRecorder(capacity=16)
        none = fr.request_dump("nothing installed")
        d = tmp_path / P.pkg
        fr.install_dump(d, host="h0", registry=reg, tracer=tracer,
                        alerts=eng)
        fr.record("admit", slot=0, trace="r-1")
        fr.record("dispatch", replica=1, trace="r-1")
        path = fr.request_dump("unit: anatomy")
        doc = P.flightrec.load_bundle(path)
        sp.end()
        fr.uninstall_dump()
        return {"none": none, "exists": os.path.exists(path),
                "listed": P.flightrec.list_bundles(d) == [path],
                "doc": doc}

    r = both(lambda P: {k: v for k, v in run(P).items() if k != "doc"})
    assert r == {"none": None, "exists": True, "listed": True}
    doc = port_only(run)["doc"]
    assert doc["reason"] == "unit: anatomy"
    assert doc["host"] == "h0" and doc["pid"] == os.getpid()
    assert [e["kind"] for e in doc["events"]] == ["admit", "dispatch"]
    assert doc["metrics"]["counters"]["things_total"] == 3
    assert "request/decode" in {s["name"] for s in doc["open_spans"]}
    assert doc["slo"]["firing"] == ["t-avail"]
    pm = _load_postmortem()
    entries = pm.merge_timeline(doc, None)
    walls = [e["wall"] for e in entries]
    assert walls == sorted(walls)
    txt = pm.render_timeline(entries, doc["reason"])
    assert "admit" in txt and "dispatch" in txt
    assert "request/decode" in txt and "slo:t-avail" in txt


# ---------------------------------------------------------------------------
# trace-store retention
# ---------------------------------------------------------------------------
def _root_event(trace, seq, wall, outcome="ok"):
    return {"name": "request", "ph": "X", "ts": 0.0, "dur": 5.0,
            "pid": 1, "tid": 1, "seq": seq, "wall": wall,
            "args": {"trace": trace, "outcome": outcome}}


def test_trace_store_retired_retention_lru_by_retire_time():
    def run(P):
        store = P.tracing.FleetTraceStore(max_traces=100, max_spans=8,
                                          max_retired=3)
        store.ingest("h", [{"name": "request/decode", "ph": "X",
                            "ts": 0.0, "dur": 1.0, "pid": 1, "tid": 1,
                            "seq": 100 + i, "wall": float(i),
                            "args": {"trace": f"live{i}"}}
                           for i in range(2)])
        for i in range(5):
            store.ingest("h", [_root_event(f"t{i}", seq=i, wall=float(i))])
        ids = sorted(store.trace_ids())
        s = store.summary()
        store.ingest("h", [_root_event("t0", seq=0, wall=9.0)])
        with pytest.raises(ValueError):
            P.tracing.FleetTraceStore(max_traces=10, max_retired=11)
        return ids, s, sorted(store.trace_ids()), store.summary()

    ids, s, ids2, s2 = both(run)
    assert ids == ["live0", "live1", "t2", "t3", "t4"]
    assert s["evicted"] == 2 and s["retired"] == 3
    assert "t2" not in ids2 and s2["evicted"] == 3


def test_trace_store_evicted_counter_on_fleet_view(tmp_path):
    def run(P):
        store = P.tracing.FleetTraceStore(max_traces=100, max_retired=1)
        freg = P.fleet.FleetRegistry(tmp_path / P.pkg, trace_store=store)
        for i in range(3):
            store.ingest("h", [_root_event(f"t{i}", seq=i, wall=float(i))])
        return freg.view().get("fleet_trace_store_evicted_total").value

    assert both(run) == 2.0


# ---------------------------------------------------------------------------
# exposition error discipline + /alerts
# ---------------------------------------------------------------------------
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_endpoints_404_400_and_alerts(tmp_path):
    def run(P):
        d = tmp_path / P.pkg
        wreg = P.registry.MetricsRegistry()
        fam = wreg.counter("fleet_requests_total",
                           labelnames=("tenant", "outcome"))
        fam.labels(tenant="a", outcome="admitted")
        fam.labels(tenant="a", outcome="failed")
        spec = P.slo.SLOSpec("scrape-avail", target=0.9, window_s=600.0,
                             windows=[(0.1, 0.4, 1.5, "page")])
        eng = P.slo.AlertEngine([spec],
                                registry=P.registry.MetricsRegistry())
        freg = P.fleet.FleetRegistry(d, stale_after_s=3600.0, alerts=eng)
        P.telemetry.publish_beacon(d, "w0", registry=wreg)
        out = {}
        with P.telemetry.start_metrics_server(freg, port=0) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            code, body = _get(base + "/metrics")
            out["m0"] = (code, "fleet_slo_burn_rate" in body,
                         'fleet_slo_alert_firing{slo="scrape-avail",'
                         'host="fleet"} 0.0' in body)
            fam.labels(tenant="a", outcome="failed").inc(9)
            fam.labels(tenant="a", outcome="admitted").inc(1)
            P.telemetry.publish_beacon(d, "w0", registry=wreg)
            time.sleep(0.5)
            code, body = _get(base + "/alerts")
            out["alerts"] = (code, json.loads(body)["firing"])
            code, body = _get(base + "/metrics")
            out["m1"] = ('fleet_slo_alert_firing{slo="scrape-avail",'
                         'host="fleet"} 1.0') in body
            code, body = _get(base + "/nope")
            out["404"] = (code, sorted(json.loads(body)["endpoints"]))
            out["400"] = [(_get(base + q)[0], q) for q in (
                "/traces?id=", "/traces?id=a&id=b", "/traces?bogus=1")]
            code, body = _get(base + "/traces?id=ghost")
            out["ghost"] = (code, json.loads(body)["root"])
        return out

    r = both(run)
    assert r["m0"] == (200, True, True)
    assert r["alerts"] == (200, ["scrape-avail"]) and r["m1"]
    assert r["404"] == (404, ["/alerts", "/metrics", "/query", "/traces"])
    assert all(code == 400 for code, _q in r["400"])
    assert r["ghost"] == (200, None)


def test_alerts_endpoint_on_plain_registry():
    def run(P):
        reg = P.registry.MetricsRegistry()
        spec = P.slo.SLOSpec("plain", target=0.9, window_s=600.0,
                             windows=[(0.1, 0.4, 1.5, "page")])
        reg.alerts = P.slo.AlertEngine([spec], registry=reg)
        fam = reg.counter("fleet_requests_total",
                          labelnames=("tenant", "outcome"))
        fam.labels(tenant="a", outcome="failed").inc(5)
        with P.telemetry.start_metrics_server(reg, port=0) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            first = _get(base + "/alerts")[0]
            fam.labels(tenant="a", outcome="failed").inc(5)
            time.sleep(0.5)
            code, body = _get(base + "/alerts")
            c404, b404 = _get(base + "/traces")
        return (first, code, json.loads(body)["firing"], c404,
                json.loads(b404)["endpoints"])

    assert both(run) == (200, 200, ["plain"], 404, ["/metrics", "/alerts"])


# ---------------------------------------------------------------------------
# autoscaler: alert pre-warm + exhausted-first shedding (fake fleet)
# ---------------------------------------------------------------------------
class _FakeFleet:
    def __init__(self, reg, n=1):
        self.n_replicas = n
        self.reg = reg
        self.adds = []
        self.demotes = []
        self.reg.gauge("fleet_replicas_healthy").set(n)

    def add_replica(self):
        idx = self.n_replicas
        self.n_replicas += 1
        self.adds.append(idx)
        self.reg.gauge("fleet_replicas_healthy").set(self.n_replicas)
        return idx

    def remove_replica(self, idx, timeout=30.0):
        pass

    def demote_waiting(self, tenants, priority=None, cancel=False):
        self.demotes.append((tuple(tenants), cancel))
        return 1

    def stats(self):
        return {"replicas": [{"dead": False, "removed": False,
                              "queue_depth": 0}
                             for _ in range(self.n_replicas)],
                "healthy_replicas": self.n_replicas}


def test_autoscaler_alert_prewarm_attributed():
    def run(P):
        A = P.autoscale
        reg = P.registry.MetricsRegistry()
        reg.gauge("fleet_queue_depth").set(0)
        fleet = _FakeFleet(reg)
        reg.counter("fleet_requests_total",
                    labelnames=("tenant", "outcome"))
        spec = P.slo.SLOSpec("as-avail", target=0.9, window_s=100.0,
                             windows=[(10.0, 10.0, 1.5, "page")])
        eng = P.slo.AlertEngine([spec],
                                registry=P.registry.MetricsRegistry())
        sc = A.Autoscaler(fleet, A.AutoscalePolicy(
            min_replicas=1, max_replicas=2, queue_wait_p99_target_s=30.0,
            up_consecutive=3, cooldown_s=0.0), source=reg,
            alert_engine=eng)
        prewarms = P.telemetry.counter(
            "fleet_autoscale_alert_prewarms_total")
        pw0 = prewarms.value
        acts = [sc.evaluate(now=100.0)]
        _feed(reg, good=0, bad=10)
        acts += [sc.evaluate(now=110.0), sc.evaluate(now=120.0)]
        adds, pw1 = list(fleet.adds), prewarms.value - pw0
        reg2 = P.registry.MetricsRegistry()
        reg2.gauge("fleet_queue_depth").set(0)
        fleet2 = _FakeFleet(reg2)
        reg2.gauge("fleet_slo_alert_firing",
                   labelnames=("slo",)).labels(slo="x").set(1.0)
        sc2 = A.Autoscaler(fleet2, A.AutoscalePolicy(
            min_replicas=1, max_replicas=2, queue_wait_p99_target_s=30.0,
            up_consecutive=3, cooldown_s=0.0), source=reg2)
        acts.append(sc2.evaluate(now=100.0))
        return acts, adds, pw1, prewarms.value - pw0

    acts, adds, pw1, pw2 = both(run)
    assert acts == ["hold", "up", "hold", "up"]
    assert adds == [1] and pw1 == 1 and pw2 == 2


def test_autoscaler_sheds_budget_exhausted_batch_first():
    class _Exhausted:
        def evaluate(self, reg, now=None):
            return []

        def any_firing(self):
            return True

        def exhausted_tenants(self):
            return frozenset({"batchA"})

    def run(P):
        A = P.autoscale
        reg = P.registry.MetricsRegistry()
        reg.gauge("fleet_queue_depth").set(0)
        fleet = _FakeFleet(reg, n=2)
        sc = A.Autoscaler(fleet, A.AutoscalePolicy(
            min_replicas=1, max_replicas=2, queue_wait_p99_target_s=30.0,
            up_consecutive=2, cooldown_s=0.0), source=reg,
            tenant_classes={"batchA": "batch", "batchB": "batch"},
            alert_engine=_Exhausted())
        sc._target = 2
        a1 = sc.evaluate(now=100.0)
        d1 = [d[0] for d in fleet.demotes]
        a2 = sc.evaluate(now=101.0)
        return a1, d1, a2, fleet.demotes[-1]

    a1, d1, a2, last = both(run)
    assert a1 == "defer" and d1 == [("batchA",), ("batchB",)]
    assert a2 == "shed" and last == (("batchA",), True)


# ---------------------------------------------------------------------------
# router: budget-exhausted tenants defer in the wait line (port fleet)
# ---------------------------------------------------------------------------
def test_fleet_defers_budget_exhausted_tenant_in_line():
    P = plane("deeplearning4j_torch")

    class _Exhausted:
        def exhausted_tenants(self):
            return frozenset({"hot"})

    gpt = tiny_net()
    defer = P.telemetry.counter("fleet_slo_budget_deferrals_total",
                                labelnames=("tenant",))
    d0 = defer.labels(tenant="hot").value
    with P.serving.ServingFleet(gpt, n_replicas=1, n_slots=2, max_len=32,
                                block_size=4, tick_batch=1,
                                tick_timeout_s=None, device="cpu",
                                slo_engine=_Exhausted()) as fleet:
        gate = threading.Event()
        orig = fleet._acct.try_dispatch
        fleet._acct.try_dispatch = (
            lambda t, c, now: gate.is_set() and orig(t, c, now))
        p = np.asarray([1, 2, 3, 4], np.int32)
        h_hot = fleet.submit_async(p, n_new=2, tenant="hot")
        h_cold = fleet.submit_async(p, n_new=2, tenant="cold")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if fleet.stats()["waiting"] == 2:
                break
            time.sleep(0.002)
        assert fleet.stats()["waiting"] == 2
        gate.set()
        fleet._wake()
        h_hot.result(timeout=300)
        h_cold.result(timeout=300)
        assert h_cold._t_dispatch < h_hot._t_dispatch
    assert defer.labels(tenant="hot").value - d0 >= 1


# ---------------------------------------------------------------------------
# series names: the whole plane driven the same way in both packages
# ---------------------------------------------------------------------------
DRIVE = r'''
import json, sys, tempfile
import numpy as np
pkg = sys.argv[1]
if pkg == "deeplearning4j_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
    from deeplearning4j_tpu.zoo.gpt import Gpt
    net = Gpt(**TINY).init_graph()
    extra = {}
    from deeplearning4j_tpu.models.generation import TransformerGenerator
    gen = TransformerGenerator(net)
else:
    from deeplearning4j_torch.zoo import Gpt
    net = Gpt(**TINY).init_graph(device="cpu")
    extra = {"device": "cpu"}
    from deeplearning4j_torch.models.generation import TransformerGenerator
    gen = TransformerGenerator(net, device="cpu")
import importlib
telemetry = importlib.import_module(pkg + ".telemetry")
serving = importlib.import_module(pkg + ".serving")
slo = importlib.import_module(pkg + ".telemetry.slo")
p = np.arange(1, 9, dtype=np.int32)
gen.generate(p[None], n_new=4)
tsdb = telemetry.get_tsdb()
reg = telemetry.get_registry()
specs = [slo.SLOSpec("ttft", objective="ttft", target=0.99,
                     threshold_s=1e-6, window_s=60.0,
                     windows=[(0.05, 0.1, 1.0, "page")]),
         slo.SLOSpec("avail", target=0.99, window_s=60.0,
                     windows=[(0.05, 0.1, 1.0, "page")])]
eng = slo.AlertEngine(specs, history=tsdb)
with serving.ServingFleet(net, n_replicas=1, n_slots=2, max_len=32,
                          block_size=4, tick_batch=1, tick_timeout_s=None,
                          quotas={"bulk": serving.TenantQuota(
                              klass="batch")}, **extra) as fleet:
    lad = serving.DegradeLadder(fleet, eng, hold_down_s=0.0)
    fleet.attach_degrade(lad)
    scaler = serving.Autoscaler(
        fleet, serving.AutoscalePolicy(min_replicas=1, max_replicas=2,
                                       cooldown_s=0.0,
                                       queue_depth_high=100,
                                       forecast_horizon_s=5.0),
        alert_engine=eng, degrade_ladder=lad,
        tenant_classes={"bulk": "batch"})
    t = 0.0
    eng.evaluate(now=t)
    for i in range(3):
        fleet.submit(p, n_new=4, tenant="chat", timeout=300)
        t += 0.2
        scaler.evaluate(now=t)
    tsdb.record(reg)
    fr = telemetry.FleetRegistry(tempfile.mkdtemp(), alerts=eng)
    fr.ingest("h0", reg.snapshot())
    fr.view()
    lad.evaluate(now=t + 1.0, burn=100.0)
    try:
        fleet.submit(p, n_new=4, tenant="bulk", timeout=300)
    except Exception:
        pass
    for k in range(6):
        lad.evaluate(now=t + 2.0 + k, burn=0.0)
touched = set()
for fam in reg._families.values():
    for labels, child in fam._items():
        if labels:
            touched.add(fam.name)
        elif fam.kind == "histogram":
            if child.state()[3]:
                touched.add(fam.name)
        elif child.value:
            touched.add(fam.name)
print(json.dumps(sorted(touched)))
'''


def _drive(pkg: str):
    code = f"TINY = {TINY!r}\n" + DRIVE
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, pkg], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_plane_series_names_match_reference_after_the_same_drive():
    """generate(), a fleet with an alert engine, a ladder walked to the
    top and back and an autoscaler with a forecast, a fleet view: the
    families the drive touches are the same in both packages."""
    pytest.importorskip("jax")
    prefixes = ("fleet_slo_", "fleet_degrade_", "fleet_autoscale_",
                "fleet_tsdb_", "fleet_admission_", "generation_",
                "flight_")
    want = {n for n in _drive("deeplearning4j_tpu")
            if n.startswith(prefixes)}
    got = {n for n in _drive("deeplearning4j_torch")
           if n.startswith(prefixes)}
    assert {"fleet_slo_burn_rate", "fleet_slo_alert_state",
            "fleet_autoscale_replicas_target",
            "fleet_autoscale_forecast", "generation_requests_total",
            "generation_tokens_total", "generation_seconds",
            "generation_decode_steps_per_sec"} <= got
    assert got == want, (sorted(got - want), sorted(want - got))


# ---------------------------------------------------------------------------
# the real SIGKILL (slow, as the reference's: a subprocess)
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_sigkill_postmortem_bundle_salvaged(tmp_path):
    """``tests/test_slo.py``'s SIGKILL case on the port: a server process
    (``tests/workers/torch_flightrec_worker.py``, no JAX) SIGKILLed
    mid-decode runs no handlers — the salvaged black-box bundle still
    holds its admit events and its open decode span, and
    ``scripts/postmortem.py`` merges them into one timeline."""
    import signal
    from deeplearning4j_torch.telemetry import flightrec
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "workers",
                                      "torch_flightrec_worker.py"),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    bbdir = os.path.join(str(tmp_path), flightrec.BLACKBOX_DIRNAME)
    ready = False
    deadline = time.monotonic() + 180
    try:
        while time.monotonic() < deadline and proc.poll() is None:
            for name in (os.listdir(bbdir) if os.path.isdir(bbdir)
                         else []):
                try:
                    doc = flightrec.load_bundle(os.path.join(bbdir, name))
                except (OSError, ValueError):
                    continue               # mid-replace
                kinds = {e["kind"] for e in doc.get("events", ())}
                spans = {s["name"] for s in doc.get("open_spans", ())}
                if "admit" in kinds and "request/decode" in spans:
                    ready = True
                    break
            if ready:
                break
            time.sleep(0.05)
        assert ready, (
            f"worker never persisted a decode-in-flight black box "
            f"(rc={proc.poll()}): "
            f"{proc.stdout.read().decode(errors='replace')[-2000:]}")
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    new = flightrec.salvage_bundles(tmp_path)
    assert len(new) == 1
    doc = flightrec.load_bundle(new[0])
    assert doc["reason"].startswith("salvaged:")
    assert doc["salvaged"] is True
    assert "admit" in [e["kind"] for e in doc["events"]]
    assert "request/decode" in {s["name"] for s in doc["open_spans"]}
    assert doc["metrics"]["counters"].get(
        "generation_server_admitted_total", 0) >= 1
    assert flightrec.salvage_bundles(tmp_path) == []
    pm = _load_postmortem()
    txt = pm.render_timeline(pm.merge_timeline(doc, None), doc["reason"])
    assert "admit" in txt and "request/decode" in txt
