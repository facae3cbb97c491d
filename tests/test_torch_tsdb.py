"""The port's embedded time-series store, ``/query`` endpoint and alert
egress, held to the JAX package's ``tests/test_tsdb.py`` case by case
(same names, same scripted values at the same injected times, the same
assertions), each case run in BOTH packages with the results compared
(``torch_plane_util.both``: equal, floats within 1e-12 relative).

Beyond the reference's cases: a seeded random history (counters with
restarts, gauges, histograms) through both stores' every read, the
process store behind the flight recorder's bundles, and the reference's
``scripts/postmortem.py`` rendering a bundle the port wrote."""
import importlib.util
import json
import math
import os
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_plane_util import both, port_only  # noqa: E402

approx = pytest.approx
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _values(doc):
    """A /query document without its wall-clock stamps (``start``,
    ``end`` and each point's t differ between two runs)."""
    out = []
    for r in doc["results"]:
        row = {k: v for k, v in r.items() if k != "points"}
        if "points" in r:
            row["values"] = [v for _t, v in r["points"]]
        out.append(row)
    return {"matched": doc["matched"], "func": doc["func"], "results": out}


# ---------------------------------------------------------------------------
# window math, hand-pinned
# ---------------------------------------------------------------------------

def test_range_rate_delta_across_a_reset():
    def run(P):
        st = P.tsdb.TimeSeriesStore()
        for t, v in ((0.0, 10.0), (10.0, 20.0), (20.0, 5.0), (30.0, 15.0)):
            st.append("c_total", t, v, kind="counter")
        return {"resets": [P.tsdb.is_reset(20.0, 5.0),
                           P.tsdb.is_reset(5.0, 15.0)],
                "points": st.points("c_total", 5.0, 25.0),
                "delta": st.delta("c_total", 0.0, 30.0),
                "rate": st.rate("c_total", 0.0, 30.0),
                "delta_edge": st.delta("c_total", 15.0, 30.0),
                "missing": st.delta("missing", 0.0, 30.0),
                "thin": st.rate("c_total", 0.0, 0.5)}

    r = both(run)
    assert r["resets"] == [True, False]
    assert r["points"] == [(10.0, 20.0), (20.0, 5.0)]
    assert r["delta"] == approx(25.0)
    assert r["rate"] == approx(25.0 / 30.0)
    assert r["delta_edge"] == approx(5.0 + 10.0)
    assert r["missing"] is None and r["thin"] is None


def test_quantile_over_time_via_bucket_math():
    def run(P):
        reg = P.registry.MetricsRegistry()
        h = reg.histogram("lat_seconds", buckets=(0.1, 1.0))
        h.observe(0.05)
        st = P.tsdb.TimeSeriesStore()
        st.record(reg, now=0.0)
        for _ in range(3):
            h.observe(0.5)
        st.record(reg, now=10.0)
        st.append("g", 0.0, 1.0)
        return {"q": st.quantile_over_time("lat_seconds", 0.5, 0.0, 10.0),
                "direct": P.tsdb.window_quantile((0.1, 1.0),
                                                 [0.0, 3.0, 0.0], 0.5),
                "empty": st.quantile_over_time("lat_seconds", 0.5,
                                               20.0, 30.0),
                "gauge": st.quantile_over_time("g", 0.5, 0.0, 10.0)}

    r = both(run)
    assert r["q"] == approx(0.55) and r["direct"] == approx(0.55)
    assert math.isnan(r["empty"]) and r["gauge"] is None


def test_two_tier_boundary_and_eviction_accounting():
    def run(P):
        st = P.tsdb.TimeSeriesStore(raw_window_s=10.0, max_raw_points=1024,
                                    down_interval_s=5.0, retention_s=100.0)
        for t in range(40):
            st.append("g", float(t), float(t))
        return {"points": st.points("g"), "stats": st.stats()}

    r = both(run)
    pts = r["points"]
    assert [v for _, v in pts][-1] == 39.0 and pts == sorted(pts)
    raw = [p for p in pts if p[0] >= 39.0 - 10.0]
    older = [p for p in pts if p[0] < 39.0 - 10.0]
    assert len(raw) >= 10 and 0 < len(older) <= 40 - len(raw)
    gaps = [b[0] - a[0] for a, b in zip(older, older[1:])]
    assert gaps and all(g >= 5.0 for g in gaps[:-1])
    s = r["stats"]
    assert s["series"] == 1 and s["samples_total"] == 40
    assert s["evicted_total"] > 0 and s["points"] == len(pts)


def test_record_and_query_with_label_matchers():
    def run(P):
        reg = P.registry.MetricsRegistry()
        fam = reg.counter("req_total", labelnames=("tenant",))
        fam.labels(tenant="a").inc(2)
        fam.labels(tenant="b").inc(7)
        st = P.tsdb.TimeSeriesStore()
        st.record(reg, now=100.0)
        fam.labels(tenant="a").inc(1)
        st.record(reg, now=110.0)
        errors = []
        for kw in ({"func": "bogus"}, {"func": "quantile"}):
            with pytest.raises(ValueError) as ei:
                st.query("req_total", **kw)
            errors.append(str(ei.value))
        return {"a": st.query("req_total", matchers=[("tenant", "a")],
                              start=90.0, end=120.0),
                "all": st.query("req_total", start=90.0, end=120.0),
                "rate": st.query("req_total", matchers=[("tenant", "a")],
                                 start=90.0, end=120.0, func="rate"),
                "none": st.query("nope")["matched"], "errors": errors}

    r = both(run)
    doc = r["a"]
    assert doc["matched"] == 1
    assert doc["results"][0]["series"] == 'req_total{tenant="a"}'
    assert [v for _, v in doc["results"][0]["points"]] == [2.0, 3.0]
    assert r["all"]["matched"] == 2 and r["none"] == 0
    assert r["rate"]["results"][0]["value"] == approx(0.1)


def test_seeded_history_reads_equal_in_both_packages():
    """A numpy-seeded drive — a counter that restarts twice, a labeled
    gauge, a histogram — recorded at the same seeded instants into both
    packages' stores (two-tier retention crossing its raw window), then
    every read: points, edge, last_two, span, delta, rate,
    quantile_over_time, query in all four functions, stats."""
    rng = np.random.default_rng(16)
    times = np.cumsum(rng.uniform(0.2, 3.0, 150))
    incs = rng.integers(0, 7, 150)
    gauges = rng.normal(5.0, 2.0, 150)
    obs = rng.exponential(0.3, (150, 4))
    restart_at = {40, 97}

    def run(P):
        reg = P.registry.MetricsRegistry()
        st = P.tsdb.TimeSeriesStore(raw_window_s=60.0, max_raw_points=80,
                                    down_interval_s=7.0,
                                    retention_s=300.0)
        for i, t in enumerate(times):
            if i in restart_at:           # a worker restart: fresh totals
                reg = P.registry.MetricsRegistry()
            c = reg.counter("jobs_total", labelnames=("kind",))
            c.labels(kind="x").inc(float(incs[i]))
            reg.gauge("depth", labelnames=("q",)).labels(q="a").set(
                float(gauges[i]))
            h = reg.histogram("lat_seconds", buckets=(0.1, 0.25, 0.5, 1.0))
            for v in obs[i]:
                h.observe(float(v))
            st.record(reg, now=float(t))
        key = 'jobs_total{kind="x"}'
        t0, t1 = float(times[20]), float(times[140])
        out = {"series": st.series(), "stats": st.stats(),
               "span": st.span(key), "last_two": st.last_two(key),
               "edge": st.edge(key, t0), "points": st.points(key, t0, t1),
               "delta": st.delta(key, t0, t1), "rate": st.rate(key, t0, t1),
               "q": [st.quantile_over_time("lat_seconds", q, t0, t1)
                     for q in (0.5, 0.9, 0.99)]}
        for func, extra in (("range", {}), ("rate", {}), ("delta", {}),
                            ("quantile", {"q": 0.9})):
            name = "lat_seconds" if func == "quantile" else "jobs_total"
            out["query_" + func] = st.query(name, start=t0, end=t1,
                                            func=func, **extra)
        return out

    r = both(run)
    assert r["stats"]["series"] == 3 and r["stats"]["evicted_total"] > 0
    assert r["delta"] > 0 and r["rate"] > 0
    assert all(0.0 < q <= 1.0 for q in r["q"])


# ---------------------------------------------------------------------------
# the HTTP surface
# ---------------------------------------------------------------------------

def test_query_endpoint_on_fleet_registry(tmp_path):
    def run(P):
        d = tmp_path / P.pkg
        src = P.registry.MetricsRegistry()
        fam = src.counter("fleet_requests_total",
                          labelnames=("tenant", "outcome"))
        fam.labels(tenant="a", outcome="ok").inc(3)
        P.telemetry.publish_beacon(d, "h0", registry=src)
        fr = P.telemetry.FleetRegistry(d, stale_after_s=3600.0)
        out = {}
        with P.telemetry.start_metrics_server(fr, port=0) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            out["metrics"] = _get(base + "/metrics")[0]
            fam.labels(tenant="a", outcome="ok").inc(2)
            P.telemetry.publish_beacon(d, "h0", registry=src)
            code, body = _get(base + "/query?series=fleet_requests_total"
                              "&tenant=a")
            out["range"] = (code, _values(json.loads(body)))
            code, body = _get(base + "/query?series=fleet_requests_total"
                              "&tenant=a&host=h0&func=rate")
            out["rate_ok"] = (code, [r["value"] > 0 for r in
                                     json.loads(body)["results"]])
            code, body = _get(base + "/nope")
            out["404"] = (code, json.loads(body))
            out["400"] = []
            for q in ("/query", "/query?series=",
                      "/query?series=a&series=b", "/query?series=a&start=x",
                      "/query?series=a&func=nope",
                      "/query?series=a&func=quantile"):
                code, body = _get(base + q)
                out["400"].append((q, code, json.loads(body)))
        return out

    r = both(run)
    assert r["metrics"] == 200
    code, doc = r["range"]
    assert code == 200
    hosts = {s["series"].rsplit('host="', 1)[1].rstrip('"}')
             for s in doc["results"]}
    assert hosts == {"h0", "fleet"}
    for s in doc["results"]:
        assert s["values"][-1] == 5.0
    assert r["rate_ok"] == (200, [True])
    assert r["404"][0] == 404 and "/query" in r["404"][1]["endpoints"]
    for q, code, body in r["400"]:
        assert code == 400, q
        assert body["error"] == "bad_query"


def test_query_endpoint_on_plain_registry():
    def run(P):
        reg = P.registry.MetricsRegistry()
        reg.counter("jobs_total").inc(4)
        reg.tsdb = P.tsdb.TimeSeriesStore()
        reg.tsdb.record(reg)
        with P.telemetry.start_metrics_server(reg, port=0) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            code, body = _get(base + "/query?series=jobs_total")
            c404, b404 = _get(base + "/nope")
        return {"query": (code, _values(json.loads(body))),
                "404": (c404, json.loads(b404))}

    r = both(run)
    code, doc = r["query"]
    assert code == 200 and doc["matched"] == 1
    assert doc["results"][0]["values"] == [4.0]
    assert r["404"] == (404, {"error": "not_found",
                              "endpoints": ["/metrics", "/query"]})


# ---------------------------------------------------------------------------
# alert egress sinks (exactly once per transition)
# ---------------------------------------------------------------------------

def test_webhook_file_sink_exactly_once_per_transition(tmp_path):
    def run(P):
        d = tmp_path / P.pkg
        d.mkdir()
        hook = d / "alerts.jsonl"
        bad = P.slo.CommandSink([os.path.join(str(d), "no-such-bin")])
        src = P.registry.MetricsRegistry()
        fam = src.counter("fleet_requests_total",
                          labelnames=("tenant", "outcome"))
        reg = P.registry.MetricsRegistry()
        spec = P.slo.SLOSpec("egress", objective="availability",
                             target=0.9, window_s=100.0,
                             windows=[(4.0, 8.0, 1.5, "page")])
        eng = P.slo.AlertEngine([spec], source=src, registry=reg,
                                sinks=[P.slo.WebhookFileSink(hook), bad])
        states = [eng.evaluate(now=0.0)[0]["state"]]
        fam.labels(tenant="a", outcome="failed").inc(5)
        states.append(eng.evaluate(now=10.0)[0]["state"])
        states.append(eng.evaluate(now=11.0)[0]["state"])
        fam.labels(tenant="a", outcome="ok").inc(500)
        states.append(eng.evaluate(now=20.0)[0]["state"])
        states.append(eng.evaluate(now=30.0)[0]["state"])
        events = [json.loads(ln) for ln in hook.read_text().splitlines()
                  if ln]
        notif = reg.counter("fleet_alert_notifications_total",
                            labelnames=("sink", "result"))
        return {"states": states,
                "events": [{k: v for k, v in e.items() if k != "t"}
                           for e in events],
                "stamped": all("t" in e for e in events),
                "ok": notif.labels(sink="webhook_file", result="ok").value,
                "err": notif.labels(sink="command", result="error").value}

    r = both(run)
    assert r["states"][1] == "firing"
    assert r["states"][-1] in ("resolved", "inactive")
    assert [e["to"] for e in r["events"]] == ["firing", "resolved"]
    assert r["stamped"] and all(e["slo"] == "egress" and "burns" in e
                                for e in r["events"])
    assert r["ok"] == 2 and r["err"] == 2


def test_command_sink_delivers_stdin_json(tmp_path):
    def run(P):
        out = tmp_path / f"{P.pkg}.json"
        sink = P.slo.CommandSink([sys.executable, "-c",
                                  "import sys; open(%r, 'w').write("
                                  "sys.stdin.read())" % str(out)])
        sink.deliver({"slo": "x", "to": "firing"})
        with pytest.raises(ValueError):
            P.slo.CommandSink([])
        return json.loads(out.read_text())

    assert both(run)["to"] == "firing"


# ---------------------------------------------------------------------------
# bundle history + retention
# ---------------------------------------------------------------------------

def test_bundle_history_and_retention(tmp_path):
    def run(P):
        d = str(tmp_path / P.pkg)
        store = P.tsdb.TimeSeriesStore()
        now = time.time()
        for i in range(5):
            store.append("fleet_queue_depth", now - 50.0 + i * 10.0,
                         float(i), kind="gauge")
        fr = P.flightrec.FlightRecorder(capacity=16)
        fr.record("dispatch", replica=0)
        fr.install_dump(d, host="h", tsdb=store, history_s=120.0,
                        max_bundles=2)
        paths = [fr.request_dump(f"drill {i}") for i in range(4)]
        kept = P.flightrec.list_bundles(d)
        doc = P.flightrec.load_bundle(paths[-1])
        hist = doc["history"]["series"]["fleet_queue_depth"]
        fr.uninstall_dump()
        salvaged = P.flightrec.salvage_bundles(d, max_bundles=1)
        with pytest.raises(ValueError):
            fr.install_dump(d, host="h", max_bundles=0)
        return {"all": all(paths), "n_kept": len(kept),
                "last_kept": paths[-1] in kept,
                "first_kept": paths[0] in kept, "kind": hist["kind"],
                "values": [v for _, v in hist["points"]],
                "span": hist["points"][-1][0] - hist["points"][0][0],
                "salvaged": salvaged,
                "after": len(P.flightrec.list_bundles(d))}

    r = both(run)
    assert r["all"] and r["n_kept"] == 2
    assert r["last_kept"] and not r["first_kept"]
    assert r["kind"] == "gauge"
    assert r["values"] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert r["span"] == approx(40.0)
    assert r["salvaged"] == [] and r["after"] == 1


def test_bundle_history_defaults_to_the_process_store(tmp_path):
    """With no store armed, a bundle's ``history`` is the process
    store's (``telemetry.get_tsdb()``), as in the reference."""
    def run(P):
        tsdb = P.telemetry.get_tsdb()
        series = f"plane_probe_{P.pkg}"
        tsdb.append(series, time.time() - 1.0, 7.0, kind="gauge")
        fr = P.flightrec.FlightRecorder(capacity=4)
        fr.install_dump(str(tmp_path / P.pkg), host="h")
        try:
            doc = P.flightrec.load_bundle(fr.request_dump("probe"))
        finally:
            fr.uninstall_dump()
        hist = doc["history"]["series"][series]
        return {"kind": hist["kind"],
                "values": [v for _t, v in hist["points"]]}

    r = both(run)
    assert r == {"kind": "gauge", "values": [7.0]}


def _load_postmortem():
    spec = importlib.util.spec_from_file_location(
        "postmortem", os.path.join(ROOT, "scripts", "postmortem.py"))
    pm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pm)
    return pm


def test_postmortem_renders_history_timelines(tmp_path):
    """The reference's renderer on the reference case's bundle, and on a
    bundle the PORT's flight recorder wrote from its own store: the
    postmortem tooling reads the port's bundles as they are."""
    pm = _load_postmortem()
    bundle = {"host": "h", "t": 100.0, "events": [
                  {"wall": 95.0, "kind": "dispatch", "seq": 0}],
              "history": {"window_s": 60.0, "t": 100.0, "series": {
                  "q_depth": {"kind": "gauge",
                              "points": [[90.0, 1.0], [95.0, 3.0]]},
                  "lat": {"kind": "histogram", "points": [
                      [95.0, {"count": 2.0, "sum": 0.5}]]}}}}
    text = pm.render_history(bundle)
    assert "2 series" in text and "q_depth" in text
    assert "count=2 sum=0.5" in text
    entries = pm.merge_timeline(bundle, history_series=["q_depth"])
    kinds = [(e["src"], e["wall"]) for e in entries]
    assert ("metric", 90.0) in kinds and ("metric", 95.0) in kinds
    assert ("event", 95.0) in kinds
    assert pm.render_history({"history": None}) == ""

    def run(P):
        reg = P.registry.MetricsRegistry()
        h = reg.histogram("lat", buckets=(0.1, 1.0))
        store = P.tsdb.TimeSeriesStore()
        now = time.time()
        for i in range(3):
            reg.gauge("q_depth").set(float(i))
            h.observe(0.05 * (i + 1))
            store.record(reg, now=now - 30.0 + 10.0 * i)
        fr = P.flightrec.FlightRecorder(capacity=8)
        fr.record("dispatch", replica=0)
        fr.install_dump(str(tmp_path / P.pkg), host="h", registry=reg,
                        tsdb=store)
        try:
            return P.flightrec.load_bundle(fr.request_dump("render"))
        finally:
            fr.uninstall_dump()

    series = both(lambda P: {
        k: [v for _t, v in s["points"]]
        for k, s in run(P)["history"]["series"].items()})
    assert series["q_depth"] == [0.0, 1.0, 2.0]
    doc = port_only(run)
    text = pm.render_history(doc)
    assert "2 series" in text and "q_depth" in text
    assert "count=3" in text
    entries = pm.merge_timeline(doc, history_series=["q_depth"])
    assert sum(e["src"] == "metric" for e in entries) == 3
    assert any(e["src"] == "event" for e in entries)
