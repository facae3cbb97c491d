"""Fleet-wide metric plane: push-style beacons + one aggregated scrape
(port of ``deeplearning4j_tpu/telemetry/fleet.py``).

Every series the stack emits is host-local; this module makes the
fleet visible to one controller, in three transport-agnostic pieces:

* **push transport** — :class:`MetricsBeacon`: a daemon thread that
  periodically serializes its registry's ``snapshot()`` into a
  per-host beacon file under ``<shared_dir>/_telemetry/`` with an
  atomic publish (a reader sees a previous complete snapshot or this
  one, never a torn write).  Where a ``torch.distributed`` process
  group exists, :func:`exchange_snapshots` moves the same snapshots
  over one ``all_gather_object`` instead of the filesystem;

* **aggregation** — :class:`FleetRegistry`: merges N hosts' snapshots
  into ONE scrape-able view.  Counters and histograms are folded as
  MONOTONIC DELTAS per host (a snapshot whose totals DECREASED is a
  worker restart: a fresh epoch, re-counted from zero — never
  subtracted as a negative delta), gauges are last-write per host.
  The built view tags every series ``{host=}``, adds fleet-level
  rollups (``host="fleet"``: counters/histograms summed, gauges
  summed, plus ``host="fleet_max"`` for peak-style gauges), and
  STALENESS-MARKS hosts whose beacon aged past ``stale_after_s``
  (``fleet_host_up{host=} == 0``; stale gauges leave the rollups,
  monotonic counters stay — a dead host's work happened);

* **exposition** — a :class:`FleetRegistry` quacks like a registry to
  ``telemetry.MetricsServer`` (``render_prometheus()`` refreshes from
  the beacon directory then renders).

Each beacon also ships the tracer's closed request-scoped spans
(``SpanTracer.trace_events`` — seq-deduped) into a
:class:`~deeplearning4j_torch.telemetry.tracing.FleetTraceStore`, so a
request that crossed hosts is ONE stitched tree at ``/traces``.  The
closed-loop consumers are ``serving.autoscale.Autoscaler`` and
``telemetry.slo.AlertEngine``, which read the aggregated view through
:func:`resolve_view` and :func:`rollup_children`.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from deeplearning4j_torch.telemetry.registry import (MetricsRegistry,
                                                   _escape_label,
                                                   parse_series)
from deeplearning4j_torch.telemetry.tracing import (FleetTraceStore,
                                                  SpanTracer)

log = logging.getLogger("deeplearning4j_torch")

#: subdirectory of the shared dir the metric beacons publish into
#: (namespaced beside — never inside — the rendezvous' ``_rendezvous``)
BEACON_DIRNAME = "_telemetry"


def _default_host_id() -> str:
    return f"{os.uname().nodename}-{os.getpid()}"


def _fmt_series(name: str, pairs: Tuple[Tuple[str, str], ...]) -> str:
    """Re-emit a ``(name, ((k, v), ...))`` pair as the quoted series
    grammar ``parse_series`` inverts (escaping included)."""
    if not pairs:
        return name
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return name + "{" + inner + "}"


def beacon_path(directory, host: str) -> str:
    return os.path.join(str(directory), BEACON_DIRNAME,
                        f"{host}.json")


def resolve_view(source):
    """Resolve a signal source to a readable registry: a
    ``FleetRegistry``-shaped object (callable ``view``) is refreshed
    (when directory-backed) and aggregated; anything else is already
    a registry.  Shared by the fleet-aware readers (autoscaler, SLO
    engine) so the view-resolution protocol has ONE encoding —
    exposition's ``/traces`` handler deliberately refreshes WITHOUT
    building a view (the trace store, not the metric families, is
    its product)."""
    view = getattr(source, "view", None)
    if callable(view):
        if getattr(source, "directory", None) is not None:
            source.refresh()
        return view()
    return source


def rollup_children(fam):
    """The children a fleet-aware signal reader consumes from one
    metric family: against an AGGREGATED view (a ``host`` label is
    present) only the ``host="fleet"`` rollups — per-host series
    would double-count; against a plain process registry, every
    child.  THE one encoding of the rollup convention — the
    autoscaler and the SLO engine both read through it, so a change
    to the scheme cannot desynchronize them."""
    items = fam._items()
    if "host" in fam.labelnames:
        hidx = fam.labelnames.index("host")
        items = [(lv, c) for lv, c in items if lv[hidx] == "fleet"]
    return items


def publish_beacon(directory, host: Optional[str] = None,
                   registry: Optional[MetricsRegistry] = None,
                   snapshot: Optional[dict] = None,
                   trace_events: Optional[list] = None) -> str:
    """Serialize one registry snapshot into this host's beacon file
    (atomic publish).  Returns the beacon path.  The one-shot form of
    what :class:`MetricsBeacon` does on a cadence.  ``trace_events``
    (``SpanTracer.trace_events``) rides in the same document so closed
    request spans reach the aggregator's trace store with the metrics
    — one transport, one atomic publish."""
    from deeplearning4j_torch.telemetry.flightrec import (
        _atomic_publish_json as atomic_publish_json)
    if host is None:
        host = _default_host_id()
    host = str(host)
    if os.sep in host:
        raise ValueError(f"host {host!r} must be a plain name")
    if snapshot is None:
        if registry is None:
            from deeplearning4j_torch import telemetry
            registry = telemetry.get_registry()
        snapshot = registry.snapshot()
    path = beacon_path(directory, host)
    doc = {"host": host, "pid": os.getpid(), "t": time.time(),
           "snapshot": snapshot}
    if trace_events is not None:
        doc["traces"] = list(trace_events)
    atomic_publish_json(path, doc)
    return path


class MetricsBeacon:
    """Push this worker's registry to the shared dir every
    ``interval_s`` seconds (daemon thread), plus once at ``close()``
    so the final counter totals always land.

    >>> beacon = MetricsBeacon(shared_dir, host="host000").start()
    >>> ...                       # train / serve; snapshots flow
    >>> beacon.close()            # final publish + stop

    The beacon counts its own publishes
    (``fleet_beacon_publishes_total`` in the SOURCE registry), so the
    transport is visible in the very snapshots it ships."""

    def __init__(self, directory, host: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 2.0,
                 tracer: Optional[SpanTracer] = None,
                 trace_limit: int = 4096, tsdb=None):
        self.directory = str(directory)
        self.host = str(host) if host is not None else _default_host_id()
        if os.sep in self.host:
            raise ValueError(f"host {self.host!r} must be a plain name")
        if registry is None:
            from deeplearning4j_torch import telemetry
            registry = telemetry.get_registry()
        self.registry = registry
        # trace transport: closed request-scoped spans ride
        # every beacon.  Defaults to the process tracer; trace_limit=0
        # turns the trace lane off (metrics-only beacon).
        if tracer is None and trace_limit:
            from deeplearning4j_torch import telemetry
            tracer = telemetry.get_tracer()
        self.tracer = tracer
        self.trace_limit = int(trace_limit)
        # optional local history: with a store attached,
        # every publish also records the source registry into it, so
        # the beacon cadence doubles as the host's history cadence
        self.tsdb = tsdb
        self.interval_s = float(interval_s)
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self._publishes = registry.counter(
            "fleet_beacon_publishes_total",
            "metric-beacon snapshots this worker published into the "
            "shared directory (the push transport's own heartbeat)")
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def publish(self) -> str:
        """One immediate publish (also what the loop calls).

        The trace lane deliberately ships the FULL tagged tail every
        time (bounded by ``trace_limit``), not a since-last-publish
        delta: each publish REPLACES the beacon file, so an aggregator
        that starts late or polls slower than the publish cadence
        would permanently miss any span shipped only incrementally.
        Receivers dedupe by (host, trace, pid, seq), so re-delivery costs
        bytes, never correctness."""
        traces = (self.tracer.trace_events(self.trace_limit)
                  if self.tracer is not None and self.trace_limit
                  else None)
        path = publish_beacon(self.directory, self.host, self.registry,
                              trace_events=traces)
        self._publishes.inc()
        if self.tsdb is not None:
            self.tsdb.record(self.registry)
        return path

    def _publish_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.publish()
            except Exception:    # shared-dir flake, serialization
                # hiccup, tracer churn — the beacon is a host's ONLY
                # window into the fleet view; one bad publish must
                # never silence it permanently
                log.exception("MetricsBeacon publish failed; retrying "
                              "at the next interval")

    def start(self) -> "MetricsBeacon":
        self.publish()           # first beacon lands immediately
        thread = threading.Thread(target=self._publish_loop,
                                  name="dl4j-torch-metrics-beacon",
                                  daemon=True)
        with self._lock:
            self._thread = thread
        thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            thread = self._thread
        if thread is not None:
            thread.join(timeout=5)
        try:
            self.publish()       # final totals always land
        except OSError:
            log.exception("MetricsBeacon final publish failed")

    def __enter__(self) -> "MetricsBeacon":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class _HostState:
    """One host's fold state (mutated only under the aggregator's
    lock): accumulated monotonic totals, the last RAW snapshot for
    delta/reset detection, gauge last-writes, and liveness."""

    __slots__ = ("counters", "hists", "gauges", "last_counters",
                 "last_hists", "last_seen", "last_t", "resets")

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.hists: Dict[str, dict] = {}
        self.gauges: Dict[str, float] = {}
        self.last_counters: Dict[str, float] = {}
        self.last_hists: Dict[str, dict] = {}
        self.last_seen = 0.0          # aggregator-clock receive time
        self.last_t = 0.0             # publisher's snapshot timestamp
        self.resets = 0


class FleetRegistry:
    """Merge N workers' snapshots into one scrape-able fleet view.

    >>> fr = FleetRegistry(shared_dir)        # file-beacon transport
    >>> fr.refresh()                          # poll the beacon dir
    >>> body = fr.render_prometheus()         # {host=}-tagged + rollups
    >>> view = fr.view()                      # a real MetricsRegistry
    >>> view.get("fleet_queue_wait_seconds").labels(
    ...     tenant="hot", host="fleet").percentile(0.99)

    ``ingest(host, snapshot)`` is the transport-agnostic entry — the
    directory poll and the collective exchange both end there.
    Counter/histogram RESETS (worker restart mid-window) are detected
    per series: a total that decreased starts a fresh epoch and folds
    in wholesale instead of as a negative delta."""

    def __init__(self, directory=None, stale_after_s: float = 10.0,
                 trace_store: Optional[FleetTraceStore] = None,
                 alerts=None, tsdb=None):
        self.directory = str(directory) if directory is not None else None
        self.stale_after_s = float(stale_after_s)
        self._lock = threading.Lock()
        self._hosts: Dict[str, _HostState] = {}
        # the cross-worker trace store: beacons' trace tails fold in
        # beside the metric snapshots (own lock, own dedup)
        self.traces = (trace_store if trace_store is not None
                       else FleetTraceStore())
        # SLO alert engine: attached, it evaluates against
        # every built view — the scrape IS its evaluation cadence —
        # and exports its burn/budget/state families into the view,
        # so /metrics and /alerts answer from the SAME aggregation
        self.alerts = alerts
        # embedded time-series store: every built view is
        # recorded — host-tagged series AND the host="fleet" rollups —
        # so /query answers range reads over the aggregation the
        # alerts and the autoscaler actually consumed.  Pass a shared
        # store to pool history with other recorders.
        if tsdb is None:
            from deeplearning4j_torch.telemetry.tsdb import TimeSeriesStore
            tsdb = TimeSeriesStore()
        self.tsdb = tsdb

    # -- fold ----------------------------------------------------------
    def ingest(self, host: str, snapshot: dict,
               now: Optional[float] = None) -> None:
        """Fold one host's ``MetricsRegistry.snapshot()`` in.  Safe to
        call with the SAME snapshot repeatedly (deltas are zero) and
        with post-restart snapshots (reset detection)."""
        now = time.monotonic() if now is None else float(now)
        host = str(host)
        with self._lock:
            st = self._hosts.get(host)
            if st is None:
                st = self._hosts[host] = _HostState()
            self._fold_counters_locked(st, snapshot.get("counters", {}))
            self._fold_hists_locked(st, snapshot.get("histograms", {}))
            st.gauges = dict(snapshot.get("gauges", {}))
            st.last_seen = now
            st.last_t = float(snapshot.get("timestamp", 0.0))

    def _fold_counters_locked(self, st: _HostState,
                              raw: Dict[str, float]) -> None:
        for series, v in raw.items():
            v = float(v)
            prev = st.last_counters.get(series)
            if prev is None:
                delta = v
            elif v < prev - 1e-9:
                # RESET: the worker restarted mid-window — its totals
                # began again from zero.  Treat the snapshot as a
                # fresh epoch and fold it in wholesale; subtracting
                # would produce a negative delta and silently shrink
                # the fleet total.
                delta = v
                st.resets += 1
            else:
                delta = v - prev
            st.counters[series] = st.counters.get(series, 0.0) + delta
            st.last_counters[series] = v

    def _fold_hists_locked(self, st: _HostState,
                           raw: Dict[str, dict]) -> None:
        for series, h in raw.items():
            buckets = {u: float(c)
                       for u, c in h.get("buckets", {}).items()}
            cur = {"buckets": buckets, "inf": float(h.get("inf", 0)),
                   "sum": float(h.get("sum", 0.0)),
                   "count": float(h.get("count", 0))}
            prev = st.last_hists.get(series)
            acc = st.hists.get(series)
            if acc is None:
                acc = st.hists[series] = {
                    "buckets": {u: 0.0 for u in buckets},
                    "inf": 0.0, "sum": 0.0, "count": 0.0}
            if prev is None or cur["count"] < prev["count"] - 1e-9:
                # first sight, or a reset epoch: fold in wholesale
                # (count going BACKWARD can only mean the worker's
                # histogram began again — bucket-wise subtraction
                # would go negative and desync count vs sum)
                if prev is not None:
                    st.resets += 1
                delta = cur
            else:
                delta = {
                    "buckets": {
                        u: max(0.0, c - prev["buckets"].get(u, 0.0))
                        for u, c in buckets.items()},
                    "inf": max(0.0, cur["inf"] - prev["inf"]),
                    "sum": max(0.0, cur["sum"] - prev["sum"]),
                    "count": cur["count"] - prev["count"]}
            for u, c in delta["buckets"].items():
                acc["buckets"][u] = acc["buckets"].get(u, 0.0) + c
            acc["inf"] += delta["inf"]
            acc["sum"] += delta["sum"]
            acc["count"] += delta["count"]
            st.last_hists[series] = cur

    # -- transports ----------------------------------------------------
    def refresh(self, now: Optional[float] = None) -> List[str]:
        """Poll the beacon directory and ingest every host file;
        returns the hosts seen this pass.  Unreadable/torn files are
        skipped (the atomic publish makes them transient)."""
        if self.directory is None:
            raise ValueError("FleetRegistry was built without a beacon "
                             "directory; feed it via ingest()")
        bdir = os.path.join(self.directory, BEACON_DIRNAME)
        seen: List[str] = []
        try:
            names = sorted(os.listdir(bdir))
        except OSError:
            return seen
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(bdir, name)) as f:
                    doc = json.load(f)
                host = str(doc["host"])
                snap = doc["snapshot"]
            except (OSError, ValueError, KeyError):
                continue          # mid-replace or foreign file
            self.ingest(host, snap, now=now)
            traces = doc.get("traces")
            if traces:
                self.traces.ingest(host, traces)
            seen.append(host)
        return seen

    # -- view ----------------------------------------------------------
    def hosts(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Liveness ledger: ``{host: {stale, age_s, resets}}``."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            return {h: {"stale": (now - st.last_seen
                                  > self.stale_after_s),
                        "age_s": max(0.0, now - st.last_seen),
                        "resets": st.resets}
                    for h, st in self._hosts.items()}

    def view(self, now: Optional[float] = None) -> MetricsRegistry:
        """Build the aggregated registry: every host's series tagged
        ``{host=}``, plus ``host="fleet"`` rollups (counters and
        histograms summed across ALL hosts — monotonic work done is
        never un-counted; gauges summed across LIVE hosts only, with
        ``host="fleet_max"`` as the peak rollup) and the liveness
        meta-series."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            hosts = {h: (st.counters.copy(),
                         {s: {"buckets": a["buckets"].copy(),
                              "inf": a["inf"], "sum": a["sum"],
                              "count": a["count"]}
                          for s, a in st.hists.items()},
                         st.gauges.copy(),
                         now - st.last_seen > self.stale_after_s,
                         now - st.last_seen, st.resets)
                     for h, st in self._hosts.items()}
        view = MetricsRegistry()
        roll_c: Dict[str, float] = {}
        roll_h: Dict[str, dict] = {}
        roll_g_sum: Dict[str, float] = {}
        roll_g_max: Dict[str, float] = {}
        n_stale = 0
        up = view.gauge(
            "fleet_host_up",
            "1 while the host's beacon is fresher than stale_after_s; "
            "0 marks a stale host (its gauges leave the rollups)",
            labelnames=("host",))
        age = view.gauge(
            "fleet_beacon_age_seconds",
            "seconds since this host's beacon was last ingested",
            labelnames=("host",))
        resets = view.counter(
            "fleet_counter_resets_total",
            "snapshots whose totals DECREASED vs the previous one "
            "(worker restart mid-window) — folded as fresh epochs, "
            "never as negative deltas", labelnames=("host",))
        for h in sorted(hosts):
            counters, hists, gauges, stale, age_s, n_resets = hosts[h]
            up.labels(host=h).set(0.0 if stale else 1.0)
            age.labels(host=h).set(age_s)
            resets.labels(host=h).inc(n_resets)
            n_stale += bool(stale)
            snap = {"counters": {}, "gauges": {}, "histograms": {}}
            for series, v in counters.items():
                name, pairs = parse_series(series)
                snap["counters"][
                    _fmt_series(name, pairs + (("host", h),))] = v
                roll_c[series] = roll_c.get(series, 0.0) + v
            for series, a in hists.items():
                name, pairs = parse_series(series)
                snap["histograms"][
                    _fmt_series(name, pairs + (("host", h),))] = a
                r = roll_h.get(series)
                if r is None:
                    r = roll_h[series] = {"buckets": {}, "inf": 0.0,
                                          "sum": 0.0, "count": 0.0}
                for u, c in a["buckets"].items():
                    r["buckets"][u] = r["buckets"].get(u, 0.0) + c
                r["inf"] += a["inf"]
                r["sum"] += a["sum"]
                r["count"] += a["count"]
            for series, v in gauges.items():
                name, pairs = parse_series(series)
                snap["gauges"][
                    _fmt_series(name, pairs + (("host", h),))] = v
                if not stale:
                    roll_g_sum[series] = roll_g_sum.get(series, 0.0) + v
                    roll_g_max[series] = max(
                        roll_g_max.get(series, float("-inf")), v)
            self._merge_defensive(view, snap)
        roll = {"counters": {
                    _fmt_series(*_with_host(s, "fleet")): v
                    for s, v in roll_c.items()},
                "histograms": {
                    _fmt_series(*_with_host(s, "fleet")): a
                    for s, a in roll_h.items()},
                "gauges": {}}
        for s, v in roll_g_sum.items():
            roll["gauges"][_fmt_series(*_with_host(s, "fleet"))] = v
        for s, v in roll_g_max.items():
            roll["gauges"][_fmt_series(*_with_host(s, "fleet_max"))] = v
        self._merge_defensive(view, roll)
        view.gauge(
            "fleet_hosts_live",
            "hosts whose beacon is fresher than stale_after_s").set(
                len(hosts) - n_stale)
        view.gauge(
            "fleet_hosts_stale",
            "hosts whose beacon aged out (their gauges left the "
            "rollups; their counters remain)").set(n_stale)
        ts = self.traces.summary()
        view.gauge(
            "fleet_trace_store_traces",
            "distinct request trace ids the cross-worker trace store "
            "currently holds").set(ts["traces"])
        view.gauge(
            "fleet_trace_store_spans",
            "beaconed request spans held across all stored traces "
            "(deduped by (host, trace, pid, seq))").set(ts["spans"])
        view.gauge(
            "fleet_trace_store_rooted",
            "stored traces whose submit-minted root span has arrived "
            "(the rest are orphan fragments awaiting their root; a "
            "rooted trace can still report complete=false at /traces "
            "if stray same-host fragments fall outside the root)").set(
                ts["rooted"])
        view.counter(
            "fleet_trace_store_evicted_total",
            "trace trees the store evicted — retired-trace retention "
            "(LRU by retire time) plus the max_traces capacity bound "
            "— so sustained traffic cannot grow the aggregator "
            "without end").inc(ts["evicted"])
        if self.alerts is not None:
            self.alerts.evaluate(view, now=now)
            self.alerts.export(view)
        tstats = self.tsdb.stats()
        view.gauge(
            "fleet_tsdb_series",
            "distinct series the embedded time-series store currently "
            "holds history for (/query's universe)").set(
                tstats["series"])
        view.counter(
            "fleet_tsdb_samples_total",
            "timestamped samples the embedded time-series store has "
            "recorded across all series").inc(tstats["samples_total"])
        view.counter(
            "fleet_tsdb_evicted_total",
            "samples the store aged out or collapsed into the "
            "downsampled tier — bounded history, not unbounded "
            "growth").inc(tstats["evicted_total"])
        # record the finished view WALL-clocked (the ``now`` above is
        # monotonic staleness time): /query ranges line up with
        # postmortem timelines and cross-host wall stamps
        self.tsdb.record(view)
        return view

    @staticmethod
    def _merge_defensive(view: MetricsRegistry, snap: dict) -> None:
        """One host's labeled-series snapshot into the view, merged
        SERIES BY SERIES: a cross-host label-schema conflict (two
        workers registered the same family with different labels)
        must cost exactly the offending series, not the whole scrape
        — and a bulk merge that raised midway would have already
        half-applied (double-counting everything a retry re-adds)."""
        for kind in ("counters", "gauges", "histograms"):
            for series, v in snap.get(kind, {}).items():
                try:
                    view.merge_snapshot({kind: {series: v}})
                except ValueError:
                    view.counter(
                        "fleet_aggregate_conflicts_total",
                        "series dropped from the fleet view because "
                        "hosts disagree on a family's label schema"
                    ).inc()
                    log.warning("fleet aggregation: dropped "
                                "conflicting series %s", series)

    def render_prometheus(self) -> str:
        """Refresh (when directory-backed) and render the aggregated
        view — the method ``telemetry.MetricsServer`` calls, so a
        ``FleetRegistry`` can be served directly as a fleet-wide
        ``/metrics`` endpoint that re-aggregates per scrape."""
        if self.directory is not None:
            self.refresh()
        return self.view().render_prometheus()


def _with_host(series: str, host: str):
    name, pairs = parse_series(series)
    return name, pairs + (("host", host),)


def exchange_snapshots(registry: Optional[MetricsRegistry] = None,
                       host: Optional[str] = None,
                       max_bytes: int = 1 << 18) -> Dict[str, dict]:
    """Snapshot exchange over the ``torch.distributed`` process group —
    the beacon transport for fleets that share a process group but no
    filesystem.  Every process contributes its registry snapshot to one
    ``all_gather_object`` (a collective: every rank must call it);
    returns ``{host: snapshot}`` for ALL processes, ready to feed
    ``FleetRegistry.ingest``.  With no initialised group, or a group of
    one, it degenerates to just the local snapshot — callers need no
    special case.  ``max_bytes`` bounds one serialized snapshot, as in
    the reference (all processes must agree on it)."""
    if registry is None:
        from deeplearning4j_torch import telemetry
        registry = telemetry.get_registry()
    if host is None:
        host = _default_host_id()
    doc = {"host": str(host), "snapshot": registry.snapshot()}
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return {doc["host"]: doc["snapshot"]}
    payload = json.dumps(doc)
    if len(payload.encode()) > max_bytes:
        raise ValueError(
            f"snapshot is {len(payload.encode())} bytes > max_bytes="
            f"{max_bytes}; raise max_bytes (all processes must agree "
            "on it) or prune the registry")
    gathered: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, payload)
    out: Dict[str, dict] = {}
    for raw in gathered:
        if not raw:
            continue
        peer = json.loads(raw)
        out[str(peer["host"])] = peer["snapshot"]
    return out
