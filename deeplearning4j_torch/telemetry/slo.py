"""SLO error-budget engine with multi-window burn-rate alerting (port
of ``deeplearning4j_tpu/telemetry/slo.py``).

* **:class:`SLOSpec`** — a declarative objective over series the stack
  ALREADY emits.  Three objective kinds: ``availability`` (good/bad
  outcome counts from ``fleet_requests_total{tenant=,outcome=}``),
  ``latency`` (a phase of ``fleet_request_phase_seconds{phase=}``
  under ``threshold_s``, good/bad derived from the histogram buckets)
  and ``ttft`` (``generation_server_ttft_seconds`` under
  ``threshold_s``).  ``target`` is the good fraction (0.99 = "99% of
  requests good over ``window_s``");

* **error budget** — the complement of the target: over ``window_s``
  the service may spend ``(1 - target)`` of its traffic on bad
  events.  The accountant tracks the spent fraction
  (``fleet_slo_error_budget_remaining{slo=}``; <= 0 is EXHAUSTED —
  the router defers exhausted batch tenants' waiting work behind
  within-budget tenants, so interactive traffic is never shed first);

* **burn rate** — how fast the budget is being spent: ``bad_fraction
  / (1 - target)`` over a window (burn 1.0 = exactly on budget).
  :class:`AlertEngine` evaluates each spec's burn over MULTI-WINDOW
  pairs (a condition needs the burn over BOTH a short and a long
  window — the long window proves the burn is sustained, the short
  window makes the alert resolve quickly once the bleeding stops, and
  together they cannot flap on a load blip);

* **alert state machine** — ``inactive -> pending -> firing ->
  resolved``: a met condition holds ``for_s`` before firing (pending),
  a firing alert needs the condition clear for ``clear_for_s`` before
  resolving, and every transition is counted
  (``fleet_slo_alert_transitions_total{slo=,to=}``).

The engine's own state is ordinary metric families
(``fleet_slo_burn_rate{slo=,window=}``, ``fleet_slo_alert_firing
{slo=}``, budget/state gauges), so a per-host engine beacons like any
other family; an engine attached to a ``FleetRegistry``
(``FleetRegistry(alerts=engine)``) evaluates against the AGGREGATED
view on every scrape instead.  The JSON surface is ``/alerts``
(``telemetry.MetricsServer``).

Closed-loop consumers: ``serving.autoscale.Autoscaler`` treats a
firing alert as a pre-warm signal stronger than the backlog
forecaster (``fleet_autoscale_alert_prewarms_total``),
``serving.degrade.DegradeLadder`` walks its rungs on
:meth:`AlertEngine.projection`, and ``serving.router.ServingFleet``
reads :meth:`AlertEngine.admission_decision` and
:meth:`AlertEngine.exhausted_tenants`.  Every clock is injectable
(``now=``), so the port is held to the reference on the same times.
"""
from __future__ import annotations

import json
import logging
import os
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from deeplearning4j_torch.telemetry.registry import _fmt_labels
from deeplearning4j_torch.telemetry.tsdb import TimeSeriesStore, is_reset

log = logging.getLogger("deeplearning4j_torch")

OBJECTIVES = ("availability", "latency", "ttft")

#: alert states, in severity order (the state gauge's value)
STATES = ("inactive", "pending", "firing", "resolved")

#: default multi-window burn configs as FRACTIONS of ``window_s`` —
#: for the SRE-book 30-day budget window these are exactly the
#: canonical pairs: (5m, 1h, burn 14.4, page) and (30m, 6h, burn 6.0,
#: ticket).  Each entry: (short_frac, long_frac, burn_threshold,
#: severity).
DEFAULT_WINDOW_FRACS = ((1 / 8640, 1 / 720, 14.4, "page"),
                        (1 / 1440, 1 / 120, 6.0, "ticket"))


class SLOSpec:
    """One declarative objective (immutable config).

    >>> SLOSpec("inter-avail", objective="availability", target=0.999,
    ...         tenant="inter", window_s=30 * 86400)
    >>> SLOSpec("ttft", objective="latency", target=0.95,
    ...         phase="queue", threshold_s=0.25, window_s=3600)

    ``windows`` overrides the burn-rate pairs: an iterable of
    ``(short_s, long_s, burn_threshold, severity)`` tuples in SECONDS
    (default: the SRE fast/slow pairs scaled from ``window_s`` via
    :data:`DEFAULT_WINDOW_FRACS`).  ``for_s``/``clear_for_s`` are the
    state machine's hold times; ``min_events`` is the traffic floor
    below which a window reports burn 0 (one unlucky request on an
    idle service must not page).

    ``availability`` counts ``bad_outcomes`` (default expired +
    failed) against ``good_outcomes`` (default admitted) of
    ``counter_family``; ``latency`` thresholds one ``phase`` of
    ``histogram_family``; ``ttft`` thresholds the decode server's
    TTFT histogram.  ``threshold_s`` resolves to the largest
    histogram bucket bound <= the requested value (bucket math — an
    exact bound costs nothing, a between-bounds threshold is
    conservative)."""

    __slots__ = ("name", "objective", "target", "tenant", "phase",
                 "threshold_s", "window_s", "windows", "for_s",
                 "clear_for_s", "min_events", "counter_family",
                 "histogram_family", "good_outcomes", "bad_outcomes")

    def __init__(self, name: str, objective: str = "availability",
                 target: float = 0.99, tenant: Optional[str] = None,
                 phase: str = "total",
                 threshold_s: Optional[float] = None,
                 window_s: float = 30 * 86400.0,
                 windows: Optional[Iterable[Tuple]] = None,
                 for_s: float = 0.0, clear_for_s: float = 0.0,
                 min_events: int = 1,
                 counter_family: str = "fleet_requests_total",
                 histogram_family: str = "fleet_request_phase_seconds",
                 good_outcomes: Sequence[str] = ("admitted",),
                 bad_outcomes: Sequence[str] = ("expired", "failed")):
        self.name = str(name)
        if not self.name:
            raise ValueError("an SLOSpec needs a non-empty name")
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}; must "
                             f"be one of {OBJECTIVES}")
        self.objective = objective
        self.target = float(target)
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target={target} must be in (0, 1) — "
                             "1.0 leaves no error budget to burn")
        self.tenant = None if tenant is None else str(tenant)
        self.phase = str(phase)
        self.threshold_s = (None if threshold_s is None
                            else float(threshold_s))
        if objective in ("latency", "ttft") and self.threshold_s is None:
            raise ValueError(f"objective {objective!r} needs "
                             "threshold_s (the good/bad latency bar)")
        self.window_s = float(window_s)
        if self.window_s <= 0:
            raise ValueError("window_s must be > 0")
        if windows is None:
            windows = [(self.window_s * sf, self.window_s * lf, b, sev)
                       for sf, lf, b, sev in DEFAULT_WINDOW_FRACS]
        self.windows = tuple(
            (float(s), float(l), float(b), str(sev))
            for s, l, b, sev in windows)
        if not self.windows:
            raise ValueError("an SLOSpec needs >= 1 burn window")
        for s, l, b, _sev in self.windows:
            if not 0 < s <= l:
                raise ValueError(
                    f"burn window ({s:g}s, {l:g}s) needs 0 < short "
                    "<= long")
            if b <= 0:
                raise ValueError(f"burn threshold {b:g} must be > 0")
        self.for_s = float(for_s)
        self.clear_for_s = float(clear_for_s)
        self.min_events = max(1, int(min_events))
        self.counter_family = str(counter_family)
        self.histogram_family = str(histogram_family)
        self.good_outcomes = tuple(str(o) for o in good_outcomes)
        self.bad_outcomes = tuple(str(o) for o in bad_outcomes)

    @property
    def budget(self) -> float:
        """The error budget: the bad fraction the target allows."""
        return 1.0 - self.target

    def horizon_s(self) -> float:
        """How much sample history the engine must retain for this
        spec: the budget window and every burn window."""
        return max([self.window_s] + [l for _s, l, _b, _v in
                                      self.windows])


def burn_rate(good: float, bad: float, budget: float) -> float:
    """The SRE burn rate of one window's (good, bad) event counts:
    ``bad_fraction / budget``.  1.0 spends the budget exactly over
    the budget window; 0 when the window saw no traffic (no events,
    no burn)."""
    total = good + bad
    if total <= 0:
        return 0.0
    return (bad / total) / budget


def _children(fam):
    """The shared rollup-selection rule (host="fleet" children on
    aggregated views, every child on plain registries) — ONE encoding
    lives in ``telemetry.fleet.rollup_children``."""
    from deeplearning4j_torch.telemetry.fleet import rollup_children
    return rollup_children(fam)


class _SpecState:
    """One spec's fold state (mutated only under the engine lock):
    last raw totals for reset detection and the alert state machine.
    The cumulative (good, bad) sample HISTORY lives in the engine's
    shared :class:`~deeplearning4j_torch.telemetry.tsdb.TimeSeriesStore`
    as ``fleet_slo_window_events{slo=}`` — one windowing/
    reset encoding for the whole observability plane instead of a
    private list here."""

    __slots__ = ("last_good", "last_bad", "state", "t_cond",
                 "t_clear", "t_fired", "last_burns", "remaining",
                 "transitions")

    def __init__(self):
        self.last_good = None
        self.last_bad = None
        self.state = "inactive"
        self.t_cond = None              # condition first true (pending)
        self.t_clear = None             # condition first false (firing)
        self.t_fired = None
        self.last_burns: Dict[str, float] = {}
        self.remaining = 1.0
        self.transitions: Dict[str, int] = {}


class AlertEngine:
    """Evaluate :class:`SLOSpec` burn rates against a metric view and
    run the alert state machines.

    >>> engine = AlertEngine([SLOSpec("avail", target=0.99)])
    >>> engine.evaluate()            # samples the process registry
    >>> engine.alerts()              # [{"slo", "state", "burns", ...}]
    >>> engine.exhausted_tenants()   # the router's defer signal

    ``source`` is where samples come from when :meth:`evaluate` gets
    no registry: a ``MetricsRegistry``, a ``FleetRegistry`` (its
    aggregated view), or None for the process default.  ``registry``
    is where the engine's OWN families register (default: the process
    registry, so a per-host engine's state beacons fleet-wide; pass a
    private registry for isolation).  :meth:`start` runs a daemon
    evaluation loop for standalone per-host use; an engine attached
    to a ``FleetRegistry`` or an ``Autoscaler`` is driven by its host
    instead."""

    def __init__(self, specs: Iterable[SLOSpec], source=None,
                 registry=None, interval_s: float = 5.0,
                 sinks: Iterable = (), history=None):
        self.specs: Tuple[SLOSpec, ...] = tuple(specs)
        if not self.specs:
            raise ValueError("AlertEngine needs >= 1 SLOSpec")
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLOSpec names in {names}")
        self.source = source
        self.interval_s = float(interval_s)
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if registry is None:
            from deeplearning4j_torch import telemetry
            registry = telemetry.get_registry()
        self.registry = registry
        # notification egress: sinks fire on
        # pending->firing and firing->resolved transitions, exactly
        # once per transition; a failing sink degrades (counted,
        # logged), never raises into the evaluation loop
        self.sinks = tuple(sinks)
        # the shared history substrate: the (good, bad)
        # sample windows live in a TimeSeriesStore under
        # fleet_slo_window_events{slo=} — pass a shared store to pool
        # history with other recorders, default is engine-private
        self.history = history if history is not None \
            else TimeSeriesStore()
        self._lock = threading.Lock()
        self._st: Dict[str, _SpecState] = {s.name: _SpecState()
                                           for s in self.specs}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._burn = registry.gauge(
            "fleet_slo_burn_rate",
            "error-budget burn rate per SLO and window (bad_fraction "
            "/ budget over the window; 1.0 spends the budget exactly "
            "over the budget window)", labelnames=("slo", "window"))
        self._remaining = registry.gauge(
            "fleet_slo_error_budget_remaining",
            "fraction of the SLO's error budget left over its budget "
            "window (<= 0: exhausted — the router defers this "
            "tenant's batch work behind within-budget tenants)",
            labelnames=("slo",))
        self._firing = registry.gauge(
            "fleet_slo_alert_firing",
            "1 while the SLO's multi-window burn-rate alert is "
            "firing (the autoscaler's strongest pre-warm signal)",
            labelnames=("slo",))
        self._stateg = registry.gauge(
            "fleet_slo_alert_state",
            "alert state machine position: 0 inactive, 1 pending, "
            "2 firing, 3 resolved", labelnames=("slo",))
        self._trans = registry.counter(
            "fleet_slo_alert_transitions_total",
            "alert state transitions per SLO, labeled by the state "
            "entered", labelnames=("slo", "to"))
        self._notif = registry.counter(
            "fleet_alert_notifications_total",
            "alert notifications attempted per sink and result — "
            "fired on pending->firing and firing->resolved, exactly "
            "once per transition; errors degrade, never raise",
            labelnames=("sink", "result"))

    # -- sampling ------------------------------------------------------
    def _read_counts(self, reg, spec: SLOSpec
                     ) -> Optional[Tuple[float, float]]:
        """Cumulative (good, bad) event totals for one spec from one
        registry view; None when the family is absent entirely (no
        sample this pass — absence of traffic is NOT a reset)."""
        if spec.objective == "availability":
            fam = reg.get(spec.counter_family)
            if fam is None or fam.kind != "counter":
                return None
            tidx = (fam.labelnames.index("tenant")
                    if "tenant" in fam.labelnames else None)
            oidx = (fam.labelnames.index("outcome")
                    if "outcome" in fam.labelnames else None)
            if oidx is None:
                return None
            good = bad = 0.0
            for lv, child in _children(fam):
                if spec.tenant is not None and tidx is not None \
                        and lv[tidx] != spec.tenant:
                    continue
                if lv[oidx] in spec.bad_outcomes:
                    bad += child.value
                elif lv[oidx] in spec.good_outcomes:
                    good += child.value
            return good, bad
        name = (spec.histogram_family if spec.objective == "latency"
                else "generation_server_ttft_seconds")
        fam = reg.get(name)
        if fam is None or fam.kind != "histogram":
            return None
        pidx = (fam.labelnames.index("phase")
                if "phase" in fam.labelnames else None)
        good = total = 0.0
        for lv, child in _children(fam):
            if spec.objective == "latency" and pidx is not None \
                    and lv[pidx] != spec.phase:
                continue
            uppers, counts, _s, n = child.state()
            total += n
            cum = 0.0
            for ub, c in zip(uppers, counts):
                if ub > spec.threshold_s + 1e-12:
                    break
                cum += c
            good += cum
        # family present but no matching child yet = zero traffic —
        # a valid (0, 0) sample, NOT an absent family (the prime
        # sample an idle process takes before its first request)
        return good, max(0.0, total - good)

    #: retention bound per spec: the sample history is thinned to at
    #: most ~this many points over the spec's horizon (head samples
    #: closer together than horizon/MAX_SAMPLES collapse into the
    #: newest).  Burn math only needs window-edge deltas, so the
    #: approximation costs at most one thinning-gap of edge slack —
    #: and a 30-day budget window polled every 5s stays a few
    #: thousand tuples instead of half a million.
    MAX_SAMPLES = 8192

    def _series_key(self, spec: SLOSpec) -> str:
        """This spec's history series in the shared store."""
        return "fleet_slo_window_events" + _fmt_labels(
            ("slo",), (spec.name,))

    def _sample_locked(self, st: _SpecState, spec: SLOSpec,
                       now: float, counts) -> None:
        if counts is None:
            return
        good, bad = counts
        key = self._series_key(spec)
        if st.last_good is not None and (
                is_reset(st.last_good, good)
                or is_reset(st.last_bad, bad)):
            # reset epoch (worker restart / fresh view source): the
            # cumulative history no longer shares an origin with the
            # new totals — folding would manufacture negative deltas.
            # Re-prime instead; the budget window restarts with the
            # process, exactly like the fleet aggregator's rule.
            self.history.clear(key)
        st.last_good, st.last_bad = good, bad
        # mode="slo" is this engine's exact windowed encoding (same-
        # instant keep-first, dense-head collapse, keep-one-at-or-
        # before-horizon trim), now shared via the store
        self.history.append(key, now, (good, bad), kind="window",
                            mode="slo", horizon_s=spec.horizon_s(),
                            max_points=self.MAX_SAMPLES)

    def _window_counts(self, spec: SLOSpec, now: float, window_s: float
                       ) -> Tuple[float, float]:
        """(good, bad) DELTAS over the trailing window: latest sample
        minus the newest sample at or before ``now - window_s`` (the
        oldest retained sample when history is shorter — a young
        engine reads its whole history as the window).  The store's
        history is time-ordered, so the edge lookup bisects."""
        key = self._series_key(spec)
        last = self.history.latest(key)
        if last is None:
            return 0.0, 0.0
        g1, b1 = last[1]
        g0, b0 = self.history.edge(key, now - window_s)[1]
        return max(0.0, g1 - g0), max(0.0, b1 - b0)

    # -- evaluation ----------------------------------------------------
    def _source_registry(self):
        src = self.source
        if src is None:
            from deeplearning4j_torch import telemetry
            return telemetry.get_registry()
        from deeplearning4j_torch.telemetry.fleet import resolve_view
        return resolve_view(src)

    def evaluate(self, reg=None, now: Optional[float] = None
                 ) -> List[dict]:
        """One evaluation pass: sample every spec's cumulative counts
        from ``reg`` (default: the configured source), update burn
        rates, budgets and the state machines, publish the gauges,
        and return the alert list (:meth:`alerts`).  ``now`` is
        injectable for tests — the engine's clock is
        ``time.monotonic``."""
        if reg is None:
            reg = self._source_registry()
        now = time.monotonic() if now is None else float(now)
        transitions: List[Tuple[str, str]] = []
        with self._lock:
            for spec in self.specs:
                st = self._st[spec.name]
                self._sample_locked(st, spec, now,
                                    self._read_counts(reg, spec))
                burns: Dict[str, float] = {}
                condition = False
                # coverage: how long the sample history actually
                # spans — a window the engine has not yet OBSERVED
                # for its full length must not page (the young-engine
                # first-blip flap the multi-window shape exists to
                # prevent); its burn still REPORTS (the fraction seen
                # so far), it just cannot meet the condition
                span = self.history.span(self._series_key(spec))
                for short_s, long_s, thresh, _sev in spec.windows:
                    bs = burn_rate(
                        *self._window_counts(spec, now, short_s),
                        spec.budget)
                    gl, bl_bad = self._window_counts(spec, now, long_s)
                    bl = burn_rate(gl, bl_bad, spec.budget)
                    burns[f"{short_s:g}s"] = bs
                    burns[f"{long_s:g}s"] = bl
                    if (gl + bl_bad >= spec.min_events
                            and span >= long_s - 1e-9
                            and bs >= thresh and bl >= thresh):
                        condition = True
                st.last_burns = burns
                wg, wb = self._window_counts(spec, now, spec.window_s)
                total = wg + wb
                # budget CONSUMED so far: the observed bad fraction,
                # scaled by how much of the budget window the history
                # actually covers — the budget is an absolute
                # allowance over window_s, and extrapolating seconds
                # of data across a 30-day window would let ONE
                # startup failure mark a tenant exhausted (and the
                # router/autoscaler penalize it) off no evidence.
                # min_events floors it the same way it floors burns.
                if total >= spec.min_events:
                    coverage = min(1.0, span / spec.window_s) \
                        if spec.window_s > 0 else 1.0
                    spent = ((wb / total) / spec.budget) * coverage
                else:
                    spent = 0.0
                st.remaining = max(-1.0, 1.0 - spent)
                transitions += [
                    (spec.name, to)
                    for to in self._advance_locked(st, spec, now,
                                                   condition)]
            out = self._alerts_locked()
        # gauges published OUTSIDE the engine lock (family child locks
        # are their own; holding ours across them buys nothing)
        for a in out:
            name = a["slo"]
            for w, b in a["burns"].items():
                self._burn.labels(slo=name, window=w).set(b)
            self._remaining.labels(slo=name).set(a["budget_remaining"])
            self._firing.labels(slo=name).set(
                1.0 if a["state"] == "firing" else 0.0)
            self._stateg.labels(slo=name).set(
                float(STATES.index(a["state"])))
        for name, to in transitions:
            self._trans.labels(slo=name, to=to).inc()
        self._notify(transitions, out)
        return out

    def _notify(self, transitions: List[Tuple[str, str]],
                alerts: List[dict]) -> None:
        """Deliver pending->firing / firing->resolved transitions to
        every configured sink — exactly once per transition (the
        transitions list holds each state entry once), outside the
        engine lock.  A sink failure is counted and logged, never
        raised: egress must not kill the evaluation loop."""
        if not self.sinks:
            return
        notify = [(n, to) for n, to in transitions
                  if to in ("firing", "resolved")]
        if not notify:
            return
        byname = {a["slo"]: a for a in alerts}
        for name, to in notify:
            a = byname.get(name, {})
            event = {"t": time.time(), "slo": name, "to": to,
                     "state": a.get("state"),
                     "burns": a.get("burns", {}),
                     "budget_remaining": a.get("budget_remaining")}
            for sink in self.sinks:
                sname = getattr(sink, "name", type(sink).__name__)
                try:
                    sink.deliver(dict(event))
                    self._notif.labels(sink=sname, result="ok").inc()
                except Exception:
                    log.exception(
                        "alert sink %s failed delivering %s -> %s",
                        sname, name, to)
                    self._notif.labels(sink=sname,
                                       result="error").inc()

    def _advance_locked(self, st: _SpecState, spec: SLOSpec,
                        now: float, condition: bool) -> List[str]:
        """Advance one state machine; returns the states entered (0,
        1 or — pending that fires the same pass with ``for_s=0`` — 2
        of them)."""
        entered: List[str] = []

        def to(state: str) -> None:
            st.state = state
            st.transitions[state] = st.transitions.get(state, 0) + 1
            entered.append(state)

        if condition:
            st.t_clear = None
            if st.state in ("inactive", "resolved"):
                st.t_cond = now
                to("pending")
            if st.state == "pending" and now - st.t_cond >= spec.for_s:
                st.t_fired = now
                to("firing")
        else:
            if st.state == "pending":
                # never fired: a blip that cleared before for_s held
                # goes straight back (no resolved edge — resolved
                # means "it fired and stopped")
                st.t_cond = None
                to("inactive")
            elif st.state == "firing":
                if st.t_clear is None:
                    st.t_clear = now
                if now - st.t_clear >= spec.clear_for_s:
                    to("resolved")
        return entered

    # -- queries -------------------------------------------------------
    def _alerts_locked(self) -> List[dict]:
        out = []
        for spec in self.specs:
            st = self._st[spec.name]
            out.append({
                "slo": spec.name, "objective": spec.objective,
                "tenant": spec.tenant, "target": spec.target,
                "state": st.state, "burns": dict(st.last_burns),
                "budget_remaining": st.remaining,
                "exhausted": st.remaining <= 0.0,
                "t_fired": st.t_fired,
                "windows": [list(w) for w in spec.windows],
                "transitions": dict(st.transitions)})
        return out

    def alerts(self) -> List[dict]:
        """The last evaluation's alert state, one entry per spec."""
        with self._lock:
            return self._alerts_locked()

    def any_firing(self) -> bool:
        with self._lock:
            return any(st.state == "firing" for st in self._st.values())

    def budget_remaining(self, name: str) -> float:
        with self._lock:
            return self._st[name].remaining

    def exhausted_tenants(self) -> frozenset:
        """Tenants of specs whose error budget is spent — the
        router's dispatch-order defer signal (tenant-less specs never
        name anyone)."""
        with self._lock:
            return frozenset(
                spec.tenant for spec in self.specs
                if spec.tenant is not None
                and self._st[spec.name].remaining <= 0.0)

    # -- admission projection -------------------------------
    def _projected_burn_locked(self, spec: SLOSpec, now: float
                               ) -> Tuple[float, bool]:
        """(projected burn, covered) for one spec, read from the
        shared TSDB history.  The projection is the short-window burn
        extrapolated by its trend against the long window — ``b_short
        + max(0, b_short - b_long)`` — the worst across the spec's
        burn windows.  Coverage-gated EXACTLY like the alert
        condition (min_events over the long window AND the history
        span covering it), so a young store projects (0, False) and
        can never reject: the same first-blip discipline the
        multi-window alert shape exists for."""
        key = self._series_key(spec)
        span = self.history.span(key)
        projected, covered = 0.0, False
        for short_s, long_s, _thresh, _sev in spec.windows:
            gl, bl_bad = self._window_counts(spec, now, long_s)
            if gl + bl_bad < spec.min_events or span < long_s - 1e-9:
                continue
            covered = True
            bs = burn_rate(*self._window_counts(spec, now, short_s),
                           spec.budget)
            bl = burn_rate(gl, bl_bad, spec.budget)
            projected = max(projected, bs + max(0.0, bs - bl))
        return projected, covered

    def projection(self, now: Optional[float] = None) -> List[dict]:
        """Per-spec projected burn for admission control and the
        degradation ladder — one entry per spec: ``{slo, tenant,
        projected_burn, covered, budget_remaining}``.  Pure read of
        the history already folded by :meth:`evaluate`; call that
        first (the engine loop does)."""
        now = time.monotonic() if now is None else float(now)
        out = []
        with self._lock:
            for spec in self.specs:
                p, cov = self._projected_burn_locked(spec, now)
                out.append({
                    "slo": spec.name, "tenant": spec.tenant,
                    "projected_burn": p, "covered": cov,
                    "budget_remaining": self._st[spec.name].remaining})
        return out

    def admission_decision(self, tenant: str,
                           now: Optional[float] = None) -> dict:
        """Map one tenant to ``admit`` / ``degrade`` / ``reject``
        BEFORE the fleet spends anything on the request.

        Reject is deliberately narrow: a spec NAMING this tenant must
        project burn at or above its worst (page-severity) threshold
        with the error budget already overdrawn — a tenant-less fleet
        SLO can only ever degrade (shared pain shapes everyone, it
        does not single anyone out).  ``retry_after_s`` comes from
        the budget-recovery slope: the overdraft slides out of the
        budget window at the rate it was burned in, so the wait is
        ``window_s * deficit / spent`` clamped to [shortest burn
        window, window_s]."""
        now = time.monotonic() if now is None else float(now)
        tenant = str(tenant)
        verdict = {"decision": "admit", "retry_after_s": 0.0,
                   "projected_burn": 0.0, "slo": None}
        with self._lock:
            for spec in self.specs:
                if spec.tenant is not None and spec.tenant != tenant:
                    continue
                projected, covered = self._projected_burn_locked(
                    spec, now)
                if not covered or projected <= 0.0:
                    continue
                st = self._st[spec.name]
                threshs = [t for _s, _l, t, _v in spec.windows]
                pages = [t for _s, _l, t, sev in spec.windows
                         if sev == "page"]
                hard = max(pages) if pages else max(threshs)
                if (spec.tenant == tenant and projected >= hard
                        and st.remaining <= 0.0):
                    spent = 1.0 - st.remaining
                    deficit = -st.remaining
                    shortest = min(s for s, _l, _t, _v in spec.windows)
                    retry = (spec.window_s * deficit / spent
                             if spent > 0 else shortest)
                    retry = min(max(retry, shortest), spec.window_s)
                    return {"decision": "reject",
                            "retry_after_s": retry,
                            "projected_burn": projected,
                            "slo": spec.name}
                if (projected >= min(threshs)
                        and projected > verdict["projected_burn"]):
                    verdict = {"decision": "degrade",
                               "retry_after_s": 0.0,
                               "projected_burn": projected,
                               "slo": spec.name}
        return verdict

    def state(self) -> dict:
        """The full engine snapshot — the ``/alerts`` document and
        the postmortem bundle's ``slo`` section."""
        alerts = self.alerts()
        return {"specs": len(self.specs), "alerts": alerts,
                "firing": sorted(a["slo"] for a in alerts
                                 if a["state"] == "firing"),
                "exhausted": sorted(
                    a["slo"] for a in alerts if a["exhausted"])}

    def render_json(self) -> str:
        return json.dumps(self.state())

    def export(self, view) -> None:
        """Write the engine's current families into ``view`` — how a
        ``FleetRegistry``-attached engine's state reaches the
        aggregated scrape (the view is rebuilt per scrape, so the
        export re-runs each time; counters re-inc from zero on the
        fresh view).  Children are tagged ``host="fleet"`` like every
        other rollup — and when per-host engines ALSO beacon these
        families (host-tagged, with a summed ``host="fleet"`` gauge
        rollup that is meaningless for rates), this export's
        aggregated-view evaluation OVERWRITES that rollup with the
        authoritative value instead of colliding on label schema."""
        for a in self.alerts():
            name = a["slo"]
            burn = view.gauge(self._burn.name, self._burn.documentation,
                              labelnames=("slo", "window", "host"))
            for w, b in a["burns"].items():
                burn.labels(slo=name, window=w, host="fleet").set(b)
            view.gauge(self._remaining.name,
                       self._remaining.documentation,
                       labelnames=("slo", "host")).labels(
                           slo=name, host="fleet").set(
                           a["budget_remaining"])
            view.gauge(self._firing.name, self._firing.documentation,
                       labelnames=("slo", "host")).labels(
                           slo=name, host="fleet").set(
                           1.0 if a["state"] == "firing" else 0.0)
            view.gauge(self._stateg.name, self._stateg.documentation,
                       labelnames=("slo", "host")).labels(
                           slo=name, host="fleet").set(
                           float(STATES.index(a["state"])))
            trans = view.counter(self._trans.name,
                                 self._trans.documentation,
                                 labelnames=("slo", "to", "host"))
            for to, n in a["transitions"].items():
                trans.labels(slo=name, to=to, host="fleet").inc(n)

    # -- standalone loop ----------------------------------------------
    def _loop(self, stop: threading.Event) -> None:
        while not stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:
                # one bad pass must not silence the alerting plane
                log.exception("AlertEngine evaluation failed")

    def start(self) -> "AlertEngine":
        # fresh stop event: re-armable after a close() (a set() event
        # would end the new loop on its first wait); the thread
        # closes over ITS OWN event
        stop = threading.Event()
        thread = threading.Thread(target=self._loop, args=(stop,),
                                  name="dl4j-torch-slo-alerts",
                                  daemon=True)
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self          # already running
            self._stop = stop
            self._thread = thread
        thread.start()
        return self

    def close(self) -> None:
        with self._lock:
            stop = self._stop
            thread = self._thread
            self._thread = None
        stop.set()
        if thread is not None:
            thread.join(timeout=max(5.0, 2 * self.interval_s))

    def __enter__(self) -> "AlertEngine":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class WebhookFileSink:
    """File-backed webhook egress: each notification
    appends ONE JSON line to ``path`` (a directory gets
    ``alerts.jsonl`` inside it — the shared-dir shape, beside the
    beacons and bundles).  The append is a single ``O_APPEND`` write
    of a complete line, so concurrent writers from several hosts
    interleave whole records, never torn ones — the same contract an
    HTTP webhook receiver's log would give, with no network
    dependency."""

    name = "webhook_file"

    def __init__(self, path: str):
        self.path = str(path)

    def deliver(self, event: dict) -> None:
        path = self.path
        if os.path.isdir(path):
            path = os.path.join(path, "alerts.jsonl")
        data = (json.dumps(event) + "\n").encode()
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                     0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)


class CommandSink:
    """Command egress: run ``argv`` once per notification with the
    event JSON on stdin (the pager/webhook-relay hook shape).  A
    non-zero exit or a hang past ``timeout_s`` raises — the engine's
    delivery loop counts it as ``result="error"`` and moves on."""

    name = "command"

    def __init__(self, argv: Sequence[str], timeout_s: float = 10.0):
        self.argv = [str(a) for a in argv]
        if not self.argv:
            raise ValueError("CommandSink needs a command to run")
        self.timeout_s = float(timeout_s)

    def deliver(self, event: dict) -> None:
        subprocess.run(self.argv, input=json.dumps(event).encode(),
                       stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL,
                       timeout=self.timeout_s, check=True)
