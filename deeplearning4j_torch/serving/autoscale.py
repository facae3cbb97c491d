"""Closed-loop autoscaling: SLO pressure in, replica lifecycle out (port
of ``deeplearning4j_tpu/serving/autoscale.py``).

:class:`Autoscaler` evaluates the (possibly aggregated) metric view on
a scheduler-style cadence and drives the fleet's actuators
(``ServingFleet.add_replica`` / ``remove_replica`` /
``demote_waiting``):

* **signals** — interactive queue-wait p99 and EDF slack p10 computed
  over a SLIDING WINDOW (cumulative histograms are differenced
  between evaluations — a cumulative p99 never recovers after one
  spike), plus the fleet queue-depth gauge, the free-KV-block gauge
  and the healthy-replica count.  Against an aggregated
  :class:`~deeplearning4j_torch.telemetry.fleet.FleetRegistry` view
  the readers consume the ``host="fleet"`` rollup children, against a
  plain process registry the bare children — the SAME policy runs on
  one host or a fleet;
* **hysteresis** — scale-up needs ``up_consecutive`` consecutive
  pressured evaluations, scale-down ``down_consecutive`` consecutive
  idle ones, and every action arms a ``cooldown_s`` dead time;
* **class-aware shedding** — when pressure persists at
  ``max_replicas``, batch-class tenants are DEFERRED first (their
  waiting requests demoted below interactive priority) and SHED
  second (cancelled) — interactive tenants are never touched;
* **predictive pre-warm** — :class:`BacklogForecaster`, a windowed
  LINEAR FIT over the backlog, counts a projected crossing of
  ``queue_depth_high`` within ``forecast_horizon_s`` as scale-up
  pressure through the SAME hysteresis/cooldown
  (``fleet_autoscale_forecast{signal=}``,
  ``fleet_autoscale_prewarms_total``);
* **SLO burn-rate pre-warm** — with an
  :class:`~deeplearning4j_torch.telemetry.slo.AlertEngine` attached
  (``alert_engine=``, or its ``fleet_slo_alert_firing`` gauge on the
  scraped view), a FIRING alert opens the streak gate immediately
  (cooldown still applies), and budget-EXHAUSTED batch tenants
  defer/shed first at ``max_replicas``.

A replica the loop adds is built by ``ServingFleet.add_replica`` from
the fleet's own server kwargs, so it lands on the fleet's device.

Telemetry: ``fleet_autoscale_actions_total{direction=}``,
``fleet_autoscale_{deferred,shed}_total{tenant=}``,
``fleet_autoscale_replicas_target``, ``fleet_autoscale_pressure``,
``fleet_autoscale_forecast{signal=}``,
``fleet_autoscale_prewarms_total``,
``fleet_autoscale_alert_prewarms_total``.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.telemetry.tsdb import (TimeSeriesStore,
                                               is_reset,
                                               window_quantile)

log = logging.getLogger("deeplearning4j_torch")

_ACTIONS = telemetry.counter(
    "fleet_autoscale_actions_total",
    "autoscaler replica actions by direction (up: add_replica, "
    "down: remove_replica through drain->migrate)",
    labelnames=("direction",))
_DEFERRED = telemetry.counter(
    "fleet_autoscale_deferred_total",
    "batch-class waiting requests demoted below interactive priority "
    "because pressure persisted at max_replicas",
    labelnames=("tenant",))
_SHED = telemetry.counter(
    "fleet_autoscale_shed_total",
    "batch-class waiting requests cancelled because pressure "
    "persisted after deferral", labelnames=("tenant",))
_TARGET = telemetry.gauge(
    "fleet_autoscale_replicas_target",
    "the autoscaler's current desired replica count")
_PRESSURE = telemetry.gauge(
    "fleet_autoscale_pressure",
    "last evaluation: +1 scale-up pressure, -1 scale-down headroom, "
    "0 neutral")
_FORECAST = telemetry.gauge(
    "fleet_autoscale_forecast",
    "the predictive scaler's state by signal: slope (backlog items/s "
    "from the windowed linear fit), backlog (fitted current value), "
    "breach_s (projected seconds until queue_depth_high, -1 when no "
    "breach is projected), firing (1 while the projection is inside "
    "forecast_horizon_s)", labelnames=("signal",))
_PREWARM = telemetry.counter(
    "fleet_autoscale_prewarms_total",
    "scale-ups taken on the FORECAST alone — a replica pre-warmed "
    "before any reactive SLO signal tripped")
_ALERT_PREWARM = telemetry.counter(
    "fleet_autoscale_alert_prewarms_total",
    "scale-ups attributed to a FIRING SLO burn-rate alert while "
    "every reactive signal was quiet — the error-budget "
    "engine pre-warmed the replica before the reactive loop could "
    "see the breach")


class AutoscalePolicy:
    """SLO targets + damping for one fleet (immutable config).

    ``queue_wait_p99_target_s`` is the interactive admission-wait SLO
    (windowed p99 above it is scale-up pressure);
    ``edf_slack_p10_floor_s`` arms the deadline-headroom signal
    (windowed slack p10 below it is pressure); ``queue_depth_high``
    and ``free_blocks_floor`` are the direct backpressure/memory
    triggers.  ``up_consecutive`` / ``down_consecutive`` /
    ``cooldown_s`` are the hysteresis, ``defer_priority`` the value
    batch-class waiting requests demote to when shedding starts.

    ``forecast_horizon_s`` turns the PREDICTIVE path on:
    when the windowed linear fit over the backlog series projects
    ``queue_depth_high`` will be crossed within the horizon, the
    projection counts as scale-up pressure through the SAME
    hysteresis/cooldown, so a replica pre-warms before the reactive
    signals trip.  ``forecast_window_s`` bounds the fit window,
    ``forecast_min_points`` the samples required before the fit is
    trusted.  Forecasting requires ``queue_depth_high`` — the
    ceiling being projected against."""

    __slots__ = ("min_replicas", "max_replicas",
                 "queue_wait_p99_target_s", "edf_slack_p10_floor_s",
                 "queue_depth_high", "free_blocks_floor",
                 "up_consecutive", "down_consecutive", "cooldown_s",
                 "shed_batch", "defer_priority", "forecast_horizon_s",
                 "forecast_window_s", "forecast_min_points")

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 queue_wait_p99_target_s: float = 0.5,
                 edf_slack_p10_floor_s: Optional[float] = None,
                 queue_depth_high: Optional[int] = None,
                 free_blocks_floor: int = 0,
                 up_consecutive: int = 2, down_consecutive: int = 6,
                 cooldown_s: float = 2.0, shed_batch: bool = True,
                 defer_priority: int = 8,
                 forecast_horizon_s: Optional[float] = None,
                 forecast_window_s: float = 10.0,
                 forecast_min_points: int = 4):
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas ({self.min_replicas}) <= "
                f"max_replicas ({self.max_replicas})")
        self.queue_wait_p99_target_s = float(queue_wait_p99_target_s)
        self.edf_slack_p10_floor_s = (
            None if edf_slack_p10_floor_s is None
            else float(edf_slack_p10_floor_s))
        self.queue_depth_high = (None if queue_depth_high is None
                                 else int(queue_depth_high))
        self.free_blocks_floor = int(free_blocks_floor)
        self.up_consecutive = max(1, int(up_consecutive))
        self.down_consecutive = max(1, int(down_consecutive))
        self.cooldown_s = float(cooldown_s)
        self.shed_batch = bool(shed_batch)
        self.defer_priority = int(defer_priority)
        self.forecast_horizon_s = (None if forecast_horizon_s is None
                                   else float(forecast_horizon_s))
        self.forecast_window_s = float(forecast_window_s)
        self.forecast_min_points = max(2, int(forecast_min_points))
        if self.forecast_horizon_s is not None \
                and self.queue_depth_high is None:
            raise ValueError(
                "forecast_horizon_s needs queue_depth_high — the "
                "backlog ceiling the forecast projects against")


def fit_trend(points: Iterable[Tuple[float, float]]
              ) -> Optional[Tuple[float, float]]:
    """Least-squares linear fit over ``(t, value)`` samples; returns
    ``(slope, value_at_latest_t)`` or None when the fit is degenerate
    (fewer than 2 points, or all at one instant).  The fitted value —
    not the raw last sample — anchors the projection, so one noisy
    reading cannot swing the predicted breach time."""
    pts = [(float(t), float(v)) for t, v in points]
    n = len(pts)
    if n < 2:
        return None
    mt = sum(t for t, _ in pts) / n
    mv = sum(v for _, v in pts) / n
    var = sum((t - mt) ** 2 for t, _ in pts)
    if var <= 0:
        return None
    slope = sum((t - mt) * (v - mv) for t, v in pts) / var
    t_last = max(t for t, _ in pts)
    return slope, mv + slope * (t_last - mt)


def predict_breach_s(points: Iterable[Tuple[float, float]],
                     threshold: float,
                     fit: Optional[Tuple[float, float]] = None
                     ) -> Optional[float]:
    """Seconds until the fitted backlog trend crosses ``threshold``
    (0.0 when already over it), or None when no breach is projected
    (flat/shrinking trend, or a degenerate fit).  ``fit`` short-
    circuits the regression when the caller already ran it (the
    control loop computes one fit per pass).  The forecast-math
    unit: a synthetic ramp ``v = a*t`` must predict ``(threshold -
    v_now) / a`` exactly."""
    if fit is None:
        fit = fit_trend(points)
    if fit is None:
        return None
    slope, v_now = fit
    if v_now >= float(threshold):
        return 0.0
    if slope <= 1e-9:
        return None
    return (float(threshold) - v_now) / slope


class BacklogForecaster:
    """Windowed queue-growth extrapolation (the predictive half of
    the loop).  ``observe`` feeds one ``(now, backlog)`` sample per
    control-loop pass (the backlog series the registry already
    carries — ``fleet_queue_depth``); ``breach_s`` fits the window
    and publishes the prediction to the ``fleet_autoscale_forecast``
    gauge family so the forecast is as observable as the signals it
    predicts.  The window lives in a
    :class:`~deeplearning4j_torch.telemetry.tsdb.TimeSeriesStore`
    (the shared history substrate, its lock): ``observe``
    may be driven from the autoscaler thread while tests and
    dashboards read concurrently."""

    _SERIES = "autoscale_backlog"

    def __init__(self, window_s: float = 10.0, min_points: int = 4,
                 store: Optional[TimeSeriesStore] = None):
        self.window_s = float(window_s)
        self.min_points = max(2, int(min_points))
        self.store = store if store is not None else TimeSeriesStore()

    def observe(self, now: float, backlog: float) -> None:
        # mode="window" strict-trims past window_s at append — the
        # deque this class used to carry, shared now
        self.store.append(self._SERIES, float(now), float(backlog),
                          kind="gauge", mode="window",
                          horizon_s=self.window_s)

    def points(self) -> List[Tuple[float, float]]:
        """The current fit window, oldest first."""
        return self.store.points(self._SERIES)

    def breach_s(self, threshold: float) -> Optional[float]:
        """Projected seconds until ``threshold``; None when the window
        is too thin or the trend projects no breach.  Publishes the
        slope/backlog/breach_s gauges either way."""
        pts = self.points()
        if len(pts) < self.min_points:
            return None
        fit = fit_trend(pts)
        if fit is None:
            return None
        slope, v_now = fit
        breach = predict_breach_s(pts, threshold, fit=fit)
        _FORECAST.labels(signal="slope").set(slope)
        _FORECAST.labels(signal="backlog").set(v_now)
        _FORECAST.labels(signal="breach_s").set(
            -1.0 if breach is None else breach)
        return breach


class Autoscaler:
    """Evaluate ``policy`` against a metric view on a cadence and
    drive ``fleet``'s replica lifecycle.

    >>> scaler = Autoscaler(fleet, AutoscalePolicy(max_replicas=3),
    ...                     tenant_classes={"analytics": "batch"},
    ...                     interval_s=0.25).start()
    >>> ...                        # step load: replicas follow SLOs
    >>> scaler.close()

    ``source`` is where signals come from: a ``FleetRegistry``
    (aggregated, cross-worker — the production shape), a plain
    ``MetricsRegistry``, or None for the process-default registry.
    ``evaluate()`` is public so tests and external schedulers can
    drive the loop without the thread."""

    def __init__(self, fleet, policy: Optional[AutoscalePolicy] = None,
                 source=None, interval_s: float = 0.5,
                 tenant_classes: Optional[Dict[str, str]] = None,
                 remove_timeout_s: float = 30.0,
                 alert_engine=None, degrade_ladder=None):
        self.fleet = fleet
        self.policy = policy or AutoscalePolicy()
        self.source = source
        # SLO burn-rate engine: attached, the autoscaler
        # DRIVES its evaluation each pass and treats a firing alert
        # as scale-up pressure STRONGER than the forecaster (the
        # streak gate opens immediately — the engine's own for_s /
        # multi-window hysteresis already damped it; cooldown still
        # applies).  Without an attached engine the same signal is
        # read from the fleet_slo_alert_firing gauge, so alerts
        # beaconed from OTHER hosts steer this loop too.
        self.alert_engine = alert_engine
        # degradation ladder: attached, the autoscaler's
        # loop also clocks the ladder each pass — one control thread
        # owns both reactions to SLO burn (add capacity AND shed
        # quality), so they observe the same projection and cannot
        # fight on stale reads of each other's signal.
        self.degrade_ladder = degrade_ladder
        self.interval_s = float(interval_s)
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.remove_timeout_s = float(remove_timeout_s)
        self.tenant_classes = dict(tenant_classes or {})
        self.batch_tenants = sorted(
            t for t, c in self.tenant_classes.items() if c == "batch")
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._target = int(getattr(fleet, "n_replicas", 1))
        self._added: List[int] = []    # replicas THIS loop added (LIFO
                                       # scale-down order)
        self._up_streak = 0
        self._down_streak = 0
        self._last_action = float("-inf")
        self._deferred = False         # defer fired since pressure rose
        # windowed-signal history: the per-key cumulative
        # bucket samples the sliding-window quantiles difference live
        # in ONE private TimeSeriesStore (pairwise mode — the
        # prev-snapshot dict this class used to carry), shared with
        # the forecaster so the loop has a single history substrate
        self._hist = TimeSeriesStore()
        self._forecaster = (
            BacklogForecaster(self.policy.forecast_window_s,
                              self.policy.forecast_min_points,
                              store=self._hist)
            if self.policy.forecast_horizon_s is not None else None)
        _TARGET.set(self._target)

    # -- signal readers ------------------------------------------------
    def _registry(self):
        src = self.source
        if src is None:
            return telemetry.get_registry()
        from deeplearning4j_torch.telemetry.fleet import resolve_view
        return resolve_view(src)

    @staticmethod
    def _children(fam):
        """The children to read — the shared rollup-selection rule
        (host="fleet" children on aggregated views, every child on a
        plain registry); ONE encoding lives in
        ``telemetry.fleet.rollup_children``, shared with the SLO
        engine so the two readers can never drift apart."""
        from deeplearning4j_torch.telemetry.fleet import rollup_children
        return rollup_children(fam)

    def _gauge_sum(self, reg, name: str) -> Optional[float]:
        fam = reg.get(name)
        if fam is None or fam.kind != "gauge":
            return None
        items = self._children(fam)
        if not items:
            return None
        return sum(c.value for _, c in items)

    def _hist_window_quantile(self, reg, name: str, q: float,
                              label: Optional[str] = None,
                              allowed: Optional[Iterable[str]] = None,
                              key: Optional[str] = None
                              ) -> Optional[float]:
        """Windowed quantile of a (possibly label-filtered) histogram
        family: merge the selected children's cumulative buckets,
        difference against the previous evaluation, and take the
        quantile of the delta.  None when the family is absent or the
        window saw no new samples.  ``key`` names the window slot
        (one family read with two filters needs two windows)."""
        fam = reg.get(name)
        if fam is None or fam.kind != "histogram":
            return None
        aset = None if allowed is None else {str(v) for v in allowed}
        lidx = (fam.labelnames.index(label)
                if label is not None and label in fam.labelnames
                else None)
        uppers: Tuple[float, ...] = ()
        merged: Optional[List[float]] = None
        for lv, child in self._children(fam):
            if aset is not None and lidx is not None \
                    and lv[lidx] not in aset:
                continue
            u, counts, _s, _n = child.state()
            if merged is None:
                uppers = u
                merged = [0.0] * len(counts)
            for i, c in enumerate(counts):
                merged[i] += c
        if merged is None:
            return None
        total = sum(merged)
        key = "hist_window:" + (key or name)
        # pairwise window in the shared store: keep the newest two
        # cumulative samples, difference them (mode="window",
        # max_points=2 — the prev-snapshot dict this method used to
        # carry, one reset/windowing encoding with the SLO engine)
        self._hist.append(key, time.monotonic(),
                          (tuple(merged), total), kind="window",
                          mode="window", max_points=2)
        two = self._hist.last_two(key)
        if two is None:
            # first sight (fresh autoscaler on a long-lived registry):
            # PRIME the window and report no signal — reading the
            # whole cumulative history as one window would resurrect
            # every historical spike as current pressure, the exact
            # failure windowing exists to avoid
            return None
        (_tp, (prev_counts, prev_total)), _cur = two
        if is_reset(prev_total, total):
            # registry reset: re-prime against the fresh epoch
            self._hist.clear(key)
            self._hist.append(key, time.monotonic(),
                              (tuple(merged), total), kind="window",
                              mode="window", max_points=2)
            return None
        window = [max(0.0, c - p) for c, p in zip(merged, prev_counts)]
        if sum(window) <= 0:
            return None
        return window_quantile(uppers, window, q)

    def interactive_tenants(self, reg) -> Optional[List[str]]:
        """Tenants NOT classed batch (None = no filter: every tenant
        counts as interactive when no classes were configured)."""
        if not self.batch_tenants:
            return None
        fam = reg.get("fleet_queue_wait_seconds")
        if fam is None or "tenant" not in fam.labelnames:
            return None
        tidx = fam.labelnames.index("tenant")
        seen = {lv[tidx] for lv, _ in fam._items()}
        return sorted(seen - set(self.batch_tenants))

    # -- the loop ------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> str:
        """One control-loop pass; returns the action taken
        ("up" / "down" / "defer" / "shed" / "hold")."""
        now = time.monotonic() if now is None else float(now)
        pol = self.policy
        reg = self._registry()
        # admission wait is TWO-STAGE: the fleet wait line (quota /
        # no-capacity) AND the replica-internal queue the greedy
        # dispatch pushes into — the phase="queue" histogram from the
        # request-trace instrumentation.  SLO pressure is the worse of
        # the two windowed p99s.
        fleet_p99 = self._hist_window_quantile(
            reg, "fleet_queue_wait_seconds", 0.99, label="tenant",
            allowed=self.interactive_tenants(reg), key="fleet_wait")
        replica_p99 = self._hist_window_quantile(
            reg, "fleet_request_phase_seconds", 0.99, label="phase",
            allowed=("queue",), key="replica_queue")
        waits = [w for w in (fleet_p99, replica_p99)
                 if w is not None and not math.isnan(w)]
        wait_p99 = max(waits) if waits else None
        slack_p10 = (self._hist_window_quantile(
            reg, "fleet_edf_slack_seconds", 0.10)
            if pol.edf_slack_p10_floor_s is not None else None)
        qdepth = self._gauge_sum(reg, "fleet_queue_depth") or 0.0
        # ONE lock-consistent fleet snapshot per pass: the forecast
        # backlog and the target re-base below both read it
        try:
            fstats = self.fleet.stats()
        except Exception:
            fstats = None
        # the BACKLOG the forecaster extrapolates is two-stage, like
        # the wait signal: the fleet wait line PLUS the replica-
        # internal queues the greedy dispatch pushes into (a burst
        # lands there within one pass, leaving fleet_queue_depth ~0).
        # Summed from the fleet's own per-replica stats — the
        # process-global generation_server_queue_depth gauge is
        # last-write-wins across replicas and reads ONE replica's
        # queue, not the sum.  Dead/removed replicas are excluded
        # (like n_live below): an organically-dead server's stranded
        # queue_depth never drains, and counting it would both
        # double-count the migrated work and pin a phantom breach
        # that blocks scale-down forever
        backlog = qdepth + (sum(r.get("queue_depth", 0) or 0
                                for r in fstats["replicas"]
                                if not r["dead"] and not r["removed"])
                            if fstats else 0.0)
        # admission headroom = free list + evictable cache (the pool
        # reports the two gauges apart; the floor signal still wants
        # the sum — an evictable block is reclaimable-by-spill, not
        # pressure by itself)
        free_blocks = self._gauge_sum(reg, "kv_pool_blocks_free")
        ev_blocks = self._gauge_sum(reg, "kv_pool_blocks_evictable")
        if free_blocks is not None and ev_blocks is not None:
            free_blocks += ev_blocks
        healthy = self._gauge_sum(reg, "fleet_replicas_healthy") or 0.0

        up_reasons = []
        if (wait_p99 is not None and not math.isnan(wait_p99)
                and wait_p99 > pol.queue_wait_p99_target_s):
            up_reasons.append(f"queue_wait_p99={wait_p99:.3g}s")
        if (slack_p10 is not None and not math.isnan(slack_p10)
                and slack_p10 < pol.edf_slack_p10_floor_s):
            up_reasons.append(f"edf_slack_p10={slack_p10:.3g}s")
        if pol.queue_depth_high is not None \
                and qdepth > pol.queue_depth_high:
            up_reasons.append(f"queue_depth={qdepth:g}")
        if pol.free_blocks_floor and free_blocks is not None \
                and free_blocks < pol.free_blocks_floor:
            up_reasons.append(f"free_blocks={free_blocks:g}")
        # SLO burn-rate alert: a firing alert is a
        # MEASURED budget burn, not a projection — it outranks the
        # forecaster below.  alert_only records whether an eventual
        # up action is attributable to the alert alone.
        alert_firing = False
        if self.alert_engine is not None:
            try:
                self.alert_engine.evaluate(reg, now=now)
            except Exception:
                log.exception("autoscaler: alert-engine evaluation "
                              "failed")
            alert_firing = self.alert_engine.any_firing()
        else:
            alert_firing = bool(
                self._gauge_sum(reg, "fleet_slo_alert_firing") or 0.0)
        if self.degrade_ladder is not None:
            # clocked here, not in its own thread: degradation steps
            # happen on the same pass (same projection snapshot) as
            # the scale decision they complement
            try:
                self.degrade_ladder.evaluate(now=now)
            except Exception:
                log.exception("autoscaler: degrade-ladder evaluation "
                              "failed")
        alert_only = False
        if alert_firing:
            alert_only = not up_reasons
            up_reasons.append("slo_burn_alert")
        # predictive pre-warm: the forecast fires BEFORE
        # any reactive signal, but through the same streak/cooldown
        # gate — prediction adds lead time, never a new flap mode.
        # forecast_only records whether an eventual up action was
        # taken on the projection alone (the prewarm accounting).
        forecast_only = False
        if self._forecaster is not None:
            self._forecaster.observe(now, backlog)
            breach = self._forecaster.breach_s(pol.queue_depth_high)
            firing = (breach is not None
                      and breach <= pol.forecast_horizon_s
                      and backlog > 0)
            _FORECAST.labels(signal="firing").set(float(firing))
            if firing:
                forecast_only = not up_reasons
                up_reasons.append(f"forecast_breach_s={breach:.3g}")
        # scale-down headroom: nothing waiting, no fresh SLO pressure,
        # and (checked under the lock below) every targeted replica
        # actually became healthy — never judge "idle" while a
        # newcomer is still joining
        idle = (not up_reasons and qdepth == 0
                and (wait_p99 is None or math.isnan(wait_p99)
                     or wait_p99 < 0.5 * pol.queue_wait_p99_target_s))

        # re-base the desired-replica target on fleet truth: replicas
        # that died (chaos) or were removed externally must not pin a
        # stale target — that would both block scale-down forever
        # (healthy can never reach it) and refuse scale-up at a
        # phantom max while fewer replicas actually live
        n_live = (sum(1 for r in fstats["replicas"]
                      if not r["dead"] and not r["removed"])
                  if fstats is not None else None)

        with self._lock:
            if n_live is not None:
                self._target = n_live
            down_ok = idle and healthy >= self._target
            if up_reasons:
                self._up_streak += 1
                self._down_streak = 0
                if alert_firing:
                    # stronger than the forecaster: the engine's own
                    # multi-window + for_s hysteresis already proved
                    # the burn is sustained — re-proving it through
                    # the streak would just delay the pre-warm
                    self._up_streak = max(self._up_streak,
                                          pol.up_consecutive)
            elif down_ok:
                self._down_streak += 1
                self._up_streak = 0
                self._deferred = False
            else:
                self._up_streak = 0
                self._down_streak = 0
                self._deferred = False
            _PRESSURE.set(1 if up_reasons else (-1 if down_ok else 0))
            cooled = now - self._last_action >= pol.cooldown_s
            action = "hold"
            remove_idx = None
            if (self._up_streak >= pol.up_consecutive and cooled):
                if self._target < pol.max_replicas:
                    action = "up"
                    self._target += 1
                elif pol.shed_batch and self.batch_tenants:
                    action = "shed" if self._deferred else "defer"
                    self._deferred = True
                if action != "hold":
                    self._last_action = now
                    self._up_streak = 0
            elif (self._down_streak >= pol.down_consecutive and cooled
                    and self._target > pol.min_replicas):
                action = "down"
                self._target -= 1
                self._last_action = now
                self._down_streak = 0
                remove_idx = self._added.pop() if self._added else None
            target = self._target
        _TARGET.set(target)

        # actuate OUTSIDE the lock (replica construction allocates a pool;
        # remove_replica blocks on migration)
        if action == "up":
            try:
                idx = self.fleet.add_replica()
            except Exception:
                log.exception("autoscaler: add_replica failed")
                with self._lock:
                    self._target -= 1
                    target = self._target
                _TARGET.set(target)
                return "hold"
            with self._lock:
                self._added.append(idx)
            _ACTIONS.labels(direction="up").inc()
            if forecast_only:
                # the reactive signals were all quiet: this replica
                # exists because the projection said the SLO horizon
                # would be crossed — the pre-warm the predictive path
                # is for
                _PREWARM.inc()
            if alert_only:
                # attributed to the burn-rate alert: the budget was
                # measurably burning while every reactive signal was
                # still quiet (the closed loop)
                _ALERT_PREWARM.inc()
            telemetry.get_flight_recorder().record(
                "scale", action="up", target=int(target),
                replica=int(idx), reasons=", ".join(up_reasons))
            log.info("autoscaler: scaled UP to %d (replica %d)%s: %s",
                     target, idx,
                     " [predictive pre-warm]" if forecast_only else "",
                     ", ".join(up_reasons))
        elif action == "down":
            if remove_idx is not None and not self._removable(remove_idx):
                # the loop's own add may have died or been removed
                # externally since (chaos kill) — removing a corpse
                # would count an action that frees no capacity
                remove_idx = None
            if remove_idx is None:
                remove_idx = self._pick_removable()
            if remove_idx is None:
                with self._lock:
                    self._target += 1
                    target = self._target
                _TARGET.set(target)
                return "hold"
            try:
                self.fleet.remove_replica(remove_idx,
                                          timeout=self.remove_timeout_s)
            except Exception:
                log.exception("autoscaler: remove_replica(%d) failed",
                              remove_idx)
            _ACTIONS.labels(direction="down").inc()
            telemetry.get_flight_recorder().record(
                "scale", action="down", target=int(target),
                replica=int(remove_idx))
            log.info("autoscaler: scaled DOWN to %d (removed replica "
                     "%d)", target, remove_idx)
        elif action == "defer":
            targets = self._batch_targets(shed=False)
            for t in targets:
                n = self.fleet.demote_waiting(
                    (t,), priority=self.policy.defer_priority)
                if n:
                    _DEFERRED.labels(tenant=t).inc(n)
            telemetry.get_flight_recorder().record(
                "scale", action="defer", tenants=",".join(targets))
            log.warning("autoscaler: at max_replicas under pressure "
                        "(%s) — deferring batch tenants %s",
                        ", ".join(up_reasons), targets)
        elif action == "shed":
            targets = self._batch_targets(shed=True)
            for t in targets:
                n = self.fleet.demote_waiting((t,), cancel=True)
                if n:
                    _SHED.labels(tenant=t).inc(n)
            telemetry.get_flight_recorder().record(
                "scale", action="shed", tenants=",".join(targets))
            log.warning("autoscaler: pressure persisted after "
                        "deferral — shedding batch tenants %s",
                        targets)
        return action

    def _batch_targets(self, shed: bool) -> List[str]:
        """Batch tenants ordered budget-exhausted FIRST (the tenant
        that already spent its error budget pays before one still
        within budget).  Shedding goes further: while ANY
        batch tenant is exhausted, only the exhausted ones are
        cancelled this round — within-budget batch work keeps its
        deferred place in line."""
        exh = set()
        if self.alert_engine is not None:
            exh = set(self.alert_engine.exhausted_tenants())
        if shed:
            hit = [t for t in self.batch_tenants if t in exh]
            return hit or list(self.batch_tenants)
        return sorted(self.batch_tenants,
                      key=lambda t: (t not in exh, t))

    @staticmethod
    def _decode_capable(r: dict) -> bool:
        return r.get("role", "unified") != "prefill"

    def _removable(self, idx: int) -> bool:
        """Is ``idx`` still a live replica worth scaling in?  Never
        the last live DECODE-CAPABLE replica of a disaggregated fleet
        — removing it would brick the fleet (remove_replica refuses
        anyway; don't burn the down action on a refusal)."""
        st = self.fleet.stats()
        if not 0 <= idx < len(st["replicas"]):
            return False
        r = st["replicas"][idx]
        if r["dead"] or r["removed"]:
            return False
        if self._decode_capable(r):
            others = [i for i, o in enumerate(st["replicas"])
                      if i != idx and not o["dead"] and not o["removed"]
                      and self._decode_capable(o)]
            if not others:
                return False
        return True

    def _pick_removable(self) -> Optional[int]:
        """Highest-index live replica when the loop added none itself
        (still bounded below by min_replicas at the decision site);
        role-aware: the last decode-capable replica is never a
        candidate."""
        st = self.fleet.stats()
        live = [i for i, r in enumerate(st["replicas"])
                if not r["dead"] and not r["removed"]]
        if len(live) <= 1:
            return None
        decode_live = [i for i in live
                       if self._decode_capable(st["replicas"][i])]
        cands = [i for i in live
                 if i not in decode_live or len(decode_live) > 1]
        return max(cands) if cands else None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:
                # the control loop must outlive one bad pass
                log.exception("autoscaler evaluation failed")

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self._loop,
                                        name="dl4j-torch-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=max(5.0, 4 * self.interval_s))

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    @property
    def target(self) -> int:
        with self._lock:
            return self._target
