"""Embedded metrics time-series store (port of
``deeplearning4j_tpu/telemetry/tsdb.py``) — the fleet's ONE history
substrate.  The SLO engine's ``(t, good, bad)`` windows, the backlog
forecaster's fit window, the autoscaler's pairwise histogram deltas,
``/query`` and the postmortem bundles' pre-crash history all read
through it.

* **:class:`TimeSeriesStore`** — timestamped samples of every
  registered series, recorded once per scrape/beacon cycle
  (:meth:`TimeSeriesStore.record`) into bounded per-series rings.
  Two retention shapes per series:

  - **two-tier** (the default, what ``record`` uses): a raw recent
    window (:data:`RAW_WINDOW_S` / :data:`MAX_RAW_POINTS`) whose aged
    samples spill into a downsampled older tier (keep-newest per
    :data:`DOWN_INTERVAL_S` bucket) retained for :data:`RETENTION_S`;
    every collapsed/expired sample counts as an eviction;
  - **windowed** (``mode="slo"`` / ``mode="window"``): the exact
    bounded-window encodings the SLO engine and forecaster use —
    same-instant keep-first + dense-head collapse +
    keep-one-at-or-before-horizon trim for burn math, plain
    strict-trim windows for trend fits and pairwise deltas.

* **range reads + functions** — :meth:`points` (bisect-indexed),
  :meth:`delta` / :meth:`rate` with worker-restart RESET detection
  (:func:`is_reset` — the one helper slo.py and the autoscaler
  share), and :meth:`quantile_over_time` via the histogram-bucket math
  (:func:`window_quantile`).

* **/query** — :meth:`query` backs the JSON endpoint beside
  ``/metrics``, ``/traces`` and ``/alerts``
  (``telemetry.exposition``): series selector + label matchers +
  ``[start, end]`` + optional function.  A ``FleetRegistry`` records
  its AGGREGATED view, so the store holds host-tagged series and the
  ``host="fleet"`` rollups ``rollup_children`` produces.

* **crash forensics** — :meth:`dump_recent` renders the last N
  minutes of every series, downsampled, for the flight recorder's
  postmortem bundles (``telemetry.flightrec``).

Host-side Python only; the arithmetic is the reference's float
arithmetic in the same order, so both packages give equal answers on
the same samples.  One store-level lock guards all shared state;
appends are O(1) amortized and reads copy out under the lock — the
recorder thread, the control loops and HTTP readers never race.
"""
from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .registry import _fmt_labels, parse_series

#: two-tier retention defaults: raw samples kept this long ...
RAW_WINDOW_S = 300.0
#: ... and at most this many per series (a hot recorder cannot grow
#: a series unbounded inside the raw window)
MAX_RAW_POINTS = 2048
#: aged raw samples collapse to one per this interval ...
DOWN_INTERVAL_S = 10.0
#: ... and the downsampled tier is dropped past this age
RETENTION_S = 3600.0

#: query functions ``/query`` accepts
QUERY_FUNCS = ("range", "rate", "delta", "quantile")


def is_reset(prev: float, cur: float, eps: float = 1e-9) -> bool:
    """Worker-restart reset detection over cumulative totals: a
    counter that went DOWN did not un-count events — its process
    restarted and the new total shares no origin with the old one.
    The one encoding ``slo.AlertEngine``, ``serving.autoscale`` and
    this store's ``delta``/``rate`` all share."""
    return cur < prev - eps


def window_quantile(uppers: Tuple[float, ...], counts: Sequence[float],
                    q: float) -> float:
    """Interpolated quantile over one WINDOW's bucket counts (the
    registry's ``percentile`` over deltas instead of cumulative
    state).  ``counts`` includes the trailing +Inf bucket: overflow
    samples COUNT toward the rank and resolve to the top finite bound
    — exactly like ``_HistogramChild.percentile`` — because the worst
    waits are precisely the ones a control loop must not lose (an
    all-overflow meltdown window must read as maximal pressure, not
    as idle).  NaN when the window is empty."""
    total = sum(counts)
    if total <= 0:
        return math.nan
    rank = q * total
    cum = 0.0
    lo = 0.0
    for i, ub in enumerate(uppers):
        prev = cum
        cum += counts[i]
        if cum >= rank:
            if counts[i] == 0:
                return ub
            return lo + (rank - prev) / counts[i] * (ub - lo)
        lo = ub
    return uppers[-1] if uppers else math.nan


class _Series:
    """One series' ring state (mutated only under the store lock):
    ``raw`` and ``down`` are time-ordered ``(t, value)`` lists —
    window edges bisect into them.  ``mode`` fixes the retention
    shape at first append; ``uppers`` is histogram bucket metadata."""

    __slots__ = ("kind", "mode", "uppers", "raw", "down", "horizon_s",
                 "max_points")

    def __init__(self, kind: str, mode: Optional[str],
                 uppers: Optional[Tuple[float, ...]],
                 horizon_s: Optional[float],
                 max_points: Optional[int]):
        self.kind = kind
        self.mode = mode
        self.uppers = uppers
        self.raw: List[Tuple[float, Any]] = []
        self.down: List[Tuple[float, Any]] = []
        self.horizon_s = horizon_s
        self.max_points = max_points

    def merged(self) -> List[Tuple[float, Any]]:
        return self.down + self.raw


def _bisect_le(pts: List[Tuple[float, Any]], t: float) -> int:
    """Index of the newest point at-or-before ``t`` (clamped to the
    oldest — a young series reads its whole history as the window,
    the same rule the SLO engine's edge lookup used)."""
    return max(0, bisect.bisect_right(pts, t, key=lambda p: p[0]) - 1)


class TimeSeriesStore:
    """The embedded TSDB: per-series bounded rings + range reads.

    >>> store = TimeSeriesStore()
    >>> store.record(registry)            # one sample of every series
    >>> store.points('fleet_queue_depth', start=t0, end=t1)
    >>> store.rate('fleet_requests_total{outcome="admitted"}', t0, t1)
    >>> store.quantile_over_time(
    ...     'fleet_request_phase_seconds{phase="queue"}', 0.99, t0, t1)

    Timestamps are WALL clock (``time.time()``) so ranges line up
    with postmortem timelines and cross-host beacons; pass ``now=``
    to pin them in tests.  Values by ``kind``: ``counter``/``gauge``
    floats, ``histogram`` ``(counts_incl_inf, sum)`` tuples with the
    bucket bounds kept once per series, ``window`` whatever tuple the
    windowed consumer folds (the SLO engine's ``(good, bad)``)."""

    def __init__(self, raw_window_s: float = RAW_WINDOW_S,
                 max_raw_points: int = MAX_RAW_POINTS,
                 down_interval_s: float = DOWN_INTERVAL_S,
                 retention_s: float = RETENTION_S):
        self.raw_window_s = float(raw_window_s)
        self.max_raw_points = int(max_raw_points)
        self.down_interval_s = float(down_interval_s)
        self.retention_s = float(retention_s)
        self._lock = threading.Lock()
        self._series: Dict[str, _Series] = {}
        self._samples_total = 0
        self._evicted_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- writes --------------------------------------------------------
    def record(self, registry, now: Optional[float] = None) -> int:
        """Append one timestamped sample of EVERY series ``registry``
        currently exposes (two-tier retention); returns the number of
        series sampled.  Called once per scrape/beacon cycle — by the
        ``FleetRegistry`` on its aggregated view, by
        :meth:`start_recorder`'s daemon on a process registry."""
        now = time.time() if now is None else float(now)
        n = 0
        with self._lock:
            for fam in registry.families():
                for lv, child in fam._items():
                    key = fam.name + _fmt_labels(fam.labelnames, lv)
                    if fam.kind == "histogram":
                        uppers, counts, total, _cnt = child.state()
                        self._append_locked(
                            key, now, (tuple(counts), float(total)),
                            kind="histogram", uppers=uppers)
                    else:
                        self._append_locked(key, now, child.value,
                                            kind=fam.kind)
                    n += 1
        return n

    def append(self, series: str, t: float, value,
               kind: str = "gauge",
               uppers: Optional[Tuple[float, ...]] = None,
               mode: Optional[str] = None,
               horizon_s: Optional[float] = None,
               max_points: Optional[int] = None) -> None:
        """Append one sample.  ``mode=None`` (default) is two-tier
        retention; ``mode="slo"`` is the SLO engine's windowed
        encoding (same-instant keep-first, dense-head collapse,
        keep-one-at-or-before-``horizon_s`` trim); ``mode="window"``
        a plain bounded window (strict trim past ``horizon_s``,
        newest ``max_points`` kept) for trend fits and pairwise
        deltas.  A series' mode is fixed at first append."""
        with self._lock:
            self._append_locked(series, float(t), value, kind=kind,
                                uppers=uppers, mode=mode,
                                horizon_s=horizon_s,
                                max_points=max_points)

    def _append_locked(self, series, t, value, kind="gauge",
                       uppers=None, mode=None, horizon_s=None,
                       max_points=None) -> None:
        st = self._series.get(series)
        if st is None:
            st = self._series[series] = _Series(
                kind, mode, uppers, horizon_s, max_points)
        raw = st.raw
        if st.mode == "slo":
            if raw and t <= raw[-1][0]:
                return               # same instant (double-driven
                                     # consumer): keep the first sample
            self._samples_total += 1
            horizon = st.horizon_s or math.inf
            cap = st.max_points or MAX_RAW_POINTS
            if len(raw) >= 2 and t - raw[-2][0] < horizon / cap:
                # dense head: collapse the sub-gap intermediate point
                # — the newest totals are what every window's right
                # edge reads, the skipped point bought nothing
                raw[-1] = (t, value)
                self._evicted_total += 1
            else:
                raw.append((t, value))
            # keep ONE sample at-or-before the horizon so a full
            # window always has a left edge to difference against
            cut = 0
            n = len(raw)
            while n - cut > 2 and raw[cut + 1][0] < t - horizon:
                cut += 1
            if cut:
                del raw[:cut]
                self._evicted_total += cut
            return
        self._samples_total += 1
        raw.append((t, value))
        if st.mode == "window":
            horizon = st.horizon_s
            cut = 0
            if horizon is not None:
                n = len(raw)
                while cut < n and raw[cut][0] < t - horizon:
                    cut += 1
            if st.max_points is not None:
                cut = max(cut, len(raw) - st.max_points)
            if cut:
                del raw[:cut]
                self._evicted_total += cut
            return
        # two-tier: age/overflow raw samples spill downsampled
        while raw and (raw[0][0] < t - self.raw_window_s
                       or len(raw) > self.max_raw_points):
            s = raw.pop(0)
            down = st.down
            # FIXED bucket anchoring (floor of t / interval) — a
            # sliding same-as-last-kept comparison would chain: every
            # sample lands < interval after the one it replaced, and
            # the whole old tier collapses into a single point
            if down and (s[0] // self.down_interval_s
                         == down[-1][0] // self.down_interval_s):
                down[-1] = s         # keep-newest per bucket
                self._evicted_total += 1
            else:
                down.append(s)
        down = st.down
        cut = 0
        n = len(down)
        while cut < n and down[cut][0] < t - self.retention_s:
            cut += 1
        if cut:
            del down[:cut]
            self._evicted_total += cut

    def clear(self, series: str) -> None:
        """Drop one series' points (config kept) — the RESET re-prime
        the SLO engine applies when a restart breaks the cumulative
        origin.  Not an eviction: nothing aged out."""
        with self._lock:
            st = self._series.get(series)
            if st is not None:
                st.raw.clear()
                st.down.clear()

    # -- reads ---------------------------------------------------------
    def series(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def points(self, series: str, start: Optional[float] = None,
               end: Optional[float] = None) -> List[Tuple[float, Any]]:
        """``(t, value)`` samples in ``[start, end]`` (both edges
        inclusive; None = unbounded), oldest first."""
        with self._lock:
            st = self._series.get(series)
            pts = st.merged() if st is not None else []
        if start is not None:
            pts = pts[bisect.bisect_left(pts, start,
                                         key=lambda p: p[0]):]
        if end is not None:
            pts = pts[:bisect.bisect_right(pts, end,
                                           key=lambda p: p[0])]
        return pts

    def latest(self, series: str) -> Optional[Tuple[float, Any]]:
        with self._lock:
            st = self._series.get(series)
            if st is None:
                return None
            return st.raw[-1] if st.raw else (
                st.down[-1] if st.down else None)

    def edge(self, series: str, t: float) -> Optional[Tuple[float, Any]]:
        """The newest sample at-or-before ``t`` (the oldest retained
        sample when history starts later — a young series reads its
        whole history as the window)."""
        with self._lock:
            st = self._series.get(series)
            pts = st.merged() if st is not None else []
        if not pts:
            return None
        return pts[_bisect_le(pts, t)]

    def last_two(self, series: str) -> Optional[
            Tuple[Tuple[float, Any], Tuple[float, Any]]]:
        """The newest two samples (prev, cur) — the pairwise delta
        shape the autoscaler's windowed quantiles difference; None
        until two samples exist."""
        with self._lock:
            st = self._series.get(series)
            pts = st.merged() if st is not None else []
        if len(pts) < 2:
            return None
        return pts[-2], pts[-1]

    def span(self, series: str) -> float:
        """Seconds between the oldest and newest retained samples (0
        with fewer than 2) — the SLO engine's coverage gate."""
        with self._lock:
            st = self._series.get(series)
            pts = st.merged() if st is not None else []
        return pts[-1][0] - pts[0][0] if len(pts) > 1 else 0.0

    def kind(self, series: str) -> Optional[str]:
        with self._lock:
            st = self._series.get(series)
            return st.kind if st is not None else None

    # -- range functions ----------------------------------------------
    def delta(self, series: str, start: float, end: float
              ) -> Optional[float]:
        """Reset-aware increase of a cumulative series over
        ``[start, end]``: left edge = newest sample at-or-before
        ``start``; a reset segment's new total counts wholesale (the
        restarted worker re-counted from zero — the same fold the
        fleet aggregator applies).  None when no samples cover the
        range."""
        base = self.edge(series, start)
        if base is None:
            return None
        pts = self.points(series, start=base[0], end=end)
        if not pts:
            return None
        d = 0.0
        prev = pts[0][1]
        for _t, v in pts[1:]:
            d += v if is_reset(prev, v) else (v - prev)
            prev = v
        return max(0.0, d)

    def rate(self, series: str, start: float, end: float
             ) -> Optional[float]:
        """``delta`` per second over the samples actually covering
        the range; None below 2 samples (a rate needs a baseline)."""
        base = self.edge(series, start)
        if base is None:
            return None
        pts = self.points(series, start=base[0], end=end)
        if len(pts) < 2:
            return None
        span = pts[-1][0] - pts[0][0]
        if span <= 0:
            return None
        d = 0.0
        prev = pts[0][1]
        for _t, v in pts[1:]:
            d += v if is_reset(prev, v) else (v - prev)
            prev = v
        return max(0.0, d) / span

    def quantile_over_time(self, series: str, q: float, start: float,
                           end: float) -> Optional[float]:
        """Interpolated quantile of a HISTOGRAM series' observations
        that fell inside ``[start, end]``: reset-aware per-bucket
        window deltas fed to :func:`window_quantile`.  None when the
        series is not a histogram or no samples cover the range; NaN
        when the window saw no observations."""
        with self._lock:
            st = self._series.get(series)
            if st is None or st.kind != "histogram" or st.uppers is None:
                return None
            uppers = st.uppers
        base = self.edge(series, start)
        if base is None:
            return None
        pts = self.points(series, start=base[0], end=end)
        if not pts:
            return None
        window = [0.0] * len(pts[0][1][0])
        prev = pts[0][1][0]
        for _t, (counts, _s) in pts[1:]:
            if any(is_reset(p, c) for p, c in zip(prev, counts)):
                for i, c in enumerate(counts):
                    window[i] += c
            else:
                for i, (p, c) in enumerate(zip(prev, counts)):
                    window[i] += max(0.0, c - p)
            prev = counts
        return window_quantile(uppers, window, q)

    # -- the /query surface -------------------------------------------
    def query(self, series: str,
              matchers: Iterable[Tuple[str, str]] = (),
              start: Optional[float] = None,
              end: Optional[float] = None,
              func: str = "range",
              q: Optional[float] = None) -> Dict:
        """The ``/query`` endpoint's engine.  ``series`` selects by
        metric NAME (label ``matchers`` filter by equality) or, with
        a ``{`` present, by exact series key.  ``func``: ``range``
        returns ``[t, value]`` points, ``rate``/``delta`` a scalar
        per matched series (cumulative kinds only), ``quantile`` the
        bucket-interpolated ``q`` over the window.  Unknown selectors
        match nothing — an empty result, not an error (absence of
        history is an answer)."""
        if func not in QUERY_FUNCS:
            raise ValueError(
                f"unknown func {func!r}; one of {QUERY_FUNCS}")
        if func == "quantile" and (q is None or not 0.0 <= q <= 1.0):
            raise ValueError("func=quantile needs q in [0, 1]")
        want = tuple((str(k), str(v)) for k, v in matchers)
        matched: List[str] = []
        for key in self.series():
            if "{" in series:
                if key != series:
                    continue
            else:
                name, pairs = parse_series(key)
                if name != series:
                    continue
                have = dict(pairs)
                if any(have.get(k) != v for k, v in want):
                    continue
            matched.append(key)
        now = time.time()
        t0 = now - self.raw_window_s if start is None else float(start)
        t1 = now if end is None else float(end)
        results = []
        for key in matched:
            kind = self.kind(key)
            if func == "range":
                pts = self.points(key, start=t0, end=t1)
                results.append({"series": key, "kind": kind,
                                "points": [self._json_point(p, kind)
                                           for p in pts]})
            elif func in ("rate", "delta"):
                if kind == "histogram":
                    raise ValueError(
                        f"func={func} needs a scalar series; "
                        f"{key!r} is a histogram (use quantile)")
                v = (self.rate if func == "rate" else self.delta)(
                    key, t0, t1)
                results.append({"series": key, "kind": kind,
                                "value": v})
            else:
                v = self.quantile_over_time(key, q, t0, t1)
                if v is not None and math.isnan(v):
                    v = None
                results.append({"series": key, "kind": kind,
                                "value": v})
        return {"func": func, "start": t0, "end": t1,
                "matched": len(matched), "results": results}

    @staticmethod
    def _json_point(p: Tuple[float, Any], kind: Optional[str]):
        t, v = p
        if kind == "histogram":
            counts, total = v
            return [t, {"count": float(sum(counts)),
                        "sum": float(total)}]
        if isinstance(v, tuple):
            return [t, list(v)]
        return [t, v]

    # -- crash forensics ----------------------------------------------
    def dump_recent(self, window_s: float = 300.0,
                    max_points: int = 64) -> Dict:
        """The last ``window_s`` of every series, stride-downsampled
        to <= ``max_points`` each (newest sample always kept) — the
        pre-crash metric history a postmortem bundle ships
        (``telemetry.flightrec``)."""
        now = time.time()
        out: Dict[str, Dict] = {}
        for key in self.series():
            kind = self.kind(key)
            pts = self.points(key, start=now - float(window_s))
            if not pts:
                continue
            if len(pts) > max_points:
                stride = -(-len(pts) // max_points)
                pts = pts[::stride] + [pts[-1]]
            out[key] = {"kind": kind,
                        "points": [self._json_point(p, kind)
                                   for p in pts]}
        return {"window_s": float(window_s), "t": now, "series": out}

    def stats(self) -> Dict[str, float]:
        with self._lock:
            points = sum(len(st.raw) + len(st.down)
                         for st in self._series.values())
            return {"series": len(self._series),
                    "samples_total": self._samples_total,
                    "evicted_total": self._evicted_total,
                    "points": points}

    # -- recorder daemon ----------------------------------------------
    def start_recorder(self, registry=None, interval_s: float = 1.0
                       ) -> "TimeSeriesStore":
        """Sample ``registry`` (default: the process registry) every
        ``interval_s`` on a daemon thread — the standalone per-host
        shape; a ``FleetRegistry`` records its aggregated view per
        scrape instead."""
        if registry is None:
            from deeplearning4j_torch import telemetry
            registry = telemetry.get_registry()
        # fresh stop event: re-armable after a close() (a set() event
        # would end the new loop on its first wait); the thread
        # closes over ITS OWN event
        stop = threading.Event()

        def loop():
            import logging
            log = logging.getLogger("deeplearning4j_torch")
            while not stop.wait(interval_s):
                try:
                    self.record(registry)
                except Exception:
                    # one bad pass must not silence the history plane
                    log.exception("TimeSeriesStore recorder failed")

        thread = threading.Thread(target=loop,
                                  name="dl4j-torch-tsdb-recorder",
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
            thread.join(timeout=5.0)
