"""Process-wide, thread-safe metrics registry — Counter / Gauge /
Histogram with Prometheus text exposition and plain-dict snapshots.

Copied from ``deeplearning4j_tpu/telemetry/registry.py`` (stdlib only),
with the series parser and the snapshot merge the fleet plane
(``telemetry.fleet``) and the time-series store read.  Every child
carries its own lock: ``inc``/``observe`` from the
scheduler thread and request threads never race (a bare ``float +=``
spans several bytecodes under the GIL and CAN lose updates).
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# Prometheus default buckets — latency-shaped, seconds.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# Ratio-shaped buckets (batch occupancy, padding waste): eighths of [0, 1].
RATIO_BUCKETS = tuple(i / 8 for i in range(1, 9))


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(labelnames: Sequence[str], labelvalues: Sequence[str],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = list(zip(labelnames, labelvalues)) + list(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def parse_series(series: str) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    """Invert the ``name{k="v",...}`` series strings ``snapshot()``
    emits back into ``(name, ((k, v), ...))``.  Values may contain
    commas/'='/escaped quotes (e.g. a mesh-shape label), so this
    parses the quoted escape grammar ``_fmt_labels`` writes instead of
    splitting on ','.  Shared by ``merge_snapshot`` and the fleet
    aggregator (``telemetry.fleet``)."""
    import re
    if "{" not in series:
        return series, ()
    name, _, rest = series.partition("{")
    unesc = lambda v: re.sub(
        r"\\(.)", lambda m: {"n": "\n"}.get(m.group(1), m.group(1)), v)
    pairs = [
        (k, unesc(v)) for k, v in re.findall(
            r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"',
            rest.rstrip("}"))]
    return name, tuple(pairs)


class _Child:
    """One labeled time series; all mutation under ``self._lock``."""

    def __init__(self):
        self._lock = threading.Lock()


class _CounterChild(_Child):
    def __init__(self):
        super().__init__()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild(_Child):
    def __init__(self):
        super().__init__()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _HistogramChild(_Child):
    def __init__(self, buckets: Sequence[float]):
        super().__init__()
        self._uppers = tuple(buckets)
        self._counts = [0] * (len(self._uppers) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            for i, ub in enumerate(self._uppers):
                if value <= ub:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def state(self) -> Tuple[Tuple[float, ...], List[int], float, int]:
        with self._lock:
            return self._uppers, list(self._counts), self._sum, self._count

    def percentile(self, q: float) -> float:
        """Bucket-derived quantile (q in [0, 1]) with linear interpolation
        inside the winning bucket.  NaN when empty."""
        uppers, counts, _, total = self.state()
        if total == 0:
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
                frac = (rank - prev) / counts[i]
                return lo + frac * (ub - lo)
            lo = ub
        return uppers[-1] if uppers else math.nan


_CHILD_TYPES = {"counter": _CounterChild, "gauge": _GaugeChild,
                "histogram": _HistogramChild}


class _Family:
    """A named metric with fixed label names; ``labels()`` creates/gets
    the child for one label-value tuple.  Unlabeled metrics delegate to
    a single ``()`` child so ``Counter.inc()`` works directly."""

    kind: str = ""

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = (), **kw):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._kw = kw
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self) -> _Child:
        return _CHILD_TYPES[self.kind](**self._kw)

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass labels positionally OR by name")
            values = tuple(kv[n] for n in self.labelnames)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._new_child()
            return child

    def remove(self, *values, **kv) -> None:
        """Drop the child for one label-value tuple: long-lived processes
        that cycle labeled resources (e.g. serving instances) retire dead
        series instead of leaking them into every scrape."""
        if kv:
            if values:
                raise ValueError("pass labels positionally OR by name")
            values = tuple(kv[n] for n in self.labelnames)
        values = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(values, None)

    def _items(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())

    def _default(self) -> _Child:
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; call "
                ".labels(...) first")
        with self._lock:
            return self._children[()]


class Counter(_Family):
    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Family):
    kind = "gauge"

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, documentation, labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        buckets = tuple(sorted(float(b) for b in buckets))
        if not buckets:
            raise ValueError("histogram needs at least one bucket bound")
        super().__init__(name, documentation, labelnames, buckets=buckets)
        self.buckets = buckets

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def percentile(self, q: float) -> float:
        return self._default().percentile(q)

    @property
    def count(self) -> int:
        return self._default().state()[3]

    @property
    def sum(self) -> float:
        return self._default().state()[2]


class MetricsRegistry:
    """Create-or-get metric families by name; render/snapshot them all.
    One process-wide default instance lives in ``telemetry``; tests that
    need isolation construct their own registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_create(self, cls, name: str, documentation: str,
                       labelnames=(), **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, not {cls.kind}")
                if tuple(labelnames) != fam.labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{fam.labelnames}, not {tuple(labelnames)}")
                want = kw.get("buckets")
                if want is not None and tuple(sorted(
                        float(b) for b in want)) != fam.buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {fam.buckets}")
                return fam
            fam = cls(name, documentation, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, documentation="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, documentation, labelnames)

    def gauge(self, name, documentation="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, documentation, labelnames)

    def histogram(self, name, documentation="", labelnames=(),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, documentation,
                                   labelnames, buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def render_prometheus(self) -> str:
        """Prometheus/OpenMetrics text format, one sample per series."""
        out: List[str] = []
        for fam in self.families():
            out.append(f"# HELP {fam.name} {fam.documentation}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for lv, child in fam._items():
                base = _fmt_labels(fam.labelnames, lv)
                if fam.kind in ("counter", "gauge"):
                    out.append(f"{fam.name}{base} {child.value}")
                else:
                    uppers, counts, total, count = child.state()
                    cum = 0
                    for ub, c in zip(uppers, counts):
                        cum += c
                        lab = _fmt_labels(fam.labelnames, lv,
                                          (("le", repr(ub)),))
                        out.append(f"{fam.name}_bucket{lab} {cum}")
                    lab = _fmt_labels(fam.labelnames, lv,
                                      (("le", "+Inf"),))
                    out.append(f"{fam.name}_bucket{lab} {count}")
                    out.append(f"{fam.name}_sum{base} {total}")
                    out.append(f"{fam.name}_count{base} {count}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict:
        """JSON-ready state: counters/gauges as ``{series: value}``,
        histograms with count/sum/buckets and derived p50/p95/p99."""
        snap = {"timestamp": time.time(), "counters": {}, "gauges": {},
                "histograms": {}}
        for fam in self.families():
            for lv, child in fam._items():
                series = fam.name + _fmt_labels(fam.labelnames, lv)
                if fam.kind == "counter":
                    snap["counters"][series] = child.value
                elif fam.kind == "gauge":
                    snap["gauges"][series] = child.value
                else:
                    uppers, counts, total, count = child.state()
                    snap["histograms"][series] = {
                        "count": count, "sum": total,
                        "buckets": {repr(u): c
                                    for u, c in zip(uppers, counts)},
                        "inf": counts[-1],
                        "p50": child.percentile(0.50),
                        "p95": child.percentile(0.95),
                        "p99": child.percentile(0.99),
                    }
        return snap

    def merge_snapshot(self, snap: Dict) -> None:
        """Fold one worker's ``snapshot()`` into this registry —
        aggregation across processes (each worker runs its own
        registry; ship snapshots over a control plane and merge here).
        Counters and histograms accumulate; gauges take the incoming
        value."""
        for series, v in snap.get("counters", {}).items():
            name, pairs = parse_series(series)
            fam = self.counter(name, labelnames=tuple(k for k, _ in pairs))
            child = fam.labels(*[val for _, val in pairs]) if pairs \
                else fam._default()
            child.inc(v)
        for series, v in snap.get("gauges", {}).items():
            name, pairs = parse_series(series)
            fam = self.gauge(name, labelnames=tuple(k for k, _ in pairs))
            child = fam.labels(*[val for _, val in pairs]) if pairs \
                else fam._default()
            child.set(v)
        for series, h in snap.get("histograms", {}).items():
            name, pairs = parse_series(series)
            uppers = tuple(float(u) for u in h["buckets"])
            fam = self.histogram(name,
                                 labelnames=tuple(k for k, _ in pairs),
                                 buckets=uppers or DEFAULT_BUCKETS)
            child = fam.labels(*[val for _, val in pairs]) if pairs \
                else fam._default()
            with child._lock:
                for i, u in enumerate(child._uppers):
                    child._counts[i] += h["buckets"].get(repr(u), 0)
                child._counts[-1] += h.get("inf", 0)
                child._sum += h["sum"]
                child._count += h["count"]

    def series_count(self) -> int:
        """Distinct exposed sample series (histogram buckets/sum/count
        each count, matching what a scraper stores)."""
        n = 0
        for fam in self.families():
            for _lv, child in fam._items():
                if fam.kind == "histogram":
                    n += len(child.state()[0]) + 3  # buckets + Inf/sum/cnt
                else:
                    n += 1
        return n
