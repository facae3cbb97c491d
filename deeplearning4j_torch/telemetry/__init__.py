"""Process-wide telemetry (port of ``deeplearning4j_tpu.telemetry``): the
metrics registry, span tracing, the sampling device profiler, the flight
recorder, the time-series store, the SLO alert engine, exposition and the
fleet metric plane.

* ``registry``  — thread-safe Counter/Gauge/Histogram families with
  Prometheus text exposition, jsonl snapshots and snapshot merging;
* ``tracing``   — nestable host-side spans exported as Chrome-trace
  jsonl, plus TRACKED spans (``begin``/``end`` from any thread,
  close-on-owner-death) carrying request trace ids across components;
* ``profiling`` — a sampling ``DeviceProfiler`` around the hot dispatch
  sites (decode tick, verify, prefill) into
  ``fleet_device_phase_seconds{device=,phase=}``, timed with CUDA events
  on the card and ``time.perf_counter`` on the CPU;
* ``flightrec`` — the per-host black box: a bounded ring of admission /
  dispatch / spill / watchdog / scale events that watchdog trips and
  chaos kills freeze — with the open spans, a metric snapshot, the
  process store's pre-crash HISTORY and the SLO state — into atomic
  postmortem bundles;
* ``tsdb``      — the embedded time-series store: bounded per-series
  history rings with ``rate``/``delta``/``quantile_over_time`` range
  reads, the one history substrate the SLO engine, the backlog
  forecaster and the autoscaler read through (``get_tsdb()`` is the
  process store);
* ``slo``       — declarative ``SLOSpec`` objectives over the emitted
  request series and a multi-window burn-rate ``AlertEngine`` with
  admission projection;
* ``exposition``— a stdlib ``http.server`` endpoint: ``/metrics``,
  ``/query``, ``/alerts`` and ``/traces``;
* ``fleet``     — per-host metric beacons (a shared directory, or
  ``torch.distributed`` with ``exchange_snapshots``) and
  ``FleetRegistry`` aggregation into one ``{host=}``-tagged scrape.

Module-level ``counter``/``gauge``/``histogram`` register on ONE
process-default registry so every subsystem lands on the same scrape
surface; ``TelemetryListener`` bridges the registry into the
``set_listeners()`` machinery.  Metric names are the reference's.
"""
from __future__ import annotations

from typing import Sequence

from deeplearning4j_torch.telemetry.registry import (
    DEFAULT_BUCKETS, RATIO_BUCKETS, Counter, Gauge, Histogram,
    MetricsRegistry, parse_series)
from deeplearning4j_torch.telemetry.tracing import (FleetTraceStore, Span,
                                                    SpanTracer)
from deeplearning4j_torch.telemetry.exposition import (
    MetricsServer, start_metrics_server)
from deeplearning4j_torch.telemetry.listener import TelemetryListener
from deeplearning4j_torch.telemetry.fleet import (
    FleetRegistry, MetricsBeacon, exchange_snapshots, publish_beacon)
from deeplearning4j_torch.telemetry.profiling import DeviceProfiler
from deeplearning4j_torch.telemetry.flightrec import FlightRecorder
from deeplearning4j_torch.telemetry.slo import (AlertEngine, CommandSink,
                                                SLOSpec, WebhookFileSink)
from deeplearning4j_torch.telemetry.tsdb import TimeSeriesStore

_REGISTRY = MetricsRegistry()
_TRACER = SpanTracer()
_PROFILER = DeviceProfiler(_REGISTRY)
_FLIGHTREC = FlightRecorder()
_TSDB = TimeSeriesStore()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every in-tree metric lives in."""
    return _REGISTRY


def get_tracer() -> SpanTracer:
    """The process-wide default span tracer."""
    return _TRACER


def get_profiler() -> DeviceProfiler:
    """The process-wide sampling device profiler the hot dispatch sites
    report into."""
    return _PROFILER


def get_flight_recorder() -> FlightRecorder:
    """The process-wide flight recorder: the bounded ring of admission /
    dispatch / spill / watchdog events the hot sites feed, and the
    postmortem-bundle writer the crash paths trip."""
    return _FLIGHTREC


def get_tsdb() -> TimeSeriesStore:
    """The process-wide embedded time-series store: recorded per
    scrape/beacon cycle (``start_recorder``), queried at ``/query``, and
    the pre-crash history source for postmortem bundles."""
    return _TSDB


def counter(name: str, documentation: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return _REGISTRY.counter(name, documentation, labelnames)


def gauge(name: str, documentation: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return _REGISTRY.gauge(name, documentation, labelnames)


def histogram(name: str, documentation: str = "",
              labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return _REGISTRY.histogram(name, documentation, labelnames, buckets)


def span(name: str, **args):
    """``with telemetry.span("phase/thing"): ...`` on the default tracer."""
    return _TRACER.span(name, **args)


__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "SpanTracer",
    "Span", "MetricsServer", "start_metrics_server", "TelemetryListener",
    "FleetRegistry", "FleetTraceStore", "MetricsBeacon", "publish_beacon",
    "exchange_snapshots", "parse_series", "DeviceProfiler",
    "FlightRecorder", "AlertEngine", "SLOSpec", "WebhookFileSink",
    "CommandSink", "TimeSeriesStore",
    "DEFAULT_BUCKETS", "RATIO_BUCKETS",
    "get_registry", "get_tracer", "get_profiler", "get_flight_recorder",
    "get_tsdb", "counter", "gauge", "histogram", "span",
]
