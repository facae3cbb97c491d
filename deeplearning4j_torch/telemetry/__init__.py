"""Process-wide telemetry (port of ``deeplearning4j_tpu.telemetry``): the
metrics registry, span tracing, the sampling device profiler and the
flight recorder.

* ``registry``  — thread-safe Counter/Gauge/Histogram families with
  Prometheus text exposition and jsonl snapshots;
* ``tracing``   — nestable host-side spans exported as Chrome-trace
  jsonl, plus TRACKED spans (``begin``/``end`` from any thread,
  close-on-owner-death) carrying request trace ids across components;
* ``profiling`` — a sampling ``DeviceProfiler`` around the hot dispatch
  sites (decode tick, verify, prefill) into
  ``fleet_device_phase_seconds{device=,phase=}``, timed with CUDA events
  on the card and ``time.perf_counter`` on the CPU;
* ``flightrec`` — the per-host black box: a bounded ring of admission /
  dispatch / spill / watchdog events that watchdog trips and chaos kills
  freeze into atomic postmortem bundles.

Module-level ``counter``/``gauge``/``histogram`` register on ONE
process-default registry so every subsystem lands on the same scrape
surface.  Metric names are the reference's.  The time-series store, the
SLO engine, exposition and the fleet beacon plane come with a later
slice.
"""
from __future__ import annotations

from typing import Sequence

from deeplearning4j_torch.telemetry.flightrec import FlightRecorder
from deeplearning4j_torch.telemetry.profiling import DeviceProfiler
from deeplearning4j_torch.telemetry.registry import (
    DEFAULT_BUCKETS, RATIO_BUCKETS, Counter, Gauge, Histogram,
    MetricsRegistry)
from deeplearning4j_torch.telemetry.tracing import (FleetTraceStore, Span,
                                                    SpanTracer)

_REGISTRY = MetricsRegistry()
_TRACER = SpanTracer()
_PROFILER = DeviceProfiler(_REGISTRY)
_FLIGHTREC = FlightRecorder()


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


__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "SpanTracer", "Span", "FleetTraceStore", "DeviceProfiler",
           "FlightRecorder", "DEFAULT_BUCKETS", "RATIO_BUCKETS",
           "get_registry", "get_tracer", "get_profiler",
           "get_flight_recorder", "counter", "gauge", "histogram", "span"]
