"""Process-wide metrics registry (port of ``deeplearning4j_tpu.telemetry``,
registry only).

Module-level ``counter``/``gauge``/``histogram`` register on ONE
process-default registry so every subsystem lands on the same scrape
surface.  Metric names are the reference's; the serving slice emits
``paged_route_total{path=}``,
``generation_server_{admitted,retired,ticks,host_syncs}_total`` and
``prefix_cache_{hits,misses}_total``; the training slice
``train_{iterations,epochs,examples}_total``,
``train_{data_wait,step_dispatch}_seconds``, ``flash_route_total{path=}``
and ``flash_fallback_above_threshold_total``.  Spans, profiling, the
TSDB, the fleet plane and the flight recorder come with later slices.
"""
from __future__ import annotations

from typing import Sequence

from deeplearning4j_torch.telemetry.registry import (
    DEFAULT_BUCKETS, RATIO_BUCKETS, Counter, Gauge, Histogram,
    MetricsRegistry)

_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every in-tree metric lives in."""
    return _REGISTRY


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


__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "DEFAULT_BUCKETS", "RATIO_BUCKETS", "get_registry", "counter",
           "gauge", "histogram"]
